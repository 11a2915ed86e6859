"""PyTorch and CUDA port of ``block_aligner_tpu`` for NVIDIA Hopper GPUs.

This slice serves the fixed-block global lane route: ``BatchAligner`` with
min == max block size, a hand-written CUDA kernel on the GPU
(``csrc/lane_kernel.cu``) and its plain PyTorch version on the CPU.  The
package imports torch and numpy, never JAX or ``block_aligner_tpu``.
"""

from .api import BatchAligner, pick_route, round_up
from .convert import gaps_from_jax, matrix_from_jax
from .core.result import AlignResult
from .core.scores import (
    BLOSUM45, BLOSUM50, BLOSUM62, BLOSUM80, BLOSUM90, BYTES1, NW1, PAM100,
    PAM120, PAM160, PAM200, PAM250, AAMatrix, ByteMatrix, Gaps, NucMatrix,
    percent_len,
)

__all__ = [
    "AlignResult", "BatchAligner", "pick_route", "round_up",
    "gaps_from_jax", "matrix_from_jax",
    "AAMatrix", "NucMatrix", "ByteMatrix", "Gaps", "percent_len",
    "BLOSUM45", "BLOSUM50", "BLOSUM62", "BLOSUM80", "BLOSUM90",
    "PAM100", "PAM120", "PAM160", "PAM200", "PAM250", "NW1", "BYTES1",
]
