"""PyTorch and CUDA port of ``block_aligner_tpu`` for NVIDIA Hopper GPUs.

It serves global and x-drop alignment, with or without trace (CIGARs), on
two routes of ``BatchAligner``, and ``align_exp_all``: fixed blocks (min ==
max, the lane kernel, ``csrc/lane_kernel.cu``) and adaptive blocks (min <
max, the adaptive kernel, ``csrc/adaptive_kernel.cu``).  Each hand-written
CUDA kernel runs on the GPU and its plain PyTorch version on the CPU.  The
package imports torch and numpy, never JAX or ``block_aligner_tpu``.
"""

from .api import BatchAligner, align_exp_all, pick_route, round_up
from .convert import gaps_from_jax, matrix_from_jax
from .core.cigar import Cigar, OpLen, Operation
from .core.result import AlignResult
from .core.scores import (
    BLOSUM45, BLOSUM50, BLOSUM62, BLOSUM80, BLOSUM90, BYTES1, NW1, PAM100,
    PAM120, PAM160, PAM200, PAM250, AAMatrix, ByteMatrix, Gaps, NucMatrix,
    percent_len,
)

__all__ = [
    "AlignResult", "BatchAligner", "align_exp_all", "pick_route", "round_up",
    "Cigar", "OpLen", "Operation",
    "gaps_from_jax", "matrix_from_jax",
    "AAMatrix", "NucMatrix", "ByteMatrix", "Gaps", "percent_len",
    "BLOSUM45", "BLOSUM50", "BLOSUM62", "BLOSUM80", "BLOSUM90",
    "PAM100", "PAM120", "PAM160", "PAM200", "PAM250", "NW1", "BYTES1",
]
