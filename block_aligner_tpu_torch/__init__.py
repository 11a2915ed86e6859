"""PyTorch and CUDA port of ``block_aligner_tpu`` for NVIDIA Hopper GPUs.

It serves global and x-drop alignment, with or without trace (CIGARs), on
two routes of ``BatchAligner``, and ``align_exp_all``: fixed blocks (min ==
max, the lane kernel, ``csrc/lane_kernel.cu``) and adaptive blocks (min <
max, the adaptive kernel, ``csrc/adaptive_kernel.cu``); and the same for
sequence-to-PSSM pairs through ``ProfileAligner`` and
``align_profile_exp_all`` (the kernels' profile instances,
``csrc/lane_profile.cu`` and ``csrc/adaptive_profile.cu``).  Blocks past
512 take a third route of both aligners, in every mode: the big-block
kernel, ``csrc/big_kernel.cu`` (its trace, FLAGS and profile instances
``csrc/big_*.cu``).  Long sequences (past the JAX kernels' 16384 code
positions, reads to 50 kbp and beyond) and blocks up to 16384 rows run
through ``LongBatchAligner`` (fixed blocks up to 512, the lane kernel) and
``LongAdaptiveAligner`` (the three kernels by size; past 8192 rows the big
kernel's 16384-row instances, ``csrc/big_16384.cu`` and
``csrc/big_trace_16384.cu``), and through ``BatchAligner``'s long routes.
Each hand-written CUDA kernel runs on the GPU and its plain PyTorch version
on the CPU.  The package imports torch and numpy, never JAX or
``block_aligner_tpu``.
"""

from .api import (BatchAligner, LongAdaptiveAligner, LongBatchAligner,
                  ProfileAligner, align_exp_all, align_profile_exp_all,
                  pick_route, round_up)
from .convert import gaps_from_jax, matrix_from_jax, profile_from_jax
from .core.cigar import Cigar, OpLen, Operation
from .core.result import AlignResult
from .core.scores import (
    BLOSUM45, BLOSUM50, BLOSUM62, BLOSUM80, BLOSUM90, BYTES1, NW1, PAM100,
    PAM120, PAM160, PAM200, PAM250, AAMatrix, AAProfile, ByteMatrix, Gaps,
    NucMatrix,
    percent_len,
)

__all__ = [
    "AlignResult", "BatchAligner", "ProfileAligner", "LongBatchAligner",
    "LongAdaptiveAligner", "align_exp_all",
    "align_profile_exp_all", "pick_route", "round_up",
    "Cigar", "OpLen", "Operation",
    "gaps_from_jax", "matrix_from_jax", "profile_from_jax",
    "AAMatrix", "NucMatrix", "ByteMatrix", "AAProfile", "Gaps", "percent_len",
    "BLOSUM45", "BLOSUM50", "BLOSUM62", "BLOSUM80", "BLOSUM90",
    "PAM100", "PAM120", "PAM160", "PAM200", "PAM250", "NW1", "BYTES1",
]
