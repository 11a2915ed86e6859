"""Big-block adaptive alignment of a batch of sequence pairs, global or
x-drop: the configuration, the packer, the plain PyTorch version and the
wrapper of the CUDA kernel.

Counterpart of ``block_aligner_tpu/ops/big_kernel.py``: ``build_big_engine``
(512 < max_size <= 8192, and (min, 512) without trace) in global and in
x-drop mode, scoring sequence pairs by a table.  Its machine is the
adaptive kernel's (``ops/adaptive_kernel.py``): the same grow / shrink /
checkpoint ladder min, 2 min, ..., max, the same 8-column rects, the same
16-residue x-drop tracker and X_DROP_ITER = 2 hysteresis; only the block is
larger, and ``min == max > 512`` makes it a fixed-block machine (its ladder
is empty).  So ``big_align_plain`` is ``adaptive_align_plain`` run with this
configuration, and computes the same score (x-drop: the best score and its
position) and step-cap overrun flag as the JAX kernel and ``BlockOracle``,
bit for bit.  Past 512 rows a grow's columns run long enough without an
offset rebase for a cell to reach the upper i16 rail, which the plain
version saturates as the reference does.

The TPU kernel's VMEM mechanism (row segments walked by a flat (step,
segment) loop, packed ACT/PAS/CC planes, HBM checkpoint planes with
DMA-staged blends, deferred swaps, saves, restores and shrinks, streamed
code and DP planes, and the code-keyed score fetch that assumes a symmetric
table) has no counterpart here: the CUDA kernel (``csrc/big_kernel.cu``)
keeps a pair's borders and checkpoint in one thread block's shared memory
and reads scores from the table by both codes.

Trace, ByteMatrix, the local-start and free-gap flags, profiles and the
segmented 16384 band are later slices of kernel C: their configurations
raise ``ValueError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..core.result import STEP
from . import _build
from .adaptive_kernel import adaptive_align_plain
from .lane_kernel import (check_inputs, count_launch, pack_lane, reset_counts,
                          wide, x_value)

__all__ = ["BigKernelConfig", "pack_big", "big_align_plain", "big_align"]

LIBRARY = "big_kernel"  # csrc/big_kernel.cu
MAX_CAP = 16384  # code positions per sequence (JAX api.py:84-87)

# the modes of kernel C still to port, and the ROADMAP.md item of each
_LATER = {
    "trace": "queue 2 item 5a (kernel C trace)",
    "byte_mode": "queue 2 item 5b (kernel C ByteMatrix)",
    "local_start": "queue 2 item 5c (kernel C flags)",
    "free_query_start_gaps": "queue 2 item 5c (kernel C flags)",
    "free_query_end_gaps": "queue 2 item 5c (kernel C flags)",
    "profile": "queue 2 item 5d (kernel C profiles)",
}


@dataclasses.dataclass(frozen=True)
class BigKernelConfig:
    min_size: int  # starting block size, a power of two >= 16
    max_size: int  # S: block-size cap, a power of two in 512..8192
    seq_cap: int  # code positions per sequence (position 0 is the NULL row)
    alpha: int = 32  # score-table side: 32 for amino acids, 16 for nucleotides
    x_drop: bool = False  # x-drop mode; the x value travels in the gaps
    # the modes of later slices, which raise (``_LATER``); they are fields so
    # that the adaptive machine and the lane helpers read this configuration
    trace: bool = False
    profile: bool = False
    byte_mode: bool = False
    local_start: bool = False
    free_query_start_gaps: bool = False
    free_query_end_gaps: bool = False

    def __post_init__(self):
        m, S = self.min_size, self.max_size
        if (m & (m - 1) or S & (S - 1) or m < 16 or not 512 <= S <= 8192
                or m > S or m == S == 512):
            raise ValueError(
                "the big kernel takes powers of two min_size >= 16 and "
                "max_size in 512..8192 with min < max, or min == max > 512, "
                f"got ({m}, {S})")
        if (self.seq_cap % 128
                or not max(256, S + 2 * STEP) <= self.seq_cap <= MAX_CAP):
            raise ValueError(
                f"seq_cap must be a multiple of 128 in max(256, max_size + "
                f"{2 * STEP})..{MAX_CAP}, got {self.seq_cap}")
        if self.alpha not in (16, 32):
            raise ValueError(f"alpha must be 16 or 32, got {self.alpha}")
        for mode, item in _LATER.items():
            if getattr(self, mode):
                raise ValueError(f"the big kernel's {mode} mode is not "
                                 f"ported yet: ROADMAP.md {item}")

    @property
    def block(self) -> int:
        """``pack_lane`` packs for the largest block."""
        return self.max_size

    @property
    def max_steps(self) -> int:
        """Step cap of a pair (the JAX kernel's loop bound,
        ``big_kernel.py:277-281``)."""
        return (4 * self.seq_cap + 32 * self.max_size) // STEP


def pack_big(pairs, matrix, cfg: BigKernelConfig, gaps, device,
             x_drop: int = 0):
    """Pack ``(query, reference)`` byte pairs for ``big_align``: the lane
    kernel's packing (``pack_lane``) for blocks of ``cfg.max_size``."""
    return pack_lane(pairs, matrix, cfg, gaps, device, x_drop)


def big_align_plain(codes, qlen, rlen, table, gaps, cfg: BigKernelConfig,
                    count_cells: bool = False, top_size: bool = False):
    """Plain PyTorch version: ``adaptive_align_plain`` on this
    configuration, all pairs in lockstep at the full width ``max_size``.
    Returns (B, 2) int32 (score, overrun), in x-drop mode (B, 4) (best
    score, its query position, its reference position, overrun); with
    ``count_cells`` also each pair's DP cell count, (B,) int64, and with
    ``top_size`` the largest block size each pair reached, (B,) int32."""
    return adaptive_align_plain(codes, qlen, rlen, table, gaps, cfg,
                                count_cells, top_size)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of ``csrc/big_kernel.cu``."""
    lib.big_align_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.big_align_launch.restype = ctypes.c_int
    lib.big_launch_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.big_launch_shape.restype = ctypes.c_int
    lib.big_error_string.argtypes = [ctypes.c_int]
    lib.big_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """``csrc/big_kernel.cu``, built and bound."""
    return bind(_build.load(LIBRARY))


def launch_shape(cfg: BigKernelConfig):
    """``(threads, dynamic shared bytes, thread blocks per SM)`` of one
    launch of ``cfg``'s kernel instance on the current CUDA device, the
    last from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    got = (ctypes.c_int * 3)()
    err = _lib().big_launch_shape(cfg.max_size, int(cfg.x_drop),
                                  ctypes.addressof(got))
    if err:
        raise RuntimeError("big kernel occupancy query failed: "
                           f"{_lib().big_error_string(err).decode()}")
    return tuple(got)


def big_align(codes, qlen, rlen, table, gaps, cfg: BigKernelConfig):
    """(score, overrun) per pair as a (B, 2) int32 tensor; in x-drop mode
    (best score, query position, reference position, overrun) as (B, 4).

    CPU tensors take ``big_align_plain``; CUDA tensors launch the kernel of
    ``csrc/big_kernel.cu`` on the current stream, one thread block per
    pair, or raise.  The wrapper counts its launches by instance:
    ``big_align.launches`` (global) and ``big_align.xdrop_launches``."""
    if codes.device.type == "cpu":
        return big_align_plain(codes, qlen, rlen, table, gaps, cfg)
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"no big kernel for device {dev}")
    B = codes.shape[0]
    check_inputs(codes, qlen, rlen, table, cfg)
    out = torch.empty((B, 4 if wide(cfg) else 2), dtype=torch.int32,
                      device=dev)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.big_align_launch(
            codes.data_ptr(), qlen.data_ptr(), rlen.data_ptr(),
            table.data_ptr(), out.data_ptr(), B, cfg.seq_cap, cfg.alpha,
            cfg.min_size, cfg.max_size, cfg.max_steps, int(gaps[0]),
            int(gaps[1]), x_value(gaps, cfg),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("big kernel launch failed: "
                           f"{lib.big_error_string(err).decode()}")
    count_launch(big_align, cfg)
    return out


reset_counts(big_align)
