"""Big-block adaptive alignment of a batch of sequence pairs, global or
x-drop, with or without trace: the configuration, the packer, the plain
PyTorch version and the wrapper of the CUDA kernel.

Counterpart of ``block_aligner_tpu/ops/big_kernel.py``: ``build_big_engine``
(512 < max_size <= 16384, and (min, 512)) in global and in x-drop mode, with
or without trace, scoring sequence pairs by a table or by byte equality
(``cfg.byte_mode``), with or without the local-start and free-query-gap
flags of ``ops/lane_kernel.py``, and for (query, profile) pairs.  Its
machine is the
adaptive kernel's (``ops/adaptive_kernel.py``): the same grow / shrink /
checkpoint ladder min, 2 min, ..., max, the same 8-column rects, the same
16-residue x-drop tracker and X_DROP_ITER = 2 hysteresis; only the block is
larger, and ``min == max > 512`` makes it a fixed-block machine (its ladder
is empty).  So ``big_align_plain`` is ``adaptive_align_plain`` run with this
configuration, and computes the same score (x-drop: the best score and its
position; with free query end gaps the best of row qlen and its position)
and step-cap overrun flag as the JAX kernel and ``BlockOracle``,
bit for bit.  Past 512 rows a grow's columns run long enough without an
offset rebase for a cell to reach the upper i16 rail, which the plain
version saturates as the reference does.

The TPU kernel's VMEM mechanism (row segments walked by a flat (step,
segment) loop, packed ACT/PAS/CC planes, HBM checkpoint planes with
DMA-staged blends, deferred swaps, saves, restores and shrinks, streamed
code and DP planes, and the code-keyed score fetch that assumes a symmetric
table) has no counterpart here: the CUDA kernel (``csrc/big_kernel.cu``)
keeps a pair's borders and checkpoint in shared memory, each thread a
contiguous run of a step's rows in registers, one to sixteen warps a pair
and several pairs a block (``launch_shape``), and reads scores from the
table by both codes.

Trace takes a layout sized by the block that ran (``ops/_trace.py``), not
the lane and adaptive kernels' dense (steps, B, max_size) words, which at
the (128, 1024) long-read band would take ~40 MB a pair: a pair writes the
rows of each step's height at its own running word counter, up to
``trace_budget`` words, and a step that would pass it stops the pair with
the overrun flag, as the step cap does.  With local start a step writes
its rows' zero bits as a second word a row, after its h trace words, so its
2 h words stay contiguous.  The JAX kernel's segment-compacted slots
(``big_kernel.py:167-182``) and its slot budget play these parts there; the
budget here is no smaller than theirs, so a pair never runs out where the
JAX kernel completes.

The modes read at run time (ByteMatrix and the three flags) run in
libraries of their own, with and without trace (``csrc/big_flags.cu``,
``csrc/big_trace_flags.cu``), as the lane and adaptive kernels' flags
instances do, so the global, x-drop and trace libraries compile the code
they had.  Sequence-to-PSSM pairs (``cfg.profile``) run in two more, with
the flags read at run time (``csrc/big_profile.cu``,
``csrc/big_trace_profile.cu``), on the inputs of
``ops/_profile.py::pack_profile`` with the JAX big kernel's clamp contract:
a table of ``cfg.prof_cap`` positions, every position past a profile's
rlen + 1 read as rlen + 1, the all-zero pad.

Codes are read from global memory, so ``seq_cap`` has no cap of its own: the
long-sequence classes of ``api.py`` size it, the step cap and the trace
budget from each batch's longest pair, where the JAX kernel's segmented
mode (``big_kernel.py:187-216``) streams per-pair code windows and its DP
state between launches.  Max size 16384 (``percent_len``'s clamp; the JAX
kernel's ``plane_stream``) runs in two libraries of its own
(``csrc/big_16384.cu``, ``csrc/big_trace_16384.cu``, the flags read at run
time, no profile) whose checkpoint planes live in a per-pair scratch the
wrapper allocates, (B, 4, 16384) int16.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..core.result import STEP
from . import _build
from ._trace import block_trace_buffers
from .adaptive_kernel import adaptive_align_plain
from .lane_kernel import (check_inputs, check_modes, count_launch, flag_bits,
                          mode_args, pack_lane, reset_counts, trace_words,
                          wide, x_value)

__all__ = ["BigKernelConfig", "pack_big", "big_align_plain", "big_align"]

LIBRARY = "big_kernel"  # csrc/big_kernel.cu
TRACE_LIBRARY = "big_trace"  # its trace instances, csrc/big_trace.cu
FLAGS_LIBRARY = "big_flags"  # its FLAGS instances, csrc/big_flags.cu
TRACE_FLAGS_LIBRARY = "big_trace_flags"  # csrc/big_trace_flags.cu
PROFILE_LIBRARY = "big_profile"  # its profile instances, csrc/big_profile.cu
TRACE_PROFILE_LIBRARY = "big_trace_profile"  # csrc/big_trace_profile.cu
# the 16384-row instances, csrc/big_16384.cu and csrc/big_trace_16384.cu
ROWS16384_LIBRARY = "big_16384"
TRACE_ROWS16384_LIBRARY = "big_trace_16384"
LIBRARIES = (LIBRARY, TRACE_LIBRARY, FLAGS_LIBRARY, TRACE_FLAGS_LIBRARY,
             PROFILE_LIBRARY, TRACE_PROFILE_LIBRARY, ROWS16384_LIBRARY,
             TRACE_ROWS16384_LIBRARY)
ROWS16384 = 16384  # the largest max_size (percent_len's clamp)
# trace words a pair may write at most: the kernel's word counters and
# budget are int32
MAX_TRACE_WORDS = (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class BigKernelConfig:
    min_size: int  # starting block size, a power of two >= 16
    max_size: int  # S: block-size cap, a power of two in 512..16384
    seq_cap: int  # code positions per sequence (position 0 is the NULL row)
    alpha: int = 32  # score-table side: 32 for amino acids, 16 for
    # nucleotides, 256 in byte mode
    x_drop: bool = False  # x-drop mode; the x value travels in the gaps
    trace: bool = False  # also return the block-sized trace (ops/_trace.py)
    byte_mode: bool = False  # ByteMatrix: equality scoring, alpha 256
    local_start: bool = False  # an alignment may start at any cell
    free_query_start_gaps: bool = False  # leading query gaps are free
    free_query_end_gaps: bool = False  # trailing query gaps are free
    profile: bool = False  # sequence-to-PSSM mode (ops/_profile.py)
    prof_cap: int = 0  # profile mode: the table's positions, a multiple
    # of 128 (JAX ``prof_cap``); 0 otherwise
    budget: int = 0  # trace words a pair may write; 0: ``trace_budget``'s
    # default

    def __post_init__(self):
        m, S = self.min_size, self.max_size
        if (m & (m - 1) or S & (S - 1) or m < 16 or not 512 <= S <= ROWS16384
                or m > S or m == S == 512):
            raise ValueError(
                "the big kernel takes powers of two min_size >= 16 and "
                f"max_size in 512..{ROWS16384} with min < max, or min == max "
                f"> 512, got ({m}, {S})")
        if self.profile and S > 8192:
            raise ValueError("the big kernel's profile instances take "
                             f"max_size up to 8192, got {S}")
        if self.seq_cap % 128 or self.seq_cap < max(256, S + 2 * STEP):
            raise ValueError(
                f"seq_cap must be a multiple of 128 and at least max(256, "
                f"max_size + {2 * STEP}), got {self.seq_cap}")
        if not 0 <= self.budget <= MAX_TRACE_WORDS:
            raise ValueError(f"budget must be in 0..{MAX_TRACE_WORDS} (the "
                             f"kernel counts words in int32), got "
                             f"{self.budget}")
        if (self.prof_cap % 128 or (self.prof_cap < 128 if self.profile
                                    else self.prof_cap)):
            raise ValueError("prof_cap must be a multiple of 128, at least "
                             f"128 in profile mode and 0 otherwise, got "
                             f"{self.prof_cap}")
        check_modes(self)

    @property
    def block(self) -> int:
        """``pack_lane`` packs for the largest block."""
        return self.max_size

    @property
    def max_steps(self) -> int:
        """Step cap of a pair (the JAX kernel's loop bound,
        ``big_kernel.py:277-281``)."""
        return (4 * self.seq_cap + 32 * self.max_size) // STEP

    @property
    def trace_budget(self) -> int:
        """Trace words (int32) a pair may write: ``budget`` if set, else
        the JAX kernel's default slot budget (``eff_trace_slots`` x ``seg``
        rows at seg 256, ``big_kernel.py:311-320``), every step at the min
        size or 256 rows and 8 steps at the max size, times the words a row
        takes (2 with local start, ``trace_words``), at most
        ``MAX_TRACE_WORDS``."""
        return self.budget or min(MAX_TRACE_WORDS, trace_words(self) * (
            self.max_steps * max(self.min_size, 256) + 8 * self.max_size))

    def walk_budget(self, walk: int) -> int:
        """A trace budget for pairs whose lengths sum to at most ``walk``:
        twice the steps of a walk straight to their end, at the min size or
        256 rows, and 8 steps at the max size, at most ``trace_budget``.
        The JAX default allows a pair that fills ``seq_cap`` as much; a
        pair that grows its block may pass it, and a long route runs it
        again with more (``api.py``)."""
        steps = 2 * (-(-walk // STEP))
        return min(self.trace_budget, trace_words(self) * (
            steps * max(self.min_size, 256) + 8 * self.max_size))

    @property
    def full_budget(self) -> int:
        """Trace words a pair can write at most: every step at the max
        size (no pair overruns a budget this large), or
        ``MAX_TRACE_WORDS`` if that is less."""
        return min(MAX_TRACE_WORDS,
                   trace_words(self) * self.max_steps * self.max_size)


def pack_big(pairs, matrix, cfg: BigKernelConfig, gaps, device,
             x_drop: int = 0):
    """Pack ``(query, reference)`` byte pairs for ``big_align``: the lane
    kernel's packing (``pack_lane``) for blocks of ``cfg.max_size``."""
    return pack_lane(pairs, matrix, cfg, gaps, device, x_drop)


def big_align_plain(codes, qlen, rlen, table, gaps, cfg: BigKernelConfig,
                    count_cells: bool = False, top_size: bool = False):
    """Plain PyTorch version: ``adaptive_align_plain`` on this
    configuration, all pairs in lockstep at the full width ``max_size``.
    Returns (B, 2) int32 (score, overrun), in x-drop mode and with free
    query end gaps (B, 4) (best score, its query position, its reference
    position, overrun); with
    ``cfg.trace`` ``(out, words, desc, steps, used)``, the block-sized
    trace of ``ops/_trace.py``, compacted step by step within
    ``cfg.trace_budget`` words a pair; with ``count_cells`` also each
    pair's DP cell count, (B,) int64, and with ``top_size`` the largest
    block size each pair reached, (B,) int32."""
    return adaptive_align_plain(
        codes, qlen, rlen, table, gaps, cfg, count_cells, top_size,
        budget=cfg.trace_budget if cfg.trace else None)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of ``csrc/big_kernel.cu`` (any of its
    libraries)."""
    lib.big_align_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
    lib.big_align_launch.restype = ctypes.c_int
    lib.big_launch_shape.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.big_launch_shape.restype = ctypes.c_int
    lib.big_error_string.argtypes = [ctypes.c_int]
    lib.big_error_string.restype = ctypes.c_char_p
    return lib


def library(cfg: BigKernelConfig) -> str:
    """The name of the ``csrc/`` library that holds ``cfg``'s instance: the
    trace library with trace, the FLAGS library with byte mode or a flag,
    the profile library (whose flags are read at run time) for profiles,
    the 16384-row library (flags read at run time too) past 8192 rows."""
    if cfg.max_size > 8192:
        return TRACE_ROWS16384_LIBRARY if cfg.trace else ROWS16384_LIBRARY
    if cfg.profile:
        return TRACE_PROFILE_LIBRARY if cfg.trace else PROFILE_LIBRARY
    if flag_bits(cfg):
        return TRACE_FLAGS_LIBRARY if cfg.trace else FLAGS_LIBRARY
    return TRACE_LIBRARY if cfg.trace else LIBRARY


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """A library of ``csrc/big_kernel.cu`` (``library``), built and bound."""
    return bind(_build.load(name))


def launch_shape(cfg: BigKernelConfig):
    """``(threads a block, dynamic shared bytes, blocks an SM, threads a
    pair, pairs a block, pairs an SM)`` of one launch of ``cfg``'s kernel
    instance on the current CUDA device, blocks an SM from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.  Raises
    ``ValueError`` where the device refuses the instance its shared memory
    (``cudaFuncSetAttribute`` past the 227 KB an H100 block may have)."""
    return _launch_shape(cfg, torch.cuda.current_device())


@functools.cache
def _launch_shape(cfg: BigKernelConfig, device: int):
    got = (ctypes.c_int * 6)()
    lib = _lib(library(cfg))
    err = lib.big_launch_shape(cfg.min_size, cfg.max_size, int(cfg.x_drop),
                               flag_bits(cfg), ctypes.addressof(got))
    if err:
        raise ValueError(
            f"the big kernel at ({cfg.min_size}, {cfg.max_size}) (trace "
            f"{cfg.trace}, flags {flag_bits(cfg)}) cannot have the shared "
            f"memory its planes need a thread block on this device: "
            f"{lib.big_error_string(err).decode()}")
    return tuple(got)


def big_align(codes, qlen, rlen, table, gaps, cfg: BigKernelConfig):
    """(score, overrun) per pair as a (B, 2) int32 tensor; in x-drop mode
    and with free query end gaps (best score, query position, reference
    position, overrun) as (B, 4).  With ``cfg.trace`` it returns ``(out,
    words, desc, steps, used)``, the block-sized trace of ``ops/_trace.py``:
    each pair wrote the descriptors of its own ``steps`` and ``used`` words;
    overrun is also set where a pair's trace would pass
    ``cfg.trace_budget``.

    CPU tensors take ``big_align_plain``; CUDA tensors launch the kernel of
    ``csrc/big_kernel.cu`` (the library ``library`` names) on the current
    stream, 1 to 16 warps a pair (``launch_shape``), or raise; past 8192
    rows with a scratch of (B, 4, 16384) int16 for the checkpoint planes.
    The wrapper
    counts its launches by instance (``lane_kernel.COUNTERS``):
    ``big_align.launches`` (global), ``xdrop_launches``, ``trace_launches``
    and ``xdrop_trace_launches``, and the same with ``profile_``,
    ``byte_`` or ``flags_`` (local start or free gaps) in front, and
    ``rows16384_`` in front of all past 8192 rows.

    In profile mode (``cfg.profile``) the inputs are those of
    ``ops/_profile.py::pack_profile``: codes (B, seq_cap) of the queries,
    table (B, prof_cap, 8) of the profiles' words."""
    if codes.device.type == "cpu":
        return big_align_plain(codes, qlen, rlen, table, gaps, cfg)
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"no big kernel for device {dev}")
    B = codes.shape[0]
    check_inputs(codes, qlen, rlen, table, cfg)
    out = torch.empty((B, 4 if wide(cfg) else 2), dtype=torch.int32,
                      device=dev)
    res, ptrs = (block_trace_buffers(out, cfg) if cfg.trace
                 else (out, (None,) * 4))
    if B == 0:
        return res
    scratch = (torch.empty((B, 4, cfg.max_size), dtype=torch.int16,
                           device=dev) if cfg.max_size > 8192 else None)
    lib = _lib(library(cfg))
    with torch.cuda.device(dev):
        launch_shape(cfg)  # raises where shared memory cannot hold it
        err = lib.big_align_launch(
            codes.data_ptr(), qlen.data_ptr(), rlen.data_ptr(),
            table.data_ptr(), out.data_ptr(), *ptrs,
            None if scratch is None else scratch.data_ptr(), B, cfg.seq_cap,
            cfg.alpha, cfg.min_size, cfg.max_size, cfg.max_steps,
            int(gaps[0]), int(gaps[1]), x_value(gaps, cfg),
            cfg.trace_budget if cfg.trace else 0, *mode_args(gaps, cfg),
            cfg.prof_cap, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("big kernel launch failed: "
                           f"{lib.big_error_string(err).decode()}")
    count_launch(big_align, cfg)
    return res


reset_counts(big_align)
