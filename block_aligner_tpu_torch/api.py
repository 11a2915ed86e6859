"""Batched alignment API of the port (counterpart of ``block_aligner_tpu/api.py``).

``BatchAligner`` serves two of the routes ``pick_route`` names, in global
or x-drop mode (``x_drop=X``) without trace, with an amino-acid or
nucleotide table:

* "lane": fixed block sizes (min == max <= 512), the lane kernel;
* "adaptive": growing and shrinking blocks (min < max <= 256), the adaptive
  kernel; the package's default size (32, 256) is one.

``align_exp_all`` retries pairs with doubled min block sizes over both, in
either mode.  The other routes ("big", "long", "long_lane", "engine"),
trace, ByteMatrix, the local-start and free-gap flags and a mesh raise
``NotImplementedError`` naming the ROADMAP slice that brings them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.result import AlignResult
from .core.scores import ByteMatrix, Gaps
from .ops.adaptive_kernel import AdaptiveKernelConfig, adaptive_align
from .ops.lane_kernel import LaneKernelConfig, lane_align, pack_lane

__all__ = ["BatchAligner", "align_exp_all", "pick_route", "round_up"]


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_route(min_size: int, max_size: int, seq_cap: int, *,
               trace: bool = False, x_drop: Optional[int] = None,
               local_start: bool = False,
               free_query_start_gaps: bool = False,
               free_query_end_gaps: bool = False,
               is_byte: bool = False):
    """The JAX package's kernel-routing decision, unchanged.

    Returns ``(path, reasons)``: path is one of "adaptive", "big", "lane",
    "long", "long_lane" or "engine"; ``reasons`` is non-empty exactly when
    path == "engine" and says why no kernel serves the configuration."""
    min_size = max(min_size, 16)
    max_size = max(max_size, min_size)
    capv = round_up(max(1 + seq_cap + max_size + 16, 256), 128)
    if (min_size < max_size and max_size <= 512
            and (max_size < 512 or trace) and capv <= 16384):
        return "adaptive", []
    if ((512 < max_size <= 8192
         or (max_size == 512 and min_size < max_size))
            and capv <= 16384):
        return "big", []
    if min_size == max_size and min_size <= 512 and capv <= 16384:
        return "lane", []
    if (not free_query_end_gaps and 128 <= max_size <= 16384
            and (min_size < max_size or max_size > 512)):
        return "long", []
    if (not free_query_end_gaps and not is_byte
            and min_size == max_size and min_size <= 512):
        return "long_lane", []
    reasons = []
    if max_size > 16384:
        reasons.append(
            "max block size > 16384 (past percent_len's clamp)"
        )
    elif free_query_end_gaps:
        reasons.append(
            "free_query_end_gaps past the resident budget (requires min "
            "block > query length, so never legitimately over-budget)"
        )
    elif is_byte:
        reasons.append(
            "segmented ByteMatrix -- the lane driver's equality scoring "
            "does not stream byte codes"
        )
    elif max_size < 128:
        reasons.append(
            "adaptive bands under 128 past the code budget (big kernel "
            "floor is 128)"
        )
    return "engine", reasons or ["unrouted configuration"]


# ROADMAP.md slice that brings each configuration the port lacks
_SLICE = {
    "big": "queue 2 slice 6, kernel C (big blocks)",
    "long": "queue 1 item 7 (long-sequence API)",
    "long_lane": "queue 1 item 7 (long-sequence API)",
    "engine": "queue 1 item 4 (PyTorch lockstep engine)",
    "trace": "queue 2 slice 2 (trace: A3 + B)",
    "byte": "queue 2 slice 4 (ByteMatrix: A5 + B)",
    "flags": "queue 2 slice 5 (local-start and free gaps: A6 + B)",
    "mesh": "queue 1 item 8 (multi-GPU)",
}


def _not_yet(what: str, key: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md {_SLICE[key]}")


class BatchAligner:
    """Batched aligner on one device, on the lane or adaptive route.

    Same surface as the JAX package's ``BatchAligner`` for those routes:
    ``align_batch``, ``align_all``, ``stage``/``align_staged``,
    ``batch_size``, ``seq_capacity`` and, on the lane route only,
    ``last_suspect`` (per-pair y-drop suspect flags of the last call: True
    where the reference's adaptive heuristic would have grown the block).
    Global mode returns each pair's score at (qlen, rlen); with ``x_drop``
    a pair ends once its block's maximum falls more than ``x_drop`` below
    its best, and the result is the best score and its position.
    ``device`` places the packed tensors: a CUDA device runs the kernels,
    the CPU their plain versions.
    """

    def __init__(
        self,
        matrix,
        gaps: Gaps,
        size: Tuple[int, int] = (32, 256),
        *,
        batch: int = 256,
        seq_cap: int = 1024,
        trace: bool = False,
        x_drop: Optional[int] = None,
        local_start: bool = False,
        free_query_start_gaps: bool = False,
        free_query_end_gaps: bool = False,
        mesh=None,
        use_lane_kernel: Optional[bool] = None,
        device="cuda",
    ):
        if not (gaps.open < 0 and gaps.extend < 0):
            raise ValueError("Gap costs must be negative!")
        if not gaps.open < gaps.extend:
            raise ValueError("Gap open must cost more than gap extend!")
        if batch < 1:
            raise ValueError(f"batch must be positive, got {batch}")
        min_size = max(size[0], 16)
        max_size = max(size[1], min_size)
        is_byte = isinstance(matrix, ByteMatrix)
        if x_drop is not None:
            # the JAX package's and the reference's own rejections
            if x_drop < 0:
                raise ValueError(f"x_drop must be >= 0, got {x_drop}")
            if free_query_end_gaps:
                raise ValueError(
                    "x_drop and free_query_end_gaps exclude each other")
            if is_byte:
                raise ValueError("x-drop with ByteMatrix is not supported "
                                 "(same as the reference)")
        route, _ = pick_route(
            min_size, max_size, seq_cap, trace=trace, x_drop=x_drop,
            local_start=local_start,
            free_query_start_gaps=free_query_start_gaps,
            free_query_end_gaps=free_query_end_gaps, is_byte=is_byte,
        )
        if route not in ("lane", "adaptive"):
            _not_yet(f"route {route!r} (size {size}, seq_cap {seq_cap})", route)
        if use_lane_kernel is False:
            _not_yet("use_lane_kernel=False", "engine")
        if trace:
            _not_yet("trace", "trace")
        if local_start or free_query_start_gaps or free_query_end_gaps:
            _not_yet("local_start / free_query_start_gaps / "
                     "free_query_end_gaps", "flags")
        if is_byte:
            _not_yet("ByteMatrix", "byte")
        if mesh is not None:
            _not_yet("mesh", "mesh")
        self.matrix = matrix
        self.gaps = gaps
        self.x_drop = x_drop
        self.device = torch.device(device)
        self._batch = batch
        self.route = route
        cap = round_up(max(1 + seq_cap + max_size + 16, 256), 128)
        alpha = 32 if matrix.kind != "nuc" else 16
        xd = x_drop is not None
        if route == "lane":
            self.cfg = LaneKernelConfig(min_size, cap, alpha, xd)
        else:
            self.cfg = AdaptiveKernelConfig(min_size, max_size, cap, alpha, xd)
        self.last_suspect: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return self._batch

    @property
    def seq_capacity(self) -> int:
        return self.cfg.seq_cap - self.cfg.block - 17

    def _check_lengths(self, pairs):
        cap = self.seq_capacity
        for q, r in pairs:
            if max(len(q), len(r)) > cap:
                raise ValueError(
                    "sequence too long for this BatchAligner's seq_cap")

    def align_batch(self, pairs: Sequence[Tuple[bytes, bytes]]) -> List[AlignResult]:
        """Align up to ``batch_size`` pairs."""
        return self.align_staged(self.stage(pairs))

    def stage(self, pairs):
        """Pack a batch onto the device; ``align_staged`` runs it, as often
        as wanted, without packing again."""
        if len(pairs) > self.batch_size:
            raise ValueError(
                f"{len(pairs)} pairs exceed batch_size {self.batch_size}")
        self._check_lengths(pairs)
        return pack_lane(pairs, self.matrix, self.cfg, self.gaps, self.device,
                         self.x_drop or 0)

    def align_staged(self, staged) -> List[AlignResult]:
        """Run a batch prepared with ``stage``."""
        return self._decode(staged, self._dispatch(staged))

    def _dispatch(self, staged):
        """Launch the device work for a staged batch (asynchronous on CUDA)."""
        kernel = lane_align if self.route == "lane" else adaptive_align
        return kernel(staged.codes, staged.qlen, staged.rlen, staged.table,
                      staged.gaps, self.cfg)

    def _decode(self, staged, out) -> List[AlignResult]:
        """Fetch a dispatched batch's results; the lane route sets
        ``last_suspect``, the adaptive route checks the step cap.  Both
        hold the flag in their output's last column; x-drop mode holds the
        best position in columns 1 and 2."""
        out = out.cpu().numpy()
        if self.route == "lane":
            self.last_suspect = out[:, -1].astype(bool)
        elif out[:, -1].any():
            raise RuntimeError(
                f"{int(out[:, -1].sum())} pairs hit the adaptive kernel's step "
                f"cap ({self.cfg.max_steps} steps); raise seq_cap")
        if self.cfg.x_drop:
            ql, rl = out[:, 1], out[:, 2]
        else:
            ql, rl = staged.qlen.cpu().numpy(), staged.rlen.cpu().numpy()
        return [AlignResult(int(sc), int(q), int(r))
                for sc, q, r in zip(out[:, 0], ql, rl)]

    def align_all(self, pairs: Sequence[Tuple[bytes, bytes]],
                  sort: bool = True) -> List[AlignResult]:
        """Align any number of pairs in batches of ``batch_size``.

        ``sort=True`` aligns in length-sorted order and unsorts the
        results, so the pairs of one batch have similar lengths.  The next
        batch is packed while the device aligns the current one."""
        self._check_lengths(pairs)
        sort = sort and len(pairs) > 1
        if sort:
            order = sorted(range(len(pairs)),
                           key=lambda k: len(pairs[k][0]) + len(pairs[k][1]))
            work = [pairs[k] for k in order]
        else:
            order = None
            work = pairs
        lane = self.route == "lane"
        got: List[AlignResult] = []
        flags = []

        def finish(staged, disp):
            got.extend(self._decode(staged, disp))
            if lane:
                flags.append(self.last_suspect)

        pending = None
        for k in range(0, len(work), self.batch_size):
            staged = self.stage(work[k : k + self.batch_size])
            disp = self._dispatch(staged)
            if pending is not None:
                finish(*pending)
            pending = (staged, disp)
        if pending is not None:
            finish(*pending)
        if order is not None:
            out: List[Optional[AlignResult]] = [None] * len(pairs)
            for pos, k in enumerate(order):
                out[k] = got[pos]
            got = out
        if lane:
            sus = np.concatenate(flags) if flags else np.zeros(0, bool)
            if order is not None:
                self.last_suspect = np.zeros(len(pairs), bool)
                self.last_suspect[np.asarray(order)] = sus
            else:
                self.last_suspect = sus
        return got


def align_exp_all(matrix, gaps: Gaps, pairs, target_scores,
                  size: Tuple[int, int] = (32, 256), *,
                  x_drop: Optional[int] = None, batch: int = 256,
                  seq_cap: int = 1024, device="cuda"):
    """Batched exponential search on the min block size (reference:
    Block::align_exp, src/scan_block.rs:884-902), global or with
    ``x_drop``.

    Each pair is retried with a doubled min block size until its score
    reaches its target or the min size passes the max.  Returns
    ``(results, min_sizes)``: ``min_sizes[k]`` is the min size that reached
    the target, or None.  Pairs under target are batched together at each
    level, so the work per level shrinks with them; each level has one
    aligner."""
    min_size, max_size = size
    results: List[Optional[AlignResult]] = [None] * len(pairs)
    min_sizes: List[Optional[int]] = [None] * len(pairs)
    pending = list(range(len(pairs)))
    cur = max(min_size, 16)
    while pending and cur <= max_size:
        al = BatchAligner(matrix, gaps, (cur, max_size), batch=batch,
                          seq_cap=seq_cap, x_drop=x_drop, device=device)
        still = []
        for k, got in zip(pending, al.align_all([pairs[k] for k in pending])):
            results[k] = got
            if got.score >= target_scores[k]:
                min_sizes[k] = cur
            else:
                still.append(k)
        pending = still
        cur *= 2
    return results, min_sizes
