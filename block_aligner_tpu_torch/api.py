"""Batched alignment API of the port (counterpart of ``block_aligner_tpu/api.py``).

``BatchAligner`` serves three of the routes ``pick_route`` names:

* "lane": fixed block sizes (min == max <= 512), the lane kernel;
* "adaptive": growing and shrinking blocks (min < max <= 256, and max 512
  with trace), the adaptive kernel; the package's default size (32, 256)
  is one;
* "big": blocks past 512 (512 < max <= 8192, min == max > 512 included,
  and (min, 512) without trace), the big-block kernel; the reference's
  long-read bands (128, 1024) and (512, 8192) are two.

On all three routes it runs in global or x-drop mode (``x_drop=X``), with
or without trace (``trace=True``), with an amino-acid or nucleotide table
or a ``ByteMatrix`` (global and trace), and with the reference's
``local_start``, ``free_query_start_gaps`` and ``free_query_end_gaps``
flags.

In trace mode each batch's trace comes back to the host: ``trace()``,
``cigar`` and ``cigar_eq`` give the reference's CIGARs of the last batch,
and ``align_all_trace`` the CIGARs of any number of pairs.
``align_exp_all`` retries pairs with doubled min block sizes over the
three routes, global or x-drop.  ``ProfileAligner`` and
``align_profile_exp_all`` do the same for (query, ``AAProfile``) pairs,
sequence-to-PSSM, on the same three routes (min < max <= 512 adaptive,
min == max <= 512 lane, 512 < max <= 8192 big), with the same flags.  The
other routes ("long", "long_lane", "engine") and a mesh raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.cigar import Cigar
from .core.result import AlignResult
from .core.scores import ByteMatrix, Gaps
from .core.traceback import Trace
from .ops._profile import pack_profile
from .ops._trace import DESC_FIELDS
from .ops.adaptive_kernel import AdaptiveKernelConfig, adaptive_align
from .ops.big_kernel import BigKernelConfig, big_align
from .ops.lane_kernel import LaneKernelConfig, lane_align, pack_lane, wide

__all__ = ["BatchAligner", "ProfileAligner", "align_exp_all",
           "align_profile_exp_all", "pick_route", "round_up"]


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


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host, copied from a device through
    page-locked memory: a trace is hundreds of MB, and a pageable copy
    moves it at a fraction of the link's rate."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def _block_trace(words, desc, steps, used):
    """A block-sized trace (``ops/_trace.py``) on the host, as ``Trace``
    takes it: ``(words, desc, steps, offsets)``.  Only the descriptors
    of executed steps and the words each pair wrote (with local start each
    step's zero words after its trace words) cross to the host, as one
    int32 tensor gathered on the device, through ``to_host``."""
    steps_h = steps.cpu().numpy()
    used_h = used.cpu().numpy().astype(np.int64)
    T, B = (int(steps_h.max()) if steps_h.size else 0), steps_h.size
    ran = torch.arange(T, device=desc.device)[:, None] < steps[None, :]
    parts = [desc[:T][ran].reshape(-1)]
    parts += [words[b, :u] for b, u in enumerate(used_h.tolist()) if u]
    flat = to_host(torch.cat(parts))
    n = DESC_FIELDS * int(steps_h.sum())
    d = np.zeros((T, B, DESC_FIELDS), np.int32)
    d[np.arange(T)[:, None] < steps_h[None, :]] = flat[:n].reshape(
        -1, DESC_FIELDS)
    # pair b's words start at the sum of the counters before it
    base = np.cumsum(used_h) - used_h
    return flat[n:], d, steps_h, base[None, :] + d[:, :, 4]


# ROADMAP.md item that brings each configuration the port lacks
_SLICE = {
    "long": "queue 1 item 5 (long-sequence API)",
    "long_lane": "queue 1 item 5 (long-sequence API)",
    "engine": "queue 1 item 3 (PyTorch lockstep engine)",
    "mesh": "queue 1 item 6 (multi-GPU)",
}


def _not_yet(what: str, key: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md {_SLICE[key]}")


_KERNELS = {"lane": lane_align, "adaptive": adaptive_align,
            "big": big_align}


class _Routed:
    """What the aligners of the kernel routes share: a batch is
    packed (``_pack``), launched (``_dispatch``) and decoded (``_decode``);
    ``align_all`` pipelines the three over any number of pairs.  A
    subclass sets ``route``, ``cfg``, ``trace_mode``, ``device``,
    ``_batch``, ``matrix`` (None for profiles) and ``_pack``."""

    route: str
    matrix = None
    last_suspect: Optional[np.ndarray] = None
    _last_trace: Optional[Trace] = None

    @property
    def batch_size(self) -> int:
        return self._batch

    def _check_lengths(self, pairs):
        """Raise before any work if a pair cannot fit (the packer checks
        too)."""

    def _length(self, pair) -> int:
        """A pair's sort key in ``align_all``: its two lengths."""
        return len(pair[0]) + len(pair[1])

    def align_batch(self, pairs) -> List[AlignResult]:
        """Align up to ``batch_size`` pairs."""
        return self.align_staged(self._pack(pairs))

    def align_staged(self, staged) -> List[AlignResult]:
        """Run a batch prepared with ``stage``."""
        return self._decode(staged, self._dispatch(staged))

    def _dispatch(self, staged):
        """Launch the device work for a staged batch (asynchronous on CUDA)."""
        return _KERNELS[self.route](staged.codes, staged.qlen, staged.rlen,
                                    staged.table, staged.gaps, self.cfg)

    def _decode(self, staged, out) -> List[AlignResult]:
        """Fetch a dispatched batch's results; the lane route sets
        ``last_suspect``, the adaptive and big routes check the step cap
        (and the big route's trace budget).  Each holds the flag in its
        output's last column; x-drop mode and free query end gaps hold the
        best position in columns 1 and 2.  In trace mode the steps every
        pair executed (up to the batch's most) come back and make the
        ``Trace`` of ``trace()``; on the big route only the executed
        descriptors and the words each pair wrote."""
        flags = dict(local_start=self.cfg.local_start,
                     free_query_start_gaps=self.cfg.free_query_start_gaps)
        if self.trace_mode and self.route == "big":
            words, desc, steps, offsets = _block_trace(*out[1:])
            self._last_trace = Trace(words, desc, steps, self.matrix,
                                     offsets=offsets, **flags)
            out = out[0]
        elif self.trace_mode:
            out, words, desc, steps = out
            steps = steps.cpu().numpy()
            T = int(steps.max()) if steps.size else 0
            words, desc = to_host(words[:T]), to_host(desc[:T])
            self._last_trace = Trace(words, desc, steps, self.matrix,
                                     **flags)
        out = out.cpu().numpy()
        if self.route == "lane":
            self.last_suspect = out[:, -1].astype(bool)
        elif out[:, -1].any():
            budget = (f" or its trace budget ({self.cfg.trace_budget} words "
                      "a pair)" if self.trace_mode and self.route == "big"
                      else "")
            raise RuntimeError(
                f"{int(out[:, -1].sum())} pairs hit the {self.route} kernel's "
                f"step cap ({self.cfg.max_steps} steps){budget}; raise "
                "seq_cap")
        if wide(self.cfg):
            ql, rl = out[:, 1], out[:, 2]
        else:
            ql, rl = staged.qlen.cpu().numpy(), staged.rlen.cpu().numpy()
        return [AlignResult(int(sc), int(q), int(r))
                for sc, q, r in zip(out[:, 0], ql, rl)]

    def align_all(self, pairs, sort: bool = True) -> List[AlignResult]:
        """Align any number of pairs in batches of ``batch_size``.

        ``sort=True`` aligns in length-sorted order and unsorts the
        results, so the pairs of one batch have similar lengths.  The next
        batch is packed while the device aligns the current one."""
        self._check_lengths(pairs)
        sort = sort and not self.trace_mode and len(pairs) > 1
        if sort:
            order = sorted(range(len(pairs)),
                           key=lambda k: self._length(pairs[k]))
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
            staged = self._pack(work[k : k + self.batch_size])
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

    # trace accessors (reference: Block::trace, src/scan_block.rs:1241)
    def trace(self) -> Trace:
        """The last batch's trace."""
        if not self.trace_mode:
            raise ValueError(f"no trace: this {type(self).__name__} has "
                             "trace=False")
        if self._last_trace is None:
            raise ValueError("no trace yet: align a batch first")
        return self._last_trace

    def cigar(self, k: int, i: int, j: int,
              cigar: Optional[Cigar] = None) -> Cigar:
        """The CIGAR of pair ``k`` of the last batch, from end (i, j)."""
        return self.trace().cigar(k, i, j, cigar)


class BatchAligner(_Routed):
    """Batched aligner on one device, on the lane, adaptive or big route.

    Same surface as the JAX package's ``BatchAligner`` for those routes:
    ``align_batch``, ``align_all``, ``stage``/``align_staged``,
    ``batch_size``, ``seq_capacity`` and, on the lane route only,
    ``last_suspect`` (per-pair y-drop suspect flags of the last call: True
    where the reference's adaptive heuristic would have grown the block).
    Global mode returns each pair's score at (qlen, rlen); with ``x_drop``
    a pair ends once its block's maximum falls more than ``x_drop`` below
    its best, and the result is the best score and its position.
    ``local_start`` lets an alignment start at any cell,
    ``free_query_start_gaps`` makes leading query gaps free, and
    ``free_query_end_gaps`` trailing ones (the result is then the best
    score of the query's last row and its position; every query must be
    shorter than the min block size).  A ``ByteMatrix`` scores raw bytes by
    equality (no x-drop, as in the reference).  With
    ``trace`` the last batch's trace stays on the host (``trace()``,
    ``cigar``, ``cigar_eq``); ``align_all`` then keeps the caller's order
    and the last batch's trace, and ``align_all_trace`` returns every
    pair's CIGAR.  The big route (blocks past 512) runs every mode too.
    ``device``
    places the packed tensors: a CUDA device runs the kernels, the CPU
    their plain versions.
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
        if local_start and free_query_start_gaps:
            # the reference's exclusion (src/scan_block.rs:853-854)
            raise ValueError(
                "local_start and free_query_start_gaps exclude each other")
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
        if route not in ("lane", "adaptive", "big"):
            _not_yet(f"route {route!r} (size {size}, seq_cap {seq_cap})", route)
        if use_lane_kernel is False:
            _not_yet("use_lane_kernel=False", "engine")
        if mesh is not None:
            _not_yet("mesh", "mesh")
        self.matrix = matrix
        self.gaps = gaps
        self.x_drop = x_drop
        self.trace_mode = trace
        self._last_trace: Optional[Trace] = None
        self.device = torch.device(device)
        self._batch = batch
        self.route = route
        cap = round_up(max(1 + seq_cap + max_size + 16, 256), 128)
        alpha = {"nuc": 16, "byte": 256}.get(matrix.kind, 32)
        modes = dict(x_drop=x_drop is not None, trace=trace,
                     byte_mode=is_byte, local_start=local_start,
                     free_query_start_gaps=free_query_start_gaps,
                     free_query_end_gaps=free_query_end_gaps)
        if route == "lane":
            self.cfg = LaneKernelConfig(min_size, cap, alpha, **modes)
        elif route == "adaptive":
            self.cfg = AdaptiveKernelConfig(min_size, max_size, cap, alpha,
                                            **modes)
        else:
            self.cfg = BigKernelConfig(min_size, max_size, cap, alpha, **modes)
        self.last_suspect: Optional[np.ndarray] = None

    @property
    def seq_capacity(self) -> int:
        return self.cfg.seq_cap - self.cfg.block - 17

    def _check_lengths(self, pairs):
        cap = self.seq_capacity
        free_end = self.cfg.free_query_end_gaps
        for q, r in pairs:
            if max(len(q), len(r)) > cap:
                raise ValueError(
                    "sequence too long for this BatchAligner's seq_cap")
            if free_end and len(q) >= self.cfg.min_size:
                # the reference's requirement (src/scan_block.rs:862)
                raise ValueError("free_query_end_gaps requires min block "
                                 "size > query len")

    def stage(self, pairs):
        """Pack a batch onto the device; ``align_staged`` runs it, as often
        as wanted, without packing again, traced too on the big route.
        Adaptive trace has no staged runs (the JAX package refuses them
        too): use ``align_batch``."""
        if self.trace_mode and self.route == "adaptive":
            raise ValueError("stage/align_staged do not run adaptive trace: "
                             "use align_batch, align_all or align_all_trace")
        return self._pack(pairs)

    def _pack(self, pairs):
        if len(pairs) > self.batch_size:
            raise ValueError(
                f"{len(pairs)} pairs exceed batch_size {self.batch_size}")
        self._check_lengths(pairs)
        return pack_lane(pairs, self.matrix, self.cfg, self.gaps, self.device,
                         self.x_drop or 0)

    def align_all_trace(self, pairs: Sequence[Tuple[bytes, bytes]],
                        eq: bool = False):
        """``(results, cigars)`` for any number of pairs, in order: each
        batch's trace comes back and its CIGARs are walked
        (``Trace.cigars_all``) while the device aligns the next batch.
        With ``eq`` the CIGARs hold = and X in place of M."""
        if not self.trace_mode:
            raise ValueError("align_all_trace needs BatchAligner(trace=True)")
        self._check_lengths(pairs)
        results: List[AlignResult] = []
        cigars: List[Cigar] = []

        def walk(staged, disp, chunk):
            got = self._decode(staged, disp)
            results.extend(got)
            ends = [(g.query_idx, g.reference_idx) for g in got]
            cigars.extend(self._last_trace.cigars_all(
                ends, eq=eq, seqs=chunk if eq else None))

        pending = None
        for k in range(0, len(pairs), self.batch_size):
            chunk = list(pairs[k : k + self.batch_size])
            staged = self._pack(chunk)
            disp = self._dispatch(staged)
            if pending is not None:
                walk(*pending)
            pending = (staged, disp, chunk)
        if pending is not None:
            walk(*pending)
        return results, cigars

    def cigar_eq(self, k: int, q, r, i: int, j: int,
                 cigar: Optional[Cigar] = None) -> Cigar:
        """``cigar`` with = and X for M, comparing the codes of the pair's
        query ``q`` and reference ``r``."""
        return self.trace().cigar_eq(k, q, r, i, j, cigar)


def align_exp_all(matrix, gaps: Gaps, pairs, target_scores,
                  size: Tuple[int, int] = (32, 256), *,
                  x_drop: Optional[int] = None, batch: int = 256,
                  seq_cap: int = 1024, device="cuda"):
    """Batched exponential search on the min block size (reference:
    Block::align_exp, src/scan_block.rs:884-902), global or with
    ``x_drop``.

    Each pair is retried with a doubled min block size until its score
    reaches its target or the min size passes the max (levels past 512 take
    the big route).  Returns
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


class ProfileAligner(_Routed):
    """Batched sequence-to-PSSM aligner on one device (reference:
    align_profile, src/scan_block.rs:942-995).  Pairs are ``(query bytes,
    AAProfile)``: the profile plays the reference, with its
    position-specific scores and gap open and close costs.

    The JAX package's ``ProfileAligner`` surface and routes: the adaptive
    kernel for ``min < max <= 512``, the lane kernel for ``min == max <=
    512`` and the big kernel for ``512 < max <= 8192``, global or with
    ``x_drop``, with or without ``trace``, with the flags of
    ``BatchAligner``: ``align_batch``, ``align_all`` (length-sorted outside
    trace), ``stage``/``align_staged`` (without trace), ``batch_size``,
    ``last_suspect`` on the lane route, ``trace()`` and ``cigar``.  All
    profiles of a batch share one gap extension.  ``prof_len`` (default
    ``seq_cap``) sizes the big kernel's profile table: profiles up to
    ``prof_len`` positions, as in the JAX package.  The engine
    (``use_lane_kernel=False``) and a mesh raise ``NotImplementedError``
    naming the ROADMAP item that brings them; blocks past 8192 raise
    ``ValueError`` as in the JAX package.  ``device`` places the packed
    tensors: a CUDA device runs the kernels, the CPU their plain versions.
    """

    def __init__(
        self,
        size: Tuple[int, int] = (32, 256),
        *,
        batch: int = 64,
        seq_cap: int = 1024,
        trace: bool = False,
        x_drop: Optional[int] = None,
        local_start: bool = False,
        free_query_start_gaps: bool = False,
        free_query_end_gaps: bool = False,
        mesh=None,
        use_lane_kernel: Optional[bool] = None,
        prof_len: Optional[int] = None,
        device="cuda",
    ):
        # the reference's flag exclusions (src/scan_block.rs:952-954), the
        # JAX package's AssertionError
        if local_start and free_query_start_gaps:
            raise AssertionError(
                "local_start and free_query_start_gaps exclude each other")
        if x_drop is not None and free_query_end_gaps:
            raise AssertionError(
                "x_drop and free_query_end_gaps exclude each other")
        if x_drop is not None and x_drop < 0:
            raise ValueError(f"x_drop must be >= 0, got {x_drop}")
        if batch < 1:
            raise ValueError(f"batch must be positive, got {batch}")
        min_size = max(size[0], 16)
        max_size = max(size[1], min_size)
        kernels = use_lane_kernel is not False
        if kernels and min_size < max_size <= 512:
            route = "adaptive"
        elif kernels and 512 < max_size <= 8192:
            route = "big"
        elif min_size == max_size <= 512 and (use_lane_kernel is None
                                              or use_lane_kernel):
            route = "lane"
        elif kernels:
            raise ValueError(
                f"ProfileAligner block sizes {min_size}-{max_size} exceed "
                "the big kernel's 8192 cap; pass use_lane_kernel=False "
                "to run on the ~100x slower XLA engine anyway")
        else:
            route = "engine"
        if route == "engine":
            _not_yet("use_lane_kernel=False", route)
        if mesh is not None:
            _not_yet("mesh", "mesh")
        self.x_drop = x_drop
        self.trace_mode = trace
        self.device = torch.device(device)
        self._batch = batch
        self.route = route
        cap = round_up(max(1 + seq_cap + max_size + 16, 256), 128)
        modes = dict(x_drop=x_drop is not None, trace=trace, profile=True,
                     local_start=local_start,
                     free_query_start_gaps=free_query_start_gaps,
                     free_query_end_gaps=free_query_end_gaps)
        if route == "lane":
            self.cfg = LaneKernelConfig(min_size, cap, **modes)
        elif route == "adaptive":
            self.cfg = AdaptiveKernelConfig(min_size, max_size, cap, **modes)
        else:
            # the JAX package's table of prof_len + 10 positions
            # (api.py:1049-1050)
            prof_cap = round_up(
                (seq_cap if prof_len is None else prof_len) + 10, 128)
            self.cfg = BigKernelConfig(min_size, max_size, cap, **modes,
                                       prof_cap=prof_cap)

    def _length(self, pair) -> int:
        return len(pair[0]) + (pair[1].str_len if pair[1] else 0)

    def _check_lengths(self, pairs):
        if self.cfg.free_query_end_gaps:
            for q, _ in pairs:
                # the reference's requirement (src/scan_block.rs:954), the
                # JAX package's AssertionError
                if len(q) >= self.cfg.min_size:
                    raise AssertionError("free_query_end_gaps requires min "
                                         "block size > query len")

    def stage(self, pairs):
        """Pack a batch onto the device; ``align_staged`` runs it, as often
        as wanted, without packing again.  Trace has no staged runs (the
        JAX package refuses them too): use ``align_batch``."""
        if self.trace_mode:
            raise ValueError("ProfileAligner.stage/align_staged do not run "
                             "trace: use align_batch or align_all")
        return self._pack(pairs)

    def _pack(self, pairs):
        if len(pairs) > self.batch_size:
            raise ValueError(
                f"{len(pairs)} pairs exceed batch_size {self.batch_size}")
        self._check_lengths(pairs)
        return pack_profile(pairs, self.cfg, self.device, self.x_drop or 0)


def align_profile_exp_all(pairs, target_scores,
                          size: Tuple[int, int] = (32, 256), *,
                          x_drop: Optional[int] = None, batch: int = 256,
                          seq_cap: int = 1024, device="cuda"):
    """Batched exponential search on the min block size for ``(query,
    AAProfile)`` pairs (reference: Block::align_profile_exp,
    src/scan_block.rs:907-925), global or with ``x_drop``: the retry
    ladder of ``align_exp_all``, each level a ``ProfileAligner``."""
    min_size, max_size = size
    results: List[Optional[AlignResult]] = [None] * len(pairs)
    min_sizes: List[Optional[int]] = [None] * len(pairs)
    pending = list(range(len(pairs)))
    cur = max(min_size, 16)
    while pending and cur <= max_size:
        al = ProfileAligner((cur, max_size), batch=batch, seq_cap=seq_cap,
                            x_drop=x_drop, device=device)
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
