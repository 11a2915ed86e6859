"""Traceback: the reference's CIGAR walker and the decoder of the kernels'
trace output (counterpart of ``block_aligner_tpu/core/traceback.py``).

``op_lut`` and ``cigar_walk`` are the reference's backwards block walk with
its 2x64-entry OP_LUT (reference: src/scan_block.rs:1469-1672), copied from
the JAX package: they walk any ordered list of rect records.

Both kernels in trace mode (``ops/lane_kernel.py``, ``ops/adaptive_kernel.py``)
return, for every step ``s`` a pair ``b`` executed:

* ``words[s, b, row]`` (int32): the traceback bits of the step's 8 columns,
  column ``w`` in bits ``4w..4w+3`` as ``t | t2 << 2`` (reference:
  src/scan_block.rs:1166-1190);
* ``desc[s, b]`` (int32 x 4): flags, lane start, column start, height; the
  flags are ``right | rectstart << 1 | save << 2 | restore << 3``.  A step
  with ``rectstart`` opens a rect at (lane start, column start) in its own
  orientation; the steps after it add 8 columns each until the next rect
  opens.  ``save`` marks the current rect count and ``restore`` pops the
  rects back to the mark (a grow restarting from its checkpoint, reference:
  src/scan_block.rs:1451-1462); both belong before the step's own rect, save
  first;
* ``steps[b]``: the steps the pair executed.  Rows of later steps, and rows
  at or past a step's height, hold whatever the buffer held before.

The big kernel (``ops/big_kernel.py``) writes a block-sized layout: a step
writes only the rows of its height, at a running per-pair word counter, and
its descriptor carries a fifth field, the counter before the step (its word
offset, ``ops/_trace.py``).  ``Trace`` reads both layouts through per-step
offsets: row ``lane`` of step ``t`` of pair ``b`` is word ``offsets[t, b] +
lane`` of the flattened words, where the dense layout's offsets are ``(t *
B + b) * W``.  A rect's steps share its height, so when a kernel writes its
steps in order, a rect's words are ``n * h`` contiguous words.

In local-start mode each step has a second word per row after the S words
of its 4-bit cells, ``words[s, b, S + row]``: bit ``w`` says that column
``w``'s D equals the relative zero (reference: src/scan_block.rs:1184-1186),
where the walk stops.  In the block-sized layout a step's zero words follow
its h words of 4-bit cells: row ``lane``'s is word ``offsets[t, b] + h +
lane``.  With free query start gaps the walk stops at query row 0 of a
right rect.

``Trace`` replays the events into each pair's rect list and walks CIGARs
from it, one pair at a time (``cigar``) or every pair of a batch at once in
numpy (``cigars_all``); ``TraceParts`` does the same for a batch whose
trace came back in parts (a long route's traced sub-batches, ``api.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from .cigar import Cigar, Operation

STEP_ = 8  # reference STEP (src/scan_block.rs:785)

# descriptor flags
F_RIGHT, F_START, F_SAVE, F_RESTORE = 1, 2, 4, 8

__all__ = ["cigar_walk", "op_lut", "Rectangle", "Trace", "TraceParts"]

_OP_LUT_CACHE = None


def op_lut():
    """The 2x64-entry traceback LUT keyed by (trace<<4 | trace2<<2 | table)
    (reference: src/scan_block.rs:1506-1572)."""
    global _OP_LUT_CACHE
    if _OP_LUT_CACHE is not None:
        return _OP_LUT_CACHE
    D, C, R = 0, 1, 2
    OpD, OpI, OpM = Operation.D, Operation.I, Operation.M
    lut = [[(OpD, 0, 1, D)] * 64, [(OpD, 0, 1, D)] * 64]
    for right in (0, 1):
        for t in range(4):
            for t2 in range(4):
                for table in (D, C, R):
                    if right == 1:
                        if table == C:
                            res = (OpD, 0, 1, C) if t2 in (0b00, 0b10) else (OpD, 0, 1, D)
                        elif table == R:
                            res = (OpI, 1, 0, R) if t2 in (0b00, 0b01) else (OpI, 1, 0, D)
                        else:  # D
                            if t == 0b00:
                                res = (OpM, 1, 1, D)
                            elif t in (0b01, 0b11):
                                res = (
                                    (OpD, 0, 1, C) if t2 in (0b00, 0b10) else (OpD, 0, 1, D)
                                )
                            else:  # t == 0b10
                                res = (
                                    (OpI, 1, 0, R) if t2 in (0b00, 0b01) else (OpI, 1, 0, D)
                                )
                    else:
                        if table == R:
                            res = (OpI, 1, 0, R) if t2 in (0b00, 0b10) else (OpI, 1, 0, D)
                        elif table == C:
                            res = (OpD, 0, 1, C) if t2 in (0b00, 0b01) else (OpD, 0, 1, D)
                        else:
                            if t == 0b00:
                                res = (OpM, 1, 1, D)
                            elif t in (0b01, 0b11):
                                res = (
                                    (OpI, 1, 0, R) if t2 in (0b00, 0b10) else (OpI, 1, 0, D)
                                )
                            else:
                                res = (
                                    (OpD, 0, 1, C) if t2 in (0b00, 0b01) else (OpD, 0, 1, D)
                                )
                    lut[right][(t << 4) | (t2 << 2) | table] = res
    _OP_LUT_CACHE = lut
    return lut


def cigar_walk(
    rects,
    i: int,
    j: int,
    *,
    local_start: bool = False,
    free_query_start_gaps: bool = False,
    eq: bool = False,
    q=None,
    r=None,
    cigar: Optional[Cigar] = None,
) -> Cigar:
    """Walk backwards from DP cell (i, j) over an ordered rect list.

    Rect records need fields ``row``, ``col``, ``right`` and indexable
    ``t``, ``t2`` (and ``zero`` when ``local_start``) of shape
    [place_col, lane] (reference walk: src/scan_block.rs:1576-1632).
    """
    if cigar is None:
        cigar = Cigar()
    cigar.clear()
    if eq:
        assert q is not None and r is not None

    lut = op_lut()
    TABLE_D = 0
    table = TABLE_D
    rect_idx = len(rects)

    outer_done = False
    while (i > 0 or j > 0) and not outer_done:
        # scan rects backward for the one containing (i, j); the reference
        # checks only lower bounds (reference: src/scan_block.rs:1578-1590)
        while True:
            rect_idx -= 1
            rect = rects[rect_idx]
            if i >= rect.row and j >= rect.col:
                break

        bi, bj = rect.row, rect.col
        while i >= bi and j >= bj and (i > 0 or j > 0):
            if rect.right:
                if free_query_start_gaps and i == 0:
                    # the i == 0 row can only be inside right rects
                    outer_done = True
                    break
                pc, lane = j - bj, i - bi  # place col = DP col offset
            else:
                pc, lane = i - bi, j - bj  # place col = DP row offset
            t = int(rect.t[pc, lane])
            t2 = int(rect.t2[pc, lane])
            if local_start and table == TABLE_D and rect.zero[pc, lane]:
                outer_done = True
                break
            op, di, dj, table = lut[1 if rect.right else 0][(t << 4) | (t2 << 2) | table]
            if eq and op == Operation.M:
                op = Operation.Eq if q.get(i) == r.get(j) else Operation.X
            i -= di
            j -= dj
            cigar.add(op)

    return cigar


def _packed_lut():
    """``op_lut`` as one int64 array indexed by ``right << 6 | key``: op |
    di << 3 | dj << 4 | next table << 5."""
    lut = op_lut()
    return np.array([int(op) | di << 3 | dj << 4 | tab << 5
                     for right in (0, 1) for op, di, dj, tab in lut[right]],
                    dtype=np.int64)


# a cell's 4 bits t | t2 << 2 -> its LUT key bits t << 4 | t2 << 2
_NIB_KEY = np.array([(n & 3) << 4 | (n >> 2) << 2 for n in range(16)],
                    dtype=np.int64)


class Rectangle(NamedTuple):
    """A computed rect in DP coordinates (reference: src/scan_block.rs
    ``Rectangle``, 1676-1691)."""

    row: int
    col: int
    width: int
    height: int


class _Codes:
    """1-based code view of a sequence for ``cigar_walk``'s =/X test."""

    __slots__ = ("codes",)

    def __init__(self, codes):
        self.codes = codes

    def get(self, i: int) -> int:
        return int(self.codes[i])


class _Rect:
    """One rect of a pair's replayed list: ``n`` steps from step ``t0``.
    Its bits unpack, as ``[place_col, lane]`` arrays, on first use; a
    step's zero words lie ``rows`` words past its first row."""

    __slots__ = ("row", "col", "right", "h", "t0", "n", "_flat", "_off", "_t",
                 "_t2", "_zero", "_rows")

    def __init__(self, row, col, right, h, t0, n, flat, off, rows):
        self.row, self.col, self.right, self.h = row, col, right, h
        self.t0, self.n = t0, n
        self._flat, self._rows = flat, rows
        self._off = off[t0 : t0 + n]  # the word offsets of the rect's steps
        self._t = self._t2 = self._zero = None

    def _read(self, shift):
        """The (n, h) words ``shift`` words past each step's first row."""
        return self._flat[self._off[:, None] + shift + np.arange(self.h)]

    def _mat(self):
        if self._t is None:
            w = self._read(0)
            sh = (4 * np.arange(STEP_))[None, :, None]
            nib = ((w[:, None, :] >> sh) & 15).reshape(STEP_ * self.n, self.h)
            self._t, self._t2 = nib & 3, nib >> 2
        return self

    @property
    def t(self):
        return self._mat()._t

    @property
    def t2(self):
        return self._mat()._t2

    @property
    def zero(self):
        """Local start's zero bits, ``[place_col, lane]``."""
        if self._zero is None:
            w = self._read(self._rows)
            sh = np.arange(STEP_)[None, :, None]
            self._zero = ((w[:, None, :] >> sh) & 1).reshape(
                STEP_ * self.n, self.h)
        return self._zero


class Trace:
    """One batch's trace output (numpy, on the host): the rect lists of its
    pairs and the CIGARs walked from them.

    ``words`` (T, B, S), (T, B, 2S) with ``local_start``, ``desc`` (T, B,
    4) and ``steps`` (B,) are as the module docstring describes, with T at
    least the largest step count.  With ``offsets`` (T, B) the layout is the
    block-sized one: step ``t`` of pair ``b`` starts at word ``offsets[t,
    b]`` of ``words``' flat view (with ``local_start`` its zero words
    follow its h words), and ``desc`` may carry the offsets as a fifth
    field, which ``Trace`` does not read.  ``matrix`` converts sequences to codes
    for ``cigar_eq`` and ``cigars_all(eq=True)``: M resolves into = or X by
    code, as the reference compares its padded codes (a ``ByteMatrix``'s
    codes are the bytes).  ``local_start`` and ``free_query_start_gaps``
    are the flags the trace was computed with; the walks stop where they
    say."""

    def __init__(self, words, desc, steps, matrix=None, *, offsets=None,
                 local_start: bool = False,
                 free_query_start_gaps: bool = False):
        self.words = np.asarray(words)
        self.desc = np.asarray(desc)
        self.steps = np.asarray(steps).astype(np.int64).reshape(-1)
        self.matrix = matrix
        self.local_start = local_start
        self.free_query_start_gaps = free_query_start_gaps
        T, B = self.desc.shape[:2]
        if offsets is None:
            if self.words.shape[:2] != (T, B):
                raise ValueError(f"trace shapes disagree: words "
                                 f"{self.words.shape}, desc {self.desc.shape}")
            W = self.words.shape[-1]
            # the rows of a step's 4-bit cells
            self.rows = W // (2 if local_start else 1)
            offsets = (np.arange(T)[:, None] * B + np.arange(B)) * W
        else:
            # a step's zero words follow its own h words
            self.rows = 0
        self.offsets = np.asarray(offsets, dtype=np.int64)
        if self.offsets.shape != (T, B) or self.steps.shape != (B,):
            raise ValueError(
                f"trace shapes disagree: desc {self.desc.shape}, offsets "
                f"{self.offsets.shape}, steps {self.steps.shape}")
        self._flat = self.words.reshape(-1)
        if B and int(self.steps.max()) > T:
            raise ValueError(f"steps up to {int(self.steps.max())} exceed the "
                             f"{T} steps of the trace")
        self._replay()

    def _replay(self):
        """Replay every pair's rect starts and checkpoint events in step
        order (numpy over the pairs); only flags of executed steps count."""
        T, B = self.desc.shape[:2]
        ran = np.arange(T)[:, None] < self.steps[None, :]
        fl = np.where(ran, self.desc[:, :, 0], 0)
        start = (fl & F_START) != 0
        save = (fl & F_SAVE) != 0
        restore = (fl & F_RESTORE) != 0
        # a rect's steps run to the next rect start or restore, or the end:
        # _stop[t, b] is where a rect of pair b that opens at step t stops
        at = np.where(start | restore, np.arange(T, dtype=np.int32)[:, None],
                      np.int32(T))
        nxt = np.minimum.accumulate(at[::-1], axis=0)[::-1]
        nxt = np.concatenate([nxt[1:], np.full((min(T, 1), B), T, np.int32)])
        self._stop = np.minimum(nxt, self.steps[None, :].astype(np.int32))
        cap = max(int(start.sum(0).max()) if T and B else 0, 1)
        t0 = np.zeros((B, cap), np.int64)
        nrect = np.zeros(B, np.int64)
        saved = np.zeros(B, np.int64)
        for t in range(T):
            if save[t].any():
                m = save[t]
                saved[m] = nrect[m]
            if restore[t].any():
                m = restore[t]
                nrect[m] = saved[m]
            b = np.flatnonzero(start[t])
            t0[b, nrect[b]] = t
            nrect[b] += 1
        self.nrect = nrect
        self.r_t0 = t0

    def _rect_origin(self, b, k):
        """(right, row, col, first step, steps, height) of rect ``k[x]`` of
        pair ``b[x]``."""
        t = self.r_t0[b, k]
        d = self.desc[t, b].astype(np.int64)
        right = (d[:, 0] & F_RIGHT) != 0
        return (right, np.where(right, d[:, 1], d[:, 2]),
                np.where(right, d[:, 2], d[:, 1]), t,
                self._stop[t, b].astype(np.int64) - t, d[:, 3])

    def rects_for(self, b: int) -> List[_Rect]:
        """Pair ``b``'s rect list, oldest first."""
        n = int(self.nrect[b])
        right, row, col, t0, steps, h = self._rect_origin(np.full(n, b),
                                                          np.arange(n))
        return [_Rect(int(row[x]), int(col[x]), bool(right[x]), int(h[x]),
                      int(t0[x]), int(steps[x]), self._flat,
                      self.offsets[:, b], self.rows or int(h[x]))
                for x in range(n)]

    def blocks(self, b: int) -> List[Rectangle]:
        """Pair ``b``'s computed rects (the reference's ``Trace::blocks``,
        src/scan_block.rs:1676-1691)."""
        out = []
        for r in self.rects_for(b):
            if r.right:
                out.append(Rectangle(r.row, r.col, STEP_ * r.n, r.h))
            else:
                out.append(Rectangle(r.row, r.col, r.h, STEP_ * r.n))
        return out

    def _codes(self, seq) -> np.ndarray:
        if self.matrix is None:
            raise ValueError("cigar_eq needs the Trace's matrix")
        return np.concatenate([np.zeros(1, np.uint8),
                               self.matrix.convert(seq).astype(np.uint8)])

    def cigar(self, b: int, i: int, j: int,
              cigar: Optional[Cigar] = None) -> Cigar:
        """Pair ``b``'s CIGAR, walked back from DP cell (i, j)."""
        return cigar_walk(self.rects_for(b), i, j, cigar=cigar,
                          **self._flags())

    def _flags(self):
        return dict(local_start=self.local_start,
                    free_query_start_gaps=self.free_query_start_gaps)

    def cigar_eq(self, b: int, q, r, i: int, j: int,
                 cigar: Optional[Cigar] = None) -> Cigar:
        """``cigar`` with M resolved into = and X by comparing the codes of
        query ``q`` and reference ``r``."""
        return cigar_walk(self.rects_for(b), i, j, eq=True,
                          q=_Codes(self._codes(q)), r=_Codes(self._codes(r)),
                          cigar=cigar, **self._flags())

    def cigars_all(self, endpoints, *, eq: bool = False,
                   seqs=None) -> List[Cigar]:
        """The CIGARs of pairs 0..len(endpoints)-1, ``endpoints[b] = (i,
        j)`` each pair's end position, walked in lockstep: every iteration
        takes one op of every unfinished pair, each pair with its own rect
        pointer.  Equal to ``cigar``/``cigar_eq`` of each pair, and like
        them it raises where a walk leaves its rects' cells.  With ``eq``,
        ``seqs`` holds the (query, reference) pairs."""
        ij = np.asarray(endpoints, dtype=np.int64).reshape(-1, 2)
        n = ij.shape[0]
        if n > self.desc.shape[1]:
            raise ValueError(f"{n} endpoints for a trace of "
                             f"{self.desc.shape[1]} pairs")
        T = self.desc.shape[0]
        S = self.rows
        lut = _packed_lut()
        words = self._flat
        ar = np.arange(n)
        i, j = ij[:, 0].copy(), ij[:, 1].copy()
        if eq:
            if seqs is None or len(seqs) != n:
                raise ValueError("cigars_all(eq=True) needs one (query, "
                                 "reference) pair per endpoint")
            qs = [self._codes(q) for q, _ in seqs]
            rs = [self._codes(r) for _, r in seqs]
            qc = np.zeros((n, max(map(len, qs), default=1)), np.uint8)
            rc = np.zeros((n, max(map(len, rs), default=1)), np.uint8)
            for k in range(n):
                qc[k, : len(qs[k])] = qs[k]
                rc[k, : len(rs[k])] = rs[k]
        table = np.zeros(n, np.int64)
        ridx = self.nrect[:n].copy()
        bi, bj, t0, rn, rh, rbase = (np.zeros(n, np.int64) for _ in range(6))
        right = np.zeros(n, bool)
        # pairs whose walk stopped at a local start or at query row 0
        stopped = np.zeros(n, bool)
        active = (i > 0) | (j > 0)
        need = active.copy()
        ops = []
        while True:
            # pairs that left their rect scan back for the next one holding
            # (i, j); like the reference, only lower bounds are checked
            while need.any():
                b = np.flatnonzero(need)
                ridx[b] -= 1
                if (ridx[b] < 0).any():
                    bad = b[ridx[b] < 0][:5].tolist()
                    raise RuntimeError(f"traceback of pairs {bad} left their "
                                       "rects")
                rr, row, col, rt, steps, h = self._rect_origin(b, ridx[b])
                hit = (i[b] >= row) & (j[b] >= col)
                f = b[hit]
                bi[f], bj[f], right[f] = row[hit], col[hit], rr[hit]
                t0[f], rn[f], rh[f] = rt[hit], steps[hit], h[hit]
                rbase[f] = right[f] << 6
                need[f] = False
            if not active.any():
                break
            # the cell's place column and lane in its rect, its word
            di, dj = i - bi, j - bj
            pc = np.where(right, dj, di)
            lane = di + dj - pc
            out = active & (((pc >> 3) >= rn) | (lane >= rh))
            if out.any():
                bad = np.flatnonzero(out)[:5].tolist()
                raise RuntimeError(f"traceback of pairs {bad} reached a cell "
                                   "past their rect's steps or height")
            # finished pairs read word 0 and ignore it
            t = np.clip(t0 + (pc >> 3), 0, max(T - 1, 0))
            flat = np.where(active, self.offsets[t, ar] + lane, 0)
            w = words[flat].astype(np.int64)
            stop = np.zeros(n, bool)
            if self.free_query_start_gaps:
                stop |= right & (i == 0)
            if self.local_start:
                # the zero word: S words on (dense), or h (block-sized)
                zw = words[flat + np.where(active, S or rh, 0)]
                z = (zw.astype(np.int64) >> (pc & 7)) & 1
                stop |= (table == 0) & (z == 1)
            stop &= active
            if stop.any():
                stopped |= stop
                active &= ~stop
            nib = (w >> ((pc & 7) << 2)) & 15
            # finished pairs take op 0 and stay where they are
            code = lut[rbase | _NIB_KEY[nib] | table] * active
            op = code & 7
            if eq:
                same = qc[ar, np.clip(i, 0, qc.shape[1] - 1)] == \
                    rc[ar, np.clip(j, 0, rc.shape[1] - 1)]
                op = np.where(op == Operation.M,
                              np.where(same, Operation.Eq, Operation.X), op)
            i -= (code >> 3) & 1
            j -= (code >> 4) & 1
            table = code >> 5
            ops.append(op.astype(np.int8))
            active = ((i > 0) | (j > 0)) & ~stopped
            need = active & ((i < bi) | (j < bj))
        return _runs_to_cigars(ops, n)


class TraceParts:
    """One batch's trace taken in parts, as a long route runs a traced
    batch in sub-batches (``api.py``): ``pairs[k][l]`` is the batch index
    of pair ``l`` of ``traces[k]``, or -1 where that pair stands for none
    (it ran again in a later part).  It walks CIGARs as ``Trace`` does, each
    pair in its part."""

    def __init__(self, traces, pairs):
        self.traces = list(traces)
        self.pairs = [np.asarray(p, dtype=np.int64) for p in pairs]
        n = sum(int((p >= 0).sum()) for p in self.pairs)
        self.part = np.zeros(n, np.int64)
        self.local = np.zeros(n, np.int64)
        for k, idx in enumerate(self.pairs):
            at = np.flatnonzero(idx >= 0)
            self.part[idx[at]] = k
            self.local[idx[at]] = at

    def _at(self, b: int):
        return self.traces[self.part[b]], int(self.local[b])

    def blocks(self, b: int) -> List[Rectangle]:
        tr, k = self._at(b)
        return tr.blocks(k)

    def cigar(self, b: int, i: int, j: int,
              cigar: Optional[Cigar] = None) -> Cigar:
        tr, k = self._at(b)
        return tr.cigar(k, i, j, cigar)

    def cigar_eq(self, b: int, q, r, i: int, j: int,
                 cigar: Optional[Cigar] = None) -> Cigar:
        tr, k = self._at(b)
        return tr.cigar_eq(k, q, r, i, j, cigar)

    def cigars_all(self, endpoints, *, eq: bool = False,
                   seqs=None) -> List[Cigar]:
        """``Trace.cigars_all`` over the parts: each part walks its pairs in
        lockstep, a pair that stands for none or lies past
        ``len(endpoints)`` from (0, 0), an empty walk."""
        ij = np.asarray(endpoints, dtype=np.int64).reshape(-1, 2)
        n = ij.shape[0]
        out: List[Optional[Cigar]] = [None] * n
        for tr, idx in zip(self.traces, self.pairs):
            mine = (idx >= 0) & (idx < n)
            ends = np.zeros((len(idx), 2), np.int64)
            ends[mine] = ij[idx[mine]]
            part_seqs = ([seqs[b] if m else (b"", b"")
                          for b, m in zip(idx, mine)] if eq else None)
            for b, m, c in zip(idx, mine,
                               tr.cigars_all(ends, eq=eq, seqs=part_seqs)):
                if m:
                    out[b] = c
        return out


def _runs_to_cigars(ops, n: int) -> List[Cigar]:
    """Per-iteration op arrays of a lockstep walk (0: no op) -> one Cigar
    per pair, its runs in forward order."""
    if not ops:
        return [Cigar._from_forward_runs(np.zeros((0, 2), np.int64))
                for _ in range(n)]
    seq = np.stack(ops[::-1], 1)  # (n, iters), forward order per pair
    live = seq != 0
    vals = seq[live].astype(np.int64)
    cnt = live.sum(1)
    off = np.concatenate([[0], np.cumsum(cnt)])
    first = np.zeros(vals.size, bool)
    first[off[:-1][cnt > 0]] = True
    first[1:] |= vals[1:] != vals[:-1]
    starts = np.flatnonzero(first)
    lens = np.diff(np.append(starts, vals.size))
    runs = np.stack([vals[starts], lens], 1)
    roff = np.searchsorted(starts, off)
    return [Cigar._from_forward_runs(runs[roff[b] : roff[b + 1]])
            for b in range(n)]
