"""Adaptive-block alignment of a batch of pairs, global or x-drop: the plain
PyTorch version and the wrapper of the CUDA kernel.

Counterpart of ``block_aligner_tpu/ops/adaptive_kernel.py``:
``build_adaptive_engine`` (min_size < max_size <= 256, 512 with trace or a
profile), in global and in x-drop mode, with or without trace, scoring
sequence pairs by a table or by byte equality (``cfg.byte_mode``) or
(query, profile) pairs by the profile (``cfg.profile``,
``ops/_profile.py``), with or without the local-start and free-gap flags
of ``ops/lane_kernel.py``.  Both versions here compute what that kernel
computes, bit for bit: the final score of every pair (x-drop and free end
gaps: the best score and its position) and whether the pair hit the step
cap.

The machine (reference: src/scan_block.rs:101-593).  A pair's state is the
step machine of ``ops/lane_kernel.py`` (an ACT/PAS border pair, i16 values
relative to ``ZERO`` plus an i32 offset) with a current block size
``min_size <= sz <= max_size`` and one of four rect phases:

* R and D: an 8-column shift right or down, as in the lane kernel; the
  offset is rebased at its start and the passive border shifts by 8 at its
  end.
* GROW_D then GROW_R: a grow in two halves.  The block doubles and restarts
  from the checkpoint ``(CK_I, CK_J, CK_OFF)`` and its four border planes:
  GROW_D computes the new query rows ``psz..sz-1`` against the old width
  (lanes = reference), then ACT and PAS swap and GROW_R computes the new
  reference columns against the full height (lanes = query).  The initial
  rect is a GROW_R with ``psz == 0``, where the DP origin is set.
* After each rect but GROW_D: the running maximum drives the offset, the
  y-drop counter and the checkpoint (saved on a new best while
  ``sz < max_size``, and its borders again after every grow); forced moves
  go down once the block covers the reference's end, then right once it
  covers the query's; a free rect grows when the best stalled for sz/8
  rects (or the last grow found no new best), else shrinks to half when its
  border suffix holds the rect maximum, else moves towards the larger
  8-row border head.
* A pair freezes at the column where its rect covers (qlen, rlen) and
  reaches the last column, never inside GROW_D.

X-drop mode has no freeze.  The lane kernel's 16-residue tracker
(``ops/lane_kernel.py``) runs over the rows inside the rect height; GROW_D
banks its candidate and GROW_R restarts the tracker, and a grow rect's new
best takes the GROW_R position unless the GROW_D one is strictly higher
(reference: src/scan_block.rs:463-482).  A pair ends at a rect's decision,
after its checkpoint save and before its grow, shrink or move: when the
rect maximum falls more than x below the best at two decisions in a row,
or when the rect covers both ends.

The flags act as in the lane kernel, in every rect phase: local start
raises D to the relative zero of the rect's offset, free start gaps
re-seed row 0 of every right or GROW_R rect whose query start is 0 (after
a restore too: the checkpoint's anchor decides), and free end gaps run
the tracker over both grow halves and take row qlen's residue as the rect
maximum (offset, y-drop counter, checkpoint, shrink), its column as the
best's, restart the tracker at each decision and end a pair once its rect
covers both ends.

The TPU kernel keeps per-side score stacks that it rebuilds on every
restore; here every lane re-reads its own code at the rect's lane start, so
a restore only moves the anchor.  The plain version runs all pairs in
lockstep under masks on (B, S) int32 tensors at the full width S, as the
JAX kernel does; the kernel runs one warp per pair
(``csrc/adaptive_kernel.cu``).  Rows at or past the rect height never feed
rows below it, so what the two hold there may differ without changing any
result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..core.result import I16_MAX, I16_MIN, STEP, ZERO
from ..core.traceback import F_RESTORE, F_RIGHT, F_SAVE, F_START
from . import _build
from ._profile import ProfileFetch
from ._trace import (DESC_FIELDS, as_int32, compact_step, stack_steps,
                     trace_bits, trace_buffers)
from .lane_kernel import (check_inputs, check_modes, count_launch, library,
                          mode_args, reset_counts, trace_words, wide, x_value)

__all__ = ["AdaptiveKernelConfig", "adaptive_align_plain", "adaptive_align"]

NEG = I16_MIN
INT_MIN = -(1 << 31)

# rect phases; the initial rect is a GROW_R with psz == 0 (the reference's
# direction = Grow start state)
DIR_R, DIR_D, DIR_GD, DIR_GR = 0, 1, 2, 3

SHRINK_SUFFIX_LEN = STEP // 4  # reference: src/scan_block.rs:786


@dataclasses.dataclass(frozen=True)
class AdaptiveKernelConfig:
    min_size: int  # starting block size, a power of two >= 16
    max_size: int  # S: block-size cap, a power of two <= 256 (512 with
    # trace or profile)
    seq_cap: int  # code positions per sequence (position 0 is the NULL row)
    alpha: int = 32  # score-table side: 32 for amino acids, 16 for nucleotides
    x_drop: bool = False  # x-drop mode; the x value travels in the gaps
    trace: bool = False  # also return the traceback bits (core/traceback.py)
    profile: bool = False  # sequence-to-PSSM mode (ops/_profile.py)
    byte_mode: bool = False  # ByteMatrix: equality scoring, alpha 256
    local_start: bool = False  # an alignment may start at any cell
    free_query_start_gaps: bool = False  # leading query gaps are free
    free_query_end_gaps: bool = False  # trailing query gaps are free
    # a profile table's positions when not seq_cap (the big kernel's
    # ``prof_cap``); a class constant here
    prof_cap = 0

    def __post_init__(self):
        m, S = self.min_size, self.max_size
        top = 512 if self.trace or self.profile else 256
        if m & (m - 1) or S & (S - 1) or not 16 <= m < S <= top:
            raise ValueError(
                f"min_size < max_size must be powers of two in 16..{top}, got "
                f"({m}, {S})" + ("" if top == 512 else
                                 " (max_size 512 runs with trace only)"))
        if self.seq_cap % STEP or self.seq_cap < S + 2 * STEP:
            raise ValueError(
                f"seq_cap must be a multiple of {STEP} and at least "
                f"max_size + {2 * STEP}, got {self.seq_cap}")
        check_modes(self)

    @property
    def block(self) -> int:
        """``pack_lane`` packs for the largest block."""
        return self.max_size

    @property
    def max_steps(self) -> int:
        """Step cap of a pair (the JAX kernel's loop bound)."""
        return (4 * self.seq_cap + 32 * self.max_size) // STEP


def _sat(x):
    # i16 saturation at both rails, as the reference's adds: a grow's columns
    # run without a rebase, so with large scores (a ByteMatrix) or past 512
    # rows (``ops/big_kernel.py``) a cell reaches the upper one
    return x.clamp(NEG, I16_MAX)


def adaptive_align_plain(codes, qlen, rlen, table, gaps,
                         cfg: AdaptiveKernelConfig, count_cells: bool = False,
                         top_size: bool = False, budget=None):
    """Plain PyTorch version: all pairs in lockstep under masks.

    Returns a (B, 2) int32 tensor of (score, overrun), overrun 1 where a
    pair did not finish within ``cfg.max_steps`` steps, or in x-drop mode
    (x = ``gaps[2]``) and with free query end gaps a (B, 4) tensor of (best
    score, its query position, its reference position, overrun).  Code positions are clamped to
    ``seq_cap - 1`` and codes to ``alpha - 1``, as the kernel does;
    ``pack_lane`` output never needs either.  With ``cfg.trace`` it returns
    ``(out, words, desc, steps)``, the trace of ``core/traceback.py`` with
    T the most steps of any pair, a checkpoint save or restore in the
    descriptor of the step after the one that decided it.  With
    ``count_cells`` it also returns, last, each pair's DP cell count, (B,)
    int64: the rect height for every column up to and including the freeze
    column (x-drop: every column of every step up to the one that ends the
    pair).  With ``top_size`` it also returns, last, the largest block size
    each pair reached, (B,) int32.

    With a trace ``budget`` (words a pair may write) the trace takes the big
    kernel's block-sized layout (``ops/_trace.py``), compacted step by step:
    ``(out, words (B, budget), desc (T, B, 5), steps, used)``; a pair whose
    next step's rows would pass the budget stops there with the overrun
    flag, as at the step cap; with local start a step writes its h trace
    words, then its rows' h zero words."""
    S, MIN, A, cap = cfg.max_size, cfg.min_size, cfg.alpha, cfg.seq_cap
    dev = codes.device
    B = codes.shape[0]
    open_, e = int(gaps[0]), int(gaps[1])
    xd = cfg.x_drop
    fe = cfg.free_query_end_gaps
    i32 = torch.int32
    if cfg.profile:
        # the big kernel's table clamps profile positions to rlen + 1
        fetch = ProfileFetch(codes, table, e,
                             rlen if cfg.prof_cap else None)
    else:
        seqs = codes.long().clamp(max=A - 1)
        if cfg.byte_mode:
            match, mismatch = int(gaps[3]), int(gaps[4])
        else:
            tab = table.reshape(-1).to(i32)
    ql, rl = qlen.to(i32), rlen.to(i32)
    rows = torch.arange(S, device=dev)
    cols = torch.arange(STEP, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    zc = (e * (rows % STEP + 1)).to(i32)
    # the gap scan max_{q <= p} (v[q] + e (p - q)) as e p + a running
    # max of v[q] - e q
    erows = (e * rows).to(i32)

    def full(v, shape=(B,)):
        return torch.full(shape, v, dtype=i32, device=dev)

    def col(x):
        return x[:, None]

    def down_by(x, k):
        """row r <- row r + k[pair], rows past S filled with NEG."""
        src = rows + col(k)
        got = x.gather(1, src.clamp(max=S - 1))
        return torch.where(src < S, got, NEG)

    actD, actC, pasD, pasR = (full(0, (B, S)) for _ in range(4))
    ckcD, ckcC, ckrD, ckrR = (full(0, (B, S)) for _ in range(4))
    tempD, tempR = full(0, (B, STEP)), full(0, (B, STEP))
    (I, J, off, offmax, out, psz, cpos, ckI, ckJ, ckOff, best,
     yiter) = (full(0) for _ in range(12))
    sz, gnm = full(MIN), full(1)  # the initial rect is a grow
    dirn, pdir = full(DIR_GR), full(DIR_GR)
    corn, dmax = full(NEG), full(NEG)
    rest = torch.zeros(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    cells = torch.zeros(B, dtype=torch.int64, device=dev)
    top = sz.clone()
    tr = cfg.trace
    if tr:
        # per step: words (B, S), descriptors (B, 4); executed steps per
        # pair; the checkpoint events waiting for the next descriptor
        t_words, t_desc = [], []
        nsteps, pend = full(0), full(0)
        zcol = full(0, (B, 1))
        if budget is not None:
            t_buf = torch.zeros((B, budget), dtype=i32, device=dev)
            used = full(0)
    halted = torch.zeros(B, dtype=torch.bool, device=dev)
    if wide(cfg):
        x = int(gaps[2])
        r16 = torch.arange(16, dtype=i32, device=dev)
        chunk = torch.arange(S // 16, dtype=i32, device=dev)[:, None]
        q16 = (ql % 16).long()[:, None]
        # the tracker (running max, chunk origin, column per residue), the
        # GROW_D half's banked candidate, the best's position
        xvm, xai, xaj = full(INT_MIN, (B, 16)), full(0, (B, 16)), full(0, (B, 16))
        gdmax, gdbi, gdbj = full(INT_MIN), full(0), full(0)
        xbi, xbj, xiter = full(0), full(0), full(0)

        def tracker_best():
            """The max over residues, and at the lowest residue holding it
            the position in the rect's (lane, column) axes."""
            cm = xvm.amax(1)
            ridx = torch.where(xvm == cm[:, None], r16, 16).amin(1, True)
            sel = r16 == ridx
            return (cm, torch.where(sel, xai + r16, INT_MIN).amax(1),
                    torch.where(sel, xaj, INT_MIN).amax(1))
    s = 0
    while s < cfg.max_steps and not bool(done.all()):
        if tr and budget is not None:
            # a step whose rows pass the budget stops the pair: an overrun
            halt = ~done & (used + trace_words(cfg)
                            * torch.where(dirn == DIR_GD, psz, sz) > budget)
            halted |= halt
            done = done | halt
            if bool(done.all()):
                break
        # ---- rect step start ----
        shift = (dirn == DIR_R) | (dirn == DIR_D)
        right_or = (dirn == DIR_R) | (dirn == DIR_GR)  # lanes = query
        # checkpoint restore, flagged by the last step's grow
        r_ = col(rest)
        actD, actC = torch.where(r_, ckrD, actD), torch.where(r_, ckrR, actC)
        pasD, pasR = torch.where(r_, ckcD, pasD), torch.where(r_, ckcC, pasR)
        rest = torch.zeros_like(rest)
        # offset rebase at a shift's start (reference: src/scan_block.rs:148-151)
        reb = shift & ~done
        new_off = torch.where(reb, offmax, off)
        oa = torch.where(reb, (off - new_off).clamp(I16_MIN, I16_MAX), 0)
        off = new_off
        actD, actC = _sat(actD + col(oa)), _sat(actC + col(oa))
        corner_ok = reb & (((dirn == DIR_R) & (pdir == DIR_D))
                           | ((dirn == DIR_D) & (pdir == DIR_R)))
        cvec = torch.where(corner_ok, _sat(corn + oa), NEG)
        # the rect maximum restarts with each rect; GROW_R continues GROW_D's
        dmax = torch.where((cpos == 0) & (dirn != DIR_GR) & ~done, NEG, dmax)
        # this step's geometry and freeze predicate
        h = torch.where(dirn == DIR_GD, psz, sz)
        ls = torch.where(right_or, I, J)
        cstart = torch.where(
            dirn == DIR_R, J + sz - STEP,
            torch.where(dirn == DIR_D, I + sz - STEP,
                        torch.where(dirn == DIR_GD, I + psz + cpos,
                                    J + psz + cpos)))
        lane_len = torch.where(right_or, ql, rl)
        col_len = torch.where(right_or, rl, ql)
        fra = (ls + h > lane_len) & (dirn != DIR_GD)
        frt = col_len - cstart
        fridx = (lane_len - ls).clamp(0, S - 1)
        if tr:
            ran = ~done
            nsteps += ran.to(i32)
            flags = (right_or.to(i32) * F_RIGHT
                     | (cpos == 0).to(i32) * F_START | pend)
            # the block-sized layout's fifth field: the step's word offset
            t_desc.append(torch.stack([flags, ls, cstart, h] + (
                [] if budget is None else [used]), 1))
            pend = full(0)
            word = torch.zeros((B, S), dtype=torch.int64, device=dev)
            zword = torch.zeros((B, S), dtype=torch.int64, device=dev)
        # the relative zero of local start and free start gaps; free start
        # gaps re-seed row 0 of a right rect at query row 0
        rz = (ZERO - off).clamp(I16_MIN, I16_MAX)
        ins0 = right_or & (I == 0)
        lpos = (col(ls) + rows).clamp(max=cap - 1)
        cp = (col(cstart) + cols).clamp(max=cap - 1)
        if cfg.profile:
            fetch.step(right_or, lpos, cp)
        else:
            lane_side = col((~right_or).long())
            lanec = seqs[bidx, lane_side, lpos]  # (B, S)
            colc = seqs[bidx, 1 - lane_side, cp]  # (B, STEP)
        origin = (dirn == DIR_GR) & (psz == 0) & (cpos == 0) & (J == 0)
        inrect = rows < col(h)
        hrow = col((h - 1).long())
        gact = col(~shift & ~done)
        for w in range(STEP):
            if cfg.profile:
                scores, copen, dopen, close = fetch.column(w)
            else:
                if cfg.byte_mode:
                    scores = torch.where(colc[:, w : w + 1] == lanec, match,
                                         mismatch).to(i32)
                else:
                    scores = tab[colc[:, w : w + 1] * A + lanec]
                copen, dopen = open_, open_ - e
            corner = cvec if w == 0 else full(NEG)
            D11 = _sat(torch.cat([col(corner), actD[:, :-1]], 1) + scores)
            if w == 0:
                D11[:, 0] = torch.where(origin, ZERO, D11[:, 0])
            if cfg.local_start:
                D11 = torch.maximum(D11, col(rz))
            elif cfg.free_query_start_gaps:
                D11[:, 0] = torch.where(ins0, rz, D11[:, 0])
            C11_open = _sat(actD + copen)
            C11 = torch.maximum(_sat(actC + e), C11_open)
            # profile: a right rect closes C before the merge, a down rect
            # R; the stored C and R stay pre-close
            c_end = (torch.where(fetch.right, _sat(C11 + close), C11)
                     if cfg.profile else C11)
            D11 = torch.maximum(D11, c_end)
            # max-plus prefix scan, then the zero correction
            D11_open = t = (_sat(D11 + dopen) if cfg.profile
                            else D11 + dopen)
            t = torch.cummax(t - erows, 1).values + erows
            R11 = torch.maximum(t, zc)
            r_end = (torch.where(fetch.right, R11, _sat(R11 + close))
                     if cfg.profile else R11)
            D11 = torch.maximum(D11, r_end)
            if tr:
                # a frozen pair's later columns stay out of its last word
                word |= torch.where(
                    col(done), 0,
                    trace_bits(D11, c_end, r_end, C11, C11_open, R11,
                               D11_open, zcol) << (4 * w))
                if cfg.local_start:
                    zword |= ((D11 == col(rz)) & ~col(done)).long() << w
            dmax = torch.maximum(dmax, torch.where(inrect, D11, NEG).amax(1))
            actD, actC = D11, C11
            bot_d, bot_r = D11.gather(1, hrow), R11.gather(1, hrow)
            # a shift stages its bottom cells; a grow half writes them
            # straight into the passive border at row psz + cpos + w
            tempD[:, w], tempR[:, w] = bot_d[:, 0], bot_r[:, 0]
            gm = gact & (rows == col(psz + cpos + w))
            pasD = torch.where(gm, bot_d, pasD)
            pasR = torch.where(gm, bot_r, pasR)
            cells += torch.where(done, 0, h)
            if wide(cfg):
                # the lane kernel's tracker over the rows inside the height
                Dr = torch.where(inrect, D11, NEG).view(B, S // 16, 16)
                vm = torch.maximum(xvm, Dr.amax(1))
                eq = Dr == vm[:, None]
                if fe:
                    eq &= ls[:, None, None] + 16 * chunk + 16 > ql[:, None, None]
                hit = torch.where(eq, chunk, -1).amax(1)
                upd = hit >= 0
                xai = torch.where(upd, ls[:, None] + 16 * hit, xai)
                xaj = torch.where(upd, (cstart + w)[:, None], xaj)
                xvm = vm
                continue
            fr_new = fra & (w >= frt) & ~done
            val = D11.gather(1, col(fridx.long()))[:, 0]
            out = torch.where(fr_new, off + val - ZERO, out)
            done = done | fr_new

        # ---- rect step end ----
        if tr:
            word = as_int32(torch.cat([word, zword], 1)
                            if cfg.local_start else word)
            if budget is None:
                t_words.append(word)
            else:
                compact_step(t_buf, used, word, h, ran, trace_words(cfg))
        active = ~done
        d0 = dirn
        cpos_new = cpos + STEP
        phase_done = cpos_new >= torch.where(shift, STEP, sz - psz)
        cpos = torch.where(phase_done, 0, cpos_new)
        # a shift's end: rebase the passive border, keep its row 7 as the
        # next corner, shift it by 8 and splice in the staged bottom cells
        # (reference: src/scan_block.rs:165-177, 349-355)
        sdone = col(active & shift)
        pd, pr = _sat(pasD + col(oa)), _sat(pasR + col(oa))
        corn = torch.where(active & shift, pd[:, STEP - 1], corn)
        win = (rows >= col(sz - STEP)) & (rows < col(sz))
        pd = torch.where(win, tempD.repeat(1, S // STEP),
                         F.pad(pd[:, STEP:], (0, STEP), value=NEG))
        pr = torch.where(win, tempR.repeat(1, S // STEP),
                         F.pad(pr[:, STEP:], (0, STEP), value=NEG))
        pasD, pasR = torch.where(sdone, pd, pasD), torch.where(sdone, pr, pasR)
        # GROW_D -> GROW_R: the lane axis flips to the query
        gd = col(active & (d0 == DIR_GD) & phase_done)
        actD, pasD = torch.where(gd, pasD, actD), torch.where(gd, actD, pasD)
        actC, pasR = torch.where(gd, pasR, actC), torch.where(gd, actC, pasR)
        dirn = torch.where(gd[:, 0], DIR_GR, dirn)
        if xd:
            # bank the GROW_D half's candidate (lanes = reference) and
            # restart the tracker for GROW_R
            cm, ai, aj = tracker_best()
            gdmax = torch.where(gd[:, 0], cm, gdmax)
            gdbi = torch.where(gd[:, 0], aj, gdbi)
            gdbj = torch.where(gd[:, 0], ai, gdbj)
            xvm = torch.where(gd, INT_MIN, xvm)

        # rect completion: the reference's decision ladder
        # (src/scan_block.rs:439-565)
        rdone = active & phase_done & (d0 != DIR_GD)
        was_grow = d0 == DIR_GR
        ro = (d0 == DIR_R) | (d0 == DIR_GR)
        # free end gaps: the rect maximum is row qlen's residue's
        # (reference: tracker.vmax[qlen % L])
        rmax = xvm.gather(1, q16)[:, 0] if fe else dmax
        off_max = off + rmax - ZERO
        offmax = torch.where(rdone, off_max, offmax)
        ydi = torch.where(rdone, yiter + 1, yiter)
        gnm_ = torch.where(rdone, was_grow.to(i32), gnm)
        new_best = rdone & (off_max > best)
        save = new_best & (sz < S)
        # a completed grow saves its doubled borders even without a new
        # best (reference: src/scan_block.rs:432-435)
        bsave = col(save | (rdone & was_grow & (sz < S)))
        ckI = torch.where(save, I, ckI)
        ckJ = torch.where(save, J, ckJ)
        ckOff = torch.where(save, off, ckOff)

        def save_borders(mask, ckcD, ckcC, ckrD, ckrR):
            cD = torch.where(col(ro), actD, pasD)
            cC = torch.where(col(ro), actC, pasR)
            rD = torch.where(col(ro), pasD, actD)
            rR = torch.where(col(ro), pasR, actC)
            return (torch.where(mask, cD, ckcD), torch.where(mask, cC, ckcC),
                    torch.where(mask, rD, ckrD), torch.where(mask, rR, ckrR))

        ckcD, ckcC, ckrD, ckrR = save_borders(bsave, ckcD, ckcC, ckrD, ckrR)
        if tr:
            pend |= bsave[:, 0].to(i32) * F_SAVE
        gnm_ = torch.where(save, 0, gnm_)
        best = torch.where(new_best, off_max, best)
        ydi = torch.where(new_best, 0, ydi)
        if xd:
            # a grow's new best takes the GROW_D half's position only when
            # it is strictly higher (reference: src/scan_block.rs:463-482)
            cmr, ai, aj = tracker_best()
            right = ~was_grow | (cmr >= gdmax)
            xbi = torch.where(new_best, torch.where(
                right, torch.where(ro, ai, aj), gdbi), xbi)
            xbj = torch.where(new_best, torch.where(
                right, torch.where(ro, aj, ai), gdbj), xbj)
            xvm = torch.where(col(rdone), INT_MIN, xvm)
            gdmax = torch.where(rdone, INT_MIN, gdmax)
            # the end, before this rect's grow, shrink or move (reference:
            # src/scan_block.rs:497-507)
            xfail = rdone & (off_max < best - x)
            stop = xfail & (xiter >= 1)
            xiter = torch.where(xfail, xiter + 1, torch.where(rdone, 0, xiter))
            stop |= rdone & (I + sz > ql) & (J + sz > rl)
            done = done | stop
            rdone = rdone & ~stop
        elif fe:
            # the best of row qlen at its residue's column, even on grows;
            # a fresh tracker per rect; the end: both ends covered
            xbi = torch.where(new_best, ql, xbi)
            xbj = torch.where(new_best, xaj.gather(1, q16)[:, 0], xbj)
            rd = col(rdone)
            xvm = torch.where(rd, INT_MIN, xvm)
            xai = torch.where(rd, 0, xai)
            xaj = torch.where(rd, 0, xaj)
            stop = rdone & (I + sz > ql) & (J + sz > rl)
            done = done | stop
            rdone = rdone & ~stop
        # forced moves skip both heuristics (reference: src/scan_block.rs:509-516)
        forced_down = rdone & (J + sz > rl)
        forced_right = rdone & ~forced_down & (I + sz > ql)
        free = rdone & ~forced_down & ~forced_right
        grow = free & (2 * sz <= S) & ((ydi > sz // STEP - 1) | (gnm_ == 1))
        psz = torch.where(grow, sz, psz)
        I = torch.where(grow, ckI, I)
        J = torch.where(grow, ckJ, J)
        off = torch.where(grow, ckOff, off)
        rest = grow
        if tr:
            pend |= grow.to(i32) * F_RESTORE
        dirn = torch.where(grow, DIR_GD, dirn)
        ydi = torch.where(grow, 0, ydi)
        # shrink (reference: src/scan_block.rs:534-559): halve and move into
        # the suffix corner when the border suffix holds the rect maximum
        suf = (rows >= col(sz - SHRINK_SUFFIX_LEN)) & (rows < col(sz))
        sufmax = torch.maximum(torch.where(suf, actD, INT_MIN).amax(1),
                               torch.where(suf, pasD, INT_MIN).amax(1))
        shrink = free & ~grow & (sz > MIN) & (ydi == 0) & (sufmax >= rmax)
        half = sz // 2
        sh = col(shrink)
        actD = torch.where(sh, down_by(actD, half), actD)
        actC = torch.where(sh, down_by(actC, half), actC)
        pasD = torch.where(sh, down_by(pasD, half), pasD)
        pasR = torch.where(sh, down_by(pasR, half), pasR)
        I = torch.where(shrink, I + half, I)
        J = torch.where(shrink, J + half, J)
        ckI = torch.where(shrink, I, ckI)
        ckJ = torch.where(shrink, J, ckJ)
        ckOff = torch.where(shrink, off, ckOff)
        ckcD, ckcC, ckrD, ckrR = save_borders(sh, ckcD, ckcC, ckrD, ckrR)
        if tr:
            pend |= shrink.to(i32) * F_SAVE
        ydi = torch.where(shrink, 0, ydi)
        yiter = torch.where(rdone, ydi, yiter)
        gnm = torch.where(rdone, gnm_, gnm)
        # a shrink forces GROW_D as the previous direction, which kills the
        # next rect's corner (reference: src/scan_block.rs:541)
        pdir = torch.where(rdone, torch.where(shrink, DIR_GD, d0), pdir)
        sz = torch.where(grow, 2 * sz, torch.where(shrink, half, sz))
        top = torch.maximum(top, sz)
        # direction from the post-shrink borders' first 8 rows
        # (reference: src/scan_block.rs:560-565)
        free_ng = free & ~grow
        a8, p8 = actD[:, :STEP].amax(1), pasD[:, :STEP].amax(1)
        right_max = torch.where(ro, a8, p8)
        down_max = torch.where(ro, p8, a8)
        godown = forced_down | (free_ng & (down_max > right_max))
        goright = (forced_right | free_ng) & ~godown
        I = torch.where(godown, I + STEP, I)
        J = torch.where(goright, J + STEP, J)
        choose = godown | goright
        new_dir = torch.where(godown, DIR_D, DIR_R)
        dirn = torch.where(choose, new_dir, dirn)
        swap = col(choose & (ro != (new_dir != DIR_D)))
        actD, pasD = torch.where(swap, pasD, actD), torch.where(swap, actD, pasD)
        actC, pasR = torch.where(swap, pasR, actC), torch.where(swap, actC, pasR)
        s += 1
    over = (~done | halted).to(i32)
    out = torch.stack([best, xbi, xbj, over] if wide(cfg) else [out, over], 1)
    res = (out,)
    if tr and budget is None:
        res += (stack_steps(t_words, (B, S * trace_words(cfg)), dev),
                stack_steps(t_desc, (B, 4), dev), nsteps)
    elif tr:
        res += (t_buf, stack_steps(t_desc, (B, DESC_FIELDS), dev), nsteps,
                used)
    if count_cells:
        res += (cells,)
    if top_size:
        res += (top,)
    return res if len(res) > 1 else out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    ``csrc/adaptive_kernel.cu``."""
    lib.adaptive_align_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    lib.adaptive_align_launch.restype = ctypes.c_int
    lib.adaptive_error_string.argtypes = [ctypes.c_int]
    lib.adaptive_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """A library of the adaptive kernel (``lane_kernel.library``), built
    and bound."""
    return bind(_build.load(name))


def adaptive_align(codes, qlen, rlen, table, gaps, cfg: AdaptiveKernelConfig):
    """(score, overrun) per pair as a (B, 2) int32 tensor; in x-drop mode
    and with free query end gaps (best score, query position, reference
    position, overrun) as (B, 4).
    With ``cfg.trace`` it returns ``(out, words, desc, steps)``, the trace
    of ``core/traceback.py``; on CUDA words and desc hold ``cfg.max_steps``
    steps, of which each pair wrote its own ``steps``, and of a step's
    words the rows of the block size's 32-row slots.

    In profile mode (``cfg.profile``) the inputs are those of
    ``ops/_profile.py::pack_profile``.

    CPU tensors take ``adaptive_align_plain``; CUDA tensors launch the
    kernel of ``csrc/adaptive_kernel.cu`` (the library
    ``lane_kernel.library`` names) on the current stream or raise.  The
    wrapper counts its launches by instance: ``adaptive_align.launches``
    (global), ``xdrop_launches``, ``trace_launches`` and
    ``xdrop_trace_launches``, and the same with ``profile_``, ``byte_`` or
    ``flags_`` in front."""
    if codes.device.type == "cpu":
        return adaptive_align_plain(codes, qlen, rlen, table, gaps, cfg)
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"no adaptive kernel for device {dev}")
    B = codes.shape[0]
    check_inputs(codes, qlen, rlen, table, cfg)
    out = torch.empty((B, 4 if wide(cfg) else 2), dtype=torch.int32,
                      device=dev)
    res, ptrs = trace_buffers(out, cfg, cfg.max_size * trace_words(cfg))
    if B == 0:
        return res
    lib = _lib(library("adaptive", cfg))
    with torch.cuda.device(dev):
        err = lib.adaptive_align_launch(
            codes.data_ptr(), qlen.data_ptr(), rlen.data_ptr(),
            table.data_ptr(), out.data_ptr(), *ptrs, B, cfg.seq_cap,
            cfg.alpha, cfg.min_size, cfg.max_size, cfg.max_steps,
            int(gaps[0]), int(gaps[1]), x_value(gaps, cfg),
            *mode_args(gaps, cfg), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("adaptive kernel launch failed: "
                           f"{lib.adaptive_error_string(err).decode()}")
    count_launch(adaptive_align, cfg)
    return res


reset_counts(adaptive_align)
