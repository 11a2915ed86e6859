"""Fixed-block alignment of a batch of pairs, global or x-drop: packing, the
plain PyTorch version, and the wrapper of the CUDA kernel.

Counterpart of ``block_aligner_tpu/ops/lane_kernel.py``: ``build_lane_engine``
(min == max block size S, a power of two in 16..512), in global and in
x-drop mode, with or without trace, scoring sequence pairs by a table, by
byte equality (``cfg.byte_mode``, a ``ByteMatrix``) or (query, profile)
pairs by the profile (``cfg.profile``, ``ops/_profile.py``), with or
without the reference's local-start, free-query-start-gap and
free-query-end-gap flags.  Both versions here compute what that kernel
computes, bit for bit: the final score (x-drop and free end gaps: the best
score and its position) and the y-drop "suspect" flag of every pair.

The step machine (reference: src/scan_block.rs:94-595 with min == max).  A
pair's state is an S-cell block whose active border ACT (D and C values
along the block's lane axis) advances 8 columns per step, and whose passive
border PAS (D and R values along the other axis) records the bottom cells.
Values are i16 relative to ``ZERO`` plus a per-pair i32 offset, rebased to
the previous step's maximum each step; both i16 rails saturate.

* The first S/8 steps are the reference's initial grow: lanes are the
  query, columns 0..S-1 of the reference, bottom cells written straight
  into PAS, the DP origin (0, 0) set to ZERO.
* Every later step moves the block 8 right or 8 down: forced down once the
  block covers the reference's end, then forced right once it covers the
  query's end, else down exactly when the first 8 rows of the bottom
  border beat those of the right border.  A change of lane axis swaps ACT
  and PAS; a direction flip feeds the stored corner into column 0.
* A pair freezes at the column where the block covering (qlen, rlen)
  reaches rlen (qlen for down blocks); its score is the cell at the lane
  of the other length, ``off + D - ZERO``.
* The suspect flag is the reference's y-drop grow trigger: set on a free
  step once the running maximum has not improved for S/8 steps.

X-drop mode (reference: src/scan_block.rs:353-404, 434-445, 1192-1201) has
no freeze.  A 16-residue tracker keeps, for each residue class row % 16, the
running maximum since the last decision and where it was last reached (the
highest 16-row chunk, the latest column).  At each decision a new best
score takes the position of the lowest residue holding the step's maximum;
a pair ends when its maximum falls more than x below the best at two
decisions in a row (X_DROP_ITER = 2), or when the block covers both ends.

The flags (reference: src/scan_block.rs:1126-1136, 1184-1186).  Local
start lets every cell begin an alignment: D is raised to the relative
zero ``clip(ZERO - off, -32768, 32767)`` before the merges, and in trace
mode a fifth bit per cell, D == that zero, stops the walk.  Free leading
query gaps set row 0 of every column of a right block whose lanes start
at query row 0 to the relative zero.  Free trailing query gaps (query
shorter than S) have no freeze: the tracker of x-drop mode keeps only the
residue ``qlen % 16`` (its running max drives the offset and the y-drop
counter) and its column, counting only chunks that reach past qlen; the
result is the best of it, at (qlen, that column), and a pair ends once
the block covers both ends.

The TPU's layout work (pairs in 128 lanes, banks, row splits, packed score
stacks scored on the MXU, VMEM budgets) does not exist here: the plain
version runs all pairs in lockstep under masks on (B, S) int32 tensors, and
the kernel runs one warp per pair (``csrc/lane_kernel.cu``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.result import I16_MAX, I16_MIN, STEP, ZERO
from ..core.scores import INVALID
from ..core.traceback import F_RIGHT, F_START
from . import _build
from ._profile import PROF_WORDS, ProfileFetch
from ._trace import as_int32, stack_steps, trace_bits, trace_buffers

__all__ = ["LaneKernelConfig", "LanePack", "pack_lane", "lane_align_plain",
           "lane_align"]

NEG = I16_MIN
INT_MIN = -(1 << 31)


@dataclasses.dataclass(frozen=True)
class LaneKernelConfig:
    block: int  # S: fixed block size, a power of two in 16..512
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
        S = self.block
        if S & (S - 1) or not 16 <= S <= 512:
            raise ValueError(f"block must be a power of two in 16..512, got {S}")
        if self.seq_cap % STEP or self.seq_cap < S + 2 * STEP:
            raise ValueError(
                f"seq_cap must be a multiple of {STEP} and at least "
                f"block + {2 * STEP}, got {self.seq_cap}")
        check_modes(self)

    @property
    def max_steps(self) -> int:
        """Step cap of a pair (the JAX kernel's loop bound)."""
        return 2 * self.seq_cap // STEP + self.block // STEP + 2

    @property
    def min_size(self) -> int:
        """The block size, min and max at once."""
        return self.block


def check_modes(cfg):
    """The modes a kernel configuration may combine (the JAX configs'
    exclusions, and the port's: ByteMatrix has no x-drop, as in the
    reference)."""
    if cfg.alpha not in ((256,) if cfg.byte_mode else (16, 32)):
        raise ValueError(f"alpha must be 16 or 32 (256 in byte mode), got "
                         f"{cfg.alpha}")
    if cfg.local_start and cfg.free_query_start_gaps:
        raise ValueError(
            "local_start and free_query_start_gaps exclude each other")
    if cfg.free_query_end_gaps and cfg.x_drop:
        raise ValueError("x_drop and free_query_end_gaps exclude each other")
    if cfg.byte_mode and (cfg.profile or cfg.x_drop):
        raise ValueError("byte mode has no profile and no x-drop")


def flag_bits(cfg) -> int:
    """The kernels' ``flags`` argument: local start 1, free query start gaps
    2, free query end gaps 4, byte mode 8; nonzero only for the instances
    of ``csrc/*_flags.cu``."""
    return (cfg.local_start | cfg.free_query_start_gaps << 1
            | cfg.free_query_end_gaps << 2 | cfg.byte_mode << 3)


def wide(cfg) -> bool:
    """Whether the output holds the best score and its position: x-drop
    and free query end gaps."""
    return cfg.x_drop or cfg.free_query_end_gaps


def trace_words(cfg) -> int:
    """int32 words per row of a traced step: 2 in local-start mode (the
    zero bits follow the 4-bit cells), else 1."""
    return 2 if cfg.local_start else 1


class LanePack(NamedTuple):
    codes: torch.Tensor  # (B, 2, seq_cap) uint8: query row 0, reference row 1
    qlen: torch.Tensor  # (B,) int32
    rlen: torch.Tensor  # (B,) int32
    table: torch.Tensor  # (alpha, alpha) int32: table[column code, lane
    # code]; (0,) in byte mode
    gaps: tuple  # (open, extend, x), x read in x-drop mode only; byte mode
    # appends (match, mismatch)


def _as_bytes(s) -> bytes:
    return s.encode("ascii") if isinstance(s, str) else bytes(s)


def code_lut(matrix) -> np.ndarray:
    """256-entry byte -> kernel code table (``INVALID`` for rejected bytes);
    nucleotide codes fold to their low 4 bits as the JAX ``pack_lane`` does;
    a ``ByteMatrix``'s is the identity, every byte valid."""
    if matrix.kind not in ("aa", "nuc", "byte"):
        raise ValueError(f"no kernel codes for matrix kind {matrix.kind!r}")
    lut = matrix.lut.copy()
    if matrix.kind == "nuc":
        ok = lut != INVALID
        lut[ok] &= 15
    return lut


def score_table(matrix, alpha: int) -> np.ndarray:
    """(alpha, alpha) int32 table, unused entries -128, as the JAX
    ``pack_lane`` builds it (nucleotide rows fold with ``& 7``)."""
    M = np.full((alpha, alpha), -128, dtype=np.int32)
    tab = matrix.dense()
    if matrix.kind == "nuc":
        x = np.arange(16)
        M[:16, :16] = tab[(x & 7)[:, None], x[None, :]]
    else:
        M[: tab.shape[0], : tab.shape[1]] = tab
    return M


def pack_lane(pairs, matrix, cfg: LaneKernelConfig, gaps, device,
              x_drop: int = 0) -> LanePack:
    """Pack ``(query, reference)`` byte pairs for ``lane_align`` on ``device``.

    The sequences travel as one byte buffer; the byte -> code lookup and the
    scatter into the pair-major code block run on the device.  Codes start
    at position 1 and every other position holds the NULL code.  A
    ``ByteMatrix`` packs raw bytes (NULL is byte 0) and no table; its match
    and mismatch scores follow the gaps."""
    dev = torch.device(device)
    n = len(pairs)
    seqs = [_as_bytes(q) for q, _ in pairs] + [_as_bytes(r) for _, r in pairs]
    lens = np.fromiter(map(len, seqs), np.int64, 2 * n)
    if n and 1 + int(lens.max()) + cfg.block + STEP > cfg.seq_cap:
        raise ValueError("sequence too long for seq_cap")
    byte = matrix.kind == "byte"
    if byte != cfg.byte_mode:
        raise ValueError(f"a {type(matrix).__name__} needs byte_mode="
                         f"{byte}")
    lut = code_lut(matrix)
    codes = torch.full((n, 2, cfg.seq_cap), int(lut[matrix.NULL]),
                       dtype=torch.uint8, device=dev)
    total = int(lens.sum())
    if total:
        raw = torch.frombuffer(bytearray().join(seqs), dtype=torch.uint8)
        mapped = torch.as_tensor(lut, device=dev)[raw.to(dev).int()]
        if not byte and bool((mapped == INVALID).any()):
            raise ValueError(matrix.ERROR)
        lens_t = torch.as_tensor(lens, device=dev)
        pair = torch.arange(n, device=dev) * 2
        rows = torch.cat([pair, pair + 1])  # sequence k's row in (B*2, cap)
        first = rows * cfg.seq_cap + 1 - (torch.cumsum(lens_t, 0) - lens_t)
        dest = torch.repeat_interleave(first, lens_t, output_size=total)
        dest += torch.arange(total, device=dev)
        codes.view(-1)[dest] = mapped
    qlen = torch.as_tensor(lens[:n], dtype=torch.int32).to(dev)
    rlen = torch.as_tensor(lens[n:], dtype=torch.int32).to(dev)
    g = (int(gaps.open), int(gaps.extend), int(x_drop))
    if byte:
        table = torch.zeros(0, dtype=torch.int32, device=dev)
        g += (matrix.match_score, matrix.mismatch_score)
    else:
        table = torch.as_tensor(score_table(matrix, cfg.alpha)).to(dev)
    return LanePack(codes, qlen, rlen, table, g)


def _sat(x):
    # i16 saturation at both rails, as the reference's adds: the first S/8
    # steps run without a rebase, so a cell can reach the upper one
    return x.clamp(NEG, I16_MAX)


def lane_align_plain(codes, qlen, rlen, table, gaps, cfg: LaneKernelConfig,
                     count_cells: bool = False):
    """Plain PyTorch version: all pairs in lockstep under masks.

    Returns a (B, 2) int32 tensor of (score, suspect), or in x-drop mode
    (x = ``gaps[2]``) and with free query end gaps a (B, 4) tensor of (best
    score, its query position, its reference position, suspect).  Code
    positions are clamped to ``seq_cap - 1`` and codes to ``alpha - 1``, as
    the kernel does; ``pack_lane`` output never needs either.  With
    ``cfg.trace`` it returns ``(out, words, desc, steps)``, the trace of
    ``core/traceback.py`` with T the most steps of any pair: a freezing
    step holds the bits of its columns up to the freeze.  With
    ``count_cells`` it also returns, last, each pair's DP cell count, (B,)
    int64: S cells for every column up to and including the freeze column
    (x-drop and free end gaps: every column of every step up to the one
    that ends the pair)."""
    S, A, cap = cfg.block, cfg.alpha, cfg.seq_cap
    PRO = S // STEP
    dev = codes.device
    B = codes.shape[0]
    open_, e = int(gaps[0]), int(gaps[1])
    xd = cfg.x_drop
    fe = cfg.free_query_end_gaps
    i32 = torch.int32
    if cfg.profile:
        fetch = ProfileFetch(codes, table, e)
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
    # the closed form of the chunked prefix scan's zero correction
    zc = (e * (rows % STEP + 1)).to(i32)
    # the gap scan max_{q <= p} (v[q] + e (p - q)) as e p + a running
    # max of v[q] - e q
    erows = (e * rows).to(i32)

    def full(v, shape=(B,)):
        return torch.full(shape, v, dtype=i32, device=dev)

    actD, actC, pasD, pasR = (full(0, (B, S)) for _ in range(4))
    tempD, tempR = full(0, (B, STEP)), full(0, (B, STEP))
    I, J, off, offmax, yiter, susp, out = (full(0) for _ in range(7))
    dirn, pdir = full(2), full(2)  # 2: the prologue (initial grow)
    corn, dmax = full(NEG), full(NEG)
    ybest = full(-(1 << 30))
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    cells = torch.zeros(B, dtype=torch.int64, device=dev)
    # freeze predicate of the current rect, prologue values (lanes = query)
    fra, frt, fridx = S > ql, rl.clone(), ql.clamp(0, S - 1)
    oa = full(0)
    # the relative zero of local start and free start gaps
    rz = full(ZERO)
    tr = cfg.trace
    if tr:
        # per step: words (B, S), descriptors (B, 4); executed steps per pair
        t_words, t_desc = [], []
        nsteps = full(0)
        zcol = full(0, (B, 1))
    if wide(cfg):
        x = int(gaps[2])
        r16 = torch.arange(16, dtype=i32, device=dev)
        chunk = torch.arange(S // 16, dtype=i32, device=dev)[:, None]
        # the tracker: running max, chunk origin and column per residue
        xvm, xai, xaj = full(NEG, (B, 16)), full(0, (B, 16)), full(0, (B, 16))
        xbest, xbi, xbj, xiter = (full(0) for _ in range(4))
        # free end gaps: the residue of row qlen
        q16 = (ql % 16).long()[:, None]
    s = 0
    while s < cfg.max_steps and not bool(done.all()):
        in_pro = s < PRO
        if in_pro:
            cvec = full(NEG)
            lane_side = torch.zeros(B, dtype=torch.long, device=dev)
            starti, colpos0 = full(0), full(s * STEP)
        else:
            # offset rebase (reference: src/scan_block.rs:148-151)
            new_off = torch.where(done, off, offmax)
            oa = (off - new_off).clamp(I16_MIN, I16_MAX)
            off = new_off
            rz = (ZERO - off).clamp(I16_MIN, I16_MAX)
            actD = _sat(actD + oa[:, None])
            actC = _sat(actC + oa[:, None])
            flip = ((dirn == 0) & (pdir == 1)) | ((dirn == 1) & (pdir == 0))
            cvec = torch.where(flip, _sat(corn + oa), NEG)
            right = dirn != 1
            starti = torch.where(right, I, J)
            colpos0 = torch.where(right, J, I) + (S - STEP)
            lane_len = torch.where(right, ql, rl)
            col_len = torch.where(right, rl, ql)
            fra = starti + S > lane_len
            frt = col_len - colpos0
            fridx = (lane_len - starti).clamp(0, S - 1)
            lane_side = (~right).long()
        if tr:
            nsteps += (~done).to(i32)
            if in_pro:
                # the prologue is one right rect at (0, 0)
                flags = full(F_RIGHT | (F_START if s == 0 else 0))
                ls, cs = full(0), colpos0
            else:
                flags = (dirn != 1).to(i32) * F_RIGHT | F_START
                ls, cs = starti, colpos0
            t_desc.append(torch.stack([flags, ls, cs, full(S)], 1))
            word = torch.zeros((B, S), dtype=torch.int64, device=dev)
            zword = torch.zeros((B, S), dtype=torch.int64, device=dev)
        # free start gaps: a right block whose lanes start at query row 0
        ins0 = (lane_side == 0) & (starti == 0)
        lpos = (starti[:, None] + rows).clamp(max=cap - 1)
        cpos = (colpos0[:, None] + cols).clamp(max=cap - 1)
        if cfg.profile:
            fetch.step(lane_side == 0, lpos, cpos)
        else:
            lanec = seqs[bidx, lane_side[:, None], lpos]  # (B, S)
            colc = seqs[bidx, 1 - lane_side[:, None], cpos]  # (B, STEP)
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
            D11 = _sat(torch.cat([corner[:, None], actD[:, :-1]], 1) + scores)
            if in_pro and s == 0 and w == 0:
                D11[:, 0] = ZERO  # the DP origin cell
            if cfg.local_start:
                D11 = torch.maximum(D11, rz[:, None])
            elif cfg.free_query_start_gaps:
                D11[:, 0] = torch.where(ins0, rz, D11[:, 0])
            C11_open = _sat(actD + copen)
            C11 = torch.maximum(_sat(actC + e), C11_open)
            # profile: a right step closes C before the merge, a down step
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
                # the cell's traceback bits (reference:
                # src/scan_block.rs:1166-1190); a frozen pair's later
                # columns stay out of its last word
                word |= torch.where(
                    done[:, None], 0,
                    trace_bits(D11, c_end, r_end, C11, C11_open, R11,
                               D11_open, zcol) << (4 * w))
                if cfg.local_start:
                    # the cell restarted at the relative zero: the walk
                    # stops there
                    zword |= ((D11 == rz[:, None]) & ~done[:, None]).long() << w
            dmax = torch.maximum(dmax, D11.amax(1))
            actD, actC = D11, C11
            if in_pro:
                pasD[:, s * STEP + w] = D11[:, -1]
                pasR[:, s * STEP + w] = R11[:, -1]
            else:
                tempD[:, w] = D11[:, -1]
                tempR[:, w] = R11[:, -1]
            cells += torch.where(done, 0, S)
            if wide(cfg):
                # a residue's max is reached again or raised: the highest
                # chunk holding it, at this column (reference:
                # src/scan_block.rs:1192-1201); free end gaps count only
                # chunks that reach past qlen
                Dr = D11.view(B, S // 16, 16)
                vm = torch.maximum(xvm, Dr.amax(1))
                eq = Dr == vm[:, None]
                if fe:
                    eq &= (starti[:, None, None] + 16 * chunk + 16
                           > ql[:, None, None])
                hit = torch.where(eq, chunk, -1).amax(1)
                upd = hit >= 0
                xai = torch.where(upd, starti[:, None] + 16 * hit, xai)
                xaj = torch.where(upd, (colpos0 + w)[:, None], xaj)
                xvm = vm
                continue
            wloc = s * STEP + w if in_pro else w
            fr_new = fra & (wloc >= frt) & ~done
            val = D11.gather(1, fridx.long()[:, None])[:, 0]
            out = torch.where(fr_new, off + val - ZERO, out)
            done = done | fr_new
        if s >= PRO - 1:
            active = ~done
            if s != PRO - 1:
                # shift the passive border by 8 and splice in the new bottom
                # cells; the pre-splice row 7 is the next corner
                pd, pr = _sat(pasD + oa[:, None]), _sat(pasR + oa[:, None])
                corn = torch.where(active, pd[:, STEP - 1], corn)
                pasD = torch.cat([pd[:, STEP:], tempD], 1)
                pasR = torch.cat([pr[:, STEP:], tempR], 1)
            cur, dmax = dmax, full(NEG)
            if fe:
                # the rebase and the y-drop counter follow row qlen's
                # residue (reference: tracker.vmax[qlen % L])
                cur = xvm.gather(1, q16)[:, 0]
            off_max = off + cur - ZERO
            offmax = torch.where(active, off_max, offmax)
            # y-drop stall tracking (reference: src/scan_block.rs:470-487)
            improved = active & (off_max > ybest)
            y_iter = torch.where(improved, 0, yiter + 1)
            ybest = torch.where(improved, off_max, ybest)
            yiter = torch.where(active, y_iter, yiter)
            if fe:
                # the best of row qlen, at its residue's column; the end:
                # both ends covered
                improved = active & (off_max > xbest)
                xbest = torch.where(improved, off_max, xbest)
                xbi = torch.where(improved, ql, xbi)
                xbj = torch.where(improved, xaj.gather(1, q16)[:, 0], xbj)
                xvm = full(NEG, (B, 16))
                done = done | (active & (I + S > ql) & (J + S > rl))
                active = ~done
            if xd:
                # a new best takes the position of the lowest residue
                # holding the step's max (reference: src/avx2.rs:269-274)
                ridx = torch.where(xvm == cur[:, None], r16, 16).amin(1, True)
                sel = r16 == ridx
                ai = torch.where(sel, xai + r16, INT_MIN).amax(1)
                aj = torch.where(sel, xaj, INT_MIN).amax(1)
                rx = dirn != 1
                improved = active & (off_max > xbest)
                xbest = torch.where(improved, off_max, xbest)
                xbi = torch.where(improved, torch.where(rx, ai, aj), xbi)
                xbj = torch.where(improved, torch.where(rx, aj, ai), xbj)
                xvm = full(NEG, (B, 16))  # the chunk origins and columns stay
                # the end: two failing decisions in a row, or both ends
                # covered (reference: src/scan_block.rs:353-404, 434-445)
                xfail = active & (off_max < xbest - x)
                stop = xfail & (xiter >= 1)
                xiter = torch.where(xfail, xiter + 1, torch.where(active, 0, xiter))
                stop |= active & (I + S > ql) & (J + S > rl)
                done = done | stop
                active = ~done
            # direction (reference: src/scan_block.rs:447-462, 551-558)
            right_now = dirn != 1
            a8, p8 = actD[:, :STEP].amax(1), pasD[:, :STEP].amax(1)
            right_max = torch.where(right_now, a8, p8)
            down_max = torch.where(right_now, p8, a8)
            forced_down = active & (J + S > rl)
            forced_right = active & ~forced_down & (I + S > ql)
            free = active & ~forced_down & ~forced_right
            susp = torch.where(free & (y_iter > PRO - 1), 1, susp)
            godown = forced_down | (free & (down_max > right_max))
            goright = active & ~godown
            pdir = torch.where(active, dirn, pdir)
            I = torch.where(godown, I + STEP, I)
            J = torch.where(goright, J + STEP, J)
            new_dir = torch.where(godown, 1, torch.where(goright, 0, dirn))
            swap = (active & ((dirn != 1) != (new_dir != 1)))[:, None]
            dirn = torch.where(active, new_dir, dirn)
            actD, pasD = torch.where(swap, pasD, actD), torch.where(swap, actD, pasD)
            actC, pasR = torch.where(swap, pasR, actC), torch.where(swap, actC, pasR)
        if tr:
            t_words.append(as_int32(torch.cat([word, zword], 1)
                                    if cfg.local_start else word))
        s += 1
    out = torch.stack([xbest, xbi, xbj, susp] if wide(cfg) else [out, susp],
                      1)
    res = (out,)
    if tr:
        res += (stack_steps(t_words, (B, S * trace_words(cfg)), dev),
                stack_steps(t_desc, (B, 4), dev), nsteps)
    if count_cells:
        res += (cells,)
    return res if len(res) > 1 else out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    ``csrc/lane_kernel.cu``."""
    lib.lane_align_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.lane_align_launch.restype = ctypes.c_int
    lib.lane_error_string.argtypes = [ctypes.c_int]
    lib.lane_error_string.restype = ctypes.c_char_p
    return lib


def library(kernel: str, cfg) -> str:
    """The name of the ``csrc/`` library that holds ``cfg``'s instance of
    ``kernel`` ("lane" or "adaptive"): ``<kernel>_kernel``, or
    ``<kernel>_profile`` for profiles, with ``_flags`` for the instances
    that read the flags and byte mode at run time."""
    name = kernel + ("_profile" if cfg.profile else "")
    if flag_bits(cfg):
        return name + "_flags"
    return name if cfg.profile else name + "_kernel"


LIBRARIES = tuple(f"{k}_{v}" for k in ("lane", "adaptive")
                  for v in ("kernel", "profile", "flags", "profile_flags"))


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """A library of the lane kernel (``library``), built and bound."""
    return bind(_build.load(name))


def x_value(gaps, cfg) -> int:
    """The kernels' ``x_drop`` argument: x in x-drop mode, -1 in global."""
    if not cfg.x_drop:
        return -1
    if int(gaps[2]) < 0:
        raise ValueError(f"x_drop must be >= 0, got {gaps[2]}")
    return int(gaps[2])


def check_inputs(codes, qlen, rlen, table, cfg):
    """The kernels' input tensors must lie on one device, with the dtypes,
    shapes and layout their C entry points read."""
    dev, B, cap = codes.device, codes.shape[0], cfg.seq_cap
    if cfg.profile:
        # the big kernel's table has prof_cap positions
        _check("codes", codes, torch.uint8, (B, cap), dev)
        _check("table", table, torch.int32,
               (B, cfg.prof_cap or cap, PROF_WORDS), dev)
    elif cfg.byte_mode:
        _check("codes", codes, torch.uint8, (B, 2, cap), dev)
        _check("table", table, torch.int32, (0,), dev)
    else:
        _check("codes", codes, torch.uint8, (B, 2, cap), dev)
        _check("table", table, torch.int32, (cfg.alpha, cfg.alpha), dev)
    _check("qlen", qlen, torch.int32, (B,), dev)
    _check("rlen", rlen, torch.int32, (B,), dev)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lane_align(codes, qlen, rlen, table, gaps, cfg: LaneKernelConfig):
    """(score, suspect) per pair as a (B, 2) int32 tensor; in x-drop mode
    and with free query end gaps (best score, query position, reference
    position, suspect) as (B, 4).  With ``cfg.trace`` it returns ``(out,
    words, desc, steps)``, the trace of ``core/traceback.py``; on CUDA
    words and desc hold ``cfg.max_steps`` steps, of which each pair wrote
    its own ``steps``.

    In profile mode (``cfg.profile``) the inputs are those of
    ``ops/_profile.py::pack_profile``: codes (B, seq_cap) of the queries,
    table (B, seq_cap, 8) of the profiles' words.

    CPU tensors take ``lane_align_plain``; CUDA tensors launch the kernel of
    ``csrc/lane_kernel.cu`` (the library ``library`` names) on the current
    stream or raise.  The wrapper counts its launches by instance (``COUNTERS``):
    ``lane_align.launches`` (global), ``xdrop_launches``,
    ``trace_launches`` and ``xdrop_trace_launches``, and the same with
    ``profile_``, ``byte_`` or ``flags_`` (local start or free gaps) in
    front."""
    if codes.device.type == "cpu":
        return lane_align_plain(codes, qlen, rlen, table, gaps, cfg)
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"no lane kernel for device {dev}")
    B = codes.shape[0]
    check_inputs(codes, qlen, rlen, table, cfg)
    out = torch.empty((B, 4 if wide(cfg) else 2), dtype=torch.int32,
                      device=dev)
    res, ptrs = trace_buffers(out, cfg, cfg.block * trace_words(cfg))
    if B == 0:
        return res
    lib = _lib(library("lane", cfg))
    with torch.cuda.device(dev):
        err = lib.lane_align_launch(
            codes.data_ptr(), qlen.data_ptr(), rlen.data_ptr(),
            table.data_ptr(), out.data_ptr(), *ptrs, B, cfg.seq_cap,
            cfg.alpha, cfg.block, cfg.max_steps, int(gaps[0]), int(gaps[1]),
            x_value(gaps, cfg), *mode_args(gaps, cfg),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"lane kernel launch failed: {lib.lane_error_string(err).decode()}")
    count_launch(lane_align, cfg)
    return res


def mode_args(gaps, cfg):
    """The kernels' ``flags``, ``match`` and ``mismatch`` arguments (the
    scores are read in byte mode only)."""
    if cfg.byte_mode:
        return flag_bits(cfg), int(gaps[3]), int(gaps[4])
    return flag_bits(cfg), 0, 0


def count_launch(fn, cfg):
    """One more launch of ``fn``'s instance for ``cfg``."""
    flags = cfg.local_start or cfg.free_query_start_gaps \
        or cfg.free_query_end_gaps
    name = (("rows16384_" if getattr(cfg, "max_size", 0) > 8192 else "")
            + ("profile_" if cfg.profile else "")
            + ("byte_" if cfg.byte_mode else "")
            + ("flags_" if flags else "")
            + ("xdrop_" if cfg.x_drop else "")
            + ("trace_" if cfg.trace else "") + "launches")
    setattr(fn, name, getattr(fn, name) + 1)


COUNTERS = tuple(h + p + y + f + x + t + "launches"
                 for h in ("", "rows16384_") for p in ("", "profile_")
                 for y in ("", "byte_") for f in ("", "flags_")
                 for x in ("", "xdrop_") for t in ("", "trace_"))


def reset_counts(fn):
    """Set every launch count of ``fn`` to 0."""
    for c in COUNTERS:
        setattr(fn, c, 0)


reset_counts(lane_align)
