"""Sequence-to-PSSM profile mode of both kernels: the packer and the
score and gap fetch of the plain versions.

Counterpart of the profile half of ``block_aligner_tpu/ops/lane_kernel.py``
(``_pack_profile_host``, ``extract_prof`` and the asymmetric fetch of
``column``; reference: src/scan_block.rs:597-783, 942-995).  The profile
plays the reference.  A pair packs into its query's codes and one
position-major table of 8 int32 words per profile position, 32 bytes, one
memory sector: words 0..6 hold the scores of query codes 0..27 as bytes
biased by +128 (code c in byte c % 4 of word c // 4), word 7 the gap costs
``open_C | open_R << 8 | close_C << 16``, each biased by +128.  Positions
past a profile's packed length hold word 0: scores and gap costs of -128.

A right step's lane is a query row: it scores by its own code in the
entering profile position's row, and the column's gap costs apply.  A down
step's lane is a profile position: it scores by the entering query code in
its own row, and its own gap costs apply, with the C and R roles swapped
(``core/oracle.py::_SeqProfileFetch``).  The TPU kernels kept lane-window
stacks of codes and rows for this; here every lane knows its row's
position from the block's anchor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.scores import _as_bytes

__all__ = ["ProfilePack", "pack_profile", "ProfileFetch", "PROF_WORDS"]

PROF_SCORE_WORDS = 7  # query codes 0..27: A..Z, NULL and one more
PROF_WORDS = PROF_SCORE_WORDS + 1  # and the gap word
NULL_CODE = 26  # the query padding code (``AAProfile.NULL - 65``)


class ProfilePack(NamedTuple):
    codes: torch.Tensor  # (B, seq_cap) uint8: query codes, NULL padded
    qlen: torch.Tensor  # (B,) int32
    rlen: torch.Tensor  # (B,) int32: the profiles' lengths
    table: torch.Tensor  # (B, seq_cap, 8) int32: the profiles' words
    gaps: tuple  # (0, extend, x): one gap extension for the whole batch


def pack_profile(pairs, cfg, device, x_drop: int = 0) -> ProfilePack:
    """Pack ``(query, AAProfile)`` pairs for ``lane_align`` or
    ``adaptive_align`` in profile mode on ``device``; ``cfg.block`` is the
    block size the packing must leave room for.  A pair whose profile is
    None packs as an empty pair.  Rejects what the JAX packer rejects, with
    its messages.

    The host gathers every profile's packed rows into one array and the
    device scatters them into the zeroed table, so only the rows in use
    travel."""
    B, S, cap = len(pairs), cfg.block, cfg.seq_cap
    dev = torch.device(device)
    qlen = np.zeros(B, np.int64)
    rlen = np.zeros(B, np.int64)
    cls = np.zeros(B, np.int64)
    ge = None
    queries, ps_parts, gaps = [], [], ([], [], [])
    for b, (q, prof) in enumerate(pairs):
        if prof is None:
            continue
        if ge is None:
            ge = prof.get_gap_extend()
        if ge != prof.get_gap_extend():
            raise AssertionError(
                "all profiles in a batch must share gap_extend")
        q = _as_bytes(q)
        qlen[b], rlen[b] = len(q), prof.str_len
        if prof.str_len + S + 1 > cap:
            raise AssertionError("profile too long")
        if 1 + len(q) + S + 16 > cap:
            raise AssertionError("query too long")
        queries.append(q)
        cls[b] = cl = min(prof.curr_len, prof.str_len + S + 1, cap)
        ps_parts.append(prof.pos_scores[:cl])
        for part, arr in zip(gaps, (prof.gap_open_C, prof.gap_open_R,
                                    prof.gap_close_C)):
            part.append(arr[:cl])
    codes = torch.full((B, cap), NULL_CODE, dtype=torch.uint8, device=dev)
    table = torch.zeros((B, cap, PROF_WORDS), dtype=torch.int32, device=dev)
    if ps_parts:
        ps = np.concatenate(ps_parts).astype(np.int32, copy=False)
        gv = np.stack([np.concatenate(g) for g in gaps], 1).astype(np.int64)
        gv += 128
        if ps.min() < -128 or ps.max() > 127:
            raise AssertionError("profile score overflow")
        if gv.min() < 0 or gv.max() > 255:
            raise AssertionError("gap cost overflow")
        # little-endian bytes: code c lands in byte c % 4 of word c // 4
        rows = np.empty((len(ps), 4 * PROF_WORDS), np.uint8)
        rows[:, : 4 * PROF_SCORE_WORDS] = ps[:, : 4 * PROF_SCORE_WORDS] + 128
        rows[:, 4 * PROF_SCORE_WORDS : -1] = gv
        rows[:, -1] = 0
        words = torch.from_numpy(rows.view("<u4").view(np.int32)).to(dev)
        table.view(B * cap, PROF_WORDS)[_runs(cls, cap, dev)] = words
        qb = torch.frombuffer(bytearray().join(queries), dtype=torch.uint8)
        if qb.numel():
            # codes: the uppercased byte - 65, wrapping (AAProfile.convert)
            codes.view(-1)[_runs(qlen, cap, dev) + 1] = _QUERY_CODES.to(dev)[
                qb.to(dev).long()]
    return ProfilePack(codes, torch.from_numpy(qlen).to(torch.int32).to(dev),
                       torch.from_numpy(rlen).to(torch.int32).to(dev), table,
                       (0, -1 if ge is None else int(ge), int(x_drop)))


def _upper_codes() -> torch.Tensor:
    b = torch.arange(256)
    up = torch.where((b >= 97) & (b <= 122), b - 32, b)
    return ((up - 65) % 256).to(torch.uint8)


_QUERY_CODES = _upper_codes()


def _runs(lens, cap, dev) -> torch.Tensor:
    """Flat indices of positions 0..lens[b]-1 of each row b of a
    (len(lens), cap) array, row after row."""
    lens_t = torch.from_numpy(lens).to(dev)
    total = int(lens.sum())
    first = torch.arange(len(lens), device=dev) * cap - (
        torch.cumsum(lens_t, 0) - lens_t)
    return (torch.repeat_interleave(first, lens_t, output_size=total)
            + torch.arange(total, device=dev))


def _byte(words, sub):
    return ((words >> (8 * sub)) & 255) - 128


class ProfileFetch:
    """The plain versions' profile scores and gap costs, one step at a
    time: ``step`` reads the step's codes and rows, ``column(w)`` gives
    column w's scores and per-cell gap costs, each (B, S)."""

    def __init__(self, codes, table, e: int):
        self.codes = codes.long()
        self.table = table.to(torch.int64)
        self.e = e
        self.bidx = torch.arange(codes.shape[0], device=codes.device)[:, None]

    def step(self, right, lpos, cpos):
        """``right`` (B,) bool: the lanes are query rows; ``lpos`` (B, S)
        and ``cpos`` (B, 8) the lanes' and the columns' positions, clamped
        to the capacity."""
        self.right = right[:, None]
        # a right step's lanes score by their codes in the column rows; a
        # down step's by the column codes in their own rows
        self.lane_code = self.codes.gather(1, lpos)
        self.col_code = self.codes.gather(1, cpos)
        self.col_rows = self.table[self.bidx, cpos]  # (B, 8, 8)
        self.lane_rows = self.table[self.bidx, lpos]  # (B, S, 8)

    def column(self, w):
        """Column w's (scores, C open cost, R open cost, close cost), each
        (B, S) int32.  The close cost closes C on right steps and R on down
        steps."""
        right = self.right
        rows = torch.where(right[:, :, None],
                           self.col_rows[:, w : w + 1, :], self.lane_rows)
        code = torch.where(right, self.lane_code,
                           self.col_code[:, w : w + 1])
        idx = (code >> 2).clamp(max=PROF_WORDS - 1)
        word = rows.gather(2, idx[:, :, None])
        sc = torch.where(code < 4 * PROF_SCORE_WORDS,
                         _byte(word[:, :, 0], code & 3), -128)
        g = rows[:, :, PROF_WORDS - 1]
        oc, orr, cl = _byte(g, 0), _byte(g, 1), _byte(g, 2)
        i32 = torch.int32
        return (sc.to(i32), (torch.where(right, oc, orr) + self.e).to(i32),
                torch.where(right, orr, oc).to(i32), cl.to(i32))
