"""Scoring matrices and gap parameters.

Same tables and byte->code conventions as ``block_aligner_tpu.core.scores``
(reference: src/scores.rs:17-338), in numpy only.  Each matrix class keeps a
256-entry byte->code lookup table (``lut``, 255 = invalid byte): ``convert``
applies it on the host, and ``ops.lane_kernel.pack_lane`` applies the same
table on the device.

* ``AAMatrix``: 27x32 table indexed by ``char - 'A'`` (A..Z plus NULL=26);
  unset entries score -128.
* ``NucMatrix``: 8x16 table indexed by ``(c & 7, q & 15)`` over raw
  uppercased ASCII.
* ``ByteMatrix``: match/mismatch by byte equality; every byte is its own
  code and byte 0 is the padding (NULL) code.
* ``Gaps``: ``open`` includes the first extension; a gap of length n costs
  ``open + extend * (n - 1)``.
* ``AAProfile``: a position-specific scoring matrix (PSSM) with per-position
  gap open and close costs, the reference side of sequence-to-profile
  alignment (reference: src/scores.rs:341-715).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import ClassVar, Optional

import numpy as np

# the JAX package's data file, read by path: the port never imports it
_MATRICES = (Path(__file__).resolve().parents[2] / "block_aligner_tpu"
             / "data" / "matrices.npz")

__all__ = [
    "Gaps", "AAMatrix", "NucMatrix", "ByteMatrix", "AAProfile", "NW1",
    "BYTES1",
    "BLOSUM45", "BLOSUM50", "BLOSUM62", "BLOSUM80", "BLOSUM90",
    "PAM100", "PAM120", "PAM160", "PAM200", "PAM250", "percent_len",
]

INVALID = 255  # lut entry of a byte the matrix rejects


@dataclasses.dataclass(frozen=True)
class Gaps:
    """Affine gap costs; both must be negative and ``open < extend``."""

    open: int
    extend: int


def _as_bytes(s) -> bytes:
    if isinstance(s, str):
        return s.encode("ascii")
    if isinstance(s, (bytes, bytearray)):
        return bytes(s)
    return bytes(np.asarray(s, dtype=np.uint8).tobytes())


def _upper_lut(lo: int, hi: int, base: int) -> np.ndarray:
    """Bytes uppercased (a..z -> A..Z), valid in [lo, hi], minus ``base``."""
    b = np.arange(256, dtype=np.int32)
    up = np.where((b >= 97) & (b <= 122), b - 32, b)
    return np.where((up >= lo) & (up <= hi), up - base, INVALID).astype(np.uint8)


def _char_upper(c) -> int:
    c = c if isinstance(c, int) else ord(c)
    if 97 <= c <= 122:
        c -= 32
    return c


class _Table:
    lut: ClassVar[np.ndarray]
    ERROR: ClassVar[str]

    def convert(self, seq) -> np.ndarray:
        """Raw bytes -> storage codes through ``lut``."""
        c = self.lut[np.frombuffer(_as_bytes(seq), dtype=np.uint8)]
        if (c == INVALID).any():
            raise ValueError(self.ERROR)
        return c

    def dense(self) -> np.ndarray:
        return self.table


class AAMatrix(_Table):
    """Amino-acid scoring matrix over ``A..Z`` (reference: src/scores.rs:37-135)."""

    kind: ClassVar[str] = "aa"
    #: Padding byte: one past 'Z' (reference: src/scores.rs:83).
    NULL: ClassVar[int] = ord("A") + 26
    ROWS: ClassVar[int] = 27
    COLS: ClassVar[int] = 32
    lut: ClassVar[np.ndarray] = _upper_lut(65, ord("A") + 26, 65)
    ERROR: ClassVar[str] = "AAMatrix sequences must be in A..Z"

    def __init__(self, table: Optional[np.ndarray] = None):
        if table is None:
            table = np.full((27, 32), -128, dtype=np.int32)
        else:
            table = np.asarray(table, dtype=np.int32)
            if table.shape != (27, 32):
                raise ValueError(f"AAMatrix table must be 27x32, got {table.shape}")
        self.table = table

    @classmethod
    def new_simple(cls, match_score: int, mismatch_score: int) -> "AAMatrix":
        t = np.full((27, 32), -128, dtype=np.int32)
        t[:26, :26] = mismatch_score
        np.fill_diagonal(t[:26, :26], match_score)
        return cls(t)

    @classmethod
    def from_tsv(cls, tsv: str, aa_order: str) -> "AAMatrix":
        """Parse a whitespace-separated square table with rows/cols in ``aa_order``."""
        order = [ord(c) for c in aa_order.split()]
        m = cls()
        for line, a in zip(tsv.strip().split("\n"), order):
            for tok, b in zip(line.split(), order):
                m.set(a, b, int(tok))
        return m

    def set(self, a, b, score: int) -> None:
        a, b = _char_upper(a), _char_upper(b)
        self.table[a - 65, b - 65] = score
        self.table[b - 65, a - 65] = score

    def get(self, a, b) -> int:
        return int(self.table[_char_upper(a) - 65, _char_upper(b) - 65])


class NucMatrix(_Table):
    """Nucleotide matrix over A/C/G/T/N raw ASCII (reference: src/scores.rs:137-217)."""

    kind: ClassVar[str] = "nuc"
    NULL: ClassVar[int] = ord("Z")
    ROWS: ClassVar[int] = 8
    COLS: ClassVar[int] = 16
    # codes are the uppercased bytes themselves
    lut: ClassVar[np.ndarray] = _upper_lut(65, 90, 0)
    ERROR: ClassVar[str] = "NucMatrix sequences must be in A..Z"

    def __init__(self, table: Optional[np.ndarray] = None):
        if table is None:
            table = np.full((8, 16), -128, dtype=np.int32)
        else:
            table = np.asarray(table, dtype=np.int32)
            if table.shape != (8, 16):
                raise ValueError(f"NucMatrix table must be 8x16, got {table.shape}")
        self.table = table

    @classmethod
    def new_simple(cls, match_score: int, mismatch_score: int) -> "NucMatrix":
        t = np.full((8, 16), -128, dtype=np.int32)
        alpha = [ord(c) for c in "ATCGN"]
        for i, a in enumerate(alpha):
            for j, b in enumerate(alpha):
                t[a & 0b111, b & 0b1111] = match_score if i == j else mismatch_score
        return cls(t)

    def set(self, a, b, score: int) -> None:
        a, b = _char_upper(a), _char_upper(b)
        self.table[a & 0b111, b & 0b1111] = score
        self.table[b & 0b111, a & 0b1111] = score

    def get(self, a, b) -> int:
        return int(self.table[_char_upper(a) & 0b111, _char_upper(b) & 0b1111])


class ByteMatrix:
    """Arbitrary-byte match/mismatch matrix (reference: src/scores.rs:219-273).

    The kernels compare codes instead of reading a table: each byte is its
    own code (``lut`` is the identity, no byte is rejected) and ``NULL`` is
    byte 0, so padding scores as a match against padding and against a
    sequence's own byte 0, as in the reference.  X-drop with ByteMatrix is
    not supported, as in the reference."""

    kind: ClassVar[str] = "byte"
    NULL: ClassVar[int] = 0
    lut: ClassVar[np.ndarray] = np.arange(256, dtype=np.uint8)

    def __init__(self, match_score: int, mismatch_score: int):
        self.match_score = int(match_score)
        self.mismatch_score = int(mismatch_score)

    @classmethod
    def new_simple(cls, match_score: int, mismatch_score: int) -> "ByteMatrix":
        return cls(match_score, mismatch_score)

    def get(self, a, b) -> int:
        a = a if isinstance(a, int) else ord(a)
        b = b if isinstance(b, int) else ord(b)
        return self.match_score if a == b else self.mismatch_score

    def convert(self, seq) -> np.ndarray:
        return np.frombuffer(_as_bytes(seq), dtype=np.uint8).copy()

    def dense(self) -> Optional[np.ndarray]:
        return None


class AAProfile:
    """Position-specific scoring matrix with per-position gap open and
    close costs (reference: src/scores.rs:341-715).

    The profile is one longer than its string: position 0 is the DP
    boundary column, whose gap-open costs apply and whose scores stay at
    the -128 padding; positions past the string pad to ``block_size``.
    Storage is one position-major ``(max_len, 32)`` int32 table, scores by
    ``char - 'A'``, and three int32 gap arrays, -128 where unset.
    """

    kind: ClassVar[str] = "profile"
    NULL: ClassVar[int] = ord("A") + 26

    def __init__(self, str_len: int, block_size: int, gap_extend: int):
        self.max_len = str_len + block_size + 1
        self.curr_len = self.max_len
        self.str_len = str_len
        self.gap_extend = int(gap_extend)
        self.pos_scores = np.full((self.max_len, 32), -128, dtype=np.int32)
        self.gap_open_C = np.full(self.max_len, -128, dtype=np.int32)
        self.gap_close_C = np.full(self.max_len, -128, dtype=np.int32)
        self.gap_open_R = np.full(self.max_len, -128, dtype=np.int32)

    @classmethod
    def from_bytes(cls, b, block_size: int, match_score: int,
                   mismatch_score: int, gap_open_C: int, gap_close_C: int,
                   gap_open_R: int, gap_extend: int) -> "AAProfile":
        """The profile of one sequence: ``match_score`` at its own letter,
        ``mismatch_score`` at every other of A..Z, the same gap costs at
        every position."""
        b = _as_bytes(b)
        p = cls(len(b), block_size, gap_extend)
        for i, ch in enumerate(b):
            for c in range(ord("A"), ord("Z") + 1):
                p.set(i + 1, c, match_score if c == ch else mismatch_score)
        for i in range(len(b) + 1):
            p.set_gap_open_C(i, gap_open_C)
            p.set_gap_close_C(i, gap_close_C)
            p.set_gap_open_R(i, gap_open_R)
        return p

    def __len__(self) -> int:
        return self.str_len

    def len(self) -> int:
        return self.str_len

    def clear(self, str_len: int, block_size: int) -> None:
        """Reset to the padding values for a string of ``str_len``."""
        curr_len = str_len + block_size + 1
        assert curr_len <= self.max_len
        for a in (self.pos_scores, self.gap_open_C, self.gap_close_C,
                  self.gap_open_R):
            a[:curr_len] = -128
        self.str_len = str_len
        self.curr_len = curr_len

    def set(self, i: int, b, score: int) -> None:
        b = _char_upper(b)
        assert 65 <= b <= 65 + 26
        self.pos_scores[i, b - 65] = score

    def set_all(self, order, scores, left_shift: int = 0,
                right_shift: int = 0) -> None:
        """Row i + 1 of the profile from row i of ``scores`` (str_len x
        len(order)), columns in ``order``."""
        self._set_all(order, scores, left_shift, right_shift, rev=False)

    def set_all_rev(self, order, scores, left_shift: int = 0,
                    right_shift: int = 0) -> None:
        """``set_all`` with the rows in reverse order."""
        self._set_all(order, scores, left_shift, right_shift, rev=True)

    def _set_all(self, order, scores, left_shift, right_shift, rev):
        cols = [_char_upper(c) - 65 for c in _as_bytes(order)]
        scores = np.asarray(scores, dtype=np.int64).reshape(self.str_len,
                                                            len(cols))
        # scores scale as i8 values (reference: src/scores.rs:698)
        scaled = ((scores.astype(np.int8) << left_shift)
                  >> right_shift).astype(np.int32)
        rows = range(self.str_len, 0, -1) if rev else range(1,
                                                            self.str_len + 1)
        for i, row in zip(rows, scaled):
            self.pos_scores[i, cols] = row

    def set_gap_open_C(self, i: int, gap: int) -> None:
        assert gap < 0, "Gap open cost must be negative!"
        self.gap_open_C[i] = gap

    def set_gap_close_C(self, i: int, gap: int) -> None:
        self.gap_close_C[i] = gap

    def set_gap_open_R(self, i: int, gap: int) -> None:
        assert gap < 0, "Gap open cost must be negative!"
        self.gap_open_R[i] = gap

    def set_all_gap_open_C(self, gap: int) -> None:
        assert gap < 0
        self.gap_open_C[: self.str_len + 1] = gap

    def set_all_gap_close_C(self, gap: int) -> None:
        self.gap_close_C[: self.str_len + 1] = gap

    def set_all_gap_open_R(self, gap: int) -> None:
        assert gap < 0
        self.gap_open_R[: self.str_len + 1] = gap

    def get(self, i: int, b) -> int:
        return int(self.pos_scores[i, _char_upper(b) - 65])

    def get_gap_extend(self) -> int:
        return self.gap_extend

    def convert(self, seq) -> np.ndarray:
        """Query bytes -> codes: the uppercased byte - 65, wrapping as
        uint8.  The kernels score codes past 27 (the NULL code is 26) at
        -128, as the JAX kernels do."""
        b = np.frombuffer(_as_bytes(seq), dtype=np.uint8).copy()
        lower = (b >= 97) & (b <= 122)
        b[lower] -= 32
        return b - 65


def _load_static_matrices() -> dict:
    with np.load(_MATRICES) as data:
        return {name: AAMatrix(data[name].astype(np.int32)) for name in data.files}


_STATICS = _load_static_matrices()

BLOSUM45: AAMatrix = _STATICS["BLOSUM45"]
BLOSUM50: AAMatrix = _STATICS["BLOSUM50"]
BLOSUM62: AAMatrix = _STATICS["BLOSUM62"]
BLOSUM80: AAMatrix = _STATICS["BLOSUM80"]
BLOSUM90: AAMatrix = _STATICS["BLOSUM90"]
PAM100: AAMatrix = _STATICS["PAM100"]
PAM120: AAMatrix = _STATICS["PAM120"]
PAM160: AAMatrix = _STATICS["PAM160"]
PAM200: AAMatrix = _STATICS["PAM200"]
PAM250: AAMatrix = _STATICS["PAM250"]

#: Match = 1, mismatch = -1 (reference: src/scores.rs:277).
NW1: NucMatrix = NucMatrix.new_simple(1, -1)
#: Match = 1, mismatch = -1 over arbitrary bytes (reference: src/scores.rs:311).
BYTES1: ByteMatrix = ByteMatrix.new_simple(1, -1)


def percent_len(length: int, p: float) -> int:
    """Percentage of a length rounded to the next power of two, clamped to
    [32, 2^14] (reference: src/lib.rs:105-111)."""
    v = int(np.round(p * float(length)))
    v = max(v, 32)
    v = 1 << (v - 1).bit_length()
    return min(v, 1 << 14)
