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
* ``ByteMatrix``: match/mismatch by byte equality (no kernel serves it yet).
* ``Gaps``: ``open`` includes the first extension; a gap of length n costs
  ``open + extend * (n - 1)``.
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
    "Gaps", "AAMatrix", "NucMatrix", "ByteMatrix", "NW1", "BYTES1",
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

    Class surface only: no port kernel scores byte matrices yet."""

    kind: ClassVar[str] = "byte"
    NULL: ClassVar[int] = 0

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
