"""Numeric constants of the block state machine and the result record
(counterparts: ``block_aligner_tpu/core/oracle.py:46-75``)."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["AlignResult", "STEP", "ZERO", "I16_MIN", "I16_MAX"]

#: Columns (or rows) a block advances per shift.
STEP = 8
#: Block scores are i16 values relative to this bias.
ZERO = 1 << 14
I16_MIN = -(1 << 15)
I16_MAX = (1 << 15) - 1


@dataclass(frozen=True)
class AlignResult:
    """Score and end position (reference: src/scan_block.rs:1887-1893)."""

    score: int
    query_idx: int
    reference_idx: int
