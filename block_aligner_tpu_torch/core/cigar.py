"""CIGAR strings (reference: src/cigar.rs); the port's own copy of
``block_aligner_tpu/core/cigar.py``.

Operations are encoded with the same numeric values as the reference, so the
batch walker's op arrays and the reference agree on the encoding.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Tuple

__all__ = ["Operation", "OpLen", "Cigar"]


class Operation(enum.IntEnum):
    """Edit operations to get from ``r`` to ``q`` (reference: src/cigar.rs:10-31)."""

    Sentinel = 0
    M = 1  # match or mismatch (diagonal)
    Eq = 2  # match
    X = 3  # mismatch
    I = 4  # insertion: gap in r (row transition)  # noqa: E741
    D = 5  # deletion: gap in q (column transition)


_OP_CHAR = {
    Operation.M: "M",
    Operation.Eq: "=",
    Operation.X: "X",
    Operation.I: "I",
    Operation.D: "D",
}


@dataclass
class OpLen:
    op: Operation
    len: int


_OP_BY_VALUE = (Operation.Sentinel, Operation.M, Operation.Eq, Operation.X,
                Operation.I, Operation.D)


class Cigar:
    """Run-length-encoded operation list, built in reverse during traceback.

    Batch traceback (``Trace.cigars_all``) constructs Cigars directly from
    forward-order run arrays; the per-``OpLen`` list materializes lazily on
    first access, so a batch's CIGARs cost one array each until read.
    """

    def __init__(self, query_len: int = 0, reference_len: int = 0):
        # ops are appended in traceback (reverse) order; viewing methods
        # reverse them (reference: src/cigar.rs:63-94)
        self._ops: List[OpLen] = []
        self._arr = None  # lazy (n, 2) forward-order (op, len) runs

    @classmethod
    def _from_forward_runs(cls, arr) -> "Cigar":
        """Wrap an (n, 2) int array of forward-order (op, len) runs."""
        c = cls.__new__(cls)
        c._ops = None
        c._arr = arr
        return c

    def _mat(self) -> List[OpLen]:
        if self._ops is None:
            a = self._arr
            self._ops = [OpLen(_OP_BY_VALUE[int(a[k, 0])], int(a[k, 1]))
                         for k in range(a.shape[0] - 1, -1, -1)]
        return self._ops

    def clear(self, query_len: int = 0, reference_len: int = 0) -> None:
        self._ops = []
        self._arr = None

    def add(self, op: Operation, n: int = 1) -> None:
        """Append ``op`` (run-length-coalescing), in reverse order."""
        ops = self._mat()
        if ops and ops[-1].op == op:
            ops[-1].len += n
        else:
            ops.append(OpLen(Operation(op), n))

    def reverse(self) -> None:
        self._mat().reverse()

    def __len__(self) -> int:
        if self._ops is None:
            return int(self._arr.shape[0])
        return len(self._ops)

    def get(self, i: int) -> OpLen:
        if self._ops is None:
            a = self._arr
            return OpLen(_OP_BY_VALUE[int(a[i, 0])], int(a[i, 1]))
        return self._ops[len(self._ops) - 1 - i]

    def to_vec(self) -> List[OpLen]:
        if self._ops is None:
            a = self._arr
            return [OpLen(_OP_BY_VALUE[int(a[k, 0])], int(a[k, 1]))
                    for k in range(a.shape[0])]
        return [OpLen(o.op, o.len) for o in reversed(self._ops)]

    def format(self, q, r) -> Tuple[str, str]:
        """Render the two aligned strings with '-' for gaps (reference: src/cigar.rs:97-132)."""
        if isinstance(q, str):
            q = q.encode("ascii")
        if isinstance(r, str):
            r = r.encode("ascii")
        a = []
        b = []
        i = j = 0
        for ol in reversed(self._mat()):
            if ol.op in (Operation.M, Operation.Eq, Operation.X):
                for _ in range(ol.len):
                    a.append(chr(q[i]))
                    b.append(chr(r[j]))
                    i += 1
                    j += 1
            elif ol.op == Operation.I:
                for _ in range(ol.len):
                    a.append(chr(q[i]))
                    b.append("-")
                    i += 1
            elif ol.op == Operation.D:
                for _ in range(ol.len):
                    a.append("-")
                    b.append(chr(r[j]))
                    j += 1
        return "".join(a), "".join(b)

    def __str__(self) -> str:
        if self._ops is None:
            a = self._arr
            return "".join(
                f"{int(a[k, 1])}{_OP_CHAR[_OP_BY_VALUE[int(a[k, 0])]]}"
                for k in range(a.shape[0])
                if _OP_BY_VALUE[int(a[k, 0])] in _OP_CHAR
            )
        return "".join(
            f"{ol.len}{_OP_CHAR[ol.op]}" for ol in reversed(self._ops) if ol.op in _OP_CHAR
        )

    to_string = __str__

    def __repr__(self) -> str:
        return f"Cigar({self})"
