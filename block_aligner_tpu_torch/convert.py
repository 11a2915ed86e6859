"""Carry scoring parameters over from the JAX package.

Duck-typed: these read only a matrix's ``.kind`` and numpy ``.table`` (a
byte matrix's ``.match_score`` and ``.mismatch_score``), a
gap object's ``.open`` and ``.extend`` and a profile's arrays and lengths,
so the port never imports ``block_aligner_tpu``.  The tests use them so that
both packages score with identical tables.
"""

from __future__ import annotations

import numpy as np

from .core.scores import AAMatrix, AAProfile, ByteMatrix, Gaps, NucMatrix

__all__ = ["matrix_from_jax", "gaps_from_jax", "profile_from_jax"]


def matrix_from_jax(m):
    """A JAX-package ``AAMatrix``, ``NucMatrix`` or ``ByteMatrix`` -> the
    port's."""
    if m.kind == "byte":
        return ByteMatrix(int(m.match_score), int(m.mismatch_score))
    cls = {"aa": AAMatrix, "nuc": NucMatrix}.get(m.kind)
    if cls is None:
        raise ValueError(f"no port matrix for kind {m.kind!r}")
    return cls(np.array(m.table, dtype=np.int32))


def gaps_from_jax(g) -> Gaps:
    """A JAX-package ``Gaps`` -> the port's."""
    return Gaps(int(g.open), int(g.extend))


def profile_from_jax(p) -> AAProfile:
    """A JAX-package ``AAProfile`` -> the port's, every array copied."""
    out = AAProfile.__new__(AAProfile)
    out.max_len, out.curr_len = int(p.max_len), int(p.curr_len)
    out.str_len, out.gap_extend = int(p.str_len), int(p.gap_extend)
    for name in ("pos_scores", "gap_open_C", "gap_close_C", "gap_open_R"):
        setattr(out, name, np.array(getattr(p, name), dtype=np.int32))
    return out
