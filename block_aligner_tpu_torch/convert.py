"""Carry scoring parameters over from the JAX package.

Duck-typed: these read only a matrix's numpy ``.kind`` and ``.table`` and a
gap object's ``.open`` and ``.extend``, so the port never imports
``block_aligner_tpu``.  The tests use them so that both packages score with
identical tables.
"""

from __future__ import annotations

import numpy as np

from .core.scores import AAMatrix, Gaps, NucMatrix

__all__ = ["matrix_from_jax", "gaps_from_jax"]


def matrix_from_jax(m):
    """A JAX-package ``AAMatrix`` or ``NucMatrix`` -> the port's."""
    cls = {"aa": AAMatrix, "nuc": NucMatrix}.get(m.kind)
    if cls is None:
        raise ValueError(f"no port matrix for kind {m.kind!r}")
    return cls(np.array(m.table, dtype=np.int32))


def gaps_from_jax(g) -> Gaps:
    """A JAX-package ``Gaps`` -> the port's."""
    return Gaps(int(g.open), int(g.extend))
