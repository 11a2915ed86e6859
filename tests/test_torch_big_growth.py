"""Deep growth on the big route: a batch whose blocks grow to 4096 rows,
``big_align_plain`` against ``BlockOracle``, and the upper i16 rail, which
past 2048 rows a grow's columns reach before any offset rebase.  Exact
comparisons; the oracle's 4096-row rects make this the slowest of the big
route's tests."""

import os

import numpy as np
import torch

import chip_smoke
from block_aligner_tpu import BLOSUM62, BlockOracle, Gaps, PaddedBytes
from block_aligner_tpu_torch import gaps_from_jax, matrix_from_jax
from block_aligner_tpu_torch.ops import big_kernel as bk

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GAPS = Gaps(open=-11, extend=-1)


def plain(pairs, size, cap):
    cfg = bk.BigKernelConfig(*size, cap)
    pk = bk.pack_big(pairs, matrix_from_jax(BLOSUM62), cfg,
                     gaps_from_jax(GAPS), "cpu")
    return bk.big_align_plain(*pk, cfg, top_size=True)


def test_batch_grows_to_4096():
    """At (512, 4096): two unrelated proteins of 2100 and 2150 residues,
    whose rects find no new best, so the ladder grows from the origin's
    checkpoint to 4096 (JAX ``tests/test_big_kernel.py::
    test_big_kernel_4096_growth`` grows through a random middle), beside a
    homologous pair that stays at 512; scores equal the oracle's."""
    rng = np.random.default_rng(5)
    a = rng.choice(chip_smoke.AA, size=600).tobytes()
    pairs = [(rng.choice(chip_smoke.AA, size=2100).tobytes(),
              rng.choice(chip_smoke.AA, size=2150).tobytes()),
             (a, a[:300] + a[310:])]
    got, top = plain(pairs, (512, 4096), 6400)
    assert top.tolist() == [4096, 512] and not got[:, 1].any()
    orc = BlockOracle()
    for k, (q, r) in enumerate(pairs):
        orc.align(PaddedBytes.from_bytes(q, 4096, BLOSUM62),
                  PaddedBytes.from_bytes(r, 4096, BLOSUM62), BLOSUM62, GAPS,
                  (512, 4096), 0)
        assert int(got[k, 0]) == orc.res().score, k


def test_upper_rail():
    """1500 W residues against themselves at fixed (2048, 2048): the first
    rect's 1500 diagonal columns add 11 each to ZERO = 16384 with no
    rebase, so D saturates at 32767 from row 1490 on and the score is
    32767 - 16384 = 16383, not 16500; ``BlockOracle`` gives 16383 too (12 s
    on one CPU core, so it is pinned here).  A run of 1400 stays below the
    rail (16384 + 15400 = 31784) and scores its sum."""
    w = b"W" * 1500
    got, _ = plain([(w, w), (w[:1400], w[:1400])], (2048, 2048), 3712)
    assert got[:, 0].tolist() == [16383, 1400 * 11]
