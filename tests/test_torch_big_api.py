"""The big route as a whole: the port's ``BatchAligner`` on blocks past 512
against the JAX package's (its big kernel in interpret mode, on one small
configuration), x-drop through the aligner, ``align_exp_all`` with a max
past 512 against a ``BlockOracle`` ladder, the route choices, the
ByteMatrix and flag modes against ``BlockOracle`` and the profile mode that
still raises.  Every comparison is exact."""

import os

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
import chip_smoke
from block_aligner_tpu_torch.ops import big_kernel as bk
from test_big_kernel import structural_pairs
from test_torch_adaptive_kernel import protein_pairs
from test_torch_api import fields, oracle_exp_all

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GAPS = tba.Gaps(-11, -1)


def test_big_batch_aligner_matches_jax():
    """``test_big_kernel_api_route``'s configuration: (64, 1024), batch 128,
    seq_cap 1024, five pairs with big indels; ``align_batch``, a staged
    batch run twice and ``align_all`` give the JAX package's results."""
    pairs = structural_pairs(np.random.default_rng(61), 5, 200, 450)
    jal = jba.BatchAligner(jba.BLOSUM62, jba.Gaps(-11, -1), (64, 1024),
                           batch=128, seq_cap=1024)
    assert jal._big
    want = fields(jal.align_batch(pairs))
    al = tba.BatchAligner(tba.BLOSUM62, GAPS, (64, 1024), batch=128,
                          seq_cap=1024, device="cpu")
    assert al.route == "big" and isinstance(al.cfg, bk.BigKernelConfig)
    assert al.seq_capacity == jal.seq_capacity
    assert fields(al.align_batch(pairs)) == want
    staged = al.stage(pairs)
    assert fields(al.align_staged(staged)) == want
    assert fields(al.align_staged(staged)) == want
    al = tba.BatchAligner(tba.BLOSUM62, GAPS, (64, 1024), batch=2,
                          seq_cap=1024, device="cpu")
    assert fields(al.align_all(pairs)) == want


def test_big_x_drop_batch_aligner():
    """x-drop on the big route: each result is the plain version's best
    score and its position, in the caller's order through ``align_all``,
    and the unrelated pairs end short of their ends."""
    pairs = protein_pairs(8, 12)
    al = tba.BatchAligner(tba.BLOSUM62, GAPS, (128, 1024), batch=5,
                          seq_cap=512, x_drop=30, device="cpu")
    assert al.route == "big" and al.cfg.x_drop
    got = fields(al.align_all(pairs))
    pk = bk.pack_big(pairs, tba.BLOSUM62, al.cfg, GAPS, "cpu", 30)
    want = bk.big_align_plain(*pk, al.cfg)[:, :3].tolist()
    assert [list(g) for g in got] == want
    assert sum(g[1] < len(q) or g[2] < len(r)
               for g, (q, r) in zip(got, pairs)) > 0


def test_align_exp_all_past_512():
    """The x-drop retry ladder 256, 512 (big, min < max) and 1024 (big,
    fixed), targets the fixed (1024, 1024) scores: the results and min
    sizes of the JAX package's ladder, run through ``BlockOracle``.  A pair
    with 300 residues inserted settles only at 512 (x-drop ends the
    256-row band inside the insertion); one target is unreachable and runs
    every level."""
    pairs = [(q[:150], r[:150]) for q, r in protein_pairs(41, 7)[4:]]
    pairs += chip_smoke.grow_to_512_pairs(np.random.default_rng(12), 2, 250,
                                          300)[1:]
    fixed = tba.BatchAligner(tba.BLOSUM62, GAPS, (1024, 1024), batch=16,
                             seq_cap=1100, x_drop=50, device="cpu")
    targets = [r.score for r in fixed.align_all(pairs)]
    targets[1] += 1  # unreachable
    want, want_min = oracle_exp_all(pairs, targets, (256, 1024), x_drop=50)
    got, got_min = tba.align_exp_all(tba.BLOSUM62, GAPS, pairs, targets,
                                     (256, 1024), x_drop=50, batch=16,
                                     seq_cap=1100, device="cpu")
    assert got_min == want_min == [256, None, 256, 512]
    assert fields(got) == fields(want)


@pytest.mark.parametrize("size,trace,route", [
    ((32, 512), False, "big"), ((32, 512), True, "adaptive"),
    ((1024, 1024), False, "big"), ((512, 8192), False, "big"),
    ((512, 512), False, "lane"),
])
def test_routes(size, trace, route):
    """``pick_route``'s choices: (min, 512) without trace, fixed blocks
    past 512 and the (512, 8192) band take the big kernel."""
    if trace:
        al = tba.BatchAligner(tba.BLOSUM62, GAPS, size, trace=True,
                              seq_cap=512, device="cpu")
    else:
        al = tba.BatchAligner(tba.BLOSUM62, GAPS, size, seq_cap=512,
                              device="cpu")
    assert al.route == route


@pytest.mark.parametrize("kwargs", [
    dict(trace=True, matrix=tba.BYTES1), dict(matrix=tba.BYTES1),
    dict(local_start=True),
    dict(free_query_start_gaps=True), dict(free_query_end_gaps=True),
], ids=["trace", "byte", "local_start", "free_start", "free_end"])
def test_later_modes_raise(kwargs):
    """The modes that raised on the big route before its FLAGS instances
    now route there and give ``BlockOracle``'s results on three pairs
    (traced: its CIGARs too); profiles past 512 still raise, naming the
    ROADMAP item that brings them."""
    kw = dict(matrix=tba.BLOSUM62, gaps=GAPS, size=(128, 1024), batch=3,
              seq_cap=300, device="cpu")
    kw.update(kwargs)
    byte = kw["matrix"] is tba.BYTES1
    rng = np.random.default_rng(len(kwargs) + 3 * byte)
    pairs = (chip_smoke.byte_pairs(rng, 7, 250) if byte else
             chip_smoke.structural_pairs(rng, chip_smoke.AA, 7, 250))[4:]
    if kw.get("free_query_end_gaps"):
        pairs = [(q[:100], r) for q, r in pairs]
    al = tba.BatchAligner(**kw)
    assert al.route == "big"
    flags = {k: v for k, v in kwargs.items()
             if k not in ("trace", "matrix")}
    jm = jba.BYTES1 if byte else jba.BLOSUM62
    orc = jba.BlockOracle(trace=al.trace_mode, **flags)
    for k, got in enumerate(al.align_batch(pairs)):
        q, r = pairs[k]
        orc.align(jba.PaddedBytes.from_bytes(q, 1024, jm),
                  jba.PaddedBytes.from_bytes(r, 1024, jm), jm,
                  jba.Gaps(-11, -1), (128, 1024), 0)
        want = orc.res()
        assert (got.score, got.query_idx, got.reference_idx) == (
            want.score, want.query_idx, want.reference_idx), k
        if al.trace_mode:
            i, j = got.query_idx, got.reference_idx
            assert str(al.cigar(k, i, j)) == str(orc.cigar(i, j)), k
    with pytest.raises(NotImplementedError,
                       match="route 'big'.*ROADMAP.md queue 2 item 5d"):
        tba.ProfileAligner((128, 1024), device="cpu")


def test_step_cap_raises():
    """A pair past the big kernel's step cap raises, as the JAX package
    asserts (``api.py:1203``)."""
    al = tba.BatchAligner(tba.BLOSUM62, GAPS, (32, 512), seq_cap=256,
                          device="cpu")
    al.cfg = chip_smoke.with_step_cap(al.cfg, 10)
    with pytest.raises(RuntimeError, match="big kernel's step cap"):
        al.align_batch([(b"ACDEFGHIKLMNPQ" * 10, b"ACDEFGHIKLMNPQ" * 10)])
