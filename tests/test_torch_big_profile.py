"""Kernel C's profile mode in the port against the JAX package: the plain
version of the big route on (query, profile) pairs (``big_align_plain`` on
a profile ``BigKernelConfig``, its table of ``prof_cap`` positions clamped
to each profile's rlen + 1) against ``BlockOracle.align_profile``, global,
x-drop, traced (CIGARs equal as strings), with the flags and on a pair whose
blocks grow to 1024; ``ProfileAligner`` on the big route against the JAX
``ProfileAligner`` (its big kernel in interpret mode, one compile for the
module) on the pairs of the JAX package's
``tests/test_big_profile.py::test_big_profile_vs_oracle_1024``; the
refusals.  Every comparison is exact: the tolerance is 0.  The CUDA kernel
runs only on the card (``chip_smoke.py``); ``test_torch_kernel_sources.py``
holds its source's profile instances against this plain version here."""

import os

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
import chip_smoke
from block_aligner_tpu_torch.ops import big_kernel as bk
from block_aligner_tpu_torch.ops._profile import pack_profile
from test_big_profile import growth_pair, rand_profile, rand_seq
from test_torch_profile import both, fields, oracle

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def mutated(rng, n, block=1024):
    """A random profile of ``n`` positions (``rand_profile``: varied gap
    opens and close costs) and its consensus with n/4 substitutions."""
    prof, cons = rand_profile(rng, n, block)
    q = bytearray(cons)
    for _ in range(n // 4):
        q[int(rng.integers(0, len(q)))] = int(rng.choice(list(b"ACDEFGHIKLMN"
                                                            b"PQRSTVWY")))
    return bytes(q), prof, cons


def oracle_pairs(seed):
    """JAX-package pairs whose oracle runs take about a second in all: two
    mutated profiles, a query overhanging its profile and one missing a
    stretch of it (the last two's profile gaps run along down rects)."""
    rng = np.random.default_rng(seed)
    q, prof, _ = mutated(rng, 90)
    pairs = [(q, prof)]
    q, prof, cons = mutated(rng, 140)
    pairs.append((q, prof))
    pairs.append((cons + rand_seq(rng, 60), prof))
    pairs.append((bytes(cons[:30]) + bytes(cons[100:]), prof))
    return pairs


def big_cfg(size, prof_cap=256, cap=1536, **modes):
    return bk.BigKernelConfig(*size, cap, profile=True, prof_cap=prof_cap,
                              **modes)


@pytest.mark.parametrize("size,mode,x,trace", [
    ((128, 1024), None, None, False), ((128, 1024), None, 20, False),
    ((32, 512), None, None, True), ((128, 1024), None, 20, True),
    ((128, 1024), "local_start", None, True),
    ((128, 1024), "free_query_start_gaps", None, False),
    ((128, 1024), "free_query_end_gaps", None, False),
], ids=["global", "x-drop", "trace", "x-drop-trace", "local-start-trace",
        "free-start", "free-end"])
def test_big_plain_matches_oracle(size, mode, x, trace):
    """Scores (x-drop and free end gaps: with their positions) and traced
    CIGARs equal the oracle's."""
    jpairs = oracle_pairs(size[0] + (x or 0) + len(mode or "") + trace)
    if mode == "free_query_end_gaps":
        jpairs = [(q[: size[0] - 1], p) for q, p in jpairs]
    tpairs = [(q, tba.profile_from_jax(p)) for q, p in jpairs]
    modes = {mode: True} if mode else {}
    cfg = big_cfg(size, x_drop=x is not None, trace=trace, **modes)
    got = bk.big_align_plain(*pack_profile(tpairs, cfg, "cpu", x or 0), cfg)
    tr = chip_smoke.block_trace(got, None, cfg) if trace else None
    out = (got[0] if trace else got).numpy()
    assert not out[:, -1].any()
    wide = x is not None or mode == "free_query_end_gaps"
    orc = jba.BlockOracle(x_drop=x is not None, trace=trace, **modes)
    for k, (q, p) in enumerate(jpairs):
        orc.align_profile(jba.PaddedBytes.from_bytes(q, size[1], p), p, size,
                          x or 0)
        want = orc.res()
        assert (tuple(out[k, :3]) if wide else out[k, 0]) == (
            (want.score, want.query_idx, want.reference_idx) if wide
            else want.score), k
        if trace:
            ends = (want.query_idx, want.reference_idx)
            assert str(tr.cigar(k, *ends)) == str(orc.cigar(*ends)), k
    if x is not None:
        assert any(tuple(o[1:3]) != (len(q), p.str_len)
                   for o, (q, p) in zip(out, tpairs))


def test_big_plain_grows_to_1024():
    """A strong-consensus pair with random middles (``chip_smoke``'s
    growth pairs) at (128, 1024): the plain version's blocks reach 1024
    rows and its score is the oracle's."""
    tpairs = chip_smoke.consensus_growth_pairs(np.random.default_rng(3), 1,
                                               100, 500)
    cfg = big_cfg((128, 1024), prof_cap=768, cap=1792)
    out, top = bk.big_align_plain(*pack_profile(tpairs, cfg, "cpu"), cfg,
                                  top_size=True)
    assert int(top[0]) == 1024
    (want, _), = oracle(both(tpairs)[1], (128, 1024))
    assert int(out[0, 0]) == want[0]


def test_big_clamp_reads_the_pad():
    """A profile far shorter than the table (20 positions in 1024, and
    pairs of the first case) gives what the smallest table gives: every
    position past rlen + 1 reads rlen + 1's all-zero pad word, and only
    rows 0..rlen + 1 are packed."""
    rng = np.random.default_rng(9)
    q, prof, _ = mutated(rng, 20)
    tpairs = [(q, tba.profile_from_jax(prof))] + [
        (q, tba.profile_from_jax(p)) for q, p in oracle_pairs(128)[:2]]
    outs = []
    for prof_cap in (256, 1024):
        cfg = big_cfg((128, 1024), prof_cap=prof_cap)
        pk = pack_profile(tpairs, cfg, "cpu")
        assert pk.table.shape == (3, prof_cap, 8)
        rows = (pk.table != 0).any(2).sum(1)
        assert (rows <= pk.rlen + 2).all() and not pk.table[:, 2 + int(
            pk.rlen.max()):].any()
        outs.append(bk.big_align_plain(*pk, cfg))
    assert torch.equal(*outs)
    (want, _), = oracle(both(tpairs[:1])[1], (128, 1024))
    assert int(outs[0][0, 0]) == want[0]


def test_big_refusals():
    """What the JAX package refuses: byte mode with a profile, a profile
    longer than prof_cap - 10, profiles of a batch with other gap
    extensions, blocks past 8192; and a configuration without a table
    size."""
    with pytest.raises(ValueError, match="profile"):
        bk.BigKernelConfig(16, 1024, 2048, 256, profile=True, prof_cap=256,
                           byte_mode=True)
    with pytest.raises(ValueError, match="prof_cap"):
        bk.BigKernelConfig(16, 1024, 2048, profile=True)
    al = tba.ProfileAligner((128, 1024), seq_cap=300, prof_len=100,
                            device="cpu")
    assert al.route == "big" and al.cfg.prof_cap == 128
    rng = np.random.default_rng(2)
    long_one = (b"ACD", tba.profile_from_jax(rand_profile(rng, 119, 16)[0]))
    with pytest.raises(AssertionError, match="prof_cap 128 must cover"):
        al.align_batch([long_one])
    q, prof, _ = mutated(rng, 30)
    other = tba.profile_from_jax(prof)
    other.gap_extend = -2
    with pytest.raises(AssertionError, match="share gap_extend"):
        al.align_batch([long_one, (q, other)])
    with pytest.raises(ValueError, match="8192"):
        tba.ProfileAligner((128, 16384), device="cpu")


def test_align_profile_exp_all_past_512():
    """The ladder 256, 512 (big) and 1024 (big, fixed), targets the fixed
    (1024, 1024) scores, one unreachable: every result is the plain
    version's at the min size it reports."""
    jpairs = oracle_pairs(5)[:3]
    tpairs = [(q, tba.profile_from_jax(p)) for q, p in jpairs]
    fixed = tba.ProfileAligner((1024, 1024), batch=4, seq_cap=250,
                               device="cpu")
    targets = [r.score for r in fixed.align_all(tpairs)]
    targets[1] += 1  # unreachable: every level runs
    got, mins = tba.align_profile_exp_all(tpairs, targets, (256, 1024),
                                          batch=4, seq_cap=250, device="cpu")
    assert mins[1] is None and mins[0] == mins[2] == 256
    for k, (m, r) in enumerate(zip(mins, got)):
        al = tba.ProfileAligner((m or 1024, 1024), batch=4, seq_cap=250,
                                device="cpu")
        assert al.route == "big"
        assert fields(al.align_batch(tpairs[k : k + 1])) == fields([r])


@pytest.fixture(scope="module")
def jax_1024():
    """``test_big_profile_vs_oracle_1024``'s pairs (three mutated profiles,
    two growth pairs, two overhangs) and the first 8 of its 124 short
    fillers, which there fill the JAX kernel's first grid program, through
    the JAX ProfileAligner at (128, 1024): its one big-kernel compile
    here.  All 124 are drawn, so the other pairs are that test's own."""
    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(124):
        prof, cons = rand_profile(rng, int(rng.integers(5, 12)), 1024)
        pairs.append((cons, prof))
    del pairs[FILLERS:]
    for _ in range(3):
        q, prof, _ = mutated(rng, int(rng.integers(80, 300)))
        pairs.append((q, prof))
    pairs.append(growth_pair(rng, 400, 260, 1024))
    pairs.append(growth_pair(rng, 500, 420, 1024))
    prof, cons = rand_profile(rng, 350, 1024)
    pairs.append((cons + rand_seq(rng, 200), prof))
    pairs.append((bytes(cons[:120]) + bytes(cons[260:]), prof))
    al = jba.ProfileAligner((128, 1024), batch=128, seq_cap=960)
    assert al._big
    want = fields(al.align_batch(pairs))
    return [(q, tba.profile_from_jax(p)) for q, p in pairs], want


FILLERS = 8


def test_big_profile_aligner_align_all_matches_jax(jax_1024):
    """``align_all`` in length-sorted batches gives the JAX
    ProfileAligner's results on every pair, the growth pairs' too."""
    pairs, want = jax_1024
    al = tba.ProfileAligner((128, 1024), batch=4, seq_cap=960, device="cpu")
    assert al.route == "big" and al.cfg.prof_cap == 1024
    assert fields(al.align_all(pairs)) == want


def test_big_profile_aligner_staged_matches_jax(jax_1024):
    """A staged batch (fillers, the mutated profiles and the overhangs)
    run twice gives the JAX ProfileAligner's results."""
    pairs, want = jax_1024
    F = FILLERS
    pick = [0, 1, F, F + 1, F + 2, F + 5, F + 6]
    al = tba.ProfileAligner((128, 1024), batch=8, seq_cap=960, device="cpu")
    staged = al.stage([pairs[k] for k in pick])
    for _ in range(2):
        assert fields(al.align_staged(staged)) == [want[k] for k in pick]
