"""The slice as a whole: the port's ``BatchAligner`` and ``align_exp_all`` on
the CPU against the JAX package's (lane and adaptive kernels, interpret
mode) with tables carried over by ``convert.py``.  Every comparison is
exact."""

import os

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
from block_aligner_tpu.api import pick_route as jax_pick_route
from block_aligner_tpu.core.full_dp import global_align_score
from test_torch_adaptive_kernel import protein_pairs as homolog_pairs

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


def protein_pairs(seed, n):
    """Related and unrelated protein pairs of lengths 0..160."""
    rng = np.random.default_rng(seed)
    pairs = [(b"", b""), (b"M", b""), (b"W", b"W")]
    while len(pairs) < n:
        q = rng.choice(AA, size=int(rng.integers(1, 161)))
        if len(pairs) % 2:
            r = rng.choice(AA, size=int(rng.integers(0, 161)))
        else:
            r = q.copy()
            k = len(q) // 5 + 1
            r[rng.integers(0, len(q), size=k)] = rng.choice(AA, size=k)
            r = np.insert(r, rng.integers(0, len(r) + 1, size=k // 3),
                          rng.choice(AA, size=k // 3))
        pairs.append((q.tobytes(), r.tobytes()))
    return pairs


@pytest.fixture(scope="module")
def jax_reference():
    """40 pairs through the JAX BatchAligner at (32, 32)."""
    pairs = protein_pairs(11, 40)
    al = jba.BatchAligner(jba.BLOSUM62, jba.Gaps(-11, -1), (32, 32), batch=64,
                          seq_cap=256)
    res = al.align_batch(pairs)
    return pairs, res, al.last_suspect.copy(), al.seq_capacity


def port_aligner(batch, size=(32, 32), seq_cap=256):
    return tba.BatchAligner(tba.matrix_from_jax(jba.BLOSUM62),
                            tba.gaps_from_jax(jba.Gaps(-11, -1)), size,
                            batch=batch, seq_cap=seq_cap, device="cpu")


def fields(results):
    return [(r.score, r.query_idx, r.reference_idx) for r in results]


def test_batch_aligner_matches_jax(jax_reference):
    pairs, want, want_susp, want_cap = jax_reference
    al = port_aligner(64)
    got = al.align_batch(pairs)
    assert all(isinstance(r, tba.AlignResult) for r in got)
    assert fields(got) == fields(want)
    assert np.array_equal(al.last_suspect, want_susp)
    assert 0 < want_susp.sum() < len(pairs)
    assert al.seq_capacity == want_cap


def test_align_all_and_staged_match_jax(jax_reference):
    """Several length-sorted batches, and a staged batch run twice, give
    the JAX package's results in the caller's order."""
    pairs, want, want_susp, _ = jax_reference
    al = port_aligner(16)
    assert fields(al.align_all(pairs)) == fields(want)
    assert np.array_equal(al.last_suspect, want_susp)
    assert fields(al.align_all(pairs, sort=False)) == fields(want)
    assert np.array_equal(al.last_suspect, want_susp)
    staged = al.stage(pairs[:16])
    for _ in range(2):
        assert fields(al.align_staged(staged)) == fields(want[:16])
        assert np.array_equal(al.last_suspect, want_susp[:16])
    assert al.align_all([]) == []


def test_nucleotide_batch_matches_jax():
    rng = np.random.default_rng(4)
    dna = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = [(rng.choice(dna, size=int(rng.integers(0, 90))).tobytes(),
              rng.choice(dna, size=int(rng.integers(0, 90))).tobytes())
             for _ in range(20)]
    pairs.append((b"TTTTTTTTAAAAAAATTTTTTTTT", b"TTAAAAAAATTTTTTTTTTTT"))
    jal = jba.BatchAligner(jba.NW1, jba.Gaps(-2, -1), (16, 16), batch=32,
                           seq_cap=128)
    want = jal.align_batch(pairs)
    al = tba.BatchAligner(tba.NW1, tba.Gaps(-2, -1), (16, 16), batch=32,
                          seq_cap=128, device="cpu")
    assert fields(al.align_batch(pairs)) == fields(want)
    assert np.array_equal(al.last_suspect, jal.last_suspect)
    assert want[-1].score == 7  # the reference's doc example


@pytest.mark.parametrize("args", [
    (16, 16, 1024, {}), (32, 32, 1024, {}), (512, 512, 1024, {}),
    (32, 256, 1024, {}), (32, 256, 1024, {"trace": True}),
    (32, 512, 1024, {}), (32, 512, 1024, {"trace": True}),
    (64, 1024, 1024, {}), (512, 8192, 50000, {}), (32, 32, 20000, {}),
    (32, 32, 20000, {"is_byte": True}), (16, 64, 20000, {}),
    (16, 64, 20000, {"free_query_end_gaps": True}), (32, 32768, 1024, {}),
    (8, 8, 100, {}), (256, 128, 1024, {}),
])
def test_pick_route_matches_jax(args):
    lo, hi, cap, kw = args
    assert tba.pick_route(lo, hi, cap, **kw) == jax_pick_route(lo, hi, cap, **kw)


# the configurations the big route's FLAGS instances and the long routes
# brought, by the kernel route they take: they align there now, as
# BlockOracle does; the others raise
@pytest.mark.parametrize("kwargs,route", [
    (dict(size=(64, 1024), free_query_start_gaps=True), "big"),
    (dict(seq_cap=20000), "lane"),
    (dict(size=(64, 1024), trace=True, local_start=True), "big"),
    (dict(seq_cap=20000, local_start=True), "lane"),
    (dict(free_query_start_gaps=True, use_lane_kernel=False), None),
    (dict(free_query_end_gaps=True, mesh=object()), None),
    (dict(matrix=tba.BYTES1, size=(64, 1024)), "big"),
    (dict(mesh=object()), None),
    (dict(use_lane_kernel=False), None),
    (dict(size=(64, 1024), trace=True, matrix=tba.BYTES1), "big"),
    (dict(size=(32, 512), local_start=True), "big"),
    (dict(size=(16, 64), seq_cap=20000, free_query_end_gaps=True), None),
    (dict(size=(32, 256), seq_cap=20000, matrix=tba.BYTES1), "adaptive"),
], ids=["big", "long_lane", "trace_local_start", "local_start",
        "free_start", "free_end", "byte", "mesh", "engine",
        "big_trace", "adaptive_local_start",
        "adaptive_free_end", "adaptive_byte"])
def test_unported_configurations_raise(kwargs, route):
    """Configurations the port lacks raise ``NotImplementedError`` naming
    their ROADMAP item (the engine, item 3, and a mesh, item 6); those the
    big route's ByteMatrix and flag instances brought, and those past the
    16384 code positions of the JAX kernels' VMEM that the long routes
    brought (``seq_cap=20000``: "long_lane" on the lane kernel, "long" on
    the adaptive kernel), take their kernel route and give
    ``BlockOracle``'s results (traced: its CIGARs) on two pairs."""
    kw = dict(matrix=tba.BLOSUM62, gaps=tba.Gaps(-11, -1), size=(32, 32),
              device="cpu")
    kw.update(kwargs)
    if route is None:
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue"):
            tba.BatchAligner(**kw)
        return
    al = tba.BatchAligner(**kw)
    assert al.route == route
    assert al.long == (kw.get("seq_cap", 1024) == 20000)
    pairs = homolog_pairs(5, 7)[5:]
    matrix = jba.BYTES1 if kw["matrix"] is tba.BYTES1 else jba.BLOSUM62
    flags = {k: v for k, v in kwargs.items()
             if k in ("local_start", "free_query_start_gaps")}
    orc = jba.BlockOracle(trace=al.trace_mode, **flags)
    hi = kw["size"][1]
    for k, got in enumerate(al.align_batch(pairs)):
        orc.align(*(jba.PaddedBytes.from_bytes(s, hi, matrix)
                    for s in pairs[k]), matrix, jba.Gaps(-11, -1),
                  kw["size"], 0)
        want = orc.res()
        assert (got.score, got.query_idx, got.reference_idx) == (
            want.score, want.query_idx, want.reference_idx), k
        if al.trace_mode:
            i, j = got.query_idx, got.reference_idx
            assert str(al.cigar(k, i, j)) == str(orc.cigar(i, j)), k


@pytest.fixture(scope="module", params=[(16, 64), (32, 128)],
                ids=["16-64", "32-128"])
def jax_adaptive(request):
    """30 homolog, unrelated and edge-case pairs through the JAX
    BatchAligner on the adaptive route."""
    pairs = homolog_pairs(23, 30)
    al = jba.BatchAligner(jba.BLOSUM62, jba.Gaps(-11, -1), request.param,
                          batch=128, seq_cap=300)
    assert al._adaptive
    return request.param, pairs, al.align_batch(pairs), al.seq_capacity


def test_adaptive_batch_aligner_matches_jax(jax_adaptive):
    """align_batch, align_all over several batches (sorted and not) and a
    staged batch run twice give the JAX package's results in order;
    ``last_suspect`` stays unset, as the JAX package leaves it there."""
    size, pairs, want, want_cap = jax_adaptive
    al = port_aligner(64, size, 300)
    assert al.route == "adaptive" and al.seq_capacity == want_cap
    assert fields(al.align_batch(pairs)) == fields(want)
    al = port_aligner(8, size, 300)
    assert fields(al.align_all(pairs)) == fields(want)
    assert fields(al.align_all(pairs, sort=False)) == fields(want)
    staged = al.stage(pairs[-8:])
    for _ in range(2):
        assert fields(al.align_staged(staged)) == fields(want[-8:])
    assert al.last_suspect is None


def test_default_size_is_adaptive_and_runs():
    """``BatchAligner(BLOSUM62, Gaps(-11, -1))``, the package's default
    size (32, 256), takes the adaptive route and gives the oracle's
    scores."""
    al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), device="cpu")
    assert al.route == "adaptive"
    assert (al.cfg.min_size, al.cfg.max_size) == (32, 256)
    pairs = homolog_pairs(29, 8)
    orc = jba.BlockOracle()
    for (q, r), got in zip(pairs, al.align_batch(pairs)):
        orc.align(jba.PaddedBytes.from_bytes(q, 256, jba.BLOSUM62),
                  jba.PaddedBytes.from_bytes(r, 256, jba.BLOSUM62),
                  jba.BLOSUM62, jba.Gaps(-11, -1), (32, 256), 0)
        assert (got.score, got.query_idx, got.reference_idx) == (
            orc.res().score, len(q), len(r))


def oracle_exp_all(pairs, targets, size, x_drop=None):
    """The JAX package's ``align_exp_all`` (block_aligner_tpu/api.py), one
    pair at a time through ``BlockOracle``: each pair retries with a
    doubled min size until its score reaches its target or the min size
    passes the max; the results and the min sizes that reached them (None
    past the last level, whose result stays)."""
    lo, hi = size
    orc = jba.BlockOracle(x_drop=x_drop is not None)
    results, mins = [], []
    for (q, r), target in zip(pairs, targets):
        cur, got, reached = max(lo, 16), None, None
        while cur <= hi:
            orc.align(jba.PaddedBytes.from_bytes(q, hi, jba.BLOSUM62),
                      jba.PaddedBytes.from_bytes(r, hi, jba.BLOSUM62),
                      jba.BLOSUM62, jba.Gaps(-11, -1), (cur, hi), x_drop or 0)
            got = orc.res()
            if got.score >= target:
                reached = cur
                break
            cur *= 2
        results.append(got)
        mins.append(reached)
    return results, mins


def test_align_exp_all_matches_jax():
    """The retry ladder 16, 32 (adaptive) and 64 (lane) with the exact
    global scores as targets: the same results and min sizes as the JAX
    package's ladder, run here through BlockOracle, including pairs that
    never reach their target."""
    pairs = [(q[:90], r[:90]) for q, r in homolog_pairs(37, 24)]
    targets = [global_align_score(q, r, jba.BLOSUM62, jba.Gaps(-11, -1))
               for q, r in pairs]
    targets[5] += 1  # unreachable
    want, want_min = oracle_exp_all(pairs, targets, (16, 64))
    got, got_min = tba.align_exp_all(tba.BLOSUM62, tba.Gaps(-11, -1), pairs,
                                     targets, (16, 64), batch=16, seq_cap=128,
                                     device="cpu")
    assert got_min == want_min
    assert fields(got) == fields(want)
    assert got_min.count(None) == 1 and {16, 32, 64} <= set(got_min)


def test_invalid_input_raises():
    with pytest.raises(ValueError):
        tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-1, -11), (32, 32), device="cpu")
    al = port_aligner(2)
    with pytest.raises(ValueError, match="batch_size"):
        al.align_batch([(b"A", b"A")] * 3)
    with pytest.raises(ValueError, match="too long"):
        al.align_batch([(b"A" * (al.seq_capacity + 1), b"A")])
    assert al.align_batch([(b"A" * al.seq_capacity, b"A")])[0].query_idx == \
        al.seq_capacity
