"""The long-sequence API on the CPU: ``LongBatchAligner``,
``LongAdaptiveAligner`` and ``BatchAligner``'s long routes, run on the
kernels' plain versions, against ``BlockOracle``: the cases of the JAX
package's ``tests/test_long_aligner.py`` at its sizes, seeds and modes,
score, position and CIGAR string exact; one case against the JAX
``LongBatchAligner`` itself; a (256, 16384) band; the sub-batches and
budget retries of a traced long batch; and the walk of x-drop CIGARs from
each result's position."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
from block_aligner_tpu_torch import api
from block_aligner_tpu_torch.convert import (gaps_from_jax, matrix_from_jax,
                                             profile_from_jax)
from block_aligner_tpu_torch.core.traceback import TraceParts
from block_aligner_tpu_torch.ops import _trace
from block_aligner_tpu_torch.ops import big_kernel as bk
from test_long_aligner import _rand_profile, mutate, rand_seq

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

AA = b"ACDEFGHIKLMNPQRSTVWY"
DNA = b"ACGT"
NUC = jba.NucMatrix.new_simple(2, -4)
NUC_GAPS = jba.Gaps(open=-6, extend=-2)
AA_GAPS = jba.Gaps(open=-11, extend=-1)


def homologs(rng, alpha, n, lo, hi, div):
    out = []
    for _ in range(n):
        m = int(rng.integers(lo, hi))
        q = rand_seq(rng, alpha, m)
        out.append((q, mutate(rng, q, m // div, alpha)))
    return out


# the pairs of each JAX case (tests/test_long_aligner.py), by its seed
def global_pairs():
    rng = np.random.default_rng(71)
    pairs = homologs(rng, DNA, 6, 600, 1200, 8)
    return pairs + [(b"ACGT" * 10, b"ACGT" * 10),
                    (rand_seq(rng, DNA, 900), rand_seq(rng, DNA, 700))]


def x_drop_pairs():
    return homologs(np.random.default_rng(72), AA, 5, 500, 1000, 10)


def trace_pairs():
    rng = np.random.default_rng(75)
    return homologs(rng, DNA, 5, 600, 1100, 8) + [(b"ACGT" * 10,
                                                    b"ACGT" * 10)]


def trace_x_drop_pairs():
    return homologs(np.random.default_rng(76), AA, 4, 500, 900, 10)


def profile_pairs(seed, n, lo, hi, div):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        m = int(rng.integers(lo, hi))
        prof, cons = _rand_profile(rng, m, 16)
        q = bytearray(cons)
        for _ in range(m // div):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(list(AA)))
        pairs.append((bytes(q), prof))
    return pairs


def local_pairs(seed):
    return homologs(np.random.default_rng(seed), AA, 6 if seed == 43 else 5,
                    300, 600, 6)


def free_start_pairs():
    rng = np.random.default_rng(53)
    return [(rand_seq(rng, AA, int(rng.integers(200, 400))),
             rand_seq(rng, AA, int(rng.integers(300, 600))))
            for _ in range(5)]


def free_end_pairs():
    rng = np.random.default_rng(59)
    pairs = []
    for _ in range(6):
        r = rand_seq(rng, AA, int(rng.integers(400, 700)))
        pos = int(rng.integers(0, len(r) - 40))
        q = bytearray(r[pos : pos + int(rng.integers(12, 28))])
        for _ in range(3):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(list(AA)))
        pairs.append((bytes(q), r))
    return pairs


def block_512_pairs():
    rng = np.random.default_rng(4)
    pairs = []
    for _ in range(2):
        n = int(rng.integers(2500, 3000))
        r = bytes(rng.choice(list(DNA), size=n).tolist())
        q = bytearray(r)
        for _ in range(n // 10):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(list(DNA)))
        pairs.append((bytes(q), r))
    return pairs


def adaptive_pairs():
    rng = np.random.default_rng(73)
    pairs = homologs(rng, AA, 4, 1500, 2500, 10)
    # an inserted block (grow and checkpoint restore) and a divergent tail
    # (x-drop ends mid-sequence)
    q = rand_seq(rng, AA, 1800)
    pairs.append((q, q[:900] + rand_seq(rng, AA, 300) + q[900:]))
    q = rand_seq(rng, AA, 2000)
    return pairs + [(q, q[:700] + rand_seq(rng, AA, 1300))]


def delegation_pairs():
    return homologs(np.random.default_rng(74), AA, 3, 400, 800, 10)


def oracle_check(got, pairs, matrix, gaps, size, x=None, trace=None,
                 profile=False, **flags):
    """Every result (and with ``trace``, an aligner, every CIGAR walked
    from the result's position) equals ``BlockOracle``'s at ``size``."""
    orc = jba.BlockOracle(trace=trace is not None, x_drop=x is not None,
                          **flags)
    for k, (q, r) in enumerate(pairs):
        pq = jba.PaddedBytes.from_bytes(q, size[1], r if profile else matrix)
        if profile:
            orc.align_profile(pq, r, size, x or 0)
        else:
            orc.align(pq, jba.PaddedBytes.from_bytes(r, size[1], matrix),
                      matrix, gaps, size, x or 0)
        w = orc.res()
        assert (got[k].score, got[k].query_idx, got[k].reference_idx) == (
            w.score, w.query_idx, w.reference_idx), (k, got[k], w)
        if trace is not None:
            i, j = w.query_idx, w.reference_idx
            assert str(trace.cigar(k, i, j)) == str(orc.cigar(i, j)), k


# the thirteen cases of the JAX file: (pairs, LongBatchAligner keywords or
# a LongAdaptiveAligner / BatchAligner size, the oracle's flags)
CASES = {
    "global": (global_pairs, NUC, NUC_GAPS, dict(block=32), {}),
    "x_drop": (x_drop_pairs, jba.BLOSUM62, AA_GAPS,
               dict(block=32, x_drop=100), {}),
    "trace": (trace_pairs, NUC, NUC_GAPS, dict(block=32, trace=True), {}),
    "trace_x_drop": (trace_x_drop_pairs, jba.BLOSUM62, AA_GAPS,
                     dict(block=32, x_drop=100, trace=True), {}),
    "profile": (lambda: profile_pairs(9, 6, 300, 700, 5), None, AA_GAPS,
                dict(block=16, profile=True), {}),
    "profile_trace": (lambda: profile_pairs(31, 4, 300, 500, 6), None,
                      AA_GAPS, dict(block=16, profile=True, trace=True), {}),
    "local_start": (lambda: local_pairs(43), jba.BLOSUM62, AA_GAPS,
                    dict(block=16, x_drop=100, local_start=True),
                    dict(local_start=True)),
    "local_start_trace": (lambda: local_pairs(47), jba.BLOSUM62, AA_GAPS,
                          dict(block=16, x_drop=100, local_start=True,
                               trace=True), dict(local_start=True)),
    "free_start_trace": (free_start_pairs, jba.BLOSUM62, AA_GAPS,
                         dict(block=16, free_query_start_gaps=True,
                              trace=True),
                         dict(free_query_start_gaps=True)),
    "free_end": (free_end_pairs, jba.BLOSUM62, AA_GAPS,
                 dict(block=32, free_query_start_gaps=True,
                      free_query_end_gaps=True),
                 dict(free_query_start_gaps=True, free_query_end_gaps=True)),
    "block_512": (block_512_pairs, NUC, NUC_GAPS,
                  dict(block=512, trace=True), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_long_batch_aligner_matches_oracle(case):
    """``LongBatchAligner`` on the JAX file's cases, past its 256-position
    windows: the lane kernel's plain version on one capacity a batch."""
    make, matrix, gaps, kw, flags = CASES[case]
    pairs = make()
    profile = kw.get("profile", False)
    port_pairs = ([(q, profile_from_jax(p)) for q, p in pairs] if profile
                  else pairs)
    al = tba.LongBatchAligner(matrix_from_jax(matrix or jba.BLOSUM62),
                              gaps_from_jax(gaps), window=256, batch=256,
                              device="cpu", **kw)
    assert al.route == "lane" and al.long
    got = al.align_batch(port_pairs)
    block = kw["block"]
    oracle_check(got, pairs, matrix, gaps, (block, block), kw.get("x_drop"),
                 al if kw.get("trace") else None, profile, **flags)
    # one launch, on the capacity of the longest pair
    longest = max(max(len(q), p.str_len if profile else len(p))
                  for q, p in pairs)
    assert al._pack_cfg(port_pairs).seq_cap == api.round_up(
        1 + longest + block + 16, 128)


def test_long_adaptive_x_drop():
    """``LongAdaptiveAligner`` at (128, 512) with x 100 (JAX
    ``test_long_adaptive_x_drop``): the big kernel's plain version, a pair
    that grows and restores, one that x-drop ends mid-sequence."""
    pairs = adaptive_pairs()
    al = tba.LongAdaptiveAligner(tba.BLOSUM62, tba.Gaps(-11, -1), (128, 512),
                                 window=1152, batch=128, seq_cap=4096,
                                 x_drop=100, device="cpu")
    assert al.route == "big"
    oracle_check(al.align_batch(pairs), pairs, jba.BLOSUM62, AA_GAPS,
                 (128, 512), 100)


@pytest.mark.parametrize("size,route", [((128, 512), "big"),
                                        ((128, 128), "lane")])
def test_batch_aligner_long_delegation(size, route):
    """``BatchAligner`` at a declared capacity of 20 kbp takes the "long"
    route for the adaptive x-drop band and "long_lane" for a fixed block
    (JAX ``test_batch_aligner_over_budget_delegation``), with the long
    classes' capacities, and refuses ``stage``."""
    pairs = delegation_pairs()
    x = 100 if route == "big" else None
    ba = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), size=size,
                          batch=128, seq_cap=20000, x_drop=x, device="cpu")
    assert ba.long and ba.route == route
    inner = (tba.LongAdaptiveAligner(tba.BLOSUM62, tba.Gaps(-11, -1), size,
                                     seq_cap=20000, device="cpu")
             if route == "big" else
             tba.LongBatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), size[0],
                                  device="cpu"))
    # the JAX capacities (JAX api.py:458-470)
    assert ba.seq_capacity == inner.seq_capacity == (
        (1 << 20) if route == "lane" else
        api.round_up(1 + 20000 + 512 + 16, 128) - 512 - 17)
    oracle_check(ba.align_batch(pairs), pairs, jba.BLOSUM62, AA_GAPS, size,
                 x)
    with pytest.raises(ValueError, match="long routes"):
        ba.stage(pairs)


def test_long_batch_aligner_matches_jax():
    """The JAX ``LongBatchAligner`` itself (block 32, window 256, global:
    JAX ``test_long_segmented_global``, its segments in interpret mode)
    and the port's give the same results."""
    pairs = global_pairs()
    jal = jba.LongBatchAligner(NUC, NUC_GAPS, block=32, window=256,
                               batch=256)
    want = jal.align_batch(pairs)
    al = tba.LongBatchAligner(matrix_from_jax(NUC), gaps_from_jax(NUC_GAPS),
                              block=32, window=256, device="cpu")
    got = al.align_batch(pairs)
    assert [(g.score, g.query_idx, g.reference_idx) for g in got] == [
        (w.score, w.query_idx, w.reference_idx) for w in want]


def test_long_adaptive_16384_band():
    """(256, 16384), ``percent_len``'s clamp, on three short pairs, one
    whose block grows (an insertion): the big kernel's 16384-row
    configuration through ``LongAdaptiveAligner`` against
    ``BlockOracle``."""
    rng = np.random.default_rng(16384)
    q = rand_seq(rng, AA, 400)
    pairs = [(q, q[:200] + rand_seq(rng, AA, 350) + q[200:]),
             (b"ACDEFGHIKL" * 20, b"ACDEFGHIKL" * 19), (b"W", b"")]
    al = tba.LongAdaptiveAligner(tba.BLOSUM62, tba.Gaps(-11, -1),
                                 (256, 16384), device="cpu")
    assert al.route == "big" and al.cfg.max_size == 16384
    oracle_check(al.align_batch(pairs), pairs, jba.BLOSUM62, AA_GAPS,
                 (256, 16384))
    cfg = al._pack_cfg(pairs)
    pk = bk.pack_big(pairs, al.matrix, cfg, al.gaps, "cpu")
    assert bk.big_align_plain(*pk, cfg, top_size=True)[-1].tolist() == [
        512, 256, 256]


def test_traced_long_batch_in_parts(monkeypatch):
    """A traced long batch whose trace buffers pass the launch's byte
    budget runs in sub-batches, and a pair whose trace passes its word
    budget runs again with four times it: results and CIGARs equal
    ``BlockOracle``'s, through ``TraceParts``, ``align_all_trace`` and
    ``cigar``; the first budget is the longest walk's unless the
    configuration sets one, and the retries stop at the int32 word limit;
    the lane route in parts too."""
    rng = np.random.default_rng(77)
    pairs = homologs(rng, DNA, 3, 150, 300, 8)
    q = rand_seq(rng, DNA, 300)
    pairs.append((q, q[:150] + rand_seq(rng, DNA, 200) + q[150:]))
    monkeypatch.setattr(_trace, "LAUNCH_TRACE_BYTES", 1)
    al = tba.BatchAligner(tba.NucMatrix.new_simple(2, -4), tba.Gaps(-6, -2),
                          (128, 1024), seq_cap=20000, trace=True,
                          device="cpu")
    assert al.long and al.route == "big"
    staged = al._pack(pairs)
    cfg = al._staged_cfg(staged)
    walk = max(len(q) + len(r) for q, r in pairs)
    assert al._trace_cfg(staged).trace_budget == cfg.walk_budget(walk) < (
        cfg.trace_budget)
    al.cfg = dataclasses.replace(al.cfg, budget=3000)
    assert al._trace_cfg(staged).trace_budget == 3000
    got, cigars = al.align_all_trace(pairs)
    assert isinstance(al.trace(), TraceParts)
    oracle_check(got, pairs, NUC, NUC_GAPS, (128, 1024), trace=al)
    assert [str(c) for c in cigars] == [
        str(al.cigar(k, g.query_idx, g.reference_idx))
        for k, g in enumerate(got)]
    # the retries stop at the kernel's int32 word limit (here lowered)
    monkeypatch.setattr(bk, "MAX_TRACE_WORDS", 4000)
    monkeypatch.setattr(api, "MAX_TRACE_WORDS", 4000)
    with pytest.raises(RuntimeError, match="int32"):
        al.align_batch(pairs)
    lane = tba.LongBatchAligner(tba.NucMatrix.new_simple(2, -4),
                                tba.Gaps(-6, -2), 64, trace=True,
                                device="cpu")
    oracle_check(lane.align_batch(pairs), pairs, NUC, NUC_GAPS, (64, 64),
                 trace=lane)


def test_x_drop_cigars_walk_from_the_best():
    """``align_all_trace`` on a long route in x-drop mode walks each CIGAR
    from its result's position, as ``BlockOracle``'s is taken; the JAX
    package's long branch walks from the pairs' ends (JAX ``api.py:668``),
    which for the seed-76 pair whose best lies short of its end is not
    ``BlockOracle``'s CIGAR (ROADMAP queue 3)."""
    pairs = trace_x_drop_pairs()
    rng = np.random.default_rng(76)
    q = rand_seq(rng, AA, 600)
    pairs.append((q, q[:300] + rand_seq(rng, AA, 500)))
    al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), (32, 32),
                          seq_cap=20000, x_drop=100, trace=True, device="cpu")
    got, cigars = al.align_all_trace(pairs)
    orc = jba.BlockOracle(trace=True, x_drop=True)
    short = 0
    for k, (q, r) in enumerate(pairs):
        orc.align(jba.PaddedBytes.from_bytes(q, 32, jba.BLOSUM62),
                  jba.PaddedBytes.from_bytes(r, 32, jba.BLOSUM62),
                  jba.BLOSUM62, AA_GAPS, (32, 32), 100)
        w = orc.res()
        assert (got[k].score, got[k].query_idx, got[k].reference_idx) == (
            w.score, w.query_idx, w.reference_idx), k
        assert str(cigars[k]) == str(orc.cigar(w.query_idx, w.reference_idx))
        if (w.query_idx, w.reference_idx) != (len(q), len(r)):
            short += 1
            try:
                ends = str(orc.cigar(len(q), len(r)))
            except (IndexError, AssertionError):
                ends = None
            assert ends != str(cigars[k]), k
    assert short >= 1
