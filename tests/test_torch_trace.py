"""Trace mode of the port against the JAX package: the walker on the scalar
oracle's own rects, the plain versions of both kernels in trace mode
against ``BlockOracle(trace=True)`` (CIGARs, and the adaptive rect list),
``BatchAligner(trace=True)`` on both routes against the JAX package's, and
the batch walker ``Trace.cigars_all`` against the per-pair walk.  Every
comparison is exact: CIGARs are equal as strings.  The CUDA kernels run
only on the card (``chip_smoke.py``); ``test_torch_kernel_sources.py``
holds their sources' trace output against these plain versions here."""

import os

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
import chip_smoke
from block_aligner_tpu_torch.core.traceback import F_RESTORE, Trace, cigar_walk
from block_aligner_tpu_torch.ops import adaptive_kernel as ak
from block_aligner_tpu_torch.ops import lane_kernel as lk
from test_adaptive_kernel import mutate as ad_mutate
from test_adaptive_kernel import rand_seq as ad_rand_seq
from test_lane_kernel import AA, mutate, rand_seq
from test_torch_adaptive_kernel import protein_pairs

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PROTEIN = (jba.BLOSUM62, jba.Gaps(-11, -1))


def lane_trace_pairs(seed, unrelated):
    """The pairs of the JAX package's lane trace tests
    (tests/test_lane_kernel.py): the README pair and edge cases, then
    mutated copies of length 10..120 and, with ``unrelated``, about every
    other pair unrelated (which x-drop ends early)."""
    rng = np.random.default_rng(seed)
    pairs = [(b"CAGGATTAGCGGATCACG", b"CTGGAGTCTTTTAGCGGATCACGC"),
             (b"AAAA", b"AARA"), (b"A", b"A"), (b"", b""), (b"", b"AC"),
             (b"ACD", b"")]
    for _ in range(12):
        n = int(rng.integers(10, 120))
        q = rand_seq(rng, AA, n)
        if unrelated and rng.integers(0, 2):
            pairs.append((q, rand_seq(rng, AA, n)))
        else:
            pairs.append((q, mutate(rng, q, n // 4, AA)))
    return pairs


def indel_pairs(seed):
    """The pairs of the JAX package's adaptive trace test
    (tests/test_adaptive_kernel.py::test_adaptive_trace_cigars): point
    mutations, then indel-heavy pairs whose blocks grow and restore."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(5):
        q = ad_rand_seq(rng, int(rng.integers(20, 70)))
        pairs.append((q, ad_mutate(rng, q, 5)))
    for _ in range(5):
        q = ad_rand_seq(rng, int(rng.integers(30, 70)))
        pairs.append((q, ad_mutate(rng, q, 12, indel=1)))
    return pairs


def grown_pairs():
    """Two protein pairs whose adaptive blocks grow to 512 rows: 300
    residues inserted into a 560-residue reference, which the alignment
    crosses, and 450 into a 540-residue one, where x-drop 50 ends the
    alignment after the block grew."""
    rng = np.random.default_rng(5)
    return (chip_smoke.grow_to_512_pairs(rng, 1, 560, 300)
            + chip_smoke.grow_to_512_pairs(rng, 1, 540, 450))


def cap_for(pairs, S):
    maxlen = max(max(len(q), len(r)) for q, r in pairs)
    return max(256, -(-(1 + maxlen + S + 16) // 128) * 128)


def plain_trace(pairs, size, x=None, matrix=jba.BLOSUM62, gaps=PROTEIN[1]):
    """The plain version's trace of ``pairs``: (out, Trace, ends)."""
    lo, hi = size
    kw = dict(x_drop=x is not None, trace=True)
    alpha = 32 if matrix.kind != "nuc" else 16
    if lo == hi:
        cfg = lk.LaneKernelConfig(hi, cap_for(pairs, hi), alpha, **kw)
        plain = lk.lane_align_plain
    else:
        cfg = ak.AdaptiveKernelConfig(lo, hi, cap_for(pairs, hi), alpha, **kw)
        plain = ak.adaptive_align_plain
    pm = tba.matrix_from_jax(matrix)
    pk = lk.pack_lane(pairs, pm, cfg, tba.gaps_from_jax(gaps), "cpu",
                      x_drop=x or 0)
    out, words, desc, steps = plain(*pk, cfg)
    tr = Trace(words.numpy(), desc.numpy(), steps.numpy(), pm)
    if x is None:
        ends = [(len(q), len(r)) for q, r in pairs]
    else:
        ends = [(int(o[1]), int(o[2])) for o in out]
    return out, tr, ends


def oracle_runs(pairs, size, x=None, matrix=jba.BLOSUM62, gaps=PROTEIN[1]):
    """``BlockOracle(trace=True)`` on each pair: yields (result, oracle)."""
    orc = jba.BlockOracle(trace=True, x_drop=x is not None)
    for q, r in pairs:
        orc.align(jba.PaddedBytes.from_bytes(q, size[1], matrix),
                  jba.PaddedBytes.from_bytes(r, size[1], matrix), matrix,
                  gaps, size, x or 0)
        yield orc.res(), orc


def check_against_oracle(pairs, size, x=None, **kw):
    """Scores, ends, CIGARs and =/X CIGARs of the plain version's trace
    equal the oracle's; the batch walk equals the per-pair walk.  Returns
    the Trace and the end positions."""
    out, tr, ends = plain_trace(pairs, size, x, **kw)
    for k, (res, orc) in enumerate(oracle_runs(pairs, size, x, **kw)):
        i, j = ends[k]
        assert (int(out[k, 0]), i, j) == (
            res.score, res.query_idx, res.reference_idx), (k, pairs[k])
        want = str(orc.cigar(i, j))
        assert str(tr.cigar(k, i, j)) == want, (k, pairs[k])
        matrix = kw.get("matrix", jba.BLOSUM62)
        pq, pr = (jba.PaddedBytes.from_bytes(s, size[1], matrix)
                  for s in pairs[k])
        assert str(tr.cigar_eq(k, *pairs[k], i, j)) == str(
            orc.cigar_eq(pq, pr, i, j)), k
    got = tr.cigars_all(ends)
    got_eq = tr.cigars_all(ends, eq=True, seqs=pairs)
    for k, (i, j) in enumerate(ends):
        assert str(got[k]) == str(tr.cigar(k, i, j)), k
        assert str(got_eq[k]) == str(tr.cigar_eq(k, *pairs[k], i, j)), k
    return tr, ends


@pytest.mark.parametrize("size,x", [((16, 16), None), ((16, 32), None),
                                    ((16, 64), 50)],
                         ids=["lane", "adaptive", "adaptive-x-drop"])
def test_cigar_walk_on_oracle_rects(size, x):
    """The port's copy of the walker, on the oracle's own rect records,
    gives the oracle's CIGAR, with and without =/X."""
    pairs = indel_pairs(71)[:6]
    for k, (res, orc) in enumerate(oracle_runs(pairs, size, x)):
        i, j = res.query_idx, res.reference_idx
        assert str(cigar_walk(orc._rects, i, j)) == str(orc.cigar(i, j)), k
        pq, pr = (jba.PaddedBytes.from_bytes(s, size[1], jba.BLOSUM62)
                  for s in pairs[k])
        assert str(cigar_walk(orc._rects, i, j, eq=True, q=pq, r=pr)) == str(
            orc.cigar_eq(pq, pr, i, j)), k


@pytest.mark.parametrize("S,x", [(16, None), (32, None), (16, 50), (32, 50)],
                         ids=["16", "32", "16-x-drop", "32-x-drop"])
def test_lane_plain_trace_matches_oracle(S, x):
    pairs = lane_trace_pairs(61 if x is None else 67, x is not None)
    check_against_oracle(pairs, (S, S), x)


def test_lane_plain_trace_on_dna():
    """A nucleotide table (codes fold to 4 bits) and a larger block."""
    rng = np.random.default_rng(73)
    pairs = [(rand_seq(rng, b"ACGT", n), b"") for n in (0, 5)]
    for _ in range(6):
        q = rand_seq(rng, b"ACGT", int(rng.integers(20, 150)))
        pairs.append((q, mutate(rng, q, len(q) // 6, b"ACGT")))
    check_against_oracle(pairs, (64, 64),
                         matrix=jba.NucMatrix.new_simple(2, -4),
                         gaps=jba.Gaps(-6, -2))


@pytest.mark.parametrize("size,x", [((16, 32), None), ((32, 512), None),
                                    ((16, 64), 50), ((32, 512), 50)],
                         ids=["16-32", "32-512", "16-64-x-drop",
                              "32-512-x-drop"])
def test_adaptive_plain_trace_matches_oracle(size, x):
    """Indel-heavy pairs that grow and restore, with the checkpoint events
    in the trace; at (32, 512) the S = 512 width of the trace mode, with two
    pairs whose blocks grow to 512 rows (with x-drop, one ends after it)."""
    if size == (32, 512):
        pairs = grown_pairs() + [(q[:150], r[:150])
                                 for q, r in protein_pairs(7, 6)]
    elif x is None:
        pairs = indel_pairs(67) + [(b"", b""), (b"A", b""), (b"", b"ACD")]
    else:
        pairs = [(q[:100], r[:100]) for q, r in protein_pairs(5, 10)]
    tr, ends = check_against_oracle(pairs, size, x)
    ran = np.arange(tr.desc.shape[0])[:, None] < tr.steps
    fl = np.where(ran, tr.desc[:, :, 0], 0)
    assert ((fl & F_RESTORE) != 0).sum() > 0  # some grow restarted
    if size == (32, 512):
        assert (np.where(ran, tr.desc[:, :, 3], 0)[:, :2].max(0) == 512).all()
        full = [(len(q), len(r)) for q, r in pairs[:2]]
        assert ends[0] == full[0]
        assert (ends[1] == full[1]) == (x is None)  # x-drop ends it early


def test_adaptive_blocks_match_oracle():
    """``blocks()`` lists the oracle's computed rects, without the
    reference's initial zero-area grow half (the JAX package's test
    tests/test_adaptive_kernel.py::test_adaptive_trace_blocks_telemetry)."""
    rng = np.random.default_rng(9)
    pairs = []
    for _ in range(5):
        q = ad_rand_seq(rng, int(rng.integers(30, 70)))
        pairs.append((q, ad_mutate(rng, q, 8)))
    pairs += indel_pairs(67)[5:]
    _, tr, _ = plain_trace(pairs, (16, 32))
    for k, (_, orc) in enumerate(oracle_runs(pairs, (16, 32))):
        want = [(b.row, b.col, b.width, b.height)
                for b in orc.trace_blocks() if b.width * b.height > 0]
        assert [tuple(b) for b in tr.blocks(k)] == want, k


@pytest.mark.parametrize("size", [(16, 16), (16, 32)],
                         ids=["lane", "adaptive"])
def test_garbage_past_each_pair_is_ignored(size):
    """Pairs that end at very different step counts: the rows past each
    pair's own count (which the kernels never write) may hold anything,
    here forged restores and random words, and the CIGARs do not change."""
    rng = np.random.default_rng(83)
    pairs = []
    for n in (8, 12, 150, 180, 10, 160):
        q = rand_seq(rng, AA, n)
        pairs.append((q, mutate(rng, q, max(1, n // 6), AA)))
    _, tr, ends = plain_trace(pairs, size)
    assert tr.steps.max() > 4 * tr.steps.min()
    words, desc = tr.words.copy(), tr.desc.copy()
    past = np.arange(desc.shape[0])[:, None] >= tr.steps[None, :]
    desc[past] = F_RESTORE | 2
    words[past] = rng.integers(-2**31, 2**31, size=words[past].shape)
    poisoned = Trace(words, desc, tr.steps, tr.matrix)
    want = [str(c) for c in tr.cigars_all(ends)]
    assert [str(c) for c in poisoned.cigars_all(ends)] == want
    assert [str(poisoned.cigar(k, i, j))
            for k, (i, j) in enumerate(ends)] == want


@pytest.mark.parametrize("cut", ["steps", "height"])
def test_walks_outside_the_trace_raise(cut):
    """A walk that reaches a cell its rect never computed (past the pair's
    executed steps, or below the rect's height) raises in the per-pair walk
    and in the batch walk alike, where the other pairs are sound."""
    pairs = indel_pairs(67)[5:8]
    _, tr, ends = plain_trace(pairs, (16, 32))
    steps, desc = tr.steps.copy(), tr.desc.copy()
    if cut == "steps":
        steps[1] -= 2
    else:
        desc[:, 1, 3] = 8
    forged = Trace(tr.words, desc, steps, tr.matrix)
    for k in (0, 2):
        assert str(forged.cigar(k, *ends[k])) == str(tr.cigar(k, *ends[k]))
    with pytest.raises(IndexError):
        forged.cigar(1, *ends[1])
    with pytest.raises(RuntimeError, match=r"pairs \[1\] reached a cell"):
        forged.cigars_all(ends)


@pytest.fixture(scope="module", params=[(32, 32), (16, 32)],
                ids=["lane", "adaptive"])
def jax_traced(request):
    """Pairs through the JAX BatchAligner(trace=True): results, CIGARs and
    =/X CIGARs, in one small interpret-mode configuration per route."""
    size = request.param
    pairs = lane_trace_pairs(67, True)[:10] + indel_pairs(79)[5:]
    if size[0] == size[1]:
        pairs = [(q[:90], r[:90]) for q, r in pairs]
    al = jba.BatchAligner(*PROTEIN, size, batch=128, seq_cap=128, trace=True)
    res = al.align_batch(pairs)
    cig = [str(al.cigar(k, r.query_idx, r.reference_idx))
           for k, r in enumerate(res)]
    cig_eq = [str(al.cigar_eq(k, q, p, r.query_idx, r.reference_idx))
              for k, ((q, p), r) in enumerate(zip(pairs, res))]
    return size, pairs, res, cig, cig_eq


def fields(results):
    return [(r.score, r.query_idx, r.reference_idx) for r in results]


def test_batch_aligner_trace_matches_jax(jax_traced):
    """align_batch with cigar, cigar_eq and trace().cigars_all, and
    align_all_trace over several batches, give the JAX package's results
    and CIGARs; align_all keeps the order and the last batch's trace."""
    size, pairs, want, cig, cig_eq = jax_traced
    al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), size, batch=32,
                          seq_cap=128, trace=True, device="cpu")
    assert al.route == ("lane" if size[0] == size[1] else "adaptive")
    got = al.align_batch(pairs)
    assert fields(got) == fields(want)
    ends = [(r.query_idx, r.reference_idx) for r in got]
    assert [str(al.cigar(k, i, j)) for k, (i, j) in enumerate(ends)] == cig
    assert [str(al.cigar_eq(k, q, r, i, j))
            for k, ((q, r), (i, j)) in enumerate(zip(pairs, ends))] == cig_eq
    assert [str(c) for c in al.trace().cigars_all(ends)] == cig
    al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), size, batch=8,
                          seq_cap=128, trace=True, device="cpu")
    res, cigars = al.align_all_trace(pairs)
    assert fields(res) == fields(want) and [str(c) for c in cigars] == cig
    res, cigars = al.align_all_trace(pairs, eq=True)
    assert [str(c) for c in cigars] == cig_eq
    assert fields(al.align_all(pairs)) == fields(want)
    last = len(pairs) - (len(pairs) - 1) % 8 - 1
    assert str(al.cigar(0, *ends[last])) == cig[last]


def test_x_drop_batch_aligner_trace_matches_oracle():
    """BatchAligner(trace=True, x_drop=50) on both routes: every CIGAR from
    the best position equals the oracle's."""
    pairs = lane_trace_pairs(67, True)[:12]
    for size in ((32, 32), (16, 64)):
        al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), size,
                              batch=16, seq_cap=128, trace=True, x_drop=50,
                              device="cpu")
        res, cigars = al.align_all_trace(pairs)
        assert any((r.query_idx, r.reference_idx) != (len(q), len(p))
                   for r, (q, p) in zip(res, pairs))
        for k, (want, orc) in enumerate(oracle_runs(pairs, size, 50)):
            assert (res[k].score, res[k].query_idx, res[k].reference_idx) == (
                want.score, want.query_idx, want.reference_idx), k
            assert str(cigars[k]) == str(
                orc.cigar(want.query_idx, want.reference_idx)), k


def test_trace_configurations():
    """What trace mode accepts and refuses: adaptive max 512 only with
    trace; staged runs of adaptive trace raise ValueError, as the JAX
    package refuses them; the trace accessors need trace and a batch; the
    wrappers on CPU tensors are the plain versions and count no launch."""
    with pytest.raises(ValueError, match="512 runs with trace only"):
        ak.AdaptiveKernelConfig(32, 512, 1152)
    assert ak.AdaptiveKernelConfig(32, 512, 1152, trace=True).max_steps == 2624
    kw = dict(matrix=tba.BLOSUM62, gaps=tba.Gaps(-11, -1), batch=4,
              seq_cap=64, device="cpu")
    al = tba.BatchAligner(size=(32, 512), trace=True, **kw)
    assert al.route == "adaptive" and al.cfg.max_size == 512
    with pytest.raises(ValueError, match="align_batch"):
        al.stage([(b"A", b"A")])
    with pytest.raises(ValueError, match="align a batch first"):
        al.trace()
    plain = tba.BatchAligner(size=(32, 32), **kw)
    with pytest.raises(ValueError, match="trace=True"):
        plain.align_all_trace([(b"A", b"A")])
    with pytest.raises(ValueError, match="trace=False"):
        plain.trace()
    lane = tba.BatchAligner(size=(32, 32), trace=True, **kw)
    staged = lane.stage([(b"AAAA", b"AARA")])
    assert lane.align_staged(staged)[0].score == 11
    assert str(lane.cigar(0, 4, 4)) == "4M"
    assert str(lane.cigar_eq(0, b"AAAA", b"AARA", 4, 4)) == "2=1X1="
    assert lane.align_all_trace([]) == ([], [])
    pairs = [(b"AAAA", b"AARA"), (b"", b"")]
    for cfg, fn in ((lane.cfg, lk.lane_align),
                    (ak.AdaptiveKernelConfig(16, 32, 256, trace=True),
                     ak.adaptive_align)):
        pk = lk.pack_lane(pairs, tba.BLOSUM62, cfg, tba.Gaps(-11, -1), "cpu")
        counts = (fn.launches, fn.trace_launches, fn.xdrop_trace_launches)
        got = fn(*pk, cfg)
        assert counts == (fn.launches, fn.trace_launches,
                          fn.xdrop_trace_launches)
        plain_fn = lk.lane_align_plain if fn is lk.lane_align \
            else ak.adaptive_align_plain
        want = plain_fn(*pk, cfg)
        assert len(got) == 4 and all(torch.equal(a, b)
                                     for a, b in zip(got, want))
        assert got[1].shape[1:] == (2, cfg.block) and got[2].shape[1:] == (2, 4)
