"""Trace mode of the big route: ``big_align_plain`` with trace (the block-sized
layout of ``ops/_trace.py``) against ``BlockOracle(trace=True)`` at (64,
1024) and (128, 1024), global and x-drop, with a pair whose blocks grow past
512 rows; the decoder on a dense adaptive trace compacted into that layout;
the trace budget's overrun; and ``BatchAligner((128, 1024), trace=True)``
against the JAX package's (its big kernel in interpret mode).  Every
comparison is exact: CIGARs are equal as strings.  The CUDA kernel runs only
on the card (``chip_smoke.py`` holds it against this plain version;
``test_torch_kernel_sources.py`` runs its source here)."""

import os

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
import chip_smoke
from block_aligner_tpu_torch.core.traceback import Trace
from block_aligner_tpu_torch.ops import big_kernel as bk
from block_aligner_tpu_torch.ops._trace import compact_trace
from test_big_trace import mutate, rand_seq
from test_torch_trace import indel_pairs, plain_trace

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GAPS = jba.Gaps(-11, -1)


def grow_pair():
    """A structural insert, as in JAX ``tests/test_big_trace.py:137``: 560
    random residues in place of 560 others between two 200-residue flanks,
    which the (min, 1024) ladder crosses only by growing to 1024 rows."""
    rng = np.random.default_rng(21)
    a, b, c = rand_seq(rng, 200), rand_seq(rng, 560), rand_seq(rng, 200)
    return a + b + c, a + rand_seq(rng, 560) + c


def small_pairs():
    """Edge cases and homologs with structural indels, under 300 residues."""
    return chip_smoke.structural_pairs(np.random.default_rng(4),
                                       chip_smoke.AA, 7, 300)


def big_trace(pairs, size, x=None, budget=None):
    """``big_align_plain``'s trace of ``pairs`` (BLOSUM62 -11/-1) under
    ``budget`` words a pair: ((out, words, desc, steps, used), Trace)."""
    cfg = bk.BigKernelConfig(*size, 2048, x_drop=x is not None, trace=True)
    if budget:
        cfg = chip_smoke.with_trace_budget(cfg, budget)
    pk = bk.pack_big(pairs, tba.BLOSUM62, cfg, tba.Gaps(-11, -1), "cpu",
                     x or 0)
    res = bk.big_align_plain(*pk, cfg)
    return res, chip_smoke.block_trace(res, tba.BLOSUM62)


@pytest.mark.parametrize("size,x,grow", [
    ((64, 1024), None, True), ((128, 1024), None, False),
    ((64, 1024), 60, False), ((128, 1024), 60, False),
], ids=["64-1024", "128-1024", "64-1024-x60", "128-1024-x60"])
def test_plain_trace_matches_oracle(size, x, grow):
    """Scores, end positions, CIGARs (M and =/X, per pair and in the batch
    walk) and the computed rects equal the oracle's; the structural insert's
    blocks reach 1024 rows."""
    pairs = ([grow_pair()] if grow else []) + small_pairs()
    (out, *_), tr = big_trace(pairs, size, x)
    assert not out[:, -1].any()
    ends = ([(int(o[1]), int(o[2])) for o in out] if x else
            [(len(q), len(r)) for q, r in pairs])
    orc = jba.BlockOracle(trace=True, x_drop=x is not None)
    for k, (q, r) in enumerate(pairs):
        pq, pr = (jba.PaddedBytes.from_bytes(s, 1024, jba.BLOSUM62)
                  for s in (q, r))
        orc.align(pq, pr, jba.BLOSUM62, GAPS, size, x or 0)
        res = orc.res()
        i, j = ends[k]
        assert (int(out[k, 0]), i, j) == (res.score, res.query_idx,
                                          res.reference_idx), k
        assert str(tr.cigar(k, i, j)) == str(orc.cigar(i, j)), k
        assert str(tr.cigar_eq(k, q, r, i, j)) == str(
            orc.cigar_eq(pq, pr, i, j)), k
        # the rects, but the freezing one's extent: the reference lists
        # its full width or height, the kernels the columns they ran
        want = [(b.row, b.col, b.width, b.height)
                for b in orc.trace_blocks() if b.width * b.height > 0]
        got = [tuple(b) for b in tr.blocks(k)]
        assert got[:-1] == want[:-1] and got[-1][:2] == want[-1][:2], k
        if grow and k == 0:
            assert max(max(b.width, b.height)
                       for b in orc.trace_blocks()) == 1024
            assert int(tr.desc[: tr.steps[0], 0, 3].max()) == 1024
    got = tr.cigars_all(ends)
    got_eq = tr.cigars_all(ends, eq=True, seqs=pairs)
    for k, (i, j) in enumerate(ends):
        assert str(got[k]) == str(tr.cigar(k, i, j)), k
        assert str(got_eq[k]) == str(tr.cigar_eq(k, *pairs[k], i, j)), k


def test_compacted_dense_trace_decodes_alike():
    """An adaptive-route dense trace, compacted by ``compact_trace`` into the
    block-sized layout, walks to the same CIGARs and rects: the words of a
    pair's steps are its rects' rows, back to back."""
    pairs = indel_pairs(67)
    _, tr, ends = plain_trace(pairs, (16, 32))
    budget = int((tr.desc[:, :, 3] * (np.arange(tr.desc.shape[0])[:, None]
                                      < tr.steps)).sum(0).max())
    words, desc, used = compact_trace(torch.from_numpy(tr.words),
                                      torch.from_numpy(tr.desc),
                                      torch.from_numpy(tr.steps), budget)
    assert int(used.max()) == budget
    off = np.arange(len(pairs))[None, :] * budget + desc[:, :, 4].numpy()
    ct = Trace(words.numpy(), desc.numpy(), tr.steps, tr.matrix, offsets=off)
    assert [str(c) for c in ct.cigars_all(ends)] == [
        str(c) for c in tr.cigars_all(ends)]
    for k, (i, j) in enumerate(ends):
        assert str(ct.cigar(k, i, j)) == str(tr.cigar(k, i, j)), k
        assert ct.blocks(k) == tr.blocks(k), k


def test_trace_budget_overruns():
    """Under a budget of 1200 words a pair the longer pairs stop with the
    overrun flag at the step their rows would pass it and the short ones
    finish, their CIGARs unchanged; ``BatchAligner`` raises on an overrun,
    as the JAX package asserts (``api.py:782-786``)."""
    pairs = small_pairs()
    full, tr = big_trace(pairs, (64, 1024))
    cut, ctr = big_trace(pairs, (64, 1024), budget=1200)
    over = cut[0][:, -1].numpy().astype(bool)
    assert 0 < over.sum() < len(pairs) and int(cut[4].max()) <= 1200
    for b in np.flatnonzero(over):
        # the same steps and words up to the one whose rows pass the budget
        t = int(cut[3][b])
        assert t < int(full[3][b]) and int(full[2][t, b, 4]) == int(cut[4][b])
        assert int(cut[4][b]) + int(full[2][t, b, 3]) > 1200
    ends = [(len(q), len(r)) for q, r in pairs]
    ok = np.flatnonzero(~over)
    assert torch.equal(cut[0][ok], full[0][ok])
    assert [str(ctr.cigar(k, *ends[k])) for k in ok] == [
        str(tr.cigar(k, *ends[k])) for k in ok]
    al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), (64, 1024),
                          trace=True, seq_cap=300, device="cpu")
    al.cfg = chip_smoke.with_trace_budget(al.cfg, 1200)
    with pytest.raises(RuntimeError, match="trace budget"):
        al.align_batch(pairs)


def test_batch_aligner_matches_jax():
    """The pairs of JAX ``test_big_trace_api_route_past_512`` (a 1360-residue
    structural insert that grows to 1024 rows, and a mutated 600): the
    port's ``BatchAligner((128, 1024), trace=True)`` gives the JAX
    package's results and ``align_all_trace(eq=True)`` CIGARs, through
    ``align_batch``, a staged batch and ``align_all_trace``."""
    rng = np.random.default_rng(21)
    a, b, c = rand_seq(rng, 400), rand_seq(rng, 560), rand_seq(rng, 400)
    pairs = [(a + b + c, a + rand_seq(rng, 560) + c)]
    q = rand_seq(rng, 600)
    pairs.append((q, mutate(rng, q, 50)))
    jal = jba.BatchAligner(jba.BLOSUM62, GAPS, (128, 1024), batch=128,
                           seq_cap=1408, trace=True)
    assert jal._big
    want, want_cig = jal.align_all_trace(pairs, eq=True)
    al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), (128, 1024),
                          batch=2, seq_cap=1408, trace=True, device="cpu")
    assert al.route == "big" and al.cfg.trace
    fields = [(r.score, r.query_idx, r.reference_idx) for r in want]
    got = al.align_staged(al.stage(pairs))
    assert [(r.score, r.query_idx, r.reference_idx) for r in got] == fields
    assert int(al.trace().desc[:, 0, 3].max()) == 1024
    res, cig = al.align_all_trace(pairs, eq=True)
    assert [(r.score, r.query_idx, r.reference_idx) for r in res] == fields
    assert [str(c) for c in cig] == [str(c) for c in want_cig]
    assert str(al.cigar(1, 600, 600)) == str(
        al.trace().cigar(1, 600, 600))
