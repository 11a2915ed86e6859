"""The local-start, free-query-start-gap and free-query-end-gap flags in the
port against the JAX package: both kernels' plain versions against
``BlockOracle`` with the same flags (global, x-drop where the flag allows
it, and trace; sequence pairs and ``align_profile``; adaptive blocks that
grow), ``BatchAligner`` and ``ProfileAligner`` against the JAX aligners on
one configuration per flag, the CIGAR checks of ``chip_smoke.py`` on flag
CIGARs, and the rejections.  Every comparison is exact: results equal,
CIGARs equal as strings.  The CUDA kernels run only on the card
(``chip_smoke.py``); ``test_torch_kernel_sources.py`` holds their flags
instances against these plain versions here."""

import os

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
import chip_smoke
from block_aligner_tpu_torch.core.traceback import Trace
from block_aligner_tpu_torch.ops import adaptive_kernel as ak
from block_aligner_tpu_torch.ops import lane_kernel as lk
from block_aligner_tpu_torch.ops._profile import pack_profile
from test_torch_profile import grow_pairs, to_jax
from test_torch_trace import check_against_oracle

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PROTEIN = (jba.BLOSUM62, jba.Gaps(-11, -1))
LOCAL = dict(local_start=True)
FSTART = dict(free_query_start_gaps=True)
FEND = dict(free_query_end_gaps=True)


def seq_pairs(seed, n, max_len, short=None):
    """``chip_smoke.structural_pairs`` (half related, a few with inserted
    or deleted blocks that make adaptive blocks grow); with ``short`` the
    queries are cut to fewer residues, for free end gaps."""
    pairs = chip_smoke.structural_pairs(np.random.default_rng(seed),
                                        chip_smoke.AA, n, max_len)
    return pairs if short is None else [(q[:short], r) for q, r in pairs]


def fields(results):
    return [(r.score, r.query_idx, r.reference_idx) for r in results]


def oracle_results(pairs, size, flags, x=None):
    orc = jba.BlockOracle(x_drop=x is not None, **flags)
    for q, r in pairs:
        orc.align(jba.PaddedBytes.from_bytes(q, size[1], PROTEIN[0]),
                  jba.PaddedBytes.from_bytes(r, size[1], PROTEIN[0]),
                  *PROTEIN, size, x or 0)
        yield orc.res()


CASES = [("local", LOCAL, None), ("local-x-drop", LOCAL, 30),
         ("free-start", FSTART, None), ("free-start-x-drop", FSTART, 30),
         ("free-end", FEND, None)]


@pytest.mark.parametrize("size", [(16, 16), (32, 32), (16, 64)],
                         ids=["16", "32", "16-64"])
@pytest.mark.parametrize("name,flags,x", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_oracle(size, name, flags, x):
    """Results of both plain versions (through ``BatchAligner`` on the CPU)
    equal ``BlockOracle``'s; free end gaps take queries shorter than the
    min size."""
    short = size[0] - 1 if flags is FEND else None
    pairs = seq_pairs(size[1] + len(name), 14, 140, short)
    al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), size,
                          batch=len(pairs), seq_cap=160, x_drop=x,
                          device="cpu", **flags)
    got = al.align_batch(pairs)
    assert fields(got) == fields(oracle_results(pairs, size, flags, x))


TRACE_CASES = [("local", LOCAL, None), ("local-x-drop", LOCAL, 30),
               ("free-start", FSTART, None), ("free-end", FEND, None)]


@pytest.mark.parametrize("size", [(16, 16), (16, 64)],
                         ids=["lane", "adaptive"])
@pytest.mark.parametrize("name,flags,x", TRACE_CASES,
                         ids=[c[0] for c in TRACE_CASES])
def test_plain_trace_matches_oracle(size, name, flags, x):
    """CIGARs (local start's zero bits and free start gaps' row-0 stop
    included), =/X CIGARs and the batch walk equal
    ``BlockOracle(trace=True)``'s; the adaptive pairs grow and restore."""
    short = size[0] - 1 if flags is FEND else None
    pairs = seq_pairs(3 * size[1] + len(name), 12, 120, short)
    tr, _ = check_against_oracle(pairs, size, x, flags=flags)
    assert tr.words.shape[2] == size[1] * (2 if flags is LOCAL else 1)


def profile_oracle(pairs, size, flags, x=None, trace=False):
    """BlockOracle.align_profile on each pair: (result fields, oracle)."""
    orc = jba.BlockOracle(x_drop=x is not None, trace=trace, **flags)
    for q, p in pairs:
        jp = to_jax(p)
        orc.align_profile(jba.PaddedBytes.from_bytes(q, size[1], jp), jp,
                          size, x or 0)
        r = orc.res()
        yield (r.score, r.query_idx, r.reference_idx), orc


@pytest.mark.parametrize("size", [(16, 16), (16, 64)],
                         ids=["lane", "adaptive"])
@pytest.mark.parametrize("name,flags,x", TRACE_CASES,
                         ids=[c[0] for c in TRACE_CASES])
def test_profile_plain_matches_oracle(size, name, flags, x):
    """Both plain versions in profile mode, traced, against
    ``BlockOracle.align_profile``: results and CIGARs (the adaptive pairs'
    profiles carry inserted or deleted blocks, and blocks grow)."""
    lo, hi = size
    pairs = grow_pairs(hi + len(name), 10, 120)
    if flags is FEND:
        pairs = [(q[: lo - 1], p) for q, p in pairs]
    kw = dict(x_drop=x is not None, trace=True, profile=True, **flags)
    cfg = (lk.LaneKernelConfig(hi, 384, **kw) if lo == hi
           else ak.AdaptiveKernelConfig(lo, hi, 384, **kw))
    plain = lk.lane_align_plain if lo == hi else ak.adaptive_align_plain
    out, words, desc, steps = plain(*pack_profile(pairs, cfg, "cpu",
                                                  x_drop=x or 0), cfg)
    tr = Trace(words.numpy(), desc.numpy(), steps.numpy(),
               **chip_smoke.trace_flags(cfg))
    ends = []
    for k, (want, orc) in enumerate(profile_oracle(pairs, size, flags, x,
                                                   True)):
        got = (tuple(int(v) for v in out[k, :3]) if lk.wide(cfg)
               else (int(out[k, 0]), len(pairs[k][0]), pairs[k][1].str_len))
        assert got == want, k
        ends.append(want[1:])
        assert str(tr.cigar(k, *want[1:])) == str(orc.cigar(*want[1:])), k
    assert [str(c) for c in tr.cigars_all(ends)] == [
        str(tr.cigar(k, *e)) for k, e in enumerate(ends)]


@pytest.fixture(scope="module", params=[
    ("BatchAligner", (16, 32), LOCAL), ("ProfileAligner", (16, 16), FSTART),
    ("BatchAligner", (32, 32), FEND)],
    ids=["batch-local-adaptive", "profile-free-start-lane",
         "batch-free-end-lane"])
def jax_flags(request):
    """The JAX aligners (kernels in interpret mode) with one flag each, in
    trace mode: results and CIGARs."""
    kind, size, flags = request.param
    if kind == "BatchAligner":
        pairs = seq_pairs(41, 16, 90, size[0] - 1 if flags is FEND else None)
        al = jba.BatchAligner(*PROTEIN, size, batch=128, seq_cap=128,
                              trace=True, **flags)
        jpairs = pairs
    else:
        pairs = chip_smoke.profile_pairs(np.random.default_rng(43), 12, 90,
                                         odd=False)
        jpairs = [(q, to_jax(p)) for q, p in pairs]
        al = jba.ProfileAligner(size, batch=128, seq_cap=128, trace=True,
                                **flags)
    res = al.align_batch(jpairs)
    cig = [str(al.cigar(k, r.query_idx, r.reference_idx))
           for k, r in enumerate(res)]
    return kind, size, flags, pairs, res, cig


def test_aligners_match_jax(jax_flags):
    """``BatchAligner`` / ``ProfileAligner`` with the flag, traced and not,
    over one batch and (without trace) several, give the JAX aligner's
    results and CIGARs."""
    kind, size, flags, pairs, want, cig = jax_flags
    if kind == "BatchAligner":
        def make(**kw):
            return tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), size,
                                    seq_cap=128, device="cpu", **flags, **kw)
    else:
        def make(**kw):
            return tba.ProfileAligner(size, seq_cap=128, device="cpu",
                                      **flags, **kw)
    al = make(batch=len(pairs), trace=True)
    got = al.align_batch(pairs)
    assert fields(got) == fields(want)
    ends = [(r.query_idx, r.reference_idx) for r in got]
    assert [str(al.cigar(k, i, j)) for k, (i, j) in enumerate(ends)] == cig
    assert [str(c) for c in al.trace().cigars_all(ends)] == cig
    assert fields(make(batch=5).align_all(pairs)) == fields(want)


@pytest.mark.parametrize("name,flags,x,start", [
    ("local", LOCAL, None, "any"), ("local-x-drop", LOCAL, 30, "any"),
    ("free-start", FSTART, None, "query0"), ("free-end", FEND, None,
                                             "origin")],
    ids=["local", "local-x-drop", "free-start", "free-end"])
def test_chip_smoke_cigar_checks(name, flags, x, start):
    """``chip_smoke.check_cigars``, which holds every CIGAR of the card's
    trace paths to its result, accepts the reference's flag CIGARs: a local
    start's CIGAR begins anywhere, a free start's at query row 0, and each
    rescores to its score (free end gaps: at most, as the result is the
    best of row qlen's residue class)."""
    pairs = seq_pairs(53, 40, 200, 31 if flags is FEND else None)
    al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), (32, 64),
                          batch=16, seq_cap=256, trace=True, x_drop=x,
                          device="cpu", **flags)
    res, cigars = al.align_all_trace(pairs)
    n_ops, below = chip_smoke.check_cigars(
        cigars, pairs, res, al.matrix, al.gaps, name, start,
        at_most=flags is FEND)
    # free end gaps: these pairs hold one whose result is another row's
    assert n_ops > 0 and (below > 0) == (flags is FEND)
    if flags is not FEND:
        # the same CIGARs from (0, 0) would not all span their ends
        with pytest.raises(AssertionError, match="spans"):
            chip_smoke.check_cigars(cigars, pairs, res, al.matrix, al.gaps,
                                    name)


@pytest.mark.parametrize("make,error", [
    (lambda: tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1),
                              device="cpu", **LOCAL, **FSTART), ValueError),
    (lambda: tba.ProfileAligner(device="cpu", **LOCAL, **FSTART),
     AssertionError),
    (lambda: tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), x_drop=10,
                              device="cpu", **FEND), ValueError),
    (lambda: tba.ProfileAligner(x_drop=10, device="cpu", **FEND),
     AssertionError),
    (lambda: tba.BatchAligner(tba.BYTES1, tba.Gaps(-11, -1), x_drop=10,
                              device="cpu", **LOCAL), ValueError),
    (lambda: lk.LaneKernelConfig(16, 256, **LOCAL, **FSTART), ValueError),
    (lambda: ak.AdaptiveKernelConfig(16, 64, 256, x_drop=True, **FEND),
     ValueError),
], ids=["local-free-start", "profile-local-free-start", "x-drop-free-end",
        "profile-x-drop-free-end", "byte-x-drop", "lane-config",
        "adaptive-config"])
def test_exclusions(make, error):
    with pytest.raises(error, match="exclude|ByteMatrix|x-drop"):
        make()


@pytest.mark.parametrize("size", [(32, 32), (32, 256)],
                         ids=["lane", "adaptive"])
def test_free_end_needs_short_queries(size):
    """Free end gaps need every query shorter than the min block size, in
    align_batch, stage and align_all (the reference's requirement)."""
    al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), size, batch=4,
                          device="cpu", **FEND)
    ok, bad = [(b"A" * 31, b"A" * 40)], [(b"A" * 32, b"ACD")]
    assert fields(al.align_batch(ok)) == [(31 * 4, 31, 31)]
    for call in (al.align_batch, al.stage, al.align_all):
        with pytest.raises(ValueError, match="query len"):
            call(bad)
    prof = tba.ProfileAligner(size, batch=4, device="cpu", **FEND)
    p = chip_smoke.profile_pairs(np.random.default_rng(1), 5, 40)[4][1]
    with pytest.raises(AssertionError, match="query len"):
        prof.align_batch([(b"A" * 32, p)])
