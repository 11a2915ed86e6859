"""Sequence-to-PSSM profile mode of the port against the JAX package: the
port's ``AAProfile`` and packer against the JAX ones, the plain versions of
both kernels in profile mode against ``BlockOracle.align_profile`` (global,
x-drop and trace, CIGARs equal as strings), ``ProfileAligner`` on both
routes against the JAX ``ProfileAligner`` (its kernels in interpret mode),
``align_profile_exp_all`` against a ``BlockOracle`` retry ladder, and the
rejections.  Every comparison is exact: the tolerance is 0.  The CUDA
kernels run only on the card (``chip_smoke.py``);
``test_torch_kernel_sources.py`` holds their sources' profile instances
against these plain versions here."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
import chip_smoke
from block_aligner_tpu.ops import lane_kernel as jlane
from block_aligner_tpu_torch.core.traceback import Trace
from block_aligner_tpu_torch.ops import adaptive_kernel as ak
from block_aligner_tpu_torch.ops import big_kernel as bk
from block_aligner_tpu_torch.ops import lane_kernel as lk
from block_aligner_tpu_torch.ops._profile import pack_profile
from examples_tpu.common import load_scop_profiles

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def to_jax(p):
    """The port's AAProfile as the JAX package's, every array copied."""
    jp = jba.AAProfile(p.str_len, p.max_len - p.str_len - 1, p.gap_extend)
    jp.curr_len = p.curr_len
    for name in ("pos_scores", "gap_open_C", "gap_close_C", "gap_open_R"):
        setattr(jp, name, getattr(p, name).copy())
    return jp


def both(pairs):
    """The port's pairs and the same pairs with JAX profiles."""
    return pairs, [(q, None if p is None else to_jax(p)) for q, p in pairs]


def fields(results):
    return [(r.score, r.query_idx, r.reference_idx) for r in results]


def grow_pairs(seed, n, max_len):
    """``chip_smoke.structural_pairs`` with each reference made a BLOSUM62
    profile (varied gap opens, nonzero close costs): half the pairs carry
    inserted or deleted blocks that make adaptive blocks grow."""
    rng = np.random.default_rng(seed)
    return [(q, chip_smoke.blosum_profile(rng, r)) for q, r in
            chip_smoke.structural_pairs(rng, chip_smoke.AA, n, max_len)]


def oracle(jpairs, size, x=None, trace=False):
    """BlockOracle.align_profile on each pair: (result fields, oracle)."""
    orc = jba.BlockOracle(x_drop=x is not None, trace=trace)
    for q, p in jpairs:
        orc.align_profile(jba.PaddedBytes.from_bytes(q, size[1], p), p, size,
                          x or 0)
        r = orc.res()
        yield (r.score, r.query_idx, r.reference_idx), orc


def test_aaprofile_matches_jax():
    """Constructors, setters (the i8 shift scaling of set_all included),
    clear, getters and convert give the JAX profile's arrays."""
    args = (b"MKVLAtgQ", 16, 5, -2, -11, -1, -9, -1)
    t, j = tba.AAProfile.from_bytes(*args), jba.AAProfile.from_bytes(*args)
    rng = np.random.default_rng(1)
    sc = rng.integers(-128, 128, size=(8, 5))
    for p in (t, j):
        p.set_all(b"ACdEW", sc, 1, 2)
        p.set(3, "y", 7)
        p.set_gap_open_C(2, -20)
        p.set_gap_close_C(4, -3)
        p.set_gap_open_R(0, -5)
    names = ("pos_scores", "gap_open_C", "gap_close_C", "gap_open_R")

    def same(t, j):
        assert (t.max_len, t.curr_len, t.str_len, t.get_gap_extend()) == (
            j.max_len, j.curr_len, j.str_len, j.get_gap_extend())
        for name in names:
            assert getattr(t, name).dtype == np.int32
            assert np.array_equal(getattr(t, name), getattr(j, name)), name

    same(t, j)
    assert t.get(3, "Y") == j.get(3, "Y") == 7 and len(t) == t.len() == 8
    for p in (t, j):
        p.set_all_rev(b"ACW", sc[:, :3], 2, 1)
        p.set_all_gap_open_C(-7)
        p.set_all_gap_close_C(-2)
        p.set_all_gap_open_R(-6)
    same(t, j)
    seq = bytes(range(256))
    assert np.array_equal(t.convert(seq), j.convert(seq))
    back = tba.profile_from_jax(j)
    same(back, j)
    back.pos_scores[1, 0] = 99  # a copy
    assert j.pos_scores[1, 0] != 99
    for p in (t, j):
        p.clear(5, 16)
    same(t, j)
    with pytest.raises(AssertionError, match="negative"):
        t.set_gap_open_C(1, 0)


def test_pack_matches_jax_packer():
    """Query codes, lengths and the position-major words equal those of
    the JAX packer (``_pack_profile_host``), batch padding entries,
    empty sequences and query bytes outside A..Z included."""
    pairs = chip_smoke.profile_pairs(np.random.default_rng(3), 30, 90)
    pairs[5] = (b"", None)
    tpairs, jpairs = both(pairs)
    S, cap = 32, 256
    jq, jr, jqc, jwords, ge = jlane._pack_profile_host(
        jpairs, SimpleNamespace(batch=len(pairs), block=S), cap)
    pk = pack_profile(tpairs, lk.LaneKernelConfig(S, cap, profile=True),
                      "cpu", x_drop=7)
    assert np.array_equal(pk.codes.numpy(), jqc.view(np.uint8))
    assert np.array_equal(pk.table.numpy(), jwords.transpose(0, 2, 1))
    assert np.array_equal(pk.qlen.numpy(), jq)
    assert np.array_equal(pk.rlen.numpy(), jr)
    assert pk.gaps == (0, ge, 7)
    assert (pk.codes.numpy() >= 28).any()  # odd query bytes occur


@pytest.mark.parametrize("change,match", [
    (lambda ps: setattr(ps[1][1], "gap_extend", -2), "share gap_extend"),
    (lambda ps: ps.append((b"A", tba.AAProfile(300, 16, -1))),
     "profile too long"),
    (lambda ps: ps.append((b"A" * 300, ps[1][1])), "query too long"),
    (lambda ps: ps[1][1].pos_scores.__setitem__((2, 3), 128),
     "profile score overflow"),
    (lambda ps: ps[1][1].gap_open_R.__setitem__(2, -129),
     "gap cost overflow"),
], ids=["extend", "profile", "query", "score", "gap"])
def test_pack_rejects_what_jax_rejects(change, match):
    pairs = chip_smoke.profile_pairs(np.random.default_rng(4), 6, 60)
    change(pairs)
    cfg = lk.LaneKernelConfig(32, 256, profile=True)
    with pytest.raises(AssertionError, match=match):
        pack_profile(pairs, cfg, "cpu")
    with pytest.raises(AssertionError, match=match):
        jlane._pack_profile_host(both(pairs)[1], SimpleNamespace(
            batch=len(pairs), block=32), 256)


@pytest.mark.parametrize("S,x,trace", [
    (16, None, False), (32, None, True), (32, 50, False), (16, 30, True),
], ids=["16-global", "32-trace", "32-x-drop", "16-x-drop-trace"])
def test_lane_plain_matches_oracle(S, x, trace):
    """Profiles with varied gap opens and nonzero close costs: scores (in
    x-drop mode their positions) and CIGARs equal the oracle's."""
    tpairs, jpairs = both(chip_smoke.profile_pairs(
        np.random.default_rng(S), 14, 100, odd=False))
    cfg = lk.LaneKernelConfig(S, 256, x_drop=x is not None, trace=trace,
                              profile=True)
    got = lk.lane_align_plain(*pack_profile(tpairs, cfg, "cpu", x or 0), cfg)
    tr = None
    if trace:
        got, words, desc, steps = got
        tr = Trace(words.numpy(), desc.numpy(), steps.numpy())
    got = got.numpy()
    for k, (want, orc) in enumerate(oracle(jpairs, (S, S), x, trace)):
        assert (tuple(got[k, :3]) if x is not None else got[k, 0]) == (
            want if x is not None else want[0]), k
        if trace:
            assert str(tr.cigar(k, *want[1:])) == str(orc.cigar(*want[1:])), k
    if x is not None:
        ends = got[:, 1:3] != [(len(q), p.str_len) for q, p in tpairs]
        assert ends.any()


@pytest.mark.parametrize("size,x,trace", [
    ((16, 64), None, False), ((16, 64), 50, False), ((16, 64), None, True),
    ((32, 512), None, True),
], ids=["16-64-global", "16-64-x-drop", "16-64-trace", "32-512-trace"])
def test_adaptive_plain_matches_oracle(size, x, trace):
    """Pairs whose blocks grow (at (32, 512) one to 512 rows, across a
    profile with 300 inserted residues): scores, positions and CIGARs equal
    the oracle's."""
    if size[1] == 512:
        pairs = chip_smoke.grow_profile_pairs(np.random.default_rng(8), 1)
        cap = 1408
    else:
        pairs = grow_pairs(size[1], 14, 100)
        cap = 256
    tpairs, jpairs = both(pairs)
    cfg = ak.AdaptiveKernelConfig(*size, cap, x_drop=x is not None,
                                  trace=trace, profile=True)
    got = ak.adaptive_align_plain(*pack_profile(tpairs, cfg, "cpu", x or 0),
                                  cfg)
    if trace:
        got, words, desc, steps = got
        tr = Trace(words.numpy(), desc.numpy(), steps.numpy())
    got = got.numpy()
    assert not got[:, -1].any()
    grew = 0
    for k, (want, orc) in enumerate(oracle(jpairs, size, x, trace=True)):
        assert (tuple(got[k, :3]) if x is not None else got[k, 0]) == (
            want if x is not None else want[0]), k
        sizes = [max(b.width, b.height) for b in orc.trace_blocks()]
        grew += any(b > a for a, b in zip(sizes[1:], sizes[2:]))
        if trace:
            assert str(tr.cigar(k, *want[1:])) == str(orc.cigar(*want[1:])), k
    assert grew >= (1 if size[1] == 512 else 4)
    if size[1] == 512:
        ran = np.arange(desc.shape[0]) < int(steps[0])
        assert int(desc[ran.nonzero()[0], 0, 3].max()) == 512


@pytest.fixture(scope="module", params=[(16, 16), (16, 64)],
                ids=["lane", "adaptive"])
def jax_global(request):
    """Profile pairs through the JAX ProfileAligner (interpret mode), one
    compile per route; the lane pairs hold query bytes outside A..Z."""
    size = request.param
    lane = size[0] == size[1]
    pairs = (chip_smoke.profile_pairs(np.random.default_rng(11), 24, 90)
             if lane else grow_pairs(12, 24, 90))
    tpairs, jpairs = both(pairs)
    al = jba.ProfileAligner(size, batch=32, seq_cap=128)
    return size, tpairs, al.align_batch(jpairs), al.last_suspect


def test_profile_aligner_matches_jax(jax_global):
    """align_batch, align_all over several batches (sorted and not) and a
    staged batch run twice give the JAX ProfileAligner's results, and on
    the lane route its suspect flags; odd query bytes score as there."""
    size, pairs, want, want_susp = jax_global
    lane = size[0] == size[1]

    def port(batch):
        return tba.ProfileAligner(size, batch=batch, seq_cap=128,
                                  device="cpu")

    al = port(32)
    assert al.route == ("lane" if lane else "adaptive")
    assert fields(al.align_batch(pairs)) == fields(want)
    if lane:
        assert np.array_equal(al.last_suspect, want_susp)
        assert want_susp.any()
        assert any(bool((p.convert(q) >= 28).any()) for q, p in pairs)
    else:
        assert al.last_suspect is None
    al = port(7)
    for sort in (True, False):
        assert fields(al.align_all(pairs, sort=sort)) == fields(want)
        if lane:
            assert np.array_equal(al.last_suspect, want_susp)
    staged = al.stage(pairs[-7:])
    for _ in range(2):
        assert fields(al.align_staged(staged)) == fields(want[-7:])


def test_profile_aligner_x_drop_matches_jax():
    """Adaptive x-drop: best scores and their positions equal the JAX
    ProfileAligner's, and some pairs end short of both ends."""
    pairs = grow_pairs(13, 20, 90)
    for k in range(4, 20, 3):  # unrelated pairs, which x-drop ends early
        pairs[k] = (pairs[k - 1][0], pairs[k][1])
    tpairs, jpairs = both(pairs)
    want = jba.ProfileAligner((16, 64), batch=32, seq_cap=128,
                              x_drop=50).align_batch(jpairs)
    al = tba.ProfileAligner((16, 64), batch=32, seq_cap=128, x_drop=50,
                            device="cpu")
    got = al.align_batch(tpairs)
    assert fields(got) == fields(want)
    assert any((r.query_idx, r.reference_idx) != (len(q), p.str_len)
               for r, (q, p) in zip(got, tpairs))


def test_profile_aligner_trace_matches_jax():
    """Lane trace: results and CIGARs (``cigar``) equal the JAX
    ProfileAligner's; stage refuses trace with a ValueError."""
    tpairs, jpairs = both(chip_smoke.profile_pairs(
        np.random.default_rng(14), 16, 90, odd=False))
    jal = jba.ProfileAligner((16, 16), batch=32, seq_cap=128, trace=True)
    want = jal.align_batch(jpairs)
    al = tba.ProfileAligner((16, 16), batch=32, seq_cap=128, trace=True,
                            device="cpu")
    got = al.align_batch(tpairs)
    assert fields(got) == fields(want)
    for k, r in enumerate(got):
        ends = (r.query_idx, r.reference_idx)
        assert str(al.cigar(k, *ends)) == str(jal.cigar(k, *ends)), k
    with pytest.raises(ValueError, match="trace"):
        al.stage(tpairs)


def test_align_profile_exp_all_matches_oracle_ladder():
    """The ladder 16, 32 (adaptive) and 64 (lane), global and x-drop, with
    the (64, 64) scores as targets and one unreachable target: the results
    and min sizes of ``BlockOracle.align_profile_exp`` per pair."""
    tpairs, jpairs = both(grow_pairs(15, 12, 80))
    for x in (None, 50):
        cfg = lk.LaneKernelConfig(64, 256, x_drop=x is not None, profile=True)
        full = lk.lane_align_plain(*pack_profile(tpairs, cfg, "cpu", x or 0),
                                   cfg)
        targets = [int(v) for v in full[:, 0]]
        targets[3] += 1  # unreachable
        got, mins = tba.align_profile_exp_all(
            tpairs, targets, (16, 64), x_drop=x, batch=8, seq_cap=128,
            device="cpu")
        orc = jba.BlockOracle(x_drop=x is not None)
        for k, (q, p) in enumerate(jpairs):
            m = orc.align_profile_exp(jba.PaddedBytes.from_bytes(q, 64, p), p,
                                      (16, 64), x or 0, targets[k])
            r = orc.res()
            assert mins[k] == m, (x, k)
            assert fields(got[k : k + 1]) == [
                (r.score, r.query_idx, r.reference_idx)], (x, k)
        assert mins[3] is None  # the unreachable pair runs every level


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(size=(32, 1024)), None, None),
    (dict(size=(1024, 1024)), None, None),
    (dict(size=(32, 16384)), ValueError, "8192"),
    (dict(size=(32, 1024), local_start=True), None, None),
    (dict(free_query_start_gaps=True, use_lane_kernel=False),
     NotImplementedError, "queue 1 item 3"),
    (dict(free_query_end_gaps=True, mesh=object()), NotImplementedError,
     "queue 1 item 6"),
    (dict(use_lane_kernel=False), NotImplementedError, "queue 1 item 3"),
    (dict(mesh=object()), NotImplementedError, "queue 1 item 6"),
    (dict(local_start=True, free_query_start_gaps=True), AssertionError,
     "exclude"),
    (dict(x_drop=5, free_query_end_gaps=True), AssertionError, "exclude"),
    (dict(x_drop=-1), ValueError, ">= 0"),
], ids=["big", "big-fixed", "past-8192", "local-start", "free-start",
        "free-end", "engine", "mesh", "exclusive-flags", "x-drop-free-end",
        "negative-x"])
def test_rejections(kwargs, error, match):
    """What ``ProfileAligner`` rejects, as the JAX package does.  Blocks past
    512 (``error`` None), which raised before kernel C's profile mode, take
    the big route and give the plain version's results."""
    if error is not None:
        with pytest.raises(error, match=match):
            tba.ProfileAligner(device="cpu", **kwargs)
        return
    al = tba.ProfileAligner(device="cpu", batch=4, seq_cap=100, **kwargs)
    assert al.route == "big" and al.cfg.prof_cap == 128
    pairs = chip_smoke.profile_pairs(np.random.default_rng(17), 8, 60)[4:]
    want = bk.big_align_plain(*pack_profile(pairs, al.cfg, "cpu"), al.cfg)
    assert [r.score for r in al.align_batch(pairs)] == want[:, 0].tolist()


def test_routes_and_wrappers():
    """(32, 512) without trace is the adaptive route; on CPU tensors the
    wrappers are the plain versions and count no launch."""
    assert tba.ProfileAligner((32, 512), device="cpu").route == "adaptive"
    assert tba.ProfileAligner((512, 512), device="cpu").route == "lane"
    assert tba.ProfileAligner().device == torch.device("cuda")
    pairs = chip_smoke.profile_pairs(np.random.default_rng(16), 8, 60)
    for cfg, fn, plain in (
            (lk.LaneKernelConfig(32, 256, profile=True), lk.lane_align,
             lk.lane_align_plain),
            (ak.AdaptiveKernelConfig(32, 512, 768, profile=True),
             ak.adaptive_align, ak.adaptive_align_plain)):
        pk = pack_profile(pairs, cfg, "cpu")
        before = fn.profile_launches
        assert torch.equal(fn(*pk, cfg), plain(*pk, cfg))
        assert fn.profile_launches == before
    with pytest.raises(ValueError, match="16..256"):
        ak.AdaptiveKernelConfig(32, 512, 768)


def test_scop_generators_match_jax():
    """chip_smoke's SCOP-style generator and PSSM reader give the arrays of
    the JAX package's ``load_scop_profiles``."""
    for got, want in ((chip_smoke.scop_profiles(12, seed=1234),
                       load_scop_profiles(n_pairs=12, seed=1234)),
                      (chip_smoke.read_pssm(chip_smoke.ROOT
                                            + "/data/scop/pairs.mini.pssm"),
                       load_scop_profiles(name="pairs.mini.pssm"))):
        assert len(got) == len(want) > 0
        for (q, p), (jq, jp) in zip(got, want):
            assert q == jq
            for name in ("pos_scores", "gap_open_C", "gap_close_C",
                         "gap_open_R"):
                assert np.array_equal(getattr(p, name), getattr(jp, name))


def missing_pairs():
    """SCOP-style pairs whose lane (32, 32) trace walks, three of them,
    pass a profile gap from a down rect's last lane into a right rect where
    the walk cannot follow the DP (pairs 6, 11 and 45)."""
    return chip_smoke.scop_profiles(110, seed=21, max_len=90)[60:]


def lane_trace_cigars(pairs):
    """The plain lane (32, 32) version's results, trace, CIGARs and
    ``chip_smoke.profile_gap_rects`` of each pair."""
    cfg = lk.LaneKernelConfig(32, 256, trace=True, profile=True)
    out, words, desc, steps = lk.lane_align_plain(
        *pack_profile(pairs, cfg, "cpu"), cfg)
    tr = Trace(words.numpy(), desc.numpy(), steps.numpy())
    results = [tba.AlignResult(int(o[0]), len(q), p.str_len)
               for o, (q, p) in zip(out, pairs)]
    cigars = tr.cigars_all([(r.query_idx, r.reference_idx) for r in results])
    gaps = [chip_smoke.profile_gap_rects(tr, b, c)
            for b, c in enumerate(cigars)]
    return results, cigars, gaps


def test_cigars_rescore_or_equal_the_oracle():
    """On SCOP-style pairs every lane trace CIGAR sums to its end and
    rescores to its score under chip_smoke's profile rescorer, but for
    pairs with a profile gap handed from a down rect's last lane to a right
    rect; those rescore below their score, and their CIGARs are the
    oracle's own."""
    pairs = missing_pairs()
    results, cigars, gaps = lane_trace_cigars(pairs)
    miss, hand = chip_smoke.check_profile_cigars(cigars, gaps, pairs,
                                                 results, "lane profile")
    assert miss == [6, 11, 45] and hand >= len(miss)
    jpairs = [(q, to_jax(p)) for q, p in pairs]
    for k in miss:
        (want, orc), = oracle(jpairs[k : k + 1], (32, 32), trace=True)
        assert want[0] == results[k].score
        assert str(orc.cigar(*want[1:])) == str(cigars[k])


def test_missed_cigars_leave_the_oracle_dp_at_the_hand_off(monkeypatch):
    """Why those CIGARs miss, in the oracle's own DP values: along each
    walked CIGAR every run moves D by its cost, but for the D run with the
    hand-off, across which D rises, as no gap can (the right rect extends
    the down rect's last-lane open, which the trace cannot show, so the
    walk goes one position too far back)."""
    cells = {}
    place = jba.BlockOracle._place_block

    def recording(self, fetch, right, start_i, start_j, width, height,
                  D_col, **kw):
        def put(w):
            for lane in range(height):
                at = ((start_i + lane, start_j + w) if right
                      else (start_j + w, start_i + lane))
                cells[at] = int(D_col[lane]) - kw["relative_zero"]

        class Recording:
            gap_extend = fetch.gap_extend

            def column(self, right_, si, col, h):
                if col > start_j:
                    put(col - start_j - 1)
                self.last = col - start_j
                return fetch.column(right_, si, col, h)

        rec = Recording()
        out = place(self, rec, right, start_i, start_j, width, height, D_col,
                    **kw)
        if hasattr(rec, "last"):
            put(rec.last)
        return out

    monkeypatch.setattr(jba.BlockOracle, "_place_block", recording)
    pairs = missing_pairs()
    results, cigars, gaps = lane_trace_cigars(pairs)
    for k in (6, 11, 45):
        q, p = pairs[k]
        cells.clear()
        (want, _), = oracle([(q, to_jax(p))], (32, 32), trace=True)
        assert cells[want[1:]] == want[0]
        codes = p.convert(q).astype(np.int64)
        e = p.get_gap_extend()
        i = j = 0
        run_gaps = iter(gaps[k])
        off = []
        for run in cigars[k].to_vec():
            op, n = int(run.op), run.len
            if op == tba.Operation.M:
                cost = int(p.pos_scores[np.arange(j + 1, j + 1 + n),
                                        codes[i : i + n]].sum())
                ni, nj, hand = i + n, j + n, False
            elif op == tba.Operation.I:
                cost = int(p.gap_open_R[j]) + n * e
                ni, nj, hand = i + n, j, False
            else:
                right, hand = next(run_gaps)
                cost = (int(p.gap_open_C[j + 1 if right else j]) + n * e
                        + int(p.gap_close_C[j + n]))
                ni, nj = i, j + n
            step = cells[(ni, nj)] - cells[(i, j)]
            if step != cost:
                off.append((hand, step))
            i, j = ni, nj
        assert len(off) == 1 and off[0][0]
        assert off[0][1] > 0
