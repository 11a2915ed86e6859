"""X-drop mode of the port against the JAX package: the plain versions of
both kernels against ``BlockOracle(x_drop=True)`` and against the JAX lane
and adaptive kernels in x-drop mode (interpret mode), and ``BatchAligner``
and ``align_exp_all`` with ``x_drop`` against the JAX package's.  Every
comparison is exact (best score, its position, suspect or overrun): the
contract is integer arithmetic, so the tolerance is 0.  The CUDA kernels
run only on the card (``chip_smoke.py``); ``test_torch_kernel_sources.py``
holds their sources against these plain versions here."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
import chip_smoke
from block_aligner_tpu.ops import adaptive_kernel as jadaptive
from block_aligner_tpu.ops import lane_kernel as jlane
from block_aligner_tpu_torch.ops import adaptive_kernel as ak
from block_aligner_tpu_torch.ops import lane_kernel as lk
from test_lane_kernel import AA, DNA, mutate, rand_seq
from test_torch_adaptive_kernel import dna_pairs, protein_pairs

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PROTEIN = (jba.BLOSUM62, jba.Gaps(-11, -1))
DIVERGENT = (jba.NucMatrix.new_simple(2, -4), jba.Gaps(-6, -2))
NUC = (jba.NW1, jba.Gaps(-2, -1))


def lane_pairs(seed, alphabet, n, max_len, unrelated):
    """The JAX package's x-drop test pairs (tests/test_lane_kernel.py):
    pairs with len/5 (len/6 for DNA) edits, and with ``unrelated`` about
    every other pair unrelated, which x-drop ends early."""
    rng = np.random.default_rng(seed)
    pairs = [(b"AAAA", b"AARA"), (b"", b""), (b"A", b"")]
    while len(pairs) < n:
        k = int(rng.integers(10, max_len))
        q = rand_seq(rng, alphabet, k)
        if unrelated and rng.integers(0, 2):
            pairs.append((q, rand_seq(rng, alphabet, k)))
        else:
            pairs.append((q, mutate(rng, q, k // (6 if alphabet == DNA else 5),
                                    alphabet)))
    return pairs


def cap_for(pairs, S):
    maxlen = max(max(len(q), len(r)) for q, r in pairs)
    return max(256, -(-(1 + maxlen + S + 16) // 128) * 128)


def alpha(matrix):
    return 32 if matrix.kind != "nuc" else 16


def port_pack(pairs, matrix, gaps, cfg, x):
    return lk.pack_lane(pairs, tba.matrix_from_jax(matrix),
                        cfg, tba.gaps_from_jax(gaps), "cpu", x_drop=x)


def oracle(pairs, matrix, gaps, size, x, trace=False):
    orc = jba.BlockOracle(x_drop=True, trace=trace)
    for q, r in pairs:
        orc.align(jba.PaddedBytes.from_bytes(q, size[1], matrix),
                  jba.PaddedBytes.from_bytes(r, size[1], matrix), matrix,
                  gaps, size, x)
        res = orc.res()
        yield (res.score, res.query_idx, res.reference_idx), orc


def fields(results):
    return [(r.score, r.query_idx, r.reference_idx) for r in results]


@pytest.mark.parametrize("S,setup,x,seed,unrelated", [
    (32, PROTEIN, 50, 23, False), (16, DIVERGENT, 100, 29, True),
    (64, NUC, 20, 31, True), (256, PROTEIN, 50, 37, True),
], ids=["32-protein", "16-dna-divergent", "64-dna", "256-protein"])
def test_lane_plain_matches_block_oracle(S, setup, x, seed, unrelated):
    matrix, gaps = setup
    alphabet = AA if matrix is jba.BLOSUM62 else DNA
    n, max_len = (10, 100) if S == 256 else (22, 150)
    pairs = lane_pairs(seed, alphabet, n, max_len, unrelated)
    cfg = lk.LaneKernelConfig(S, cap_for(pairs, S), alpha(matrix), x_drop=True)
    pk = port_pack(pairs, matrix, gaps, cfg, x)
    got = lk.lane_align_plain(*pk, cfg).numpy()
    for k, (want, _) in enumerate(oracle(pairs, matrix, gaps, (S, S), x)):
        assert tuple(got[k, :3]) == want, (k, pairs[k])
    assert chip_smoke.x_dropped(torch.from_numpy(got), pk) > 0


def test_lane_plain_matches_jax_lane_kernel():
    """All four rows of the JAX lane kernel's x-drop output (best, its
    position, suspect), run in interpret mode as
    tests/test_lane_kernel.py::run_kernel_xdrop runs it."""
    pairs = lane_pairs(41, AA, 40, 90, True)
    cap = cap_for(pairs, 32)
    jcfg = jlane.LaneKernelConfig(batch=128, block=32, seq_cap=cap, alpha=32,
                                  banks=1, x_drop=True, interpret=True)
    out = np.asarray(jlane.build_lane_engine(jcfg)(
        *jlane.pack_lane(pairs, jba.BLOSUM62, jcfg, PROTEIN[1], x_drop=50)))
    want = out[0, 0, :, : len(pairs)].T
    cfg = lk.LaneKernelConfig(32, cap, 32, x_drop=True)
    got = lk.lane_align_plain(*port_pack(pairs, *PROTEIN, cfg, 50), cfg)
    assert 0 < want[:, 3].sum() < len(pairs)  # both suspect values occur
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("size,setup,x", [
    ((16, 64), PROTEIN, 50), ((32, 128), NUC, 20),
], ids=["16-64-protein", "32-128-dna"])
def test_adaptive_plain_matches_block_oracle(size, setup, x):
    """Pairs whose blocks grow (the oracle's trace shows it), and pairs
    that x-drop ends before both ends."""
    matrix, gaps = setup
    pairs = protein_pairs(5, 30) if matrix is jba.BLOSUM62 else dna_pairs(3, 24)
    cfg = ak.AdaptiveKernelConfig(*size, cap_for(pairs, size[1]),
                                  alpha(matrix), x_drop=True)
    pk = port_pack(pairs, matrix, gaps, cfg, x)
    got = ak.adaptive_align_plain(*pk, cfg).numpy()
    assert not got[:, 3].any()
    grew = 0
    for k, (want, orc) in enumerate(oracle(pairs, matrix, gaps, size, x, True)):
        assert tuple(got[k, :3]) == want, (k, pairs[k])
        sizes = [max(b.width, b.height) for b in orc.trace_blocks()]
        grew += any(b > a for a, b in zip(sizes[1:], sizes[2:]))
    assert grew > 5 and chip_smoke.x_dropped(torch.from_numpy(got), pk) > 5


def test_adaptive_plain_matches_jax_adaptive_kernel():
    """All four rows of the JAX adaptive kernel's x-drop output (best, its
    position, overrun) at (16, 64), interpret mode."""
    pairs = [(q[:70], r[:70]) for q, r in protein_pairs(43, 32)]
    cap = cap_for(pairs, 64)
    jcfg = jadaptive.AdaptiveKernelConfig(
        batch=128, min_size=16, max_size=64, seq_cap=cap, alpha=32, banks=1,
        x_drop=True, interpret=True)
    out = np.asarray(jadaptive.build_adaptive_engine(jcfg)(
        *jlane.pack_lane(pairs, jba.BLOSUM62, jcfg, PROTEIN[1], x_drop=50)))
    cfg = ak.AdaptiveKernelConfig(16, 64, cap, 32, x_drop=True)
    got = ak.adaptive_align_plain(*port_pack(pairs, *PROTEIN, cfg, 50), cfg)
    assert np.array_equal(got.numpy(), out[0, 0, :, : len(pairs)].T)


@pytest.fixture(scope="module", params=[(32, 32), (16, 64)],
                ids=["lane", "adaptive"])
def jax_xdrop(request):
    """Homolog, unrelated and edge-case pairs through the JAX BatchAligner
    with x_drop=50."""
    pairs = [(q[:80], r[:80]) for q, r in protein_pairs(47, 30)]
    al = jba.BatchAligner(*PROTEIN, request.param, batch=32, seq_cap=128,
                          x_drop=50)
    res = al.align_batch(pairs)
    return request.param, pairs, res, al.last_suspect


def test_batch_aligner_matches_jax(jax_xdrop):
    """align_batch, align_all over several batches (sorted and not) and a
    staged batch run twice give the JAX package's x-drop results in order,
    and on the lane route its suspect flags."""
    size, pairs, want, want_susp = jax_xdrop
    lane = size[0] == size[1]

    def port(batch):
        return tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), size,
                                batch=batch, seq_cap=128, x_drop=50,
                                device="cpu")

    al = port(32)
    assert al.route == ("lane" if lane else "adaptive")
    got = al.align_batch(pairs)
    assert fields(got) == fields(want)
    assert any((r.query_idx, r.reference_idx) != (len(q), len(p))
               for r, (q, p) in zip(got, pairs))
    if lane:
        assert np.array_equal(al.last_suspect, want_susp)
    else:
        assert al.last_suspect is None
    al = port(8)
    for sort in (True, False):
        assert fields(al.align_all(pairs, sort=sort)) == fields(want)
        if lane:
            assert np.array_equal(al.last_suspect, want_susp)
    staged = al.stage(pairs[-8:])
    for _ in range(2):
        assert fields(al.align_staged(staged)) == fields(want[-8:])


def test_align_exp_all_matches_jax():
    """The ladder 32 (adaptive) and 64 (lane) with x_drop=50, targets the
    x-drop scores at (64, 64): the same results and min sizes as the JAX
    package; the pair that never reaches its target ends with the lane
    level's result."""
    pairs = [(q[:60], r[:60]) for q, r in protein_pairs(53, 20)]
    cfg = lk.LaneKernelConfig(64, 256, 32, x_drop=True)
    full = lk.lane_align_plain(*port_pack(pairs, *PROTEIN, cfg, 50), cfg)
    targets = [int(v) for v in full[:, 0]]
    targets[7] += 1  # unreachable
    want, want_min = jba.api.align_exp_all(*PROTEIN, pairs, targets, (32, 64),
                                           x_drop=50, batch=32, seq_cap=128)
    got, got_min = tba.align_exp_all(tba.BLOSUM62, tba.Gaps(-11, -1), pairs,
                                     targets, (32, 64), x_drop=50, batch=32,
                                     seq_cap=128, device="cpu")
    assert got_min == want_min and fields(got) == fields(want)
    assert got_min.count(None) == 1 and got_min[7] is None
    assert fields(got[7:8]) == [tuple(int(v) for v in full[7, :3])]
    with pytest.raises(ValueError, match=">= 0"):
        tba.align_exp_all(tba.BLOSUM62, tba.Gaps(-11, -1), pairs, targets,
                          (32, 64), x_drop=-1, device="cpu")


@pytest.mark.parametrize("kwargs,match", [
    (dict(x_drop=-1), ">= 0"),
    (dict(x_drop=50, free_query_end_gaps=True), "free_query_end_gaps"),
    (dict(x_drop=50, matrix=tba.BYTES1), "ByteMatrix"),
], ids=["negative", "free_end", "byte"])
def test_rejections_raise_value_error(kwargs, match):
    """What the JAX package and the reference reject, the port rejects with
    a ValueError, before any route or slice check."""
    kw = dict(matrix=tba.BLOSUM62, gaps=tba.Gaps(-11, -1), size=(32, 32),
              device="cpu")
    kw.update(kwargs)
    with pytest.raises(ValueError, match=match):
        tba.BatchAligner(**kw)


def test_wrappers_on_cpu_give_the_wide_output():
    """On CPU tensors both wrappers are their plain versions, (B, 4) wide
    in x-drop mode; the kernels' x argument is x, or -1 in global mode."""
    pairs = [(q[:60], r[:60]) for q, r in protein_pairs(59, 10)]
    for cfg, fn, plain in (
            (lk.LaneKernelConfig(32, 256, 32, x_drop=True), lk.lane_align,
             lk.lane_align_plain),
            (ak.AdaptiveKernelConfig(16, 64, 256, 32, x_drop=True),
             ak.adaptive_align, ak.adaptive_align_plain)):
        pk = port_pack(pairs, *PROTEIN, cfg, 50)
        before = fn.launches, fn.xdrop_launches
        got = fn(*pk, cfg)
        assert (fn.launches, fn.xdrop_launches) == before
        assert got.shape == (len(pairs), 4) and got.dtype == torch.int32
        assert torch.equal(got, plain(*pk, cfg))
        assert fn(*port_pack([], *PROTEIN, cfg, 50), cfg).shape == (0, 4)
        assert lk.x_value(pk.gaps, cfg) == 50
        assert lk.x_value(pk.gaps[:2], global_mode(cfg)) == -1
        with pytest.raises(ValueError, match=">= 0"):
            lk.x_value((-11, -1, -5), cfg)


def global_mode(cfg):
    return dataclasses.replace(cfg, x_drop=False)


def test_cells_count_whole_steps():
    """In x-drop mode a pair's cells are whole steps up to the decision
    that ends it; on unrelated pairs that is fewer than global mode's."""
    rng = np.random.default_rng(61)
    pairs = [(rand_seq(rng, AA, 200), rand_seq(rng, AA, 200))
             for _ in range(6)]
    for xd in (lk.LaneKernelConfig(32, 512, 32, x_drop=True),
               ak.AdaptiveKernelConfig(32, 64, 512, 32, x_drop=True)):
        gl = global_mode(xd)
        pk = port_pack(pairs, *PROTEIN, xd, 10)
        plain = lk.lane_align_plain if isinstance(
            xd, lk.LaneKernelConfig) else ak.adaptive_align_plain
        _, cells = plain(*pk, xd, count_cells=True)
        _, gcells = plain(*pk, gl, count_cells=True)
        assert bool((cells % (8 * 32) == 0).all())
        assert bool((cells < gcells).all())
