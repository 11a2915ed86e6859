"""The port's big-kernel module against the JAX package's scalar contract:
``big_align_plain`` (the adaptive machine of ``ops/adaptive_kernel.py`` on
blocks past 512) against ``BlockOracle``, global and x-drop, protein and
DNA, at (32, 512), (128, 1024), (512, 1024) and fixed (1024, 1024), lengths
0 to the sequence capacity, and pairs whose blocks grow to 1024; then the
wrapper, the configuration and the packer.  Every comparison is exact: the
contract is integer arithmetic, so the tolerance is 0.  The CUDA kernel
itself runs only on the card (``chip_smoke.py`` holds it against this plain
version; ``test_torch_kernel_sources.py`` runs its source here)."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from block_aligner_tpu import BLOSUM62, BlockOracle, Gaps, PaddedBytes
from block_aligner_tpu.core.scores import NucMatrix
from block_aligner_tpu.ops import big_kernel as jbig
from block_aligner_tpu_torch import gaps_from_jax, matrix_from_jax
from block_aligner_tpu_torch.ops import big_kernel as bk
from block_aligner_tpu_torch.ops import lane_kernel as lk
from test_torch_adaptive_kernel import protein_pairs

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PROTEIN = (BLOSUM62, Gaps(open=-11, extend=-1))
# the reference's long-read scoring (examples/nanopore_accuracy.rs)
DNA = (NucMatrix.new_simple(2, -4), Gaps(open=-6, extend=-2))


def dna_pairs(seed, n):
    return chip_smoke.structural_pairs(np.random.default_rng(seed),
                                       chip_smoke.DNA, n, 200)


def config(pairs, size, matrix, x=None):
    maxlen = max(max(len(q), len(r)) for q, r in pairs)
    cap = max(256, -(-(1 + maxlen + size[1] + 16) // 128) * 128)
    return bk.BigKernelConfig(size[0], size[1], cap,
                              16 if matrix.kind == "nuc" else 32,
                              x_drop=x is not None)


def plain(pairs, matrix, gaps, size, x=None, **kw):
    cfg = config(pairs, size, matrix, x)
    pk = bk.pack_big(pairs, matrix_from_jax(matrix), cfg, gaps_from_jax(gaps),
                     "cpu", x or 0)
    return bk.big_align_plain(*pk, cfg, **kw)


def oracle(q, r, matrix, gaps, size, x=None):
    orc = BlockOracle(x_drop=x is not None)
    orc.align(PaddedBytes.from_bytes(q, size[1], matrix),
              PaddedBytes.from_bytes(r, size[1], matrix), matrix, gaps, size,
              x or 0)
    res = orc.res()
    return (res.score, res.query_idx, res.reference_idx)


def at_capacity(pairs, size, rng, alphabet):
    """``pairs`` and one more whose query fills the sequence capacity of
    their configuration (``BatchAligner.seq_capacity``)."""
    cap = config(pairs, size, NucMatrix.new_simple(1, -1)).seq_cap
    n = cap - size[1] - 17
    q = rng.choice(alphabet, size=n).tobytes()
    return pairs + [(q, q[: n - 9] + rng.choice(alphabet, size=5).tobytes())]


@pytest.mark.parametrize("size,setup,x,n", [
    ((32, 512), "protein", None, 9), ((32, 512), "dna", 20, 9),
    ((128, 1024), "protein", 100, 7), ((128, 1024), "dna", None, 7),
    ((512, 1024), "dna", 0, 3), ((512, 1024), "protein", None, 5),
    ((1024, 1024), "protein", None, 5),
], ids=["32-512-protein", "32-512-dna-x20", "128-1024-protein-x100",
        "128-1024-dna", "512-1024-dna-x0", "512-1024-protein",
        "1024-1024-protein"])
def test_plain_matches_block_oracle(size, setup, x, n):
    """Edge cases (empty sequences, one residue), homologs with structural
    indels, unrelated pairs, and a query as long as the capacity; in
    x-drop mode score and end position, else the score at (qlen, rlen)."""
    matrix, gaps = PROTEIN if setup == "protein" else DNA
    seed = size[0] + size[1] + n
    rng = np.random.default_rng(seed)
    if setup == "protein":
        pairs = at_capacity(protein_pairs(seed, n), size, rng, chip_smoke.AA)
    else:
        pairs = at_capacity(dna_pairs(seed, n), size, rng, chip_smoke.DNA)
    got = plain(pairs, matrix, gaps, size, x).numpy()
    assert not got[:, -1].any()  # no pair hit the step cap
    for k, (q, r) in enumerate(pairs):
        want = oracle(q, r, matrix, gaps, size, x)
        have = tuple(int(v) for v in got[k, :3]) if x is not None else (
            int(got[k, 0]), len(q), len(r))
        assert have == want, (k, len(q), len(r))
    if x is not None:  # some pairs end short of (qlen, rlen)
        assert any(got[k, 1] < len(q) or got[k, 2] < len(r)
                   for k, (q, r) in enumerate(pairs))


@pytest.mark.parametrize("x", [None, 500], ids=["global", "x-drop"])
def test_plain_grows_to_1024(x):
    """A 650-residue protein and the same with 700 random residues
    inserted (the reference's long-indel case, JAX
    ``tests/test_big_kernel.py::test_big_kernel_past_512``): at (256, 1024)
    the blocks grow to 1024 rows, in x-drop mode too, and the plain version
    equals the oracle."""
    pairs = chip_smoke.grow_to_512_pairs(np.random.default_rng(9), 1, 650,
                                         700)
    got, top = plain(pairs, *PROTEIN, (256, 1024), x, top_size=True)
    assert int(top[0]) == 1024
    q, r = pairs[0]
    want = oracle(q, r, *PROTEIN, (256, 1024), x)
    have = got[0, :3] if x is not None else (got[0, 0], len(q), len(r))
    assert tuple(int(v) for v in have) == want


def test_step_cap_overrun():
    """Under a lowered step cap the pairs that need more steps report the
    overrun, and the others keep their results."""
    pairs = protein_pairs(3, 10)
    cfg = config(pairs, (32, 512), BLOSUM62)
    pk = bk.pack_big(pairs, matrix_from_jax(BLOSUM62), cfg,
                     gaps_from_jax(PROTEIN[1]), "cpu")
    full = bk.big_align(*pk, cfg)
    capped = bk.big_align(*pk, chip_smoke.with_step_cap(cfg, 30))
    over = capped[:, 1].bool()
    assert 0 < int(over.sum()) < len(pairs) and not full[:, 1].any()
    assert torch.equal(capped[~over], full[~over])


def test_wrapper_devices_and_counts():
    """CPU tensors take the plain version and count no launch; a device
    that is neither the CPU nor CUDA raises, and no path falls back."""
    pairs = protein_pairs(4, 6)
    cfg = config(pairs, (64, 1024), BLOSUM62, x=20)
    pk = bk.pack_big(pairs, matrix_from_jax(BLOSUM62), cfg,
                     gaps_from_jax(PROTEIN[1]), "cpu", 20)
    lk.reset_counts(bk.big_align)
    assert torch.equal(bk.big_align(*pk, cfg), bk.big_align_plain(*pk, cfg))
    assert bk.big_align.launches == bk.big_align.xdrop_launches == 0
    meta = [t.to("meta") for t in pk[:4]]
    with pytest.raises(ValueError, match="no big kernel for device meta"):
        bk.big_align(*meta, pk.gaps, cfg)


def test_config_validation():
    """Sizes, capacity and modes (profiles take a table size, ``prof_cap``,
    and blocks up to 8192; the ByteMatrix and flag modes take the JAX
    configuration's exclusions); the code capacity has no cap of its own
    (the long routes size it from each batch) and blocks reach 16384 rows
    in the 16384-row libraries; the block, the
    step cap and the trace budget are the JAX configuration's
    (``big_kernel.py:277-281``, its default slot budget in rows at seg 256,
    ``:311-320``, two words a row with local start)."""
    for bad in [(16, 256, 1024), (16, 16384, 16384), (24, 1024, 2048),
                (2048, 1024, 4096), (512, 512, 1024), (16, 1024, 1000),
                (16, 1024, 1024), (16, 32768, 33024)]:
        with pytest.raises(ValueError):
            bk.BigKernelConfig(*bad)
    assert bk.library(bk.BigKernelConfig(16, 8192, 65536)) == "big_kernel"
    for trace, name in ((False, "big_16384"), (True, "big_trace_16384")):
        assert bk.library(bk.BigKernelConfig(
            512, 16384, 16512, trace=trace, local_start=trace)) == name
    with pytest.raises(ValueError, match="8192"):
        bk.BigKernelConfig(16, 16384, 16512, profile=True, prof_cap=128)
    big = bk.BigKernelConfig(16, 1024, 2048, trace=True)
    assert bk.BigKernelConfig(16, 1024, 2048, trace=True,
                              budget=600).trace_budget == 600
    assert big.full_budget == big.max_steps * 1024 > big.trace_budget
    # the long routes' first budget: twice a straight walk's steps at 256
    # rows and 8 at the max size, at most the default
    assert big.walk_budget(800) == 2 * 100 * 256 + 8 * 1024
    assert big.walk_budget(10 ** 6) == big.trace_budget
    # the kernel counts words in int32: budgets stop below 2^31
    huge = bk.BigKernelConfig(512, 16384, 1 << 20, trace=True,
                              local_start=True)
    assert huge.full_budget == bk.MAX_TRACE_WORDS < (
        2 * huge.max_steps * 16384)
    assert bk.BigKernelConfig(16, 1024, 2048, trace=True,
                              budget=bk.MAX_TRACE_WORDS).trace_budget == (
        bk.MAX_TRACE_WORDS)
    with pytest.raises(ValueError, match="int32"):
        bk.BigKernelConfig(16, 1024, 2048, trace=True,
                           budget=bk.MAX_TRACE_WORDS + 1)
    with pytest.raises(ValueError):
        bk.BigKernelConfig(16, 1024, 2048, alpha=20)
    with pytest.raises(ValueError, match="prof_cap"):
        bk.BigKernelConfig(16, 1024, 2048, profile=True)
    for bad in (100, 128):
        with pytest.raises(ValueError, match="prof_cap"):
            bk.BigKernelConfig(16, 1024, 2048, prof_cap=bad,
                               profile=bad == 100)
    prof = bk.BigKernelConfig(16, 1024, 2048, profile=True, prof_cap=256,
                              trace=True, local_start=True)
    assert bk.library(prof) == "big_trace_profile"
    assert prof.trace_budget == bk.BigKernelConfig(
        16, 1024, 2048, trace=True, local_start=True).trace_budget
    # the JAX configuration's exclusions (big_kernel.py:218-234)
    for bad in [dict(byte_mode=True), dict(byte_mode=True, alpha=256,
                                           x_drop=True),
                dict(local_start=True, free_query_start_gaps=True),
                dict(free_query_end_gaps=True, x_drop=True)]:
        with pytest.raises(ValueError):
            bk.BigKernelConfig(16, 1024, 2048, **bad)
    for good in [dict(byte_mode=True, alpha=256, trace=True),
                 dict(byte_mode=True, alpha=256, local_start=True),
                 dict(local_start=True, x_drop=True, trace=True),
                 dict(free_query_start_gaps=True, x_drop=True),
                 dict(free_query_end_gaps=True, trace=True)]:
        cfg = bk.BigKernelConfig(16, 1024, 2048, **good)
        assert lk.wide(cfg) == bool(cfg.x_drop or cfg.free_query_end_gaps)
    for lo, hi, cap in [(32, 512, 768), (128, 1024, 11136), (1024, 1024, 2048),
                        (512, 8192, 9088)]:
        cfg = bk.BigKernelConfig(lo, hi, cap, trace=True)
        want = jbig.BigKernelConfig(batch=128, min_size=lo, max_size=hi,
                                    seq_cap=cap, trace=True)
        assert (cfg.block, cfg.max_steps) == (want.block, want.max_steps)
        assert cfg.trace_budget == want.eff_trace_slots * want.seg == (
            cfg.max_steps * max(lo, 256) + 8 * hi)
        local = bk.BigKernelConfig(lo, hi, cap, trace=True, local_start=True)
        want = jbig.BigKernelConfig(batch=128, min_size=lo, max_size=hi,
                                    seq_cap=cap, trace=True, local_start=True)
        assert local.trace_budget == (want.eff_trace_slots * want.seg
                                      * want.trace_words) == (
            2 * cfg.trace_budget)


def test_pack_big_is_pack_lane():
    pairs = dna_pairs(2, 6)
    cfg = config(pairs, (128, 1024), DNA[0], x=30)
    m, g = matrix_from_jax(DNA[0]), gaps_from_jax(DNA[1])
    got = bk.pack_big(pairs, m, cfg, g, "cpu", 30)
    want = lk.pack_lane(pairs, m, cfg, g, "cpu", 30)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], want[:4]))
    assert got.gaps == want.gaps == (-6, -2, 30)
    assert got.codes.shape == (6, 2, cfg.seq_cap)
