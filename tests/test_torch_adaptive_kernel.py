"""The port's adaptive kernel module against the JAX package: the plain
PyTorch version against ``BlockOracle`` and against the JAX adaptive kernel
(interpret mode).  Every comparison is exact: the contract is integer
arithmetic, so the tolerance is 0.  The CUDA kernel itself runs only on the
card (``chip_smoke.py`` holds it against this plain version)."""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from block_aligner_tpu import BLOSUM62, NW1, BlockOracle, Gaps, PaddedBytes
from block_aligner_tpu.ops import adaptive_kernel as jadaptive
from block_aligner_tpu.ops import lane_kernel as jlane
from block_aligner_tpu_torch import BatchAligner, gaps_from_jax, matrix_from_jax
from block_aligner_tpu_torch.ops import _build
from block_aligner_tpu_torch.ops.adaptive_kernel import (
    AdaptiveKernelConfig,
    adaptive_align,
    adaptive_align_plain,
)
from block_aligner_tpu_torch.ops.lane_kernel import (
    LaneKernelConfig,
    lane_align_plain,
    pack_lane,
)
from test_adaptive_kernel import mutate, rand_seq

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PROTEIN = (BLOSUM62, Gaps(open=-11, extend=-1))
NUC = (NW1, Gaps(open=-2, extend=-1))
EDGE = [(b"", b""), (b"", b"A"), (b"A", b""), (b"A", b"A"), (b"", b"CAT")]


def protein_pairs(seed, n):
    """Edge cases, then in turn: point mutations with 1..3 structural
    indels (the JAX package's adaptive test generators), a block inserted
    into the reference, a block inserted into the query, and an unrelated
    pair; lengths up to ~260."""
    rng = np.random.default_rng(seed)
    pairs = list(EDGE)
    while len(pairs) < n:
        q = rand_seq(rng, int(rng.integers(40, 200)))
        ins = rand_seq(rng, int(rng.integers(10, 60)))
        pos = int(rng.integers(10, len(q) - 10))
        kind = len(pairs) % 4
        if kind == 0:
            pairs.append((q, mutate(rng, q, len(q) // 10,
                                    indel=int(rng.integers(1, 4)))))
        elif kind == 1:
            pairs.append((q, q[:pos] + ins + q[pos:]))
        elif kind == 2:
            pairs.append((q[:pos] + ins + q[pos:], q))
        else:
            pairs.append((q, rand_seq(rng, int(rng.integers(0, 200)))))
    return pairs


def dna_pairs(seed, n):
    return chip_smoke.structural_pairs(np.random.default_rng(seed),
                                       chip_smoke.DNA, n, 200)


def config(pairs, size, matrix):
    maxlen = max(max(len(q), len(r)) for q, r in pairs)
    cap = max(256, -(-(1 + maxlen + size[1] + 16) // 128) * 128)
    return AdaptiveKernelConfig(size[0], size[1], cap,
                                32 if matrix.kind != "nuc" else 16)


def port_run(pairs, matrix, gaps, size, **kw):
    cfg = config(pairs, size, matrix)
    pk = pack_lane(pairs, matrix_from_jax(matrix), cfg, gaps_from_jax(gaps), "cpu")
    return adaptive_align_plain(*pk, cfg, **kw)


def oracle(q, r, matrix, gaps, size, trace=False):
    orc = BlockOracle(trace=trace)
    orc.align(PaddedBytes.from_bytes(q, size[1], matrix),
              PaddedBytes.from_bytes(r, size[1], matrix), matrix, gaps, size, 0)
    return orc


@pytest.mark.parametrize("size,setup,n", [
    ((16, 32), PROTEIN, 28), ((16, 32), NUC, 20),
    ((16, 64), PROTEIN, 28), ((16, 64), NUC, 20),
    ((32, 128), PROTEIN, 20), ((32, 128), NUC, 16),
    ((32, 256), PROTEIN, 16), ((32, 256), NUC, 12),
], ids=["16-32-protein", "16-32-dna", "16-64-protein", "16-64-dna",
        "32-128-protein", "32-128-dna", "32-256-protein", "32-256-dna"])
def test_plain_matches_block_oracle(size, setup, n):
    matrix, gaps = setup
    seed = size[0] + size[1] + n
    pairs = protein_pairs(seed, n) if matrix is BLOSUM62 else dna_pairs(seed, n)
    got = port_run(pairs, matrix, gaps, size).numpy()
    assert not got[:, 1].any()  # no pair hit the step cap
    for k, (q, r) in enumerate(pairs):
        assert int(got[k, 0]) == oracle(q, r, matrix, gaps, size).res().score, \
            (k, q, r)


def test_inputs_grow_and_shrink():
    """The generators reach both adaptive moves: of 40 protein pairs at
    (16, 64), the oracle's blocks grow in 33 and shrink in 6, and 29
    adaptive scores differ from the fixed-min-size score; the plain version
    equals the oracle on all of them."""
    pairs = protein_pairs(5, 40)
    got = port_run(pairs, *PROTEIN, (16, 64)).numpy()
    grew = shrank = differs = 0
    for k, (q, r) in enumerate(pairs):
        orc = oracle(q, r, *PROTEIN, (16, 64), trace=True)
        assert int(got[k, 0]) == orc.res().score, k
        sizes = [max(b.width, b.height) for b in orc.trace_blocks()]
        grew += any(b > a for a, b in zip(sizes[1:], sizes[2:]))
        shrank += any(b < a for a, b in zip(sizes, sizes[1:]))
        differs += orc.res().score != oracle(q, r, *PROTEIN, (16, 16)).res().score
    assert (grew, shrank, differs) == (33, 6, 29)


def test_plain_matches_jax_adaptive_kernel():
    """Scores and step-cap flags equal the JAX adaptive kernel's at
    (16, 64), run in interpret mode and fed by the JAX ``pack_lane``, as
    tests/test_adaptive_kernel.py runs it."""
    pairs = protein_pairs(17, 128)
    cfg = config(pairs, (16, 64), BLOSUM62)
    jcfg = jadaptive.AdaptiveKernelConfig(
        batch=128, min_size=16, max_size=64, seq_cap=cfg.seq_cap, alpha=32,
        banks=1, interpret=True)
    out = np.asarray(jadaptive.build_adaptive_engine(jcfg)(
        *jlane.pack_lane(pairs, BLOSUM62, jcfg, PROTEIN[1])))
    got = port_run(pairs, *PROTEIN, (16, 64)).numpy()
    assert cfg.max_steps == jcfg.max_steps
    assert np.array_equal(got[:, 0], out[:, :, 0, :].reshape(128))
    assert np.array_equal(got[:, 1], out[:, :, -1, :].reshape(128))


def test_golden_scores_match_block_oracle():
    """The adaptive scores ``chip_smoke.py`` pins on the card are the
    oracle's and the plain version's; all but the first pair and the edge
    cases grew past the fixed-min-size score."""
    n = 0
    for name, (go, ge), size, cases in chip_smoke.GOLDEN_ADAPTIVE:
        matrix, gaps = {"BLOSUM62": BLOSUM62, "NW1": NW1}[name], Gaps(go, ge)
        pairs = [(q, r) for q, r, _ in cases]
        got = port_run(pairs, matrix, gaps, size).numpy()
        for k, (q, r, want) in enumerate(cases):
            assert oracle(q, r, matrix, gaps, size).res().score == want
            assert int(got[k, 0]) == want
            fixed = oracle(q, r, matrix, gaps, (size[0], size[0])).res().score
            n += fixed != want
    assert n == 5


def test_cells_equal_the_lane_kernel_without_grows():
    """Identical sequences never grow or shrink at (16, 32), so the plain
    version computes the lane kernel's block-16 cells and score."""
    rng = np.random.default_rng(3)
    pairs = [(s, s) for s in (rand_seq(rng, int(rng.integers(1, 120)))
                              for _ in range(10))]
    out, cells = port_run(pairs, *PROTEIN, (16, 32), count_cells=True)
    lcfg = LaneKernelConfig(16, config(pairs, (16, 32), BLOSUM62).seq_cap)
    pk = pack_lane(pairs, matrix_from_jax(BLOSUM62), lcfg, Gaps(-11, -1), "cpu")
    lout, lcells = lane_align_plain(*pk, lcfg, count_cells=True)
    assert torch.equal(out[:, 0], lout[:, 0])
    assert torch.equal(cells, lcells) and bool((cells % 16 == 0).all())
    assert torch.equal(out, port_run(pairs, *PROTEIN, (16, 32)))


def test_step_cap_overrun():
    """A pair that needs more steps than the cap reports an overrun, and
    ``BatchAligner`` raises instead of returning its score."""
    pairs = [(b"A" * 200, b"A" * 200), (b"AAAA", b"AAAA")]
    cfg = chip_smoke.with_step_cap(AdaptiveKernelConfig(16, 32, 256), 20)
    pk = pack_lane(pairs, matrix_from_jax(BLOSUM62), cfg, Gaps(-11, -1), "cpu")
    got = adaptive_align_plain(*pk, cfg)
    assert got[:, 1].tolist() == [1, 0] and int(got[1, 0]) == 16
    al = BatchAligner(matrix_from_jax(BLOSUM62), Gaps(-11, -1), (16, 32),
                      batch=2, seq_cap=256, device="cpu")
    assert al.route == "adaptive"
    al.cfg = chip_smoke.with_step_cap(al.cfg, 20)
    with pytest.raises(RuntimeError, match="step cap.*seq_cap"):
        al.align_batch(pairs)


def test_wrapper_on_cpu_is_the_plain_version():
    pairs = protein_pairs(5, 12)
    cfg = config(pairs, (32, 128), BLOSUM62)
    pk = pack_lane(pairs, matrix_from_jax(BLOSUM62), cfg, Gaps(-11, -1), "cpu")
    before = adaptive_align.launches
    got = adaptive_align(*pk, cfg)
    assert adaptive_align.launches == before  # no kernel was launched
    assert got.dtype == torch.int32 and got.shape == (len(pairs), 2)
    assert torch.equal(got, adaptive_align_plain(*pk, cfg))
    empty = pack_lane([], matrix_from_jax(BLOSUM62), cfg, Gaps(-11, -1), "cpu")
    assert adaptive_align(*empty, cfg).shape == (0, 2)


def test_wrapper_raises_off_the_cpu_and_card():
    cfg = AdaptiveKernelConfig(16, 64, 256, 32)
    meta = torch.empty((4, 2, 256), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no adaptive kernel"):
        adaptive_align(meta, meta, meta, meta, (-11, -1), cfg)


def test_kernel_entry_point_matches_binding():
    """The C signature and the ctypes argument list agree (the binding
    passes 8 pointers: 5 for the inputs and the output, 3 for the trace
    buffers; 9 ints and the stream)."""
    src = (_build.CSRC / "adaptive_kernel.cu").read_text()
    sig = re.search(r'extern "C" int adaptive_align_launch\((.*?)\)', src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    assert [p.startswith(("const void*", "void*")) for p in params] == \
        [True] * 8 + [False] * 9 + [True]
    assert _build.library_path("adaptive_kernel").name.startswith(
        "libadaptive_kernel-")


def test_config_validation():
    for bad in [(32, 32, 512), (24, 64, 512), (16, 1024, 2048), (8, 32, 256),
                (64, 32, 512), (16, 64, 260), (16, 64, 64), (64, 512, 1024)]:
        with pytest.raises(ValueError):
            AdaptiveKernelConfig(*bad)
    with pytest.raises(ValueError):
        AdaptiveKernelConfig(16, 64, 256, alpha=20)
    for lo, hi, cap in [(16, 32, 256), (32, 256, 1408), (64, 128, 1024)]:
        cfg = AdaptiveKernelConfig(lo, hi, cap)
        want = jadaptive.AdaptiveKernelConfig(
            batch=128, min_size=lo, max_size=hi, seq_cap=cap, banks=1)
        assert (cfg.block, cfg.max_steps) == (want.block, want.max_steps)
