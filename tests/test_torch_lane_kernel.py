"""The port's lane kernel module against the JAX package: packing, and the
plain PyTorch version against ``BlockOracle`` and against the JAX lane
kernel (interpret mode).  Every comparison is exact: the contract is
integer arithmetic, so the tolerance is 0.  The CUDA kernel itself runs only
on the card (``chip_smoke.py`` holds it against this plain version)."""

import os
import re

import numpy as np
import pytest
import torch

from block_aligner_tpu import BLOSUM62, NW1, BlockOracle, Gaps, PaddedBytes
from block_aligner_tpu.ops import lane_kernel as jlane
from block_aligner_tpu_torch import gaps_from_jax, matrix_from_jax
from block_aligner_tpu_torch.ops import _build
from block_aligner_tpu_torch.ops.lane_kernel import (
    LaneKernelConfig,
    lane_align,
    lane_align_plain,
    pack_lane,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

AA = b"ACDEFGHIKLMNPQRSTVWY"
DNA = b"ACGT"
PROTEIN = (BLOSUM62, Gaps(open=-11, extend=-1), AA)
NUC = (NW1, Gaps(open=-2, extend=-1), DNA)
EDGE = [(b"", b""), (b"", b"A"), (b"A", b""), (b"A", b"A"), (b"AAAA", b"AARA")]


def make_pairs(seed, alphabet, n, max_len):
    """Edge cases, then pairs that are half related (substitutions and
    indels), half unrelated, with lengths 0..max_len."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    pairs = list(EDGE)
    while len(pairs) < n:
        q = rng.choice(alpha, size=int(rng.integers(0, max_len + 1)))
        if rng.random() < 0.5 or len(q) == 0:
            r = rng.choice(alpha, size=int(rng.integers(0, max_len + 1)))
        else:
            k = len(q) // 6 + 1
            r = q.copy()
            r[rng.integers(0, len(q), size=k)] = rng.choice(alpha, size=k)
            r = np.delete(r, rng.integers(0, len(r), size=k // 3))
            r = np.insert(r, rng.integers(0, len(r) + 1, size=k // 3),
                          rng.choice(alpha, size=k // 3))[:max_len]
        pairs.append((q.tobytes(), r.tobytes()))
    return pairs


def lane_cfg(pairs, S, matrix):
    maxlen = max(max(len(q), len(r)) for q, r in pairs)
    cap = max(256, -(-(1 + maxlen + S + 16) // 128) * 128)
    return cap, (32 if matrix.kind != "nuc" else 16)


def port_run(pairs, matrix, gaps, S):
    cap, alpha = lane_cfg(pairs, S, matrix)
    cfg = LaneKernelConfig(S, cap, alpha)
    pk = pack_lane(pairs, matrix_from_jax(matrix), cfg, gaps_from_jax(gaps), "cpu")
    return lane_align(*pk, cfg).numpy()


@pytest.mark.parametrize("setup", [PROTEIN, NUC], ids=["protein", "dna"])
def test_pack_matches_jax_pack_lane(setup):
    matrix, gaps, alphabet = setup
    pairs = make_pairs(3, alphabet, 40, 150) + [(b"acgt", b"ACgT")]
    cap, alpha = lane_cfg(pairs, 16, matrix)
    jcfg = jlane.LaneKernelConfig(batch=128, block=16, seq_cap=cap, alpha=alpha,
                                  banks=1, interpret=True)
    jq, jr, _, _, Mp, codes_t, jg = jlane.pack_lane(pairs, matrix, jcfg, gaps)
    cfg = LaneKernelConfig(16, cap, alpha)
    pk = pack_lane(pairs, matrix_from_jax(matrix), cfg, gaps_from_jax(gaps), "cpu")
    n = len(pairs)
    # the JAX layout is position-major with pairs in lanes: undo it
    jcodes = codes_t.transpose(0, 1, 4, 2, 3).reshape(128, 2, cap)[:n]
    assert pk.codes.dtype == torch.uint8
    assert np.array_equal(pk.codes.numpy(), jcodes.view(np.uint8))
    assert np.array_equal(pk.qlen.numpy(), jq.reshape(-1)[:n])
    assert np.array_equal(pk.rlen.numpy(), jr.reshape(-1)[:n])
    # the JAX table is biased by 128 and byte-plane ordered: row b*NG+g
    # holds matrix row 4g+b
    NG = alpha // 4
    M = np.empty((alpha, alpha), np.int32)
    for b in range(4):
        for g in range(NG):
            M[4 * g + b] = Mp[b * NG + g] - 128
    assert np.array_equal(pk.table.numpy(), M)
    assert pk.gaps == tuple(int(v) for v in jg[0, :3])  # open, extend, x


@pytest.mark.parametrize("S,setup,n,max_len", [
    (16, PROTEIN, 24, 200),
    (16, NUC, 16, 150),
    (32, PROTEIN, 24, 250),
    (32, NUC, 16, 200),
    (64, NUC, 12, 300),
    (128, PROTEIN, 10, 350),
    (512, PROTEIN, 9, 700),
], ids=["16-protein", "16-dna", "32-protein", "32-dna", "64-dna",
        "128-protein", "512-protein"])
def test_plain_matches_block_oracle(S, setup, n, max_len):
    matrix, gaps, alphabet = setup
    pairs = make_pairs(S + n, alphabet, n, max_len)
    got = port_run(pairs, matrix, gaps, S)
    oracle = BlockOracle()
    for k, (q, r) in enumerate(pairs):
        oracle.align(PaddedBytes.from_bytes(q, S, matrix),
                     PaddedBytes.from_bytes(r, S, matrix), matrix, gaps, (S, S), 0)
        assert int(got[k, 0]) == oracle.res().score, (k, q, r)


@pytest.mark.parametrize("S,setup", [(16, PROTEIN), (32, NUC)],
                         ids=["16-protein", "32-dna"])
def test_plain_matches_jax_lane_kernel(S, setup):
    """Scores and y-drop suspect flags equal the JAX kernel's, run in
    interpret mode as tests/test_lane_kernel.py runs it."""
    matrix, gaps, alphabet = setup
    pairs = make_pairs(100 + S, alphabet, 256, 180)
    cap, alpha = lane_cfg(pairs, S, matrix)
    jcfg = jlane.LaneKernelConfig(batch=256, block=S, seq_cap=cap, alpha=alpha,
                                  banks=2, interpret=True)
    out = np.asarray(jlane.build_lane_engine(jcfg)(
        *jlane.pack_lane(pairs, matrix, jcfg, gaps)))
    want_score = out[:, :, 0, :].reshape(256)
    want_susp = out[:, :, -1, :].reshape(256)
    got = port_run(pairs, matrix, gaps, S)
    assert 0 < want_susp.sum() < 256  # both flag values occur
    assert np.array_equal(got[:, 0], want_score)
    assert np.array_equal(got[:, 1], want_susp)


def test_wrapper_on_cpu_is_the_plain_version():
    pairs = make_pairs(5, AA, 12, 90)
    cap, alpha = lane_cfg(pairs, 32, BLOSUM62)
    cfg = LaneKernelConfig(32, cap, alpha)
    pk = pack_lane(pairs, matrix_from_jax(BLOSUM62), cfg, Gaps(-11, -1), "cpu")
    before = lane_align.launches
    got = lane_align(*pk, cfg)
    assert lane_align.launches == before  # no kernel was launched
    assert got.dtype == torch.int32 and got.shape == (len(pairs), 2)
    assert torch.equal(got, lane_align_plain(*pk, cfg))
    empty = pack_lane([], matrix_from_jax(BLOSUM62), cfg, Gaps(-11, -1), "cpu")
    assert lane_align(*empty, cfg).shape == (0, 2)


def test_wrapper_raises_off_the_cpu_and_card():
    cfg = LaneKernelConfig(16, 256, 32)
    meta = torch.empty((4, 2, 256), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no lane kernel"):
        lane_align(meta, meta, meta, meta, (-11, -1), cfg)


def test_kernel_entry_point_matches_binding():
    """The C signature and the ctypes argument list agree (the binding
    passes 8 pointers: 5 for the inputs and the output, 3 for the trace
    buffers; 11 ints (8, then the flags and byte mode's match and mismatch
    scores) and the stream)."""
    src = (_build.CSRC / "lane_kernel.cu").read_text()
    sig = re.search(r'extern "C" int lane_align_launch\((.*?)\)', src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    assert [p.startswith(("const void*", "void*")) for p in params] == \
        [True] * 8 + [False] * 11 + [True]
    assert _build.library_path("lane_kernel").parent == _build.BUILD
    assert _build.library_path("lane_kernel").name.startswith("liblane_kernel-")


def test_config_and_pack_validation():
    for bad in [dict(block=24, seq_cap=256), dict(block=1024, seq_cap=2048),
                dict(block=16, seq_cap=260), dict(block=16, seq_cap=16),
                dict(block=16, seq_cap=256, alpha=20)]:
        with pytest.raises(ValueError):
            LaneKernelConfig(**bad)
    cfg = LaneKernelConfig(16, 256, 32)
    assert cfg.max_steps == 2 * 256 // 8 + 16 // 8 + 2
    m = matrix_from_jax(BLOSUM62)
    with pytest.raises(ValueError, match="too long"):
        pack_lane([(b"A" * 240, b"A")], m, cfg, Gaps(-11, -1), "cpu")
    with pytest.raises(ValueError, match="A..Z"):
        pack_lane([(b"AC1", b"A")], m, cfg, Gaps(-11, -1), "cpu")
