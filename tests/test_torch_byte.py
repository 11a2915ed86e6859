"""ByteMatrix scoring in the port against the JAX package: both kernels'
plain versions against ``BlockOracle`` with ``ByteMatrix`` on pairs over
all 256 byte values (byte 0, the padding code, included) and the JAX
package's golden pair, with and without trace (CIGARs equal as strings),
``BatchAligner(BYTES1)`` against the JAX ``BatchAligner`` on the three
configurations of ``tests/test_lane_kernel.py::test_lane_byte_matrix_modes``,
``convert.py`` carrying a ``ByteMatrix`` across, and the rejections.  The
tolerance is 0.  The CUDA kernels run only on the card (``chip_smoke.py``);
``test_torch_kernel_sources.py`` holds their byte instances against these
plain versions here."""

import os

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
import chip_smoke
from block_aligner_tpu_torch.ops import lane_kernel as lk
from test_torch_trace import check_against_oracle

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GAPS = jba.Gaps(-11, -1)


def pairs_of(seed, n=14, max_len=90):
    """``chip_smoke.byte_pairs``: the golden pair, runs of byte 0, then
    random pairs over all 256 bytes."""
    return chip_smoke.byte_pairs(np.random.default_rng(seed), n, max_len)


def jax_modes_pairs():
    """The pairs of ``tests/test_lane_kernel.py::test_lane_byte_matrix_modes``
    (seed 5: random bytes with a quarter of them changed, and the
    case-sensitive golden pair)."""
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(12):
        n = int(rng.integers(10, 90))
        q = bytes(rng.integers(0, 256, size=n, dtype=np.uint8).tolist())
        r = bytearray(q)
        for _ in range(n // 4):
            r[int(rng.integers(0, len(r)))] = int(rng.integers(0, 256))
        pairs.append((q, bytes(r)))
    pairs.append((b"AAAAAA", b"AAAaaA"))
    return pairs


def fields(results):
    return [(r.score, r.query_idx, r.reference_idx) for r in results]


# scores large enough to reach the upper i16 rail within a block's un-rebased
# columns
RAIL = jba.ByteMatrix(100, -1)


def rail_pairs():
    """The lane route's rail pair, 400 A against 400 A at (512, 512): the
    first 64 steps have no rebase, so D saturates at 32767 and the score is
    32767 - 16384 = 16383, not 40000.  The adaptive route's, at (16, 512)
    with trace: 450 A against 100 A, 260 random letters and 350 A; the
    blocks grow past the insert from the checkpoint before it, and the grow
    rect's matches gain more than 16383 over its offset."""
    rng = np.random.default_rng(1)
    mid = rng.choice(np.frombuffer(b"CDEFGHIKLMNP", np.uint8), 260)
    return ((b"A" * 400, b"A" * 400),
            (b"A" * 450, b"A" * 100 + mid.tobytes() + b"A" * 350))


@pytest.mark.parametrize("size", [(16, 16), (32, 32), (16, 32), (16, 64)],
                         ids=["16", "32", "16-32", "16-64"])
def test_plain_matches_oracle(size):
    """Scores of both plain versions equal ``BlockOracle``'s with
    ``BYTES1``; padding against padding and against a sequence's own byte 0
    scores as a match, as in the reference."""
    pairs = pairs_of(sum(size))
    al = tba.BatchAligner(tba.BYTES1, tba.gaps_from_jax(GAPS), size,
                          batch=len(pairs), seq_cap=128, device="cpu")
    assert al.route == ("lane" if size[0] == size[1] else "adaptive")
    assert al.cfg.byte_mode and al.cfg.alpha == 256
    got = al.align_batch(pairs)
    orc = jba.BlockOracle()
    for k, (q, r) in enumerate(pairs):
        orc.align(jba.PaddedBytes.from_bytes(q, size[1], jba.BYTES1),
                  jba.PaddedBytes.from_bytes(r, size[1], jba.BYTES1),
                  jba.BYTES1, GAPS, size, 0)
        assert fields(got[k : k + 1]) == fields([orc.res()]), (k, q, r)
    assert got[0].score == 2  # the golden pair: 4 matches, 2 case mismatches


@pytest.mark.parametrize("size", [(16, 16), (16, 64)],
                         ids=["lane", "adaptive"])
def test_plain_trace_matches_oracle(size):
    """Trace CIGARs, =/X CIGARs (bytes compared as they are) and the batch
    walk equal ``BlockOracle(trace=True)``'s."""
    check_against_oracle(pairs_of(size[1] + 3), size, matrix=jba.BYTES1,
                         gaps=GAPS)


@pytest.fixture(scope="module", params=[((16, 16), False), ((16, 32), False),
                                        ((16, 16), True)],
                ids=["lane", "adaptive", "lane-trace"])
def jax_byte(request):
    """The JAX BatchAligner(BYTES1) on the three configurations of its own
    byte test, with CIGARs in trace mode."""
    size, trace = request.param
    pairs = jax_modes_pairs()
    al = jba.BatchAligner(jba.BYTES1, GAPS, size, batch=128, seq_cap=128,
                          trace=trace)
    res = al.align_batch(pairs)
    cig = [str(al.cigar(k, r.query_idx, r.reference_idx))
           for k, r in enumerate(res)] if trace else None
    return size, trace, pairs, res, cig


def test_batch_aligner_matches_jax(jax_byte):
    """align_batch, align_all and (in trace mode) cigar, cigar_eq against
    the JAX aligner's results and CIGARs; the =/X CIGAR of the golden pair
    compares bytes, so case counts."""
    size, trace, pairs, want, cig = jax_byte
    al = tba.BatchAligner(tba.matrix_from_jax(jba.BYTES1),
                          tba.gaps_from_jax(GAPS), size, batch=8,
                          seq_cap=128, trace=trace, device="cpu")
    assert fields(al.align_all(pairs, sort=not trace)) == fields(want)
    al = tba.BatchAligner(tba.BYTES1, tba.gaps_from_jax(GAPS), size,
                          batch=len(pairs), seq_cap=128, trace=trace,
                          device="cpu")
    got = al.align_batch(pairs)
    assert fields(got) == fields(want)
    if trace:
        ends = [(r.query_idx, r.reference_idx) for r in got]
        assert [str(al.cigar(k, i, j)) for k, (i, j) in enumerate(ends)] == cig
        assert [str(c) for c in al.trace().cigars_all(ends)] == cig
        assert str(al.cigar_eq(len(pairs) - 1, *pairs[-1], 6, 6)) == "3=2X1="


def test_convert_carries_byte_matrix():
    """``matrix_from_jax`` carries a JAX ByteMatrix's scores across; the
    port's ``ByteMatrix`` converts and scores as the JAX one."""
    m = tba.matrix_from_jax(jba.ByteMatrix(3, -7))
    assert isinstance(m, tba.ByteMatrix)
    assert (m.match_score, m.mismatch_score, m.NULL) == (3, -7, 0)
    seq = bytes(range(256))
    assert np.array_equal(m.convert(seq), jba.ByteMatrix(3, -7).convert(seq))
    assert np.array_equal(m.lut[np.frombuffer(seq, np.uint8)],
                          np.arange(256))
    for a, b in ((0, 0), (0, 65), (97, 65), (255, 255)):
        assert m.get(a, b) == jba.ByteMatrix(3, -7).get(a, b)


def test_packing_and_rejections():
    """Byte mode packs raw bytes with byte 0 as padding and no table, and
    carries the scores beside the gaps; x-drop with ByteMatrix and a
    matrix that does not fit the configuration's mode raise."""
    cfg = lk.LaneKernelConfig(16, 256, 256, byte_mode=True)
    pk = lk.pack_lane([(b"\x00\xffA", b"a")], tba.ByteMatrix(2, -3), cfg,
                      tba.Gaps(-11, -1), "cpu")
    assert pk.codes[0, 0, :5].tolist() == [0, 0, 255, 65, 0]
    assert pk.codes[0, 1, :3].tolist() == [0, 97, 0]
    assert pk.table.numel() == 0 and pk.gaps == (-11, -1, 0, 2, -3)
    with pytest.raises(ValueError, match="byte_mode"):
        lk.pack_lane([(b"A", b"A")], tba.BLOSUM62, cfg, tba.Gaps(-11, -1),
                     "cpu")
    with pytest.raises(ValueError, match="ByteMatrix"):
        tba.BatchAligner(tba.BYTES1, tba.Gaps(-11, -1), (16, 16), x_drop=5,
                         device="cpu")
    for bad in (dict(alpha=32, byte_mode=True), dict(alpha=256),
                dict(alpha=256, byte_mode=True, x_drop=True),
                dict(alpha=256, byte_mode=True, profile=True)):
        with pytest.raises(ValueError):
            lk.LaneKernelConfig(16, 256, **bad)


def test_upper_rail():
    """Both rail pairs (``rail_pairs``) give ``BlockOracle``'s scores, which
    saturate at the upper i16 rail as the reference's adds do (a one-sided
    clamp gives 40000 and 44730): the lane route through ``BatchAligner``,
    the adaptive route traced, its CIGAR the oracle's."""
    lane, grow = rail_pairs()
    al = tba.BatchAligner(tba.matrix_from_jax(RAIL), tba.gaps_from_jax(GAPS),
                          (512, 512), batch=1, seq_cap=400, device="cpu")
    orc = jba.BlockOracle()
    orc.align(*(jba.PaddedBytes.from_bytes(s, 512, RAIL) for s in lane),
              RAIL, GAPS, (512, 512), 0)
    assert al.route == "lane"
    assert al.align_batch([lane])[0].score == orc.res().score == 16383
    tr, _ = check_against_oracle([grow], (16, 512), matrix=RAIL)
    assert int(tr.desc[:, 0, 3].max()) == 512
