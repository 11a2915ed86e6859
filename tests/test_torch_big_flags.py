"""ByteMatrix and the local-start, free-query-start-gap and free-query-end-gap
flags on the big route: ``big_align_plain`` against ``BlockOracle`` for byte
mode and each flag, global, x-drop where the flag allows it, and traced, at
(128, 1024), (1024, 1024) and (32, 512); ``BatchAligner`` on blocks past
512 against the JAX package's (its big kernel in interpret mode) with a
ByteMatrix and with local start, traced; a dense local-start trace
compacted into the block-sized layout (two words a row); and a reduced
trace budget that local-start pairs overrun.  Every comparison is exact:
results equal, CIGARs equal as strings.  The CUDA kernel runs only on the
card (``chip_smoke.py`` holds its FLAGS instances against this plain
version; ``test_torch_kernel_sources.py`` runs their source here)."""

import os

import numpy as np
import pytest
import torch

import block_aligner_tpu as jba
import block_aligner_tpu_torch as tba
import chip_smoke
from block_aligner_tpu_torch.core.traceback import Trace
from block_aligner_tpu_torch.ops import big_kernel as bk
from block_aligner_tpu_torch.ops import lane_kernel as lk
from block_aligner_tpu_torch.ops._trace import compact_trace
from test_big_trace import mutate, rand_seq
from test_torch_trace import indel_pairs, oracle_runs, plain_trace

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PROTEIN = (jba.BLOSUM62, jba.Gaps(-11, -1))
BYTE = (jba.BYTES1, jba.Gaps(-2, -1))
LOCAL = dict(local_start=True)
FSTART = dict(free_query_start_gaps=True)
FEND = dict(free_query_end_gaps=True)


def big_plain(pairs, size, matrix, gaps, flags, x=None, trace=False,
              budget=None):
    """``big_align_plain`` on ``pairs`` with ``flags``: (its result, the
    host ``Trace`` of a traced run or None, the end positions)."""
    pm = tba.matrix_from_jax(matrix)
    byte = matrix.kind == "byte"
    maxlen = max(max(len(q), len(r)) for q, r in pairs)
    cap = max(256, -(-(1 + maxlen + size[1] + 16) // 128) * 128)
    cfg = bk.BigKernelConfig(*size, cap, 256 if byte else 32,
                             x_drop=x is not None, trace=trace,
                             byte_mode=byte, **flags)
    if budget:
        cfg = chip_smoke.with_trace_budget(cfg, budget)
    pk = bk.pack_big(pairs, pm, cfg, tba.gaps_from_jax(gaps), "cpu", x or 0)
    res = bk.big_align_plain(*pk, cfg)
    out = res[0] if trace else res
    tr = chip_smoke.block_trace(res, pm, cfg) if trace else None
    ends = ([(int(o[1]), int(o[2])) for o in out] if lk.wide(cfg)
            else [(len(q), len(r)) for q, r in pairs])
    return res, tr, ends


def homologs(seed, n, max_len):
    return chip_smoke.structural_pairs(np.random.default_rng(seed),
                                       chip_smoke.AA, n, max_len)


# (mode, size, x, trace, pairs): each mode at two sizes or more, traced and
# not, x-drop where the mode allows it, and the (32, 512) band that takes
# the big route without trace.  At (1024, 1024) a pair with x-drop or free
# end gaps has no freeze, so its first rect runs all 1024 columns in the
# oracle (about half a minute a pair here): those modes run at the other
# sizes.
CASES = [
    ("byte", (128, 1024), None, False, 8),
    ("byte", (1024, 1024), None, True, 9),
    ("byte", (32, 512), None, False, 8),
    ("local", (128, 1024), None, True, 6),
    ("local", (128, 1024), 50, True, 6),
    ("local", (1024, 1024), None, False, 7),
    ("local", (32, 512), 20, False, 8),
    ("fstart", (128, 1024), 20, False, 6),
    ("fstart", (128, 1024), None, True, 6),
    ("fstart", (1024, 1024), None, True, 7),
    ("fend", (128, 1024), None, False, 8),
    ("fend", (128, 1024), None, True, 6),
    ("fend", (32, 512), None, False, 8),
]
MODES = {"byte": {}, "local": LOCAL, "fstart": FSTART, "fend": FEND}


@pytest.mark.parametrize("mode,size,x,trace,n", CASES,
                         ids=[f"{m}-{s[0]}-{s[1]}" + (f"-x{x}" if x else "")
                              + ("-trace" if t else "")
                              for m, s, x, t, _ in CASES])
def test_plain_matches_oracle(mode, size, x, trace, n):
    """Scores and end positions equal ``BlockOracle``'s with the same mode;
    traced, the CIGARs (local start's zero bits and free start gaps'
    row-0 stop included), the =/X CIGARs and the batch walk equal its
    walk.  Byte pairs span all 256 bytes, byte 0 included; free end gaps
    take queries shorter than the min size."""
    flags = MODES[mode]
    seed = size[0] + len(mode) + (x or 0) + trace
    max_len = 250 if size[0] == 1024 else 500
    if mode == "byte":
        matrix, gaps = BYTE
        pairs = chip_smoke.byte_pairs(np.random.default_rng(seed), n,
                                      max_len)
    else:
        matrix, gaps = PROTEIN
        pairs = homologs(seed, n, max_len)
    if mode == "fend":
        pairs = [(q[: size[0] - 1], r) for q, r in pairs]
    res, tr, ends = big_plain(pairs, size, matrix, gaps, flags, x, trace)
    out = res[0] if trace else res
    assert not out[:, -1].any()  # no pair hit the step cap
    for k, (want, orc) in enumerate(oracle_runs(pairs, size, x, matrix, gaps,
                                                flags)):
        i, j = ends[k]
        assert (int(out[k, 0]), i, j) == (
            want.score, want.query_idx, want.reference_idx), k
        if trace:
            assert str(tr.cigar(k, i, j)) == str(orc.cigar(i, j)), k
            pq, pr = (jba.PaddedBytes.from_bytes(s, size[1], matrix)
                      for s in pairs[k])
            assert str(tr.cigar_eq(k, *pairs[k], i, j)) == str(
                orc.cigar_eq(pq, pr, i, j)), k
    if trace:
        assert [str(c) for c in tr.cigars_all(ends)] == [
            str(tr.cigar(k, *e)) for k, e in enumerate(ends)]
    if x is not None:  # x-drop ends some pairs short of their ends
        assert any(i < len(q) or j < len(r)
                   for (i, j), (q, r) in zip(ends, pairs))


def byte_pairs():
    """JAX ``test_big_trace_byte_mode``'s pairs: 300 lowercase letters and
    the same with 30 substitutions, and two overlapping cuts."""
    rng = np.random.default_rng(17)
    base = bytes(rng.integers(97, 123, size=300).tolist())
    r = bytearray(base)
    for _ in range(30):
        r[int(rng.integers(0, len(r)))] = int(rng.integers(97, 123))
    return [(base, bytes(r)), (base[:250], base[10:230])]


def local_pairs():
    """A protein and a mutated copy with indels, and a read whose first
    200 residues are foreign to its reference, so local start drops
    them."""
    rng = np.random.default_rng(5)
    q = rand_seq(rng, 250)
    return [(q, mutate(rng, q, 25, indel=1)),
            (rand_seq(rng, 200) + q[50:200], q[20:220])]


@pytest.mark.parametrize("matrix,gaps,size,flags,pairs", [
    (jba.BYTES1, jba.Gaps(-2, -1), (32, 1024), {}, byte_pairs),
    (jba.BLOSUM62, jba.Gaps(-11, -1), (64, 1024), LOCAL, local_pairs),
], ids=["byte", "local-start"])
def test_batch_aligner_matches_jax(matrix, gaps, size, flags, pairs):
    """The slice as a whole, traced: the port's ``BatchAligner`` on the big
    route gives the JAX package's results and ``align_all_trace(eq=True)``
    CIGARs, through ``align_all_trace``, a staged batch and ``cigar``."""
    pairs = pairs()
    jal = jba.BatchAligner(matrix, gaps, size, batch=8, seq_cap=512,
                           trace=True, **flags)
    assert jal._big
    want, want_cig = jal.align_all_trace(pairs, eq=True)
    fields = [(r.score, r.query_idx, r.reference_idx) for r in want]
    al = tba.BatchAligner(tba.matrix_from_jax(matrix), tba.gaps_from_jax(gaps),
                          size, batch=8, seq_cap=512, trace=True,
                          device="cpu", **flags)
    assert al.route == "big" and al.cfg.trace
    res, cig = al.align_all_trace(pairs, eq=True)
    assert [(r.score, r.query_idx, r.reference_idx) for r in res] == fields
    assert [str(c) for c in cig] == [str(c) for c in want_cig]
    got = al.align_staged(al.stage(pairs))
    assert [(r.score, r.query_idx, r.reference_idx) for r in got] == fields
    for k, (s, i, j) in enumerate(fields):
        assert str(al.cigar(k, i, j)) == str(jal.cigar(k, i, j)), k


def test_compacted_dense_local_trace_decodes_alike():
    """A dense adaptive local-start trace (two words a row), compacted by
    ``compact_trace`` into the block-sized layout, walks to the same CIGARs
    and rects: a step's words are its h trace words, then its h zero
    words."""
    pairs = indel_pairs(67)
    _, tr, ends = plain_trace(pairs, (16, 32), flags=LOCAL)
    ran = np.arange(tr.desc.shape[0])[:, None] < tr.steps
    budget = 2 * int((tr.desc[:, :, 3] * ran).sum(0).max())
    words, desc, used = compact_trace(torch.from_numpy(tr.words),
                                      torch.from_numpy(tr.desc),
                                      torch.from_numpy(tr.steps), budget, 2)
    assert int(used.max()) == budget
    off = np.arange(len(pairs))[None, :] * budget + desc[:, :, 4].numpy()
    ct = Trace(words.numpy(), desc.numpy(), tr.steps, tr.matrix, offsets=off,
               local_start=True)
    assert [str(c) for c in ct.cigars_all(ends)] == [
        str(c) for c in tr.cigars_all(ends)]
    for k, (i, j) in enumerate(ends):
        assert str(ct.cigar(k, i, j)) == str(tr.cigar(k, i, j)), k
        assert ct.blocks(k) == tr.blocks(k), k
    # a local start stops some walks short of the origin
    assert any(sum(o.len for o in c.to_vec()) < i + j
               for c, (i, j) in zip(ct.cigars_all(ends), ends))


def test_local_trace_budget_overruns():
    """Local start's trace takes two words a row: the budget counts both.
    Under 2400 words a pair the longer pairs stop with the overrun flag at
    the step whose 2 h words would pass it, and the short ones finish with
    their results and CIGARs unchanged; ``BatchAligner`` raises on an
    overrun."""
    pairs = homologs(4, 7, 300)
    full, tr, ends = big_plain(pairs, (64, 1024), *PROTEIN, LOCAL, trace=True)
    cut, ctr, _ = big_plain(pairs, (64, 1024), *PROTEIN, LOCAL, trace=True,
                            budget=2400)
    over = cut[0][:, -1].numpy().astype(bool)
    assert 0 < over.sum() < len(pairs) and int(cut[4].max()) <= 2400
    for b in np.flatnonzero(over):
        t = int(cut[3][b])
        assert t < int(full[3][b]) and int(full[2][t, b, 4]) == int(cut[4][b])
        assert int(cut[4][b]) + 2 * int(full[2][t, b, 3]) > 2400
    ok = np.flatnonzero(~over)
    assert torch.equal(cut[0][ok], full[0][ok])
    assert [str(ctr.cigar(k, *ends[k])) for k in ok] == [
        str(tr.cigar(k, *ends[k])) for k in ok]
    al = tba.BatchAligner(tba.BLOSUM62, tba.Gaps(-11, -1), (64, 1024),
                          trace=True, seq_cap=300, local_start=True,
                          device="cpu")
    assert al.cfg.trace_budget == 2 * bk.BigKernelConfig(
        64, 1024, al.cfg.seq_cap, trace=True).trace_budget
    al.cfg = chip_smoke.with_trace_budget(al.cfg, 2400)
    with pytest.raises(RuntimeError, match="trace budget"):
        al.align_batch(pairs)
