"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each reported on its own line:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile ``block_aligner_tpu_torch/csrc/{lane,adaptive}_kernel.cu``
   into ``build/`` (keyed on the sources), one ``nvcc`` each, and beside
   them one ``nvcc -Xptxas -v`` each for the registers, stack and spills
   of every kernel instance, all four started together; load the builds;
3. lane kernel vs plain: the lane kernel against its plain PyTorch version
   on the card, exact equality of score and suspect flag at blocks 16..512
   on seeded random protein and DNA pairs, and the reference's golden
   scores; then in x-drop mode (protein x 50, DNA x 100), equality of all
   four outputs (best score, its position, suspect), with the count of
   pairs whose best lies short of (qlen, rlen);
4. adaptive kernel vs plain: the adaptive kernel against its plain version,
   exact equality of score and overrun flag at ladders (16, 32) .. (64,
   256) on seeded protein and DNA pairs (lengths 0..600, half of them
   with structural indels), once more with a step cap low
   enough to overrun, and pinned adaptive scores that
   ``tests/test_torch_adaptive_kernel.py`` holds against ``BlockOracle``;
   then the same ladders and a capped run in x-drop mode, as in phase 3;
5. lane main path: 16384 random protein pairs 1000x1000 with k=100
   mutations (``bench.rand_protein_pairs``, seed 1234), BLOSUM62, gaps
   -11/-1, block 32, through ``BatchAligner.stage`` + ``align_staged`` and
   through ``align_all`` on twice as many pairs;
6. adaptive main path: the package's default size (32, 256) on 7000
   Uniclust30-style homolog pairs (``examples_tpu/common.py::load_uc_pairs``,
   seed 1234) through ``stage`` + ``align_staged`` and ``align_all``, and on
   16384 random protein pairs 1000x1000 k=100 (seed 1234);
7. ``align_exp_all`` at (32, 256) on 1024 of those homolog pairs, with the
   256-256 lane score as the target (and 8 unreachable targets, so the last
   level runs): every result must equal a direct ``BatchAligner`` run at the
   min size it reports;
8. lane x-drop main path: the JAX package's x-drop workload
   (``examples_tpu/run_results.py::bench_xdrop``): 8192 protein pairs of
   800..999 residues with len/10 substitutions (seed 7), BLOSUM62 -11/-1,
   x_drop 50, size (32, 32), seq_cap 1100, through ``stage`` +
   ``align_staged`` and ``align_all``;
9. adaptive x-drop main path: the reference's ``x_drop_accuracy``
   configuration (``examples_tpu/x_drop_accuracy.py``): 8192 DNA pairs of
   300 bases with 30 edits (seed 1234), ``NucMatrix.new_simple(1, -1)``,
   gaps -2/-1, x_drop 50, size (32, 64); and the default size (32, 256)
   with x_drop 50 on the 7000 homolog pairs of phase 6;
10. ``align_exp_all`` with x_drop 50 at (32, 256) on the 1024 pairs of
   phase 7, the target the x-drop 256-256 lane score, checked as there;
11. the trace instances of both kernels against their plain versions: lane
   blocks 16..512 and adaptive ladders (16, 32) .. (64, 256) and (32,
   512), global and x-drop, on seeded protein and DNA pairs (at (32, 512)
   with pairs that grow to 512), and a capped adaptive run: equal
   outputs, step counts, descriptors of every executed step and words
   inside each step's height, and equal CIGARs walked from the two; the
   adaptive runs must emit checkpoint saves and grow restores;
12. lane trace main paths, the JAX package's traced short-read workloads
   (``examples_tpu/run_results.py::bench_short_reads``, seed 77):
   ``NucMatrix.new_simple(2, -4)``, gaps -6/-2, size (32, 32), 8192
   nanopore-like pairs of 800..999 bases with 10% edits (seq_cap 1100) and
   16384 Illumina-like pairs of 100..150 bases with 1% edits (seq_cap
   180);
13. the lane x-drop trace main path: phase 8's pairs with trace;
14. adaptive trace main paths on the homolog pairs of phase 6 in batches
   of 2048: (32, 256) (the reference's traced uc_bench row), (32, 512)
   and (32, 256) with x_drop 50.

On every main path the kernels must have launched (their counts are set to
0 just before the path and read just after) and every result must equal
the plain version's; kernel times come from CUDA events, packing is timed
apart.  A trace main path runs ``align_all_trace``; its results must
equal the non-trace instance's (none exists at max size 512), every CIGAR
must sum to its end position and rescore to its score, and the first 512
must equal those walked from the plain version's trace; pack, the trace's
copy-back and the walk are timed on the host clock.  The line before the last is a JSON summary of the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises, so the
script exits non-zero and prints no result.  It needs the repository around
it and a CUDA device; without either it fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
DNA = np.frombuffer(b"ACGT", dtype=np.uint8)

# the reference's hand-checked fixed-block scores (reference:
# src/scan_block.rs:1902-1940, src/lib.rs:8-35): (matrix, gaps, block, pairs)
GOLDEN = [
    ("BLOSUM62", (-11, -1), 16, [
        (b"", b"", 0), (b"", b"AAAA", -14), (b"AAAA", b"", -14),
        (b"AARA", b"AAAA", 11), (b"AARAAAA", b"AAAAAAAA", 12),
        (b"AAAA", b"AAAA", 16), (b"RRRR", b"AAAA", -4), (b"AAA", b"AAAA", 1),
    ]),
    ("NW1", (-2, -1), 16, [
        (b"ATAA", b"AAAN", 0), (b"A" * 32, b"A" * 32, 32),
        (b"T" * 32, b"A" * 32, -32), (b"TA" * 16, b"A" * 32, 0),
        (b"TTTTTTTTAAAAAAATTTTTTTTT", b"TTAAAAAAATTTTTTTTTTTT", 7),
        (b"C", b"AAAA", -5), (b"AAAA", b"C", -5),
    ]),
    # the README example at block 32
    ("NW1", (-2, -1), 32, [
        (b"TTTTTTTTAAAAAAATTTTTTTTT", b"TTAAAAAAATTTTTTTTTTTT", 7),
    ]),
]

# adaptive scores pinned from BlockOracle (tests/test_torch_adaptive_kernel.py
# asserts them): (matrix, gaps, (min, max), pairs).  All but the first and
# the edge cases score higher than the oracle at the fixed min size, so
# their blocks grew.
GOLDEN_ADAPTIVE = [
    ("BLOSUM62", (-11, -1), (16, 32), [
        (b"CAGGATTAGCGGATCACG", b"CTGGAGTCTTTTAGCGGATCACGC", 77),
        (b"QCFHHWSWYCDVCEEWIGELNTPYDLNQAFLCYPSMNHHDFSKTGRVTFIGS",
         b"QCFGHWSGYCDVCEEWIGELGTISILLLLYFVECHFPEPTDLNQAFLCYPSMNHHDCSKTGR"
         b"VTFILS", 235),
        (b"AARILQNQDSTNIGKSNEGEKGDPRHDKGIFADTMMEQSWGAYVNYCNPFFMIMFKGMPLMG",
         b"ITRPLPVWSMFDIPEPTIARILQNQDSTNIGKSNEGEKGDPRHLFGIFADTMMEWSWGAYVNY"
         b"CNPFFMDMFKGMPLMG", 275),
    ]),
    ("BLOSUM62", (-11, -1), (16, 64), [
        (b"AQENVQTILMHKGNVPLQETIEHFKHKWSPVDRHSRVFERYWVWALFHQESDFCITCHVFHVWD"
         b"CDYGATFDQFTWHVSQMDMRHYIQ",
         b"AQENVQTILMHKGNVPLQETIEHFKHKWSPVDRHSRPFERYWVWALVFHVKHCDYGATFDQFTW"
         b"HVSRMDMRHYIQ", 386),
    ]),
    ("BLOSUM62", (-11, -1), (32, 256), [
        (b"CWDYANARQSEKVYSQRNQSWEMDGCRDDPGHAAYNGYVLVFMERNHEKLWKYGCFTSSLKTAV"
         b"LNQADMNTWEDLQPIMSI",
         b"CWDYANARQPEKVYSQRNHSWELDGCRDDPGSSLKTAVLNQADMNTWEDLQPIMSI", 260),
        (b"", b"", 0), (b"A", b"", -11), (b"", b"ACGT", -14),
    ]),
    ("NW1", (-2, -1), (16, 64), [
        (b"GAGCAGGATATCCGGAACGAGCAACATTAGCGCTAGCACTCGGCTTCAGGAATGCTTC",
         b"GAGCAGGATATCCGGAACGAGCAACATTAGCGCTAGCACTGTAGTATTGCAGCTAACTCATTTG"
         b"ACATTGCTGGCGGCTTCAGGAATGCTTC", 23),
        (b"", b"ACGT", -5),
    ]),
]

# The least time for a kernel's work: bytes over the memory rate, integer
# operations over the int32 rate.  3.35 TB/s is the H100 SXM's HBM rate
# (NVIDIA's data sheet).  A Hopper SM issues 64 int32 operations per clock
# (four sub-partitions of 16 INT32 lanes; NVIDIA's Hopper architecture white
# paper); the SM count and the maximum SM clock are read from the card.
# A DP cell of the recurrence needs 12 int32 adds and maxes, whatever the
# kernel's layout: the score add (its clamp is absorbed by the merge with
# C, which is never below the rail); for C two adds, one max and one clamp
# (the two clamps fold into one); the merge max(D, C); a serial max-plus
# scan's add, add and max; the zero correction; the final merge and the
# rect maximum.  Carries between a kernel's scan segments are its own cost.
HBM_BYTES_PER_S = 3.35e12
INT32_PER_SM_CLOCK = 64
OPS_PER_CELL = 12
# x-drop adds the 16-residue tracker: the cell's max into its residue's
# running max, and the compare that says whether the cell reached it
OPS_PER_CELL_XDROP = OPS_PER_CELL + 2


# trace adds, per cell: the four compares of its bits (D == C, D == R,
# C == C_open, R == D_open), the shift that hands the R bit to the row
# below, and the shift and or that put the cell's bits into its word
OPS_PER_CELL_TRACE = 7


def random_pairs(rng, alphabet, n, max_len):
    """Half related (substitutions and indels), half unrelated pairs, with
    lengths 0..max_len, plus empty and length-1 sequences."""
    pairs = [(b"", b""), (b"", b"A"), (b"A", b""), (b"A", b"A")]
    while len(pairs) < n:
        q = rng.choice(alphabet, size=int(rng.integers(0, max_len + 1)))
        if rng.random() < 0.5 or len(q) == 0:
            r = rng.choice(alphabet, size=int(rng.integers(0, max_len + 1)))
        else:
            k = len(q) // 8 + 1
            r = q.copy()
            r[rng.integers(0, len(q), size=k)] = rng.choice(alphabet, size=k)
            r = np.delete(r, rng.integers(0, len(r), size=k // 4))
            r = np.insert(r, rng.integers(0, len(r) + 1, size=k // 4),
                          rng.choice(alphabet, size=k // 4))[:max_len]
        pairs.append((q.tobytes(), r.tobytes()))
    return pairs


def xdrop_protein_pairs(rng, n):
    """The JAX package's x-drop workload (examples_tpu/run_results.py::
    bench_xdrop, seed 7 there): protein pairs of 800..999 residues, the
    reference a copy of the query with len/10 random substitutions."""
    aa = list(b"ACDEFGHIKLMNPQRSTVWY")
    pairs = []
    for _ in range(n):
        k = int(rng.integers(800, 1000))
        q = bytes(rng.choice(aa, size=k).tolist())
        r = bytearray(q)
        for _ in range(k // 10):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(aa))
        pairs.append((q, bytes(r)))
    return pairs


def short_read_pairs(rng):
    """The JAX package's traced short-read workloads
    (examples_tpu/run_results.py::bench_short_reads, seed 77 there), drawn
    in its order: 16384 Illumina-like pairs of 100..150 bases with 1%
    edits, then 8192 nanopore-like pairs of 800..999 bases with 10% edits;
    each pair is (mutated copy, original)."""
    dna = b"ACGT"

    def mutated(n, err):
        r = bytes(rng.choice(list(dna), size=n).tolist())
        q = bytearray(r)
        for _ in range(max(1, int(n * err))):
            op = int(rng.integers(0, 3))
            pos = int(rng.integers(0, max(len(q), 1)))
            if op == 0:
                q[pos % len(q)] = int(rng.choice(list(dna)))
            elif op == 1 and len(q) > 1:
                del q[pos % len(q)]
            else:
                q.insert(pos, int(rng.choice(list(dna))))
        return bytes(q), r

    ill = [mutated(int(rng.integers(100, 151)), 0.01) for _ in range(16384)]
    ont = [mutated(int(rng.integers(800, 1000)), 0.1) for _ in range(8192)]
    return ill, ont


def grow_to_512_pairs(rng, n, length=700, inserted=450):
    """Protein pairs whose adaptive blocks grow to 512: a ``length``-residue
    query and the same with ``inserted`` random residues inserted in its
    middle (560 and 300 suffice)."""
    pairs = []
    for _ in range(n):
        q = rng.choice(AA, size=length)
        mid = length // 2
        pairs.append((q.tobytes(), np.concatenate(
            [q[:mid], rng.choice(AA, size=inserted), q[mid:]]).tobytes()))
    return pairs


def structural_pairs(rng, alphabet, n, max_len):
    """``random_pairs``, where every other pair's reference also gains or
    loses 1..3 blocks of 8..len/3 residues, which makes adaptive blocks
    grow."""
    pairs = random_pairs(rng, alphabet, n, max_len)
    for k in range(4, n, 2):
        q, r = pairs[k]
        r = np.frombuffer(r, dtype=np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            ln = int(rng.integers(8, max(9, len(r) // 3 + 1)))
            pos = int(rng.integers(0, max(len(r) - ln, 1)))
            if rng.random() < 0.5 and len(r) > ln + 8:
                r = np.concatenate([r[:pos], r[pos + ln:]])
            else:
                r = np.concatenate([r[:pos], rng.choice(alphabet, size=ln),
                                    r[pos:]])
        pairs[k] = (q, r[:max_len].tobytes())
    return pairs


def x_dropped(out, staged):
    """How many pairs of an x-drop run ended short of (qlen, rlen): their
    best position lies before the end of the query or the reference."""
    ends = (out[:, 1].cpu() < staged.qlen.cpu()) | (out[:, 2].cpu()
                                                     < staged.rlen.cpu())
    return int(ends.sum())


def with_step_cap(cfg, steps):
    """``cfg`` with its step cap lowered to ``steps``."""
    class Capped(type(cfg)):
        max_steps = steps

    return Capped(**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cfg)})


def ptxas_report(_build, name):
    """One line per kernel instance of ``csrc/<name>.cu``: its registers,
    stack frame and spills as ``nvcc -Xptxas -v`` reports them with the
    build's flags (compiled to a cubin under ``build/``)."""
    flags = [f for f in _build.FLAGS if f not in ("-shared", "-Xcompiler",
                                                  "-fPIC")]
    _build.BUILD.mkdir(exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
         str(_build.BUILD / f"{name}.cubin"), str(_build.CSRC / f"{name}.cu")],
        capture_output=True, text=True, check=True)
    lines, fn, frame = [], None, ""
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)"
                      r"ILi(\d+)ELb([01])ELb([01])E", line)
        if m:
            fn = (f"{m[1]}<{m[2]}, {'x_drop' if m[3] == '1' else 'global'}"
                  f"{', trace' if m[4] == '1' else ''}>")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = (f"{m[1]} bytes stack, {m[2]} bytes spill stores, {m[3]} "
                     "bytes spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            lines.append(f"{fn}: {m[1]} registers, {frame}")
            fn = None
    if not lines:
        raise AssertionError(f"no ptxas report for {name}:\n{proc.stderr}")
    return lines


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs."""
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    """Milliseconds of ``fn()`` on the host clock, ending in a synchronise;
    returns (result, ms)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    return got, (time.perf_counter() - t0) * 1e3


def bound(staged, cells, int32_per_s, x_drop=False):
    """(bound_ms, bound_by) for one launch on ``staged``: each input read
    once and the int32 output, (B, 2) or in x-drop mode (B, 4), written
    once, against the DP cells the pairs need."""
    nbytes = (staged.codes.numel() + 4 * (staged.qlen.numel()
              + staged.rlen.numel() + staged.table.numel())
              + (16 if x_drop else 8) * staged.codes.shape[0])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = OPS_PER_CELL_XDROP if x_drop else OPS_PER_CELL
    t_ops = int(cells.sum()) * ops / int32_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


COUNTERS = ("launches", "xdrop_launches", "trace_launches",
            "xdrop_trace_launches")


def reset_launches(lk, ak):
    for fn in (lk.lane_align, ak.adaptive_align):
        for c in COUNTERS:
            setattr(fn, c, 0)


def expect_launches(lk, ak, what, *launched):
    """The launch counts by kernel instance since ``reset_launches``; fails
    unless exactly the instances named in ``launched`` ran."""
    counts = {}
    for fn in (lk.lane_align, ak.adaptive_align):
        for c in COUNTERS:
            name = fn.__name__ + ("_xdrop" if "xdrop" in c else "") + (
                "_trace" if "trace" in c else "")
            counts[name] = getattr(fn, c)
    if any((counts[k] > 0) != (k in launched) for k in counts):
        raise AssertionError(f"{what}: launches {counts}, expected only "
                             f"{launched}")
    return counts


def check_equal(got, want, what):
    import torch

    if not torch.equal(got, want):
        bad = (got != want).any(1).nonzero()[:5, 0].tolist()
        raise AssertionError(f"kernel != plain {what}: pairs {bad}: "
                             f"{got[bad].tolist()} vs {want[bad].tolist()}")


def check_trace(got, want, what):
    """A trace instance's ``(out, words, desc, steps)`` against its plain
    version's: equal outputs and step counts, equal descriptors of every
    step a pair executed and equal words of those steps in the rows inside
    each step's height.  Returns the count of checkpoint saves and
    restores in the executed descriptors."""
    import torch

    check_equal(got[0], want[0], what)
    out, words, desc, steps = want
    if not torch.equal(got[3], steps):
        bad = (got[3] != steps).nonzero()[:5, 0].tolist()
        raise AssertionError(f"kernel != plain {what}: step counts of pairs "
                             f"{bad}: {got[3][bad].tolist()} vs "
                             f"{steps[bad].tolist()}")
    T, B, S = words.shape
    ran = torch.arange(T, device=steps.device)[:, None] < steps[None, :]
    gd = got[2][:T]
    if not torch.equal(gd[ran], desc[ran]):
        t, b = ((gd != desc).any(2) & ran).nonzero()[0].tolist()
        raise AssertionError(f"kernel != plain {what}: descriptor of pair {b} "
                             f"step {t}: {gd[t, b].tolist()} vs "
                             f"{desc[t, b].tolist()}")
    rows = torch.arange(S, device=steps.device)
    inside = ran[:, :, None] & (rows < desc[:, :, 3:4])
    diff = (got[1][:T] != words) & inside
    if bool(diff.any()):
        t, b, r = diff.nonzero()[0].tolist()
        raise AssertionError(f"kernel != plain {what}: word of pair {b} step "
                             f"{t} row {r}: {int(got[1][t, b, r])} vs "
                             f"{int(words[t, b, r])}")
    fl = torch.where(ran, desc[:, :, 0], 0)
    return int(((fl >> 2) & 1).sum()), int(((fl >> 3) & 1).sum())


def score_table(matrix):
    """256 x 256 scores of letter pairs, by raw byte (``matrix.get``)."""
    tab = np.zeros((256, 256), np.int64)
    letters = list(range(65, 91)) + list(range(97, 123))
    for a in letters:
        for c in letters:
            tab[a, c] = matrix.get(a, c)
    return tab


def check_cigars(cigars, pairs, results, matrix, gaps, what):
    """The reference's trace check (examples_tpu/verify_trace.py:42-54, and
    the rescoring of tests/test_accuracy_random.py:151-167) on every pair:
    a CIGAR's ops sum to the result's end position, and its matches and
    mismatches scored with the matrix plus each gap run's open + (len - 1)
    * extend give the result's score.  Numpy over all pairs at once."""
    from block_aligner_tpu_torch import Operation as Op

    runs = [np.array([(int(o.op), o.len) for o in c.to_vec()],
                     np.int64).reshape(-1, 2) for c in cigars]
    B = len(runs)
    nrun = np.array([len(r) for r in runs], np.int64)
    allr = np.concatenate(runs) if B else np.zeros((0, 2), np.int64)
    pair = np.repeat(np.arange(B), nrun)
    op, ln = allr[:, 0], allr[:, 1]
    diag = (op == Op.M) | (op == Op.Eq) | (op == Op.X)
    di = np.where(diag | (op == Op.I), ln, 0)
    dj = np.where(diag | (op == Op.D), ln, 0)
    ends = np.stack([np.bincount(pair, di, B), np.bincount(pair, dj, B)],
                    1).astype(np.int64)
    want_ends = np.array([(r.query_idx, r.reference_idx) for r in results],
                         np.int64).reshape(-1, 2)
    if not np.array_equal(ends, want_ends):
        k = int(np.flatnonzero((ends != want_ends).any(1))[0])
        raise AssertionError(f"{what}: pair {k}: CIGAR {cigars[k]} ends at "
                             f"{tuple(ends[k])}, result {results[k]}")
    gap = np.where((op == Op.I) | (op == Op.D),
                   gaps.open + (ln - 1) * gaps.extend, 0)
    # each diagonal op's query and reference index
    first = np.concatenate([[0], np.cumsum(nrun)[:-1]])
    i0 = np.cumsum(di) - di
    j0 = np.cumsum(dj) - dj
    i0 -= i0[first[pair]] if len(pair) else 0
    j0 -= j0[first[pair]] if len(pair) else 0
    rep = np.repeat(np.flatnonzero(diag), ln[diag])
    start = np.repeat(np.cumsum(ln[diag]) - ln[diag], ln[diag])
    off = np.arange(rep.size) - start
    width = max([len(q) for q, _ in pairs] + [len(r) for _, r in pairs] + [1])
    qb = np.zeros((B, width), np.uint8)
    rb = np.zeros((B, width), np.uint8)
    for k, (q, r) in enumerate(pairs):
        qb[k, : len(q)] = np.frombuffer(q, np.uint8)
        rb[k, : len(r)] = np.frombuffer(r, np.uint8)
    pr = pair[rep]
    sub = score_table(matrix)[qb[pr, i0[rep] + off], rb[pr, j0[rep] + off]]
    score = (np.bincount(pair, gap, B) + np.bincount(pr, sub, B)).astype(
        np.int64)
    want = np.array([r.score for r in results], np.int64)
    if not np.array_equal(score, want):
        k = int(np.flatnonzero(score != want)[0])
        raise AssertionError(f"{what}: pair {k}: CIGAR {cigars[k]} rescores "
                             f"to {score[k]}, result {results[k]}")
    return int(ln.sum())


def walk_both(got, want, ends, matrix, what):
    """CIGARs walked from a kernel's trace and from its plain version's
    trace must be equal."""
    from block_aligner_tpu_torch.core.traceback import Trace

    cig = []
    for out, words, desc, steps in (got, want):
        st = steps.cpu().numpy()
        T = int(st.max())
        tr = Trace(words[:T].cpu().numpy(), desc[:T].cpu().numpy(), st,
                   matrix)
        cig.append([str(c) for c in tr.cigars_all(ends)])
    if cig[0] != cig[1]:
        k = next(k for k in range(len(ends)) if cig[0][k] != cig[1][k])
        raise AssertionError(f"{what}: CIGAR of pair {k}: kernel {cig[0][k]} "
                             f"vs plain {cig[1][k]}")


def check_goldens(golden, BatchAligner, Gaps, scores, dev):
    n = 0
    for name, (go, ge), size, cases in golden:
        size = size if isinstance(size, tuple) else (size, size)
        al = BatchAligner(getattr(scores, name), Gaps(go, ge), size=size,
                          batch=len(cases), seq_cap=128, device=dev)
        got = al.align_batch([(q, r) for q, r, _ in cases])
        for (q, r, want), res in zip(cases, got):
            if res.score != want:
                raise AssertionError(f"golden {name} {size} {q!r} {r!r}: "
                                     f"{res.score} != {want}")
        n += len(cases)
    return n


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from bench import rand_protein_pairs
    from block_aligner_tpu_torch import BatchAligner, Gaps, align_exp_all, api
    from block_aligner_tpu_torch.core import scores
    from block_aligner_tpu_torch.ops import _build
    from block_aligner_tpu_torch.ops import adaptive_kernel as ak
    from block_aligner_tpu_torch.ops import lane_kernel as lk
    from examples_tpu.common import load_uc_pairs, rand_mutate, rand_seq

    last = [time.perf_counter()]

    def phase(what):
        """Print the seconds since the previous phase ended."""
        now = time.perf_counter()
        print(f"[phase] {what}: {now - last[0]:.1f} s")
        last[0] = now

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_per_s = sms * INT32_PER_SM_CLOCK * float(clock) * 1e6
    print(f"[device] torch: {kind}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; {sms} SMs, "
          f"max SM clock {clock} MHz: int32 peak {int32_per_s / 1e12:.2f} "
          "Tops/s")
    print(card)
    dev = torch.device("cuda")

    # 2. build: one nvcc per source, and one per source for ptxas's
    # report, all started together
    t0 = time.perf_counter()
    names = ("lane_kernel", "adaptive_kernel")
    with ThreadPoolExecutor(2 * len(names)) as pool:
        reports = [pool.submit(ptxas_report, _build, n) for n in names]
        paths = list(pool.map(_build.build, names))
        reports = [line for r in reports for line in r.result()]
    lk._lib()
    ak._lib()
    print(f"[build] {', '.join(os.path.relpath(p, ROOT) for p in paths)} "
          f"built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in reports:
        print(f"[ptxas] {line}")
    phase("1-2, device and build")

    # 3. lane kernel vs plain version on the card (these launches are not
    # a main path's and are not counted)
    rng = np.random.default_rng(7)
    checked = 0
    for S in (16, 32, 64, 256, 512):
        for matrix, gaps, alphabet in ((scores.BLOSUM62, Gaps(-11, -1), AA),
                                       (scores.NW1, Gaps(-2, -1), DNA)):
            pairs = random_pairs(rng, alphabet, 192, 600)
            cfg = lk.LaneKernelConfig(
                S, -(-(1 + 600 + S + 16) // 128) * 128,
                32 if matrix.kind == "aa" else 16)
            pk = lk.pack_lane(pairs, matrix, cfg, gaps, dev)
            got = lk.lane_align(*pk, cfg)
            torch.cuda.synchronize()
            check_equal(got, lk.lane_align_plain(*pk, cfg),
                        f"at S={S} {matrix.kind}")
            checked += len(pairs)
    print(f"[lane-vs-plain] {checked} pairs at S in 16,32,64,256,512 "
          "(protein and DNA, lengths 0..600): score and suspect equal")
    n_gold = check_goldens(GOLDEN, BatchAligner, Gaps, scores, dev)
    print(f"[lane-golden] {n_gold} pinned reference scores equal "
          "(incl. README example NW1 -2/-1 block 32 -> 7)")
    phase("3, lane kernel vs plain")

    # 4. adaptive kernel vs plain version on the card
    checked = overran = 0
    ladders = ((16, 32), (16, 64), (32, 128), (32, 256), (64, 256))
    for lo, hi in ladders:
        for matrix, gaps, alphabet in ((scores.BLOSUM62, Gaps(-11, -1), AA),
                                       (scores.NW1, Gaps(-2, -1), DNA)):
            pairs = structural_pairs(rng, alphabet, 192, 600)
            cfg = ak.AdaptiveKernelConfig(
                lo, hi, -(-(1 + 600 + hi + 16) // 128) * 128,
                32 if matrix.kind == "aa" else 16)
            pk = lk.pack_lane(pairs, matrix, cfg, gaps, dev)
            got = ak.adaptive_align(*pk, cfg)
            torch.cuda.synchronize()
            check_equal(got, ak.adaptive_align_plain(*pk, cfg),
                        f"at ({lo}, {hi}) {matrix.kind}")
            checked += len(pairs)

    cfg = with_step_cap(ak.AdaptiveKernelConfig(16, 64, 768), 40)
    pk = lk.pack_lane(structural_pairs(rng, AA, 192, 600), scores.BLOSUM62,
                      cfg, Gaps(-11, -1), dev)
    got = ak.adaptive_align(*pk, cfg)
    torch.cuda.synchronize()
    check_equal(got, ak.adaptive_align_plain(*pk, cfg), "with 40 steps")
    overran = int(got[:, 1].sum())
    if not 0 < overran < len(got):
        raise AssertionError(f"{overran} of {len(got)} pairs overran 40 steps")
    print(f"[adaptive-vs-plain] {checked} pairs at ladders "
          f"{', '.join(map(str, ladders))} (protein and DNA, lengths 0..600, "
          f"structural indels): score and overrun equal; and with a 40-step "
          f"cap on {len(got)} pairs, {overran} of which overran")
    n_gold = check_goldens(GOLDEN_ADAPTIVE, BatchAligner, Gaps, scores, dev)
    print(f"[adaptive-golden] {n_gold} pinned adaptive scores equal")
    phase("4, adaptive kernel vs plain")

    # 3-4, x-drop: both kernels' x-drop instances vs their plain versions
    xsetups = ((scores.BLOSUM62, Gaps(-11, -1), AA, 50),
               (scores.NW1, Gaps(-2, -1), DNA, 100))
    checked = dropped = 0
    for S in (16, 32, 64, 256, 512):
        for matrix, gaps, alphabet, x in xsetups:
            pairs = random_pairs(rng, alphabet, 192, 600)
            cfg = lk.LaneKernelConfig(
                S, -(-(1 + 600 + S + 16) // 128) * 128,
                32 if matrix.kind == "aa" else 16, x_drop=True)
            pk = lk.pack_lane(pairs, matrix, cfg, gaps, dev, x_drop=x)
            got = lk.lane_align(*pk, cfg)
            torch.cuda.synchronize()
            check_equal(got, lk.lane_align_plain(*pk, cfg),
                        f"x-drop at S={S} {matrix.kind}")
            checked += len(pairs)
            dropped += x_dropped(got, pk)
    if not dropped:
        raise AssertionError("no lane x-drop pair ended short of its ends")
    print(f"[lane-xdrop-vs-plain] {checked} pairs at S in 16,32,64,256,512 "
          "(protein x 50 and DNA x 100, lengths 0..600): best, position and "
          f"suspect equal; {dropped} best positions short of (qlen, rlen)")

    checked = dropped = 0
    for lo, hi in ladders:
        for matrix, gaps, alphabet, x in xsetups:
            pairs = structural_pairs(rng, alphabet, 192, 600)
            cfg = ak.AdaptiveKernelConfig(
                lo, hi, -(-(1 + 600 + hi + 16) // 128) * 128,
                32 if matrix.kind == "aa" else 16, x_drop=True)
            pk = lk.pack_lane(pairs, matrix, cfg, gaps, dev, x_drop=x)
            got = ak.adaptive_align(*pk, cfg)
            torch.cuda.synchronize()
            check_equal(got, ak.adaptive_align_plain(*pk, cfg),
                        f"x-drop at ({lo}, {hi}) {matrix.kind}")
            checked += len(pairs)
            dropped += x_dropped(got, pk)
    if not dropped:
        raise AssertionError("no adaptive x-drop pair ended short of its ends")
    cfg = with_step_cap(ak.AdaptiveKernelConfig(16, 64, 768, x_drop=True), 25)
    pk = lk.pack_lane(structural_pairs(rng, AA, 192, 600), scores.BLOSUM62,
                      cfg, Gaps(-11, -1), dev, x_drop=50)
    got = ak.adaptive_align(*pk, cfg)
    torch.cuda.synchronize()
    check_equal(got, ak.adaptive_align_plain(*pk, cfg), "x-drop, 25 steps")
    overran = int(got[:, 3].sum())
    if not 0 < overran < len(got):
        raise AssertionError(f"{overran} of {len(got)} x-drop pairs overran "
                             "25 steps")
    print(f"[adaptive-xdrop-vs-plain] {checked} pairs at ladders "
          f"{', '.join(map(str, ladders))} (protein x 50 and DNA x 100, "
          "lengths 0..600, structural indels): best, position and overrun "
          f"equal; {dropped} best positions short of (qlen, rlen); with a "
          f"25-step cap on {len(got)} pairs, {overran} of which overran")
    phase("3-4, x-drop instances vs plain")

    # 5. the lane main path
    pairs = rand_protein_pairs(np.random.default_rng(1234), 16384, 1000, 100)
    more = rand_protein_pairs(np.random.default_rng(1235), 16384, 1000, 100)
    al = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 32),
                      batch=16384, seq_cap=1024, device=dev)
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    staged, pack_ms = host_ms(lambda: al.stage(pairs))
    res, run_ms = host_ms(lambda: al.align_staged(staged))
    suspect = al.last_suspect.copy()
    res_all = al.align_all(pairs + more)
    lane_launches = expect_launches(lk, ak, "lane main path",
                                    "lane_align")["lane_align"]
    for k, (q, r) in enumerate(pairs):
        if (res[k].query_idx, res[k].reference_idx) != (len(q), len(r)):
            raise AssertionError(f"pair {k}: end {res[k]} != ({len(q)}, {len(r)})")
    if res_all[: len(pairs)] != res:
        raise AssertionError("align_all disagrees with stage + align_staged")
    if not np.array_equal(al.last_suspect[: len(pairs)], suspect):
        raise AssertionError("align_all suspect flags disagree")
    sc = np.array([x.score for x in res])
    print(f"[lane-main] {len(pairs)} pairs 1000x1000 k=100 BLOSUM62 -11/-1 "
          f"block 32: stage+align_staged and align_all({len(pairs) + len(more)}) "
          f"agree; lane_align launches {lane_launches}; scores "
          f"{sc.min()}..{sc.max()} (mean {sc.mean():.1f}); suspect "
          f"{int(suspect.sum())}")

    # the kernel against the plain version on the main path's own inputs
    cfg = al.cfg
    args = (staged.codes, staged.qlen, staged.rlen, staged.table, staged.gaps)
    (want, cells), plain_ms = host_ms(
        lambda: lk.lane_align_plain(*args, cfg, count_cells=True))
    got = torch.from_numpy(np.stack([sc, suspect], 1).astype(np.int32))
    lane_err = int((got - want.cpu()).abs().max())
    if lane_err:
        raise AssertionError(f"lane main path differs from the plain version: "
                             f"max abs err {lane_err}")
    sub = al.stage(pairs[:512])
    sub_args = (sub.codes, sub.qlen, sub.rlen, sub.table, sub.gaps)
    want512, plain512_ms = host_ms(lambda: lk.lane_align_plain(*sub_args, cfg))
    if not torch.equal(want512.cpu(), got[:512]):
        raise AssertionError("first 512 main-path results differ from plain")
    print(f"[lane-main-vs-plain] all {len(pairs)} results (incl. the first "
          "512) equal the plain version on the card")

    lane_ms = cuda_ms(lambda: lk.lane_align(*args, cfg), 10)
    kernel512_ms = cuda_ms(lambda: lk.lane_align(*sub_args, cfg), 10)
    lane_bound, lane_by = bound(staged, cells, int32_per_s)
    B = len(pairs)
    print(f"[time] {card}: lane kernel {lane_ms * 1e3 / B:.4f} us/pair "
          f"({lane_ms:.3f} ms per launch of {B} pairs, CUDA events, mean of "
          f"10); bound {lane_bound:.4f} ms by {lane_by} "
          f"({int(cells.sum())} DP cells)")
    print(f"[time] {card}: pack (stage, host clock) {pack_ms * 1e3 / B:.4f} us/pair")
    print(f"[time] {card}: align_staged (launch, kernel, copy back, decode; "
          f"host clock) {run_ms * 1e3 / B:.4f} us/pair")
    print(f"[time] {card}: lane plain version {plain_ms * 1e3 / B:.4f} us/pair "
          f"on all {B} pairs ({plain_ms:.1f} ms, host clock)")
    print(f"[time] {card}: 512-pair subset: plain {plain512_ms * 1e3 / 512:.4f} "
          f"us/pair, kernel {kernel512_ms * 1e3 / 512:.4f} us/pair")
    lane_plain_ms = plain_ms
    phase("5, lane main path")

    # 6. the adaptive main path: the default size on homolog pairs, then on
    # the long random pairs
    uc = [(q, r) for q, r, _ in load_uc_pairs("uc30", per_bucket=1000, seed=1234)]
    ucal = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 256),
                        batch=len(uc), seq_cap=512, device=dev)
    lrand = rand_protein_pairs(np.random.default_rng(1234), 16384, 1000, 100)
    lral = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 256),
                        batch=len(lrand), seq_cap=1024, device=dev)
    if ucal.route != "adaptive" or lral.route != "adaptive":
        raise AssertionError("(32, 256) did not take the adaptive route")
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    runs = []
    for al, work, what in ((ucal, uc, "uc30 homologs 50-256 + indels"),
                           (lral, lrand, "random 1000x1000 k=100")):
        staged, pack_ms = host_ms(lambda: al.stage(work))
        res, run_ms = host_ms(lambda: al.align_staged(staged))
        res_all = al.align_all(work)
        runs.append((al, work, what, staged, res, pack_ms, run_ms, res_all))
    ad_launches = expect_launches(lk, ak, "adaptive main path",
                                  "adaptive_align")["adaptive_align"]
    ad_err = 0
    for al, work, what, staged, res, pack_ms, run_ms, res_all in runs:
        B = len(work)
        if res_all != res:
            raise AssertionError(f"{what}: align_all disagrees with "
                                 "stage + align_staged")
        for k, (q, r) in enumerate(work):
            if (res[k].query_idx, res[k].reference_idx) != (len(q), len(r)):
                raise AssertionError(f"{what} pair {k}: end {res[k]}")
        cfg = al.cfg
        args = (staged.codes, staged.qlen, staged.rlen, staged.table,
                staged.gaps)
        (want, cells), plain_ms = host_ms(
            lambda: ak.adaptive_align_plain(*args, cfg, count_cells=True))
        sc = np.array([x.score for x in res])
        got = torch.from_numpy(np.stack([sc, np.zeros_like(sc)], 1)
                               .astype(np.int32))
        err = int((got - want.cpu()).abs().max())
        if err:
            raise AssertionError(f"{what}: adaptive main path differs from the "
                                 f"plain version: max abs err {err}")
        ad_err = max(ad_err, err)
        kernel_ms = cuda_ms(lambda: ak.adaptive_align(*args, cfg), 10)
        bnd, by = bound(staged, cells, int32_per_s)
        print(f"[adaptive-main] {B} pairs, {what}, BLOSUM62 -11/-1 (32, 256): "
              "stage+align_staged and align_all agree and equal the plain "
              f"version; scores {sc.min()}..{sc.max()} (mean {sc.mean():.1f}); "
              f"{int(cells.sum())} DP cells, {int(cells.sum()) / B:.0f} per pair")
        print(f"[time] {card}: adaptive, {what}: kernel "
              f"{kernel_ms * 1e3 / B:.4f} us/pair ({kernel_ms:.3f} ms per "
              f"launch of {B} pairs, CUDA events, mean of 10); bound "
              f"{bnd:.4f} ms by {by}; pack {pack_ms * 1e3 / B:.4f} us/pair; "
              f"align_staged {run_ms * 1e3 / B:.4f} us/pair; plain "
              f"{plain_ms * 1e3 / B:.4f} us/pair ({plain_ms:.1f} ms)")
        if what.startswith("uc30"):
            ad_ms, ad_plain_ms, ad_bound, ad_by = kernel_ms, plain_ms, bnd, by
    print(f"[adaptive-main] adaptive_align launches {ad_launches}")
    phase("6, adaptive main path")

    # 7. align_exp_all at (32, 256) on 1024 homolog pairs
    pick = np.random.default_rng(5).choice(len(uc), 1024, replace=False)
    exp_pairs = [uc[k] for k in pick]
    fixed = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(256, 256),
                         batch=1024, seq_cap=512, device=dev)
    targets = [x.score for x in fixed.align_all(exp_pairs)]
    for k in range(8):
        targets[k] = 1 << 30  # never reached: these pairs run every level
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    exp_res, exp_min = align_exp_all(scores.BLOSUM62, Gaps(-11, -1), exp_pairs,
                                     targets, (32, 256), batch=1024,
                                     seq_cap=512, device=dev)
    counts = expect_launches(lk, ak, "align_exp_all", "lane_align",
                             "adaptive_align")
    exp_launches = (counts["lane_align"], counts["adaptive_align"])

    def check_exp_all(res, mins, targets, x_drop=None):
        """Every result equals a direct BatchAligner run at the min size it
        reports (None: the last level, 256); returns the count per size."""
        settled = {}
        for m in (32, 64, 128, 256, None):
            idx = [k for k in range(len(exp_pairs)) if mins[k] == m]
            settled[m] = len(idx)
            if not idx:
                continue
            direct = BatchAligner(
                scores.BLOSUM62, Gaps(-11, -1), size=(m or 256, 256),
                batch=1024, seq_cap=512, x_drop=x_drop,
                device=dev).align_all([exp_pairs[k] for k in idx])
            for k, d in zip(idx, direct):
                if res[k] != d or (m is None) != (d.score < targets[k]):
                    raise AssertionError(
                        f"align_exp_all pair {k} (min size {m}, x_drop "
                        f"{x_drop}): {res[k]} vs direct {d}, target "
                        f"{targets[k]}")
        return settled

    settled = check_exp_all(exp_res, exp_min, targets)
    print(f"[align_exp_all] {len(exp_pairs)} uc30 pairs at (32, 256), target "
          f"the 256-256 lane score: settled per min size {settled}; every "
          f"result equals a direct BatchAligner run at its size; launches "
          f"(lane, adaptive) {exp_launches}")
    phase("7, align_exp_all")

    def xdrop_path(al, work, what, name, plain_fn, kernel_fn):
        """Drive an x-drop main path (stage + align_staged, then align_all)
        with the launch counts reset just before it and read just after,
        hold every result against the plain version on the card, and time
        it; returns the path's numbers for the kernels line."""
        torch.cuda.synchronize()
        reset_launches(lk, ak)
        staged, pack_ms = host_ms(lambda: al.stage(work))
        res, run_ms = host_ms(lambda: al.align_staged(staged))
        flags = None if al.last_suspect is None else al.last_suspect.copy()
        res_all = al.align_all(work)
        launches = expect_launches(lk, ak, what, name)[name]
        if res_all != res:
            raise AssertionError(f"{what}: align_all disagrees with stage + "
                                 "align_staged")
        if flags is not None and not np.array_equal(al.last_suspect, flags):
            raise AssertionError(f"{what}: align_all suspect flags disagree")
        (want, cells), plain_ms = host_ms(
            lambda: plain_fn(*staged, al.cfg, count_cells=True))
        last = np.zeros(len(res), np.int32) if flags is None else flags
        got = torch.from_numpy(np.column_stack(
            [[(r.score, r.query_idx, r.reference_idx) for r in res], last])
            .astype(np.int32))
        err = int((got - want.cpu()).abs().max())
        if err:
            raise AssertionError(f"{what}: differs from the plain version: max "
                                 f"abs err {err}")
        kernel_ms = cuda_ms(lambda: kernel_fn(*staged, al.cfg), 10)
        bnd, by = bound(staged, cells, int32_per_s, x_drop=True)
        B, n_cells = len(work), int(cells.sum())
        sc = got[:, 0].numpy()
        print(f"[{name}-main] {B} pairs, {what}: stage+align_staged and "
              f"align_all agree and equal the plain version; {name} launches "
              f"{launches}; scores {sc.min()}..{sc.max()} (mean "
              f"{sc.mean():.1f}); best short of (qlen, rlen) in "
              f"{x_dropped(want, staged)}; {n_cells} DP cells, "
              f"{n_cells / B:.0f} per pair" + (
                  "" if flags is None else f"; suspect {int(flags.sum())}"))
        print(f"[time] {card}: {name}, {what}: kernel "
              f"{kernel_ms * 1e3 / B:.4f} us/pair ({kernel_ms:.3f} ms per "
              f"launch of {B} pairs, CUDA events, mean of 10); bound "
              f"{bnd:.4f} ms by {by}; pack {pack_ms * 1e3 / B:.4f} us/pair; "
              f"align_staged {run_ms * 1e3 / B:.4f} us/pair; plain "
              f"{plain_ms * 1e3 / B:.4f} us/pair ({plain_ms:.1f} ms)")
        return {"launches": launches, "max_abs_err": err, "ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by}

    # 8. the lane x-drop main path
    xal = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 32),
                       batch=8192, seq_cap=1100, x_drop=50, device=dev)
    lane_x = xdrop_path(
        xal, xdrop_protein_pairs(np.random.default_rng(7), 8192),
        "protein 800..999 with len/10 substitutions, BLOSUM62 -11/-1, "
        "x_drop 50, (32, 32)", "lane_align_xdrop", lk.lane_align_plain,
        lk.lane_align)
    phase("8, lane x-drop main path")

    # 9. the adaptive x-drop main path: x_drop_accuracy's configuration,
    # then the default size on the homolog pairs
    drng = np.random.default_rng(1234)
    dna = []
    for _ in range(8192):
        q = rand_seq(drng, b"ACGT", 300)
        dna.append((q, rand_mutate(drng, q, 30, b"ACGT")))
    xal = BatchAligner(scores.NucMatrix.new_simple(1, -1), Gaps(-2, -1),
                       size=(32, 64), batch=8192, seq_cap=300 + 300 // 8 + 32,
                       x_drop=50, device=dev)
    ad_x = xdrop_path(
        xal, dna, "DNA 300 with 30 edits, NucMatrix(1, -1) -2/-1, x_drop 50, "
        "(32, 64)", "adaptive_align_xdrop", ak.adaptive_align_plain,
        ak.adaptive_align)
    xal = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 256),
                       batch=len(uc), seq_cap=512, x_drop=50, device=dev)
    xdrop_path(xal, uc, "uc30 homologs 50-256 + indels, BLOSUM62 -11/-1, "
               "x_drop 50, (32, 256)", "adaptive_align_xdrop",
               ak.adaptive_align_plain, ak.adaptive_align)
    phase("9, adaptive x-drop main paths")

    # 10. align_exp_all with x-drop on the pairs of phase 7
    fixed = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(256, 256),
                         batch=1024, seq_cap=512, x_drop=50, device=dev)
    targets = [x.score for x in fixed.align_all(exp_pairs)]
    for k in range(8):
        targets[k] = 1 << 30  # never reached: these pairs run every level
    torch.cuda.synchronize()
    reset_launches(lk, ak)
    exp_res, exp_min = align_exp_all(scores.BLOSUM62, Gaps(-11, -1), exp_pairs,
                                     targets, (32, 256), x_drop=50,
                                     batch=1024, seq_cap=512, device=dev)
    counts = expect_launches(lk, ak, "align_exp_all x-drop",
                             "lane_align_xdrop", "adaptive_align_xdrop")
    settled = check_exp_all(exp_res, exp_min, targets, x_drop=50)
    print(f"[align_exp_all-xdrop] {len(exp_pairs)} uc30 pairs at (32, 256), "
          f"x_drop 50, target the x-drop 256-256 lane score: settled per min "
          f"size {settled}; every result equals a direct BatchAligner(x_drop"
          f"=50) run at its size; launches (lane, adaptive) "
          f"{(counts['lane_align_xdrop'], counts['adaptive_align_xdrop'])}")
    phase("10, align_exp_all with x-drop")

    # 11. the trace instances of both kernels vs their plain versions
    from block_aligner_tpu_torch.core.traceback import Trace

    def kernel_vs_plain_trace(cfg, pairs, matrix, gaps, x, what, walk=True):
        pk = lk.pack_lane(pairs, matrix, cfg, gaps, dev, x_drop=x)
        kernel = lk.lane_align if isinstance(cfg, lk.LaneKernelConfig) \
            else ak.adaptive_align
        plain = lk.lane_align_plain if kernel is lk.lane_align \
            else ak.adaptive_align_plain
        got = kernel(*pk, cfg)
        torch.cuda.synchronize()
        want = plain(*pk, cfg)
        events = check_trace(got, want, what)
        if walk:
            out = want[0].cpu().numpy()
            ends = ([(int(o[1]), int(o[2])) for o in out] if cfg.x_drop else
                    [(len(q), len(r)) for q, r in pairs])
            walk_both(got, want, ends, matrix, what)
        return got, events

    setups = ((scores.BLOSUM62, Gaps(-11, -1), AA, 50),
              (scores.NW1, Gaps(-2, -1), DNA, 100))
    checked = 0
    for S in (16, 32, 64, 256, 512):
        for xd in (False, True):
            for matrix, gaps, alphabet, x in setups:
                pairs = random_pairs(rng, alphabet, 96, 400)
                cfg = lk.LaneKernelConfig(
                    S, -(-(1 + 400 + S + 16) // 128) * 128,
                    32 if matrix.kind == "aa" else 16, x_drop=xd, trace=True)
                kernel_vs_plain_trace(cfg, pairs, matrix, gaps, x if xd else 0,
                                      f"lane trace S={S} x_drop={xd}")
                checked += len(pairs)
    print(f"[lane-trace-vs-plain] {checked} pairs at S in 16,32,64,256,512, "
          "global and x-drop (protein x 50 and DNA x 100, lengths 0..400): "
          "outputs, step counts, descriptors and words of every executed "
          "step equal, and the CIGARs walked from both")
    checked, saves, restores = 0, 0, 0
    ladders_t = ladders + ((32, 512),)
    for lo, hi in ladders_t:
        for xd in (False, True):
            for matrix, gaps, alphabet, x in setups:
                pairs = structural_pairs(rng, alphabet, 96, 400)
                if hi == 512 and matrix.kind == "aa":
                    pairs += grow_to_512_pairs(rng, 4)
                cfg = ak.AdaptiveKernelConfig(
                    lo, hi, -(-(1 + 1150 + hi + 16) // 128) * 128,
                    32 if matrix.kind == "aa" else 16, x_drop=xd, trace=True)
                got, (sv, rs) = kernel_vs_plain_trace(
                    cfg, pairs, matrix, gaps, x if xd else 0,
                    f"adaptive trace ({lo}, {hi}) x_drop={xd}")
                if hi == 512 and matrix.kind == "aa":
                    # every one of the 4 pairs, global and x-drop
                    ran = (torch.arange(got[2].shape[0], device=dev)[:, None]
                           < got[3][None, -4:])
                    grown = torch.where(ran, got[2][:, -4:, 3], 0).amax(0)
                    if not bool((grown == 512).all()):
                        raise AssertionError(f"x_drop={xd}: blocks grew to "
                                             f"{grown.tolist()}, not 512")
                checked += len(pairs)
                saves += sv
                restores += rs
    cfg = with_step_cap(ak.AdaptiveKernelConfig(16, 64, 768, trace=True), 40)
    got, _ = kernel_vs_plain_trace(
        cfg, structural_pairs(rng, AA, 192, 600), scores.BLOSUM62,
        Gaps(-11, -1), 0, "adaptive trace, 40 steps", walk=False)
    overran = int(got[0][:, 1].sum())
    if not 0 < overran < len(got[0]) or not saves or not restores:
        raise AssertionError(f"trace: {overran} pairs overran 40 steps; "
                             f"{saves} saves, {restores} restores")
    print(f"[adaptive-trace-vs-plain] {checked} pairs at ladders "
          f"{', '.join(map(str, ladders_t))}, global and x-drop (lengths "
          "0..400, structural indels; at (32, 512) 4 pairs that grow to "
          "512 in both modes): outputs, step counts, descriptors and words "
          f"equal, and the CIGARs; the descriptors held {saves} checkpoint "
          f"saves and {restores} grow restores; with a 40-step cap on "
          f"{len(got[0])} pairs, {overran} of which overran, the traces "
          "equal too")
    phase("11, trace instances vs plain")

    def trace_path(al, work, what, name, base):
        """Drive a trace main path through ``align_all_trace`` with the
        launch counts reset just before it and read just after; hold its
        results against the non-trace instance (``base``; None at max size
        512, which without trace is the big kernel's route) and the plain
        version on the card, every CIGAR against its result, and the first
        512 CIGARs against those of the plain version's trace; time it per
        batch.  Returns the path's numbers for the kernels line."""
        plain_fn = lk.lane_align_plain if al.route == "lane" \
            else ak.adaptive_align_plain
        kernel_fn = lk.lane_align if al.route == "lane" else ak.adaptive_align
        x = al.x_drop or 0
        torch.cuda.synchronize()
        reset_launches(lk, ak)
        (res, cigars), path_ms = host_ms(lambda: al.align_all_trace(work))
        launches = expect_launches(lk, ak, what, name)[name]
        if base is not None and base.align_all(work, sort=False) != res:
            raise AssertionError(f"{what}: results differ from the non-trace "
                                 "instance's")
        n_ops = check_cigars(cigars, work, res, al.matrix, al.gaps, what)
        # the plain version: every result, and the first 512 CIGARs
        cfg0 = al.cfg if base is None else dataclasses.replace(al.cfg,
                                                               trace=False)
        pk = lk.pack_lane(work, al.matrix, cfg0, al.gaps, dev, x_drop=x)
        plain_res, plain_ms = host_ms(
            lambda: plain_fn(*pk, cfg0, count_cells=True))
        want, cells = plain_res[0], plain_res[-1]
        del plain_res
        got = torch.tensor([(r.score, r.query_idx, r.reference_idx)
                            for r in res], dtype=torch.int32)
        want = want.cpu()
        if al.cfg.x_drop:
            err = int((got - want[:, :3]).abs().max())
        else:
            err = int((got[:, 0] - want[:, 0]).abs().max())
        if err:
            raise AssertionError(f"{what}: differs from the plain version: "
                                 f"max abs err {err}")
        sub = work[:512]
        pk = lk.pack_lane(sub, al.matrix, al.cfg, al.gaps, dev, x_drop=x)
        _, words, desc, steps = plain_fn(*pk, al.cfg)
        tr = Trace(words.cpu().numpy(), desc.cpu().numpy(),
                   steps.cpu().numpy(), al.matrix)
        ends = [(r.query_idx, r.reference_idx) for r in res[: len(sub)]]
        if [str(c) for c in tr.cigars_all(ends)] != [str(c) for c in
                                                      cigars[: len(sub)]]:
            raise AssertionError(f"{what}: CIGARs differ from the plain "
                                 "version's on the first 512 pairs")
        # times per batch: pack, kernel (CUDA events; the non-trace twin on
        # the same batches beside it), the trace's copy to the host alone,
        # _decode (that copy, the replay of the events, the results), walk
        # (cigars_all)
        t = {"pack": 0.0, "kernel": 0.0, "twin": 0.0, "copy": 0.0,
             "decode": 0.0, "walk": 0.0}
        nbytes = 0
        for k in range(0, len(work), al.batch_size):
            chunk = work[k : k + al.batch_size]
            staged, ms = host_ms(lambda: al._pack(chunk))
            t["pack"] += ms
            t["kernel"] += cuda_ms(lambda: kernel_fn(*staged, al.cfg), 3)
            if base is not None:
                t["twin"] += cuda_ms(lambda: kernel_fn(*staged, cfg0), 3)
            disp = kernel_fn(*staged, al.cfg)
            T = int(disp[3].max())
            _, ms = host_ms(lambda: [api.to_host(disp[1][:T]),
                                     api.to_host(disp[2][:T])])
            t["copy"] += ms
            got_b, ms = host_ms(lambda: al._decode(staged, disp))
            t["decode"] += ms
            ends = [(r.query_idx, r.reference_idx) for r in got_b]
            _, ms = host_ms(lambda: al.trace().cigars_all(ends))
            t["walk"] += ms
            # bytes the launch must move: codes, lengths and table read
            # once; out, steps, and each executed step's descriptor and
            # words of its rows inside the height written once
            trb = al.trace()
            ran = np.arange(trb.desc.shape[0])[:, None] < trb.steps[None, :]
            nbytes += (staged.codes.numel() + 4 * (2 * len(chunk)
                       + staged.table.numel()) + (16 if x else 8) * len(chunk)
                       + 4 * len(chunk) + 16 * int(ran.sum())
                       + 4 * int(np.where(ran, trb.desc[:, :, 3], 0).sum()))
        ops = (OPS_PER_CELL_XDROP if al.cfg.x_drop else OPS_PER_CELL) \
            + OPS_PER_CELL_TRACE
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = int(cells.sum()) * ops / int32_per_s * 1e3
        bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                              "operations")
        B = len(work)
        sc = got[:, 0].numpy()
        print(f"[{name}-main] {B} pairs, {what}: align_all_trace in batches "
              f"of {al.batch_size}; {name} launches {launches}; results equal "
              + ("the non-trace instance's and " if base is not None else "")
              + "the plain version's; every CIGAR "
              f"sums to its end and rescores to its score ({n_ops} ops); the "
              "first 512 equal the plain version's; scores "
              f"{sc.min()}..{sc.max()} (mean {sc.mean():.1f}); "
              f"{int(cells.sum())} DP cells, {int(cells.sum()) / B:.0f} per "
              f"pair; {nbytes / B:.0f} bytes per pair")
        twin = (f"the non-trace twin on the same batches "
                f"{t['twin'] * 1e3 / B:.4f} us/pair ({t['twin']:.3f} ms)"
                if base is not None else "no non-trace twin")
        print(f"[time] {card}: {name}, {what}: kernel "
              f"{t['kernel'] * 1e3 / B:.4f} us/pair ({t['kernel']:.3f} ms for "
              f"{B} pairs, CUDA events, mean of 3 per batch), {twin}; bound "
              f"{bnd:.4f} ms by {by}; host clock, us/pair: pack "
              f"{t['pack'] * 1e3 / B:.4f}, trace copy to the host "
              f"{t['copy'] * 1e3 / B:.4f}, _decode (copy, replay, results) "
              f"{t['decode'] * 1e3 / B:.4f}, walk (cigars_all) "
              f"{t['walk'] * 1e3 / B:.4f}, align_all_trace "
              f"{path_ms * 1e3 / B:.4f}, plain {plain_ms * 1e3 / B:.4f} "
              f"({plain_ms:.1f} ms)")
        phase(f"{name}, {what}")
        return {"launches": launches, "max_abs_err": err, "ms": t["kernel"],
                "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by}

    def merged(*paths):
        """One kernels-line entry for an instance that ran several paths:
        the launches of all, the numbers of the first."""
        return {**paths[0], "launches": sum(p["launches"] for p in paths),
                "max_abs_err": max(p["max_abs_err"] for p in paths)}

    # 12. the lane trace main paths: the reference's traced short reads
    ill, ont = short_read_pairs(np.random.default_rng(77))
    nuc, ngaps = scores.NucMatrix.new_simple(2, -4), Gaps(-6, -2)
    paths = []
    for work, cap, what in (
            (ont, 1100, "nanopore-like 800..999 bases, 10% edits"),
            (ill, 180, "Illumina-like 100..150 bases, 1% edits")):
        kw = dict(size=(32, 32), batch=len(work), seq_cap=cap, device=dev)
        paths.append(trace_path(
            BatchAligner(nuc, ngaps, trace=True, **kw), work,
            f"{what}, NucMatrix(2, -4) -6/-2, (32, 32)", "lane_align_trace",
            BatchAligner(nuc, ngaps, **kw)))
    lane_t = merged(*paths)

    # 13. the lane x-drop trace main path: the pairs of phase 8
    kw = dict(size=(32, 32), batch=8192, seq_cap=1100, x_drop=50, device=dev)
    lane_xt = trace_path(
        BatchAligner(scores.BLOSUM62, Gaps(-11, -1), trace=True, **kw),
        xdrop_protein_pairs(np.random.default_rng(7), 8192),
        "protein 800..999 with len/10 substitutions, BLOSUM62 -11/-1, "
        "x_drop 50, (32, 32)", "lane_align_xdrop_trace",
        BatchAligner(scores.BLOSUM62, Gaps(-11, -1), **kw))

    # 14. the adaptive trace main paths: the homolog pairs of phase 6 at
    # the reference's traced (32, 256), at (32, 512), and with x-drop
    paths = []
    for size, x, name in (((32, 256), None, "adaptive_align_trace"),
                          ((32, 512), None, "adaptive_align_trace"),
                          ((32, 256), 50, "adaptive_align_xdrop_trace")):
        kw = dict(size=size, batch=2048, seq_cap=512, x_drop=x, device=dev)
        al = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), trace=True, **kw)
        if al.route != "adaptive" or al.cfg.max_size != size[1]:
            raise AssertionError(f"{size} with trace did not take the "
                                 "adaptive route")
        base = None if size[1] == 512 else BatchAligner(
            scores.BLOSUM62, Gaps(-11, -1), **kw)
        paths.append(trace_path(
            al, uc, f"uc30 homologs 50-256 + indels, BLOSUM62 -11/-1, {size}"
            + (f", x_drop {x}" if x else ""), name, base))
    ad_t = merged(paths[0], paths[1])
    ad_xt = paths[2]

    print(json.dumps({"kernels": [
        {
            "name": "lane_align",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/lane_kernel.cu",
            "replaces": "block_aligner_tpu/ops/lane_kernel.py:381",
            "launches": lane_launches,
            "max_abs_err": lane_err,
            "ms": lane_ms,
            "plain_ms": lane_plain_ms,
            "bound_ms": lane_bound,
            "bound_by": lane_by,
            "library_ms": None,
        },
        {
            "name": "adaptive_align",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/adaptive_kernel.cu",
            "replaces": "block_aligner_tpu/ops/adaptive_kernel.py:213",
            "launches": ad_launches,
            "max_abs_err": ad_err,
            "ms": ad_ms,
            "plain_ms": ad_plain_ms,
            "bound_ms": ad_bound,
            "bound_by": ad_by,
            "library_ms": None,
        },
        {
            "name": "lane_align_xdrop",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/lane_kernel.cu",
            "replaces": "block_aligner_tpu/ops/lane_kernel.py:957",
            **lane_x,
            "library_ms": None,
        },
        {
            "name": "adaptive_align_xdrop",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/adaptive_kernel.cu",
            "replaces": "block_aligner_tpu/ops/adaptive_kernel.py:788",
            **ad_x,
            "library_ms": None,
        },
        {
            "name": "lane_align_trace",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/lane_kernel.cu",
            "replaces": "block_aligner_tpu/ops/lane_kernel.py:884",
            **lane_t,
            "library_ms": None,
        },
        {
            "name": "lane_align_xdrop_trace",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/lane_kernel.cu",
            "replaces": "block_aligner_tpu/ops/lane_kernel.py:884",
            **lane_xt,
            "library_ms": None,
        },
        {
            "name": "adaptive_align_trace",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/adaptive_kernel.cu",
            "replaces": "block_aligner_tpu/ops/adaptive_kernel.py:720",
            **ad_t,
            "library_ms": None,
        },
        {
            "name": "adaptive_align_xdrop_trace",
            "route": "cuda",
            "source": "block_aligner_tpu_torch/csrc/adaptive_kernel.cu",
            "replaces": "block_aligner_tpu/ops/adaptive_kernel.py:720",
            **ad_xt,
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
