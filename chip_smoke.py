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
   phase 7, the target the x-drop 256-256 lane score, checked as there.

On every main path the kernels must have launched (their counts are set to
0 just before the path and read just after) and every result must equal
the plain version's; kernel times come from CUDA events, packing is timed
apart.  The line before the last is a JSON summary of the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises, so the
script exits non-zero and prints no result.  It needs the repository around
it and a CUDA device; without either it fails.
"""

from __future__ import annotations

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

    return Capped(cfg.min_size, cfg.max_size, cfg.seq_cap, cfg.alpha,
                  cfg.x_drop)


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
                      r"ILi(\d+)ELb([01])E", line)
        if m:
            fn = f"{m[1]}<{m[2]}, {'x_drop' if m[3] == '1' else 'global'}>"
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


def reset_launches(lk, ak):
    lk.lane_align.launches = lk.lane_align.xdrop_launches = 0
    ak.adaptive_align.launches = ak.adaptive_align.xdrop_launches = 0


def expect_launches(lk, ak, what, *launched):
    """The launch counts by kernel instance since ``reset_launches``; fails
    unless exactly the instances named in ``launched`` ran."""
    counts = {"lane_align": lk.lane_align.launches,
              "adaptive_align": ak.adaptive_align.launches,
              "lane_align_xdrop": lk.lane_align.xdrop_launches,
              "adaptive_align_xdrop": ak.adaptive_align.xdrop_launches}
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
    from block_aligner_tpu_torch import BatchAligner, Gaps, align_exp_all
    from block_aligner_tpu_torch.core import scores
    from block_aligner_tpu_torch.ops import _build
    from block_aligner_tpu_torch.ops import adaptive_kernel as ak
    from block_aligner_tpu_torch.ops import lane_kernel as lk
    from examples_tpu.common import load_uc_pairs, rand_mutate, rand_seq

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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
