"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each reported on its own line:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile ``block_aligner_tpu_torch/csrc/lane_kernel.cu`` into
   ``build/`` (keyed on the sources) and load it;
3. kernel vs plain: the CUDA kernel against its plain PyTorch version on
   the card, exact equality of score and suspect flag at blocks 16..512 on
   seeded random protein and DNA pairs, and the reference's golden scores;
4. main path: 16384 random protein pairs 1000x1000 with k=100 mutations
   (``bench.rand_protein_pairs``, seed 1234), BLOSUM62, gaps -11/-1, block
   32, through ``BatchAligner.stage`` + ``align_staged`` and through
   ``align_all`` on twice as many pairs; the kernel must have launched, and
   its results must equal the plain version's; kernel time from CUDA
   events, packing timed apart.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no result.  It needs the repository around it and a
CUDA device; without either it fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from bench import rand_protein_pairs
    from block_aligner_tpu_torch import BatchAligner, Gaps
    from block_aligner_tpu_torch.core import scores
    from block_aligner_tpu_torch.ops import _build
    from block_aligner_tpu_torch.ops import lane_kernel as lk

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"[device] torch: {kind}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build("lane_kernel")
    lk._lib()
    print(f"[build] {os.path.relpath(lib_path, ROOT)} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    # 3. kernel vs plain version on the card (these launches are not the
    # main path's and are not counted)
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
            want = lk.lane_align_plain(*pk, cfg)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).any(1).nonzero()[:5, 0].tolist()
                raise AssertionError(
                    f"kernel != plain at S={S} {matrix.kind}: pairs {bad}: "
                    f"{got[bad].tolist()} vs {want[bad].tolist()}")
            checked += len(pairs)
    print(f"[kernel-vs-plain] {checked} pairs at S in 16,32,64,256,512 "
          "(protein and DNA, lengths 0..600): score and suspect equal")
    n_gold = 0
    for name, (go, ge), S, cases in GOLDEN:
        al = BatchAligner(getattr(scores, name), Gaps(go, ge), size=(S, S),
                          batch=len(cases), seq_cap=64, device=dev)
        got = al.align_batch([(q, r) for q, r, _ in cases])
        for (q, r, want), res in zip(cases, got):
            if res.score != want:
                raise AssertionError(f"golden {name} S={S} {q!r} {r!r}: "
                                     f"{res.score} != {want}")
        n_gold += len(cases)
    print(f"[golden] {n_gold} pinned reference scores equal "
          "(incl. README example NW1 -2/-1 block 32 -> 7)")

    # 4. the main path
    pairs = rand_protein_pairs(np.random.default_rng(1234), 16384, 1000, 100)
    more = rand_protein_pairs(np.random.default_rng(1235), 16384, 1000, 100)
    al = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(32, 32),
                      batch=16384, seq_cap=1024, device=dev)
    torch.cuda.synchronize()
    lk.lane_align.launches = 0
    t0 = time.perf_counter()
    staged = al.stage(pairs)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = al.align_staged(staged)
    run_s = time.perf_counter() - t0
    suspect = al.last_suspect.copy()
    res_all = al.align_all(pairs + more)
    launches = lk.lane_align.launches
    if launches < 1:
        raise AssertionError("the main path launched no lane kernel")
    for k, (q, r) in enumerate(pairs):
        if (res[k].query_idx, res[k].reference_idx) != (len(q), len(r)):
            raise AssertionError(f"pair {k}: end {res[k]} != ({len(q)}, {len(r)})")
    if res_all[: len(pairs)] != res:
        raise AssertionError("align_all disagrees with stage + align_staged")
    if not np.array_equal(al.last_suspect[: len(pairs)], suspect):
        raise AssertionError("align_all suspect flags disagree")
    sc = np.array([x.score for x in res])
    print(f"[main] {len(pairs)} pairs 1000x1000 k=100 BLOSUM62 -11/-1 block 32: "
          f"stage+align_staged and align_all({len(pairs) + len(more)}) agree; "
          f"lane_align launches {launches}; scores {sc.min()}..{sc.max()} "
          f"(mean {sc.mean():.1f}); suspect {int(suspect.sum())}")

    # the kernel against the plain version on the main path's own inputs
    cfg = al.cfg
    args = (staged.codes, staged.qlen, staged.rlen, staged.table, staged.gaps)
    t0 = time.perf_counter()
    want = lk.lane_align_plain(*args, cfg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = torch.from_numpy(np.stack([sc, suspect], 1).astype(np.int32))
    max_abs_err = int((got - want.cpu()).abs().max())
    if max_abs_err:
        raise AssertionError(f"main path differs from the plain version: "
                             f"max abs err {max_abs_err}")
    sub = al.stage(pairs[:512])
    sub_args = (sub.codes, sub.qlen, sub.rlen, sub.table, sub.gaps)
    t0 = time.perf_counter()
    want512 = lk.lane_align_plain(*sub_args, cfg)
    torch.cuda.synchronize()
    plain512_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(want512.cpu(), got[:512]):
        raise AssertionError("first 512 main-path results differ from plain")
    print(f"[main-vs-plain] all {len(pairs)} results (incl. the first 512) "
          "equal the plain version on the card")

    kernel_ms = cuda_ms(lambda: lk.lane_align(*args, cfg), 10)
    kernel512_ms = cuda_ms(lambda: lk.lane_align(*sub_args, cfg), 10)
    B = len(pairs)
    print(f"[time] {card}: kernel {kernel_ms * 1e3 / B:.4f} us/pair "
          f"({kernel_ms:.3f} ms per launch of {B} pairs, CUDA events, mean of 10)")
    print(f"[time] {card}: pack (stage, host clock) {pack_s * 1e6 / B:.4f} us/pair")
    print(f"[time] {card}: align_staged (launch, kernel, copy back, decode; "
          f"host clock) {run_s * 1e6 / B:.4f} us/pair")
    print(f"[time] {card}: plain version {plain_ms * 1e3 / B:.4f} us/pair "
          f"on all {B} pairs ({plain_ms:.1f} ms, host clock)")
    print(f"[time] {card}: 512-pair subset: plain {plain512_ms * 1e3 / 512:.4f} "
          f"us/pair, kernel {kernel512_ms * 1e3 / 512:.4f} us/pair")

    print(json.dumps({"kernels": [{
        "name": "lane_align",
        "route": "cuda",
        "source": "block_aligner_tpu_torch/csrc/lane_kernel.cu",
        "replaces": "block_aligner_tpu/ops/lane_kernel.py:381",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
