"""Where kernel C's time goes, by clock64() sections of
``csrc/big_kernel.cu``.

Usage, on a machine with the card, from the repository's root::

    python3 scripts_torch/probe_big_kernel.py

The script writes a copy of the source into ``build/probe/`` with
counters in thread 0 of every pair, at the lines the kernel marks
``// probe:``: the step's start (descriptor, restore), its columns (the
rows' rebase, loads and stores too) and its end (trace words, tracker
fold, decision ladder).  It builds the global and the profile library from
the copy, drives the nanopore band (128, 1024) on 1024 pairs and the PSSM
self-oracle at a fixed (2048, 2048) on 8192 SCOP pairs (``chip_smoke.py``'s
phases 27 and 38) through ``ops/big_kernel.py``, and prints each split as
shares of the counted threads' cycles, summed.  The counters cost time
themselves: the shares, not the kernel times, are the result."""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "block_aligner_tpu_torch", "csrc",
                      "big_kernel.cu")
OUT = os.path.join(ROOT, "build", "probe")

PROLOGUE = r"""
__device__ unsigned long long probe_acc[3];
#define PSW(nb)                                  \
  {                                              \
    const unsigned long long n_ = clock64();     \
    pc_[cb_] += n_ - tmark_;                     \
    tmark_ = n_;                                 \
    cb_ = (nb);                                  \
  }
"""

EPILOGUE = r"""
extern "C" int probe_read(unsigned long long* host) {
  unsigned long long zero[3] = {0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(host, probe_acc, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(probe_acc, zero, sizeof(zero));
  return (int)err;
}
"""

SECTIONS = ("step start", "columns", "step end")

# the code that replaces each marked line
MARKS = {
    "pair start": "unsigned long long pc_[3] = {0, 0, 0};\n"
                  "unsigned long long tmark_ = clock64();\nint cb_ = 0;",
    "step start": "PSW(0);",
    "columns": "PSW(1);",
    "step end": "PSW(2);",
    "pair end": "if (L.gt == 0) {\n  PSW(2);\n  for (int q = 0; q < 3; ++q) "
                "atomicAdd(&probe_acc[q], pc_[q]);\n}",
}


def instrument(src: str) -> str:
    """The source with the counters at its ``// probe:`` lines, each of
    which must be there once."""
    lines, seen = [], []
    for line in src.splitlines():
        mark = line.strip()
        if mark.startswith("// probe: "):
            name = next(n for n in MARKS if mark[10:].startswith(n))
            seen.append(name)
            lines.append(MARKS[name])
        else:
            lines.append(line)
    assert sorted(seen) == sorted(MARKS), seen
    text = "\n".join(lines) + "\n"
    return text.replace("#include <stdint.h>\n",
                        "#include <stdint.h>\n" + PROLOGUE, 1) + EPILOGUE


def build():
    """The global and the profile library of the instrumented copy."""
    import ctypes

    from block_aligner_tpu_torch.ops import _build
    from block_aligner_tpu_torch.ops import big_kernel as bk

    out = OUT
    os.makedirs(out, exist_ok=True)
    with open(SOURCE) as f:
        text = instrument(f.read())
    with open(os.path.join(out, "probe_kernel.cu"), "w") as f:
        f.write(text)
    with open(os.path.join(out, "probe_profile.cu"), "w") as f:
        f.write("#define BIG_FLAGS true\n#define BIG_PROFILE true\n"
                '#include "probe_kernel.cu"\n')
    libs, procs = {}, []
    for name, lib in (("probe_kernel", bk.LIBRARY),
                      ("probe_profile", bk.PROFILE_LIBRARY)):
        so = os.path.join(out, f"lib{name}.so")
        procs.append((lib, so, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-o", so,
             os.path.join(out, f"{name}.cu")], stderr=subprocess.PIPE,
            text=True)))
    for lib, so, proc in procs:
        err = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {so}:\n{err}")
        libs[lib] = bk.bind(ctypes.CDLL(so))
        libs[lib].probe_read.argtypes = [ctypes.c_void_p]
    return libs


def split(lib, run):
    """``run`` once to warm up, the counters reset, then once counted."""
    import ctypes

    import torch

    got = (ctypes.c_ulonglong * 3)()
    run()
    torch.cuda.synchronize()
    assert lib.probe_read(ctypes.addressof(got)) == 0
    run()
    torch.cuda.synchronize()
    assert lib.probe_read(ctypes.addressof(got)) == 0
    total = sum(got)
    return ", ".join(f"{name} {100 * v / total:.1f}%"
                     for name, v in zip(SECTIONS, got)) + \
        f" ({total} cycles of thread 0 over the pairs)"


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_big_kernel: no CUDA device")
    import chip_smoke
    from block_aligner_tpu_torch import BatchAligner, Gaps, ProfileAligner
    from block_aligner_tpu_torch.core import scores
    from block_aligner_tpu_torch.ops import big_kernel as bk
    from examples_tpu.common import load_nanopore_pairs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build()
    bk._lib = lambda name: libs[name]
    dev = torch.device("cuda")
    nano = load_nanopore_pairs(n_pairs=1024, max_len=10000, seed=1234)
    al = BatchAligner(scores.NucMatrix.new_simple(2, -4), Gaps(-6, -2),
                      size=(128, 1024), batch=len(nano),
                      seq_cap=max(max(len(q), len(r)) for q, r in nano),
                      device=dev)
    st = al.stage(nano)
    print(f"[probe] {card}: band (128, 1024), 1024 nanopore pairs: "
          + split(libs[bk.LIBRARY],
                  lambda: bk.big_align(*st, al._staged_cfg(st))))
    scop = chip_smoke.scop_profiles(8192)
    pal = ProfileAligner((2048, 2048), batch=len(scop),
                         seq_cap=max(len(q) for q, _ in scop) + 16,
                         prof_len=max(p.len() for _, p in scop) + 16,
                         device=dev)
    pst = pal.stage(scop)
    print(f"[probe] {card}: self-oracle (2048, 2048), 8192 SCOP pairs: "
          + split(libs[bk.PROFILE_LIBRARY],
                  lambda: bk.big_align(*pst, pal._staged_cfg(pst))))
    print(f"[probe] numpy {np.__version__}, torch {torch.__version__}")


if __name__ == "__main__":
    main()
