"""Where kernels A and C spend a pair's cycles, by clock64() sections of
``csrc/lane_kernel.cu`` and ``csrc/big_kernel.cu``; and kernel A's warps a
pair, by time.

Usage, on a machine with the card, from the repository's root::

    python3 scripts_torch/probe_big_kernel.py [big | lane] [--source PATH]
    python3 scripts_torch/probe_big_kernel.py warps [--source PATH]
    python3 scripts_torch/probe_big_kernel.py sass [--source PATH]

The probe writes a copy of the source (the repository's, or ``--source``)
into ``build/probe/`` with counters in lane 0 of every warp, at the lines
the kernel marks ``// probe:``, builds it and prints each split as shares
of the counted lanes' cycles, summed.  The counters cost time themselves:
the shares, not the kernel times, are the result.

- ``big`` (the default): kernel C's step start (descriptor, restore), its
  columns (the rows' rebase, loads and stores too) and its end (trace
  words, tracker fold, decision ladder), on the nanopore band (128, 1024),
  1024 pairs, and the PSSM self-oracle at a fixed (2048, 2048) on 8192 SCOP
  pairs (``chip_smoke.py``'s phases 27 and 38), through
  ``ops/big_kernel.py``.
- ``lane``: kernel A's step start (codes, rebase, descriptor), each
  column's row pass (D and C), in-lane scan, shuffle scan (with the pair's
  warps' carries) and second pass (R, trace bits, tails, trackers), and
  the step's end (trace stores, prologue, shift, decision), on the 64
  simulated reads of 25-50 kbp at block 512 (phase 44) and the 16384
  random protein pairs at block 32 (phase 5), through
  ``ops/lane_kernel.py``; the copy builds blocks 32 and 512 only.
- ``warps``: kernel A's global instances at blocks 256 and 512 rebuilt
  with each of several warps a pair (the ``WIDE_WARPS`` and
  ``NARROW_WARPS`` lines of the copy rewritten; no counters), timed with
  CUDA events on phase 44's reads in launches of 64, 256 (the long API's
  default batch) and 528 pairs and on 132 to 2048 random protein pairs of
  1000 residues (one pair an SM to a batch that fills the card), every
  variant's results equal.
- ``sass``: kernel A's instances of ``csrc/lane_kernel.cu`` compiled to a
  cubin with the build's flags, and per instance the count of the DPX
  instructions (``VIADDMNMX``, ``VIMNMX3``), of two-operand ``IMNMX`` and of
  local-memory accesses (``LDL``, ``STL``) in ``cuobjdump -sass``."""

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "block_aligner_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "probe")

PROLOGUE = r"""
__device__ unsigned long long probe_acc[{n}];
#define PSW(nb)                                  \
  {{                                             \
    const unsigned long long n_ = clock64();     \
    pc_[cb_] += n_ - tmark_;                     \
    tmark_ = n_;                                 \
    cb_ = (nb);                                  \
  }}
"""

EPILOGUE = r"""
extern "C" int probe_read(unsigned long long* host) {{
  unsigned long long zero[{n}] = {{0}};
  cudaError_t err = cudaMemcpyFromSymbol(host, probe_acc, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(probe_acc, zero, sizeof(zero));
  return (int)err;
}}
"""

# each target's sections, in order, and the source lines that mark them
SECTIONS = {
    "big": ("step start", "columns", "step end"),
    "lane": ("step start", "row pass", "lane scan", "shuffle scan",
             "second pass", "step end"),
}


def marks(target):
    """The code that replaces each marked line of ``target``'s source."""
    names = SECTIONS[target]
    n = len(names)
    got = {name: f"PSW({k});" for k, name in enumerate(names)}
    got["pair start"] = (f"unsigned long long pc_[{n}] = {{0}};\n"
                         "unsigned long long tmark_ = clock64();\n"
                         "int cb_ = 0;")
    got["pair end"] = (f"if ((threadIdx.x & 31) == 0) {{\n  PSW({n - 1});\n"
                       f"  for (int q = 0; q < {n}; ++q) "
                       "atomicAdd(&probe_acc[q], pc_[q]);\n}")
    return got


def instrument(src: str, target: str) -> str:
    """The source with the counters at its ``// probe:`` lines, each of
    which must be there once."""
    table = marks(target)
    lines, seen = [], []
    for line in src.splitlines():
        mark = line.strip()
        if mark.startswith("// probe: "):
            name = next(n for n in table if mark[10:].startswith(n))
            seen.append(name)
            lines.append(table[name])
        else:
            lines.append(line)
    assert sorted(seen) == sorted(table), seen
    n = len(SECTIONS[target])
    text = "\n".join(lines) + "\n"
    return text.replace("#include <stdint.h>\n", "#include <stdint.h>\n"
                        + PROLOGUE.format(n=n), 1) + EPILOGUE.format(n=n)


def only_blocks(src: str, blocks) -> str:
    """The lane source with its launch switch cut to ``blocks``."""
    def keep(m):
        return m[0] if int(m[1]) in blocks else ""
    got, n = re.subn(r"^ *case (\d+): return \(int\)launch<.*\n", keep, src,
                     flags=re.M)
    assert n == 6, n
    return got


def compile_all(jobs, report=False):
    """Build each ``(name, text)`` of ``jobs`` into ``build/probe/`` at
    once; returns ``{name: (path, ptxas log)}``."""
    from block_aligner_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in jobs:
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS,
             *(("-Xptxas", "-v") if report else ()), "-I", CSRC, "-o", so,
             src], stderr=subprocess.PIPE, text=True))
    got = {}
    for name, (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        got[name] = (so, err)
    return got


def load(path, bind):
    lib = bind(ctypes.CDLL(path))
    if hasattr(lib, "probe_read"):
        lib.probe_read.argtypes = [ctypes.c_void_p]
    return lib


def split(lib, run, target):
    """``run`` once to warm up, the counters reset, then once counted."""
    import torch

    names = SECTIONS[target]
    got = (ctypes.c_ulonglong * len(names))()
    run()
    torch.cuda.synchronize()
    assert lib.probe_read(ctypes.addressof(got)) == 0
    run()
    torch.cuda.synchronize()
    assert lib.probe_read(ctypes.addressof(got)) == 0
    total = sum(got)
    return ", ".join(f"{name} {100 * v / total:.1f}%"
                     for name, v in zip(names, got)) + \
        f" ({total} cycles of lane 0 over the warps)"


def read_source(args, name):
    with open(args.source or os.path.join(CSRC, name)) as f:
        return f.read()


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def long_reads(n=64):
    """Phase 44's reads, the first ``n`` of its stream."""
    from examples_tpu.common import load_nanopore_pairs

    return load_nanopore_pairs("nanopore.50kbps", n_pairs=n, max_len=50000,
                               seed=1234)


def lane_work(block, pairs, dev, long=False):
    """The staged inputs and config of ``pairs`` at ``block``: phase 44's
    long aligner for the reads, else phase 5's ``BatchAligner``."""
    from block_aligner_tpu_torch import BatchAligner, Gaps, LongBatchAligner
    from block_aligner_tpu_torch.core import scores

    if long:
        al = LongBatchAligner(scores.NucMatrix.new_simple(2, -4),
                              Gaps(-6, -2), block, batch=len(pairs),
                              device=dev)
        st = al._pack(pairs)
        return st, al._staged_cfg(st)
    al = BatchAligner(scores.BLOSUM62, Gaps(-11, -1), size=(block, block),
                      batch=len(pairs), seq_cap=1024, device=dev)
    st = al.stage(pairs)
    return st, al.cfg


def probe_big(args):
    import torch

    import chip_smoke
    from block_aligner_tpu_torch import BatchAligner, Gaps, ProfileAligner
    from block_aligner_tpu_torch.core import scores
    from block_aligner_tpu_torch.ops import big_kernel as bk
    from examples_tpu.common import load_nanopore_pairs

    text = instrument(read_source(args, "big_kernel.cu"), "big")
    built = compile_all([
        ("probe_kernel", text),
        ("probe_profile", "#define BIG_FLAGS true\n#define BIG_PROFILE true\n"
         + text)])
    libs = {bk.LIBRARY: load(built["probe_kernel"][0], bk.bind),
            bk.PROFILE_LIBRARY: load(built["probe_profile"][0], bk.bind)}
    bk._lib = lambda name: libs[name]
    dev = torch.device("cuda")
    nano = load_nanopore_pairs(n_pairs=1024, max_len=10000, seed=1234)
    al = BatchAligner(scores.NucMatrix.new_simple(2, -4), Gaps(-6, -2),
                      size=(128, 1024), batch=len(nano),
                      seq_cap=max(max(len(q), len(r)) for q, r in nano),
                      device=dev)
    st = al.stage(nano)
    print(f"[probe] {card()}: band (128, 1024), 1024 nanopore pairs: "
          + split(libs[bk.LIBRARY],
                  lambda: bk.big_align(*st, al._staged_cfg(st)), "big"))
    scop = chip_smoke.scop_profiles(8192)
    pal = ProfileAligner((2048, 2048), batch=len(scop),
                         seq_cap=max(len(q) for q, _ in scop) + 16,
                         prof_len=max(p.len() for _, p in scop) + 16,
                         device=dev)
    pst = pal.stage(scop)
    print(f"[probe] {card()}: self-oracle (2048, 2048), 8192 SCOP pairs: "
          + split(libs[bk.PROFILE_LIBRARY],
                  lambda: bk.big_align(*pst, pal._staged_cfg(pst)), "big"))


def probe_lane(args):
    import torch

    from bench import rand_protein_pairs
    from block_aligner_tpu_torch.ops import lane_kernel as lk

    text = only_blocks(instrument(read_source(args, "lane_kernel.cu"),
                                  "lane"), (32, 512))
    lib = load(compile_all([("probe_lane", text)])["probe_lane"][0], lk.bind)
    lk._lib = lambda name: lib
    dev = torch.device("cuda")
    st, cfg = lane_work(512, long_reads(), dev, long=True)
    print(f"[probe] {card()}: lane block 512, 64 reads of 25-50 kbp: "
          + split(lib, lambda: lk.lane_align(*st, cfg), "lane"))
    pairs = rand_protein_pairs(np.random.default_rng(1234), 16384, 1000, 100)
    st, cfg = lane_work(32, pairs, dev)
    print(f"[probe] {card()}: lane block 32, 16384 protein pairs: "
          + split(lib, lambda: lk.lane_align(*st, cfg), "lane"))


WARPS = re.compile(r"^template <int S> constexpr int (WIDE|NARROW)_WARPS = "
                   r".*;$", re.M)


def sweep_warps(args):
    """Kernel A's global instances at blocks 256 and 512 with each G."""
    import torch

    import chip_smoke
    from bench import rand_protein_pairs
    from block_aligner_tpu_torch.ops import lane_kernel as lk

    src = read_source(args, "lane_kernel.cu")
    assert len(WARPS.findall(src)) == 2, "no WIDE_WARPS / NARROW_WARPS lines"
    variants = {256: (1, 2), 512: (2, 4, 8)}
    jobs = []
    for S, gs in variants.items():
        for G in gs:
            rule = (f"template <int S> constexpr int \\1_WARPS = S == {S} ? "
                    f"{G} : 1;")
            jobs.append((f"warps_{S}_{G}",
                         only_blocks(WARPS.sub(rule, src), (S,))))
    built = compile_all(jobs, report=True)
    dev = torch.device("cuda")
    reads = long_reads(528)
    full = rand_protein_pairs(np.random.default_rng(1234), 2048, 1000, 100)
    for S, gs in variants.items():
        work = {f"{n} reads": lane_work(S, reads[:n], dev, long=True)
                for n in (64, 256, 528)}
        for n in (132, 264, 528, 2048):
            work[f"{n} protein pairs"] = lane_work(S, full[:n], dev)
        seen = {}
        for G in gs:
            path, log = built[f"warps_{S}_{G}"]
            lib = load(path, lk.bind)
            lk._lib = lambda name, lib=lib: lib
            regs = [line for line in chip_smoke.parse_ptxas(log, "lane_kernel")
                    if line.startswith(f"lane_align_kernel<{S}, {G} warps, "
                                       "global>")]
            times = []
            for what, (st, cfg) in work.items():
                out = lk.lane_align(*st, cfg)
                torch.cuda.synchronize()
                if what in seen and not torch.equal(out, seen[what]):
                    raise SystemExit(f"G={G} at {S} differs on {what}")
                seen[what] = out
                ms = chip_smoke.cuda_ms(lambda: lk.lane_align(*st, cfg), 3)
                times.append(f"{what} {ms:.3f} ms")
            print(f"[warps] {card()}: block {S}, {G} warps a pair: "
                  f"{'; '.join(times)} (CUDA events, mean of 3); "
                  f"{regs[0].split(': ', 1)[1]}")


def sass_counts(args):
    """Kernel A's SASS, instruction counts per instance."""
    from block_aligner_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "sass_lane.cu")
    with open(src, "w") as f:
        f.write(read_source(args, "lane_kernel.cu"))
    cubin = os.path.join(OUT, "sass_lane.cubin")
    flags = [f for f in _build.FLAGS if f not in ("-shared", "-Xcompiler",
                                                  "-fPIC")]
    subprocess.run([_build.nvcc(), *flags, "-cubin", "-o", cubin, src],
                   check=True)
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    ops = ("VIADDMNMX", "VIMNMX3", "IMNMX", "LDL", "STL")
    seen = {op: [] for op in ops}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"lane_align_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)ELb(\d)",
                      fn.split("\n", 1)[0])
        if not m:
            continue
        got = {op: len(re.findall(r"\b" + op + r"\b", fn)) for op in ops}
        for op in ops:
            seen[op].append(got[op])
        print(f"[sass] lane_align_kernel<{m[1]}, {m[2]} warps, "
              f"{'x_drop' if m[3] == '1' else 'global'}"
              f"{', trace' if m[4] == '1' else ''}>: "
              + ", ".join(f"{op} {n}" for op, n in got.items()))
    print(f"[sass] {card()}'s toolkit, {len(seen['LDL'])} instances: "
          + "; ".join(f"{op} {min(v)}..{max(v)}" for op, v in seen.items()))


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("target", nargs="?", default="big",
                        choices=("big", "lane", "warps", "sass"))
    parser.add_argument("--source", help="the kernel source to probe")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_big_kernel: no CUDA device")
    {"big": probe_big, "lane": probe_lane, "warps": sweep_warps,
     "sass": sass_counts}[args.target](args)
    print(f"[probe] numpy {np.__version__}, torch {torch.__version__}")


if __name__ == "__main__":
    main()
