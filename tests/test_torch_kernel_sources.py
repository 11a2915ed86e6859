"""The CUDA sources themselves on the CPU: ``csrc/lane_kernel.cu`` and
``csrc/adaptive_kernel.cu`` compiled as C++ against a small header that
emulates the few CUDA features they use, called through their own C entry
points and ``bind``, and held exactly against the plain versions, in
global, x-drop and trace mode.

The emulation runs one block at a time (so ``__shared__`` arrays may be
function statics), each of its CUDA threads a fiber on one host thread;
the warp primitives exchange values through per-warp buffers, one barrier
wait each, where a fiber hands over to the next until all arrived.  It
checks the kernels' logic (indexing, shuffles, the step machine), not their
timing or their compilation by ``nvcc``, which only ``chip_smoke.py`` on the
card can check."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from block_aligner_tpu_torch import Gaps
from block_aligner_tpu_torch.core import scores
from block_aligner_tpu_torch.ops import _build
from block_aligner_tpu_torch.ops import adaptive_kernel as ak
from block_aligner_tpu_torch.ops import lane_kernel as lk
from test_torch_adaptive_kernel import protein_pairs
from test_torch_trace import grown_pairs

EMULATION = r"""
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <memory>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __shared__ static
typedef int cudaError_t;
typedef void* cudaStream_t;
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
// The running CUDA thread's state; the scheduler swaps it per fiber.
inline dim3 threadIdx, blockIdx;
inline dim3 blockDim;
inline unsigned turn_ = 0;
namespace emu {
// Every CUDA thread of a block is a fiber on one host thread; a fiber
// runs until it waits at a barrier, then the next one runs.
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  unsigned tid = 0, turn = 0;
  bool done = false;
};
inline ucontext_t sched_;
inline Fiber* cur_;
inline std::function<void()>* body_;
inline unsigned long progress_;  // barrier arrivals and finished fibers
inline void yield_() { swapcontext(&cur_->ctx, &sched_); }
inline void entry_() {
  (*body_)();
  cur_->done = true;
  ++progress_;
}
}  // namespace emu
struct Barrier {
  explicit Barrier(int n) : n_(n) {}
  void arrive_and_wait() {
    const unsigned gen = gen_;
    ++emu::progress_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
    } else {
      while (gen_ == gen) emu::yield_();
    }
  }
  const int n_;
  int count_ = 0;
  unsigned gen_ = 0;
};
// Two buffers, used in turns: a lane writes the next exchange's buffer only
// after the barrier that every lane reaches after reading this one's.
struct Warp { Barrier* bar; int buf[2][32]; };
inline Warp* warps_;
inline Barrier* block_;
inline int lane_() { return threadIdx.x & 31; }
inline Warp& warp_() { return warps_[threadIdx.x >> 5]; }
inline int* post_(int v) {
  Warp& w = warp_();
  int* buf = w.buf[turn_++ & 1];
  buf[lane_()] = v;
  w.bar->arrive_and_wait();
  return buf;
}
inline int exchange_(int v, int src) { return post_(v)[src]; }
inline int __shfl_sync(unsigned, int v, int src) { return exchange_(v, src & 31); }
inline int __shfl_up_sync(unsigned, int v, int d) {
  return exchange_(v, lane_() >= d ? lane_() - d : lane_());
}
inline int __shfl_down_sync(unsigned, int v, int d) {
  return exchange_(v, lane_() + d < 32 ? lane_() + d : lane_());
}
inline int __shfl_xor_sync(unsigned, int v, int m) {
  return exchange_(v, (lane_() ^ m) & 31);
}
inline int __reduce_max_sync(unsigned, int v) {
  const int* buf = post_(v);
  int r = buf[0];
  for (int k = 1; k < 32; ++k) r = std::max(r, buf[k]);
  return r;
}
inline int __reduce_min_sync(unsigned, int v) {
  const int* buf = post_(v);
  int r = buf[0];
  for (int k = 1; k < 32; ++k) r = std::min(r, buf[k]);
  return r;
}
inline void __syncwarp() { warp_().bar->arrive_and_wait(); }
inline void __syncthreads() { block_->arrive_and_wait(); }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
namespace emu {
template <class F>
void launch(unsigned grid, unsigned block, F body) {
  constexpr size_t kStack = 256 << 10;
  blockDim.x = block;
  std::function<void()> fn = body;
  body_ = &fn;
  std::vector<Fiber> fibers(block);
  for (auto& f : fibers) f.stack.reset(new char[kStack]);
  for (unsigned b = 0; b < grid; ++b) {
    Barrier all(block);
    std::vector<std::unique_ptr<Barrier>> bars;
    std::vector<Warp> ws(block / 32);
    for (auto& w : ws) {
      bars.emplace_back(new Barrier(32));
      w.bar = bars.back().get();
    }
    warps_ = ws.data();
    block_ = &all;
    blockIdx.x = b;
    for (unsigned t = 0; t < block; ++t) {
      Fiber& f = fibers[t];
      f.tid = t;
      f.turn = 0;
      f.done = false;
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.get();
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = &sched_;
      makecontext(&f.ctx, entry_, 0);
    }
    for (unsigned live = block; live;) {
      const unsigned long before = progress_;
      live = 0;
      for (auto& f : fibers) {
        if (f.done) continue;
        cur_ = &f;
        threadIdx.x = f.tid;
        turn_ = f.turn;
        swapcontext(&sched_, &f.ctx);
        f.turn = turn_;
        live += !f.done;
      }
      if (live && progress_ == before) {
        std::fprintf(stderr, "emulated block %u: every thread waits\n", b);
        std::abort();
      }
    }
  }
}
}  // namespace emu
"""

LAUNCH = re.compile(r"(\w+)<<<(\w+), (WARPS \* 32), 0, stream>>>\((.*?)\);",
                    re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Build each kernel source against the emulation header; returns the
    libraries, declared by the modules' own ``bind``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("emu")
    (out / "cuda_runtime.h").write_text(EMULATION)
    builds = {}
    for name, mod in (("lane_kernel", lk), ("adaptive_kernel", ak)):
        src = (_build.CSRC / f"{name}.cu").read_text()
        src, n = LAUNCH.subn(r"emu::launch(\2, \3, [=] { \1(\4); });", src)
        assert n == 1, f"{name}: kernel launch not found"
        (out / f"{name}.cpp").write_text(src)
        so = out / f"lib{name}.so"
        # both sources compile at once
        builds[name] = (mod, so, subprocess.Popen(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
             str(out), "-o", str(so), str(out / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (mod, so, proc) in builds.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log.decode()
        libs[name] = mod.bind(ctypes.CDLL(str(so)))
    return libs


def launch(fn, pk, out, *ints, x=-1, trace=None):
    """Call a C entry point; ``trace`` holds the (words, desc, steps)
    buffers of a trace launch."""
    ptrs = [None] * 3 if trace is None else [t.data_ptr() for t in trace]
    err = fn(pk.codes.data_ptr(), pk.qlen.data_ptr(), pk.rlen.data_ptr(),
             pk.table.data_ptr(), out.data_ptr(), *ptrs, *ints, pk.gaps[0],
             pk.gaps[1], x, None)
    assert err == 0
    return out


SETUPS = {"protein": (scores.BLOSUM62, Gaps(-11, -1), chip_smoke.AA),
          "dna": (scores.NW1, Gaps(-2, -1), chip_smoke.DNA)}


@pytest.mark.parametrize("size,setup", [
    ((16, 32), "dna"), ((16, 64), "protein"), ((16, 128), "protein"),
    ((32, 256), "protein"), ((64, 256), "dna"), ((32, 128), "dna"),
], ids=["16-32-dna", "16-64-protein", "16-128-protein", "32-256-protein",
        "64-256-dna", "32-128-dna"])
def test_adaptive_kernel_source_matches_plain(emulated, size, setup):
    """The protein pairs grow to the largest size their ladder allows (up
    to 256) and shrink from 64 rows or more; the DNA pairs have structural
    indels."""
    matrix, gaps, alphabet = SETUPS[setup]
    if setup == "protein":
        pairs = protein_pairs(1, 10)
    else:
        pairs = chip_smoke.structural_pairs(
            np.random.default_rng(size[0] * size[1]), alphabet, 8, 120)
    cfg = ak.AdaptiveKernelConfig(*size, 896, 32 if setup == "protein" else 16)
    pk = lk.pack_lane(pairs, matrix, cfg, gaps, "cpu")
    got = launch(emulated["adaptive_kernel"].adaptive_align_launch, pk,
                 torch.full((len(pairs), 2), -7, dtype=torch.int32),
                 len(pairs), cfg.seq_cap, cfg.alpha, cfg.min_size,
                 cfg.max_size, cfg.max_steps)
    assert torch.equal(got, ak.adaptive_align_plain(*pk, cfg))


def test_adaptive_kernel_source_step_cap(emulated):
    """Pairs past a 12-step cap report the same overrun flags."""
    pairs = chip_smoke.structural_pairs(np.random.default_rng(2),
                                        chip_smoke.AA, 8, 120)
    cfg = ak.AdaptiveKernelConfig(16, 64, 512)
    pk = lk.pack_lane(pairs, scores.BLOSUM62, cfg, Gaps(-11, -1), "cpu")
    capped = chip_smoke.with_step_cap(cfg, 12)
    got = launch(emulated["adaptive_kernel"].adaptive_align_launch, pk,
                 torch.zeros((len(pairs), 2), dtype=torch.int32), len(pairs),
                 cfg.seq_cap, cfg.alpha, cfg.min_size, cfg.max_size,
                 capped.max_steps)
    want = ak.adaptive_align_plain(*pk, capped)
    assert torch.equal(got, want) and 0 < int(got[:, 1].sum()) < len(pairs)


@pytest.mark.parametrize("size,setup,x,steps", [
    ((16, 64), "protein", 50, None), ((32, 256), "dna", 20, None),
    ((16, 64), "protein", 50, 12),
], ids=["16-64-protein", "32-256-dna", "16-64-capped"])
def test_adaptive_kernel_source_x_drop_matches_plain(emulated, size, setup, x,
                                                     steps):
    """All four outputs (best score, its position, overrun) equal the plain
    version's, with grows, x-drop ends and, under a 12-step cap,
    overruns."""
    matrix, gaps, alphabet = SETUPS[setup]
    if setup == "protein":
        pairs = protein_pairs(3, 10)
    else:
        pairs = chip_smoke.structural_pairs(np.random.default_rng(x), alphabet,
                                            8, 120)
    cfg = ak.AdaptiveKernelConfig(*size, 896, 32 if setup == "protein" else 16,
                                  x_drop=True)
    if steps:
        cfg = chip_smoke.with_step_cap(cfg, steps)
    pk = lk.pack_lane(pairs, matrix, cfg, gaps, "cpu", x_drop=x)
    got = launch(emulated["adaptive_kernel"].adaptive_align_launch, pk,
                 torch.full((len(pairs), 4), -7, dtype=torch.int32),
                 len(pairs), cfg.seq_cap, cfg.alpha, cfg.min_size,
                 cfg.max_size, cfg.max_steps, x=x)
    assert torch.equal(got, ak.adaptive_align_plain(*pk, cfg))
    if steps:
        assert 0 < int(got[:, 3].sum()) < len(pairs)
    else:
        assert not got[:, 3].any() and chip_smoke.x_dropped(got, pk) > 0


@pytest.mark.parametrize("S", [16, 32, 256, 512])
def test_lane_kernel_source_matches_plain(emulated, S):
    rng = np.random.default_rng(S)
    pairs = chip_smoke.random_pairs(rng, chip_smoke.AA, 8, 120)
    cfg = lk.LaneKernelConfig(S, 768)
    pk = lk.pack_lane(pairs, scores.BLOSUM62, cfg, Gaps(-11, -1), "cpu")
    got = launch(emulated["lane_kernel"].lane_align_launch, pk,
                 torch.full((len(pairs), 2), -7, dtype=torch.int32),
                 len(pairs), cfg.seq_cap, cfg.alpha, cfg.block, cfg.max_steps)
    assert torch.equal(got, lk.lane_align_plain(*pk, cfg))


@pytest.mark.parametrize("S,setup,x", [(16, "dna", 20), (32, "protein", 50),
                                       (512, "protein", 30)],
                         ids=["16-dna", "32-protein", "512-protein"])
def test_lane_kernel_source_x_drop_matches_plain(emulated, S, setup, x):
    """All four outputs (best score, its position, suspect) equal the plain
    version's; the unrelated pairs end by x-drop before both ends."""
    matrix, gaps, alphabet = SETUPS[setup]
    pairs = chip_smoke.random_pairs(np.random.default_rng(S + x), alphabet,
                                    10, 120)
    cfg = lk.LaneKernelConfig(S, 768, 32 if setup == "protein" else 16,
                              x_drop=True)
    pk = lk.pack_lane(pairs, matrix, cfg, gaps, "cpu", x_drop=x)
    got = launch(emulated["lane_kernel"].lane_align_launch, pk,
                 torch.full((len(pairs), 4), -7, dtype=torch.int32),
                 len(pairs), cfg.seq_cap, cfg.alpha, cfg.block, cfg.max_steps,
                 x=x)
    assert torch.equal(got, lk.lane_align_plain(*pk, cfg))
    assert chip_smoke.x_dropped(got, pk) > 0


def poisoned_trace(cfg, B, rows):
    """Trace buffers of a launch, filled with -5 where the kernel writes
    nothing (unwritten device memory holds anything)."""
    return (torch.full((cfg.max_steps, B, rows), -5, dtype=torch.int32),
            torch.full((cfg.max_steps, B, 4), -5, dtype=torch.int32),
            torch.full((B,), -5, dtype=torch.int32))


@pytest.mark.parametrize("S,setup,x", [
    (16, "dna", -1), (32, "protein", -1), (512, "protein", -1),
    (16, "dna", 20), (32, "protein", 50), (512, "protein", 30),
], ids=["16-dna", "32-protein", "512-protein", "16-dna-x-drop",
        "32-protein-x-drop", "512-protein-x-drop"])
def test_lane_kernel_source_trace_matches_plain(emulated, S, setup, x):
    """Trace instances: outputs, step counts, the descriptors of every
    executed step and its words equal the plain version's, freezing steps
    included."""
    matrix, gaps, alphabet = SETUPS[setup]
    pairs = chip_smoke.random_pairs(np.random.default_rng(S + x), alphabet,
                                    10 if S < 512 else 6, 120)
    cfg = lk.LaneKernelConfig(S, 768, 32 if setup == "protein" else 16,
                              x_drop=x >= 0, trace=True)
    pk = lk.pack_lane(pairs, matrix, cfg, gaps, "cpu", x_drop=max(x, 0))
    bufs = poisoned_trace(cfg, len(pairs), S)
    got = launch(emulated["lane_kernel"].lane_align_launch, pk,
                 torch.full((len(pairs), 4 if x >= 0 else 2), -7,
                            dtype=torch.int32),
                 len(pairs), cfg.seq_cap, cfg.alpha, cfg.block, cfg.max_steps,
                 x=x, trace=bufs)
    chip_smoke.check_trace((got, *bufs), lk.lane_align_plain(*pk, cfg),
                           f"lane trace S={S}")


@pytest.mark.parametrize("size,setup,x,steps", [
    ((16, 32), "dna", -1, None), ((32, 512), "protein", -1, None),
    ((16, 64), "protein", -1, 12), ((32, 512), "protein", 50, None),
], ids=["16-32-dna", "32-512-protein", "16-64-capped", "32-512-x-drop"])
def test_adaptive_kernel_source_trace_matches_plain(emulated, size, setup, x,
                                                    steps):
    """Trace instances, S = 512 included: as for the lane kernel, with the
    checkpoint saves and restores in the descriptors; under a 12-step cap
    the pairs that overrun report the cap as their step count.  At (32,
    512) the first pair's blocks grow to 512 rows, global and x-drop."""
    matrix, gaps, alphabet = SETUPS[setup]
    if size == (32, 512):
        # the pair that crosses its insertion, or the one x-drop ends
        pairs = [grown_pairs()[1 if x >= 0 else 0]] + protein_pairs(1, 6)
    elif setup == "protein":
        pairs = protein_pairs(1, 8)
    else:
        pairs = chip_smoke.structural_pairs(
            np.random.default_rng(size[0] * size[1]), alphabet, 8, 120)
    cfg = ak.AdaptiveKernelConfig(*size, 1536 if size[1] == 512 else 896,
                                  32 if setup == "protein" else 16,
                                  x_drop=x >= 0, trace=True)
    if steps:
        cfg = chip_smoke.with_step_cap(cfg, steps)
    pk = lk.pack_lane(pairs, matrix, cfg, gaps, "cpu", x_drop=max(x, 0))
    bufs = poisoned_trace(cfg, len(pairs), size[1])
    got = launch(emulated["adaptive_kernel"].adaptive_align_launch, pk,
                 torch.full((len(pairs), 4 if x >= 0 else 2), -7,
                            dtype=torch.int32),
                 len(pairs), cfg.seq_cap, cfg.alpha, cfg.min_size,
                 cfg.max_size, cfg.max_steps, x=x, trace=bufs)
    saves, restores = chip_smoke.check_trace(
        (got, *bufs), ak.adaptive_align_plain(*pk, cfg),
        f"adaptive trace {size}")
    assert saves > 0 and restores > 0
    if steps:
        assert 0 < int(got[:, 1].sum()) < len(pairs)
    if size == (32, 512):
        ran = torch.arange(cfg.max_steps) < bufs[2][0]
        assert int(torch.where(ran, bufs[1][:, 0, 3], 0).max()) == 512
        assert x < 0 or int(got[0, 1]) < len(pairs[0][0])  # x-drop ends


def test_entry_points_reject_bad_arguments(emulated):
    pk = lk.pack_lane([(b"A", b"A")], scores.BLOSUM62,
                      lk.LaneKernelConfig(16, 256), Gaps(-11, -1), "cpu")
    out = torch.zeros((1, 2), dtype=torch.int32)
    bad = emulated["adaptive_kernel"].adaptive_align_launch(
        pk.codes.data_ptr(), pk.qlen.data_ptr(), pk.rlen.data_ptr(),
        pk.table.data_ptr(), out.data_ptr(), None, None, None, 1, 256, 32,
        32, 32, 100, -11, -1, -1, None)
    assert bad != 0  # min == max is not an adaptive configuration
    msg = emulated["adaptive_kernel"].adaptive_error_string(bad)
    assert msg == b"emulated"
    cfg = ak.AdaptiveKernelConfig(32, 512, 1152, trace=True)
    pk = lk.pack_lane([(b"A", b"A")], scores.BLOSUM62, cfg, Gaps(-11, -1),
                      "cpu")
    args = (pk.codes.data_ptr(), pk.qlen.data_ptr(), pk.rlen.data_ptr(),
            pk.table.data_ptr(), out.data_ptr())
    ints = (1, cfg.seq_cap, 32, 32, 512, cfg.max_steps, -11, -1, -1, None)
    fn = emulated["adaptive_kernel"].adaptive_align_launch
    assert fn(*args, None, None, None, *ints) != 0  # 512 needs trace
    bufs = poisoned_trace(cfg, 1, 512)
    assert fn(*args, bufs[0].data_ptr(), None, None, *ints) != 0
    assert fn(*args, *(b.data_ptr() for b in bufs), *ints) == 0
    assert int(bufs[2][0]) == 1 and tuple(out[0].tolist()) == (4, 0)
