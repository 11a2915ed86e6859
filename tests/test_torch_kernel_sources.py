"""The CUDA sources themselves on the CPU: ``csrc/lane_kernel.cu``,
``csrc/adaptive_kernel.cu`` and ``csrc/big_kernel.cu`` compiled as C++
against a small header that emulates the few CUDA features they use, called
through their own C entry points and ``bind``, and held exactly against the
plain versions, in global, x-drop and trace mode.

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
from block_aligner_tpu_torch.ops._profile import pack_profile
from block_aligner_tpu_torch.ops import adaptive_kernel as ak
from block_aligner_tpu_torch.ops import big_kernel as bk
from block_aligner_tpu_torch.ops import lane_kernel as lk
from test_torch_adaptive_kernel import protein_pairs
from test_torch_trace import grown_pairs
from test_torch_byte import rail_pairs

EMULATION = r"""
#pragma once
#include <setjmp.h>
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
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)
typedef int cudaError_t;
typedef void* cudaStream_t;
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct alignas(8) int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
// The running CUDA thread's state; the scheduler swaps it per fiber.
inline dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline unsigned turn_ = 0;
namespace emu {
// Every CUDA thread of a block is a fiber on one host thread; a fiber
// runs until it waits at a barrier, then the next one runs.  A fiber starts
// on its own stack through swapcontext, and every later switch is a
// _setjmp / _longjmp pair, which unlike swapcontext makes no system call
// for the signal mask.
struct Fiber {
  ucontext_t ctx;
  jmp_buf jb;
  std::unique_ptr<char[]> stack;
  unsigned tid = 0, turn = 0;
  bool done = false, started = false;
};
inline ucontext_t sched_;
inline jmp_buf sched_jb_;
inline Fiber* cur_;
inline std::function<void()>* body_;
inline unsigned long progress_;  // barrier arrivals and finished fibers
inline void yield_() {
  if (!_setjmp(cur_->jb)) _longjmp(sched_jb_, 1);
}
inline void entry_() {
  (*body_)();
  cur_->done = true;
  ++progress_;
  _longjmp(sched_jb_, 1);
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
inline bool __any_sync(unsigned, int v) {
  const int* buf = post_(v != 0);
  for (int k = 0; k < 32; ++k)
    if (buf[k]) return true;
  return false;
}
inline int __reduce_min_sync(unsigned, int v) {
  const int* buf = post_(v);
  int r = buf[0];
  for (int k = 1; k < 32; ++k) r = std::min(r, buf[k]);
  return r;
}
inline void __syncwarp() { warp_().bar->arrive_and_wait(); }
inline void __syncthreads() { block_->arrive_and_wait(); }
// named barriers (bar.sync id, n): made at a block's first use of an id
inline std::unique_ptr<Barrier>* named_;
inline void named_sync_(int id, int n) {
  if (!named_[id]) named_[id].reset(new Barrier(n));
  named_[id]->arrive_and_wait();
}
#define BIG_NAMED_SYNC(id, n) named_sync_(id, n)
#define LANE_NAMED_SYNC(id, n) named_sync_(id, n)
// Hopper's DPX instructions
inline int __viaddmax_s32(int a, int b, int c) { return std::max(a + b, c); }
inline int __vimax3_s32(int a, int b, int c) {
  return std::max(std::max(a, b), c);
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// an emulated device of 16 SMs
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 16;
  return cudaSuccess;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
namespace emu {
template <class F>
void launch(unsigned grid, unsigned block, F body) {
  constexpr size_t kStack = 256 << 10;
  blockDim.x = block;
  gridDim.x = grid;
  std::function<void()> fn = body;
  body_ = &fn;
  std::vector<Fiber> fibers(block);
  for (auto& f : fibers) f.stack.reset(new char[kStack]);
  for (unsigned b = 0; b < grid; ++b) {
    Barrier all(block);
    std::unique_ptr<Barrier> named[16];
    named_ = named;
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
      f.done = f.started = false;
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
        if (!_setjmp(sched_jb_)) {
          if (f.started) _longjmp(f.jb, 1);
          f.started = true;
          swapcontext(&sched_, &f.ctx);
        }
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
// A launch with dynamic shared memory: one buffer for the block at work,
// filled with junk, as the card's is.
inline std::vector<char> dynamic_;
template <class F>
void launch_shared(unsigned grid, unsigned block, size_t bytes, F body) {
  dynamic_.assign(bytes, 0x5a);
  launch(grid, block, body);
}
}  // namespace emu
"""

LAUNCH = re.compile(r"(\w+)<<<(\w+), (WARPS \* 32|threads), 0, stream>>>"
                    r"\((.*?)\);", re.S)
# csrc/big_kernel.cu: a launch with dynamic shared memory, and its
# declaration
BIG_LAUNCH = re.compile(r"(\w+)<<<(\w+), (\w+), (\w+), stream>>>"
                        r"\((.*?)\);", re.S)
BIG_SHARED = "extern __shared__ __align__(16) short planes[];"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Build each kernel source, and each profile library around it,
    against the emulation header; returns the libraries, declared by the
    modules' own ``bind``."""
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
        # the profile libraries include the kernel source by this name
        (out / f"{name}.cu").write_text(src)
    src = (_build.CSRC / f"{bk.LIBRARY}.cu").read_text()
    src, n = BIG_LAUNCH.subn(
        r"emu::launch_shared(\2, \3, \4, [=] { \1(\5); });", src)
    assert n == 1 and src.count(BIG_SHARED) == 1, "big kernel launch not found"
    src = src.replace(BIG_SHARED, "short* const planes = "
                      "reinterpret_cast<short*>(emu::dynamic_.data());")
    (out / f"{bk.LIBRARY}.cu").write_text(src)
    for name in (*lk.LIBRARIES, *bk.LIBRARIES):
        mod = {"lane": lk, "adaptive": ak}.get(name.split("_")[0], bk)
        (out / f"{name}.cpp").write_text(
            (out / f"{name}.cu").read_text() if name.endswith("kernel")
            else (_build.CSRC / f"{name}.cu").read_text())
        so = out / f"lib{name}.so"
        # all twelve compile at once
        # no _FORTIFY_SOURCE: its _longjmp refuses to switch stacks
        builds[name] = (mod, so, subprocess.Popen(
            [gxx, "-std=c++17", "-O1", "-U_FORTIFY_SOURCE", "-shared", "-fPIC",
             "-I",
             str(out), "-o", str(so), str(out / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (mod, so, proc) in builds.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log.decode()
        libs[name] = mod.bind(ctypes.CDLL(str(so)))
    return libs


def launch(fn, pk, out, *ints, x=-1, trace=None, cfg=None):
    """Call a C entry point; ``trace`` holds the (words, desc, steps)
    buffers of a trace launch; ``cfg`` gives the flags and byte mode of a
    flags library's launch."""
    ptrs = [None] * 3 if trace is None else [t.data_ptr() for t in trace]
    modes = (0, 0, 0) if cfg is None else lk.mode_args(pk.gaps, cfg)
    err = fn(pk.codes.data_ptr(), pk.qlen.data_ptr(), pk.rlen.data_ptr(),
             pk.table.data_ptr(), out.data_ptr(), *ptrs, *ints, pk.gaps[0],
             pk.gaps[1], x, *modes, None)
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


def test_lane_kernel_source_x_drop_ties_across_warps(emulated):
    """At S = 512 a pair takes 4 warps.  With gap costs of 0 a block's
    maximum spreads down its columns, so at the decision every 16-row
    chunk of the block ties: the best's position is the highest chunk's,
    in the pair's last warp (query row 496 of the first block), equal to
    the plain version's."""
    pairs = chip_smoke.random_pairs(np.random.default_rng(512), chip_smoke.DNA,
                                    8, 400)
    cfg = lk.LaneKernelConfig(512, 1024, 16, x_drop=True)
    pk = lk.pack_lane(pairs, scores.NW1, cfg, Gaps(0, 0), "cpu", x_drop=30)
    got = launch(emulated["lane_kernel"].lane_align_launch, pk,
                 torch.full((len(pairs), 4), -7, dtype=torch.int32),
                 len(pairs), cfg.seq_cap, cfg.alpha, cfg.block, cfg.max_steps,
                 x=30)
    assert torch.equal(got, lk.lane_align_plain(*pk, cfg))
    assert int(got[:, 1].max()) >= 3 * 128  # a row of the fourth warp


def test_lane_launch_shape(emulated):
    """At S = 512 a pair takes 4 warps in a launch of at most one pair an
    SM (16 on the emulated device) and 2 in a larger one; 1 at S <= 256; a
    block holds 128 threads."""
    got = (ctypes.c_int * 5)()
    fn = emulated["lane_kernel"].lane_launch_shape
    for block, B, warps, pairs in ((512, 16, 4, 1), (512, 17, 2, 2),
                                   (256, 3, 1, 4), (32, 5000, 1, 4)):
        assert fn(block, B, 0, 0, ctypes.addressof(got)) == 0
        assert (got[0], got[2], got[3]) == (128, warps, pairs)
    assert fn(48, 1, 0, 0, ctypes.addressof(got)) != 0


@pytest.mark.parametrize("mode", ["global", "x-drop-trace", "local-trace",
                                  "profile-x-drop-trace"])
def test_lane_kernel_source_two_warp_pairs(emulated, mode):
    """A launch of more pairs than the emulated device's 16 SMs at S = 512
    takes 2 warps a pair, 8 rows a lane: global, x-drop traced, local start
    traced (its zero-bit words) and a profile x-drop traced on pairs that
    run past the block, equal to the plain version's."""
    rng = np.random.default_rng(len(mode))
    profile = mode.startswith("profile")
    x = 50 if "x-drop" in mode else -1
    cfg = lk.LaneKernelConfig(512, 1664, x_drop=x >= 0, trace=True,
                              profile=profile,
                              local_start=mode.startswith("local"))
    if mode == "global":
        cfg = lk.LaneKernelConfig(512, 1664)
    if profile:
        pairs = chip_smoke.profile_pairs(rng, 20, 900)
        pk = pack_profile(pairs, cfg, "cpu", x_drop=max(x, 0))
    else:
        pairs = chip_smoke.structural_pairs(rng, chip_smoke.AA, 20, 900)
        pk = lk.pack_lane(pairs, scores.BLOSUM62, cfg, Gaps(-11, -1), "cpu",
                          x_drop=max(x, 0))
    tw = lk.trace_words(cfg)
    bufs = poisoned_trace(cfg, len(pairs), 512 * tw) if cfg.trace else None
    fn = emulated[lk.library("lane", cfg)].lane_align_launch
    got = launch(fn, pk, torch.full((len(pairs), 4 if x >= 0 else 2), -7,
                                    dtype=torch.int32),
                 len(pairs), cfg.seq_cap, cfg.alpha, cfg.block, cfg.max_steps,
                 x=x, trace=bufs, cfg=cfg)
    want = lk.lane_align_plain(*pk, cfg)
    if cfg.trace:
        chip_smoke.check_trace((got, *bufs), want, mode, tw)
    else:
        assert torch.equal(got, want)


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
        32, 32, 100, -11, -1, -1, 0, 0, 0, None)
    assert bad != 0  # min == max is not an adaptive configuration
    msg = emulated["adaptive_kernel"].adaptive_error_string(bad)
    assert msg == b"emulated"
    cfg = ak.AdaptiveKernelConfig(32, 512, 1152, trace=True)
    pk = lk.pack_lane([(b"A", b"A")], scores.BLOSUM62, cfg, Gaps(-11, -1),
                      "cpu")
    args = (pk.codes.data_ptr(), pk.qlen.data_ptr(), pk.rlen.data_ptr(),
            pk.table.data_ptr(), out.data_ptr())
    ints = (1, cfg.seq_cap, 32, 32, 512, cfg.max_steps, -11, -1, -1, 0, 0, 0,
            None)
    fn = emulated["adaptive_kernel"].adaptive_align_launch
    assert fn(*args, None, None, None, *ints) != 0  # 512 needs trace
    bufs = poisoned_trace(cfg, 1, 512)
    assert fn(*args, bufs[0].data_ptr(), None, None, *ints) != 0
    assert fn(*args, *(b.data_ptr() for b in bufs), *ints) == 0
    assert int(bufs[2][0]) == 1 and tuple(out[0].tolist()) == (4, 0)


@pytest.mark.parametrize("S,x,trace", [
    (32, -1, False), (16, 50, False), (64, 20, False), (32, -1, True),
    (16, 50, True), (512, 50, True),
], ids=["32-global", "16-x-drop", "64-x-drop", "32-trace", "16-x-drop-trace",
        "512-x-drop-trace"])
def test_lane_kernel_source_profile_matches_plain(emulated, S, x, trace):
    """Profile instances: profiles with varied gap opens and nonzero close
    costs, a few query bytes outside A..Z; outputs (and in trace mode step
    counts, descriptors and words) equal the plain version's.  At S = 512
    (4 warps a pair) the pairs run past the block, so down steps close R
    across the warps' boundaries."""
    long = S == 512
    pairs = chip_smoke.profile_pairs(np.random.default_rng(S + x),
                                     6 if long else 12, 1000 if long else 120)
    cfg = lk.LaneKernelConfig(S, 1664 if long else 768, x_drop=x >= 0,
                              trace=trace, profile=True)
    pk = pack_profile(pairs, cfg, "cpu", x_drop=max(x, 0))
    bufs = poisoned_trace(cfg, len(pairs), S) if trace else None
    got = launch(emulated["lane_profile"].lane_align_launch, pk,
                 torch.full((len(pairs), 4 if x >= 0 else 2), -7,
                            dtype=torch.int32),
                 len(pairs), cfg.seq_cap, cfg.alpha, cfg.block, cfg.max_steps,
                 x=x, trace=bufs)
    want = lk.lane_align_plain(*pk, cfg)
    if trace:
        chip_smoke.check_trace((got, *bufs), want, f"lane profile trace {S}")
    else:
        assert torch.equal(got, want)
    if x >= 0:
        assert chip_smoke.x_dropped(got, pk) > 0


@pytest.mark.parametrize("size,x,trace", [
    ((16, 64), -1, False), ((16, 64), 50, False), ((32, 512), -1, False),
    ((32, 512), -1, True), ((32, 512), 50, True),
], ids=["16-64-global", "16-64-x-drop", "32-512-global", "32-512-trace",
        "32-512-x-drop-trace"])
def test_adaptive_kernel_source_profile_matches_plain(emulated, size, x,
                                                      trace):
    """Profile instances, S = 512 without trace included: at (32, 512) the
    first pair's profile holds 300 inserted residues and its blocks grow to
    512 rows; the other pairs as in the lane case."""
    rng = np.random.default_rng(size[1] + x)
    pairs = chip_smoke.profile_pairs(rng, 8, 120)
    if size[1] == 512:
        pairs = chip_smoke.grow_profile_pairs(rng, 1) + pairs[:5]
    cfg = ak.AdaptiveKernelConfig(*size, 1408 if size[1] == 512 else 768,
                                  x_drop=x >= 0, trace=trace, profile=True)
    pk = pack_profile(pairs, cfg, "cpu", x_drop=max(x, 0))
    bufs = poisoned_trace(cfg, len(pairs), size[1]) if trace else None
    got = launch(emulated["adaptive_profile"].adaptive_align_launch, pk,
                 torch.full((len(pairs), 4 if x >= 0 else 2), -7,
                            dtype=torch.int32),
                 len(pairs), cfg.seq_cap, cfg.alpha, cfg.min_size,
                 cfg.max_size, cfg.max_steps, x=x, trace=bufs)
    want = ak.adaptive_align_plain(*pk, cfg)
    if trace:
        saves, restores = chip_smoke.check_trace(
            (got, *bufs), want, f"adaptive profile trace {size}")
        assert saves > 0 and restores > 0
        ran = torch.arange(cfg.max_steps) < bufs[2][0]
        assert int(torch.where(ran, bufs[1][:, 0, 3], 0).max()) == 512
    else:
        assert torch.equal(got, want)


FLAG_MODES = {"byte": dict(byte_mode=True), "local": dict(local_start=True),
              "fstart": dict(free_query_start_gaps=True),
              "fend": dict(free_query_end_gaps=True),
              "byte-fend": dict(byte_mode=True, free_query_end_gaps=True),
              "byte-local": dict(byte_mode=True, local_start=True)}


@pytest.mark.parametrize("size,mode,x,trace,profile", [
    ((16, 16), "byte", -1, False, False), ((32, 32), "byte", -1, True, False),
    ((16, 16), "byte-fend", -1, True, False),
    ((32, 32), "local", -1, True, False), ((16, 16), "local", 30, True, False),
    ((32, 32), "fstart", -1, False, False),
    ((64, 64), "fstart", 30, True, False),
    ((32, 32), "fend", -1, False, False), ((64, 64), "fend", -1, True, False),
    ((32, 32), "local", -1, True, True), ((16, 16), "fend", -1, False, True),
    ((16, 64), "byte", -1, False, False), ((16, 32), "byte", -1, True, False),
    ((16, 32), "byte-local", -1, False, False),
    ((16, 64), "local", -1, True, False), ((16, 64), "local", 40, False, False),
    ((16, 64), "fstart", -1, True, False),
    ((32, 128), "fend", -1, False, False),
    ((32, 128), "fend", -1, True, False),
    ((16, 64), "fstart", -1, True, True),
    ((32, 512), "local", -1, True, False),
    ((512, 512), "local", -1, True, False),
    ((256, 256), "fend", -1, True, False),
], ids=lambda v: str(v))
def test_kernel_source_flags_match_plain(emulated, size, mode, x, trace,
                                         profile):
    """The instances of the flags libraries (``csrc/*_flags.cu``):
    ByteMatrix on pairs over all 256 bytes (byte 0 included), local start,
    free start and free end gaps (queries shorter than the min size), with
    x-drop where the flag allows it, trace, profiles, adaptive blocks that
    grow (at (32, 512) a pair whose blocks reach 512 rows); outputs, and in
    trace mode step counts, descriptors and words (local start's zero bits
    included), equal the plain version's."""
    lo, hi = size
    modes = FLAG_MODES[mode]
    rng = np.random.default_rng(hi + x + len(mode))
    kw = dict(x_drop=x >= 0, trace=trace, profile=profile, **modes)
    byte = modes.get("byte_mode", False)
    alpha = 256 if byte else 32
    cap = 1536 if hi == 512 else 768
    if lo == hi:
        cfg = lk.LaneKernelConfig(hi, cap, alpha, **kw)
        ints = (cfg.seq_cap, alpha, hi, cfg.max_steps)
    else:
        cfg = ak.AdaptiveKernelConfig(lo, hi, cap, alpha, **kw)
        ints = (cfg.seq_cap, alpha, lo, hi, cfg.max_steps)
    if byte:
        pairs = chip_smoke.byte_pairs(rng, 10, 120)
    elif profile:
        pairs = chip_smoke.profile_pairs(rng, 10, 120)
    elif hi == 512:
        pairs = [grown_pairs()[0]] + protein_pairs(1, 5)
    elif mode in ("fstart", "fend"):
        # rarer events (a grow from a checkpoint at query row 0, a tracker
        # row past qlen) need more and longer pairs
        pairs = chip_smoke.structural_pairs(rng, chip_smoke.AA, 40, 300)
    else:
        pairs = chip_smoke.structural_pairs(rng, chip_smoke.AA, 16, 150)
    if cfg.free_query_end_gaps:
        pairs = [(q[: lo - 1], r) for q, r in pairs]
    if profile:
        pk = pack_profile(pairs, cfg, "cpu", x_drop=max(x, 0))
    else:
        matrix = scores.BYTES1 if byte else scores.BLOSUM62
        pk = lk.pack_lane(pairs, matrix, cfg, Gaps(-11, -1), "cpu",
                          x_drop=max(x, 0))
    name = lk.library("lane" if lo == hi else "adaptive", cfg)
    fn = getattr(emulated[name], ("lane" if lo == hi else "adaptive")
                 + "_align_launch")
    tw = lk.trace_words(cfg)
    bufs = poisoned_trace(cfg, len(pairs), hi * tw) if trace else None
    got = launch(fn, pk, torch.full((len(pairs), 4 if lk.wide(cfg) else 2),
                                    -7, dtype=torch.int32),
                 len(pairs), *ints, x=x, trace=bufs, cfg=cfg)
    want = (lk.lane_align_plain if lo == hi
            else ak.adaptive_align_plain)(*pk, cfg)
    if trace:
        chip_smoke.check_trace((got, *bufs), want, f"{mode} {size}", tw)
        if hi == 512:
            ran = torch.arange(cfg.max_steps) < bufs[2][0]
            assert int(torch.where(ran, bufs[1][:, 0, 3], 0).max()) == 512
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("size,trace", [((512, 512), False),
                                        ((16, 512), True)],
                         ids=["lane", "adaptive-trace"])
def test_kernel_source_upper_rail(emulated, size, trace):
    """The byte instances on ``test_torch_byte.rail_pairs``: D saturates at
    the upper i16 rail, so the scores are ``BlockOracle``'s (16383 and
    36972), equal to the plain versions', and so are the traces."""
    lo, hi = size
    pair = rail_pairs()[0 if lo == hi else 1]
    kw = dict(trace=trace, byte_mode=True)
    if lo == hi:
        cfg = lk.LaneKernelConfig(hi, 1024, 256, **kw)
        ints = (cfg.seq_cap, 256, hi, cfg.max_steps)
    else:
        cfg = ak.AdaptiveKernelConfig(lo, hi, 1280, 256, **kw)
        ints = (cfg.seq_cap, 256, lo, hi, cfg.max_steps)
    pk = lk.pack_lane([pair], scores.ByteMatrix(100, -1), cfg, Gaps(-11, -1),
                      "cpu")
    kernel = "lane" if lo == hi else "adaptive"
    fn = getattr(emulated[lk.library(kernel, cfg)], kernel + "_align_launch")
    bufs = poisoned_trace(cfg, 1, hi) if trace else None
    got = launch(fn, pk, torch.full((1, 2), -7, dtype=torch.int32), 1, *ints,
                 trace=bufs, cfg=cfg)
    want = (lk.lane_align_plain if lo == hi
            else ak.adaptive_align_plain)(*pk, cfg)
    if trace:
        chip_smoke.check_trace((got, *bufs), want, f"rail {size}")
    else:
        assert torch.equal(got, want)
    assert int(got[0, 0]) == (16383 if lo == hi else 36972)


def big_launch(lib, pk, cfg, x=-1):
    """``csrc/big_kernel.cu``'s entry point on a packed batch, with
    ``cfg``'s flags; with ``cfg.trace`` (the libraries of
    ``csrc/big_trace.cu`` and ``csrc/big_trace_flags.cu``) it returns
    ``(out, words, desc, steps, used)``, the trace buffers filled with -5
    where the kernel writes nothing.  Past 8192 rows the checkpoint scratch
    starts filled with junk, as ``torch.empty`` leaves it on the card."""
    B = pk.codes.shape[0]
    scratch = (torch.full((B, 4, cfg.max_size), 0x5a5a, dtype=torch.int16)
               if cfg.max_size > 8192 else None)
    out = torch.full((B, 4 if lk.wide(cfg) else 2), -7, dtype=torch.int32)
    bufs = ((torch.full((B, cfg.trace_budget), -5, dtype=torch.int32),
             torch.full((cfg.max_steps, B, 5), -5, dtype=torch.int32),
             torch.full((B,), -5, dtype=torch.int32),
             torch.full((B,), -5, dtype=torch.int32)) if cfg.trace else ())
    err = lib.big_align_launch(
        pk.codes.data_ptr(), pk.qlen.data_ptr(), pk.rlen.data_ptr(),
        pk.table.data_ptr(), out.data_ptr(),
        *([t.data_ptr() for t in bufs] or [None] * 4),
        None if scratch is None else scratch.data_ptr(), B, cfg.seq_cap,
        cfg.alpha, cfg.min_size, cfg.max_size, cfg.max_steps, pk.gaps[0],
        pk.gaps[1], x, cfg.trace_budget if cfg.trace else 0,
        *lk.mode_args(pk.gaps, cfg), cfg.prof_cap, None)
    assert err == 0
    return (out, *bufs) if cfg.trace else out


@pytest.mark.parametrize("size,setup,x", [
    ((32, 512), "protein", -1), ((64, 1024), "dna", -1),
    ((32, 512), "protein", 50), ((128, 1024), "dna", 20),
    ((1024, 1024), "protein", -1), ((2048, 4096), "dna", -1),
    ((256, 2048), "dna", -1), ((256, 2048), "protein", 30),
], ids=["32-512-protein", "64-1024-dna", "32-512-x-drop",
        "128-1024-dna-x-drop", "1024-1024-protein", "2048-4096-dna",
        "256-2048-dna", "256-2048-x-drop"])
def test_big_kernel_source_matches_plain(emulated, size, setup, x):
    """Big-kernel instances against the plain version: edge cases, homologs
    with indels and unrelated pairs, which freeze or end by x-drop at
    different steps and heights beside each other in a block (4 one-warp
    pairs a block at (32, 512), (64, 1024) and (128, 1024), 2 two-warp
    pairs at (256, 2048), each pair's warps at a named barrier of their
    own); at (32, 512) a pair whose blocks grow to 512 rows (16 rows a
    thread), at (1024, 1024) fixed blocks of 1024 rows (four warps, 8 rows
    a thread), and at (2048, 4096) four warps of 16 rows a thread."""
    matrix, gaps, alphabet = SETUPS[setup]
    rng = np.random.default_rng(size[1] + x)
    pairs = chip_smoke.structural_pairs(rng, alphabet, 8, 200)
    if size == (32, 512):
        pairs = [grown_pairs()[1 if x >= 0 else 0]] + pairs
    cfg = bk.BigKernelConfig(*size, 1664 if size[1] == 512 else 4352,
                             32 if setup == "protein" else 16, x_drop=x >= 0)
    pk = bk.pack_big(pairs, matrix, cfg, gaps, "cpu", x_drop=max(x, 0))
    got = big_launch(emulated[bk.LIBRARY], pk, cfg, x)
    assert torch.equal(got, bk.big_align_plain(*pk, cfg))
    if x >= 0:
        assert chip_smoke.x_dropped(got, pk) > 0


def test_big_entry_point_matches_binding(emulated):
    """The C signature of ``csrc/big_kernel.cu`` and its ctypes argument
    list agree (5 pointers for the inputs and the output, 4 for the trace
    buffers, the checkpoint scratch, 14 ints, the stream); the entry point
    refuses sizes the big route does not take, trace buffers in the library
    without trace and their absence in the trace library
    (``csrc/big_trace.cu``), and reports its launch shape (threads a
    block, dynamic shared bytes, blocks an SM, threads a pair, pairs a
    block, pairs an SM): one warp a pair and 4 pairs a block at (16, 1024),
    2 warps and 2 pairs at (256, 2048), 4 warps at (512, 1024) and (2048,
    2048), at (512, 8192) 4 in the global library and 8 in the others, a
    pair's planes 16 bytes a row in every mode
    (trace, local start's trace and profiles stage nothing in shared
    memory).  The 16384-row libraries (``csrc/big_16384.cu``,
    ``csrc/big_trace_16384.cu``) take max size 16384 and a scratch only,
    and the others neither; they run 16 warps a pair and their planes take
    8 bytes a row."""
    src = (_build.CSRC / f"{bk.LIBRARY}.cu").read_text()
    sig = re.search(r'extern "C" int big_align_launch\((.*?)\)', src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    lib, tlib = emulated[bk.LIBRARY], emulated[bk.TRACE_LIBRARY]
    assert [p.startswith(("const void*", "void*")) for p in params] == \
        [True] * 10 + [False] * 14 + [True]
    assert len(lib.big_align_launch.argtypes) == len(params)
    assert _build.library_path(bk.LIBRARY).name.startswith("libbig_kernel-")
    cfg = bk.BigKernelConfig(16, 1024, 1152)
    pk = bk.pack_big([(b"A", b"A")], scores.BLOSUM62, cfg, Gaps(-11, -1),
                     "cpu")
    out = torch.zeros((1, 2), dtype=torch.int32)
    ptrs = (pk.codes.data_ptr(), pk.qlen.data_ptr(), pk.rlen.data_ptr(),
            pk.table.data_ptr(), out.data_ptr())
    for lo, hi in [(16, 256), (32, 16384), (512, 512), (24, 1024),
                   (2048, 1024)]:
        assert lib.big_align_launch(
            *ptrs, None, None, None, None, None, 1, cfg.seq_cap, 32, lo, hi,
            cfg.max_steps, -11, -1, -1, 0, 0, 0, 0, 0, None) != 0
    bufs = [out.data_ptr()] * 4
    assert lib.big_align_launch(*ptrs, *bufs, None, 1, cfg.seq_cap, 32, 16,
                                1024,
                                cfg.max_steps, -11, -1, -1, 64, 0, 0, 0, 0,
                                None) != 0
    assert tlib.big_align_launch(*ptrs, None, None, None, None, None, 1,
                                 cfg.seq_cap, 32, 16, 1024, cfg.max_steps,
                                 -11, -1, -1, 64, 0, 0, 0, 0, None) != 0
    assert tuple(big_launch(lib, pk, cfg)[0].tolist()) == (4, 0)
    shape = (ctypes.c_int * 6)()
    ftlib = emulated[bk.TRACE_FLAGS_LIBRARY]
    plib = emulated[bk.PROFILE_LIBRARY]
    ptlib = emulated[bk.TRACE_PROFILE_LIBRARY]
    # (threads a block, shared bytes, blocks an SM (the emulation's 1),
    # threads a pair, pairs a block, pairs an SM); at 8192 rows a thread
    # of the global library holds 64 rows at most, of the others 32
    for size, want in [((16, 1024), (128, 65536, 1, 32, 4, 4)),
                       ((256, 2048), (128, 65536, 1, 64, 2, 2)),
                       ((512, 1024), (128, 16384, 1, 128, 1, 1)),
                       ((2048, 2048), (128, 32768, 1, 128, 1, 1)),
                       ((512, 8192), (128, 131072, 1, 128, 1, 1))]:
        for name, x, flags in [(lib, 1, 0), (tlib, 1, 0), (ftlib, 0, 1),
                               (plib, 1, 2), (ptlib, 0, 1)]:
            if size[1] == 8192 and name is not lib:
                want = (256, 131072, 1, 256, 1, 1)
            assert name.big_launch_shape(*size, x, flags,
                                         ctypes.addressof(shape)) == 0
            assert tuple(shape) == want, (size, flags)
    tall = emulated[bk.ROWS16384_LIBRARY]
    ttall = emulated[bk.TRACE_ROWS16384_LIBRARY]
    for name, x, flags, want in [(lib, 0, 0, None), (tall, 1, 0, 131072),
                                 (ttall, 0, 0, 131072),
                                 (ttall, 1, 1, 131072)]:
        err = name.big_launch_shape(512, 16384, x, flags,
                                    ctypes.addressof(shape))
        assert (err == 0) == (want is not None)
        if want:
            assert tuple(shape) == (512, want, 1, 512, 1, 1)
    assert tall.big_launch_shape(512, 8192, 0, 0,
                                 ctypes.addressof(shape)) != 0
    scratch = torch.zeros((1, 4, 16384), dtype=torch.int16)
    tcfg = bk.BigKernelConfig(16, 16384, 16512)
    tpk = bk.pack_big([(b"A", b"A")], scores.BLOSUM62, tcfg, Gaps(-11, -1),
                      "cpu")
    for name, sp, hi, ok in [(tall, None, 16384, False),
                             (tall, scratch.data_ptr(), 8192, False),
                             (lib, scratch.data_ptr(), 8192, False),
                             (tall, scratch.data_ptr(), 16384, True)]:
        err = name.big_align_launch(
            *(t.data_ptr() for t in tpk[:4]), out.data_ptr(), None, None,
            None, None, sp, 1, tcfg.seq_cap, 32, 16, hi, tcfg.max_steps, -11,
            -1, -1, 0, 0, 0, 0, 0, None)
        assert (err == 0) == ok, (hi, ok)
    assert tuple(out[0].tolist()) == (4, 0)


@pytest.mark.parametrize("size,setup,x,budget", [
    ((32, 512), "protein", -1, None), ((128, 1024), "dna", 20, None),
    ((64, 1024), "protein", -1, 600), ((16, 1024), "protein", -1, None),
], ids=["32-512-protein", "128-1024-dna-x-drop", "64-1024-budget",
        "16-1024-every-k"])
def test_big_kernel_source_trace_matches_plain(emulated, size, setup, x,
                                               budget):
    """The trace instances (``csrc/big_trace.cu``) against the plain
    version: outputs, step counts, word counters, the descriptors of every
    executed step and the words below each counter, and the CIGARs walked
    from both.  At (32, 512) a pair grows to 512 rows (16 rows a thread),
    so the R-open bit and the diagonal cross threads within rows of 1 to 16
    a thread; under a budget of 600 words a pair the two longest pairs
    overrun and the edge cases finish.  At (16, 1024) the pairs run every
    height of the ladder and so every rows-a-thread step (16 of 32 lanes
    idle at 16 rows, 1 to 32 rows a thread from 32 to 1024): one pair grows
    to 1024 rows across a 600-residue insertion, one shrinks from 64 to
    32."""
    matrix, gaps, alphabet = SETUPS[setup]
    rng = np.random.default_rng(size[1] + x + 1)
    pairs = chip_smoke.structural_pairs(rng, alphabet, 6, 200)
    if size == (32, 512):
        pairs = [grown_pairs()[0]] + pairs
    if size == (16, 1024):
        pairs = protein_pairs(1, 10) + grown_1024_pair()
    cfg = bk.BigKernelConfig(*size, 1664 if size[1] == 512 else 3072,
                             32 if setup == "protein" else 16, x_drop=x >= 0,
                             trace=True)
    if budget:
        cfg = chip_smoke.with_trace_budget(cfg, budget)
    pk = bk.pack_big(pairs, matrix, cfg, gaps, "cpu", x_drop=max(x, 0))
    got = big_launch(emulated[bk.TRACE_LIBRARY], pk, cfg, x)
    want = bk.big_align_plain(*pk, cfg)
    saves, restores = chip_smoke.check_big_trace(got, want, f"{size}")
    out = want[0]
    ends = ([(int(o[1]), int(o[2])) for o in out] if x >= 0 else
            [(len(q), len(r)) for q, r in pairs])
    done = (out[:, -1] == 0).nonzero()[:, 0].tolist()
    chip_smoke.walk_both(
        tuple(t[:, done] if t.dim() == 3 else t[done] for t in got),
        tuple(t[:, done] if t.dim() == 3 else t[done] for t in want),
        [ends[k] for k in done], matrix, f"{size}")
    if size == (32, 512):
        assert saves > 0 and restores > 0
        ran = torch.arange(cfg.max_steps) < got[3][0]
        assert int(torch.where(ran, got[2][:, 0, 3], 0).max()) == 512
    if budget:
        assert 0 < int(out[:, -1].sum()) < len(pairs)
    if size == (16, 1024):
        heights = [got[2][: int(got[3][b]), b, 3].tolist()
                   for b in range(len(pairs))]
        assert set(sum(heights, [])) == {16 << k for k in range(7)}
        assert any(b < a for h in heights for a, b in zip(h, h[1:]))


def grown_1024_pair():
    """A protein pair whose blocks grow to 1024 at (16, 1024): 300 and 700
    residues with point mutations on the reference side, a random
    600-residue insertion between them."""
    from examples_tpu.common import rand_mutate, rand_seq

    rng = np.random.default_rng(0)
    aa = chip_smoke.AA.tobytes()
    a, c = rand_seq(rng, aa, 300), rand_seq(rng, aa, 700)
    return [(a + c, rand_mutate(rng, a, 10, aa) + rand_seq(rng, aa, 600)
             + rand_mutate(rng, c, 30, aa))]


@pytest.mark.parametrize("size,mode,x,trace", [
    ((128, 1024), "byte", -1, False), ((64, 1024), "byte", -1, True),
    ((128, 1024), "local", 20, False), ((32, 512), "local", -1, True),
    ((1024, 1024), "local", -1, True), ((128, 1024), "local", 50, True),
    ((128, 1024), "fstart", -1, True), ((128, 1024), "fend", -1, True),
], ids=lambda v: str(v))
def test_big_kernel_source_flags_match_plain(emulated, size, mode, x, trace):
    """The FLAGS instances of the big kernel (``csrc/big_flags.cu``,
    ``csrc/big_trace_flags.cu``) against the plain version: ByteMatrix on
    pairs over all 256 bytes (byte 0 included), local start, free start
    and free end gaps (queries shorter than the min size), with x-drop
    where the mode allows it; outputs, and in trace mode step counts, word
    counters, descriptors, words (local start's zero words after each
    step's h words) and the CIGARs walked from both.  Traced local start
    runs at 512 rows (a pair that grows to 512: four warps of four slots)
    and at 1024 (four warps of eight slots), so a row's zero bits come from
    every slot and warp."""
    lo, hi = size
    modes = FLAG_MODES[mode]
    byte = mode == "byte"
    rng = np.random.default_rng(hi + x + len(mode) + trace)
    if byte:
        pairs = chip_smoke.byte_pairs(rng, 8, 200)
    elif hi == 512:
        pairs = [grown_pairs()[0]] + protein_pairs(1, 5)
    else:
        pairs = chip_smoke.structural_pairs(rng, chip_smoke.AA, 8, 200)
    if mode == "fend":
        pairs = [(q[: lo - 1], r) for q, r in pairs]
    cfg = bk.BigKernelConfig(lo, hi, 1664 if hi == 512 else 1280,
                             256 if byte else 32, x_drop=x >= 0, trace=trace,
                             **modes)
    matrix = scores.BYTES1 if byte else scores.BLOSUM62
    pk = bk.pack_big(pairs, matrix, cfg, Gaps(-11, -1), "cpu",
                     x_drop=max(x, 0))
    got = big_launch(emulated[bk.library(cfg)], pk, cfg, x)
    want = bk.big_align_plain(*pk, cfg)
    if not trace:
        assert torch.equal(got, want)
        return
    chip_smoke.check_big_trace(got, want, f"{mode} {size}")
    out = want[0]
    ends = ([(int(o[1]), int(o[2])) for o in out] if lk.wide(cfg) else
            [(len(q), len(r)) for q, r in pairs])
    chip_smoke.walk_both(got, want, ends, matrix, f"{mode} {size}", cfg)
    if hi == 512:
        ran = torch.arange(cfg.max_steps) < got[3][0]
        assert int(torch.where(ran, got[2][:, 0, 3], 0).max()) == 512


def test_big_entry_point_rejects_bad_modes(emulated):
    """``big_align_launch`` refuses what the configuration refuses: byte mode
    with x-drop or with a table side other than 256, local start with free
    start gaps, free end gaps with x-drop, an unknown flag, and any flag in
    the libraries without FLAGS; the FLAGS libraries take valid ones (byte
    mode with local start among them).  A profile table size (``prof_cap``)
    is refused outside the profile libraries, and its absence or a size not
    a multiple of 128 there, and so is byte mode with a profile; the
    profile libraries take the flags."""
    cfg = bk.BigKernelConfig(16, 1024, 1152)
    pk = bk.pack_big([(b"A", b"A")], scores.BLOSUM62, cfg, Gaps(-11, -1),
                     "cpu")
    out = torch.zeros((1, 4), dtype=torch.int32)

    # the trace buffers stay alive across every call that may write them
    bufs = (torch.zeros((1, cfg.trace_budget), dtype=torch.int32),
            torch.zeros((cfg.max_steps, 1, 5), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))

    def call(name, alpha, x, flags, trace=False, prof_cap=0, packed=pk):
        ptrs = [t.data_ptr() for t in bufs] if trace else [None] * 4
        return emulated[name].big_align_launch(
            packed.codes.data_ptr(), packed.qlen.data_ptr(),
            packed.rlen.data_ptr(), packed.table.data_ptr(), out.data_ptr(),
            *ptrs, None, 1, cfg.seq_cap, alpha, 16, 1024, cfg.max_steps, -11,
            -1,
            x, cfg.trace_budget if trace else 0, flags, 1, -1, prof_cap, None)

    F = bk.FLAGS_LIBRARY
    for alpha, x, flags in [(256, 10, 8), (32, 10, 8), (32, -1, 8),
                            (32, -1, 3), (32, 10, 4), (32, -1, 16)]:
        assert call(F, alpha, x, flags) != 0, (alpha, x, flags)
    for name, trace in [(bk.LIBRARY, False), (bk.TRACE_LIBRARY, True)]:
        assert call(name, 32, -1, 1, trace) != 0
        assert call(name, 256, -1, 8, trace) != 0
    assert call(F, 32, -1, 1) == 0 and tuple(out[0, :2].tolist()) == (4, 0)
    assert call(bk.TRACE_FLAGS_LIBRARY, 32, 10, 2, trace=True) == 0
    assert call(bk.TRACE_FLAGS_LIBRARY, 256, -1, 9, trace=True) == 0
    # profiles: a table size only in the profile libraries, no byte mode
    pcfg = bk.BigKernelConfig(16, 1024, 1152, profile=True, prof_cap=128)
    ppk = pack_profile([(b"A", scores.AAProfile.from_bytes(
        b"A", 16, 2, -1, -11, 0, -11, -1))], pcfg, "cpu")
    P, PT = bk.PROFILE_LIBRARY, bk.TRACE_PROFILE_LIBRARY
    for name, trace in [(F, False), (bk.LIBRARY, False),
                        (bk.TRACE_LIBRARY, True)]:
        assert call(name, 32, -1, 0, trace, prof_cap=128) != 0
    for name, trace in [(P, False), (PT, True)]:
        for alpha, flags, prof_cap in [(32, 0, 0), (32, 0, 100),
                                       (256, 8, 128), (256, 9, 128)]:
            assert call(name, alpha, -1, flags, trace, prof_cap, ppk) != 0
    assert call(P, 32, -1, 0, prof_cap=128, packed=ppk) == 0
    assert tuple(out[0, :2].tolist()) == (2, 0)
    assert call(P, 32, 10, 1, prof_cap=128, packed=ppk) == 0
    assert call(PT, 32, -1, 4, True, prof_cap=128, packed=ppk) == 0


@pytest.mark.parametrize("size,mode,x,trace", [
    ((128, 1024), "grow", -1, False), ((32, 512), None, 20, False),
    ((32, 512), "grow", -1, True), ((128, 1024), None, 20, True),
    ((128, 1024), "local", -1, True), ((32, 512), "fstart", -1, True),
    ((128, 1024), "fend", -1, True),
], ids=lambda v: str(v))
def test_big_kernel_source_profile_matches_plain(emulated, size, mode, x,
                                                 trace):
    """The profile instances of the big kernel (``csrc/big_profile.cu``,
    ``csrc/big_trace_profile.cu``) against the plain version on (query,
    profile) pairs with gap opens and close costs that vary by position and
    a few query bytes outside A..Z, in a table of ``prof_cap`` positions
    (each profile's rows past rlen + 1 read as its pad): a strong-consensus
    pair whose blocks grow to 1024 rows (eight slots a warp) and at (32,
    512) to 512 traced (four warps of four slots), x 20, local start, free
    start gaps and free end gaps, and two queries that miss a stretch of
    their profile; outputs, and in trace mode step counts,
    word counters, descriptors, words (local start's zero words too) and
    the CIGARs walked from both."""
    lo, hi = size
    modes = {"local": dict(local_start=True),
             "fstart": dict(free_query_start_gaps=True),
             "fend": dict(free_query_end_gaps=True)}.get(mode, {})
    rng = np.random.default_rng(hi + x + len(str(mode)) + trace)
    pairs = (chip_smoke.profile_pairs(rng, 6, 200)
             + chip_smoke.deletion_profile_pairs(rng))
    if mode == "grow":
        pairs = chip_smoke.consensus_growth_pairs(
            rng, 1, 100, 500 if hi == 1024 else 300) + pairs[4:]
    if mode == "fend":
        pairs = [(q[: lo - 1], p) for q, p in pairs]
    cfg = bk.BigKernelConfig(lo, hi, 1792, x_drop=x >= 0, trace=trace,
                             profile=True, prof_cap=768, **modes)
    pk = pack_profile(pairs, cfg, "cpu", x_drop=max(x, 0))
    got = big_launch(emulated[bk.library(cfg)], pk, cfg, x)
    want = bk.big_align_plain(*pk, cfg)
    if mode == "grow":
        assert int(bk.big_align_plain(*pk, cfg, top_size=True)[-1][0]) == hi
    if not trace:
        assert torch.equal(got, want)
        return
    chip_smoke.check_big_trace(got, want, f"profile {mode} {size}")
    out = want[0]
    ends = ([(int(o[1]), int(o[2])) for o in out] if lk.wide(cfg) else
            [(len(q), p.str_len) for q, p in pairs])
    chip_smoke.walk_both(got, want, ends, None, f"profile {mode} {size}",
                         cfg)


@pytest.mark.parametrize("mode", ["global", "trace", "local_trace",
                                  "xdrop_trace"])
def test_big_kernel_source_16384_rows(emulated, mode):
    """The 16384-row layout (``csrc/big_16384.cu``, ``csrc/big_trace_16384.cu``)
    at (128, 16384) against the plain version: two protein pairs with an
    insertion, whose blocks grow to 512 rows and restore from the
    checkpoint planes in the global scratch (which starts as junk); with
    trace the row words accumulate in the trace buffer itself, with local
    start each step's zero words follow them from their shared staging,
    and with x-drop (x 1000, past the insertion) the best and its position:
    outputs, step counts, word counters, descriptors, words and the CIGARs
    walked from both."""
    rng = np.random.default_rng(16384)
    pairs = []
    for n, ins in ((300, 160), (360, 250)):
        q = bytes(rng.choice(chip_smoke.AA, n).tolist())
        r = q[: n // 2] + bytes(rng.choice(chip_smoke.AA, ins).tolist())
        pairs.append((q, r + q[n // 2 :]))
    trace = mode != "global"
    x = 1000 if mode == "xdrop_trace" else -1
    cfg = bk.BigKernelConfig(128, 16384, 17152, 32, trace=trace,
                             x_drop=x >= 0,
                             local_start=mode == "local_trace")
    if trace:
        cfg = chip_smoke.with_trace_budget(
            cfg, lk.trace_words(cfg) << 17)
    pk = bk.pack_big(pairs, scores.BLOSUM62, cfg, Gaps(-11, -1), "cpu",
                     x_drop=max(x, 0))
    got = big_launch(emulated[bk.library(cfg)], pk, cfg, x)
    *want, top = bk.big_align_plain(*pk, cfg, top_size=True)
    assert top.tolist() == [512, 512]
    if not trace:
        assert torch.equal(got, want[0])
        return
    saves, restores = chip_smoke.check_big_trace(got, tuple(want), mode)
    assert saves > 0 and restores > 0
    ends = ([(int(o[1]), int(o[2])) for o in want[0]] if lk.wide(cfg) else
            [(len(q), len(r)) for q, r in pairs])
    chip_smoke.walk_both(got, tuple(want), ends, scores.BLOSUM62, mode, cfg)
