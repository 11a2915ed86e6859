"""The CUDA sources themselves on the CPU: ``csrc/lane_kernel.cu`` and
``csrc/adaptive_kernel.cu`` compiled as C++ against a small header that
emulates the few CUDA features they use, called through their own C entry
points and ``bind``, and held exactly against the plain versions.

The emulation runs one host thread per CUDA thread and one block at a time
(so ``__shared__`` arrays may be function statics); the warp primitives
exchange values through per-warp buffers, one barrier wait each.  It
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

EMULATION = r"""
#pragma once
#include <algorithm>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <mutex>
#include <thread>
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
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;
// A barrier whose waiters sleep at once: spinning threads would take the
// cores from the other tests running beside this one.
struct Barrier {
  explicit Barrier(int n) : n_(n) {}
  void arrive_and_wait() {
    std::unique_lock<std::mutex> lock(m_);
    const unsigned gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      cv_.notify_all();
    } else {
      cv_.wait(lock, [&] { return gen != gen_; });
    }
  }
  std::mutex m_;
  std::condition_variable cv_;
  const int n_;
  int count_ = 0;
  unsigned gen_ = 0;
};
// Two buffers, used in turns: a lane writes the next exchange's buffer only
// after the barrier that every lane reaches after reading this one's.
struct Warp { Barrier* bar; int buf[2][32]; };
inline Warp* warps_;
inline Barrier* block_;
inline thread_local unsigned turn_ = 0;
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
  blockDim.x = block;
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
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& th : threads) th.join();
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
    libs = {}
    for name, mod in (("lane_kernel", lk), ("adaptive_kernel", ak)):
        src = (_build.CSRC / f"{name}.cu").read_text()
        src, n = LAUNCH.subn(r"emu::launch(\2, \3, [=] { \1(\4); });", src)
        assert n == 1, f"{name}: kernel launch not found"
        (out / f"{name}.cpp").write_text(src)
        so = out / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-pthread", "-I", str(out), "-o", str(so),
                        str(out / f"{name}.cpp")], check=True,
                       capture_output=True)
        libs[name] = mod.bind(ctypes.CDLL(str(so)))
    return libs


def launch(fn, pk, out, *ints, x=-1):
    err = fn(pk.codes.data_ptr(), pk.qlen.data_ptr(), pk.rlen.data_ptr(),
             pk.table.data_ptr(), out.data_ptr(), *ints, pk.gaps[0],
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


def test_entry_points_reject_bad_arguments(emulated):
    pk = lk.pack_lane([(b"A", b"A")], scores.BLOSUM62,
                      lk.LaneKernelConfig(16, 256), Gaps(-11, -1), "cpu")
    out = torch.zeros((1, 2), dtype=torch.int32)
    bad = emulated["adaptive_kernel"].adaptive_align_launch(
        pk.codes.data_ptr(), pk.qlen.data_ptr(), pk.rlen.data_ptr(),
        pk.table.data_ptr(), out.data_ptr(), 1, 256, 32, 32, 32, 100, -11,
        -1, -1, None)
    assert bad != 0  # min == max is not an adaptive configuration
    msg = emulated["adaptive_kernel"].adaptive_error_string(bad)
    assert msg == b"emulated"
