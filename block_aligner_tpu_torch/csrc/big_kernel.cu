// Big-block adaptive alignment of a batch of sequence pairs, or of (query,
// profile) pairs, global or x-drop, with or without trace, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by ops/big_kernel.py;
// the trace instances build from csrc/big_trace.cu, the FLAGS instances
// (ByteMatrix scoring and the local-start and free-query-gap flags, read at
// run time) from csrc/big_flags.cu and csrc/big_trace_flags.cu, the
// profile instances (with the flags read at run time) from
// csrc/big_profile.cu and csrc/big_trace_profile.cu, and the 16384-row
// instances (the FLAGS instances at max_size 16384) from csrc/big_16384.cu
// and csrc/big_trace_16384.cu.
//
// Replaces: block_aligner_tpu/ops/big_kernel.py::build_big_engine (its
// Pallas `kernel`) in global and in x-drop mode with a score table or a
// ByteMatrix or a profile (sequence-to-PSSM), with the local-start,
// free-query-start-gap and free-query-end-gap flags, with or without trace:
// the grow / shrink / checkpoint machine for 512 < max_size <= 8192, and
// (min, 512); and the same machine at 16384 rows on codes of any length, in
// place of the JAX kernel's segmented mode (code windows, planes streamed
// from HBM) that its long-sequence driver runs.  It computes the same score
// (x-drop and free end gaps: the best score and its position) and the same
// overrun flag, bit for bit; the machine is the adaptive kernel's
// (csrc/adaptive_kernel.cu), described in ops/adaptive_kernel.py, whose
// adaptive_align_plain, run on a BigKernelConfig, is the plain PyTorch
// version of this kernel.
//
// Trace (ops/_trace.py, core/traceback.py): the reference's 4 bits a cell,
// t | t2 << 2 (src/scan_block.rs:1166-1190), 8 columns a row's word, in a
// layout sized by the block that ran: each pair writes the words of a step's
// rect height at its own running counter, and the step's descriptor (flags,
// lane start, column start, height, the counter before the step).  The
// checkpoint save and restore decided at a step's end ride the next step's
// flags, save before restore.  A step whose rows would pass the pair's word
// budget stops the pair with the overrun flag, as the step cap does.
//
// What bounds it: integer ALU work (a dozen adds and maxes per DP cell) and
// latency: each of a rect's 8 columns per step depends on the one before,
// each column carries a max-plus prefix scan down a block of up to 16384
// rows, and each step's decision depends on the last column.  Bytes are not
// the limit: a pair reads its codes and writes 8 or 16 bytes.
//
// The layout before this one gave a pair a block of 4 or 8 warps whatever
// the height it ran at, one row a thread in 32-row slots, and staged every
// cell of a column in shared memory twice, behind a block barrier a column:
// at the band's 128 rows every per-column overhead was paid per cell.  What
// this design does about it:
// * threads per pair are fitted to the configuration: a pair takes G warps,
//   G = min_size / 128 within 1..4 (4 rows a thread at the min size, where a
//   pair runs most), raised so that no thread holds more rows than its
//   registers do (MAX_ROWS: 64 in the global library, 4 warps at 8192, and
//   32 in the others, 8 warps at 8192 and 16 at 16384), chosen by measured
//   time.  A block of 128 threads carries 4 pairs of one warp or 2 of two;
//   wider pairs take a block each.  A pair whose column one warp holds
//   synchronises with __syncwarp only; a pair of several warps meets at a named barrier of its
//   own (bar.sync 1 + pair, 32 G), once a column for the warps' scan
//   carries, so pairs that end at different steps never hang one another;
// * at a rect of height h each thread owns the contiguous rows [k t, k t +
//   k), k = h / (32 G) (or one row and idle threads when h < 32 G), and
//   keeps their D and C in registers for the step: loaded once from the
//   ring planes at the step's start, 16 bytes at a time, 8 columns computed
//   in registers, written back once at its end.  The step body is a
//   template on k, dispatched once a step; its rows unroll, its columns do
//   not.  A row's code (a profile down rect's gap word) is read once a
//   step.  The diagonal into a row is a register move, into a thread's
//   first row one shuffle;
// * the column's vertical-gap scan R[p] = max_{q <= p} (v[q] + e (p - q))
//   runs in three levels, each once a column: a serial max-plus over the
//   thread's k rows (its aggregate), a 5-level shuffle scan of the
//   threads' aggregates, and with several warps their carries through
//   shared memory behind the pair's barrier; the rows' values follow from
//   the carry in a second serial pass that recomputes each cell's
//   candidates instead of storing them.  All of it is int32, so it equals
//   the reference's saturating chunked scan: every candidate below the i16
//   rail loses to the zero correction e ((row % 8) + 1);
// * trackers and trace words are built per step, not per column: x-drop
//   keeps each of the thread's residues' best (value, column, chunk) over
//   the step's 8 columns in registers, folded across the pair once a step;
//   a row's trace word (and local start's zero bits) stays in a register
//   and is written once at the step's end;
// * the ring planes stay in shared memory as i16 (every DP value is the
//   reference's i16, relative to ZERO = 2^14, saturating at both rails): the
//   active column (D, C), the passive border (D, R) and the two checkpoint
//   borders, 16 bytes a row of max_size a pair (8 in the 16384-row
//   instances, whose checkpoint planes are a per-pair scratch of 4 max_size
//   i16 in global memory that the wrapper allocates).  A shift moves a
//   plane's base by 8 rows and a shrink by half a block, so 8-row groups
//   stay 16-byte aligned; a swap of the borders only swaps which planes are
//   active; a checkpoint save or restore copies the block's rows;
// * scores come from the table in shared memory by both codes, so a
//   restore only moves the anchor.  The pair's scalar state is replicated
//   in every thread, which takes the same decisions from the same values;
// * the FLAGS instances (BIG_FLAGS) read the modes from a run-time
//   argument.  Byte mode compares the two codes and never reads a table.
//   Local start and free start gaps restart cells at the relative zero of
//   the step's offset, clamp16(ZERO - off), taken after the step's rebase
//   or restore.  Free end gaps track row qlen's residue: per column a key 2
//   D + (the row's 16-row chunk reaches past qlen), so the column's max and
//   whether a row past qlen holds it fold in one max.  Local start's trace
//   has a second word a row, its 8 zero bits (D == the relative zero),
//   written after the step's h words;
// * the profile instances (BIG_PROFILE, which also reads the flags) score a
//   query against a table of 8 words a profile position (7 words of biased
//   score bytes by query code, and the gap word open_C | open_R << 8 |
//   close_C << 16; ops/_profile.py), clamping every profile position to
//   rlen + 1, whose word is the all-zero pad, so the table holds the
//   profile's own rows.  A right rect (lanes = query rows, columns = profile
//   positions) stages its 8 entering rows in shared memory once a step; a
//   down rect's row is a profile position, whose gap word its thread loads
//   once a step and whose score it reads by the column's query code.  C and
//   R swap their open costs there, and R closes before the merge into D (a
//   right rect closes C).  Trace compares D with the gap-closed C and R, as
//   the reference does, and so reproduces its down-to-right hand-off.
// What is left: thread block clusters to split one pair of 8192 or 16384
// rows across SMs for batches of such pairs smaller than the card, i16x2
// arithmetic and the DPX instructions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STEP = 8;             // columns per step
constexpr int ZERO = 1 << 14;       // score bias
constexpr int NEG = -32768;         // the i16 rails
constexpr int POS = 32767;
constexpr int INT_MIN_ = -2147483647 - 1;
constexpr int FAR = -(1 << 30);     // below every scan value, far from overflow
constexpr int MAX_ALPHA = 32;
constexpr int SUFFIX = STEP / 4;    // shrink suffix rows
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMALL_PAIRS = 4;      // pairs a 128-thread block of 1-warp pairs
// rect phases; the initial rect is a GROW_R with psz == 0
constexpr int DIR_R = 0, DIR_D = 1, DIR_GD = 2, DIR_GR = 3;

#ifndef BIG_TRACE
// csrc/big_trace.cu builds the trace instances apart, behind the
// preprocessor
#define BIG_TRACE false
#endif
#ifndef BIG_FLAGS
// csrc/big_flags.cu and csrc/big_trace_flags.cu build the FLAGS instances
// apart, behind the preprocessor as the trace code is
#define BIG_FLAGS false
#endif
#ifndef BIG_PROFILE
// csrc/big_profile.cu and csrc/big_trace_profile.cu build the profile
// instances apart, with BIG_FLAGS, behind the preprocessor too
#define BIG_PROFILE false
#endif
#if BIG_PROFILE && !BIG_FLAGS
#error "the profile instances read the flags: define BIG_FLAGS too"
#endif
#ifndef BIG_16384
// csrc/big_16384.cu and csrc/big_trace_16384.cu build the 16384-row
// instances apart, with BIG_FLAGS and without BIG_PROFILE, behind the
// preprocessor too
#define BIG_16384 false
#endif
#if BIG_16384 && (!BIG_FLAGS || BIG_PROFILE)
#error "the 16384-row instances read the flags and take no profile"
#endif
#ifndef BIG_NAMED_SYNC
// the named barrier `id` of `n` threads (a host-side build of this source
// may define its own)
#define BIG_NAMED_SYNC(id, n) \
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory")
#endif
#if BIG_16384
// the checkpoint planes: (B, 4, 16384) i16 of global scratch
#define BIG_16384_PARAMS , short* __restrict__ scratch
#define BIG_16384_ARGS , static_cast<short*>(scratch)
#else
#define BIG_16384_PARAMS
#define BIG_16384_ARGS
#endif
// The rows a thread holds at most, and so a pair's warps at the max size.
// The threshold is the register budget, 255 a thread: a pair's rows past
// it go to more warps, not to shared memory.  64 rows (4 warps at 8192)
// in the global and x-drop library alone, whose 64-row instances spill
// under 100 bytes and run the 50 kbp reads faster than 32 rows and 8
// warps do, their steps at 512 rows holding 4 rows a thread, not 2; 32
// rows (8 warps at 8192, 16 at 16384) in the seven others, whose 64-row
// instances spill 0.7 to 3 KB (traced growth ran 1.6x slower on one) and
// whose 16384 band ran faster at 16 warps than at 8 (PERF.md section 6).
constexpr int MAX_ROWS = BIG_TRACE || BIG_FLAGS ? 32 : 64;
constexpr int MAX_WARPS = (BIG_16384 ? 16384 : 8192) / (32 * MAX_ROWS);
// the run-time modes of the FLAGS instances (the `flags` argument)
constexpr int LOCAL_START = 1, FREE_START = 2, FREE_END = 4, BYTE_MODE = 8;
#if BIG_FLAGS
#define BIG_FLAGS_PARAMS , int flags, int bmatch, int bmismatch
#define BIG_FLAGS_ARGS , flags, bmatch, bmismatch
#else
#define BIG_FLAGS_PARAMS
#define BIG_FLAGS_ARGS
#endif
#if BIG_PROFILE
// the profile table's words per position: 7 score words (4 biased bytes
// each, query codes 0..27), then the gap word
constexpr int PROF_WORDS = 8;
#define BIG_PROFILE_PARAMS , int prof_cap
#define BIG_PROFILE_ARGS , prof_cap
#else
#define BIG_PROFILE_PARAMS
#define BIG_PROFILE_ARGS
#endif
#if BIG_TRACE
// descriptor flags (core/traceback.py)
constexpr int F_RIGHT = 1, F_START = 2, F_SAVE = 4, F_RESTORE = 8;
// the trace buffers: words (B, budget), descriptors (max_steps, B, 5), the
// steps each pair ran and the words it wrote (B,)
#define BIG_TRACE_PARAMS                               \
  , int* __restrict__ twords, int* __restrict__ tdesc, \
      int* __restrict__ tsteps, int* __restrict__ tused, int budget
#define BIG_TRACE_ARGS                                 \
  , static_cast<int*>(words), static_cast<int*>(desc), \
      static_cast<int*>(steps), static_cast<int*>(used), budget
#else
#define BIG_TRACE_PARAMS
#define BIG_TRACE_ARGS
#endif

__device__ __forceinline__ int sat(int x) { return max(x, NEG); }
__device__ __forceinline__ int sat2(int x) { return min(max(x, NEG), POS); }

// An int the optimizer cannot see through: comparing a register array's
// index with it keeps a select among the array's entries a select (the
// compiler would otherwise copy the array to local memory and index it).
__device__ __forceinline__ int opaque(int v) {
  asm("" : "+r"(v));
  return v;
}

// ... that it cannot move out of a loop either: what a step's column
// derives from a row's loop-invariant word is derived again each column,
// and not held in registers across the step, one copy a row.
__device__ __forceinline__ int fresh(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

#if BIG_PROFILE
// The byte of query code `code` in a profile position's row of 8 words:
// the score of code c < 28 is byte c, biased by 128; a code past 27 reads
// byte 31, the gap word's top byte, which is 0 (ops/_profile.py), and so
// scores -128 (as csrc/adaptive_kernel.cu's prof_score).
__device__ __forceinline__ int prof_byte(int code) {
  return code < 4 * (PROF_WORDS - 1) ? code : 4 * PROF_WORDS - 1;
}
__device__ __forceinline__ int prof_score(const int* row, int byte) {
  return (int)reinterpret_cast<const uint8_t*>(row)[byte] - 128;
}

// A profile position's gap costs for one cell (reference:
// src/scan_block.rs:651-705): on a right rect the position is the column's,
// C opens with its open_C plus the extension, R with its open_R, and C
// closes; on a down rect it is the row's and the roles swap: C opens with
// open_R, R with open_C, and R closes.
struct ProfGaps {
  int copen, dopen, close;
  __device__ __forceinline__ ProfGaps(int g, bool right, int gext) {
    const int oc = (g & 255) - 128, orr = ((g >> 8) & 255) - 128;
    copen = (right ? oc : orr) + gext;
    dopen = right ? orr : oc;
    close = ((g >> 16) & 255) - 128;
  }
};
#endif

// A pair's warps: G = min_size / 128 within 1..4, at least max_size /
// (32 MAX_ROWS) (no thread holds more than MAX_ROWS rows); pairs a block:
// 4 of one warp, 2 of two, else 1.
inline int pair_warps(int min_size, int max_size) {
  return max(min(max(min_size / 128, 1), 4), max_size / (32 * MAX_ROWS));
}
inline int block_pairs(int warps) { return max(1, SMALL_PAIRS / warps); }
// the largest rows a thread holds at this configuration: the kernel instance
inline int rows_max(int min_size, int max_size) {
  return max_size / (32 * pair_warps(min_size, max_size));
}
// A pair's shared planes, in shorts: the four border planes and, but in the
// 16384-row instances, the four checkpoint planes, each max_size rows.
constexpr int PLANES = BIG_16384 ? 4 : 8;
inline size_t pair_shorts(int max_size) { return (size_t)max_size * PLANES; }

// The four border planes: D planes 0 and 1, C / R planes 2 and 3; the
// active border is D plane `a` and C plane 2 + a, the passive one the
// others.  Each plane is a ring of S rows from its own base.
struct Planes {
  short* p[4];
  int base[4];
  int a, mask;
  __device__ __forceinline__ short& at(int q, int r) {
    return p[q][(base[q] + r) & mask];
  }
  __device__ __forceinline__ int aD() const { return a; }
  __device__ __forceinline__ int aC() const { return 2 + a; }
  __device__ __forceinline__ int pD() const { return 1 - a; }
  __device__ __forceinline__ int pR() const { return 3 - a; }
};

struct Pair {  // one pair's step-machine state, the same in every thread
  int I, J, off, offmax, sz, psz, cpos, dir, pdir, corn;
  int ckI, ckJ, ckOff, best, yiter, gnm;
  bool done, rest;
  int dmax;  // this thread's part of the rect maximum
  // x-drop: the tracker of residue lane % 16 (running max, chunk origin,
  // column), the GROW_D half's banked candidate, the best's position and
  // the count of failing decisions
  int vm, ai, aj, gdmax, gdbi, gdbj, xbi, xbj, xiter;
};

// A thread's place in its pair and the pair's constants.
struct Lanes {
  int gt, lane, wi, gw, G, T, bar;  // thread, lane, warp in the pair and
                                    // in the block, warps, threads, barrier
  int S, mask, cap, alpha, gopen, gext, ql, rl, chunks, log_ch;
  const uint8_t* qs;  // the query's codes
#if BIG_PROFILE
  const int* pw;  // the profile's words
  const int* prow;  // a right rect's 8 entering profile rows
  int pmax;
#else
  const uint8_t* rs;  // the reference's codes
  const int* tab;
#endif
#if BIG_FLAGS
  bool local, fstart, fend, byte;
  int bmatch, bmismatch;
#endif
#if BIG_TRACE
  int* tw;  // the pair's trace words
#endif
};

// One step's values, the same in every thread of the pair.
struct Step {
  int h, sz, psz, cpos, ls, cstart, oa, cvec, frt, fridx, tpos;
  bool shift, right_or, origin, fra;
#if BIG_FLAGS
  int rz;
  bool ins0;
#endif
};

// The pair's warps meet: a warp's lanes, or the pair's named barrier.
__device__ __forceinline__ void pair_sync(const Lanes& L) {
  if (L.G == 1)
    __syncwarp();
  else
    BIG_NAMED_SYNC(L.bar, L.T);
}

// K rows of a ring plane from `start` (a multiple of min(K, 8)) into
// ints, 16 bytes a load from 8 rows on; the rows of an 8-row group never
// wrap.
template <int K>
__device__ __forceinline__ void load_rows(const short* p, int start, int mask,
                                          int (&v)[K]) {
  if constexpr (K >= 8) {
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
      const int4 x =
          *reinterpret_cast<const int4*>(p + ((start + 8 * j) & mask));
      const int u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[8 * j + 2 * q] = (short)u[q];
        v[8 * j + 2 * q + 1] = u[q] >> 16;
      }
    }
  } else if constexpr (K == 4) {
    const int2 x = *reinterpret_cast<const int2*>(p + start);
    v[0] = (short)x.x;
    v[1] = x.x >> 16;
    v[2] = (short)x.y;
    v[3] = x.y >> 16;
  } else if constexpr (K == 2) {
    const int x = *reinterpret_cast<const int*>(p + start);
    v[0] = (short)x;
    v[1] = x >> 16;
  } else {
    v[0] = p[start];
  }
}

__device__ __forceinline__ int pack2(int lo, int hi) {
  return (lo & 0xffff) | (hi << 16);
}

// ... and back, the values i16 already.
template <int K>
__device__ __forceinline__ void store_rows(short* p, int start, int mask,
                                           const int (&v)[K]) {
  if constexpr (K >= 8) {
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
      const int* u = v + 8 * j;
      *reinterpret_cast<int4*>(p + ((start + 8 * j) & mask)) =
          make_int4(pack2(u[0], u[1]), pack2(u[2], u[3]), pack2(u[4], u[5]),
                    pack2(u[6], u[7]));
    }
  } else if constexpr (K == 4) {
    *reinterpret_cast<int2*>(p + start) =
        make_int2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  } else if constexpr (K == 2) {
    *reinterpret_cast<int*>(p + start) = pack2(v[0], v[1]);
  } else {
    p[start] = (short)v[0];
  }
}

// A thread's K trace words (or zero words) at `dst`, four at a time where
// they are 16-byte aligned.
template <int K>
__device__ __forceinline__ void store_words(int* dst, const int (&v)[K]) {
  if constexpr (K >= 4) {
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
      for (int j = 0; j < K / 4; ++j)
        reinterpret_cast<int4*>(dst)[j] =
            make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) dst[i] = v[i];
}

// Checkpoint save of rows [0, sz): the column borders (D, C) and row
// borders (D, R) of the rect just completed; `ro` says whether its lanes
// were the query.
__device__ __forceinline__ void save_ckpt(Planes& P, short* const* ck,
                                          bool ro, int sz, const Lanes& L) {
  const int q[4] = {ro ? P.aD() : P.pD(), ro ? P.aC() : P.pR(),
                    ro ? P.pD() : P.aD(), ro ? P.pR() : P.aC()};
  const short* src[4];
  int base[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    src[k] = P.p[q[k]];
    base[k] = P.base[q[k]];
  }
  for (int r = L.gt; r < sz; r += L.T)
#pragma unroll
    for (int k = 0; k < 4; ++k) ck[k][r] = src[k][(base[k] + r) & P.mask];
}

// The tracker's best residue: the max over residues (returned), and at the
// lowest residue holding it the position in the rect's (lane, column) axes.
__device__ __forceinline__ int tracker_best(const Pair& m, int lane, int& ai,
                                            int& aj) {
  const int cm = __reduce_max_sync(FULL, m.vm);
  const int r = __reduce_min_sync(FULL, m.vm == cm ? (lane & 15) : 16);
  ai = __shfl_sync(FULL, m.ai, r) + r;
  aj = __shfl_sync(FULL, m.aj, r);
  return cm;
}

// The x-drop keys of a thread's residues, folded over the warp: lane l
// returns residue l % 16's.  With K < 16 rows thread t holds residues
// (K t + j) % 16 in slots j, as does every lane congruent to t modulo
// 16 / K; with K >= 16 it holds all 16, in slots j = residue.
template <int K>
__device__ __forceinline__ int fold_residues(int (&cand)[K < 16 ? K : 16],
                                             int lane) {
  constexpr int NS = K < 16 ? K : 16;
  const int rho = lane & 15;
  int v = INT_MIN_;
  if constexpr (K >= 16) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int x = __reduce_max_sync(FULL, cand[j]);
      if (opaque(j) == rho) v = x;
    }
  } else {
#pragma unroll
    for (int s = 16 / K; s < 32; s <<= 1)
#pragma unroll
      for (int j = 0; j < NS; ++j)
        cand[j] = max(cand[j], __shfl_xor_sync(FULL, cand[j], s));
    const int src = rho / K, slot = rho & (K - 1);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int x = __shfl_sync(FULL, cand[j], src);
      if (opaque(j) == slot) v = x;
    }
  }
  return v;
}

// Shared arrays of a block, indexed by its warps (the pairs' warps in
// order) or by its pairs.
struct Shared {
  int* wagg;  // [2][MAX_WARPS]: a warp's scan at its last row
  int* wdp;   // ... and D before the scan there
#if BIG_PROFILE
  int* wt;    // ... its D plus R open
  int* wcl;   // ... its close cost
#endif
  int* wkey;  // [MAX_WARPS][16]: x-drop keys by residue
#if BIG_FLAGS
  int* fkey;  // [STEP][MAX_WARPS]: free end gaps' keys by column
#endif
  int* score;  // [pair]: global mode's frozen cell
};

// One step of the pair at rect height h = K threads' rows (K = 1 with idle
// threads where h < 32 G): rebase and load the thread's rows, run the 8
// columns, write them back and the step's trace words.  Returns whether the
// rect froze; sets `xk` (x-drop: the step's key of residue lane % 16 over
// the warp's rows) and `corn` (a shift's next corner, in the pair's first
// warp).
template <bool XDROP, int K>
__device__ __forceinline__ bool run_step(const Lanes& L, const Step& st,
                                         Planes& P, Pair& m, const Shared& sh,
                                         int& xk, int& corn) {
  constexpr int NS = K < 16 ? K : 16;  // x-drop residue slots
  const int r0 = L.gt * K;             // the thread's first row
  const bool live = K > 1 || r0 < st.h;
  const int gext = L.gext;
  const int mask = L.mask;
  int Dv[K], Cv[K];
  int row7 = NEG;  // a shift's row 7 of the rebased passive D border
  // the active border's rows, and for a shift the rebase of all four
  // planes' (the passive ones are not read before the step's end)
  if (live) {
    load_rows<K>(P.p[P.aD()], (P.base[P.aD()] + r0) & mask, mask, Dv);
    load_rows<K>(P.p[P.aC()], (P.base[P.aC()] + r0) & mask, mask, Cv);
    if (st.shift) {
      // offset rebase (reference: src/scan_block.rs:148-151)
#pragma unroll
      for (int i = 0; i < K; ++i) {
        Dv[i] = sat2(Dv[i] + st.oa);
        Cv[i] = sat2(Cv[i] + st.oa);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int pl = q ? P.pR() : P.pD();
        const int at = (P.base[pl] + r0) & mask;
        int pv[K];
        load_rows<K>(P.p[pl], at, mask, pv);
#pragma unroll
        for (int i = 0; i < K; ++i) pv[i] = sat2(pv[i] + st.oa);
        store_rows<K>(P.p[pl], at, mask, pv);
        if (q == 0) row7 = pv[min(7, K - 1)];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) Dv[i] = Cv[i] = NEG;
  }
  // a shift's next corner, from the thread of row 7
  if (st.shift) corn = __shfl_sync(FULL, row7, K >= 8 ? 0 : 7 / K);
  // the rows' codes, 4 a register (profiles: the byte of each query code
  // in a position's row; a down rect: the positions' gap words), and the 8
  // columns'
  int lc[(K + 3) / 4];
#pragma unroll
  for (int j = 0; j < (K + 3) / 4; ++j) lc[j] = 0;
#if BIG_PROFILE
  int gw[K];
  if (st.right_or) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      lc[i >> 2] |= prof_byte(L.qs[min(st.ls + r0 + i, L.cap - 1)])
                    << (8 * (i & 3));
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i)
      gw[i] = L.pw[(size_t)min(st.ls + r0 + i, L.pmax) * PROF_WORDS +
                   PROF_WORDS - 1];
  }
  const uint8_t* cseq = L.qs;
#else
  const uint8_t* lseq = st.right_or ? L.qs : L.rs;
  const uint8_t* cseq = st.right_or ? L.rs : L.qs;
#pragma unroll
  for (int i = 0; i < K; ++i)
    lc[i >> 2] |= min((int)lseq[min(st.ls + r0 + i, L.cap - 1)], L.alpha - 1)
                  << (8 * (i & 3));
#endif
  int ccw[2] = {0, 0};
#pragma unroll
  for (int w = 0; w < STEP; ++w)
#if BIG_PROFILE
    ccw[w >> 2] |= prof_byte(cseq[min(st.cstart + w, L.cap - 1)])
                   << (8 * (w & 3));
#else
    ccw[w >> 2] |= min((int)cseq[min(st.cstart + w, L.cap - 1)], L.alpha - 1)
                   << (8 * (w & 3));
#endif
  // the diagonal into the thread's first row: the entering column's row
  // above (rebased as the thread above rebased it), or the corner
  int up0 = __shfl_up_sync(FULL, Dv[K - 1], 1);
  if (L.lane == 0) {
    if (L.wi == 0) {
      up0 = st.cvec;
    } else {
      up0 = P.at(P.aD(), r0 - 1);
      if (st.shift) up0 = sat2(up0 + st.oa);
    }
  }
  // the rows' zero correction e ((row % 8) + 1), clamped to the rail
  const int zc0 = K >= 8 ? 0 : (r0 & 7);
  int cand[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) cand[j] = INT_MIN_;
#if BIG_TRACE
  int wd[K];  // the rows' trace words
#if BIG_FLAGS
  int zb[(K + 3) / 4];  // ... and local start's zero bits, a byte a row
#endif
#endif
  // the row of the rect's bottom cells, and where they go: a shift's
  // passive border shifted by 8, a grow half's at row psz + cpos + w
  const bool bottom = live && r0 + K - 1 == st.h - 1;
  const int brow = st.shift ? st.sz : st.psz + st.cpos;
  // the step's start reads of other rows are done before the first write
  // into them (with several warps the first column's barrier does it)
  if (L.G == 1) __syncwarp();

  bool frozen = false;
#pragma unroll 1
  for (int w = 0; w < STEP; ++w) {
    const int par = w & 1;
    const int cc = (ccw[w >> 2] >> (8 * (w & 3))) & 255;
#if BIG_PROFILE
    // a right rect's column: its entering profile row and gap costs
    const int* crow = L.prow + w * PROF_WORDS;
    const ProfGaps gc(st.right_or ? crow[PROF_WORDS - 1] : 0, true, gext);
#elif BIG_FLAGS
    const int* trow = L.tab + (L.byte ? 0 : cc * L.alpha);
#else
    const int* trow = L.tab + cc * L.alpha;
#endif
    // pass 1: D before the vertical gaps, C, and the thread's scan of D +
    // (open - extend) over its rows (its aggregate)
    int prev = up0, agg = FAR;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int dold = Dv[i];
      const int code = (fresh(lc[i >> 2]) >> (8 * (i & 3))) & 255;
#if BIG_PROFILE
      const ProfGaps g =
          st.right_or ? gc : ProfGaps(fresh(gw[i]), false, gext);
      int d = sat2(prev + (st.right_or
                               ? prof_score(crow, code)
                               : prof_score(L.pw + (size_t)min(fresh(st.ls) +
                                                                   r0 + i,
                                                               L.pmax) *
                                                       PROF_WORDS,
                                            cc)));
      if (st.origin && w == 0 && i == 0 && r0 == 0) d = ZERO;  // the origin
      if (L.local) d = max(d, st.rz);
      else if (st.ins0 && i == 0 && r0 == 0) d = st.rz;
      const int copen = sat2(dold + g.copen);
      const int c = max(sat2(Cv[i] + gext), copen);
      // a right rect closes C before the merge; C stays pre-close
      d = max(d, st.right_or ? sat2(c + g.close) : c);
      const int t = sat2(d + g.dopen);
#else
#if BIG_FLAGS
      // byte mode compares the codes; the flags restart cells at the
      // relative zero
      int d = sat2(prev + (L.byte ? (code == cc ? L.bmatch : L.bmismatch)
                                  : trow[code]));
      if (st.origin && w == 0 && i == 0 && r0 == 0) d = ZERO;  // the origin
      if (L.local) d = max(d, st.rz);
      else if (st.ins0 && i == 0 && r0 == 0) d = st.rz;
#else
      int d = sat2(prev + trow[code]);
      if (st.origin && w == 0 && i == 0 && r0 == 0) d = ZERO;  // the origin
#endif
      const int copen = sat(dold + L.gopen);
      const int c = max(sat(Cv[i] + gext), copen);
      d = max(d, c);
      const int t = d + (L.gopen - gext);
#endif
#if BIG_TRACE
      // t2's C-open bit; the rest of the nibble follows R
      wd[i] = (w == 0 ? 0 : wd[i]) | (c == copen) << (4 * w + 2);
#endif
      prev = dold;
      Cv[i] = c;
      Dv[i] = d;
      agg = max(t, agg + gext);
    }
    if (!live) agg = FAR;
    // the threads' aggregates, scanned over the warp: a segment ending in t
    // composes with the carry c before it as max(t, c + e rows)
    int sc = agg;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int o = __shfl_up_sync(FULL, sc, dd);
      if (L.lane >= dd) sc = max(sc, o + gext * K * dd);
    }
    // the row above the thread's first: D before its R, (profiles) its D +
    // R open and its close, and the scan there
    const int dlast = Dv[K - 1];
#if BIG_PROFILE
    const ProfGaps gl =
        st.right_or ? gc : ProfGaps(fresh(gw[K - 1]), false, gext);
    const int tlast = sat2(dlast + gl.dopen);
    int tA = __shfl_up_sync(FULL, tlast, 1);
    int clA = __shfl_up_sync(FULL, gl.close, 1);
#endif
    int dA = __shfl_up_sync(FULL, dlast, 1);
    int E = __shfl_up_sync(FULL, sc, 1);
    int cw = FAR;  // the carry of the warps above
    if (L.G > 1) {
      if (L.lane == 31) {
        sh.wagg[par * MAX_WARPS + L.gw] = sc;
        sh.wdp[par * MAX_WARPS + L.gw] = dlast;
#if BIG_PROFILE
        sh.wt[par * MAX_WARPS + L.gw] = tlast;
        sh.wcl[par * MAX_WARPS + L.gw] = gl.close;
#endif
      }
      pair_sync(L);  // the warps' scans are visible
      for (int v = L.gw - L.wi; v < L.gw; ++v)
        cw = max(sh.wagg[par * MAX_WARPS + v], cw + gext * 32 * K);
    }
    if (L.lane == 0) {
      E = cw;
      if (L.wi > 0) {
        dA = sh.wdp[par * MAX_WARPS + L.gw - 1];
#if BIG_PROFILE
        tA = sh.wt[par * MAX_WARPS + L.gw - 1];
        clA = sh.wcl[par * MAX_WARPS + L.gw - 1];
#endif
      }
    } else {
      E = max(E, cw + gext * K * L.lane);
    }
    // that row's R and final D: the next column's diagonal into the
    // thread's first row; with trace its R-open bit (0 above row 0)
    const int RA = max(E, max(gext * ((r0 - 1) & 7) + gext, NEG));
#if BIG_PROFILE
    up0 = r0 == 0 ? NEG : max(dA, st.right_or ? RA : sat2(RA + clA));
#if BIG_TRACE
    int rin = r0 != 0 && RA == tA;
#endif
#else
    up0 = r0 == 0 ? NEG : max(dA, RA);
#if BIG_TRACE
    int rin = r0 != 0 && RA == dA + L.gopen - gext;
#endif
#endif
    // pass 2: R from the carry, and the final D
    int run = E;
#if BIG_FLAGS
    int fk = INT_MIN_;  // free end gaps: the column's key of qlen's residue
#endif
    const int wch = w * L.chunks + (r0 >> 4);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int d = Dv[i];
#if BIG_PROFILE
      const ProfGaps g =
          st.right_or ? gc : ProfGaps(fresh(gw[i]), false, gext);
      const int t = sat2(d + g.dopen);
#else
      const int t = d + (L.gopen - gext);
#endif
      run = max(t, run + gext);
      const int R = max(run, max(gext * (zc0 + (i & 7)) + gext, NEG));
#if BIG_PROFILE
      // a down rect closes R before the merge
      const int re = st.right_or ? R : sat2(R + g.close);
      const int D = max(d, re);
#else
      const int D = max(d, R);
#endif
#if BIG_TRACE
      {
        // t = (D == C) | (D == R) << 1, t2's R bit from the row above
        const int c = Cv[i];
#if BIG_PROFILE
        // profile: D against the gap-closed C and R
        wd[i] |= ((D == (st.right_or ? sat2(c + g.close) : c)) |
                  (D == re) << 1 | rin << 3)
                 << (4 * w);
#else
        wd[i] |= ((D == c) | (D == R) << 1 | rin << 3) << (4 * w);
#endif
        rin = R == t;
#if BIG_FLAGS
        // local start: the cell restarted at the relative zero
        if (L.local)
          zb[i >> 2] = (w == 0 && (i & 3) == 0 ? 0 : zb[i >> 2]) |
                       (D == st.rz) << (8 * (i & 3) + w);
#endif
      }
#endif
      Dv[i] = D;
      if (live) {
        m.dmax = max(m.dmax, D);
        if constexpr (XDROP) {
          // (value, column, chunk), the latest column and highest chunk
          // winning a tie
          cand[i & (NS - 1)] = max(cand[i & (NS - 1)],
                                   D * (L.S >> 1) + wch + (i >> 4));
        }
#if BIG_FLAGS
        else if (L.fend) {
          // D, and whether the row's chunk reaches past qlen
          const int r = r0 + i;
          if ((r & 15) == (L.ql & 15))
            fk = max(fk, 2 * D + (st.ls + 16 * (r >> 4) + 16 > L.ql));
        }
#endif
      }
      if (i == K - 1 && bottom) {
        // the rect's bottom cells into the passive border
        P.p[P.pD()][(P.base[P.pD()] + brow + w) & mask] = (short)D;
        P.p[P.pR()][(P.base[P.pR()] + brow + w) & mask] = (short)R;
      }
    }
#if BIG_FLAGS
    if (!XDROP && L.fend) {
      // the column's key over the warp, for the step's end
      fk = __reduce_max_sync(FULL, fk);
      if (L.lane == 0) sh.fkey[w * MAX_WARPS + L.gw] = fk;
    }
    if (!XDROP && !L.fend && st.fra && w >= st.frt) {
#else
    if (!XDROP && st.fra && w >= st.frt) {
#endif
      // freeze: the rect covering (qlen, rlen) reached the last column;
      // the frozen cell's score
      const int fi = st.fridx - r0;
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (opaque(i) == fi && live) *sh.score = m.off + Dv[i] - ZERO;
      frozen = true;
      break;
    }
  }
  // the step's rows back into the active border
  if (live) {
    store_rows<K>(P.p[P.aD()], (P.base[P.aD()] + r0) & mask, mask, Dv);
    store_rows<K>(P.p[P.aC()], (P.base[P.aC()] + r0) & mask, mask, Cv);
  }
#if BIG_TRACE
  // the step's words, at the pair's counter; local start's zero words
  // follow the step's h words
  if (live) {
    store_words<K>(L.tw + st.tpos + r0, wd);
#if BIG_FLAGS
    if (L.local) {
#pragma unroll
      for (int i = 0; i < K; ++i) wd[i] = (zb[i >> 2] >> (8 * (i & 3))) & 255;
      store_words<K>(L.tw + st.tpos + st.h + r0, wd);
    }
#endif
  }
#endif
  if constexpr (XDROP) {
    xk = fold_residues<K>(cand, L.lane);
    if (L.G > 1 && L.lane < 16) sh.wkey[L.gw * 16 + L.lane] = xk;
  }
  return frozen;
}

// KMAX: the most rows a thread holds.  The instances of at most 16 rows a
// thread run 128 threads a block and, but with trace, are held to four
// blocks an SM (128 registers), the profile instances to three (168): the
// (2048, 2048) self-oracle's pairs take a block each, and at 16 rows a
// thread would take more registers otherwise, two blocks an SM.
template <bool XDROP, int KMAX>
__global__ void __launch_bounds__(KMAX <= 16 ? 128 : MAX_WARPS * 32,
                                  KMAX <= 16 && !BIG_TRACE
                                      ? (BIG_PROFILE ? 3 : 4)
                                      : 1)
big_align_kernel(const uint8_t* __restrict__ codes,
                 const int* __restrict__ qlen, const int* __restrict__ rlen,
                 const int* __restrict__ table, int* __restrict__ out, int B,
                 int cap, int alpha, int S, int G, int min_size,
                 int max_steps, int gopen, int gext,
                 int xdrop BIG_TRACE_PARAMS BIG_FLAGS_PARAMS BIG_PROFILE_PARAMS
                     BIG_16384_PARAMS) {
  extern __shared__ __align__(16) short planes[];
#if BIG_PROFILE
  // a right rect's 8 entering profile rows, by pair
  __shared__ int prow[SMALL_PAIRS][STEP * PROF_WORDS];
  __shared__ int wt[2 * MAX_WARPS], wcl[2 * MAX_WARPS];
#else
  __shared__ int tab[MAX_ALPHA * MAX_ALPHA];
#endif
  __shared__ int wagg[2 * MAX_WARPS], wdp[2 * MAX_WARPS];
  __shared__ int red[MAX_WARPS];  // the warps' rect maxima
  __shared__ int wkey[XDROP ? MAX_WARPS * 16 : 1];
#if BIG_FLAGS
  __shared__ int fkey[STEP * MAX_WARPS];
#endif
  __shared__ int score[SMALL_PAIRS];  // global mode: the frozen cell's score

  const int T = 32 * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pp = warp / G;  // the pair in the block
  const int b = blockIdx.x * (blockDim.x / T) + pp;
  Lanes L;
  L.gt = tid - pp * T;
  L.lane = lane;
  L.wi = warp - pp * G;
  L.gw = warp;
  L.G = G;
  L.T = T;
  L.bar = 1 + pp;
  L.S = S;
  L.mask = S - 1;
  L.cap = cap;
  L.alpha = alpha;
  L.gopen = gopen;
  L.gext = gext;
  L.chunks = S >> 4;
  L.log_ch = __ffs(L.chunks) - 1;
#if BIG_FLAGS
  // the modes; byte mode has no table
  L.local = flags & LOCAL_START;
  L.fstart = flags & FREE_START;
  L.fend = flags & FREE_END;
  L.byte = flags & BYTE_MODE;
  L.bmatch = bmatch;
  L.bmismatch = bmismatch;
#endif
#if BIG_PROFILE
  L.prow = prow[pp];
#else
#if BIG_FLAGS
  if (!L.byte)
#endif
    for (int k = tid; k < alpha * alpha; k += blockDim.x) tab[k] = table[k];
  L.tab = tab;
#endif
  __syncthreads();  // the table is in; a block's last pairs may be missing
  if (b >= B) return;
  Shared sh{wagg, wdp,
#if BIG_PROFILE
            wt, wcl,
#endif
            wkey,
#if BIG_FLAGS
            fkey,
#endif
            score + pp};
  short* const pl = planes + (size_t)pp * PLANES * S;
#if BIG_PROFILE
  // the pair's query codes (cap) and profile words (prof_cap, 8), every
  // profile position clamped to rlen + 1
  L.qs = codes + (size_t)b * cap;
  L.pw = table + (size_t)b * prof_cap * PROF_WORDS;
  L.ql = qlen[b];
  L.rl = rlen[b];
  L.pmax = min(L.rl + 1, prof_cap - 1);
#else
  L.qs = codes + (size_t)b * 2 * cap;
  L.rs = L.qs + cap;
  L.ql = qlen[b];
  L.rl = rlen[b];
#endif
  const int ql = L.ql, rl = L.rl;
#if BIG_16384
  for (int k = L.gt; k < 4 * S; k += T) pl[k] = 0;
  // the checkpoint planes: the pair's 4 S rows of global scratch, zeroed
  // as the shared ones are
  short* const ckb = scratch + (size_t)b * 4 * S;
  for (int k = L.gt; k < 4 * S; k += T) ckb[k] = 0;
  short* const ck[4] = {ckb, ckb + S, ckb + 2 * S, ckb + 3 * S};
#else
  for (int k = L.gt; k < 8 * S; k += T) pl[k] = 0;
  short* const ck[4] = {pl + 4 * S, pl + 5 * S, pl + 6 * S, pl + 7 * S};
#endif
  if (L.gt == 0) *sh.score = 0;
#if BIG_TRACE
  L.tw = twords + (size_t)b * budget;
  // the words written, the steps run, the checkpoint events of the next
  // step's descriptor
  int tpos = 0, nsteps = 0, pend = 0;
#if BIG_FLAGS
  const int tw = L.local ? 2 : 1;  // the words a row writes a step
#endif
#endif
  Planes P{{pl, pl + S, pl + 2 * S, pl + 3 * S}, {0, 0, 0, 0}, 0, S - 1};
  const int chunks = L.chunks, log_ch = L.log_ch;
  // the reference's start state (src/scan_block.rs:291-317): a grow from
  // size 0, best 0, a virgin checkpoint at the origin
  Pair m{0, 0, 0, 0, min_size, 0, 0, DIR_GR, DIR_GR, NEG,
         0, 0, 0, 0, 0, 1, false, false, NEG,
         INT_MIN_, 0, 0, INT_MIN_, 0, 0, 0, 0, 0};

  // probe: pair start (the `probe:` lines mark the sections that
  // scripts_torch/probe_big_kernel.py times in a copy of this source)
  int s = 0;
  for (; s < max_steps && !m.done; ++s) {
    // probe: step start
#if BIG_TRACE
    // a step whose rows pass the budget stops the pair: an overrun
#if BIG_FLAGS
    if (tpos + tw * (m.dir == DIR_GD ? m.psz : m.sz) > budget) break;
#else
    if (tpos + (m.dir == DIR_GD ? m.psz : m.sz) > budget) break;
#endif
    ++nsteps;
#endif
    Step st;
    st.shift = m.dir == DIR_R || m.dir == DIR_D;
    st.right_or = m.dir == DIR_R || m.dir == DIR_GR;  // lanes = query
    const int sz = st.sz = m.sz;
    st.psz = m.psz;
    st.cpos = m.cpos;
    st.h = m.dir == DIR_GD ? m.psz : sz;  // rect height
    st.ls = st.right_or ? m.I : m.J;      // lane start
    st.cstart = m.dir == DIR_R   ? m.J + sz - STEP
                : m.dir == DIR_D ? m.I + sz - STEP
                                 : (m.dir == DIR_GD ? m.I : m.J) + m.psz +
                                       m.cpos;
#if BIG_PROFILE
    // a right rect's entering profile rows, before the step's barrier
    if (st.right_or)
      for (int k = L.gt; k < STEP * PROF_WORDS; k += T)
        prow[pp][k] =
            L.pw[(size_t)min(st.cstart + k / PROF_WORDS, L.pmax) * PROF_WORDS +
                 k % PROF_WORDS];
#endif
    // the previous step's reads of the planes are done (and the profile
    // rows are in)
    pair_sync(L);
    if (m.rest) {
      // a grow starts down-oriented from the checkpoint's borders
      P.a = 0;
      P.base[0] = P.base[1] = P.base[2] = P.base[3] = 0;
      for (int r = L.gt; r < sz; r += T) {
        P.p[0][r] = ck[2][r];
        P.p[2][r] = ck[3][r];
        P.p[1][r] = ck[0][r];
        P.p[3][r] = ck[1][r];
      }
      m.rest = false;
      pair_sync(L);  // the restored borders are visible
    }
    st.oa = 0;
    st.cvec = NEG;
    if (st.shift) {
      // offset rebase of both borders, by each row's thread
      st.oa = min(max(m.off - m.offmax, NEG), POS);
      m.off = m.offmax;
      if ((m.dir == DIR_R && m.pdir == DIR_D) ||
          (m.dir == DIR_D && m.pdir == DIR_R))
        st.cvec = sat2(m.corn + st.oa);
    }
#if BIG_FLAGS
    // the relative zero of the step's (rebased or restored) offset, and
    // whether free start gaps re-seed row 0 (a right rect at query row 0)
    st.rz = min(max(ZERO - m.off, NEG), POS);
    st.ins0 = L.fstart && st.right_or && m.I == 0;
#endif
    // the rect maximum restarts with each rect; GROW_R continues GROW_D's
    if (m.cpos == 0 && m.dir != DIR_GR) m.dmax = NEG;
    const int lane_len = st.right_or ? ql : rl;
    const int col_len = st.right_or ? rl : ql;
    // freeze predicate: never inside GROW_D
    st.fra = st.ls + st.h > lane_len && m.dir != DIR_GD;
    st.frt = col_len - st.cstart;
    st.fridx = min(max(lane_len - st.ls, 0), S - 1);
    st.origin = m.dir == DIR_GR && m.psz == 0 && m.cpos == 0 && m.J == 0;
#if BIG_TRACE
    st.tpos = tpos;
    if (L.gt == 0) {
      int* d = tdesc + ((size_t)s * B + b) * 5;
      d[0] = (st.right_or ? F_RIGHT : 0) | (m.cpos == 0 ? F_START : 0) | pend;
      d[1] = st.ls;
      d[2] = st.cstart;
      d[3] = st.h;
      d[4] = tpos;
    }
    pend = 0;
#else
    st.tpos = 0;
#endif
    const int cpos_new = m.cpos + STEP;
    const bool phase_done = cpos_new >= (st.shift ? STEP : sz - m.psz);

    // probe: columns
    // the step at K = h / T rows a thread
    int xk = INT_MIN_, corn_next = m.corn;
    bool frozen;
    const int k = st.h / T;
    if (k <= 1)
      frozen = run_step<XDROP, 1>(L, st, P, m, sh, xk, corn_next);
    else if (k == 2)
      frozen = run_step<XDROP, 2>(L, st, P, m, sh, xk, corn_next);
    else if (k == 4)
      frozen = run_step<XDROP, 4>(L, st, P, m, sh, xk, corn_next);
    else if (k == 8)
      frozen = run_step<XDROP, 8>(L, st, P, m, sh, xk, corn_next);
    else if (KMAX == 16 || k == 16)
      frozen = run_step<XDROP, 16>(L, st, P, m, sh, xk, corn_next);
    else if (KMAX == 32 || k == 32)
      frozen = run_step<XDROP, (KMAX < 32 ? KMAX : 32)>(L, st, P, m, sh, xk,
                                                         corn_next);
    else
      frozen = run_step<XDROP, KMAX>(L, st, P, m, sh, xk, corn_next);
    // probe: step end
#if BIG_TRACE
#if BIG_FLAGS
    tpos += tw * st.h;
#else
    tpos += st.h;
#endif
#endif
    int cur_max = NEG;
    if (phase_done && m.dir != DIR_GD) {
      // the rect completes: each warp's part of its maximum
      cur_max = __reduce_max_sync(FULL, m.dmax);
      if (G > 1 && lane == 0) red[warp] = cur_max;
    }
    pair_sync(L);  // the step's cells, bottom cells and keys are visible
    if (frozen) {
      m.done = true;
      break;
    }
    if constexpr (XDROP) {
      // the 16-residue tracker: the step's best of residue lane % 16, at
      // the latest column and the highest chunk of its value; a value of
      // NEG ties there at the last chunk, as in the plain version, whose
      // rows past the height are NEG
      if (G > 1)
        for (int v = warp - L.wi; v < warp - L.wi + G; ++v)
          xk = max(xk, wkey[v * 16 + (lane & 15)]);
      const int cmax = xk >> (log_ch + 3);
      if (cmax >= m.vm) {
        m.vm = cmax;
        m.ai = st.ls + 16 * (cmax == NEG ? chunks - 1 : xk & (chunks - 1));
        m.aj = st.cstart + ((xk >> log_ch) & (STEP - 1));
      }
#if BIG_FLAGS
    } else if (L.fend) {
      // free end gaps: the running max of row qlen's residue, and the
      // latest column where a row of a chunk reaching past qlen equals it;
      // where the max is NEG the rows past the height (NEG in the plain
      // version) equal it too, the last chunk of which reaches past qlen
      // once ls + S does
      for (int w = 0; w < STEP; ++w) {
        int key = INT_MIN_;
        for (int v = warp - L.wi; v < warp - L.wi + G; ++v)
          key = max(key, fkey[w * MAX_WARPS + v]);
        const int cmax = key >> 1, vmn = max(m.vm, cmax);
        if ((cmax >= m.vm && (key & 1)) || (vmn == NEG && st.ls + S > ql))
          m.aj = st.cstart + w;
        m.vm = vmn;
      }
#endif
    }
    if (st.shift) {
      // a shift's end (reference: src/scan_block.rs:165-177, 349-355): keep
      // row 7 as the next corner and shift the passive border by 8; its
      // bottom cells are in
      m.corn = corn_next;
      P.base[P.pD()] += STEP;
      P.base[P.pR()] += STEP;
    }
    m.cpos = phase_done ? 0 : cpos_new;
    if (!phase_done) continue;

    if (m.dir == DIR_GD) {
      // GROW_D -> GROW_R: the lane axis flips to the query
      P.a ^= 1;
      m.dir = DIR_GR;
      if constexpr (XDROP) {
        // bank the GROW_D half's candidate (lanes = reference) and restart
        // the tracker for GROW_R
        int ai, aj;
        m.gdmax = tracker_best(m, lane, ai, aj);
        m.gdbi = aj;
        m.gdbj = ai;
        m.vm = INT_MIN_;
      }
      continue;
    }
    // rect completion: the reference's decision ladder
    // (src/scan_block.rs:439-565)
    const int d0 = m.dir;
    const bool was_grow = d0 == DIR_GR;
    const bool ro = d0 == DIR_R || d0 == DIR_GR;
    if (G > 1)
      for (int v = warp - L.wi; v < warp - L.wi + G; ++v)
        cur_max = max(cur_max, red[v]);
#if BIG_FLAGS
    // free end gaps: the rect maximum is row qlen's residue's
    if (L.fend) cur_max = m.vm;
#endif
    const int off_max = m.off + cur_max - ZERO;
    m.offmax = off_max;
    int ydi = m.yiter + 1;
    m.gnm = was_grow ? 1 : 0;
    const bool new_best = off_max > m.best;
    const bool save = new_best && sz < S;
    if (save) {
      m.ckI = m.I;
      m.ckJ = m.J;
      m.ckOff = m.off;
      m.gnm = 0;
    }
    // a completed grow saves its doubled borders even without a new best
    // (reference: src/scan_block.rs:432-435)
    if (save || (was_grow && sz < S)) save_ckpt(P, ck, ro, sz, L);
#if BIG_TRACE
    if (save || (was_grow && sz < S)) pend |= F_SAVE;
#endif
    if (new_best) {
      m.best = off_max;
      ydi = 0;
    }
    if constexpr (XDROP) {
      if (new_best) {
        // the rect tracker's candidate; a grow takes the GROW_D half's when
        // it beats the GROW_R half's strictly (reference:
        // src/scan_block.rs:463-482)
        int ai, aj;
        const int cmr = tracker_best(m, lane, ai, aj);
        const bool use_right = !was_grow || cmr >= m.gdmax;
        m.xbi = use_right ? (ro ? ai : aj) : m.gdbi;
        m.xbj = use_right ? (ro ? aj : ai) : m.gdbj;
      }
      m.vm = INT_MIN_;
      m.gdmax = INT_MIN_;
      // the end: the max fell more than x below the best at two decisions in
      // a row (X_DROP_ITER = 2), or the rect covers both ends; it pre-empts
      // this rect's grow, shrink and move (reference: src/scan_block.rs:497-507)
      const bool xfail = off_max < m.best - xdrop;
      const bool stop = xfail && m.xiter >= 1;
      m.xiter = xfail ? m.xiter + 1 : 0;
      if (stop || (m.I + sz > ql && m.J + sz > rl)) {
        m.done = true;
        continue;
      }
    }
#if BIG_FLAGS
    if (L.fend) {
      // the best of row qlen at its residue's column, even on grows; a
      // fresh tracker per rect; the end: both ends covered
      if (new_best) {
        m.xbi = ql;
        m.xbj = m.aj;
      }
      m.vm = INT_MIN_;
      m.aj = 0;
      if (m.I + sz > ql && m.J + sz > rl) {
        m.done = true;
        continue;
      }
    }
#endif
    // forced moves skip both heuristics (src/scan_block.rs:509-516)
    const bool forced_down = m.J + sz > rl;
    const bool free_rect = !forced_down && m.I + sz <= ql;
    bool shrink = false;
    if (free_rect && 2 * sz <= S && (ydi > sz / STEP - 1 || m.gnm == 1)) {
      // grow: double and restart from the checkpoint
      m.psz = sz;
      m.sz = 2 * sz;
      m.I = m.ckI;
      m.J = m.ckJ;
      m.off = m.ckOff;
      m.rest = true;
      m.dir = DIR_GD;
      ydi = 0;
#if BIG_TRACE
      pend |= F_RESTORE;
#endif
    } else {
      if (free_rect && sz > min_size && ydi == 0) {
        // shrink when the border suffix holds the rect maximum
        // (src/scan_block.rs:534-559)
        int suf = INT_MIN_;
#pragma unroll
        for (int r = sz - SUFFIX; r < sz; ++r)
          suf = max(suf, max((int)P.at(P.aD(), r), (int)P.at(P.pD(), r)));
        shrink = suf >= cur_max;
      }
      if (shrink) {
        // halve into the suffix corner: rows [half, sz) become [0, half)
        const int half = sz >> 1;
#pragma unroll
        for (int q = 0; q < 4; ++q) P.base[q] += half;
        m.sz = half;
        m.I += half;
        m.J += half;
        m.ckI = m.I;
        m.ckJ = m.J;
        m.ckOff = m.off;
        save_ckpt(P, ck, ro, half, L);
        ydi = 0;
#if BIG_TRACE
        pend |= F_SAVE;
#endif
      }
      // direction from the first 8 rows of both borders
      // (src/scan_block.rs:560-565)
      int ah = INT_MIN_, ph = INT_MIN_;
      {
        const short *da = P.p[P.aD()], *dp = P.p[P.pD()];
        const int ba = P.base[P.aD()], bp = P.base[P.pD()];
#pragma unroll
        for (int r = 0; r < STEP; ++r) {
          ah = max(ah, (int)da[(ba + r) & P.mask]);
          ph = max(ph, (int)dp[(bp + r) & P.mask]);
        }
      }
      const int right_max = ro ? ah : ph, down_max = ro ? ph : ah;
      const bool godown = forced_down || (free_rect && down_max > right_max);
      if (godown) m.I += STEP; else m.J += STEP;
      m.dir = godown ? DIR_D : DIR_R;
      // the lane axis flipped: the borders trade roles
      if (ro == godown) P.a ^= 1;
    }
    m.yiter = ydi;
    // a shrink forces GROW_D as the previous direction, which kills the next
    // rect's corner (src/scan_block.rs:541)
    m.pdir = shrink ? DIR_GD : d0;
  }
  pair_sync(L);  // the frozen cell's score is visible
  // probe: pair end
  if (L.gt == 0) {
#if BIG_TRACE
    tsteps[b] = nsteps;
    tused[b] = tpos;
#endif
    if constexpr (XDROP) {
      out[4 * b] = m.best;
      out[4 * b + 1] = m.xbi;
      out[4 * b + 2] = m.xbj;
      out[4 * b + 3] = m.done ? 0 : 1;
#if BIG_FLAGS
    } else if (L.fend) {
      out[4 * b] = m.best;
      out[4 * b + 1] = m.xbi;
      out[4 * b + 2] = m.xbj;
      out[4 * b + 3] = m.done ? 0 : 1;
#endif
    } else {
      out[2 * b] = *sh.score;
      out[2 * b + 1] = m.done ? 0 : 1;
    }
  }
}

// The instance of a configuration: by the most rows a thread holds, 16,
// 32 or MAX_ROWS (the 16384-row libraries hold 32 only).
template <bool X>
auto instance(int min_size, int max_size) {
  const int rows = rows_max(min_size, max_size);
  auto kernel = big_align_kernel<X, MAX_ROWS>;
  if constexpr (!BIG_16384) {
    if (rows <= 32) kernel = big_align_kernel<X, 32>;
    if (rows <= 16) kernel = big_align_kernel<X, 16>;
  }
  return kernel;
}

template <bool X>
cudaError_t launch(const uint8_t* codes, const int* qlen, const int* rlen,
                   const int* table, int* out, void* words, void* desc,
                   void* steps, void* used, int B, int cap, int alpha,
                   int min_size, int max_size, int max_steps, int gopen,
                   int gext, int xdrop, int budget, int flags, int bmatch,
                   int bmismatch, int prof_cap, void* scratch,
                   cudaStream_t stream) {
  const int G = pair_warps(min_size, max_size), P = block_pairs(G);
  const size_t smem = P * pair_shorts(max_size) * sizeof(short);
  const int threads = 32 * G * P, blocks = (B + P - 1) / P;
  const auto kernel = instance<X>(min_size, max_size);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(
      codes, qlen, rlen, table, out, B, cap, alpha, max_size, G, min_size,
      max_steps, gopen, gext,
      xdrop BIG_TRACE_ARGS BIG_FLAGS_ARGS BIG_PROFILE_ARGS BIG_16384_ARGS);
  return cudaGetLastError();
}

bool bad_sizes(int min_size, int max_size) {
  return min_size < 16 || (min_size & (min_size - 1)) || max_size < 512 ||
#if BIG_16384
         max_size != 16384 ||
#else
         max_size > 8192 ||
#endif
         (max_size & (max_size - 1)) || min_size > max_size ||
         (min_size == max_size && max_size == 512);
}

// The modes a library takes: none but in the FLAGS and profile libraries,
// and there the reference's exclusions (no local start with free start
// gaps, no x-drop with free end gaps or byte mode, no byte mode with a
// profile)
bool bad_flags(int flags, bool xdrop) {
  return (flags & ~15) || (flags && !BIG_FLAGS) ||
         ((flags & LOCAL_START) && (flags & FREE_START)) ||
         (xdrop && (flags & (FREE_END | BYTE_MODE))) ||
         (BIG_PROFILE && (flags & BYTE_MODE));
}

}  // namespace

// codes (B, 2, cap) uint8, qlen/rlen (B,) int32, table (alpha, alpha) int32
// (byte mode: alpha 256 and no table read).  x_drop < 0: global mode, out
// (B, 2) int32 = (score, overrun), with free end gaps (B, 4) as x-drop's;
// else x-drop with x = x_drop, out (B, 4) int32 = (best, query pos,
// reference pos, overrun).  The trace libraries (csrc/big_trace.cu,
// csrc/big_trace_flags.cu) also write words (B, budget), desc (max_steps,
// B, 5), steps and used (B,) int32; the others take null trace pointers.
// `flags` (LOCAL_START | FREE_START | FREE_END | BYTE_MODE, as in
// csrc/lane_kernel.cu's lane_align_launch) and byte mode's match and
// mismatch scores are read by the FLAGS libraries (csrc/big_flags.cu,
// csrc/big_trace_flags.cu) and the profile libraries (csrc/big_profile.cu,
// csrc/big_trace_profile.cu, no byte mode); the others take flags 0.  The
// profile libraries take prof_cap > 0 (a multiple of 128), the others 0:
// there codes (B, cap) uint8 are the queries' codes, table (B, prof_cap,
// 8) int32 the profiles' words (ops/_profile.py), rlen the profiles'
// lengths (each below prof_cap - 1), and alpha and gopen are not read.  The
// 16384-row libraries (csrc/big_16384.cu, csrc/big_trace_16384.cu) take
// max_size 16384 only and `scratch`, (B, 4, 16384) int16, which the kernel
// overwrites; the others take max_size up to 8192 and a null scratch.  A
// pair takes 1 to 16 warps, several pairs a block (big_launch_shape).
// Returns the cudaError_t of the launch.
extern "C" int big_align_launch(const void* codes, const void* qlen,
                                const void* rlen, const void* table, void* out,
                                void* words, void* desc, void* steps,
                                void* used, void* scratch, int B, int cap,
                                int alpha,
                                int min_size, int max_size, int max_steps,
                                int gopen, int gext, int x_drop, int budget,
                                int flags, int match, int mismatch,
                                int prof_cap, void* stream) {
  const bool traced = words && desc && steps && used && budget > 0;
  if (B < 1 || cap < 1 || alpha < 1 ||
      ((flags & BYTE_MODE) ? alpha != 256 : alpha > MAX_ALPHA) ||
      bad_sizes(min_size, max_size) || bad_flags(flags, x_drop >= 0) ||
      traced != BIG_TRACE || (!BIG_TRACE && (words || desc || steps || used)) ||
      (prof_cap > 0) != BIG_PROFILE || prof_cap < 0 || prof_cap % 128 ||
      (scratch != nullptr) != BIG_16384)
    return (int)cudaErrorInvalidValue;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* q = static_cast<const int*>(qlen);
  const auto* r = static_cast<const int*>(rlen);
  const auto* t = static_cast<const int*>(table);
  auto* o = static_cast<int*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return x_drop < 0
             ? (int)launch<false>(c, q, r, t, o, words, desc, steps, used, B,
                                  cap, alpha, min_size, max_size, max_steps,
                                  gopen, gext, x_drop, budget, flags, match,
                                  mismatch, prof_cap, scratch, st)
             : (int)launch<true>(c, q, r, t, o, words, desc, steps, used, B,
                                 cap, alpha, min_size, max_size, max_steps,
                                 gopen, gext, x_drop, budget, flags, match,
                                 mismatch, prof_cap, scratch, st);
}

// The launch of a configuration's instance (x-drop if `x_drop`; the trace
// libraries' trace instance, the profile libraries' profile instance;
// `flags` as in big_align_launch): shape[0] threads a block, shape[1]
// bytes of dynamic shared memory, shape[2] blocks resident on an SM of the
// current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor), shape[3]
// threads a pair, shape[4] pairs a block and shape[5] pairs an SM.
extern "C" int big_launch_shape(int min_size, int max_size, int x_drop,
                                int flags, int* shape) {
  if (bad_sizes(min_size, max_size) || bad_flags(flags, x_drop))
    return (int)cudaErrorInvalidValue;
  const int G = pair_warps(min_size, max_size), P = block_pairs(G);
  const size_t smem = P * pair_shorts(max_size) * sizeof(short);
  const int threads = 32 * G * P;
  const auto kernel = x_drop ? instance<true>(min_size, max_size)
                             : instance<false>(min_size, max_size);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      smem);
  shape[0] = threads;
  shape[1] = (int)smem;
  shape[2] = blocks;
  shape[3] = 32 * G;
  shape[4] = P;
  shape[5] = blocks * P;
  return (int)err;
}

extern "C" const char* big_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
