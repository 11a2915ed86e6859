// Fixed-block alignment of a batch of sequence pairs, or of (query, profile)
// pairs, global or x-drop, with or without trace, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by ops/lane_kernel.py; the profile
// instances build apart from csrc/lane_profile.cu, and the instances that
// read the flags and byte mode from csrc/lane_flags.cu and
// csrc/lane_profile_flags.cu.
//
// Replaces: block_aligner_tpu/ops/lane_kernel.py::build_lane_engine (its
// Pallas `kernel`) in global and in x-drop mode, with and without trace,
// with a score table, byte equality or a profile, with or without the
// local-start, free-query-start-gap and free-query-end-gap flags.
// It computes the same score (x-drop: the best score and its position) and
// the same y-drop suspect flag, bit for bit, and in trace mode the
// traceback bits of every cell it computes; the step machine is described
// in ops/lane_kernel.py, whose lane_align_plain is the plain PyTorch
// version of this kernel, and the trace layout in core/traceback.py.
//
// What bounds it: integer ALU work (a handful of adds and maxes per DP
// cell) and, above all, latency: each of a pair's 8 columns per step
// depends on the one before, and each column carries a max-plus prefix
// scan down the block, a chain of dependent warp shuffles.  Bytes are not
// the limit: a pair reads its codes once per step and writes 8 bytes.
//
// The layout before this one gave every pair one warp, 16 rows a lane at
// S = 512: a few long pairs left the card idle (64 reads on 16 SMs, one
// warp a scheduler) while each column ran two 16-row passes and a 16-deep
// dependent chain, and the S = 512 instances spilled.  What this design
// does about it:
// * a pair takes G warps, and a lane holds RPL = S / (32 G) contiguous rows
//   in registers (S = 16 leaves half the warp idle).  G is 1 up to 256
//   rows; at 512 it is 4 (4 rows a lane) in a launch of at most one pair an
//   SM and 2 (8 rows a lane) in a larger one, both instances built and the
//   choice made at launch (WIDE_WARPS, NARROW_WARPS, FEW_PAIRS: by time,
//   PERF.md).  A 128-thread block carries 4 one-warp pairs, 2 two-warp
//   pairs or 1 of four, so a batch smaller than the card lands on as many
//   SMs as it has blocks.  Each pair runs its own step loop and leaves as soon as its
//   block freezes, so no pair waits for the longest one in a batch (the
//   TPU kernel ran 128-pair lanes in lockstep);
// * the column's vertical-gap scan runs in three levels: serial over a
//   lane's rows, over the warp's 32 lanes in three rounds of shuffles
//   issued together (3, 3 and 2 lanes up: 8 shuffles, of which only three
//   wait in a row, where a log-step scan waits on six), and, with several
//   warps, over the warps' aggregates through shared memory behind the
//   pair's named barrier (bar.sync 1 + pair, 32 G threads), once a column.
//   The same exchange carries D before R of each warp's last row (and, for
//   profiles, its D plus R open and its close cost), from which the next
//   warp's first lane derives that row's R, its final D (the next column's
//   diagonal) and its R-open trace bit, so a column needs one barrier.
//   With several warps, where a column waits on this chain, every other
//   lane derives its next diagonal the same way, from the scan and a
//   shuffle issued before it, so the chain holds no shuffle after the
//   second pass (UP_FROM_SCAN), and each warp reduces its aggregate for
//   the exchange while its shuffles run (EARLY_TOTAL).  A one-warp pair
//   synchronises with __syncwarp only;
// * once a step the pair's warps meet again for the step's end: each warp
//   posts its maximum, the first 8 rows' border maxima (warp 0), its
//   x-drop key (below), the rebased passive rows the warp above shifts in,
//   and the free-end gaps' column keys; every thread then takes the same
//   decision from the same values;
// * every add is int32 and saturates at the i16 rails only where it can
//   reach them: the score add, the rebase and a profile's costs at both,
//   the gap adds (costs <= 0, refused otherwise) at the lower rail alone,
//   and the add-then-max chains (C = max(C + e, D + o), the in-lane scan,
//   the shuffle scan's carries, R from the carry) are single DPX
//   instructions (__viaddmax_s32, __vimax3_s32);
// * the score table sits in shared memory and each lane looks up
//   table[column code][own row code] directly, which replaces the TPU's
//   packed score stacks and one-hot matrix products.
// X-drop is a template flag, so the global instances keep their code and
// the x-drop ones have no freeze.  The 16-residue tracker (running max per
// residue class row % 16, reached last at the highest 16-row chunk and the
// latest column) is kept per row: a lane's rows lie in one chunk, so each
// of its rows keeps its own running max and the latest column that
// reached it, with no shuffle per column.  At a decision each row holding
// the step's maximum makes a key (15 - residue, column, chunk) whose
// largest value over the pair is the lowest residue, then the latest
// column, then the highest chunk.  That is the per-column rule of the JAX
// kernel: a running max only grows, so the last column where the whole
// tracker is raised or reached again is the last column where some row
// reached the final max, and the rows that reached it there are exactly
// those whose own latest column it is.
// Trace is a template flag too.  Each lane ORs a cell's 4 bits into one
// word per row it holds, column w at bits 4w..4w+3, and stores its words
// once per step (contiguous rows per lane, so the pair's stores coalesce);
// the pair's first thread stores the step's descriptor.  The R bit of a
// row is the row above's R == D_open, one shuffle of the lane's packed
// bits per column (across warps, from the exchange above).  A freezing
// step stores the columns computed before it leaves.
// Profile mode (sequence-to-PSSM, ops/_profile.py) is a fourth flag: the
// profile plays the reference, one 32-byte row of 8 words per position.
// A right step stages its 8 entering rows (256 bytes) in shared memory and
// each lane scores by its own query code; a down step's lane, a profile
// position, reads its own row (two L1 loads a cell: the score word and the
// gap word) by the entering query code.  Every lane knows its row's
// position from the block's anchor, so no lane-window stack of rows is
// kept.  Gap opens and the close cost come from the row's gap word, the C
// and R roles swapped on down steps; the close applies only on the merge
// into D, and the trace bits compare D with the closed values.
// ByteMatrix scoring and the three flags are built into libraries of their
// own (LANE_FLAGS), whose instances read which of them apply from a
// run-time argument (a branch the whole pair takes alike), so that four
// instances per size serve all of them.  Byte mode compares the lane's byte with the entering one in
// place of the table fetch (no table is loaded; the codes are raw bytes,
// alpha 256).  Local start raises each cell's D to the relative zero
// clip(ZERO - off) before the merges; free start gaps set row 0 of a right
// block whose lanes start at query row 0 to it.  In trace mode local start
// adds one word per row and step after the S words of the 4-bit cells,
// bit w the cell of column w whose D equals the relative zero.  Free end
// gaps (query shorter than S) replace the freeze by the x-drop tracker cut
// down to the residue qlen % 16: each column the pair takes the max of the
// key 2 D + (the row's chunk reaches past qlen) over that residue's rows,
// whose half is the column's max and whose low bit says whether a row of
// a chunk past qlen holds it; the running max drives the offset and the
// y-drop counter, the best is kept at each decision, and a pair ends once
// its block covers both ends.
// i16x2 packing and several pairs per warp at S = 16 are left to later
// work.

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
constexpr int BLOCK_WARPS = 4;      // warps a thread block
constexpr unsigned FULL = 0xffffffffu;
// profile words per position: 7 score words (4 biased bytes each, query
// codes 0..27), then the gap word open_C | open_R << 8 | close_C << 16
constexpr int PROF_WORDS = 8;
// the run-time modes of the FLAGS instances (the `flags` argument)
constexpr int LOCAL_START = 1, FREE_START = 2, FREE_END = 4, BYTE_MODE = 8;

// A pair's warps at block S, chosen by time (PERF.md; the `warps` sweep of
// scripts_torch/probe_big_kernel.py rewrites these two lines in copies):
// WIDE_WARPS for a launch of at most FEW_PAIRS pairs an SM, which waits on
// each column's chain, NARROW_WARPS for more, which waits on instructions
// (every warp repeats the shuffle scan for its lanes' rows)
template <int S> constexpr int WIDE_WARPS = S >= 512 ? 4 : 1;
template <int S> constexpr int NARROW_WARPS = S >= 512 ? 2 : 1;
constexpr int FEW_PAIRS = 1;
// pairs a thread block of G-warp pairs: 4 of one warp, 2 of two, else 1
template <int G>
constexpr int BLOCK_PAIRS = G >= BLOCK_WARPS ? 1 : BLOCK_WARPS / G;
template <int G>
constexpr int BLOCK_THREADS = 32 * G * BLOCK_PAIRS<G>;

#ifndef LANE_PROFILE
// csrc/lane_profile.cu builds the profile instances apart, so that the
// libraries compile in parallel
#define LANE_PROFILE false
#endif
#ifndef LANE_FLAGS
// csrc/lane_flags.cu and csrc/lane_profile_flags.cu build the FLAGS
// instances apart.  Their code is compiled in by the preprocessor, not in
// discarded `if constexpr` branches: those still moved ptxas's register
// allocation of the other libraries' profile x-drop trace instances.
#define LANE_FLAGS false
#endif
#if LANE_FLAGS
// the FLAGS instances' extra arguments
#define LANE_MODE_ARGS , flags, bmatch, bmismatch
#else
#define LANE_MODE_ARGS
#endif
#ifndef LANE_NAMED_SYNC
// the named barrier `id` of `n` threads (a host-side build of this source
// may define its own)
#define LANE_NAMED_SYNC(id, n) \
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory")
#endif

// i16 saturation at both rails, for the adds that can reach the upper one
// (a score or a profile cost, the rebase: a block's columns run far without
// a rebase in the first S/8 steps).  An add of a gap cost (<= 0) to a value
// at most POS clamps at the lower rail alone: __viaddmax_s32(x, c, NEG).
__device__ __forceinline__ int sat2(int x) { return min(max(x, NEG), POS); }

// The score of query code `code` in a profile position's row: byte code % 4
// of word code / 4, biased by 128.  No word holds a code past 27, which
// scores -128 (its read lands on the gap word and is dropped).
__device__ __forceinline__ int prof_score(const int* row, int code) {
  const int word = row[min(code >> 2, PROF_WORDS - 1)];
  return code < 4 * (PROF_WORDS - 1) ? ((word >> (8 * (code & 3))) & 255) - 128
                                     : -128;
}

// A profile position's gap costs for one cell (reference:
// src/scan_block.rs:651-705).  On a right step the position is the
// column's: C opens with its open_C (plus the extension), R with its
// open_R, and C closes with its close_C.  On a down step it is the lane's
// and the roles swap: C opens with open_R, R with open_C, and R closes.
struct ProfGaps {
  int copen, dopen, close;
  __device__ __forceinline__ ProfGaps(int g, bool right, int gext) {
    const int oc = (g & 255) - 128, orr = ((g >> 8) & 255) - 128;
    copen = (right ? oc : orr) + gext;
    dopen = right ? orr : oc;
    close = ((g >> 16) & 255) - 128;
  }
};

// An int the optimizer cannot see through, so that a select among a row
// array's entries stays a select and is not turned into an indexed copy
// of the array in local memory.
__device__ __forceinline__ int opaque(int v) {
  asm("" : "+r"(v));
  return v;
}

// The pair's threads meet: a warp's lanes, or the pair's named barrier.
template <int G>
__device__ __forceinline__ void pair_sync(int pair) {
  if constexpr (G == 1)
    __syncwarp();
  else
    LANE_NAMED_SYNC(1 + pair, 32 * G);
}

// Passive border shift, row r <- row r + 8, in two parts: inside the warp
// (shift_rows, RPL rows a lane), and into the last 8 rows of the WL lanes
// that hold rows, from `nxt`, the 8 rows after them (the next warp's
// first, or the step's bottom cells: fill_rows).
template <int RPL>
__device__ __forceinline__ void shift_rows(int (&x)[RPL]) {
  if constexpr (RPL >= STEP) {
    int nx[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k)
      nx[k] = k + STEP < RPL ? x[k + STEP]
                             : __shfl_down_sync(FULL, x[k + STEP - RPL], 1);
#pragma unroll
    for (int k = 0; k < RPL; ++k) x[k] = nx[k];
  } else {
#pragma unroll
    for (int k = 0; k < RPL; ++k)
      x[k] = __shfl_down_sync(FULL, x[k], STEP / RPL);
  }
}

template <int WL, int RPL>
__device__ __forceinline__ void fill_rows(int (&x)[RPL], const int* nxt,
                                          int lane) {
  if constexpr (RPL >= STEP) {
    if (lane == WL - 1) {
#pragma unroll
      for (int k = RPL - STEP; k < RPL; ++k) x[k] = nxt[k + STEP - RPL];
    }
  } else {
    constexpr int D = STEP / RPL;  // lanes per 8 rows
    if (lane >= WL - D && lane < WL) {
#pragma unroll
      for (int k = 0; k < RPL; ++k) x[k] = nxt[(lane - (WL - D)) * RPL + k];
    }
  }
}

// N (1..8, a power of two) codes of a sequence's row `p` of `cap` bytes
// (8-byte aligned) from position `pos` (a multiple of N), each position
// clamped to cap - 1, packed 4 a word: one load where they lie in the row.
template <int N>
__device__ __forceinline__ void load_codes(const uint8_t* p, int pos, int cap,
                                           unsigned (&w)[(N + 3) / 4]) {
  if (pos + N <= cap) {
    if constexpr (N == 8) {
      const int2 v = *reinterpret_cast<const int2*>(p + pos);
      w[0] = (unsigned)v.x;
      w[1] = (unsigned)v.y;
    } else if constexpr (N == 4) {
      w[0] = *reinterpret_cast<const unsigned*>(p + pos);
    } else if constexpr (N == 2) {
      w[0] = *reinterpret_cast<const unsigned short*>(p + pos);
    } else {
      w[0] = p[pos];
    }
  } else {
#pragma unroll
    for (int j = 0; j < (N + 3) / 4; ++j) w[j] = 0u;
#pragma unroll
    for (int i = 0; i < N; ++i)
      w[i >> 2] |= (unsigned)p[min(pos + i, cap - 1)] << (8 * (i & 3));
  }
}

// Code i of the words of load_codes.
__device__ __forceinline__ int code_at(unsigned w, int i) {
  return (int)((w >> (8 * (i & 3))) & 255u);
}

// The x-drop key of this lane's rows that hold the step's maximum `cur`:
// 15 - residue, the column from `base` and the 16-row chunk, so that the
// largest key over the pair is the lowest residue, then the latest column,
// then the highest chunk (-1: no such row).  The column lies within the
// decision's window, the prologue's S columns or a step's 8.
template <int RPL>
__device__ __forceinline__ int xkey(const int (&vm)[RPL], const int (&vj)[RPL],
                                    int cur, int row0, int base, bool on) {
  int key = -1;
#pragma unroll
  for (int k = 0; k < RPL; ++k)
    if (on && vm[k] == cur)
      key = max(key, (15 - ((row0 + k) & 15)) << 14 | (vj[k] - base) << 5 |
                         (row0 + k) >> 4);
  return key;
}

// No __launch_bounds__: with one, ptxas spilled a few bytes in a dozen
// instances to keep a register count below an occupancy step.
template <int S, int G, bool XDROP, bool TRACE, bool PROFILE>
__global__ void lane_align_kernel(const uint8_t* __restrict__ codes,
                  const int* __restrict__ qlen, const int* __restrict__ rlen,
                  const int* __restrict__ table, int* __restrict__ out,
                  int* __restrict__ twords, int4* __restrict__ tdesc,
                  int* __restrict__ tsteps, int B, int cap, int alpha,
#if LANE_FLAGS
                  int max_steps, int gopen, int gext, int xdrop, int flags,
                  int bmatch, int bmismatch) {
#else
                  int max_steps, int gopen, int gext, int xdrop) {
#endif
  constexpr int NT = 32 * G;             // threads a pair
  constexpr int NL = S < NT ? S : NT;    // threads holding block rows
  constexpr int WL = NL < 32 ? NL : 32;  // ... of a warp
  constexpr int RPL = S / NL;            // rows per lane, contiguous
  constexpr int PRO = S / STEP;          // prologue steps (the initial grow)
  constexpr int P = BLOCK_PAIRS<G>;      // pairs a block
  constexpr int GW = G > 1 ? G * P : 1;  // the block's warps, several a pair
  // Two cuts of a column's chain where a pair of several warps waits on it
  // (one warp of a full card waits on its instructions instead; by time,
  // PERF.md): a lane takes the next column's diagonal (the final D of the
  // row above its first) from the column's scan and that row's D before R,
  // shuffled early, not by a shuffle after the column (not in profile
  // mode: its 2-warp x-drop trace instance spilled); and a warp reduces
  // its scan at its last row, the warps' exchange, from its lanes' own
  // while the shuffles run (not with trace, which it slowed)
  constexpr bool UP_FROM_SCAN = G > 1 && !PROFILE;
  constexpr bool EARLY_TOTAL = G > 1 && !TRACE;

  __shared__ int tab[PROFILE ? 1 : MAX_ALPHA * MAX_ALPHA];
  __shared__ int tails[P][2][STEP];  // a step's bottom D and R cells
  // profile: the profile rows of a right step's 8 entering columns
  __shared__ int prows[P][PROFILE ? STEP * PROF_WORDS : 1];
  // several warps a pair, by the column's parity: a warp's scan at its last
  // row, and there D before R, (profiles) D plus R open and the close
  __shared__ int wagg[2][GW], wdp[2][GW];
  __shared__ int wt[2][PROFILE ? GW : 1], wcl[2][PROFILE ? GW : 1];
  // ... and at a step's end: a warp's maximum, (warp 0) the first 8 rows'
  // active and passive maxima, its x-drop key; the rebased passive D and R
  // of its first 8 rows; the passive D of its last row; free end gaps' keys
  // by column; global mode's frozen cell
  __shared__ int wred[GW][4];
  __shared__ int wfirst[GW][2][STEP];
  __shared__ int wlast[GW];
  __shared__ int fkeys[LANE_FLAGS ? STEP : 1][GW];
  __shared__ int fscore[P];

#if LANE_FLAGS
  // the modes of this launch
  const bool local = flags & LOCAL_START;
  const bool fstart = flags & FREE_START;
  const bool fend = flags & FREE_END;
  const bool byte = !PROFILE && (flags & BYTE_MODE);
  if constexpr (!PROFILE) {
    if (!byte)
      for (int k = threadIdx.x; k < alpha * alpha; k += blockDim.x)
        tab[k] = table[k];
    __syncthreads();
  }
#else
  constexpr bool byte = false;
  if constexpr (!PROFILE) {
    for (int k = threadIdx.x; k < alpha * alpha; k += blockDim.x)
      tab[k] = table[k];
    __syncthreads();
  }
#endif

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;  // in the block
  const int pp = warp / G;            // the pair in the block
  const int wi = warp - pp * G;       // the warp in the pair
  const int gt = wi * 32 + lane;      // the thread in the pair
  const int b = blockIdx.x * P + pp;
  if (b >= B) return;
  int* tailD = tails[pp][0];
  int* tailR = tails[pp][1];
  int* prow = prows[pp];
  const bool on = NL == NT || gt < NL;
  const int row0 = gt * RPL;
  const int ql = qlen[b], rl = rlen[b];
  // profile: codes (B, cap) of the queries and table (B, cap, 8) of the
  // profiles' words; else codes (B, 2, cap) of both sequences
  const uint8_t* qs = codes + (size_t)b * (PROFILE ? 1 : 2) * cap;
  const uint8_t* rs = qs + cap;
  const int* pw = table + (size_t)b * cap * PROF_WORDS;

  int actD[RPL], actC[RPL], pasD[RPL], pasR[RPL], zc[RPL];
  // x-drop tracker of this lane's rows: running max, latest column
  int vm[RPL], vj[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    actD[k] = actC[k] = pasD[k] = pasR[k] = 0;
    zc[k] = gext * (((row0 + k) & 7) + 1);  // scan zero correction
    vm[k] = NEG;
    vj[k] = 0;
  }
  int xbest = 0, xbi = 0, xbj = 0, xiter = 0;
  // several warps, in a warp's lane 0: the active D of the row above the
  // warp's first, in the previous column
  int upA = 0;

  int I = 0, J = 0, off = 0, offmax = 0, dir = 2, pdir = 2, corn = NEG;
  int ybest = -(1 << 30), yiter = 0, susp = 0, score = 0;
  int dmax = INT_MIN_;
  bool done = false;
  // freeze predicate of the current block (prologue: lanes = query)
  bool fra = S > ql;
  int frt = rl, fridx = min(max(ql, 0), S - 1);
  int nsteps = 0;  // trace: the steps this pair executed
  // sequences: the next step's codes, loaded a step ahead, by its direction:
  // the lanes' and columns' codes of a right step (query rows from I,
  // reference columns) and of a down step (reference rows from J, query
  // columns); the first step's are the prologue's
  constexpr int LW = (RPL + 3) / 4;
  unsigned nlr[LW], nld[LW], ncr[2], ncd[2];
  if constexpr (!PROFILE) {
    load_codes<RPL>(qs, row0, cap, nlr);
    load_codes<STEP>(rs, 0, cap, ncr);
  }
#if LANE_FLAGS
  // free end gaps: this lane's row of residue qlen % 16 (if it holds one:
  // its rows lie in one 16-row chunk), that row's chunk, the residue's
  // running max and the column of the best
  const int fidx = ((ql & 15) - row0) & 15;
  const bool fhas = on && fidx < RPL;
  const int fchunk = (row0 + fidx) >> 4;
  int fvm = NEG, fj = 0;
#endif

  // probe: pair start (the `probe:` lines mark the sections that
  // scripts_torch/probe_big_kernel.py times in a copy of this source)
  for (int s = 0; s < max_steps && !done; ++s) {
    // probe: step start
    const bool in_pro = s < PRO;
    int oa = 0, cvec = NEG, lstart = 0, cpos0 = s * STEP;
#if LANE_FLAGS
    int rz = ZERO;  // the relative zero of local start and free start gaps
#endif
    if (!in_pro) {
      // offset rebase (reference: src/scan_block.rs:148-151)
      oa = min(max(off - offmax, NEG), 32767);
      off = offmax;
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        actD[k] = sat2(actD[k] + oa);
        actC[k] = sat2(actC[k] + oa);
      }
      if constexpr (G > 1) upA = sat2(upA + oa);
      const bool flip = (dir == 0 && pdir == 1) || (dir == 1 && pdir == 0);
      cvec = flip ? sat2(corn + oa) : NEG;
      const bool right = dir != 1;
      lstart = right ? I : J;
      cpos0 = (right ? J : I) + S - STEP;
      const int lane_len = right ? ql : rl, col_len = right ? rl : ql;
      fra = lstart + S > lane_len;
      frt = col_len - cpos0;
      fridx = min(max(lane_len - lstart, 0), S - 1);
#if LANE_FLAGS
      rz = min(max(ZERO - off, NEG), 32767);
#endif
    }
#if LANE_FLAGS
    // free start gaps: a right block whose lanes start at query row 0
    const bool ins0 = fstart && (in_pro || dir != 1) && lstart == 0;
    unsigned zb[RPL];  // local-start trace: this step's zero bits
#endif
    unsigned wd[RPL];  // trace: this step's bits of this lane's rows
    if constexpr (TRACE) {
      ++nsteps;
      // the step's rect descriptor; the prologue is one right rect at (0, 0)
      if (gt == 0)
        tdesc[(size_t)s * B + b] =
            in_pro ? make_int4(1 | (s == 0 ? 2 : 0), 0, cpos0, S)
                   : make_int4((dir != 1 ? 1 : 0) | 2, lstart, cpos0, S);
#pragma unroll
      for (int k = 0; k < RPL; ++k) wd[k] = 0u;
#if LANE_FLAGS
#pragma unroll
      for (int k = 0; k < RPL; ++k) zb[k] = 0u;
#endif
    }
    const bool right = in_pro || dir != 1;  // lanes are query rows
    int lc[RPL], cc[STEP];  // profiles: the lanes' and columns' codes
    // sequences: the columns' codes, packed (col(w) is column w's), and a
    // column's table scores of the lane's rows
    unsigned ccw[2];
    auto col = [&](int w) { return min(code_at(ccw[w >> 2], w), alpha - 1); };
    int sc[RPL];
    if constexpr (PROFILE) {
      // lanes are query rows on right steps and profile positions on down
      // steps (the profile is the reference)
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int pos = min(lstart + row0 + k, cap - 1);
        lc[k] = right ? (int)qs[pos] : pos;  // a code, or a position
      }
#pragma unroll
      for (int w = 0; w < STEP; ++w) cc[w] = qs[min(cpos0 + w, cap - 1)];
      if (right) {
        // the 8 entering positions' rows, 256 contiguous bytes
#pragma unroll
        for (int i = gt; i < STEP * PROF_WORDS; i += NT)
          prow[i] = pw[(size_t)min(cpos0 + i / PROF_WORDS, cap - 1) *
                           PROF_WORDS + i % PROF_WORDS];
      }
      pair_sync<G>(pp);
    } else {
      // this step's codes, loaded by the step before
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        lc[k] = min(code_at(right ? nlr[k >> 2] : nld[k >> 2], k), alpha - 1);
      ccw[0] = right ? ncr[0] : ncd[0];
      ccw[1] = right ? ncr[1] : ncd[1];
      // and the next step's, whichever way it goes
      load_codes<RPL>(qs, I + row0, cap, nlr);
      load_codes<RPL>(rs, J + row0, cap, nld);
      load_codes<STEP>(rs, s + 1 < PRO ? (s + 1) * STEP : J + S, cap, ncr);
      load_codes<STEP>(qs, I + S, cap, ncd);
      // the first column's scores (each column loads the next one's)
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        sc[k] = byte ? 0 : tab[col(0) * alpha + lc[k]];
    }

    int upn = 0;  // UP_FROM_SCAN: the next column's up
#pragma unroll
    for (int w = 0; w < STEP; ++w) {
      // probe: row pass
      int up = UP_FROM_SCAN && w > 0
                   ? upn
                   : __shfl_up_sync(FULL, actD[RPL - 1], 1);
      if (lane == 0) up = wi > 0 ? upA : w == 0 ? cvec : NEG;
      int D[RPL], C[RPL], T[RPL], CO[RPL];
      int DO[RPL], CL[RPL], CE[RPL];  // profile: D_open, close, closed C
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        if constexpr (PROFILE) {
          // a right step's lane reads the entering row by its own code, a
          // down step's the row of its own position by the entering code
          const int* row = right ? prow + w * PROF_WORDS
                                 : pw + (size_t)lc[k] * PROF_WORDS;
          int d = sat2((k == 0 ? up : actD[k - 1]) +
                       prof_score(row, right ? lc[k] : cc[w]));
          if (k == 0 && w == 0 && s == 0 && gt == 0) d = ZERO;  // origin
#if LANE_FLAGS
          if (local) d = max(d, rz);
          else if (ins0 && k == 0 && gt == 0) d = rz;
#endif
          const ProfGaps g(row[PROF_WORDS - 1], right, gext);
          const int co = sat2(actD[k] + g.copen);
          DO[k] = g.dopen;
          CL[k] = g.close;
          C[k] = __viaddmax_s32(actC[k], gext, co);
          // a right step closes C before the merge; C stays pre-close
          CE[k] = right ? sat2(C[k] + g.close) : C[k];
          D[k] = max(d, CE[k]);
          if constexpr (TRACE) CO[k] = co;
        } else {
#if LANE_FLAGS
          // byte mode compares the codes; the flags restart cells at the
          // relative zero
          int d = sat2((k == 0 ? up : actD[k - 1]) +
                       (byte ? (lc[k] == col(w) ? bmatch : bmismatch)
                             : sc[k]));
          if (k == 0 && w == 0 && s == 0 && gt == 0) d = ZERO;  // DP origin
          if (local) d = max(d, rz);
          else if (ins0 && k == 0 && gt == 0) d = rz;
#else
          int d = sat2((k == 0 ? up : actD[k - 1]) + sc[k]);
          if (k == 0 && w == 0 && s == 0 && gt == 0) d = ZERO;  // DP origin
#endif
          const int co = __viaddmax_s32(actD[k], gopen, NEG);
          C[k] = __viaddmax_s32(actC[k], gext, co);
          D[k] = max(d, C[k]);
          if constexpr (TRACE) CO[k] = co;
        }
      }
      int dpa = 0;  // UP_FROM_SCAN: the row above the lane's first, D before R
      if constexpr (UP_FROM_SCAN) dpa = __shfl_up_sync(FULL, D[RPL - 1], 1);
      if constexpr (!PROFILE) {
        // the next column's scores, loaded while this one's scan runs
        if (w + 1 < STEP && !byte) {
#pragma unroll
          for (int k = 0; k < RPL; ++k)
            sc[k] = tab[col(w + 1) * alpha + lc[k]];
        }
      }
      // probe: lane scan
      // max-plus prefix scan of D + (open - extend) down the block (profile:
      // of D plus the cell's R open): serial inside the lane, log-step
      // across lanes and warps, then the zero correction
      if constexpr (PROFILE) {
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          DO[k] = sat2(D[k] + DO[k]);
          T[k] = k == 0 ? DO[k] : __viaddmax_s32(T[k - 1], gext, DO[k]);
        }
      } else {
        T[0] = D[0] + (gopen - gext);
#pragma unroll
        for (int k = 1; k < RPL; ++k)
          T[k] = __viaddmax_s32(T[k - 1], gext, D[k] + (gopen - gext));
      }
      // probe: shuffle scan
      // (a lane below d gets its own carry back, which the add cannot raise)
      int carry = T[RPL - 1], E;
      const int g1 = gext * RPL;  // the gap extended over a lane's rows
      if constexpr (EARLY_TOTAL) {
        // the warp's scan at its last row: its lanes' own, each carried
        // down to it
        const int tot = __reduce_max_sync(FULL, T[RPL - 1] + g1 * (31 - lane));
        if (lane == 31) wagg[w & 1][warp] = tot;
      }
      if constexpr (WL == 32) {
        // three rounds: the scan over 4 lanes, over 16, then at the row
        // above the lane's first (the lane's own carry masked out)
        const int a1 = __shfl_up_sync(FULL, carry, 1);
        const int a2 = __shfl_up_sync(FULL, carry, 2);
        const int a3 = __shfl_up_sync(FULL, carry, 3);
        carry = __vimax3_s32(__viaddmax_s32(a1, g1, carry), a2 + 2 * g1,
                             a3 + 3 * g1);
        const int b1 = __shfl_up_sync(FULL, carry, 4);
        const int b2 = __shfl_up_sync(FULL, carry, 8);
        const int b3 = __shfl_up_sync(FULL, carry, 12);
        carry = __vimax3_s32(__viaddmax_s32(b1, 4 * g1, carry), b2 + 8 * g1,
                             b3 + 12 * g1);
        const int e1 = __shfl_up_sync(FULL, carry, 1);
        const int e2 = __shfl_up_sync(FULL, carry, 17);
        E = lane == 0 ? FAR : lane < 17 ? e1 : __viaddmax_s32(e2, 16 * g1, e1);
        // the scan at the lane's last row, for the warps' exchange
        if constexpr (G > 1 && !EARLY_TOTAL)
          carry = __viaddmax_s32(E, g1, T[RPL - 1]);
      } else {
        // log2(WL) rounds of one shuffle
#pragma unroll
        for (int d = 1; d < WL; d <<= 1)
          carry = __viaddmax_s32(__shfl_up_sync(FULL, carry, d), g1 * d, carry);
        // the scan at the row above the lane's first
        E = __shfl_up_sync(FULL, carry, 1);
        if (lane == 0) E = FAR;
      }
      int rinA = 0;  // a warp's lane 0: the R-open bit of the row above
      if constexpr (G > 1) {
        const int par = w & 1;
        if (lane == 31) {
          if constexpr (!EARLY_TOTAL) wagg[par][warp] = carry;
          wdp[par][warp] = D[RPL - 1];
          if constexpr (PROFILE) {
            wt[par][warp] = DO[RPL - 1];
            wcl[par][warp] = CL[RPL - 1];
          }
        }
        pair_sync<G>(pp);  // the warps' scans are visible
        // every lane loads the warps' scans and the row above the warp's
        // first (warp 0: its own last, unused) at once
        const int w0 = warp - wi, above = wi > 0 ? warp - 1 : warp;
        int agg[G];
#pragma unroll
        for (int v = 0; v < G; ++v) agg[v] = wagg[par][w0 + v];
        const int dA = wdp[par][above];
        int cw = FAR;  // the scan at the last row of the warp above
#pragma unroll
        for (int v = 0; v + 1 < G; ++v)
          if (v < wi) cw = __viaddmax_s32(cw, gext * 32 * RPL, agg[v]);
        E = lane == 0 ? cw : __viaddmax_s32(cw, gext * RPL * lane, E);
        // that row's R and final D (the next column's diagonal into the
        // warp's lane 0) and its R-open bit
        const int RA = max(cw, gext * STEP);
        if constexpr (PROFILE) {
          upA = max(dA, right ? RA : sat2(RA + wcl[par][above]));
          rinA = wi > 0 && RA == wt[par][above];
        } else {
          upA = max(dA, RA);
          rinA = wi > 0 && RA == dA + (gopen - gext);
        }
      }
      if constexpr (UP_FROM_SCAN) {
        // the next column's diagonal: the row above's final D, the max of
        // its D before R and its R (the scan E there, or its zero
        // correction)
        upn = __vimax3_s32(dpa, E, gext * (((row0 - 1) & 7) + 1));
      }
      // probe: second pass
      int nib[RPL], rbits = 0;
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        T[k] = __vimax3_s32(T[k], E + gext * (k + 1), zc[k]);  // R
        if constexpr (PROFILE) {
          // a down step closes R before the merge; the bits compare D with
          // the closed C and R
          const int re = right ? T[k] : sat2(T[k] + CL[k]);
          if constexpr (TRACE) {
            const int dn = max(D[k], re);
            nib[k] = (dn == CE[k]) | (dn == re) << 1 | (C[k] == CO[k]) << 2;
            rbits |= (T[k] == DO[k]) << k;
          }
          D[k] = max(D[k], re);
        } else {
          if constexpr (TRACE) {
            // the cell's bits (reference: src/scan_block.rs:1166-1190):
            // D == C, D == R, C == C_open; R == D_open feeds the row below
            const int dn = max(D[k], T[k]);
            nib[k] = (dn == C[k]) | (dn == T[k]) << 1 | (C[k] == CO[k]) << 2;
            rbits |= (T[k] == D[k] + (gopen - gext)) << k;
          }
          D[k] = max(D[k], T[k]);
        }
#if LANE_FLAGS
        if constexpr (TRACE) {
          // local start: the cell restarted at the relative zero
          if (local) zb[k] |= (unsigned)(D[k] == rz) << w;
        }
#endif
        actD[k] = D[k];
        actC[k] = C[k];
      }
      if (on) {
#pragma unroll
        for (int k = 0; k + 1 < RPL; k += 2)
          dmax = __vimax3_s32(dmax, D[k], D[k + 1]);
        if constexpr (RPL % 2 == 1) dmax = max(dmax, D[RPL - 1]);
      }
      if constexpr (TRACE) {
        // bit k: the R bit of the row above row0 + k (0 above row 0)
        const int up_bits = __shfl_up_sync(FULL, rbits, 1);
        const int above =
            rbits << 1 | (lane > 0 ? (up_bits >> (RPL - 1)) & 1 : rinA);
#pragma unroll
        for (int k = 0; k < RPL; ++k)
          wd[k] |= (unsigned)(nib[k] | ((above >> k) & 1) << 3) << (4 * w);
      }
      if (gt == NL - 1) {
        tailD[w] = D[RPL - 1];
        tailR[w] = T[RPL - 1];
      }
      if constexpr (XDROP) {
        // a row reaching its running max again takes this column
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          if (D[k] >= vm[k]) {
            vm[k] = D[k];
            vj[k] = cpos0 + w;
          }
        }
#if LANE_FLAGS
      } else if (fend) {
        // free end gaps: the column's key of residue qlen % 16, 2 D + (the
        // row's chunk reaches past qlen), into the running max; the column
        // is the best's when a row past qlen holds the new max
        int v = D[0];
#pragma unroll
        for (int k = 1; k < RPL; ++k)
          if (opaque(k) == fidx) v = D[k];
        const int key = __reduce_max_sync(
            FULL, fhas ? 2 * v + (lstart + 16 * fchunk + 16 > ql) : INT_MIN_);
        if constexpr (G == 1) {
          if ((key >> 1) >= fvm && (key & 1)) fj = cpos0 + w;
          fvm = max(fvm, key >> 1);
        } else if (lane == 0) {
          fkeys[w][warp] = key;  // folded at the step's end
        }
#endif
      } else {
        // freeze: the block covering (qlen, rlen) reached the last column
        const int wloc = in_pro ? s * STEP + w : w;
        if (fra && wloc >= frt) {
          const int src = fridx / RPL, idx = fridx - src * RPL;
          int v = D[0];
#pragma unroll
          for (int k = 1; k < RPL; ++k)
            if (k == idx) v = D[k];
          if constexpr (G == 1)
            score = off + __shfl_sync(FULL, v, src) - ZERO;
          else if (gt == src)
            fscore[pp] = off + v - ZERO;
          done = true;
          break;
        }
      }
    }
    // probe: step end
#if LANE_FLAGS
    if constexpr (TRACE) {
      if (on) {
        // local start: the zero bits follow the step's S words
        const int tw = local ? 2 : 1;
        int* dst = twords + ((size_t)s * B + b) * S * tw + row0;
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          dst[k] = (int)wd[k];
          if (local) dst[S + k] = (int)zb[k];
        }
      }
    }
#else
    if constexpr (TRACE) {
      if (on) {
        int* dst = twords + ((size_t)s * B + b) * S + row0;
        if constexpr (RPL % 4 == 0) {
#pragma unroll
          for (int k = 0; k < RPL; k += 4)
            *reinterpret_cast<int4*>(dst + k) =
                make_int4((int)wd[k], (int)wd[k + 1], (int)wd[k + 2],
                          (int)wd[k + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < RPL; ++k) dst[k] = (int)wd[k];
        }
      }
    }
#endif
    if (done) break;
    const bool decide = s >= PRO - 1;
    const bool shift = s >= PRO;  // a decided step after the prologue's last
    if (shift) {
      // the passive border's rebase; several warps post their first 8 rows
      // for the warp above; then row r <- row r + 8 inside the warp (its
      // last 8 rows come after the barrier); the pre-splice row 7 is the
      // next step's corner (each warp's own row 7: its lane 0's diagonal if
      // the borders swap)
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        pasD[k] = sat2(pasD[k] + oa);
        pasR[k] = sat2(pasR[k] + oa);
      }
      if constexpr (G > 1) {
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          if (lane * RPL + k < STEP) {
            wfirst[warp][0][lane * RPL + k] = pasD[k];
            wfirst[warp][1][lane * RPL + k] = pasR[k];
          }
        }
      }
      corn = __shfl_sync(FULL, pasD[7 % RPL], 7 / RPL);
      shift_rows<RPL>(pasD);
      shift_rows<RPL>(pasR);
    }
    if constexpr (G > 1) {
      if (decide) {
        // each warp's part of the decision: its maximum, (warp 0) the first
        // 8 rows of both borders, its x-drop key
        const int wmax = __reduce_max_sync(FULL, dmax);
        if (lane == 0) wred[warp][0] = wmax;
        if (wi == 0) {
          int ah = INT_MIN_, ph = INT_MIN_;
#pragma unroll
          for (int k = 0; k < RPL; ++k) {
            if (row0 + k < STEP) {
              ah = max(ah, actD[k]);
              ph = max(ph, pasD[k]);
            }
          }
          ah = __reduce_max_sync(FULL, ah);
          ph = __reduce_max_sync(FULL, ph);
          if (lane == 0) {
            wred[warp][1] = ah;
            wred[warp][2] = ph;
          }
        }
        if constexpr (XDROP) {
          const int key = __reduce_max_sync(
              FULL, xkey<RPL>(vm, vj, wmax, row0, in_pro ? 0 : cpos0, on));
          if (lane == 0) wred[warp][3] = key;
        }
      }
      // the row handed down when the prologue's borders swap
      if (lane == 31 && s == PRO - 1) wlast[warp] = pasD[RPL - 1];
    }
    pair_sync<G>(pp);  // the step's tail cells (and the warps' parts) are in

    if (shift) {
      // the warp's last 8 rows: the next warp's first, or the bottom cells
      const bool last = G == 1 || wi == G - 1;
      fill_rows<WL, RPL>(pasD, last ? tailD : wfirst[warp + 1][0], lane);
      fill_rows<WL, RPL>(pasR, last ? tailR : wfirst[warp + 1][1], lane);
    }
    if (in_pro) {
      // the prologue's bottom cells fill passive rows 8s..8s+7
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int row = row0 + k;
        if ((row >> 3) == s) {
          pasD[k] = tailD[row & 7];
          pasR[k] = tailR[row & 7];
        }
      }
    }
#if LANE_FLAGS
    if constexpr (G > 1 && !XDROP) {
      if (fend) {
        // the step's columns' keys over the pair's warps, in column order
#pragma unroll 1
        for (int w = 0; w < STEP; ++w) {
          int key = INT_MIN_;
#pragma unroll
          for (int v = 0; v < G; ++v) key = max(key, fkeys[w][warp - wi + v]);
          if ((key >> 1) >= fvm && (key & 1)) fj = cpos0 + w;
          fvm = max(fvm, key >> 1);
        }
      }
    }
#endif
    if (decide) {
      int cur, ah = INT_MIN_, ph = INT_MIN_;
      if constexpr (G == 1) {
#if LANE_FLAGS
        // free end gaps: the rebase and the y-drop counter follow row
        // qlen's residue
        cur = fend ? fvm : __reduce_max_sync(FULL, dmax);
#else
        cur = __reduce_max_sync(FULL, dmax);
#endif
        // the first 8 rows of both borders, for the direction
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          if (row0 + k < STEP) {
            ah = max(ah, actD[k]);
            ph = max(ph, pasD[k]);
          }
        }
        ah = __reduce_max_sync(FULL, ah);
        ph = __reduce_max_sync(FULL, ph);
      } else {
        cur = INT_MIN_;
#pragma unroll
        for (int v = 0; v < G; ++v) cur = max(cur, wred[warp - wi + v][0]);
#if LANE_FLAGS
        if (fend) cur = fvm;
#endif
        ah = wred[warp - wi][1];
        ph = wred[warp - wi][2];
      }
      const int off_max = off + cur - ZERO;
      dmax = INT_MIN_;
      offmax = off_max;
      // y-drop stall tracking (reference: src/scan_block.rs:470-487)
      const int y_iter = off_max > ybest ? 0 : yiter + 1;
      ybest = max(ybest, off_max);
      yiter = y_iter;
#if LANE_FLAGS
      if (fend) {
        // the best of row qlen, at its residue's column; the end: both
        // ends covered
        if (off_max > xbest) {
          xbest = off_max;
          xbi = ql;
          xbj = fj;
        }
        fvm = NEG;
        if (I + S > ql && J + S > rl) {
          done = true;
          break;
        }
      }
#endif
      if constexpr (XDROP) {
        if (off_max > xbest) {
          // the new best's position: the lowest residue holding the
          // step's max, then the latest column and the highest chunk
          // reaching it (reference: src/avx2.rs:269-274)
          const int base = in_pro ? 0 : cpos0;
          int key = -1;
          if constexpr (G == 1) {
            key = __reduce_max_sync(FULL,
                                    xkey<RPL>(vm, vj, cur, row0, base, on));
          } else {
#pragma unroll
            for (int v = 0; v < G; ++v)
              if (wred[warp - wi + v][0] == cur)
                key = max(key, wred[warp - wi + v][3]);
          }
          const int bi = lstart + 16 * (key & 31) + 15 - (key >> 14);
          const int bj = base + ((key >> 5) & 511);
          xbest = off_max;
          xbi = dir != 1 ? bi : bj;
          xbj = dir != 1 ? bj : bi;
        }
#pragma unroll
        for (int k = 0; k < RPL; ++k) vm[k] = NEG;
        // the end: the max fell more than x below the best at two
        // decisions in a row (X_DROP_ITER = 2), or the block covers both
        // ends (reference: src/scan_block.rs:353-404, 434-445)
        const bool xfail = off_max < xbest - xdrop;
        const bool stop = xfail && xiter >= 1;
        xiter = xfail ? xiter + 1 : 0;
        if (stop || (I + S > ql && J + S > rl)) {
          done = true;
          break;
        }
      }
      // direction from the first 8 rows of both borders
      const bool right_now = dir != 1;
      const int right_max = right_now ? ah : ph;
      const int down_max = right_now ? ph : ah;
      const bool forced_down = J + S > rl;
      const bool forced_right = !forced_down && I + S > ql;
      const bool free_step = !forced_down && !forced_right;
      // the grow trigger is only reachable on free steps
      if (free_step && y_iter > PRO - 1) susp = 1;
      const bool godown = forced_down || (free_step && down_max > right_max);
      pdir = dir;
      if (godown) I += STEP; else J += STEP;
      const int new_dir = godown ? 1 : 0;
      if ((dir != 1) != (new_dir != 1)) {
        // the lane axis flipped: the borders trade roles
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          const int d = actD[k], c = actC[k];
          actD[k] = pasD[k];
          actC[k] = pasR[k];
          pasD[k] = d;
          pasR[k] = c;
        }
        // the row above a warp's first: the new active border's
        if constexpr (G > 1)
          if (wi > 0) upA = shift ? corn : wlast[warp - 1];
      }
      dir = new_dir;
    }
    if constexpr (G == 1)
      __syncwarp();  // tail cells read before the next step writes them
  }
  if constexpr (G > 1 && !XDROP) {
    if (done) {
      pair_sync<G>(pp);  // the frozen cell's score is in
      score = fscore[pp];
    }
  }
  // probe: pair end
  if (gt == 0) {
    if constexpr (TRACE) tsteps[b] = nsteps;
    if constexpr (XDROP) {
      out[4 * b] = xbest;
      out[4 * b + 1] = xbi;
      out[4 * b + 2] = xbj;
      out[4 * b + 3] = susp;
#if LANE_FLAGS
    } else if (fend) {
      out[4 * b] = xbest;
      out[4 * b + 1] = xbi;
      out[4 * b + 2] = xbj;
      out[4 * b + 3] = susp;
#endif
    } else {
      out[2 * b] = score;
      out[2 * b + 1] = susp;
    }
  }
}

// The instance of block S and G warps a pair, x-drop or global, traced or
// not.
template <int S, int G>
auto instance(bool xdrop, bool trace) {
  constexpr bool P = LANE_PROFILE;
  return trace ? (xdrop ? lane_align_kernel<S, G, true, true, P>
                        : lane_align_kernel<S, G, false, true, P>)
               : (xdrop ? lane_align_kernel<S, G, true, false, P>
                        : lane_align_kernel<S, G, false, false, P>);
}

// The SMs of the current device (1 if it cannot say).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return n;
}

// The warps a pair takes in a launch of B pairs at block S.
template <int S>
int launch_warps(int B) {
  return B <= FEW_PAIRS * sm_count() ? WIDE_WARPS<S> : NARROW_WARPS<S>;
}

template <int S, int G>
cudaError_t launch_g(const uint8_t* codes, const int* qlen, const int* rlen,
                     const int* table, int* out, int* twords, int4* tdesc,
                     int* tsteps, int B, int cap, int alpha, int max_steps,
                     int gopen, int gext, int xdrop, int flags, int bmatch,
                     int bmismatch, cudaStream_t stream) {
  const unsigned grid = (unsigned)((B + BLOCK_PAIRS<G> - 1) / BLOCK_PAIRS<G>);
  const int threads = BLOCK_THREADS<G>;
  auto kernel = instance<S, G>(xdrop >= 0, twords != nullptr);
  kernel<<<grid, threads, 0, stream>>>(
      codes, qlen, rlen, table, out, twords, tdesc, tsteps, B, cap, alpha,
      max_steps, gopen, gext, xdrop LANE_MODE_ARGS);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch(const uint8_t* codes, const int* qlen, const int* rlen,
                   const int* table, int* out, int* twords, int4* tdesc,
                   int* tsteps, int B, int cap, int alpha, int max_steps,
                   int gopen, int gext, int xdrop, int flags, int bmatch,
                   int bmismatch, cudaStream_t stream) {
  if constexpr (WIDE_WARPS<S> != NARROW_WARPS<S>) {
    if (launch_warps<S>(B) == WIDE_WARPS<S>)
      return launch_g<S, WIDE_WARPS<S>>(
          codes, qlen, rlen, table, out, twords, tdesc, tsteps, B, cap, alpha,
          max_steps, gopen, gext, xdrop, flags, bmatch, bmismatch, stream);
  }
  return launch_g<S, NARROW_WARPS<S>>(
      codes, qlen, rlen, table, out, twords, tdesc, tsteps, B, cap, alpha,
      max_steps, gopen, gext, xdrop, flags, bmatch, bmismatch, stream);
}

// A launch's shape (lane_launch_shape) at block S and G warps a pair.
template <int S, int G>
cudaError_t shape_g(bool xdrop, bool trace, int* got) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, instance<S, G>(xdrop, trace), BLOCK_THREADS<G>, 0);
  got[0] = BLOCK_THREADS<G>;
  got[1] = blocks;
  got[2] = G;
  got[3] = BLOCK_PAIRS<G>;
  got[4] = blocks * BLOCK_PAIRS<G>;
  return err;
}

template <int S>
cudaError_t shape_of(int B, bool xdrop, bool trace, int* got) {
  if constexpr (WIDE_WARPS<S> != NARROW_WARPS<S>) {
    if (launch_warps<S>(B) == WIDE_WARPS<S>)
      return shape_g<S, WIDE_WARPS<S>>(xdrop, trace, got);
  }
  return shape_g<S, NARROW_WARPS<S>>(xdrop, trace, got);
}

}  // namespace

// codes (B, 2, cap) uint8, qlen/rlen (B,) int32, table (alpha, alpha) int32;
// in the profile library (csrc/lane_profile.cu) codes (B, cap) uint8 are the
// queries' codes, table (B, cap, 8) int32 the profiles' words, rlen the
// profiles' lengths, and alpha and gopen are not read.
// x_drop < 0: global mode, out (B, 2) int32 = (score, suspect); else x-drop
// with x = x_drop, out (B, 4) int32 = (best, query pos, reference pos,
// suspect).  Trace mode when `words` is not null: words (max_steps, B,
// block) int32 (block * 2 with local start), desc (max_steps, B, 4) int32
// and steps (B,) int32 receive the trace of core/traceback.py; rows of
// steps a pair did not execute are left as they were.  `flags` (only in
// the libraries of csrc/*_flags.cu; 0 elsewhere) ors local start 1, free
// query start gaps 2, free query end gaps 4 (out (B, 4) as in x-drop, no
// x-drop) and byte mode 8 (codes are raw bytes, alpha 256, table not read,
// match and mismatch scores `match` / `mismatch`; no x-drop, no profile).
// The gap costs gopen and gext must be <= 0: the kernel's gap adds clamp at
// the lower rail only.  A pair takes launch_warps<block>(B) warps
// (lane_launch_shape).  Returns the launch's cudaError_t.
extern "C" int lane_align_launch(const void* codes, const void* qlen,
                                 const void* rlen, const void* table,
                                 void* out, void* words, void* desc,
                                 void* steps, int B, int cap, int alpha,
                                 int block, int max_steps, int gopen,
                                 int gext, int x_drop, int flags, int match,
                                 int mismatch, void* stream) {
  const bool byte = flags & BYTE_MODE;
  if (B < 1 || cap < 1 || alpha < 1 ||
      (byte ? alpha != 256 : alpha > MAX_ALPHA) ||
      (words && (!desc || !steps)) || (flags & ~15) ||
      (flags && !LANE_FLAGS) ||
      ((flags & LOCAL_START) && (flags & FREE_START)) ||
      ((flags & FREE_END) && x_drop >= 0) ||
      (byte && (x_drop >= 0 || LANE_PROFILE)) || gext > 0 ||
      (!LANE_PROFILE && gopen > 0))
    return (int)cudaErrorInvalidValue;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* q = static_cast<const int*>(qlen);
  const auto* r = static_cast<const int*>(rlen);
  const auto* t = static_cast<const int*>(table);
  auto* o = static_cast<int*>(out);
  auto* tw = static_cast<int*>(words);
  auto* td = static_cast<int4*>(desc);
  auto* ts = static_cast<int*>(steps);
  auto st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 16: return (int)launch<16>(c, q, r, t, o, tw, td, ts, B, cap, alpha, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    case 32: return (int)launch<32>(c, q, r, t, o, tw, td, ts, B, cap, alpha, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    case 64: return (int)launch<64>(c, q, r, t, o, tw, td, ts, B, cap, alpha, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    case 128: return (int)launch<128>(c, q, r, t, o, tw, td, ts, B, cap, alpha, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    case 256: return (int)launch<256>(c, q, r, t, o, tw, td, ts, B, cap, alpha, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    case 512: return (int)launch<512>(c, q, r, t, o, tw, td, ts, B, cap, alpha, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch shape of a launch of B pairs at block `block` (x-drop if
// `x_drop`, traced if `trace`) on the current device: shape[0] threads a
// block, shape[1] blocks resident on an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), shape[2] warps a pair,
// shape[3] pairs a block, shape[4] pairs an SM.  Returns the query's
// cudaError_t.
extern "C" int lane_launch_shape(int block, int B, int x_drop, int trace,
                                 int* shape) {
  const bool x = x_drop, tr = trace;
  switch (block) {
    case 16: return (int)shape_of<16>(B, x, tr, shape);
    case 32: return (int)shape_of<32>(B, x, tr, shape);
    case 64: return (int)shape_of<64>(B, x, tr, shape);
    case 128: return (int)shape_of<128>(B, x, tr, shape);
    case 256: return (int)shape_of<256>(B, x, tr, shape);
    case 512: return (int)shape_of<512>(B, x, tr, shape);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* lane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
