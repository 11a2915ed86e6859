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
// What the design does about it:
// * one warp per pair, and each pair runs its own step loop and leaves as
//   soon as its block freezes, so no pair waits for the longest one in a
//   batch (the TPU kernel ran 128-pair lanes in lockstep);
// * the S block rows sit in registers, S/32 contiguous rows per lane
//   (S = 16 leaves half the warp idle), so the D00 diagonal shift is one
//   shuffle per column and the prefix scan is serial inside a lane plus
//   log2(lanes) shuffles across lanes;
// * the score table sits in shared memory and each lane looks up
//   table[column code][own row code] directly, which replaces the TPU's
//   packed score stacks and one-hot matrix products;
// * many warps per SM hide the chain's latency: a warp's registers are
//   its only state, so occupancy is set by registers alone.
// X-drop is a template flag, so the global instances keep their code and
// registers and the x-drop ones have no freeze.  The 16-residue tracker
// (running max per residue class row % 16, reached last at the highest
// 16-row chunk and the latest column) is kept per lane: a lane's rows lie
// in one chunk, so each of its rows keeps its own running max and the
// latest column that reached it, with no shuffle per column.  At a
// decision the warp takes the max over lanes, then the latest column among
// the lanes that reached it, then the highest chunk among those.  That is
// the per-column rule of the JAX kernel: a running max only grows, so the
// last column where the whole tracker is raised or reached again is the
// last column where some lane reached the final max, and the lanes that
// reached it there are exactly those whose own latest column it is.
// Trace is a template flag too.  Each lane ORs a cell's 4 bits into one
// word per row it holds, column w at bits 4w..4w+3, and stores its words
// once per step (S/32 contiguous rows per lane, so the warp's stores
// coalesce); lane 0 stores the step's descriptor.  The R bit of a row is
// the row above's R == D_open, one shuffle of the lane's packed bits per
// column.  A freezing step stores the columns computed before it leaves.
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
// run-time argument (a branch the whole warp takes alike), so that four
// instances per size serve all of them.  Byte mode compares the lane's byte with the entering one in
// place of the table fetch (no table is loaded; the codes are raw bytes,
// alpha 256).  Local start raises each cell's D to the relative zero
// clip(ZERO - off) before the merges; free start gaps set row 0 of a right
// block whose lanes start at query row 0 to it.  In trace mode local start
// adds one word per row and step after the S words of the 4-bit cells,
// bit w the cell of column w whose D equals the relative zero.  Free end
// gaps (query shorter than S) replace the freeze by the x-drop tracker cut
// down to the residue qlen % 16: each column the warp takes the max of that
// residue's rows into its running max, and the column becomes the best's
// when a row of a chunk reaching past qlen equals it; the running max
// drives the offset and the y-drop counter, the best is kept at each
// decision, and a pair ends once its block covers both ends.
// i16x2 packing, DPX instructions and several pairs per warp are left to
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STEP = 8;             // columns per step
constexpr int ZERO = 1 << 14;       // score bias
constexpr int NEG = -32768;         // the i16 rails
constexpr int POS = 32767;
constexpr int INT_MIN_ = -2147483647 - 1;
constexpr int MAX_ALPHA = 32;
constexpr int WARPS = 4;            // pairs per thread block
constexpr unsigned FULL = 0xffffffffu;
// profile words per position: 7 score words (4 biased bytes each, query
// codes 0..27), then the gap word open_C | open_R << 8 | close_C << 16
constexpr int PROF_WORDS = 8;
// the run-time modes of the FLAGS instances (the `flags` argument)
constexpr int LOCAL_START = 1, FREE_START = 2, FREE_END = 4, BYTE_MODE = 8;

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

// i16 saturation at both rails, as the reference's adds (the upper one
// is reached where a block's columns run far without a rebase)
__device__ __forceinline__ int sat(int x) { return min(max(x, NEG), POS); }

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

// Passive border shift: row r <- row r + 8, rows S-8..S-1 <- tail.
template <int NL, int RPL>
__device__ __forceinline__ void shift_tail(int (&x)[RPL], const int* tail,
                                           int lane) {
  if constexpr (RPL >= STEP) {
    int nx[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      if (k + STEP < RPL) {
        nx[k] = x[k + STEP];
      } else {
        const int v = __shfl_down_sync(FULL, x[k + STEP - RPL], 1);
        nx[k] = lane == NL - 1 ? tail[k + STEP - RPL] : v;
      }
    }
#pragma unroll
    for (int k = 0; k < RPL; ++k) x[k] = nx[k];
  } else {
    constexpr int D = STEP / RPL;  // lanes per 8 rows
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int v = __shfl_down_sync(FULL, x[k], D);
      x[k] = (lane >= NL - D && lane < NL) ? tail[(lane - (NL - D)) * RPL + k]
                                           : v;
    }
  }
}

template <int S, bool XDROP, bool TRACE, bool PROFILE>
__global__ void __launch_bounds__(WARPS * 32)
lane_align_kernel(const uint8_t* __restrict__ codes,
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
  constexpr int NL = S < 32 ? S : 32;  // lanes holding block rows
  constexpr int RPL = S / NL;          // rows per lane, contiguous
  constexpr int PRO = S / STEP;        // prologue steps (the initial grow)

  __shared__ int tab[PROFILE ? 1 : MAX_ALPHA * MAX_ALPHA];
  __shared__ int tails[WARPS][2][STEP];  // a step's bottom D and R cells
  // profile: the profile rows of a right step's 8 entering columns
  __shared__ int prows[WARPS][PROFILE ? STEP * PROF_WORDS : 1];

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
  if constexpr (!PROFILE) {
    for (int k = threadIdx.x; k < alpha * alpha; k += blockDim.x)
      tab[k] = table[k];
    __syncthreads();
  }
#endif

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  int* tailD = tails[warp][0];
  int* tailR = tails[warp][1];
  int* prow = prows[warp];
  const bool on = lane < NL;
  const int row0 = lane * RPL;
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

  int I = 0, J = 0, off = 0, offmax = 0, dir = 2, pdir = 2, corn = NEG;
  int ybest = -(1 << 30), yiter = 0, susp = 0, score = 0;
  int dmax = INT_MIN_;
  bool done = false;
  // freeze predicate of the current block (prologue: lanes = query)
  bool fra = S > ql;
  int frt = rl, fridx = min(max(ql, 0), S - 1);
  int nsteps = 0;  // trace: the steps this pair executed
#if LANE_FLAGS
  // free end gaps: this lane's row of residue qlen % 16 (if it holds one:
  // its rows lie in one 16-row chunk), that row's chunk, the residue's
  // running max and the column of the best
  const int fidx = ((ql & 15) - row0) & 15;
  const bool fhas = on && fidx < RPL;
  const int fchunk = (row0 + fidx) >> 4;
  int fvm = NEG, fj = 0;
#endif

  for (int s = 0; s < max_steps && !done; ++s) {
    const bool in_pro = s < PRO;
    int oa = 0, cvec = NEG, lstart = 0, cpos0 = s * STEP;
    const uint8_t* lseq = qs;
    const uint8_t* cseq = rs;
#if LANE_FLAGS
    int rz = ZERO;  // the relative zero of local start and free start gaps
#endif
    if (!in_pro) {
      // offset rebase (reference: src/scan_block.rs:148-151)
      oa = min(max(off - offmax, NEG), 32767);
      off = offmax;
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        actD[k] = sat(actD[k] + oa);
        actC[k] = sat(actC[k] + oa);
      }
      const bool flip = (dir == 0 && pdir == 1) || (dir == 1 && pdir == 0);
      cvec = flip ? sat(corn + oa) : NEG;
      const bool right = dir != 1;
      lstart = right ? I : J;
      cpos0 = (right ? J : I) + S - STEP;
      const int lane_len = right ? ql : rl, col_len = right ? rl : ql;
      fra = lstart + S > lane_len;
      frt = col_len - cpos0;
      fridx = min(max(lane_len - lstart, 0), S - 1);
      lseq = right ? qs : rs;
      cseq = right ? rs : qs;
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
      if (lane == 0)
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
    int lc[RPL], cc[STEP];
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
        for (int i = lane; i < STEP * PROF_WORDS; i += 32)
          prow[i] = pw[(size_t)min(cpos0 + i / PROF_WORDS, cap - 1) *
                           PROF_WORDS + i % PROF_WORDS];
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        lc[k] = on ? min((int)lseq[min(lstart + row0 + k, cap - 1)], alpha - 1)
                   : 0;
#pragma unroll
      for (int w = 0; w < STEP; ++w)
        cc[w] = min((int)cseq[min(cpos0 + w, cap - 1)], alpha - 1);
    }

#pragma unroll
    for (int w = 0; w < STEP; ++w) {
      const int* trow = tab + cc[w] * alpha;
      int up = __shfl_up_sync(FULL, actD[RPL - 1], 1);
      if (lane == 0) up = w == 0 ? cvec : NEG;
      int D[RPL], C[RPL], T[RPL], CO[RPL];
      int DO[RPL], CL[RPL], CE[RPL];  // profile: D_open, close, closed C
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        if constexpr (PROFILE) {
          // a right step's lane reads the entering row by its own code, a
          // down step's the row of its own position by the entering code
          const int* row = right ? prow + w * PROF_WORDS
                                 : pw + (size_t)lc[k] * PROF_WORDS;
          int d = sat((k == 0 ? up : actD[k - 1]) +
                      prof_score(row, right ? lc[k] : cc[w]));
          if (k == 0 && w == 0 && s == 0 && lane == 0) d = ZERO;  // origin
#if LANE_FLAGS
          if (local) d = max(d, rz);
          else if (ins0 && k == 0 && lane == 0) d = rz;
#endif
          const ProfGaps g(row[PROF_WORDS - 1], right, gext);
          const int co = sat(actD[k] + g.copen);
          DO[k] = g.dopen;
          CL[k] = g.close;
          C[k] = max(sat(actC[k] + gext), co);
          // a right step closes C before the merge; C stays pre-close
          CE[k] = right ? sat(C[k] + g.close) : C[k];
          D[k] = max(d, CE[k]);
          if constexpr (TRACE) CO[k] = co;
        } else {
#if LANE_FLAGS
          // byte mode compares the codes; the flags restart cells at the
          // relative zero
          int d = sat((k == 0 ? up : actD[k - 1]) +
                      (byte ? (lc[k] == cc[w] ? bmatch : bmismatch)
                            : trow[lc[k]]));
          if (k == 0 && w == 0 && s == 0 && lane == 0) d = ZERO;  // DP origin
          if (local) d = max(d, rz);
          else if (ins0 && k == 0 && lane == 0) d = rz;
#else
          int d = sat((k == 0 ? up : actD[k - 1]) + trow[lc[k]]);
          if (k == 0 && w == 0 && s == 0 && lane == 0) d = ZERO;  // DP origin
#endif
          const int co = sat(actD[k] + gopen);
          C[k] = max(sat(actC[k] + gext), co);
          D[k] = max(d, C[k]);
          if constexpr (TRACE) CO[k] = co;
        }
      }
      // max-plus prefix scan of D + (open - extend) down the block (profile:
      // of D plus the cell's R open): serial inside the lane, log-step
      // across lanes, then the zero correction
      if constexpr (PROFILE) {
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          DO[k] = sat(D[k] + DO[k]);
          T[k] = k == 0 ? DO[k] : max(DO[k], T[k - 1] + gext);
        }
      } else {
        T[0] = D[0] + (gopen - gext);
#pragma unroll
        for (int k = 1; k < RPL; ++k)
          T[k] = max(D[k] + (gopen - gext), T[k - 1] + gext);
      }
      int carry = T[RPL - 1];
#pragma unroll
      for (int d = 1; d < NL; d <<= 1) {
        const int o = __shfl_up_sync(FULL, carry, d);
        if (lane >= d) carry = max(carry, o + gext * RPL * d);
      }
      const int prev = __shfl_up_sync(FULL, carry, 1);
      int nib[RPL], rbits = 0;
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int t = lane > 0 ? max(T[k], prev + gext * (k + 1)) : T[k];
        T[k] = max(t, zc[k]);  // R
        if constexpr (PROFILE) {
          // a down step closes R before the merge; the bits compare D with
          // the closed C and R
          const int re = right ? T[k] : sat(T[k] + CL[k]);
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
        if (on) dmax = max(dmax, D[k]);
      }
      if constexpr (TRACE) {
        // bit k: the R bit of the row above row0 + k (0 above row 0)
        const int up_bits = __shfl_up_sync(FULL, rbits, 1);
        const int above =
            rbits << 1 | (lane > 0 ? (up_bits >> (RPL - 1)) & 1 : 0);
#pragma unroll
        for (int k = 0; k < RPL; ++k)
          wd[k] |= (unsigned)(nib[k] | ((above >> k) & 1) << 3) << (4 * w);
      }
      if (lane == NL - 1) {
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
        // free end gaps: residue qlen % 16's max into its running max; the
        // column is the best's when a row of a chunk reaching past qlen
        // equals it
        int v = D[0];
#pragma unroll
        for (int k = 1; k < RPL; ++k)
          if (opaque(k) == fidx) v = D[k];
        fvm = max(fvm, __reduce_max_sync(FULL, fhas ? v : INT_MIN_));
        if (__any_sync(FULL, fhas && v == fvm &&
                                 lstart + 16 * fchunk + 16 > ql))
          fj = cpos0 + w;
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
          score = off + __shfl_sync(FULL, v, src) - ZERO;
          done = true;
          break;
        }
      }
    }
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
    __syncwarp();  // the step's tail cells are visible to the warp

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
    if (s >= PRO - 1) {
      if (s != PRO - 1) {
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          pasD[k] = sat(pasD[k] + oa);
          pasR[k] = sat(pasR[k] + oa);
        }
        // the pre-splice row 7 is the next step's corner
        corn = __shfl_sync(FULL, pasD[7 % RPL], 7 / RPL);
        shift_tail<NL, RPL>(pasD, tailD, lane);
        shift_tail<NL, RPL>(pasR, tailR, lane);
      }
#if LANE_FLAGS
      // free end gaps: the rebase and the y-drop counter follow row qlen's
      // residue
      const int cur = fend ? fvm : __reduce_max_sync(FULL, dmax);
#else
      const int cur = __reduce_max_sync(FULL, dmax);
#endif
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
          int rlow = 16;
#pragma unroll
          for (int k = 0; k < RPL; ++k)
            if (on && vm[k] == cur) rlow = min(rlow, (row0 + k) & 15);
          const int r = __reduce_min_sync(FULL, rlow);
          int col = INT_MIN_;
#pragma unroll
          for (int k = 0; k < RPL; ++k)
            if (on && ((row0 + opaque(k)) & 15) == r && vm[k] == cur)
              col = vj[k];
          const int bj = __reduce_max_sync(FULL, col);
          const int ch = __reduce_max_sync(FULL, col == bj ? row0 >> 4 : -1);
          const int bi = lstart + 16 * ch + r;
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
      }
      dir = new_dir;
    }
    __syncwarp();  // tail cells read before the next step writes them
  }
  if (lane == 0) {
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

template <int S>
cudaError_t launch(const uint8_t* codes, const int* qlen, const int* rlen,
                   const int* table, int* out, int* twords, int4* tdesc,
                   int* tsteps, int B, int cap, int alpha, int max_steps,
                   int gopen, int gext, int xdrop, int flags, int bmatch,
                   int bmismatch, cudaStream_t stream) {
  constexpr bool P = LANE_PROFILE;
  const unsigned grid = (unsigned)((B + WARPS - 1) / WARPS);
  auto kernel = twords ? (xdrop < 0 ? lane_align_kernel<S, false, true, P>
                                    : lane_align_kernel<S, true, true, P>)
                       : (xdrop < 0 ? lane_align_kernel<S, false, false, P>
                                    : lane_align_kernel<S, true, false, P>);
  kernel<<<grid, WARPS * 32, 0, stream>>>(
      codes, qlen, rlen, table, out, twords, tdesc, tsteps, B, cap, alpha,
      max_steps, gopen, gext, xdrop LANE_MODE_ARGS);
  return cudaGetLastError();
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
// Returns the launch's cudaError_t.
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
      (byte && (x_drop >= 0 || LANE_PROFILE)))
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

extern "C" const char* lane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
