// Adaptive-block alignment of a batch of sequence pairs, or of (query,
// profile) pairs, global or x-drop, with or without trace, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// ops/adaptive_kernel.py; the profile instances build apart from
// csrc/adaptive_profile.cu, and the instances that read the flags and byte
// mode from csrc/adaptive_flags.cu and csrc/adaptive_profile_flags.cu.
//
// Replaces: block_aligner_tpu/ops/adaptive_kernel.py::build_adaptive_engine
// (its Pallas `kernel`) in global and in x-drop mode, with and without
// trace, with a score table, byte equality or a profile, with or without
// the local-start and free-gap flags: the grow / shrink / checkpoint
// machine for min_size < max_size <= 256, and <= 512 with trace or a
// profile.  It computes the same score (x-drop: the best
// score and its position) and the same step-cap overrun flag, bit for bit,
// and in trace mode the traceback bits of every cell it computes, the rect
// of every step and the checkpoint events; the machine is described in
// ops/adaptive_kernel.py, whose adaptive_align_plain is the plain PyTorch
// version of this kernel, and the trace layout in core/traceback.py.
//
// What bounds it: integer ALU work (a handful of adds and maxes per DP
// cell) and, above all, latency: each of a rect's 8 columns per step
// depends on the one before, each column carries a max-plus prefix scan
// down the block (a chain of dependent warp shuffles), and each step's
// decision (shift, grow, shrink) depends on the last column.  Bytes are not
// the limit: a pair reads its codes once per step and writes 8 bytes.
//
// What the design does about it:
// * one warp per pair, and each pair runs its own step loop and leaves as
//   soon as it freezes (the TPU kernel ran 128-pair lanes in lockstep until
//   the slowest pair of a bank finished);
// * the per-column work tracks the current block size: rows are
//   interleaved across the 32 lanes (row r in lane r % 32 of register slot
//   r / 32, S/32 slots for the largest size S), and a step of a block of
//   size sz computes only its ceil(sz/32) slots, a template parameter of
//   the step, so no loop over slots has a run-time bound.  Rows at or past
//   the rect height never feed the rows below it (the diagonal and the
//   prefix scan move rows upward, a shrink moves rows down from below sz),
//   so slots past sz are left stale; the plain version computes them at
//   the full width, as the JAX kernel does, and the two must still agree.
//   A slot's prefix scan is log2(32) shuffles, and the slots chain their
//   carries;
// * scores come from the 32x32 table in shared memory, indexed by the
//   column code and each lane's own row code re-read at the rect's lane
//   start (one coalesced load per slot), so a checkpoint restore only
//   moves the anchor; the TPU's packed score stacks and their rebuild on
//   every restore do not exist here;
// * the four checkpoint border planes live in shared memory (4 KB per warp
//   at S = 256), each lane keeping its own rows, so saves and restores are
//   conflict-free and cost no registers; registers set occupancy.
// * x-drop is a template flag, so the global instances keep their code and
//   registers and the x-drop ones have no freeze.  Row k * 32 + lane has
//   residue lane % 16 and chunk 2k + lane / 16, so the 16-residue tracker
//   (running max per residue class, reached last at the highest chunk and
//   the latest column) is three registers per lane, the same in lanes l and
//   l ^ 16: each column folds a lane's rows into one key, value * 16 +
//   chunk (value * 32 + chunk at S = 512), whose max over the lane and its
//   partner (one shuffle) is the column's max and the highest chunk
//   holding it.
// * trace is a third template flag.  Each lane ORs a cell's 4 bits into one
//   word per slot, column w at bits 4w..4w+3, and the warp stores the
//   current size's slots once per step (32 contiguous rows per slot); the
//   R bit of row r is row r - 1's R == D_open, one shuffle of the lane's
//   packed slot bits per column.  Lane 0 stores the step's descriptor, with
//   the checkpoint saves and restores the previous step decided.  A
//   freezing step stores the columns computed before it leaves.  The S =
//   512 instance exists with trace only: without it, max_size 512 takes
//   the big kernel's route.
// * profile mode (sequence-to-PSSM) is a fourth flag, as in the lane
//   kernel (csrc/lane_kernel.cu): a right rect stages its 8 entering
//   profile rows in shared memory, a down rect's lane reads its own
//   position's row; lanes find their positions from the rect's anchor, so
//   a restore still only moves the anchor.  Profiles take max_size 512
//   in every mode.
// * ByteMatrix scoring and the three flags are built into libraries of
//   their own (ADAPTIVE_FLAGS), as in the lane kernel (csrc/lane_kernel.cu):
//   their instances read which apply from a run-time argument.  The relative zero follows the rect's offset
//   in every phase; free start gaps re-seed row 0 of right and GROW_R
//   rects whose query start is 0, so after a restore the checkpoint's
//   anchor decides.  Free end gaps keep the x-drop tracker's registers for
//   residue lane % 16 without the GROW_D bank: its running max over both
//   grow halves, and the latest column where a row of a chunk reaching
//   past qlen equals it; at each decision residue qlen % 16's max is the
//   rect maximum and its column the best's, and the tracker restarts.
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
constexpr int SUFFIX = STEP / 4;    // shrink suffix rows
constexpr unsigned FULL = 0xffffffffu;
// rect phases; the initial rect is a GROW_R with psz == 0
constexpr int DIR_R = 0, DIR_D = 1, DIR_GD = 2, DIR_GR = 3;
// profile words per position: 7 score words (4 biased bytes each, query
// codes 0..27), then the gap word open_C | open_R << 8 | close_C << 16
constexpr int PROF_WORDS = 8;
// the run-time modes of the FLAGS instances (the `flags` argument)
constexpr int LOCAL_START = 1, FREE_START = 2, FREE_END = 4, BYTE_MODE = 8;

#ifndef ADAPTIVE_PROFILE
// csrc/adaptive_profile.cu builds the profile instances apart, so that the
// libraries compile in parallel
#define ADAPTIVE_PROFILE false
#endif
#ifndef ADAPTIVE_FLAGS
// csrc/adaptive_flags.cu and csrc/adaptive_profile_flags.cu build the
// FLAGS instances apart; their code is compiled in by the preprocessor, so
// that the other libraries compile exactly the code they had (as in
// csrc/lane_kernel.cu)
#define ADAPTIVE_FLAGS false
#endif
#if ADAPTIVE_FLAGS
// the FLAGS instances' extra arguments
#define ADAPTIVE_MODE_ARGS , flags, bmatch, bmismatch
#else
#define ADAPTIVE_MODE_ARGS
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
// src/scan_block.rs:651-705).  On a right rect the position is the
// column's: C opens with its open_C (plus the extension), R with its
// open_R, and C closes with its close_C.  On a down rect it is the lane's
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

// Rows are interleaved: row r sits in lane r % 32 of slot r / 32.

// An int the optimizer cannot see through.  Comparing a slot number with
// it keeps a select among a plane's slots a select: the compiler would
// otherwise turn `if (k == slot)` chains into an indexed copy of the plane
// in local memory.
__device__ __forceinline__ int opaque(int v) {
  asm("" : "+r"(v));
  return v;
}

// Row `row` (warp-uniform, in slots 0 .. NA-1) of a plane.
template <int NA, int NS>
__device__ __forceinline__ int row_value(const int (&x)[NS], int row) {
  const int slot = row >> 5;
  int v = x[0];
#pragma unroll
  for (int k = 1; k < NA; ++k)
    if (opaque(k) == slot) v = x[k];
  return __shfl_sync(FULL, v, row & 31);
}

// row r <- row r + D in slots 0 .. NA-1, reading slots 0 .. NA-1 only;
// rows past them read NEG.
template <int NA, int D, int NS>
__device__ __forceinline__ void rows_down(int (&x)[NS], int lane) {
  constexpr int DS = D >> 5, DL = D & 31;
  const bool wrap = lane + DL >= 32;  // the source row is one slot further
  const int src = (lane + DL) & 31;
  int a[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) a[j] = __shfl_sync(FULL, x[j], src);
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    // source slot k + DS, or k + DS + 1 for a row that wraps
    const int lo = k + DS < NA ? a[min(k + DS, NA - 1)] : NEG;
    const int hi = k + DS + 1 < NA ? a[min(k + DS + 1, NA - 1)] : NEG;
    x[k] = wrap ? hi : lo;
  }
}

// rows g..g+7 (g a multiple of 8, in slots 0 .. NA-1) <- tail.
template <int NA, int NS>
__device__ __forceinline__ void splice8(int (&x)[NS], const int* tail, int g,
                                        int lane) {
  const int r = lane - (g & 31);
  if (r >= 0 && r < STEP) {
    const int v = tail[r];
#pragma unroll
    for (int k = 0; k < NA; ++k)
      if (opaque(k) == (g >> 5)) x[k] = v;
  }
}

template <int NS>
struct Planes {  // the rect's borders: active D and C, passive D and R
  int actD[NS], actC[NS], pasD[NS], pasR[NS];
};

// Swap active and passive borders in slots 0 .. NA-1.
template <int NA, int NS>
__device__ __forceinline__ void swap_planes(Planes<NS>& p) {
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    const int d = p.actD[k], c = p.actC[k];
    p.actD[k] = p.pasD[k];
    p.actC[k] = p.pasR[k];
    p.pasD[k] = d;
    p.pasR[k] = c;
  }
}

struct Pair {  // one pair's step-machine state, the same in every lane
  int I, J, off, offmax, sz, psz, cpos, dir, pdir, corn;
  int ckI, ckJ, ckOff, best, yiter, gnm, score;
  bool done, rest;
  int dmax;  // this lane's part of the rect maximum
  // trace: the checkpoint events for the next step's descriptor
  // (save << 2 | restore << 3)
  int pend = 0;
  // x-drop: the tracker of residue lane % 16 (running max, chunk origin,
  // column), the GROW_D half's banked candidate, the best's position and
  // the count of failing decisions
  int vm = INT_MIN_, ai = 0, aj = 0;
  int gdmax = INT_MIN_, gdbi = 0, gdbj = 0;
  int xbi = 0, xbj = 0, xiter = 0;
};

struct Ctx {  // what a step reads and never changes
  const uint8_t* qs;
  const uint8_t* rs;
  const int* tab;
  // profile: this pair's profile words (cap, 8), and the warp's staging of
  // a right rect's 8 entering rows
  const int* pw;
  int* prow;
  int* tailD;
  int* tailR;
  int* ck[4];  // checkpoint borders by row: column D, C; row D, R
  int lane, ql, rl, cap, alpha, min_size, gopen, gext, zc, x;
  // trace: this pair's words and descriptor of step 0, and their strides
  // from one step to the next
  int* tw;
  int4* td;
  size_t tw_step, td_step;
#if ADAPTIVE_FLAGS
  // the modes (LOCAL_START | ...), and byte mode's scores
  int flags, bmatch, bmismatch;
#endif
};

// Checkpoint save of slots 0 .. NA-1: the column borders (D, C) and row
// borders (D, R) of the rect just completed; `ro` says whether its lanes
// were the query.
template <int NA, int NS>
__device__ __forceinline__ void save_ckpt(const Ctx& c, const Planes<NS>& p,
                                          bool ro) {
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    const int e = k * 32 + c.lane;
    c.ck[0][e] = ro ? p.actD[k] : p.pasD[k];
    c.ck[1][e] = ro ? p.actC[k] : p.pasR[k];
    c.ck[2][e] = ro ? p.pasD[k] : p.actD[k];
    c.ck[3][e] = ro ? p.pasR[k] : p.actC[k];
  }
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

// One step (8 columns and the decision after them), step number s, of a
// pair whose block size sz has NA = ceil(sz / 32) slots.
template <int S, int NA, bool XDROP, bool TRACE, bool PROFILE>
__device__ __forceinline__ void run_step(Pair& m, Planes<S / 32>& p,
                                         const Ctx& c, int s) {
  // x-drop tracker keys: value * CH + chunk, CH a power of two >= S / 16
  constexpr int CH = S <= 256 ? 16 : 32, LOG_CH = S <= 256 ? 4 : 5;
  const int lane = c.lane;
  const bool shift = m.dir == DIR_R || m.dir == DIR_D;
  const bool right_or = m.dir == DIR_R || m.dir == DIR_GR;  // lanes = query
  if (m.rest) {
    // a grow starts down-oriented from the checkpoint's borders
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      const int e = k * 32 + lane;
      p.actD[k] = c.ck[2][e];
      p.actC[k] = c.ck[3][e];
      p.pasD[k] = c.ck[0][e];
      p.pasR[k] = c.ck[1][e];
    }
    m.rest = false;
  }
  int oa = 0, cvec = NEG;
  if (shift) {
    // offset rebase (reference: src/scan_block.rs:148-151)
    oa = min(max(m.off - m.offmax, NEG), 32767);
    m.off = m.offmax;
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      p.actD[k] = sat(p.actD[k] + oa);
      p.actC[k] = sat(p.actC[k] + oa);
    }
    if ((m.dir == DIR_R && m.pdir == DIR_D) ||
        (m.dir == DIR_D && m.pdir == DIR_R))
      cvec = sat(m.corn + oa);
  }
  // the rect maximum restarts with each rect; GROW_R continues GROW_D's
  if (m.cpos == 0 && m.dir != DIR_GR) m.dmax = NEG;
  const int h = m.dir == DIR_GD ? m.psz : m.sz;  // rect height
  const int ls = right_or ? m.I : m.J;           // lane start
  const int cstart = m.dir == DIR_R   ? m.J + m.sz - STEP
                     : m.dir == DIR_D ? m.I + m.sz - STEP
                                      : (m.dir == DIR_GD ? m.I : m.J) + m.psz +
                                            m.cpos;
  const int lane_len = right_or ? c.ql : c.rl;
  const int col_len = right_or ? c.rl : c.ql;
  // freeze predicate: never inside GROW_D
  const bool fra = ls + h > lane_len && m.dir != DIR_GD;
  const int frt = col_len - cstart;
  const int fridx = min(max(lane_len - ls, 0), S - 1);
  const bool origin = m.dir == DIR_GR && m.psz == 0 && m.cpos == 0 && m.J == 0;
  const uint8_t* lseq = right_or ? c.qs : c.rs;
  const uint8_t* cseq = right_or ? c.rs : c.qs;
#if ADAPTIVE_FLAGS
  // the modes, the relative zero of the rect's offset, and whether free
  // start gaps re-seed row 0 (a right rect at query row 0)
  const bool local = c.flags & LOCAL_START;
  const bool fend = c.flags & FREE_END;
  const bool byte = !PROFILE && (c.flags & BYTE_MODE);
  const bool ins0 = (c.flags & FREE_START) && right_or && m.I == 0;
  const int rz = min(max(ZERO - m.off, NEG), 32767);
  unsigned zb[NA];  // local-start trace: this step's zero bits
#endif
  unsigned wd[NA];  // trace: this step's bits of this lane's rows
  if constexpr (TRACE) {
    if (lane == 0)
      c.td[c.td_step * s] = make_int4(
          (right_or ? 1 : 0) | (m.cpos == 0 ? 2 : 0) | m.pend, ls, cstart, h);
    m.pend = 0;
#pragma unroll
    for (int k = 0; k < NA; ++k) wd[k] = 0u;
#if ADAPTIVE_FLAGS
#pragma unroll
    for (int k = 0; k < NA; ++k) zb[k] = 0u;
#endif
  }
  int lc[NA], cc[STEP];
  if constexpr (PROFILE) {
    // lanes are query rows on right rects and profile positions on down
    // rects (the profile is the reference)
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      const int pos = min(ls + k * 32 + lane, c.cap - 1);
      lc[k] = right_or ? (int)c.qs[pos] : pos;  // a code, or a position
    }
#pragma unroll
    for (int w = 0; w < STEP; ++w) cc[w] = c.qs[min(cstart + w, c.cap - 1)];
    if (right_or) {
      // the 8 entering positions' rows, 256 contiguous bytes
#pragma unroll
      for (int i = lane; i < STEP * PROF_WORDS; i += 32)
        c.prow[i] = c.pw[(size_t)min(cstart + i / PROF_WORDS, c.cap - 1) *
                             PROF_WORDS + i % PROF_WORDS];
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int k = 0; k < NA; ++k)
      lc[k] = min((int)lseq[min(ls + k * 32 + lane, c.cap - 1)], c.alpha - 1);
#pragma unroll
    for (int w = 0; w < STEP; ++w)
      cc[w] = min((int)cseq[min(cstart + w, c.cap - 1)], c.alpha - 1);
  }

#pragma unroll
  for (int w = 0; w < STEP; ++w) {
    const int* trow = c.tab + cc[w] * c.alpha;
    int D[NA], C[NA], T[NA], CO[NA], DO[NA];
    int CL[NA], CE[NA];  // profile: close cost, closed C
    int rot_prev = NEG;
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      // the diagonal: row r - 1 of the previous column, which for lane 0
      // is lane 31 of the slot before
      const int rot = __shfl_sync(FULL, p.actD[k], (lane + 31) & 31);
      int up = rot;
      if (lane == 0) up = k > 0 ? rot_prev : (w == 0 ? cvec : NEG);
      rot_prev = rot;
      int t;
      if constexpr (PROFILE) {
        // a right rect's lane reads the entering row by its own code, a
        // down rect's the row of its own position by the entering code
        const int* row = right_or ? c.prow + w * PROF_WORDS
                                  : c.pw + (size_t)lc[k] * PROF_WORDS;
        int d = sat(up + prof_score(row, right_or ? lc[k] : cc[w]));
        if (k == 0 && w == 0 && origin && lane == 0) d = ZERO;  // DP origin
#if ADAPTIVE_FLAGS
        if (local) d = max(d, rz);
        else if (ins0 && k == 0 && lane == 0) d = rz;
#endif
        const ProfGaps g(row[PROF_WORDS - 1], right_or, c.gext);
        const int co = sat(p.actD[k] + g.copen);
        C[k] = max(sat(p.actC[k] + c.gext), co);
        CL[k] = g.close;
        // a right rect closes C before the merge; C stays pre-close
        CE[k] = right_or ? sat(C[k] + g.close) : C[k];
        D[k] = max(d, CE[k]);
        // max-plus prefix scan of D plus the cell's R open across the slot
        t = sat(D[k] + g.dopen);
        if constexpr (TRACE) {
          CO[k] = co;
          DO[k] = t;
        }
      } else {
#if ADAPTIVE_FLAGS
        // byte mode compares the codes; the flags restart cells at the
        // relative zero
        int d = sat(up + (byte ? (lc[k] == cc[w] ? c.bmatch : c.bmismatch)
                               : trow[lc[k]]));
        if (k == 0 && w == 0 && origin && lane == 0) d = ZERO;  // DP origin
        if (local) d = max(d, rz);
        else if (ins0 && k == 0 && lane == 0) d = rz;
#else
        int d = sat(up + trow[lc[k]]);
        if (k == 0 && w == 0 && origin && lane == 0) d = ZERO;  // DP origin
#endif
        const int co = sat(p.actD[k] + c.gopen);
        C[k] = max(sat(p.actC[k] + c.gext), co);
        D[k] = max(d, C[k]);
        // max-plus prefix scan of D + (open - extend) across the slot
        t = D[k] + (c.gopen - c.gext);
        if constexpr (TRACE) {
          CO[k] = co;
          DO[k] = t;
        }
      }
#pragma unroll
      for (int dd = 1; dd < 32; dd <<= 1) {
        const int o = __shfl_up_sync(FULL, t, dd);
        if (lane >= dd) t = max(t, o + c.gext * dd);
      }
      T[k] = t;
    }
    // carry the scan from slot to slot, then the zero correction
#pragma unroll
    for (int k = 1; k < NA; ++k)
      T[k] = max(T[k], __shfl_sync(FULL, T[k - 1], 31) + c.gext * (lane + 1));
    int nib[NA], rbits = 0;
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      const int R = max(T[k], c.zc);
      if constexpr (PROFILE) {
        // a down rect closes R before the merge; the bits compare D with
        // the closed C and R
        const int re = right_or ? R : sat(R + CL[k]);
        if constexpr (TRACE) {
          const int dn = max(D[k], re);
          nib[k] = (dn == CE[k]) | (dn == re) << 1 | (C[k] == CO[k]) << 2;
          rbits |= (R == DO[k]) << k;
        }
        D[k] = max(D[k], re);
      } else {
        if constexpr (TRACE) {
          // the cell's bits (reference: src/scan_block.rs:1166-1190): D ==
          // C, D == R, C == C_open; R == D_open feeds the row below
          const int dn = max(D[k], R);
          nib[k] = (dn == C[k]) | (dn == R) << 1 | (C[k] == CO[k]) << 2;
          rbits |= (R == DO[k]) << k;
        }
        D[k] = max(D[k], R);
      }
#if ADAPTIVE_FLAGS
      if constexpr (TRACE) {
        // local start: the cell restarted at the relative zero
        if (local) zb[k] |= (unsigned)(D[k] == rz) << w;
      }
#endif
      p.actD[k] = D[k];
      p.actC[k] = C[k];
      if (k * 32 + lane < h) m.dmax = max(m.dmax, D[k]);
      // the rect's bottom cells: staged for a shift, written into the
      // passive border at row psz + cpos + w for a grow half
      if (k * 32 + lane == h - 1) {
        c.tailD[w] = D[k];
        c.tailR[w] = R;
      }
    }
    if constexpr (TRACE) {
      // bit k: the R bit of the row above row k * 32 + lane, which is lane
      // lane - 1 of slot k, or lane 31 of slot k - 1 (0 above row 0)
      const int up_bits = __shfl_sync(FULL, rbits, (lane + 31) & 31);
      const int above = lane > 0 ? up_bits : up_bits << 1;
#pragma unroll
      for (int k = 0; k < NA; ++k)
        wd[k] |= (unsigned)(nib[k] | ((above >> k) & 1) << 3) << (4 * w);
    }
    if constexpr (XDROP) {
      // rows at or past the height count as NEG, as in the JAX kernel,
      // whose rows past the slots are NEG too: a column whose max is NEG
      // ties there at the last chunk
      int key = INT_MIN_;
#pragma unroll
      for (int k = 0; k < NA; ++k)
        key = max(key, (k * 32 + lane < h ? D[k] : NEG) * CH + 2 * k +
                           (lane >> 4));
      key = max(key, __shfl_xor_sync(FULL, key, 16));
      const int cmax = key >> LOG_CH;
      if (cmax >= m.vm) {
        m.vm = cmax;
        m.ai = ls + 16 * (cmax == NEG && 2 * NA < S / 16 ? S / 16 - 1
                                                           : key & (CH - 1));
        m.aj = cstart + w;
      }
#if ADAPTIVE_FLAGS
    } else if (fend) {
      // free end gaps: the column's max of residue lane % 16 (rows past the
      // height count as NEG) into its running max; the column is the
      // best's when a row of a chunk reaching past qlen equals it, and
      // where the max is NEG the chunks past the slots, the last of which
      // reaches past qlen, equal it too
      int v = NEG;
#pragma unroll
      for (int k = 0; k < NA; ++k)
        if (k * 32 + lane < h) v = max(v, D[k]);
      v = max(v, __shfl_xor_sync(FULL, v, 16));
      const int vmn = max(m.vm, v);
      int hit = vmn == NEG && ls + S > c.ql;
#pragma unroll
      for (int k = 0; k < NA; ++k) {
        const int r = k * 32 + lane;
        hit |= r < h && D[k] == vmn && ls + 16 * (r >> 4) + 16 > c.ql;
      }
      hit |= __shfl_xor_sync(FULL, hit, 16);
      if (hit) m.aj = cstart + w;
      m.vm = vmn;
#endif
    } else {
      // freeze: the rect covering (qlen, rlen) reached the last column
      if (fra && w >= frt) {
        m.score = m.off + row_value<NA>(p.actD, fridx) - ZERO;
        m.done = true;
        if constexpr (TRACE)
          break;  // the step's words are stored below
        else
          return;
      }
    }
  }
  if constexpr (TRACE) {
#pragma unroll
    for (int k = 0; k < NA; ++k)
      c.tw[c.tw_step * s + k * 32 + lane] = (int)wd[k];
#if ADAPTIVE_FLAGS
    // local start: the zero bits follow the step's S words
    if (local) {
#pragma unroll
      for (int k = 0; k < NA; ++k)
        c.tw[c.tw_step * s + S + k * 32 + lane] = (int)zb[k];
    }
#endif
    if (m.done) return;
  }
  __syncwarp();  // the step's bottom cells are visible to the warp

  const int cpos_new = m.cpos + STEP;
  const bool phase_done = cpos_new >= (shift ? STEP : m.sz - m.psz);
  if (!shift) {
    splice8<NA>(p.pasD, c.tailD, m.psz + m.cpos, lane);
    splice8<NA>(p.pasR, c.tailR, m.psz + m.cpos, lane);
  } else {
    // a shift's end (reference: src/scan_block.rs:165-177, 349-355):
    // rebase the passive border, keep its row 7 as the next corner, shift
    // it by 8 and splice in the bottom cells
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      p.pasD[k] = sat(p.pasD[k] + oa);
      p.pasR[k] = sat(p.pasR[k] + oa);
    }
    m.corn = __shfl_sync(FULL, p.pasD[0], STEP - 1);
    rows_down<NA, STEP>(p.pasD, lane);
    rows_down<NA, STEP>(p.pasR, lane);
    splice8<NA>(p.pasD, c.tailD, m.sz - STEP, lane);
    splice8<NA>(p.pasR, c.tailR, m.sz - STEP, lane);
  }
  m.cpos = phase_done ? 0 : cpos_new;
  __syncwarp();  // bottom cells read before the next step writes them
  if (!phase_done) return;

  if (m.dir == DIR_GD) {
    // GROW_D -> GROW_R: the lane axis flips to the query
    swap_planes<NA>(p);
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
    return;
  }
  // rect completion: the reference's decision ladder
  // (src/scan_block.rs:439-565)
  const int d0 = m.dir;
  const bool was_grow = d0 == DIR_GR;
  const bool ro = d0 == DIR_R || d0 == DIR_GR;
#if ADAPTIVE_FLAGS
  // free end gaps: the rect maximum is row qlen's residue's
  const int cur_max = fend ? __shfl_sync(FULL, m.vm, c.ql & 15)
                           : __reduce_max_sync(FULL, m.dmax);
#else
  const int cur_max = __reduce_max_sync(FULL, m.dmax);
#endif
  const int off_max = m.off + cur_max - ZERO;
  m.offmax = off_max;
  int ydi = m.yiter + 1;
  m.gnm = was_grow ? 1 : 0;
  const bool new_best = off_max > m.best;
  const bool save = new_best && m.sz < S;
  if (save) {
    m.ckI = m.I;
    m.ckJ = m.J;
    m.ckOff = m.off;
    m.gnm = 0;
  }
  // a completed grow saves its doubled borders even without a new best
  // (reference: src/scan_block.rs:432-435)
  if (save || (was_grow && m.sz < S)) {
    save_ckpt<NA>(c, p, ro);
    if constexpr (TRACE) m.pend |= 4;
  }
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
    const bool xfail = off_max < m.best - c.x;
    const bool stop = xfail && m.xiter >= 1;
    m.xiter = xfail ? m.xiter + 1 : 0;
    if (stop || (m.I + m.sz > c.ql && m.J + m.sz > c.rl)) {
      m.done = true;
      return;
    }
  }
#if ADAPTIVE_FLAGS
  if (fend) {
    // the best of row qlen at its residue's column, even on grows; a fresh
    // tracker per rect; the end: both ends covered
    const int aj = __shfl_sync(FULL, m.aj, c.ql & 15);
    if (new_best) {
      m.xbi = c.ql;
      m.xbj = aj;
    }
    m.vm = INT_MIN_;
    m.aj = 0;
    if (m.I + m.sz > c.ql && m.J + m.sz > c.rl) {
      m.done = true;
      return;
    }
  }
#endif
  // forced moves skip both heuristics (src/scan_block.rs:509-516)
  const bool forced_down = m.J + m.sz > c.rl;
  const bool free_rect = !forced_down && m.I + m.sz <= c.ql;
  bool shrink = false;
  if (free_rect && 2 * m.sz <= S && (ydi > m.sz / STEP - 1 || m.gnm == 1)) {
    // grow: double and restart from the checkpoint
    m.psz = m.sz;
    m.sz *= 2;
    m.I = m.ckI;
    m.J = m.ckJ;
    m.off = m.ckOff;
    m.rest = true;
    m.dir = DIR_GD;
    ydi = 0;
    if constexpr (TRACE) m.pend |= 8;
  } else {
    if (free_rect && m.sz > c.min_size && ydi == 0) {
      // shrink when the border suffix holds the rect maximum
      // (src/scan_block.rs:534-559)
      int suf = INT_MIN_;
#pragma unroll
      for (int k = 0; k < NA; ++k) {
        const int r = k * 32 + lane;
        if (r >= m.sz - SUFFIX && r < m.sz)
          suf = max(p.actD[k], p.pasD[k]);
      }
      shrink = __reduce_max_sync(FULL, suf) >= cur_max;
    }
    if (shrink) {
      // sz > min_size >= 16 makes sz = 32 * NA, so the half is 16 * NA
      const int half = m.sz >> 1;
      rows_down<NA, 16 * NA>(p.actD, lane);
      rows_down<NA, 16 * NA>(p.actC, lane);
      rows_down<NA, 16 * NA>(p.pasD, lane);
      rows_down<NA, 16 * NA>(p.pasR, lane);
      m.sz = half;
      m.I += half;
      m.J += half;
      m.ckI = m.I;
      m.ckJ = m.J;
      m.ckOff = m.off;
      save_ckpt<NA>(c, p, ro);
      if constexpr (TRACE) m.pend |= 4;
      ydi = 0;
    }
    // direction from the first 8 rows of both borders
    // (src/scan_block.rs:560-565)
    const int ah = __reduce_max_sync(FULL, lane < STEP ? p.actD[0] : INT_MIN_);
    const int ph = __reduce_max_sync(FULL, lane < STEP ? p.pasD[0] : INT_MIN_);
    const int right_max = ro ? ah : ph, down_max = ro ? ph : ah;
    const bool godown = forced_down || (free_rect && down_max > right_max);
    if (godown) m.I += STEP; else m.J += STEP;
    m.dir = godown ? DIR_D : DIR_R;
    // the lane axis flipped: the borders trade roles
    if (ro == godown) swap_planes<NA>(p);
  }
  m.yiter = ydi;
  // a shrink forces GROW_D as the previous direction, which kills the next
  // rect's corner (src/scan_block.rs:541)
  m.pdir = shrink ? DIR_GD : d0;
}

template <int S, bool XDROP, bool TRACE, bool PROFILE>
__global__ void __launch_bounds__(WARPS * 32)
adaptive_align_kernel(const uint8_t* __restrict__ codes,
                      const int* __restrict__ qlen,
                      const int* __restrict__ rlen,
                      const int* __restrict__ table, int* __restrict__ out,
                      int* __restrict__ twords, int4* __restrict__ tdesc,
                      int* __restrict__ tsteps, int B, int cap, int alpha,
                      int min_size, int max_steps, int gopen, int gext,
#if ADAPTIVE_FLAGS
                      int xdrop, int flags, int bmatch, int bmismatch) {
#else
                      int xdrop) {
#endif
  constexpr int NS = S / 32;  // row slots of the largest block

  __shared__ int tab[PROFILE ? 1 : MAX_ALPHA * MAX_ALPHA];
  __shared__ int tails[WARPS][2][STEP];  // a step's bottom D and R cells
  __shared__ int ckpt[WARPS][4][S];      // checkpoint borders by row
  __shared__ int prows[WARPS][PROFILE ? STEP * PROF_WORDS : 1];

#if ADAPTIVE_FLAGS
  if constexpr (!PROFILE) {
    if (!(flags & BYTE_MODE))
      for (int k = threadIdx.x; k < alpha * alpha; k += blockDim.x)
        tab[k] = table[k];
    __syncthreads();
  }
  // local-start trace: two words per row and step
  const size_t tws = flags & LOCAL_START ? 2 : 1;
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
  // profile: codes (B, cap) of the queries and table (B, cap, 8) of the
  // profiles' words; else codes (B, 2, cap) of both sequences
  const uint8_t* qs = codes + (size_t)b * (PROFILE ? 1 : 2) * cap;
  const Ctx c{qs, qs + cap, tab, table + (size_t)b * cap * PROF_WORDS,
              prows[warp], tails[warp][0], tails[warp][1],
              {ckpt[warp][0], ckpt[warp][1], ckpt[warp][2], ckpt[warp][3]},
              lane, qlen[b], rlen[b], cap, alpha, min_size, gopen, gext,
              gext * ((lane & 7) + 1),  // the scan's zero correction
              xdrop,
#if ADAPTIVE_FLAGS
              TRACE ? twords + (size_t)b * S * tws : nullptr,
              TRACE ? tdesc + b : nullptr, (size_t)B * S * tws, (size_t)B,
              flags, bmatch, bmismatch};
#else
              TRACE ? twords + (size_t)b * S : nullptr,
              TRACE ? tdesc + b : nullptr, (size_t)B * S, (size_t)B};
#endif

  Planes<NS> p;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    p.actD[k] = p.actC[k] = p.pasD[k] = p.pasR[k] = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) c.ck[q][k * 32 + lane] = 0;
  }
  // the reference's start state (src/scan_block.rs:291-317): a grow from
  // size 0, best 0, a virgin checkpoint at the origin
  Pair m{0, 0, 0, 0, min_size, 0, 0, DIR_GR, DIR_GR, NEG,
         0, 0, 0, 0, 0, 1, 0, false, false, NEG};

  int s = 0;
  for (; s < max_steps && !m.done; ++s) {
    switch ((m.sz + 31) >> 5) {
      case 1: run_step<S, 1, XDROP, TRACE, PROFILE>(m, p, c, s); break;
      case 2: if constexpr (NS >= 2) run_step<S, 2, XDROP, TRACE, PROFILE>(m, p, c, s); break;
      case 4: if constexpr (NS >= 4) run_step<S, 4, XDROP, TRACE, PROFILE>(m, p, c, s); break;
      default:
        if constexpr (NS >= 16) {
          if (m.sz > 256) run_step<S, 16, XDROP, TRACE, PROFILE>(m, p, c, s);
          else run_step<S, 8, XDROP, TRACE, PROFILE>(m, p, c, s);
        } else if constexpr (NS >= 8) {
          run_step<S, 8, XDROP, TRACE, PROFILE>(m, p, c, s);
        }
        break;
    }
  }
  if (lane == 0) {
    if constexpr (TRACE) tsteps[b] = s;
    if constexpr (XDROP) {
      out[4 * b] = m.best;
      out[4 * b + 1] = m.xbi;
      out[4 * b + 2] = m.xbj;
      out[4 * b + 3] = m.done ? 0 : 1;
#if ADAPTIVE_FLAGS
    } else if (flags & FREE_END) {
      out[4 * b] = m.best;
      out[4 * b + 1] = m.xbi;
      out[4 * b + 2] = m.xbj;
      out[4 * b + 3] = m.done ? 0 : 1;
#endif
    } else {
      out[2 * b] = m.score;
      out[2 * b + 1] = m.done ? 0 : 1;
    }
  }
}

template <int S>
cudaError_t launch(const uint8_t* codes, const int* qlen, const int* rlen,
                   const int* table, int* out, int* twords, int4* tdesc,
                   int* tsteps, int B, int cap, int alpha, int min_size,
                   int max_steps, int gopen, int gext, int xdrop, int flags,
                   int bmatch, int bmismatch, cudaStream_t stream) {
  constexpr bool P = ADAPTIVE_PROFILE;
  const unsigned grid = (unsigned)((B + WARPS - 1) / WARPS);
  decltype(&adaptive_align_kernel<S, false, false, P>) kernel;
  if constexpr (S == 512 && !P) {
    // only trace reaches max_size 512 on the sequence route; profiles take
    // it in every mode
    if (!twords) return cudaErrorInvalidValue;
    kernel = xdrop < 0 ? adaptive_align_kernel<S, false, true, P>
                       : adaptive_align_kernel<S, true, true, P>;
  } else {
    kernel = twords ? (xdrop < 0 ? adaptive_align_kernel<S, false, true, P>
                                 : adaptive_align_kernel<S, true, true, P>)
                    : (xdrop < 0 ? adaptive_align_kernel<S, false, false, P>
                                 : adaptive_align_kernel<S, true, false, P>);
  }
  kernel<<<grid, WARPS * 32, 0, stream>>>(
      codes, qlen, rlen, table, out, twords, tdesc, tsteps, B, cap, alpha,
      min_size, max_steps, gopen, gext, xdrop ADAPTIVE_MODE_ARGS);
  return cudaGetLastError();
}

}  // namespace

// codes (B, 2, cap) uint8, qlen/rlen (B,) int32, table (alpha, alpha) int32;
// in the profile library (csrc/adaptive_profile.cu) codes (B, cap) uint8 are
// the queries' codes, table (B, cap, 8) int32 the profiles' words, rlen the
// profiles' lengths, and alpha and gopen are not read.
// x_drop < 0: global mode, out (B, 2) int32 = (score, overrun); else x-drop
// with x = x_drop, out (B, 4) int32 = (best, query pos, reference pos,
// overrun).  Trace mode when `words` is not null: words (max_steps, B,
// max_size) int32 (max_size * 2 with local start), desc (max_steps, B, 4)
// int32 and steps (B,) int32 receive the trace of core/traceback.py; of a
// step's words only the rows of the current size's slots are written, and
// nothing of the steps a pair did not execute.  max_size 512 needs trace,
// or the profile library.  `flags` as in csrc/lane_kernel.cu's
// lane_align_launch.  Returns the launch's cudaError_t.
extern "C" int adaptive_align_launch(const void* codes, const void* qlen,
                                     const void* rlen, const void* table,
                                     void* out, void* words, void* desc,
                                     void* steps, int B, int cap, int alpha,
                                     int min_size, int max_size,
                                     int max_steps, int gopen, int gext,
                                     int x_drop, int flags, int match,
                                     int mismatch, void* stream) {
  const bool byte = flags & BYTE_MODE;
  if (B < 1 || cap < 1 || alpha < 1 ||
      (byte ? alpha != 256 : alpha > MAX_ALPHA) || min_size < 16 ||
      (min_size & (min_size - 1)) || min_size >= max_size ||
      (words && (!desc || !steps)) || (flags & ~15) ||
      (flags && !ADAPTIVE_FLAGS) ||
      ((flags & LOCAL_START) && (flags & FREE_START)) ||
      ((flags & FREE_END) && x_drop >= 0) ||
      (byte && (x_drop >= 0 || ADAPTIVE_PROFILE)))
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
  switch (max_size) {
    case 32: return (int)launch<32>(c, q, r, t, o, tw, td, ts, B, cap, alpha, min_size, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    case 64: return (int)launch<64>(c, q, r, t, o, tw, td, ts, B, cap, alpha, min_size, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    case 128: return (int)launch<128>(c, q, r, t, o, tw, td, ts, B, cap, alpha, min_size, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    case 256: return (int)launch<256>(c, q, r, t, o, tw, td, ts, B, cap, alpha, min_size, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    case 512: return (int)launch<512>(c, q, r, t, o, tw, td, ts, B, cap, alpha, min_size, max_steps, gopen, gext, x_drop, flags, match, mismatch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* adaptive_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
