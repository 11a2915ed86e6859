// Adaptive-block alignment of a batch of sequence pairs, global or x-drop,
// with or without trace, for Hopper (sm_90a).  Plain C interface, loaded
// with ctypes by ops/adaptive_kernel.py.
//
// Replaces: block_aligner_tpu/ops/adaptive_kernel.py::build_adaptive_engine
// (its Pallas `kernel`) in global and in x-drop mode, with and without
// trace: the grow / shrink / checkpoint machine for min_size < max_size <=
// 256, and <= 512 with trace.  It computes the same score (x-drop: the best
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
// i16x2 packing, DPX instructions and several pairs per warp are left to
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STEP = 8;             // columns per step
constexpr int ZERO = 1 << 14;       // score bias
constexpr int NEG = -32768;         // the i16 lower rail
constexpr int INT_MIN_ = -2147483647 - 1;
constexpr int MAX_ALPHA = 32;
constexpr int WARPS = 4;            // pairs per thread block
constexpr int SUFFIX = STEP / 4;    // shrink suffix rows
constexpr unsigned FULL = 0xffffffffu;
// rect phases; the initial rect is a GROW_R with psz == 0
constexpr int DIR_R = 0, DIR_D = 1, DIR_GD = 2, DIR_GR = 3;

// only the lower rail is reachable: rect maxima are rebased to ZERO
__device__ __forceinline__ int sat(int x) { return max(x, NEG); }

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
  int* tailD;
  int* tailR;
  int* ck[4];  // checkpoint borders by row: column D, C; row D, R
  int lane, ql, rl, cap, alpha, min_size, gopen, gext, zc, x;
  // trace: this pair's words and descriptor of step 0, and their strides
  // from one step to the next
  int* tw;
  int4* td;
  size_t tw_step, td_step;
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
template <int S, int NA, bool XDROP, bool TRACE>
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
  unsigned wd[NA];  // trace: this step's bits of this lane's rows
  if constexpr (TRACE) {
    if (lane == 0)
      c.td[c.td_step * s] = make_int4(
          (right_or ? 1 : 0) | (m.cpos == 0 ? 2 : 0) | m.pend, ls, cstart, h);
    m.pend = 0;
#pragma unroll
    for (int k = 0; k < NA; ++k) wd[k] = 0u;
  }
  int lc[NA], cc[STEP];
#pragma unroll
  for (int k = 0; k < NA; ++k)
    lc[k] = min((int)lseq[min(ls + k * 32 + lane, c.cap - 1)], c.alpha - 1);
#pragma unroll
  for (int w = 0; w < STEP; ++w)
    cc[w] = min((int)cseq[min(cstart + w, c.cap - 1)], c.alpha - 1);

#pragma unroll
  for (int w = 0; w < STEP; ++w) {
    const int* trow = c.tab + cc[w] * c.alpha;
    int D[NA], C[NA], T[NA], CO[NA], DO[NA];
    int rot_prev = NEG;
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      // the diagonal: row r - 1 of the previous column, which for lane 0
      // is lane 31 of the slot before
      const int rot = __shfl_sync(FULL, p.actD[k], (lane + 31) & 31);
      int up = rot;
      if (lane == 0) up = k > 0 ? rot_prev : (w == 0 ? cvec : NEG);
      rot_prev = rot;
      int d = sat(up + trow[lc[k]]);
      if (k == 0 && w == 0 && origin && lane == 0) d = ZERO;  // DP origin
      const int co = sat(p.actD[k] + c.gopen);
      C[k] = max(sat(p.actC[k] + c.gext), co);
      D[k] = max(d, C[k]);
      // max-plus prefix scan of D + (open - extend) across the slot
      int t = D[k] + (c.gopen - c.gext);
      if constexpr (TRACE) {
        CO[k] = co;
        DO[k] = t;
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
      if constexpr (TRACE) {
        // the cell's bits (reference: src/scan_block.rs:1166-1190): D ==
        // C, D == R, C == C_open; R == D_open feeds the row below
        const int dn = max(D[k], R);
        nib[k] = (dn == C[k]) | (dn == R) << 1 | (C[k] == CO[k]) << 2;
        rbits |= (R == DO[k]) << k;
      }
      D[k] = max(D[k], R);
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
  const int cur_max = __reduce_max_sync(FULL, m.dmax);
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

template <int S, bool XDROP, bool TRACE>
__global__ void __launch_bounds__(WARPS * 32)
adaptive_align_kernel(const uint8_t* __restrict__ codes,
                      const int* __restrict__ qlen,
                      const int* __restrict__ rlen,
                      const int* __restrict__ table, int* __restrict__ out,
                      int* __restrict__ twords, int4* __restrict__ tdesc,
                      int* __restrict__ tsteps, int B, int cap, int alpha,
                      int min_size, int max_steps, int gopen, int gext,
                      int xdrop) {
  constexpr int NS = S / 32;  // row slots of the largest block

  __shared__ int tab[MAX_ALPHA * MAX_ALPHA];
  __shared__ int tails[WARPS][2][STEP];  // a step's bottom D and R cells
  __shared__ int ckpt[WARPS][4][S];      // checkpoint borders by row

  for (int k = threadIdx.x; k < alpha * alpha; k += blockDim.x)
    tab[k] = table[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  const uint8_t* qs = codes + (size_t)b * 2 * cap;
  const Ctx c{qs, qs + cap, tab, tails[warp][0], tails[warp][1],
              {ckpt[warp][0], ckpt[warp][1], ckpt[warp][2], ckpt[warp][3]},
              lane, qlen[b], rlen[b], cap, alpha, min_size, gopen, gext,
              gext * ((lane & 7) + 1),  // the scan's zero correction
              xdrop,
              TRACE ? twords + (size_t)b * S : nullptr,
              TRACE ? tdesc + b : nullptr, (size_t)B * S, (size_t)B};

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
      case 1: run_step<S, 1, XDROP, TRACE>(m, p, c, s); break;
      case 2: if constexpr (NS >= 2) run_step<S, 2, XDROP, TRACE>(m, p, c, s); break;
      case 4: if constexpr (NS >= 4) run_step<S, 4, XDROP, TRACE>(m, p, c, s); break;
      default:
        if constexpr (NS >= 16) {
          if (m.sz > 256) run_step<S, 16, XDROP, TRACE>(m, p, c, s);
          else run_step<S, 8, XDROP, TRACE>(m, p, c, s);
        } else if constexpr (NS >= 8) {
          run_step<S, 8, XDROP, TRACE>(m, p, c, s);
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
                   int max_steps, int gopen, int gext, int xdrop,
                   cudaStream_t stream) {
  const unsigned grid = (unsigned)((B + WARPS - 1) / WARPS);
  void (*kernel)(const uint8_t*, const int*, const int*, const int*, int*,
                 int*, int4*, int*, int, int, int, int, int, int, int, int);
  if constexpr (S == 512) {
    // only trace reaches max_size 512 on this route
    if (!twords) return cudaErrorInvalidValue;
    kernel = xdrop < 0 ? adaptive_align_kernel<S, false, true>
                       : adaptive_align_kernel<S, true, true>;
  } else {
    kernel = twords ? (xdrop < 0 ? adaptive_align_kernel<S, false, true>
                                 : adaptive_align_kernel<S, true, true>)
                    : (xdrop < 0 ? adaptive_align_kernel<S, false, false>
                                 : adaptive_align_kernel<S, true, false>);
  }
  kernel<<<grid, WARPS * 32, 0, stream>>>(
      codes, qlen, rlen, table, out, twords, tdesc, tsteps, B, cap, alpha,
      min_size, max_steps, gopen, gext, xdrop);
  return cudaGetLastError();
}

}  // namespace

// codes (B, 2, cap) uint8, qlen/rlen (B,) int32, table (alpha, alpha) int32.
// x_drop < 0: global mode, out (B, 2) int32 = (score, overrun); else x-drop
// with x = x_drop, out (B, 4) int32 = (best, query pos, reference pos,
// overrun).  Trace mode when `words` is not null: words (max_steps, B,
// max_size) int32, desc (max_steps, B, 4) int32 and steps (B,) int32
// receive the trace of core/traceback.py; of a step's words only the rows
// of the current size's slots are written, and nothing of the steps a pair
// did not execute.  max_size 512 needs trace.  Returns the launch's
// cudaError_t.
extern "C" int adaptive_align_launch(const void* codes, const void* qlen,
                                     const void* rlen, const void* table,
                                     void* out, void* words, void* desc,
                                     void* steps, int B, int cap, int alpha,
                                     int min_size, int max_size,
                                     int max_steps, int gopen, int gext,
                                     int x_drop, void* stream) {
  if (B < 1 || cap < 1 || alpha < 1 || alpha > MAX_ALPHA || min_size < 16 ||
      (min_size & (min_size - 1)) || min_size >= max_size ||
      (words && (!desc || !steps)))
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
    case 32: return (int)launch<32>(c, q, r, t, o, tw, td, ts, B, cap, alpha, min_size, max_steps, gopen, gext, x_drop, st);
    case 64: return (int)launch<64>(c, q, r, t, o, tw, td, ts, B, cap, alpha, min_size, max_steps, gopen, gext, x_drop, st);
    case 128: return (int)launch<128>(c, q, r, t, o, tw, td, ts, B, cap, alpha, min_size, max_steps, gopen, gext, x_drop, st);
    case 256: return (int)launch<256>(c, q, r, t, o, tw, td, ts, B, cap, alpha, min_size, max_steps, gopen, gext, x_drop, st);
    case 512: return (int)launch<512>(c, q, r, t, o, tw, td, ts, B, cap, alpha, min_size, max_steps, gopen, gext, x_drop, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* adaptive_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
