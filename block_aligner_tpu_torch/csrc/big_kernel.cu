// Big-block adaptive alignment of a batch of sequence pairs, or of (query,
// profile) pairs, global or x-drop, with or without trace, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by ops/big_kernel.py;
// the trace instances build from csrc/big_trace.cu, the FLAGS instances
// (ByteMatrix scoring and the local-start and free-query-gap flags, read at
// run time) from csrc/big_flags.cu and csrc/big_trace_flags.cu, the
// profile instances (with the flags read at run time) from
// csrc/big_profile.cu and csrc/big_trace_profile.cu.
//
// Replaces: block_aligner_tpu/ops/big_kernel.py::build_big_engine (its
// Pallas `kernel`) in global and in x-drop mode with a score table or a
// ByteMatrix or a profile (sequence-to-PSSM), with the local-start,
// free-query-start-gap and free-query-end-gap flags, with or without trace:
// the grow / shrink /
// checkpoint machine for 512 < max_size <= 8192, and (min, 512).  It
// computes the same score (x-drop and free end gaps: the best score and its
// position) and the same overrun flag, bit for bit; the
// machine is the adaptive kernel's (csrc/adaptive_kernel.cu), described in
// ops/adaptive_kernel.py, whose adaptive_align_plain, run on a
// BigKernelConfig, is the plain PyTorch version of this kernel.
//
// Trace (ops/_trace.py, core/traceback.py): the reference's 4 bits a cell,
// t | t2 << 2 (src/scan_block.rs:1166-1190), 8 columns a row's word, in a
// layout sized by the block that ran: each pair writes the words of a step's
// rect height at its own running counter, and the step's descriptor (flags,
// lane start, column start, height, the counter before the step).  The
// checkpoint save and restore decided at a step's end ride the next step's
// flags, save before restore.  A step whose rows would pass the pair's word
// budget stops the pair with the overrun flag, as the step cap does.  A
// row's word is staged in shared memory by the thread that owns the row (a
// thread holds up to 32 slots of rows) and written once at the step's end;
// the R-open bit of row r belongs to row r + 1, so the first row of a slot
// takes it from lane 31 of the slot before and the first row of a warp from
// the warp above, whose R there is the scan's carry.
//
// What bounds it: integer ALU work (a handful of adds and maxes per DP
// cell) and latency: each of a rect's 8 columns per step depends on the
// one before, each column carries a max-plus prefix scan down a block of up
// to 8192 rows, and each step's decision depends on the last column.
// Bytes are not the limit: a pair reads its codes and writes 8 or 16 bytes.
//
// What the design does about it:
// * one thread block per pair, 4 warps (8 from max_size 4096), and each
//   pair runs its own step loop until it freezes or x-drop ends it;
// * the block state lives in shared memory, not registers: a block of
//   8192 rows would need 256 registers a lane per border in a warp.  Every
//   DP value is the reference's i16 (relative to ZERO = 2^14, saturating at
//   both rails), so the borders are stored as i16 losslessly: the active
//   column (D, C), the passive border (D, R) and the two checkpoint
//   borders take 8 x max_size x 2 bytes, and two staging planes of a
//   column (D before its vertical gaps, the scan within a warp) 4 x
//   max_size bytes; 160 KB at 8192, sized at launch;
// * per-step work tracks the current block size sz: a step of a rect of
//   height h gives each warp NA = max(1, h / (32 W)) slots of 32 rows,
//   the warps in order (warp w holds rows [32 NA w, 32 NA (w + 1))), and
//   warps past h idle at the barriers.  Row r sits in lane r % 32, so its
//   16-residue class (the x-drop tracker's) is lane % 16 in every layout;
// * the column's vertical-gap scan R[p] = max_{q <= p} (v[q] + e (p - q))
//   runs in three levels: a warp shuffle scan of each slot, the slots of a
//   warp chained through lane 31, and the warps chained through shared
//   memory after one barrier a column (a segment ending in t composes with
//   the carry c before it as max(t_local, c + e (loc + 1))).  It equals
//   the reference's saturating chunked scan: every candidate below the i16
//   rail loses to the zero correction e ((row % 8) + 1);
// * the passive border shifts by 8 rows a step and a shrink halves the
//   block by moving its rows: both only move a plane's base (each plane
//   is a ring of max_size rows), and a swap of the borders only swaps
//   which planes are active; a checkpoint save or restore copies the
//   block's rows, and a restore resets the bases;
// * scores come from the table in shared memory by both codes, so a
//   restore only moves the anchor; the TPU's code-keyed score fetch, which
//   needs a symmetric table, does not exist here;
// * the pair's scalar state is replicated in every thread, which takes the
//   same decisions from the same shared values;
// * x-drop is a template flag.  Each column folds a warp's rows into one
//   key per residue, value * (max_size / 16) + chunk (|key| < 2^25 at
//   8192), kept in shared memory, and the step's end folds the 8 columns
//   into each thread's tracker of its residue.
// * trace stages a row's word in shared memory (4 bytes a row more, 192 KB
//   at 8192 in all) and writes it once at the step's end, coalesced.
// * the FLAGS instances (BIG_FLAGS) read the modes from a run-time
//   argument.  Byte mode compares the two codes and never reads a table.
//   Local start and free start gaps restart cells at the relative zero of
//   the step's offset, clamp16(ZERO - off), taken after the step's rebase
//   or restore.  Free end gaps run the x-drop tracker's per-column keys
//   without x-drop, for the one residue a decision reads (row qlen's,
//   qlen % 16): a key 2 D + (the row's 16-row chunk reaches past qlen), so
//   the column's max and whether a row past qlen holds it fold in one max.
//   Local start's trace has a second word a row, the 8 zero bits of the
//   row (D == the relative zero), staged as one byte a row (1 byte a row
//   more, 200 KB at 8192 in all) and written after the step's h words.
// * the profile instances (BIG_PROFILE, which also reads the flags) score a
//   query against a table of 8 words a profile position (7 words of biased
//   score bytes by query code, and the gap word open_C | open_R << 8 |
//   close_C << 16; ops/_profile.py), clamping every profile position to
//   rlen + 1, whose word is the all-zero pad (the JAX big kernel's
//   contract), so the table holds the profile's own rows, not rlen +
//   max_size.  A right rect (lanes = query rows, columns = profile
//   positions) stages its 8 entering rows in shared memory once a step
//   (256 bytes), and each row's thread picks its query code's byte; the
//   column's gap costs are the same for every row.  A down rect's lane is a
//   profile position: its thread reads its row's score word by the
//   entering query code and its gap word from global memory, which L1
//   keeps across the step's 8 columns; C and R swap their open costs, and
//   R closes before the merge into D (a right rect closes C).  S gap words
//   are not staged: at 8192 rows local start's trace already takes 200 KB.
//   The vertical-gap scan is the same three levels; only its open term is
//   the row's own, and the warps' carries take each warp's last row's R
//   open and close.  Trace compares D with the gap-closed C and R, as the
//   reference does, and so reproduces its down-to-right hand-off.  Rows
//   read positions by index, so a restore still only moves the anchor.
// Several pairs per block at small sizes, i16x2 arithmetic and the DPX
// instructions are left to later work.

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
constexpr int MAX_WARPS = 8;
constexpr int SUFFIX = STEP / 4;    // shrink suffix rows
constexpr unsigned FULL = 0xffffffffu;
// rect phases; the initial rect is a GROW_R with psz == 0
constexpr int DIR_R = 0, DIR_D = 1, DIR_GD = 2, DIR_GR = 3;

#ifndef BIG_TRACE
// csrc/big_trace.cu builds the trace instances apart.  Their code is
// compiled in by the preprocessor, so that this library's instances compile
// exactly the code they had.
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

#if BIG_PROFILE
// The score of query code `code` in a profile position's row: byte code % 4
// of word code / 4, biased by 128; codes past 27 score -128 (as
// csrc/adaptive_kernel.cu's prof_score).
__device__ __forceinline__ int prof_score(const int* row, int code) {
  const int word = row[min(code >> 2, PROF_WORDS - 1)];
  return code < 4 * (PROF_WORDS - 1) ? ((word >> (8 * (code & 3))) & 255) - 128
                                     : -128;
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

// Warps a block of this max_size runs with, and its shared planes' bytes:
// ten i16 planes of max_size rows, with trace a staged word a row, and with
// local start's trace a staged byte of zero bits a row.
inline int warps_for(int max_size) { return max_size >= 4096 ? 8 : 4; }
inline size_t plane_bytes(int max_size, int flags) {
  return (size_t)max_size *
         (10 * sizeof(short) + (BIG_TRACE ? sizeof(unsigned) : 0) +
          (BIG_TRACE && (flags & LOCAL_START) ? 1 : 0));
}

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

// Checkpoint save of rows [0, sz): the column borders (D, C) and row
// borders (D, R) of the rect just completed; `ro` says whether its lanes
// were the query.  Row r is copied by thread r % T, as in the restore.
__device__ __forceinline__ void save_ckpt(Planes& P, short* const* ck,
                                          bool ro, int sz, int tid, int T) {
  for (int r = tid; r < sz; r += T) {
    ck[0][r] = ro ? P.at(P.aD(), r) : P.at(P.pD(), r);
    ck[1][r] = ro ? P.at(P.aC(), r) : P.at(P.pR(), r);
    ck[2][r] = ro ? P.at(P.pD(), r) : P.at(P.aD(), r);
    ck[3][r] = ro ? P.at(P.pR(), r) : P.at(P.aC(), r);
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

template <bool XDROP>
__global__ void __launch_bounds__(MAX_WARPS * 32)
big_align_kernel(const uint8_t* __restrict__ codes,
                 const int* __restrict__ qlen, const int* __restrict__ rlen,
                 const int* __restrict__ table, int* __restrict__ out, int cap,
                 int alpha, int S, int min_size, int max_steps, int gopen,
                 int gext,
                 int xdrop BIG_TRACE_PARAMS BIG_FLAGS_PARAMS BIG_PROFILE_PARAMS) {
  extern __shared__ short planes[];
#if BIG_PROFILE
  // a right rect's 8 entering profile rows
  __shared__ int prow[STEP * PROF_WORDS];
  // a warp's last row: its D plus R open, and its close cost
  __shared__ int wdo[2][MAX_WARPS], wcl[2][MAX_WARPS];
#else
  __shared__ int tab[MAX_ALPHA * MAX_ALPHA];
#endif
  __shared__ int wagg[2][MAX_WARPS];  // a warp's scan at its last row
  __shared__ int wdp[2][MAX_WARPS];   // ... and D before the scan there
  __shared__ int red[MAX_WARPS];      // the warps' rect maxima
  __shared__ int tailD[STEP], tailR[STEP];  // a shift's bottom cells
  // tracker keys (x-drop, and free end gaps in the FLAGS instances)
  __shared__ int wkey[XDROP || BIG_FLAGS ? STEP : 1][MAX_WARPS][16];
  __shared__ int score;  // global mode: the frozen cell's score

  const int T = blockDim.x, W = T >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
#if BIG_PROFILE
  // the modes (no byte mode); the pair's query codes (cap) and profile
  // words (prof_cap, 8), every profile position clamped to rlen + 1
  const bool local = flags & LOCAL_START, fstart = flags & FREE_START;
  const bool fend = flags & FREE_END;
  for (int k = tid; k < 8 * S; k += T) planes[k] = 0;
  if (tid == 0) score = 0;
  const uint8_t* qs = codes + (size_t)b * cap;
  const int* pw = table + (size_t)b * prof_cap * PROF_WORDS;
  const int ql = qlen[b], rl = rlen[b];
  const int pmax = min(rl + 1, prof_cap - 1);
#else
#if BIG_FLAGS
  // the modes; byte mode has no table
  const bool local = flags & LOCAL_START, fstart = flags & FREE_START;
  const bool fend = flags & FREE_END, byte = flags & BYTE_MODE;
  if (!byte)
    for (int k = tid; k < alpha * alpha; k += T) tab[k] = table[k];
#else
  for (int k = tid; k < alpha * alpha; k += T) tab[k] = table[k];
#endif
  for (int k = tid; k < 8 * S; k += T) planes[k] = 0;
  if (tid == 0) score = 0;
  const uint8_t* qs = codes + (size_t)b * 2 * cap;
  const uint8_t* rs = qs + cap;
  const int ql = qlen[b], rl = rlen[b];
#endif
  Planes P{{planes, planes + S, planes + 2 * S, planes + 3 * S},
           {0, 0, 0, 0}, 0, S - 1};
  short* const ck[4] = {planes + 4 * S, planes + 5 * S, planes + 6 * S,
                        planes + 7 * S};
  short* const DP = planes + 8 * S;  // a column's D before its R merge
  short* const TL = planes + 9 * S;  // its scan within the warp
#if BIG_TRACE
  // a row's word of the step's cells, staged by the thread of the row
  unsigned* const WD = reinterpret_cast<unsigned*>(planes + 10 * S);
  // the words written, the steps run, the checkpoint events of the next
  // step's descriptor
  int tpos = 0, nsteps = 0, pend = 0;
#if BIG_FLAGS
  // local start: a row's zero bits, staged by the thread of the row; the
  // words a row writes a step
  uint8_t* const ZB = reinterpret_cast<uint8_t*>(planes + 12 * S);
  const int tw = local ? 2 : 1;
#endif
#endif
  const int chunks = S >> 4, log_ch = __ffs(chunks) - 1;
  const int zc = gext * ((lane & 7) + 1);  // the scan's zero correction
  // the reference's start state (src/scan_block.rs:291-317): a grow from
  // size 0, best 0, a virgin checkpoint at the origin
  Pair m{0, 0, 0, 0, min_size, 0, 0, DIR_GR, DIR_GR, NEG,
         0, 0, 0, 0, 0, 1, false, false, NEG,
         INT_MIN_, 0, 0, INT_MIN_, 0, 0, 0, 0, 0};

  int s = 0;
  for (; s < max_steps && !m.done; ++s) {
#if BIG_TRACE
    // a step whose rows pass the budget stops the pair: an overrun
#if BIG_FLAGS
    if (tpos + tw * (m.dir == DIR_GD ? m.psz : m.sz) > budget) break;
#else
    if (tpos + (m.dir == DIR_GD ? m.psz : m.sz) > budget) break;
#endif
    ++nsteps;
#endif
    __syncthreads();  // the previous step's reads are done
    const bool shift = m.dir == DIR_R || m.dir == DIR_D;
    const bool right_or = m.dir == DIR_R || m.dir == DIR_GR;  // lanes = query
    const int sz = m.sz;
    if (m.rest) {
      // a grow starts down-oriented from the checkpoint's borders
      P.a = 0;
      P.base[0] = P.base[1] = P.base[2] = P.base[3] = 0;
      for (int r = tid; r < sz; r += T) {
        P.p[0][r] = ck[2][r];
        P.p[2][r] = ck[3][r];
        P.p[1][r] = ck[0][r];
        P.p[3][r] = ck[1][r];
      }
      m.rest = false;
    }
    int cvec = NEG;
    if (shift) {
      // offset rebase (reference: src/scan_block.rs:148-151) of both
      // borders: the passive one is not read before the step's end, where
      // the reference rebases it
      const int oa = min(max(m.off - m.offmax, NEG), POS);
      m.off = m.offmax;
      for (int r = tid; r < sz; r += T)
#pragma unroll
        for (int q = 0; q < 4; ++q) P.at(q, r) = (short)sat2(P.at(q, r) + oa);
      if ((m.dir == DIR_R && m.pdir == DIR_D) ||
          (m.dir == DIR_D && m.pdir == DIR_R))
        cvec = sat2(m.corn + oa);
    }
#if BIG_FLAGS
    // the relative zero of the step's (rebased or restored) offset, and
    // whether free start gaps re-seed row 0 (a right rect at query row 0)
    const int rz = min(max(ZERO - m.off, NEG), POS);
    const bool ins0 = fstart && right_or && m.I == 0;
#endif
    // the rect maximum restarts with each rect; GROW_R continues GROW_D's
    if (m.cpos == 0 && m.dir != DIR_GR) m.dmax = NEG;
    const int h = m.dir == DIR_GD ? m.psz : sz;  // rect height
    const int ls = right_or ? m.I : m.J;         // lane start
    const int cstart = m.dir == DIR_R   ? m.J + sz - STEP
                       : m.dir == DIR_D ? m.I + sz - STEP
                                        : (m.dir == DIR_GD ? m.I : m.J) +
                                              m.psz + m.cpos;
    const int lane_len = right_or ? ql : rl;
    const int col_len = right_or ? rl : ql;
    // freeze predicate: never inside GROW_D
    const bool fra = ls + h > lane_len && m.dir != DIR_GD;
    const int frt = col_len - cstart;
    const int fridx = min(max(lane_len - ls, 0), S - 1);
    const bool origin = m.dir == DIR_GR && m.psz == 0 && m.cpos == 0 && m.J == 0;
#if BIG_TRACE
    if (tid == 0) {
      int* d = tdesc + ((size_t)s * gridDim.x + b) * 5;
      d[0] = (right_or ? F_RIGHT : 0) | (m.cpos == 0 ? F_START : 0) | pend;
      d[1] = ls;
      d[2] = cstart;
      d[3] = h;
      d[4] = tpos;
    }
    pend = 0;
#endif
#if BIG_PROFILE
    // a right rect's entering profile rows, for every thread of the block
    if (right_or && tid < STEP * PROF_WORDS)
      prow[tid] = pw[(size_t)min(cstart + tid / PROF_WORDS, pmax) * PROF_WORDS +
                     tid % PROF_WORDS];
#else
    const uint8_t* lseq = right_or ? qs : rs;
    const uint8_t* cseq = right_or ? rs : qs;
#endif
    const int cpos_new = m.cpos + STEP;
    const bool phase_done = cpos_new >= (shift ? STEP : sz - m.psz);
    // this step's layout: NA slots of 32 rows a warp, the warps in order
    const int NA = max(1, h / (32 * W));
    const int rows_w = 32 * NA, r0 = warp * rows_w;
    const bool active = r0 < h;
    const int nwarps = min(W, (h + rows_w - 1) / rows_w);
    __syncthreads();  // the restored or rebased borders are visible
    // the diagonal into the warp's first row: the corner, or the row above
    int diag_in = NEG;
    if (active && lane == 0) diag_in = warp == 0 ? cvec : P.at(P.aD(), r0 - 1);
    // a shift's next corner: row 7 of its rebased passive border
    const int corn_next = shift ? P.at(P.pD(), STEP - 1) : m.corn;

    bool frozen = false;
    for (int w = 0; w < STEP; ++w) {
      const int par = w & 1;
#if BIG_PROFILE
      // a down rect's column: its query code
      const int cc = qs[min(cstart + w, cap - 1)];
#elif BIG_FLAGS
      const int cc = min((int)cseq[min(cstart + w, cap - 1)], alpha - 1);
      const int* trow = tab + (byte ? 0 : cc * alpha);
#else
      const int* trow =
          tab + min((int)cseq[min(cstart + w, cap - 1)], alpha - 1) * alpha;
#endif
      if (active) {
        // pass 1: D before the vertical gaps, C, and the scan of D + (open
        // - extend) within the warp's rows
        int up_last = diag_in, tcar = FAR, t = 0, d = 0;
#if BIG_PROFILE
        int dov = 0, clv = 0;  // the row's D plus R open, its close cost
#endif
        for (int k = 0; k < NA; ++k) {
          const int r = r0 + k * 32 + lane;
          const int dold = P.at(P.aD(), r), cold = P.at(P.aC(), r);
          // the diagonal: row r - 1 of the previous column
          int up = __shfl_up_sync(FULL, dold, 1);
          if (lane == 0) up = up_last;
          up_last = __shfl_sync(FULL, dold, 31);
#if BIG_PROFILE
          // a right rect's row scores its query code in the entering row; a
          // down rect's row, a profile position, the entering query code in
          // its own row
          const int* row = right_or
                               ? prow + w * PROF_WORDS
                               : pw + (size_t)min(ls + r, pmax) * PROF_WORDS;
          const ProfGaps g(row[PROF_WORDS - 1], right_or, gext);
          d = sat2(up + prof_score(
                            row, right_or ? (int)qs[min(ls + r, cap - 1)] : cc));
          if (origin && w == 0 && r == 0) d = ZERO;  // the DP origin
          if (local) d = max(d, rz);
          else if (ins0 && r == 0) d = rz;
          // a right rect closes C before the merge; C stays pre-close
          const int c = max(sat2(cold + gext), sat2(dold + g.copen));
          d = max(d, right_or ? sat2(c + g.close) : c);
          t = dov = sat2(d + g.dopen);
          clv = g.close;
#else
          const int lc = min((int)lseq[min(ls + r, cap - 1)], alpha - 1);
#if BIG_FLAGS
          // byte mode compares the codes; the flags restart cells at the
          // relative zero
          d = sat2(up + (byte ? (lc == cc ? bmatch : bmismatch) : trow[lc]));
          if (origin && w == 0 && r == 0) d = ZERO;  // the DP origin
          if (local) d = max(d, rz);
          else if (ins0 && r == 0) d = rz;
#else
          d = sat2(up + trow[lc]);
          if (origin && w == 0 && r == 0) d = ZERO;  // the DP origin
#endif
          const int c = max(sat(cold + gext), sat(dold + gopen));
          d = max(d, c);
          t = d + (gopen - gext);
#endif
#pragma unroll
          for (int dd = 1; dd < 32; dd <<= 1) {
            const int o = __shfl_up_sync(FULL, t, dd);
            if (lane >= dd) t = max(t, o + gext * dd);
          }
          t = max(t, tcar + gext * (lane + 1));
          tcar = __shfl_sync(FULL, t, 31);
          P.at(P.aC(), r) = (short)c;
          DP[r] = (short)d;
          // below the rail a scan value loses to the zero correction
          TL[r] = (short)max(t, NEG);
        }
        if (lane == 31) {
          wagg[par][warp] = t;
          wdp[par][warp] = d;
#if BIG_PROFILE
          wdo[par][warp] = dov;
          wcl[par][warp] = clv;
#endif
        }
      }
      __syncthreads();  // the warps' scans are visible
      if (active) {
        // pass 2: the carry of the warps above, R, and the final D
        int cw = FAR;
        for (int v = 0; v < warp; ++v) cw = max(wagg[par][v], cw + gext * rows_w);
        int key = INT_MIN_;
#if BIG_TRACE
        // the R-open bit (R == D + open - extend) of the row above the
        // warp's first row, 0 above row 0; its R is max(cw, its zero
        // correction e * 8)
#if BIG_PROFILE
        int rup = warp == 0 ? 0 : max(cw, gext * STEP) == wdo[par][warp - 1];
#else
        int rup = warp == 0 ? 0
                            : max(cw, gext * STEP) ==
                                  wdp[par][warp - 1] + gopen - gext;
#endif
#endif
        for (int k = 0; k < NA; ++k) {
          const int r = r0 + k * 32 + lane;
          const int R =
              max(max((int)TL[r], cw + gext * (k * 32 + lane + 1)), zc);
#if BIG_PROFILE
          // the row's gap costs again: a down rect closes R before the merge
          const int* row = right_or
                               ? prow + w * PROF_WORDS
                               : pw + (size_t)min(ls + r, pmax) * PROF_WORDS;
          const ProfGaps g(row[PROF_WORDS - 1], right_or, gext);
          const int re = right_or ? R : sat2(R + g.close);
          const int D = max((int)DP[r], re);
#else
          const int D = max((int)DP[r], R);
#endif
#if BIG_TRACE
          {
            // t = (D == C) | (D == R) << 1, t2 = (C == C_open) | R bit << 1
            // with the R bit of the row above
            const int c = P.at(P.aC(), r);
#if BIG_PROFILE
            // profile: D against the gap-closed C and R
            const int ropen = R == sat2(DP[r] + g.dopen);
            int rin = __shfl_up_sync(FULL, ropen, 1);
            if (lane == 0) rin = rup;
            rup = __shfl_sync(FULL, ropen, 31);
            const unsigned nib = (D == (right_or ? sat2(c + g.close) : c)) |
                                 (D == re) << 1 |
                                 (c == sat2(P.at(P.aD(), r) + g.copen)) << 2 |
                                 rin << 3;
#else
            const int ropen = R == DP[r] + gopen - gext;
            int rin = __shfl_up_sync(FULL, ropen, 1);
            if (lane == 0) rin = rup;
            rup = __shfl_sync(FULL, ropen, 31);
            const unsigned nib = (D == c) | (D == R) << 1 |
                                 (c == sat(P.at(P.aD(), r) + gopen)) << 2 |
                                 rin << 3;
#endif
            WD[r] = (w == 0 ? 0u : WD[r]) | nib << (4 * w);
#if BIG_FLAGS
            // local start: the cell restarted at the relative zero
            if (local)
              ZB[r] = (uint8_t)((w == 0 ? 0 : ZB[r]) | (D == rz) << w);
#endif
          }
#endif
          P.at(P.aD(), r) = (short)D;
          if (r < h) {
            m.dmax = max(m.dmax, D);
#if BIG_FLAGS
            if constexpr (XDROP) key = max(key, D * chunks + (r >> 4));
            // free end gaps: D, and whether the row's chunk reaches past
            // qlen
            else if (fend)
              key = max(key, 2 * D + (ls + 16 * (r >> 4) + 16 > ql));
#else
            if constexpr (XDROP) key = max(key, D * chunks + (r >> 4));
#endif
            if (r == h - 1) {
              // the rect's bottom cells: staged for a shift, written into
              // the passive border at row psz + cpos + w for a grow half
              if (shift) {
                tailD[w] = D;
                tailR[w] = R;
              } else {
                P.at(P.pD(), m.psz + m.cpos + w) = (short)D;
                P.at(P.pR(), m.psz + m.cpos + w) = (short)R;
              }
            }
#if BIG_FLAGS
            if (!XDROP && !fend && fra && w >= frt && r == fridx)
#else
            if (!XDROP && fra && w >= frt && r == fridx)
#endif
              score = m.off + D - ZERO;
          }
        }
        // the next column's diagonal into the warp's first row: the final
        // D of the row above it, whose R is the carry cw
#if BIG_PROFILE
        if (warp > 0) {
          // a down rect's row above closes its R before the merge
          const int ra = max(cw, gext * STEP);
          diag_in = max(wdp[par][warp - 1],
                        right_or ? ra : sat2(ra + wcl[par][warp - 1]));
        } else {
          diag_in = NEG;
        }
#else
        diag_in = warp == 0 ? NEG
                            : max(wdp[par][warp - 1], max(cw, gext * STEP));
#endif
#if BIG_FLAGS
        if (XDROP || fend) {
#else
        if constexpr (XDROP) {
#endif
          // the residue's max over the warp's rows: lanes l and l ^ 16
          key = max(key, __shfl_xor_sync(FULL, key, 16));
          if (lane < 16) wkey[w][warp][lane] = key;
        }
      }
#if BIG_FLAGS
      if (!XDROP && !fend && fra && w >= frt) {
#else
      if (!XDROP && fra && w >= frt) {
#endif
        // freeze: the rect covering (qlen, rlen) reached the last column
        frozen = true;
        break;
      }
    }
#if BIG_TRACE
    // the step's words, each written once by the thread that staged it
    if (active)
      for (int k = 0; k < NA; ++k) {
        const int r = r0 + k * 32 + lane;
        if (r < h) twords[(size_t)b * budget + tpos + r] = (int)WD[r];
      }
#if BIG_FLAGS
    // local start: the zero bits follow the step's h words
    if (local && active)
      for (int k = 0; k < NA; ++k) {
        const int r = r0 + k * 32 + lane;
        if (r < h) twords[(size_t)b * budget + tpos + h + r] = (int)ZB[r];
      }
    tpos += tw * h;
#else
    tpos += h;
#endif
#endif
    if (phase_done && m.dir != DIR_GD) {
      // the rect completes: each warp's part of its maximum
      const int v = __reduce_max_sync(FULL, m.dmax);
      if (lane == 0) red[warp] = v;
    }
    __syncthreads();  // the step's cells, bottom cells and keys are visible
    if (frozen) {
      m.done = true;
      break;
    }
    if constexpr (XDROP) {
      // the 16-residue tracker, column by column: the running max of
      // residue lane % 16, reached last at the highest chunk and the latest
      // column; a column whose max is NEG ties there at the last chunk, as
      // in the plain version, whose rows past the height are NEG
      const int rho = lane & 15;
      for (int w = 0; w < STEP; ++w) {
        int key = INT_MIN_;
        for (int v = 0; v < nwarps; ++v) key = max(key, wkey[w][v][rho]);
        const int cmax = key >> log_ch;
        if (cmax >= m.vm) {
          m.vm = cmax;
          m.ai = ls + 16 * (cmax == NEG ? chunks - 1 : key & (chunks - 1));
          m.aj = cstart + w;
        }
      }
#if BIG_FLAGS
    } else if (fend) {
      // free end gaps: the running max of row qlen's residue, and the
      // latest column where a row of a chunk reaching past qlen equals it;
      // where the max is NEG the rows past the height (NEG in the plain
      // version) equal it too, the last chunk of which reaches past qlen
      // once ls + S does
      const int rho = ql & 15;
      for (int w = 0; w < STEP; ++w) {
        int key = INT_MIN_;
        for (int v = 0; v < nwarps; ++v) key = max(key, wkey[w][v][rho]);
        const int cmax = key >> 1, vmn = max(m.vm, cmax);
        if ((cmax >= m.vm && (key & 1)) || (vmn == NEG && ls + S > ql))
          m.aj = cstart + w;
        m.vm = vmn;
      }
#endif
    }
    if (shift) {
      // a shift's end (reference: src/scan_block.rs:165-177, 349-355): keep
      // row 7 as the next corner, shift the passive border by 8 and splice
      // in the bottom cells
      m.corn = corn_next;
      P.base[P.pD()] += STEP;
      P.base[P.pR()] += STEP;
      if (tid < STEP) {
        P.at(P.pD(), sz - STEP + tid) = (short)tailD[tid];
        P.at(P.pR(), sz - STEP + tid) = (short)tailR[tid];
      }
      __syncthreads();  // the spliced rows are visible
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
    int cur_max = red[0];
    for (int v = 1; v < W; ++v) cur_max = max(cur_max, red[v]);
#if BIG_FLAGS
    // free end gaps: the rect maximum is row qlen's residue's
    if (fend) cur_max = m.vm;
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
    if (save || (was_grow && sz < S)) save_ckpt(P, ck, ro, sz, tid, T);
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
    if (fend) {
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
        save_ckpt(P, ck, ro, half, tid, T);
        ydi = 0;
#if BIG_TRACE
        pend |= F_SAVE;
#endif
      }
      // direction from the first 8 rows of both borders
      // (src/scan_block.rs:560-565)
      int ah = INT_MIN_, ph = INT_MIN_;
      for (int r = 0; r < STEP; ++r) {
        ah = max(ah, (int)P.at(P.aD(), r));
        ph = max(ph, (int)P.at(P.pD(), r));
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
  __syncthreads();  // the frozen cell's score is visible
  if (tid == 0) {
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
    } else if (fend) {
      out[4 * b] = m.best;
      out[4 * b + 1] = m.xbi;
      out[4 * b + 2] = m.xbj;
      out[4 * b + 3] = m.done ? 0 : 1;
#endif
    } else {
      out[2 * b] = score;
      out[2 * b + 1] = m.done ? 0 : 1;
    }
  }
}

template <bool X>
cudaError_t launch(const uint8_t* codes, const int* qlen, const int* rlen,
                   const int* table, int* out, void* words, void* desc,
                   void* steps, void* used, int B, int cap, int alpha,
                   int min_size, int max_size, int max_steps, int gopen,
                   int gext, int xdrop, int budget, int flags, int bmatch,
                   int bmismatch, int prof_cap, cudaStream_t stream) {
  const size_t smem = plane_bytes(max_size, flags);
  cudaError_t err = cudaFuncSetAttribute(
      big_align_kernel<X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  big_align_kernel<X><<<B, warps_for(max_size) * 32, smem, stream>>>(
      codes, qlen, rlen, table, out, cap, alpha, max_size, min_size,
      max_steps, gopen, gext,
      xdrop BIG_TRACE_ARGS BIG_FLAGS_ARGS BIG_PROFILE_ARGS);
  return cudaGetLastError();
}

bool bad_sizes(int min_size, int max_size) {
  return min_size < 16 || (min_size & (min_size - 1)) || max_size < 512 ||
         max_size > 8192 || (max_size & (max_size - 1)) ||
         min_size > max_size || (min_size == max_size && max_size == 512);
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
// lengths (each below prof_cap - 1), and alpha and gopen are not read.  One
// thread block per pair.  Returns the cudaError_t of the launch.
extern "C" int big_align_launch(const void* codes, const void* qlen,
                                const void* rlen, const void* table, void* out,
                                void* words, void* desc, void* steps,
                                void* used, int B, int cap, int alpha,
                                int min_size, int max_size, int max_steps,
                                int gopen, int gext, int x_drop, int budget,
                                int flags, int match, int mismatch,
                                int prof_cap, void* stream) {
  const bool traced = words && desc && steps && used && budget > 0;
  if (B < 1 || cap < 1 || alpha < 1 ||
      ((flags & BYTE_MODE) ? alpha != 256 : alpha > MAX_ALPHA) ||
      bad_sizes(min_size, max_size) || bad_flags(flags, x_drop >= 0) ||
      traced != BIG_TRACE || (!BIG_TRACE && (words || desc || steps || used)) ||
      (prof_cap > 0) != BIG_PROFILE || prof_cap < 0 || prof_cap % 128)
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
                                  mismatch, prof_cap, st)
             : (int)launch<true>(c, q, r, t, o, words, desc, steps, used, B,
                                 cap, alpha, min_size, max_size, max_steps,
                                 gopen, gext, x_drop, budget, flags, match,
                                 mismatch, prof_cap, st);
}

// The launch of a max_size's instance (x-drop if `x_drop`; the trace
// libraries' trace instance, the profile libraries' profile instance;
// `flags` as in big_align_launch): shape[0]
// threads a block, shape[1] bytes of dynamic shared memory, and shape[2]
// blocks resident on an SM of the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int big_launch_shape(int max_size, int x_drop, int flags,
                                int* shape) {
  if (bad_sizes(16, max_size) || bad_flags(flags, x_drop))
    return (int)cudaErrorInvalidValue;
  const size_t smem = plane_bytes(max_size, flags);
  const int threads = warps_for(max_size) * 32;
  auto kernel = x_drop ? big_align_kernel<true> : big_align_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      smem);
  shape[0] = threads;
  shape[1] = (int)smem;
  shape[2] = blocks;
  return (int)err;
}

extern "C" const char* big_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
