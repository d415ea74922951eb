// K5 scan_compact: dedup and compaction of one `scan` block's completions
// into the NFAKernel's match table.
//
// Replaces the emission tail of siddhi_tpu/core/nfa_parallel.py
// _block_impl: the candidates of each head (one, or C for a final count,
// :1009-1027), the dedup of replayed completions (:1031, seq[comp] >
// prev_seq per lane), the single-arm filter and flag (:1034-1053), the
// exclusive prefix count and scatter into M rows (:1056-1072) and the
// gathers of the captured columns and presence rows (:1079-1154): single
// positions and logical sides at the indices K4 resolved, count captures
// by rank/select at the match (a `ge` first-hit on the count's rank tree:
// [last] at occurrence q, [last-1] at q - 1, [i] at i + 1, each present
// when q reaches it, q = min + c for a final count, else the rank at the
// completion less the base, capped at max), vmapped there over the lane
// axis.  Here the lanes are compacted into ONE table, lane-major, each
// lane's rows c-major and in head order (the order of the JAX cumsum
// over its (C, F) candidates), so the plan reads it exactly like the
// sequential kernel's.
//
// One launch.  A lane's C * F candidates (q = c * F + j) fall in tiles of
// CP_TILE; each block takes the next (lane, tile) from a ticket, so the
// tiles run in table order.  A thread takes candidates base + k * 256 +
// t (k < 4: a warp's 32 byte loads of a candidate row fall in one
// sector) and runs the live test once, keeping the result in registers;
// a warp writes the rows of its live candidates of one k together, its
// lanes over (row, candidate) pairs, so each row's writes fall on
// consecutive slots.  A one-shot
// head first needs h0, the lane's first head: each tile publishes the
// first head among its c = 0 candidates and takes the minimum over the
// lane's earlier tiles from a decoupled look-back (look_back.cuh; exact for the live
// test: every j below the tile's own is covered by an earlier tile of c
// = 0).  The tile's live count, per (k, warp) from ballots, then takes
// its first match slot from a second look-back over every earlier tile
// of the table (the match total is the last tile's inclusive prefix, in
// meta[0]).  Rows past M are counted, not written.  A lane's last tile
// writes its count (its inclusive prefix less the previous lane's last
// one) and its single-arm flag from the lane's h0.  The look-back state
// (ticket, two words a tile) is the prepared launch's own; the launcher
// zeroes it with a memset before each launch (a CUDA graph's replays
// too), so the kernel leaves it as it is.
// The row sources are decoded once per kernel on the host
// (kernels/scan_compact.py); each block stages the first CP_ROWS of them
// in shared memory.
// Event columns are read at lane * ev_stride + i: a fused multi-query
// group's lanes share one row of events (ev_stride 0), and a __qid__ row
// takes the lane's query id (lane_qid[lane], nfa_parallel.py:1146).
// A chain with no count or logical position (alg 0) runs without
// candidates (C = 1) and without the count and presence rows.
// Under @app:devicePrecision('f64') (f64 = 1) the float rows of the match
// table are double (FT, the kernel's template parameter): a DOUBLE
// column is copied, a FLOAT one widened (the JAX package's caps_f at f64,
// nfa_parallel.py:1079-1175 in f64 mode).
// Python side: kernels/scan_compact.py.
#include "look_back.cuh"
#include "seg_tree.cuh"

#define CP_THREADS 256
#define CP_WARPS (CP_THREADS / 32)
#define CP_ITEMS 4
#define CP_TILE (CP_THREADS * CP_ITEMS)
#define CP_ROWS 64  // row sources staged in shared memory; the rest read from the table
#define FULL 0xffffffffu
#define UNBOUNDED 1000000000

enum RowKind {
  ROW_COL = 0, ROW_COMP_TS = 1, ROW_COMP_SEQ = 2, ROW_HEAD_SEQ = 3, ROW_QID = 4, ROW_CNT = 5,
  ROW_PRES_BIT = 6, ROW_PRES_CNT = 7, ROW_ONE = 8
};
enum CntMode { CNT_COMP = 0, CNT_Q = 1, CNT_FIXED = 2 };
enum { ARM_NONE = 0, ARM_PENDING = 1, ARM_RESOLVED = 2 };

struct RowSrc {  // one match-table row; layout mirrored by kernels/scan_compact.py ROW
  const void* col;  // ROW_COL / ROW_CNT: the event column
  int vt;
  int kind;
  int pos;    // ROW_COL: loc (0 head, r + 1 idx row r)
  int group;  // 0 out_i, 1 out_f, 2 out_l
  int index;  // row inside its group
  int cnt;    // ROW_CNT / ROW_PRES_CNT: the count position
  int mode;   // ROW_CNT: CntMode
  int arg;    // CNT_Q offset, CNT_FIXED occurrence, bit, want
};

struct CompactParams {  // layout mirrored by kernels/scan_compact.py _Params
  int L, F, S, M, single, ntiles, n_rows, ev_stride, C, Lt, alg, f64;
  int launched;           // out: kernels the last call launched
  const int* seq;
  const int* ts;
  const int* prev;
  const int* arm_done;
  const int* lane_qid;
  const unsigned char* status;
  const int* idx;
  const unsigned char* cand;
  const int* pres;
  const int* comp_row;
  const long long* const* rank;       // (L, F) per count position
  const long long* const* rank_heap;  // (L, 2 Lt) per count position
  const int* cnt_rank;    // per position: its rank column, -1 none
  const int* cnt_min;
  const int* cnt_max;
  const int* cnt_entry;   // loc of the entry event, -1 for a count head
  unsigned long long* state;  // ticket, L * ntiles count words, L * ntiles
                              // h0 words; zeroed by the launcher
  int* lane_cnt;
  int* arm;
  int* meta;
  int* out_i;
  void* out_f;            // float, double when f64
  long long* out_l;
  const RowSrc* rows;
};

__device__ __forceinline__ long long plane_of(const CompactParams& p) {
  return static_cast<long long>(p.L) * p.F;
}

// Completion index of candidate c of head j.
__device__ __forceinline__ int comp_of(const CompactParams& p, long long row, int j, int c) {
  return p.idx[p.comp_row[c] * plane_of(p) + row + j];
}

// The count at position pi for one match: its start s, rank base ra and
// the occurrences q the match collected (min + c for a final count, the
// rank at the completion less ra, capped at max, elsewhere).
__device__ void count_ctx(const CompactParams& p, int pi, long long row, int j, int c, int comp,
                          int& s, long long& ra, long long& q) {
  const long long* rk = p.rank[p.cnt_rank[pi]] + row;
  const int e = p.cnt_entry[pi];
  if (e < 0) {
    s = j;
    ra = rk[j] - 1;
  } else {
    const int ent = e == 0 ? j : p.idx[(e - 1) * plane_of(p) + row + j];
    s = ent + 1;
    ra = rk[ent];
  }
  if (pi == p.S - 1) {
    q = p.cnt_min[pi] + c;
  } else {
    q = rk[comp] - ra;
    if (p.cnt_max[pi] < UNBOUNDED && q > p.cnt_max[pi]) q = p.cnt_max[pi];
  }
}

// A count or presence row of one match (ROW_PRES_BIT, ROW_PRES_CNT,
// ROW_CNT): an `or` side's presence bit, a per-index presence, or a count
// capture at its occurrence by rank/select.
__device__ VmVal count_row(const CompactParams& p, const RowSrc& rs, int lane, long long row,
                           long long erow, int j, int c, int comp) {
  switch (rs.kind) {
    case ROW_PRES_BIT: return vm_i((p.pres[row + j] >> rs.arg) & 1);
    case ROW_PRES_CNT: {
      int s;
      long long ra, qn;
      count_ctx(p, rs.cnt, row, j, c, comp, s, ra, qn);
      return vm_i(qn >= rs.arg ? 1 : 0);
    }
    default: {
      int at = comp;
      if (rs.mode != CNT_COMP) {
        const int pi = rs.cnt;
        int s;
        long long ra, qn;
        count_ctx(p, pi, row, j, c, comp, s, ra, qn);
        const long long want = rs.mode == CNT_Q ? qn + rs.arg : rs.arg;
        const long long* heap = p.rank_heap[p.cnt_rank[pi]] +
                                static_cast<long long>(lane) * 2 * p.Lt;
        at = first_hit(heap, VT_I64, 31 - __clz(p.Lt), p.Lt, s, vm_l(ra + want), TOP_GE);
        at = at < 0 ? 0 : (at > p.F - 1 ? p.F - 1 : at);
      }
      return vm_read(rs.col, rs.vt, erow + at);
    }
  }
}

template <bool ALG, class FT>
__global__ void __launch_bounds__(CP_THREADS, 8) compact_kernel(const __grid_constant__ CompactParams p) {
  __shared__ RowSrc srows[CP_ROWS];
  __shared__ int slice[CP_ITEMS][CP_WARPS];  // live counts per (k, warp), then their offsets
  __shared__ int wq[CP_WARPS][32], wcomp[CP_WARPS][32];  // a warp's live candidates
  __shared__ int s_g, s_h0, s_base;
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_g = static_cast<int>(atomicAdd(p.state, 1ull));
  const int staged = p.n_rows < CP_ROWS ? p.n_rows : CP_ROWS;
  for (int r = threadIdx.x; r < staged; r += CP_THREADS) srows[r] = p.rows[r];
  if (threadIdx.x == 0) s_h0 = p.F;
  __syncthreads();
  const int g = s_g, lane = g / p.ntiles, tile = g - lane * p.ntiles;
  const int g0 = lane * p.ntiles;  // the lane's first tile
  const int base = tile * CP_TILE;
  const int nq = ALG ? p.C * p.F : p.F;
  const long long row = static_cast<long long>(lane) * p.F;
  const long long erow = static_cast<long long>(lane) * p.ev_stride;
  const long long ntot = static_cast<long long>(p.L) * p.ntiles;
  unsigned long long* cwords = p.state + 1;
  unsigned long long* hwords = cwords + ntot;
  if (p.single) {  // the first head among the lane's c = 0 candidates through this tile
    int own = p.F;
#pragma unroll
    for (int k = 0; k < CP_ITEMS; ++k) {
      const int q = base + k * CP_THREADS + threadIdx.x;
      if (q < p.F && (p.status[row + q] & 4)) own = min(own, q);
    }
    own = __reduce_min_sync(FULL, own);
    if (l == 0) atomicMin(&s_h0, own);
    __syncthreads();
    if (w == 0) {
      const int mine = s_h0;
      const long long before = look_back<true>(hwords, g, g0, mine, p.F);
      if (l == 0) s_h0 = static_cast<int>(before < mine ? before : mine);
    }
    __syncthreads();
  }
  const int h0 = s_h0;
  const bool done = p.single && p.arm_done != nullptr && p.arm_done[lane] != 0;
  // the live test, once a candidate: the candidate bits and completion
  // indices of the four candidates loaded together, then their seqs
  bool live[CP_ITEMS];
  int comp[CP_ITEMS], rk[CP_ITEMS];
  unsigned bal[CP_ITEMS];
  unsigned char cb[CP_ITEMS];
  const int prev = p.prev[lane];
#pragma unroll
  for (int k = 0; k < CP_ITEMS; ++k) {
    const int q = base + k * CP_THREADS + threadIdx.x;
    cb[k] = 0;
    comp[k] = 0;
    if (q < nq) {
      const int c = ALG ? q / p.F : 0, j = ALG ? q - c * p.F : q;
      cb[k] = static_cast<unsigned char>((p.cand[row + j] >> c) & 1);
      comp[k] = comp_of(p, row, j, c);
    }
  }
#pragma unroll
  for (int k = 0; k < CP_ITEMS; ++k) {
    const int q = base + k * CP_THREADS + threadIdx.x;
    const int j = ALG ? q - (q / p.F) * p.F : q;
    live[k] = cb[k] && p.seq[erow + comp[k]] > prev && (!p.single || (j == h0 && !done));
    bal[k] = __ballot_sync(FULL, live[k]);
    rk[k] = __popc(bal[k] & ((1u << l) - 1u));
    if (l == 0) slice[k][w] = __popc(bal[k]);
  }
  __syncthreads();
  if (w == 0) {  // offsets in (k, warp) order; the tile's first slot from the look-back
    const int v = slice[l / CP_WARPS][l % CP_WARPS];
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, o);
      if (l >= o) inc += y;
    }
    slice[l / CP_WARPS][l % CP_WARPS] = inc - v;
    const int total = __shfl_sync(FULL, inc, 31);
    const long long before = look_back<false>(cwords, g, 0, total, 0);
    if (l == 0) {
      s_base = static_cast<int>(before);
      const long long incl = before + total;
      if (tile == p.ntiles - 1) {  // the lane's last tile: its count and flag
        long long start = 0;
        if (g0 > 0) {
          unsigned long long x;
          do {
            x = lb_get(cwords + g0 - 1);
          } while ((x >> 62) != 2);
          start = static_cast<long long>(x & LB_VAL);
        }
        p.lane_cnt[lane] = static_cast<int>(incl - start);
        int flag = ARM_NONE;
        if (p.single) {
          if (h0 < p.F) flag = (p.status[row + h0] & 3) ? ARM_RESOLVED : ARM_PENDING;
          if (done) flag = ARM_RESOLVED;
        }
        p.arm[lane] = flag;
      }
      if (g == ntot - 1) {
        p.meta[0] = static_cast<int>(incl);
        p.meta[1] = 0;
      }
    }
  }
  __syncthreads();
  // the rows: a warp's live candidates of one k in its shared list, then
  // its lanes take (row, candidate) pairs row by row, so a row's writes
  // fall on consecutive slots and a lane gathers one value a round
  const long long plane = plane_of(p);
#pragma unroll
  for (int k = 0; k < CP_ITEMS; ++k) {
    const int cnt = __popc(bal[k]);
    if (cnt == 0) continue;
    if (live[k]) {
      wq[w][rk[k]] = base + k * CP_THREADS + threadIdx.x;
      wcomp[w][rk[k]] = comp[k];
    }
    __syncwarp();
    const int first = s_base + slice[k][w];
    for (int t = l; t < cnt * p.n_rows; t += 32) {
      const int r = t / cnt, i = t - r * cnt;
      const int pos = first + i;
      if (pos >= p.M) continue;
      const int q = wq[w][i], cmp = wcomp[w][i];
      const int c = ALG ? q / p.F : 0, j = ALG ? q - c * p.F : q;
      const RowSrc& rs = r < CP_ROWS ? srows[r] : p.rows[r];
      VmVal v;
      switch (rs.kind) {
        case ROW_COMP_TS: v = vm_i(p.ts[erow + cmp]); break;
        case ROW_COMP_SEQ: v = vm_i(p.seq[erow + cmp]); break;
        case ROW_HEAD_SEQ: v = vm_i(p.seq[erow + j]); break;
        case ROW_QID: v = vm_i(p.lane_qid[lane]); break;
        case ROW_ONE: v = vm_i(1); break;
        case ROW_PRES_BIT:
        case ROW_PRES_CNT:
        case ROW_CNT:
          v = ALG ? count_row(p, rs, lane, row, erow, j, c, cmp) : vm_i(0);
          break;
        default: {
          const int at = rs.pos == 0 ? j : p.idx[(rs.pos - 1) * plane + row + j];
          v = vm_read(rs.col, rs.vt, erow + at);
        }
      }
      const long long o = static_cast<long long>(rs.index) * p.M + pos;
      switch (rs.group) {
        case 0: p.out_i[o] = v.i; break;
        case 1:
          if constexpr (sizeof(FT) == 8)
            static_cast<double*>(p.out_f)[o] = vm_cast(v, rs.vt, VT_F64).d;
          else
            static_cast<float*>(p.out_f)[o] = v.f;
          break;
        default: p.out_l[o] = v.l; break;
      }
    }
    __syncwarp();
  }
}

extern "C" int scan_compact_launch(CompactParams* params, cudaStream_t stream) {
  const CompactParams& p = *params;
  const long long blocks = static_cast<long long>(p.L) * p.ntiles;
  params->launched = 0;
  if (p.L < 1 || p.ntiles < 1 || blocks > 0x7fffffffLL || p.state == nullptr ||
      static_cast<long long>(p.ntiles) * CP_TILE < (p.alg ? static_cast<long long>(p.C) * p.F : p.F))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(p.state, 0, sizeof(unsigned long long) * (1 + 2 * blocks), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (p.alg && p.f64)
    compact_kernel<true, double><<<grid, CP_THREADS, 0, stream>>>(p);
  else if (p.alg)
    compact_kernel<true, float><<<grid, CP_THREADS, 0, stream>>>(p);
  else if (p.f64)
    compact_kernel<false, double><<<grid, CP_THREADS, 0, stream>>>(p);
  else
    compact_kernel<false, float><<<grid, CP_THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  params->launched = 1;
  return 0;
}
