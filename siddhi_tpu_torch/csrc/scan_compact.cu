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
//   pass 0 (one-shot heads only): h0[lane] = first head-mask index
//           (block min, one atomicMin per block);
//   pass 1: one block per (1024 of a lane's C * F candidates, lane): live
//           count per tile;
//   pass 2: one block: exclusive scan of the tile counts (the match
//           total lands in meta[0]);
//   pass 3: one block per tile again: block scan of the live bits, rows
//           written at tile offset + rank (rows past M are counted, not
//           written); the first tile of a lane writes its count and its
//           single-arm flag.
// The row sources sit in a device table, so no table width is fixed.
// Event columns are read at lane * ev_stride + i: a fused multi-query
// group's lanes share one row of events (ev_stride 0), and a __qid__ row
// takes the lane's query id (lane_qid[lane], nfa_parallel.py:1146).
// A chain with no count or logical position (alg 0) runs passes 1 and 3
// without candidates (C = 1) and without the count and presence rows.
// Under @app:devicePrecision('f64') (f64 = 1) the float rows of the match
// table are double (FT, the scatter's template parameter): a DOUBLE
// column is copied, a FLOAT one widened (the JAX package's caps_f at f64,
// nfa_parallel.py:1079-1175 in f64 mode).
// Python side: kernels/scan_compact.py.
#include "seg_tree.cuh"

#define CP_THREADS 256
#define CP_ITEMS 4
#define CP_TILE (CP_THREADS * CP_ITEMS)
#define FULL 0xffffffffu
#define UNBOUNDED 1000000000

enum RowKind {
  ROW_COL = 0, ROW_COMP_TS = 1, ROW_COMP_SEQ = 2, ROW_HEAD_SEQ = 3, ROW_QID = 4, ROW_CNT = 5,
  ROW_PRES_BIT = 6, ROW_PRES_CNT = 7, ROW_ONE = 8
};
enum CntMode { CNT_COMP = 0, CNT_Q = 1, CNT_FIXED = 2 };
enum { ARM_NONE = 0, ARM_PENDING = 1, ARM_RESOLVED = 2 };

struct CompactParams {  // layout mirrored by kernels/scan_compact.py _Params
  int L, F, S, M, single, ntiles, n_rows, ev_stride, C, Lt, alg, f64;
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
  int* h0;
  int* tile_off;
  int* lane_cnt;
  int* arm;
  int* meta;
  int* out_i;
  void* out_f;            // float, double when f64
  long long* out_l;
  const void* const* row_col;
  const int* row_vt;
  const int* row_kind;
  const int* row_pos;     // ROW_COL: loc (0 head, r + 1 idx row r)
  const int* row_group;   // 0 out_i, 1 out_f, 2 out_l
  const int* row_index;   // row inside its group
  const int* row_cnt;     // ROW_CNT / ROW_PRES_CNT: the count position
  const int* row_mode;    // ROW_CNT: CntMode
  const int* row_arg;     // CNT_Q offset, CNT_FIXED occurrence, bit, want
};

__device__ __forceinline__ long long plane_of(const CompactParams& p) {
  return static_cast<long long>(p.L) * p.F;
}

// Completion index of candidate c of head j.
__device__ __forceinline__ int comp_of(const CompactParams& p, long long row, int j, int c) {
  return p.idx[p.comp_row[c] * plane_of(p) + row + j];
}

// Candidate q of a lane (c-major: c = q / F, head j = q % F): live when its
// chain completed, its completion is new to this flush, and, for a
// one-shot head, it is the lane's first head and the arm is not resolved.
template <bool ALG>
__device__ __forceinline__ bool live_at(const CompactParams& p, int lane, int q) {
  if (q >= (ALG ? p.C * p.F : p.F)) return false;
  const int c = ALG ? q / p.F : 0, j = ALG ? q % p.F : q;
  const long long row = static_cast<long long>(lane) * p.F;
  if (!((p.cand[row + j] >> c) & 1)) return false;
  const long long erow = static_cast<long long>(lane) * p.ev_stride;
  if (p.seq[erow + comp_of(p, row, j, c)] <= p.prev[lane]) return false;
  if (p.single) {
    if (j != p.h0[lane]) return false;
    if (p.arm_done != nullptr && p.arm_done[lane] != 0) return false;
  }
  return true;
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

// Exclusive block scan of one int per thread; *total gets the block sum.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sum[CP_THREADS / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < CP_THREADS / 32 ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < CP_THREADS / 32) warp_sum[lane] = s;
  }
  __syncthreads();
  const int before = w > 0 ? warp_sum[w - 1] : 0;
  *total = warp_sum[CP_THREADS / 32 - 1];
  __syncthreads();
  return before + x - v;
}

__global__ void h0_kernel(const __grid_constant__ CompactParams p) {
  __shared__ int best;
  const int lane = static_cast<int>(blockIdx.x / p.ntiles);
  const int base = static_cast<int>(blockIdx.x % p.ntiles) * CP_TILE;
  if (threadIdx.x == 0) best = p.F;
  __syncthreads();
  const long long row = static_cast<long long>(lane) * p.F;
  for (int k = 0; k < CP_ITEMS; ++k) {
    const int j = base + threadIdx.x * CP_ITEMS + k;
    if (j < p.F && (p.status[row + j] & 4)) {
      atomicMin(&best, j);
      break;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && best < p.F) atomicMin(&p.h0[lane], best);
}

template <bool ALG>
__global__ void count_kernel(const __grid_constant__ CompactParams p) {
  const int lane = static_cast<int>(blockIdx.x / p.ntiles);
  const int base = static_cast<int>(blockIdx.x % p.ntiles) * CP_TILE;
  int c = 0;
  for (int k = 0; k < CP_ITEMS; ++k)
    c += live_at<ALG>(p, lane, base + threadIdx.x * CP_ITEMS + k) ? 1 : 0;
  int total;
  block_scan(c, &total);
  if (threadIdx.x == 0) p.tile_off[blockIdx.x] = total;
}

// One block: tile counts -> exclusive offsets in place, total at the end.
__global__ void offsets_kernel(const __grid_constant__ CompactParams p) {
  const int n = p.L * p.ntiles;
  int carry = 0;
  for (int base = 0; base < n; base += CP_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < n ? p.tile_off[i] : 0;
    int total;
    const int ex = block_scan(v, &total);
    if (i < n) p.tile_off[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    p.tile_off[n] = carry;
    p.meta[0] = carry;
    p.meta[1] = 0;
  }
}

// A count or presence row of one match (ROW_PRES_BIT, ROW_PRES_CNT,
// ROW_CNT): an `or` side's presence bit, a per-index presence, or a count
// capture at its occurrence by rank/select.
__device__ VmVal count_row(const CompactParams& p, int r, int lane, long long row,
                           long long erow, int j, int c, int comp) {
  switch (p.row_kind[r]) {
    case ROW_PRES_BIT: return vm_i((p.pres[row + j] >> p.row_arg[r]) & 1);
    case ROW_PRES_CNT: {
      int s;
      long long ra, qn;
      count_ctx(p, p.row_cnt[r], row, j, c, comp, s, ra, qn);
      return vm_i(qn >= p.row_arg[r] ? 1 : 0);
    }
    default: {
      int at = comp;
      if (p.row_mode[r] != CNT_COMP) {
        const int pi = p.row_cnt[r];
        int s;
        long long ra, qn;
        count_ctx(p, pi, row, j, c, comp, s, ra, qn);
        const long long want = p.row_mode[r] == CNT_Q ? qn + p.row_arg[r] : p.row_arg[r];
        const long long* heap = p.rank_heap[p.cnt_rank[pi]] +
                                static_cast<long long>(lane) * 2 * p.Lt;
        at = first_hit(heap, VT_I64, p.Lt, s, vm_l(ra + want), TOP_GE);
        at = at < 0 ? 0 : (at > p.F - 1 ? p.F - 1 : at);
      }
      return vm_read(p.row_col[r], p.row_vt[r], erow + at);
    }
  }
}

template <bool ALG, class FT>
__global__ void scatter_kernel(const __grid_constant__ CompactParams p) {
  const int lane = static_cast<int>(blockIdx.x / p.ntiles);
  const int tile = static_cast<int>(blockIdx.x % p.ntiles);
  const int base = tile * CP_TILE;
  const long long row = static_cast<long long>(lane) * p.F;
  const long long erow = static_cast<long long>(lane) * p.ev_stride;
  bool live[CP_ITEMS];
  int cnt = 0;
  for (int k = 0; k < CP_ITEMS; ++k) {
    live[k] = live_at<ALG>(p, lane, base + threadIdx.x * CP_ITEMS + k);
    cnt += live[k] ? 1 : 0;
  }
  int total;
  int pos = p.tile_off[blockIdx.x] + block_scan(cnt, &total);
  const long long plane = plane_of(p);
  for (int k = 0; k < CP_ITEMS; ++k) {
    if (!live[k]) continue;
    const int q = base + threadIdx.x * CP_ITEMS + k;
    const int c = ALG ? q / p.F : 0, j = ALG ? q % p.F : q;
    if (pos < p.M) {
      const int comp = comp_of(p, row, j, c);
      for (int r = 0; r < p.n_rows; ++r) {
        VmVal v;
        switch (p.row_kind[r]) {
          case ROW_COMP_TS: v = vm_i(p.ts[erow + comp]); break;
          case ROW_COMP_SEQ: v = vm_i(p.seq[erow + comp]); break;
          case ROW_HEAD_SEQ: v = vm_i(p.seq[erow + j]); break;
          case ROW_QID: v = vm_i(p.lane_qid[lane]); break;
          case ROW_ONE: v = vm_i(1); break;
          case ROW_PRES_BIT:
          case ROW_PRES_CNT:
          case ROW_CNT:
            v = ALG ? count_row(p, r, lane, row, erow, j, c, comp) : vm_i(0);
            break;
          default: {
            const int at = p.row_pos[r] == 0 ? j
                           : p.idx[(p.row_pos[r] - 1) * plane + row + j];
            v = vm_read(p.row_col[r], p.row_vt[r], erow + at);
          }
        }
        const long long o = static_cast<long long>(p.row_index[r]) * p.M + pos;
        switch (p.row_group[r]) {
          case 0: p.out_i[o] = v.i; break;
          case 1:
            if constexpr (sizeof(FT) == 8)
              static_cast<double*>(p.out_f)[o] = vm_cast(v, p.row_vt[r], VT_F64).d;
            else
              static_cast<float*>(p.out_f)[o] = v.f;
            break;
          default: p.out_l[o] = v.l; break;
        }
      }
    }
    ++pos;
  }
  if (tile == 0 && threadIdx.x == 0) {
    p.lane_cnt[lane] = p.tile_off[(lane + 1) * p.ntiles] - p.tile_off[lane * p.ntiles];
    int flag = ARM_NONE;
    if (p.single) {
      const int h0 = p.h0[lane];
      if (h0 < p.F) flag = (p.status[row + h0] & 3) ? ARM_RESOLVED : ARM_PENDING;
      if (p.arm_done != nullptr && p.arm_done[lane] != 0) flag = ARM_RESOLVED;
    }
    p.arm[lane] = flag;
  }
}

extern "C" int scan_compact_launch(const CompactParams* params, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(params->L) * static_cast<unsigned>(params->ntiles);
  cudaError_t err;
  if (params->single) {
    h0_kernel<<<blocks, CP_THREADS, 0, stream>>>(*params);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (params->alg)
    count_kernel<true><<<blocks, CP_THREADS, 0, stream>>>(*params);
  else
    count_kernel<false><<<blocks, CP_THREADS, 0, stream>>>(*params);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  offsets_kernel<<<1, CP_THREADS, 0, stream>>>(*params);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (params->alg && params->f64)
    scatter_kernel<true, double><<<blocks, CP_THREADS, 0, stream>>>(*params);
  else if (params->alg)
    scatter_kernel<true, float><<<blocks, CP_THREADS, 0, stream>>>(*params);
  else if (params->f64)
    scatter_kernel<false, double><<<blocks, CP_THREADS, 0, stream>>>(*params);
  else
    scatter_kernel<false, float><<<blocks, CP_THREADS, 0, stream>>>(*params);
  return static_cast<int>(cudaGetLastError());
}
