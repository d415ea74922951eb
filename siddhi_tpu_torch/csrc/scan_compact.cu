// K5 scan_compact: dedup and compaction of one `scan` block's completions
// into the NFAKernel's match table.
//
// Replaces the emission tail of siddhi_tpu/core/nfa_parallel.py
// _block_impl: the dedup of replayed completions (:1031, seq[comp] >
// prev_seq per lane), the single-arm filter and flag (:1034-1053), the
// exclusive prefix count and scatter into M rows (:1056-1072) and the
// gathers of the captured columns (:1079-1137, single positions), vmapped
// there over the lane axis.  Here the lanes are compacted into ONE table,
// lane-major, each lane's rows in head order (the order of the JAX
// cumsum), so the plan reads it exactly like the sequential kernel's.
//   pass 0 (one-shot heads only): h0[lane] = first head-mask index
//           (block min, one atomicMin per block);
//   pass 1: one block per (1024 candidates, lane): live count per tile;
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
// Python side: kernels/scan_compact.py.
#include "expr_vm.cuh"

#define CP_THREADS 256
#define CP_ITEMS 4
#define CP_TILE (CP_THREADS * CP_ITEMS)
#define FULL 0xffffffffu

enum RowKind { ROW_COL = 0, ROW_COMP_TS = 1, ROW_COMP_SEQ = 2, ROW_HEAD_SEQ = 3, ROW_QID = 4 };
enum { ARM_NONE = 0, ARM_PENDING = 1, ARM_RESOLVED = 2 };

struct CompactParams {  // layout mirrored by kernels/scan_compact.py _Params
  int L, F, S, M, single, ntiles, n_rows, ev_stride;
  const int* seq;
  const int* ts;
  const int* prev;
  const int* arm_done;
  const int* lane_qid;
  const unsigned char* status;
  const int* idx;
  int* h0;
  int* tile_off;
  int* lane_cnt;
  int* arm;
  int* meta;
  int* out_i;
  float* out_f;
  long long* out_l;
  const void* const* row_col;
  const int* row_vt;
  const int* row_kind;
  const int* row_pos;
  const int* row_group;   // 0 out_i, 1 out_f, 2 out_l
  const int* row_index;   // row inside its group
};

__device__ __forceinline__ int comp_of(const CompactParams& p, long long row, int j) {
  const long long plane = static_cast<long long>(p.L) * p.F;
  return p.idx[(p.S - 2) * plane + row + j];
}

__device__ __forceinline__ bool live_at(const CompactParams& p, int lane, int j) {
  if (j >= p.F) return false;
  const long long row = static_cast<long long>(lane) * p.F;
  if (!(p.status[row + j] & 1)) return false;
  const long long erow = static_cast<long long>(lane) * p.ev_stride;
  if (p.seq[erow + comp_of(p, row, j)] <= p.prev[lane]) return false;
  if (p.single) {
    if (j != p.h0[lane]) return false;
    if (p.arm_done != nullptr && p.arm_done[lane] != 0) return false;
  }
  return true;
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

__global__ void count_kernel(const __grid_constant__ CompactParams p) {
  const int lane = static_cast<int>(blockIdx.x / p.ntiles);
  const int base = static_cast<int>(blockIdx.x % p.ntiles) * CP_TILE;
  int c = 0;
  for (int k = 0; k < CP_ITEMS; ++k)
    c += live_at(p, lane, base + threadIdx.x * CP_ITEMS + k) ? 1 : 0;
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

__global__ void scatter_kernel(const __grid_constant__ CompactParams p) {
  const int lane = static_cast<int>(blockIdx.x / p.ntiles);
  const int tile = static_cast<int>(blockIdx.x % p.ntiles);
  const int base = tile * CP_TILE;
  const long long row = static_cast<long long>(lane) * p.F;
  const long long erow = static_cast<long long>(lane) * p.ev_stride;
  bool live[CP_ITEMS];
  int c = 0;
  for (int k = 0; k < CP_ITEMS; ++k) {
    live[k] = live_at(p, lane, base + threadIdx.x * CP_ITEMS + k);
    c += live[k] ? 1 : 0;
  }
  int total;
  int pos = p.tile_off[blockIdx.x] + block_scan(c, &total);
  const long long plane = static_cast<long long>(p.L) * p.F;
  for (int k = 0; k < CP_ITEMS; ++k) {
    if (!live[k]) continue;
    const int j = base + threadIdx.x * CP_ITEMS + k;
    if (pos < p.M) {
      const int comp = comp_of(p, row, j);
      for (int r = 0; r < p.n_rows; ++r) {
        VmVal v;
        switch (p.row_kind[r]) {
          case ROW_COMP_TS: v = vm_i(p.ts[erow + comp]); break;
          case ROW_COMP_SEQ: v = vm_i(p.seq[erow + comp]); break;
          case ROW_HEAD_SEQ: v = vm_i(p.seq[erow + j]); break;
          case ROW_QID: v = vm_i(p.lane_qid[lane]); break;
          default: {
            const int at = p.row_pos[r] == 0 ? j
                           : p.idx[(p.row_pos[r] - 1) * plane + row + j];
            v = vm_read(p.row_col[r], p.row_vt[r], erow + at);
          }
        }
        const long long o = static_cast<long long>(p.row_index[r]) * p.M + pos;
        switch (p.row_group[r]) {
          case 0: p.out_i[o] = v.i; break;
          case 1: p.out_f[o] = v.f; break;
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
  count_kernel<<<blocks, CP_THREADS, 0, stream>>>(*params);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  offsets_kernel<<<1, CP_THREADS, 0, stream>>>(*params);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<blocks, CP_THREADS, 0, stream>>>(*params);
  return static_cast<int>(cudaGetLastError());
}
