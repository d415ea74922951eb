// K8 win_compact: stable compaction of the rows a mask keeps to the front.
//
// Replaces `compact` of siddhi_tpu/core/window_device.py (:803-807; used
// at :835-838): an i32 cumsum of the filter mask and one scatter per
// column, pads filled with a per-column value (the timestamp pad 2^62,
// zeros), and k = the number of kept rows.  The mask arrives as K1's
// ballot words (bit j of word w = row 32w+j); without one, rows 0..n-1
// are kept.  Rows >= n are never kept.  The window plan also compacts its
// output rows with it (the `emit & having` mask of K1's window_select use).
//
// Three passes, 1024 rows per block (256 threads x 4 rows, word popcounts
// when the mask is given): per-block kept counts; one block's exclusive
// scan of them (k lands in k_out); the block scan and scatter of every
// column, where each thread also writes the pad into its own slots >= k.
// JAX's scatter drops the pads at index T (mode="drop"); here no pad is
// ever scattered.  Bound on the H100: bytes -- the mask words and the n
// rows of each column read once, each T-slot output written once.
// Python side: kernels/win_compact.py.
#include "expr_vm.cuh"
#include "win_scan.cuh"

struct CompactParams {  // layout mirrored by kernels/win_compact.py _Params
  long long n, T;
  int n_cols, nblocks;
  const unsigned* mask;     // ceil(n / 32) words, or null: keep rows < n
  int* blk;                 // nblocks: kept counts, then exclusive offsets
  int* k_out;               // 1: the number of kept rows
  const void* const* in;
  void* const* out;
  const int* vt;
  const long long* fill;    // raw 64-bit pad value per column
};

__device__ __forceinline__ bool kept(const CompactParams& p, long long r) {
  if (r >= p.n) return false;
  if (p.mask == nullptr) return true;
  return (p.mask[r >> 5] >> (r & 31)) & 1u;
}

__global__ void count_kernel(const __grid_constant__ CompactParams p) {
  const long long base = static_cast<long long>(blockIdx.x) * WS_TILE + threadIdx.x * WS_ITEMS;
  long long c = 0;
  for (int k = 0; k < WS_ITEMS; ++k) c += kept(p, base + k);
  Seg<SumI> total;
  block_seg_scan<SumI>(Seg<SumI>{false, c}, &total);
  if (threadIdx.x == 0) p.blk[blockIdx.x] = static_cast<int>(total.v);
}

__global__ void offsets_kernel(const __grid_constant__ CompactParams p) {
  long long run = 0;
  for (int base = 0; base < p.nblocks; base += WS_THREADS) {
    const int j = base + threadIdx.x;
    const long long v = j < p.nblocks ? p.blk[j] : 0;
    Seg<SumI> total;
    const Seg<SumI> ex = block_seg_scan<SumI>(Seg<SumI>{false, v}, &total);
    if (j < p.nblocks) p.blk[j] = static_cast<int>(run + ex.v);
    run += total.v;
  }
  if (threadIdx.x == 0) *p.k_out = static_cast<int>(run);
}

__global__ void scatter_kernel(const __grid_constant__ CompactParams p) {
  const long long base = static_cast<long long>(blockIdx.x) * WS_TILE + threadIdx.x * WS_ITEMS;
  bool live[WS_ITEMS];
  long long c = 0;
  for (int k = 0; k < WS_ITEMS; ++k) {
    live[k] = kept(p, base + k);
    c += live[k];
  }
  Seg<SumI> total;
  const Seg<SumI> ex = block_seg_scan<SumI>(Seg<SumI>{false, c}, &total);
  long long pos = (p.nblocks > 1 ? p.blk[blockIdx.x] : 0) + ex.v;
  const long long k_all = p.nblocks > 1 ? *p.k_out : total.v;
  for (int k = 0; k < WS_ITEMS; ++k) {
    const long long r = base + k;
    if (live[k]) {
      for (int col = 0; col < p.n_cols; ++col)
        vm_write(p.out[col], p.vt[col], pos, vm_read(p.in[col], p.vt[col], r));
      ++pos;
    }
    if (r >= k_all && r < p.T) {
      for (int col = 0; col < p.n_cols; ++col)
        vm_write(p.out[col], p.vt[col], r, vm_const(p.fill[col], p.vt[col]));
    }
  }
  if (p.nblocks == 1 && blockIdx.x == 0 && threadIdx.x == 0) *p.k_out = static_cast<int>(total.v);
}

extern "C" int win_compact_launch(const CompactParams* params, cudaStream_t stream) {
  const CompactParams& p = *params;
  cudaError_t err;
  const unsigned blocks = static_cast<unsigned>(p.nblocks);
  if (blocks > 1) {
    count_kernel<<<blocks, WS_THREADS, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    offsets_kernel<<<1, WS_THREADS, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  scatter_kernel<<<blocks, WS_THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
