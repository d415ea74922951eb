// K3 seg_tree: the segment trees of one `scan` block, every lane and
// every tree of the block in each launch.
//
// Replaces _build_heap (siddhi_tpu/core/nfa_parallel.py:499) as called by
// _block_impl for the `within` killer's timestamp max-tree (i64) and the
// threshold hops' trees (max for > and >=, min for < and <=, in the
// promoted type), and _next_static_scan (:580), whose next pointers become
// a first-hit on a max-tree of the static hop's node mask.  A leaf holds
// the sentinel where the lane has no event (j >= nev), the event belongs
// to another stream, its pre-conjuncts fail, or its value is NaN.
//
// Pass 1 (from_heap = 0): one 1024-thread block per (1024 leaves, lane,
// tree; grid x = leaf blocks x the trees' lanes, tree by tree) computes
// its leaves, writes them, and reduces them level by level in shared
// memory, writing every level to the heap up to the block's subtree root.
// A tree has L lanes, or one when the plan marks it shared (`lanes` 1:
// a fused group's tree whose leaves read the group's one row of events
// and no lane parameter, the same in every lane -- C5's timestamp and
// hop trees); such a tree is built once, as lane 0, into a (1, 2 Lt) heap
// that K4 reads at lane stride 0, so a C5 group's trees take 0.5 MB,
// which L2 holds, instead of 250 copies.  Later passes (from_heap = 1)
// treat a level of `cnt` nodes already in the heap as leaves and do the
// same, until the root.
// The per-tree arrays (sources, types, pre-masks, heaps) sit in a device
// table, so no tree count is fixed.  Event columns are read at lane *
// ev_stride + i: a fused multi-query group's lanes share one row of
// events (ev_stride 0) and differ in their pre-masks (lane * F + i).
// The `rank` use builds one i64 max-tree per count position over its
// occurrence rank column, an (L, F) tensor read at lane * F + i
// (src_stride), gated by the lane's valid events only
// (nfa_parallel.py:845).
// Python side: kernels/seg_tree.py.
#include "seg_tree.cuh"

#define ST_SUB 1024

struct TreeParams {  // layout mirrored by kernels/seg_tree.py _Params
  int L, F, Lt, n_trees, cnt, from_heap, ev_stride, lane_trees;
  const int* nev;
  const int* scode;
  const void* const* src;
  const int* src_vt;
  const int* vt;
  const int* agg;
  const unsigned* const* pre;
  const int* node_scode;
  void* const* heap;
  const int* src_stride;  // per tree: ev_stride for an event column, F
                          // for a per-lane column (a rank column)
  const int* lanes;       // per tree: L, or 1 for a shared tree;
                          // lane_trees is their sum
};

__device__ __forceinline__ bool tree_isnan(int vt, VmVal v) {
  if (vt == VT_F32) return v.f != v.f;
  if (vt == VT_F64) return v.d != v.d;
  return false;
}

__global__ void seg_tree_kernel(const __grid_constant__ TreeParams p) {
  __shared__ VmVal sh[ST_SUB];
  const int t = threadIdx.x;
  const int n = p.cnt < ST_SUB ? p.cnt : ST_SUB;   // leaves of this block
  const int nblocks = p.cnt / n;                   // blocks per lane
  const int b = static_cast<int>(blockIdx.x % nblocks);
  int lane = static_cast<int>(blockIdx.x / nblocks);   // over every tree's lanes
  int tr = 0;
  while (lane >= p.lanes[tr]) lane -= p.lanes[tr++];
  const int vt = p.vt[tr];
  const int agg_min = p.agg[tr];
  void* heap = static_cast<char*>(p.heap[tr]) +
               static_cast<long long>(lane) * 2 * p.Lt * (vt == VT_I64 || vt == VT_F64 ? 8 : 4);
  if (t < n) {
    const int i = b * n + t;                    // node index inside its level
    VmVal v;
    if (p.from_heap) {
      v = vm_read(heap, vt, p.cnt + i);
    } else {
      const VmVal sent = tree_sentinel(vt, agg_min);
      const long long cell = static_cast<long long>(lane) * p.F + i;
      const long long ecell = static_cast<long long>(lane) * p.ev_stride + i;
      bool keep = i < p.F && i < p.nev[lane];
      if (keep && p.node_scode[tr] >= 0) keep = p.scode[ecell] == p.node_scode[tr];
      if (keep && p.pre[tr] != nullptr) keep = (p.pre[tr][cell >> 5] >> (cell & 31)) & 1u;
      if (keep) {
        if (p.src[tr] != nullptr) {
          const int svt = p.src_vt[tr];
          const long long scell = static_cast<long long>(lane) * p.src_stride[tr] + i;
          v = vm_cast(vm_read(p.src[tr], svt, scell), svt, vt);
          if (tree_isnan(vt, v)) keep = false;
        } else {
          v = vm_cast(vm_i(1), VT_I32, vt);
        }
      }
      if (!keep) v = sent;
      tree_store(heap, vt, p.Lt + i, v);
      if (b == 0 && t == 0) tree_store(heap, vt, 0, sent);
    }
    sh[t] = v;
  }
  __syncthreads();
  for (int w = n; w > 1; w >>= 1) {
    const int h = w >> 1;
    VmVal r;
    if (t < h) r = tree_reduce(vt, agg_min, sh[2 * t], sh[2 * t + 1]);
    __syncthreads();
    if (t < h) {
      sh[t] = r;
      // the level holding nblocks * h nodes starts at heap slot nblocks * h
      tree_store(heap, vt, static_cast<long long>(nblocks) * h + static_cast<long long>(b) * h + t, r);
    }
    __syncthreads();
  }
}

extern "C" int seg_tree_launch(const TreeParams* params, cudaStream_t stream) {
  TreeParams p = *params;
  p.cnt = p.Lt;
  p.from_heap = 0;
  while (true) {
    const int n = p.cnt < ST_SUB ? p.cnt : ST_SUB;
    const unsigned grid = static_cast<unsigned>(p.cnt / n) * static_cast<unsigned>(p.lane_trees);
    seg_tree_kernel<<<grid, ST_SUB, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (p.cnt <= ST_SUB) break;
    p.cnt /= ST_SUB;
    p.from_heap = 1;
  }
  return 0;
}
