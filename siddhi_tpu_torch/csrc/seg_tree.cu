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
// Trees of Lt <= 1024 leaves (C4: 512; seg_tree_warps): one warp builds
// a (lane, tree), rows of 32 leaves, a leaf a thread, read coalesced
// (validity, stream code, pre-mask word and source element loaded without
// a branch, four rows in flight a thread), written, and reduced by
// shuffles over the row's 5 levels, each level written by the threads
// that hold its nodes; the row roots, one a thread, then go up the
// remaining levels by shuffles too.  No shared memory, no __syncthreads,
// no idle threads but a row's tail when Lt < 32; a block holds 8 such
// warps, grid y the tree, so no search for a warp's tree.  Larger trees
// (C3's flat 2^19 leaves, C5's shared 2^14; seg_tree_blocks): a block a
// (lane, 1024-leaf subtree), a leaf a thread, each warp's row by
// shuffles, the 32 warp roots by the first warp after the block's one
// barrier; then a launch per 10 levels reduces the subtree roots the same
// way (from_heap = 1): C3 and C5 two launches, as before.  Each tree type
// (i32, i64, f32, f64), max/min and source element size runs an
// instantiation of its own, which the warp or block picks once from the
// tree's entry (`build<T, MIN, ESZ>`): no type switch in the build, only
// a conversion of the loaded bits.  A node is reduce(left, right) keeping
// the left child on ties, as seg_tree_plain does, so the heaps' bytes,
// +0.0 and -0.0 included, are the plain version's.  The launcher writes
// its kernel count into the parameter block (`launched`).
//
// A tree has L lanes, or one when the plan marks it shared (`lanes` 1: a
// fused group's tree whose leaves read the group's one row of events and
// no lane parameter, the same in every lane -- C5's timestamp and hop
// trees); such a tree is built once, as lane 0, into a (1, 2 Lt) heap that
// K4 reads at lane stride 0.  The plan builds each distinct tree once
// (core/nfa_parallel.py same_leaves).  The per-tree arrays (sources,
// types, pre-masks, heaps) sit in a device table, so no tree count is
// fixed.  Event columns are read at lane * ev_stride + i: a fused
// multi-query group's lanes share one row of events (ev_stride 0) and
// differ in their pre-masks (lane * F + i).  The `rank` use builds one i64
// max-tree per count position over its occurrence rank column, an (L, F)
// tensor read at lane * F + i (src_stride), gated by the lane's valid
// events only (nfa_parallel.py:845).
// Bound on the H100: bytes -- the leaf columns and masks read once, each
// heap (2 Lt entries) written once.
// Python side: kernels/seg_tree.py.
#include "seg_tree.cuh"

#define ST_SUB 1024   // leaves a warp builds whole; a block's subtree past that
#define ST_WARPS 8    // warps a block, a lane's tree each
#define ST_BATCH 4    // rows of leaf loads a thread keeps in flight
#define ST_FULL 0xffffffffu

struct TreeParams {  // layout mirrored by kernels/seg_tree.py _Params
  int L, F, Lt, n_trees, cnt, from_heap, ev_stride, lane_trees;
  int max_lanes;     // the most lanes of any tree (grid x)
  int launched;      // written by the launcher: its kernel launches
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

// A source column's element as tree type T, converted as vm_cast does.
__device__ __forceinline__ int tree_conv(int x, int) { return x; }
__device__ __forceinline__ int tree_conv(long long x, int) {
  return static_cast<int>(static_cast<unsigned long long>(x));
}
__device__ __forceinline__ int tree_conv(float x, int) { return __float2int_rz(x); }
__device__ __forceinline__ int tree_conv(double x, int) { return __double2int_rz(x); }
__device__ __forceinline__ long long tree_conv(int x, long long) { return static_cast<long long>(x); }
__device__ __forceinline__ long long tree_conv(long long x, long long) { return x; }
__device__ __forceinline__ long long tree_conv(float x, long long) { return __float2ll_rz(x); }
__device__ __forceinline__ long long tree_conv(double x, long long) { return __double2ll_rz(x); }
__device__ __forceinline__ float tree_conv(int x, float) { return __int2float_rn(x); }
__device__ __forceinline__ float tree_conv(long long x, float) { return __ll2float_rn(x); }
__device__ __forceinline__ float tree_conv(float x, float) { return x; }
__device__ __forceinline__ float tree_conv(double x, float) { return __double2float_rn(x); }
__device__ __forceinline__ double tree_conv(int x, double) { return static_cast<double>(x); }
__device__ __forceinline__ double tree_conv(long long x, double) { return __ll2double_rn(x); }
__device__ __forceinline__ double tree_conv(float x, double) { return static_cast<double>(x); }
__device__ __forceinline__ double tree_conv(double x, double) { return x; }

// The storage of a source element of ESZ bytes.
template <int ESZ> struct RawOf;
template <> struct RawOf<1> { typedef unsigned char U; };
template <> struct RawOf<4> { typedef unsigned U; };
template <> struct RawOf<8> { typedef unsigned long long U; };

// A source element (its storage bits; storage type svt) as tree type T,
// converted as vm_cast does; no memory is read here.
template <typename T>
__device__ __forceinline__ T from_raw(unsigned long long raw, int svt) {
  switch (svt) {
    case VT_BOOL: return tree_conv(static_cast<int>((raw & 0xffull) != 0), T());
    case VT_I32: return tree_conv(static_cast<int>(static_cast<unsigned>(raw)), T());
    case VT_I64: return tree_conv(static_cast<long long>(raw), T());
    case VT_F32: return tree_conv(__int_as_float(static_cast<int>(static_cast<unsigned>(raw))), T());
    default: return tree_conv(__longlong_as_double(static_cast<long long>(raw)), T());
  }
}

// Leaf i of `lane`'s tree `tr` in the first pass: the source element, or
// the sentinel where the lane has no event i, the event is of another
// stream, its pre-mask bit is off or the value is NaN.  Its loads take no
// branch (the index clamped into the lane's row, a pointer that would be
// null replaced by one that is not), so a thread keeps several in flight.
// ESZ: the source's element size, 0 for the constant 1 (a mask tree).
template <typename T, bool MIN, int ESZ>
__device__ __forceinline__ T leaf_of(const TreeParams& p, int tr, int lane, long long i) {
  typedef typename RawOf<ESZ == 0 ? 4 : ESZ>::U U;
  const int nsc = p.node_scode[tr];
  const unsigned* pre = p.pre[tr];
  const long long erow = static_cast<long long>(lane) * p.ev_stride;
  const long long crow = static_cast<long long>(lane) * p.F;
  const long long ii = i < p.F ? i : p.F - 1;
  const int sc = (nsc >= 0 ? p.scode : p.nev)[nsc >= 0 ? erow + ii : 0];
  const unsigned pw = (pre != nullptr ? pre : reinterpret_cast<const unsigned*>(p.nev))
      [pre != nullptr ? (crow + ii) >> 5 : 0];
  T x = T(1);
  if (ESZ) {
    const U raw = static_cast<const U*>(p.src[tr])[static_cast<long long>(lane) * p.src_stride[tr] + ii];
    x = from_raw<T>(static_cast<unsigned long long>(raw), p.src_vt[tr]);
  }
  const bool keep = (i < p.F) & (i < p.nev[lane]) & (nsc < 0 || sc == nsc) &
                    (pre == nullptr || ((pw >> ((crow + i) & 31)) & 1u)) &
                    !(x != x);               // x != x: NaN (floats only)
  return keep ? x : TreeT<T>::sentinel(MIN);
}

// One warp: lane `lane`'s tree `tr` of Lt <= ST_SUB leaves, rows of 32, a
// leaf a thread, ST_BATCH rows of loads in flight; each row written and
// reduced by shuffles over its 5 levels, then the row roots, one a
// thread, up the levels above by shuffles too.
template <typename T, bool MIN, int ESZ>
__device__ void build_warp(const TreeParams& p, int tr, int lane) {
  const int t = threadIdx.x & 31;
  const int Lt = p.Lt;
  const int R = Lt >= 32 ? Lt >> 5 : 1;      // rows
  const int rw = Lt >= 32 ? 32 : Lt;         // leaves a row
  const int rl = 31 - __clz(rw);             // levels inside a row
  const T sent = TreeT<T>::sentinel(MIN);
  T* heap = static_cast<T*>(p.heap[tr]) + static_cast<long long>(lane) * 2 * Lt;
  if (t == 0) heap[0] = sent;
  T mine = sent;                              // the root of row t
  for (int r0 = 0; r0 < R; r0 += ST_BATCH) {
    T v[ST_BATCH];
#pragma unroll
    for (int b = 0; b < ST_BATCH; ++b)
      v[b] = leaf_of<T, MIN, ESZ>(p, tr, lane, static_cast<long long>(min(r0 + b, R - 1)) * 32 + t);
#pragma unroll
    for (int b = 0; b < ST_BATCH; ++b) {
      const int r = r0 + b;
      if (r >= R) break;
      const int i = r * 32 + t;
      T x = t < rw ? v[b] : sent;
      if (t < rw) heap[Lt + i] = x;
      for (int h = 1; h <= rl; ++h) {
        const T y = __shfl_down_sync(ST_FULL, x, 1 << (h - 1));
        x = tree_reduce<T, MIN>(x, y);
        if (t < rw && (t & ((1 << h) - 1)) == 0) heap[(Lt >> h) + (i >> h)] = x;
      }
      const T root = __shfl_sync(ST_FULL, x, 0);
      if (t == r) mine = root;
    }
  }
  T x = mine;                                 // the levels above the rows
  for (int h = 1; (1 << h) <= R; ++h) {
    const T y = __shfl_down_sync(ST_FULL, x, 1 << (h - 1));
    x = tree_reduce<T, MIN>(x, y);
    if (t < R && (t & ((1 << h) - 1)) == 0) heap[(Lt >> (rl + h)) + ((t * 32) >> (rl + h))] = x;
  }
}

// One block: subtree `sub` of W = min(p.cnt, ST_SUB) nodes of the level
// of p.cnt nodes (the leaves in the first pass, a level the last pass
// wrote after it), a node a thread: each warp's row by shuffles, the
// warps' roots by the first warp after one barrier.
template <typename T, bool MIN, int ESZ>
__device__ void build_block(const TreeParams& p, int tr, int lane, int sub) {
  const int t = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long cnt = p.cnt;
  const int W = cnt < ST_SUB ? static_cast<int>(cnt) : ST_SUB;
  const int rw = W >= 32 ? 32 : W;
  const int rl = 31 - __clz(rw);
  const int NW = W >= 32 ? W >> 5 : 1;        // warps
  const T sent = TreeT<T>::sentinel(MIN);
  T* heap = static_cast<T*>(p.heap[tr]) + static_cast<long long>(lane) * 2 * p.Lt;
  const long long base = static_cast<long long>(sub) * W;
  const long long i = base + threadIdx.x;
  T x = sent;
  if (threadIdx.x < W) {
    if (p.from_heap) {
      x = heap[cnt + i];
    } else {
      x = leaf_of<T, MIN, ESZ>(p, tr, lane, i);
      heap[cnt + i] = x;
      if (i == 0) heap[0] = sent;
    }
  }
  for (int h = 1; h <= rl; ++h) {
    const T y = __shfl_down_sync(ST_FULL, x, 1 << (h - 1));
    x = tree_reduce<T, MIN>(x, y);
    if (t < rw && (t & ((1 << h) - 1)) == 0) heap[(cnt >> h) + (i >> h)] = x;
  }
  if (NW == 1) return;
  __shared__ unsigned long long roots[ST_SUB / 32];
  if (t == 0) reinterpret_cast<T*>(roots)[wid] = x;
  __syncthreads();
  if (wid != 0) return;
  x = t < NW ? reinterpret_cast<const T*>(roots)[t] : sent;
  for (int h = 1; (1 << h) <= NW; ++h) {
    const T y = __shfl_down_sync(ST_FULL, x, 1 << (h - 1));
    x = tree_reduce<T, MIN>(x, y);
    if (t < NW && (t & ((1 << h) - 1)) == 0)
      heap[(cnt >> (rl + h)) + ((base + static_cast<long long>(t) * 32) >> (rl + h))] = x;
  }
}

// The tree's instantiation: type, max/min and the source's element size
// (0: the constant 1, or a pass over the heap's nodes).
template <bool BLOCK, typename T, bool MIN, int ESZ>
__device__ __forceinline__ void build_as(const TreeParams& p, int tr, int lane, int sub) {
  if constexpr (BLOCK)
    build_block<T, MIN, ESZ>(p, tr, lane, sub);
  else
    build_warp<T, MIN, ESZ>(p, tr, lane);
}

template <bool BLOCK, typename T, bool MIN>
__device__ __forceinline__ void build_sized(const TreeParams& p, int tr, int lane, int sub, int esz) {
  switch (esz) {
    case 8: build_as<BLOCK, T, MIN, 8>(p, tr, lane, sub); break;
    case 4: build_as<BLOCK, T, MIN, 4>(p, tr, lane, sub); break;
    case 1: build_as<BLOCK, T, MIN, 1>(p, tr, lane, sub); break;
    default: build_as<BLOCK, T, MIN, 0>(p, tr, lane, sub); break;
  }
}

template <bool BLOCK>
__device__ __forceinline__ void build_typed(const TreeParams& p, int tr, int lane, int sub) {
  const bool mn = p.agg[tr] != 0;
  const int svt = p.src_vt[tr];
  const int esz = p.from_heap || p.src[tr] == nullptr ? 0
                  : svt == VT_I64 || svt == VT_F64 ? 8 : svt == VT_BOOL ? 1 : 4;
  switch (p.vt[tr]) {
    case VT_I64:
      if (mn) build_sized<BLOCK, long long, true>(p, tr, lane, sub, esz);
      else build_sized<BLOCK, long long, false>(p, tr, lane, sub, esz);
      break;
    case VT_F32:
      if (mn) build_sized<BLOCK, float, true>(p, tr, lane, sub, esz);
      else build_sized<BLOCK, float, false>(p, tr, lane, sub, esz);
      break;
    case VT_F64:
      if (mn) build_sized<BLOCK, double, true>(p, tr, lane, sub, esz);
      else build_sized<BLOCK, double, false>(p, tr, lane, sub, esz);
      break;
    default:
      if (mn) build_sized<BLOCK, int, true>(p, tr, lane, sub, esz);
      else build_sized<BLOCK, int, false>(p, tr, lane, sub, esz);
      break;
  }
}

// Trees of Lt <= ST_SUB leaves: a warp a (lane, tree), ST_WARPS a block,
// grid y the tree.
__global__ void __launch_bounds__(ST_WARPS * 32) seg_tree_warps(const __grid_constant__ TreeParams p) {
  const int tr = static_cast<int>(blockIdx.y);
  const long long w = static_cast<long long>(blockIdx.x) * ST_WARPS + (threadIdx.x >> 5);
  if (w >= p.lanes[tr]) return;                // whole warps
  build_typed<false>(p, tr, static_cast<int>(w), 0);
}

// Larger trees, and every pass over a level of their nodes: a block a
// (lane, subtree of up to ST_SUB nodes), grid y the tree.
__global__ void __launch_bounds__(ST_SUB) seg_tree_blocks(const __grid_constant__ TreeParams p) {
  const int tr = static_cast<int>(blockIdx.y);
  const int subs = p.cnt > ST_SUB ? static_cast<int>(p.cnt / ST_SUB) : 1;
  const int lane = static_cast<int>(blockIdx.x / subs);
  if (lane >= p.lanes[tr]) return;             // the whole block
  build_typed<true>(p, tr, lane, static_cast<int>(blockIdx.x % subs));
}

extern "C" int seg_tree_launch(TreeParams* params, cudaStream_t stream) {
  TreeParams p = *params;
  p.cnt = p.Lt;
  p.from_heap = 0;
  params->launched = 0;
  while (true) {
    const int W = p.cnt < ST_SUB ? p.cnt : ST_SUB;
    if (p.Lt <= ST_SUB) {
      const dim3 grid(static_cast<unsigned>((p.max_lanes + ST_WARPS - 1) / ST_WARPS),
                      static_cast<unsigned>(p.n_trees));
      seg_tree_warps<<<grid, ST_WARPS * 32, 0, stream>>>(p);
    } else {
      const dim3 grid(static_cast<unsigned>(static_cast<long long>(p.max_lanes) * (p.cnt / W)),
                      static_cast<unsigned>(p.n_trees));
      seg_tree_blocks<<<grid, W < 32 ? 32 : W, 0, stream>>>(p);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    params->launched += 1;
    if (p.cnt <= ST_SUB) break;
    p.cnt /= ST_SUB;
    p.from_heap = 1;
  }
  return 0;
}
