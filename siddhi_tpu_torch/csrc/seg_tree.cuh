// Segment-tree device functions shared by seg_tree.cu (K3), scan_chase.cu
// (K4) and scan_compact.cu (K5).
//
// A tree is a perfect binary tree in heap layout per lane: slot 0 unused,
// root at 1, leaves at [Lt, 2Lt), Lt = 2^P >= 2.  Values are one of the VM
// types of expr_vm.cuh (i32, i64, f32, f64); K3 builds each type in an
// instantiation of its own (TreeT).  first_hit() is the descent of
// siddhi_tpu/core/nfa_parallel.py _first_hit (:523): the first leaf >= s
// whose value beats v (`>` or `<`), Lt when none; `>=` and `<=` become
// strict compares against the adjacent representable value (nextafter for
// floats, -1/+1 for integers), so a sentinel leaf never satisfies them.
// The descent reads the lane's heap in device memory through the read-only
// cache (a lane's heaps stay in L1/L2 between its heads' descents) and
// takes four levels at once on the way up and two a step on the way down
// (first_hit_t); K4 and K5 share it.
#pragma once
#include "expr_vm.cuh"

enum TreeOp { TOP_GT = 0, TOP_GE = 1, TOP_LT = 2, TOP_LE = 3 };

// A tree type's sentinel, the value a leaf holds when its mask is off
// (outside every value: the lowest for a max-tree, the highest for a
// min-tree).
template <typename T> struct TreeT;
template <> struct TreeT<int> {
  static __device__ __forceinline__ int sentinel(bool mn) { return mn ? 0x7fffffff : (-0x7fffffff - 1); }
};
template <> struct TreeT<long long> {
  static __device__ __forceinline__ long long sentinel(bool mn) {
    return mn ? 0x7fffffffffffffffll : (-0x7fffffffffffffffll - 1);
  }
};
template <> struct TreeT<float> {
  static __device__ __forceinline__ float sentinel(bool mn) {
    return mn ? __int_as_float(0x7f800000) : __int_as_float(0xff800000);
  }
};
template <> struct TreeT<double> {
  static __device__ __forceinline__ double sentinel(bool mn) {
    return mn ? __longlong_as_double(0x7ff0000000000000ll)
              : __longlong_as_double(static_cast<long long>(0xfff0000000000000ull));
  }
};

// A node of max (MIN false) or min trees: reduce(left, right) keeps the
// left child unless the right one is strictly better, so ties (+0.0 and
// -0.0 too) keep the left, as seg_tree_plain does; no NaN ever reaches
// here.
template <typename T, bool MIN>
__device__ __forceinline__ T tree_reduce(T a, T b) {
  return (MIN ? (b < a) : (b > a)) ? b : a;
}

template <typename T>
__device__ __forceinline__ bool tree_beats(T a, T v, bool gt) {
  return gt ? (a > v) : (a < v);
}

// The descent.  Up: the nodes it visits depend on s alone, so four levels'
// nodes are loaded together and the first that hits taken.  Down: the
// left child and both children's left children are loaded together, two
// levels a step.  Dependent loads: about log2(Lt) / 4 + log2(Lt) / 2, not
// 2 log2(Lt); the same nodes chosen as one level at a time.
template <typename T>
__device__ int first_hit_t(const T* heap, int P, int Lt, int s, T v, bool gt) {
  int l = (s < 0 ? 0 : (s > Lt ? Lt : s)) + Lt;
  int fnode = 0;                       // 0: none yet (nodes are >= 1)
  for (int i0 = 0; i0 <= P && fnode == 0; i0 += 4) {
    int at[4];
    bool cand[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool odd = (l & 1) != 0;
      at[k] = l;
      cand[k] = i0 + k <= P && odd && l < ((2 * Lt) >> (i0 + k));
      l = (l + (odd ? 1 : 0)) >> 1;
    }
    T x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = __ldg(heap + (cand[k] ? at[k] : 1));
#pragma unroll
    for (int k = 3; k >= 0; --k)
      if (cand[k] && tree_beats(x[k], v, gt)) fnode = at[k];
  }
  if (fnode == 0) return Lt;
  while (fnode < Lt) {
    const int c = 2 * fnode;
    if (c >= Lt) {                     // the children are leaves
      fnode = tree_beats(__ldg(heap + c), v, gt) ? c : c + 1;
      break;
    }
    const T left = __ldg(heap + c);
    const T ll = __ldg(heap + 2 * c);
    const T rl = __ldg(heap + 2 * c + 2);
    fnode = tree_beats(left, v, gt) ? (tree_beats(ll, v, gt) ? 2 * c : 2 * c + 1)
                                    : (tree_beats(rl, v, gt) ? 2 * c + 2 : 2 * c + 3);
  }
  return fnode - Lt;
}

// First leaf >= s of one lane's heap whose value satisfies `op` against v
// (v already in the tree's type `vt`); P = log2(Lt).
__device__ __forceinline__ int first_hit(const void* heap, int vt, int P, int Lt, int s, VmVal v,
                                         int op) {
  const bool gt = (op == TOP_GT || op == TOP_GE);
  switch (vt) {
    case VT_F32: {
      float x = v.f;
      if (op == TOP_GE) x = nextafterf(x, __int_as_float(0xff800000));
      if (op == TOP_LE) x = nextafterf(x, __int_as_float(0x7f800000));
      return first_hit_t(static_cast<const float*>(heap), P, Lt, s, x, gt);
    }
    case VT_F64: {
      double x = v.d;
      if (op == TOP_GE) x = nextafter(x, __longlong_as_double(static_cast<long long>(0xfff0000000000000ull)));
      if (op == TOP_LE) x = nextafter(x, __longlong_as_double(0x7ff0000000000000ll));
      return first_hit_t(static_cast<const double*>(heap), P, Lt, s, x, gt);
    }
    case VT_I64: {
      unsigned long long x = static_cast<unsigned long long>(v.l);
      if (op == TOP_GE) x -= 1ull;
      if (op == TOP_LE) x += 1ull;
      return first_hit_t(static_cast<const long long*>(heap), P, Lt, s, static_cast<long long>(x), gt);
    }
    default: {
      unsigned x = static_cast<unsigned>(v.i);
      if (op == TOP_GE) x -= 1u;
      if (op == TOP_LE) x += 1u;
      return first_hit_t(static_cast<const int*>(heap), P, Lt, s, static_cast<int>(x), gt);
    }
  }
}

