// Segment-tree device functions shared by seg_tree.cu (K3) and
// scan_chase.cu (K4).
//
// A tree is a perfect binary tree in heap layout per lane: slot 0 unused,
// root at 1, leaves at [Lt, 2Lt), Lt a power of two >= 2.  Values are one
// of the VM types of expr_vm.cuh (i32, i64, f32, f64), held in a VmVal
// while a tree is built.  first_hit() is the descent of
// siddhi_tpu/core/nfa_parallel.py _first_hit (:523): the first leaf >= s
// whose value beats v (`>` or `<`), Lt when none; `>=` and `<=` become
// strict compares against the adjacent representable value (nextafter for
// floats, -1/+1 for integers), so a sentinel leaf never satisfies them.
#pragma once
#include "expr_vm.cuh"

enum TreeOp { TOP_GT = 0, TOP_GE = 1, TOP_LT = 2, TOP_LE = 3 };

// The value a leaf holds when its mask is off: outside every value.
__device__ __forceinline__ VmVal tree_sentinel(int vt, int agg_min) {
  switch (vt) {
    case VT_I64: return vm_l(agg_min ? 0x7fffffffffffffffll : (-0x7fffffffffffffffll - 1));
    case VT_F32: return vm_f(agg_min ? __int_as_float(0x7f800000) : __int_as_float(0xff800000));
    case VT_F64:
      return vm_d(agg_min ? __longlong_as_double(0x7ff0000000000000ll)
                          : __longlong_as_double(static_cast<long long>(0xfff0000000000000ull)));
    default: return vm_i(agg_min ? 0x7fffffff : (-0x7fffffff - 1));
  }
}

// max (agg_min == 0) or min of two tree values; no NaN ever reaches here.
__device__ __forceinline__ VmVal tree_reduce(int vt, int agg_min, VmVal a, VmVal b) {
  bool take_b;
  switch (vt) {
    case VT_I64: take_b = agg_min ? (b.l < a.l) : (b.l > a.l); break;
    case VT_F32: take_b = agg_min ? (b.f < a.f) : (b.f > a.f); break;
    case VT_F64: take_b = agg_min ? (b.d < a.d) : (b.d > a.d); break;
    default: take_b = agg_min ? (b.i < a.i) : (b.i > a.i); break;
  }
  return take_b ? b : a;
}

__device__ __forceinline__ void tree_store(void* heap, int vt, long long i, VmVal v) {
  vm_write(heap, vt, i, v);
}

template <typename T>
__device__ __forceinline__ bool tree_beats(T a, T v, bool gt) {
  return gt ? (a > v) : (a < v);
}

template <typename T>
__device__ int first_hit_t(const T* heap, int Lt, int s, T v, bool gt) {
  int P = 0;
  while ((1 << (P + 1)) <= Lt) ++P;  // log2(Lt)
  int l = (s < 0 ? 0 : (s > Lt ? Lt : s)) + Lt;
  bool found = false;
  int fnode = 0;
  for (int i = 0; i <= P; ++i) {
    const int r = (2 * Lt) >> i;
    const bool odd = (l & 1) != 0;
    if (odd && l < r && tree_beats(heap[l], v, gt)) {
      found = true;
      fnode = l;
      break;
    }
    l = (l + (odd ? 1 : 0)) >> 1;
  }
  if (!found) return Lt;
  while (fnode < Lt) {
    const int left = 2 * fnode;
    fnode = tree_beats(heap[left], v, gt) ? left : left + 1;
  }
  return fnode - Lt;
}

// First leaf >= s of one lane's heap (heap + lane offset) whose value
// satisfies `op` against v (v already in the tree's type `vt`).
__device__ __forceinline__ int first_hit(const void* heap, int vt, int Lt, int s, VmVal v, int op) {
  const bool gt = (op == TOP_GT || op == TOP_GE);
  switch (vt) {
    case VT_F32: {
      float x = v.f;
      if (op == TOP_GE) x = nextafterf(x, __int_as_float(0xff800000));
      if (op == TOP_LE) x = nextafterf(x, __int_as_float(0x7f800000));
      return first_hit_t(static_cast<const float*>(heap), Lt, s, x, gt);
    }
    case VT_F64: {
      double x = v.d;
      if (op == TOP_GE) x = nextafter(x, __longlong_as_double(static_cast<long long>(0xfff0000000000000ull)));
      if (op == TOP_LE) x = nextafter(x, __longlong_as_double(0x7ff0000000000000ll));
      return first_hit_t(static_cast<const double*>(heap), Lt, s, x, gt);
    }
    case VT_I64: {
      unsigned long long x = static_cast<unsigned long long>(v.l);
      if (op == TOP_GE) x -= 1ull;
      if (op == TOP_LE) x += 1ull;
      return first_hit_t(static_cast<const long long*>(heap), Lt, s,
                         static_cast<long long>(x), gt);
    }
    default: {
      unsigned x = static_cast<unsigned>(v.i);
      if (op == TOP_GE) x -= 1u;
      if (op == TOP_LE) x += 1u;
      return first_hit_t(static_cast<const int*>(heap), Lt, s, static_cast<int>(x), gt);
    }
  }
}
