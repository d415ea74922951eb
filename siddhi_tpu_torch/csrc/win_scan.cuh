// Segmented block scans shared by the window kernels (win_scan.cu K6,
// win_range.cu K7) and by join_probe.cu K9's rank pass.
//
// An element of a segmented scan is a pair (f, v): f says that a segment
// starts inside the element's range, v is the reduction from the last such
// start (or the range's beginning) to its end.  The combine of a left and a
// right element is (fl | fr, fr ? vr : op(vl, vr)); it is associative, and
// with f always false it is the plain scan.  Each Op gives its value type,
// its identity and op(left, right).  min/max are jnp.minimum / jnp.maximum
// exactly: NaN propagates (CUDA's fmin/fmax would drop it) and -0.0 counts
// below +0.0 whichever side it is on (fmin/fmax leave the sign of zero
// open), so the comparison is written out.  K10 agg_merge uses them too.
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

#define WS_THREADS 256
#define WS_ITEMS 4
#define WS_TILE (WS_THREADS * WS_ITEMS)
#define WS_WARPS (WS_THREADS / 32)
#define WS_FULL 0xffffffffu

struct SumF {
  typedef double T;
  static __device__ __forceinline__ T id() { return 0.0; }
  static __device__ __forceinline__ T op(T a, T b) { return a + b; }
};
struct SumI {
  typedef long long T;
  static __device__ __forceinline__ T id() { return 0; }
  static __device__ __forceinline__ T op(T a, T b) { return a + b; }
};
struct MinF {
  typedef double T;
  static __device__ __forceinline__ T id() { return CUDART_INF; }
  static __device__ __forceinline__ T op(T a, T b) {
    return (isnan(a) || a < b || (a == b && signbit(a))) ? a : b;
  }
};
struct MaxF {
  typedef double T;
  static __device__ __forceinline__ T id() { return -CUDART_INF; }
  static __device__ __forceinline__ T op(T a, T b) {
    return (isnan(a) || a > b || (a == b && !signbit(a))) ? a : b;
  }
};
struct MaxI {
  typedef long long T;
  static __device__ __forceinline__ T id() { return -0x7fffffffffffffffLL - 1; }
  static __device__ __forceinline__ T op(T a, T b) { return a > b ? a : b; }
};

template <class Op>
struct Seg {
  bool f;
  typename Op::T v;
};

template <class Op>
__device__ __forceinline__ Seg<Op> seg_id() {
  return Seg<Op>{false, Op::id()};
}

template <class Op>
__device__ __forceinline__ Seg<Op> seg_combine(Seg<Op> a, Seg<Op> b) {
  return Seg<Op>{a.f || b.f, b.f ? b.v : Op::op(a.v, b.v)};
}

// Block-wide segmented scan of one element per thread (WS_THREADS
// threads): returns the thread's exclusive prefix (the identity for thread
// 0) and stores the block's total in *total.
template <class Op>
__device__ Seg<Op> block_seg_scan(Seg<Op> x, Seg<Op>* total) {
  typedef typename Op::T T;
  __shared__ int wf[WS_WARPS];
  __shared__ T wv[WS_WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  Seg<Op> inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int yf = __shfl_up_sync(WS_FULL, static_cast<int>(inc.f), o);
    const T yv = __shfl_up_sync(WS_FULL, inc.v, o);
    if (lane >= o) inc = seg_combine<Op>(Seg<Op>{yf != 0, yv}, inc);
  }
  if (lane == 31) {
    wf[w] = inc.f;
    wv[w] = inc.v;
  }
  __syncthreads();
  if (w == 0) {
    Seg<Op> s = lane < WS_WARPS ? Seg<Op>{wf[lane] != 0, wv[lane]} : seg_id<Op>();
    for (int o = 1; o < WS_WARPS; o <<= 1) {
      const int yf = __shfl_up_sync(WS_FULL, static_cast<int>(s.f), o);
      const T yv = __shfl_up_sync(WS_FULL, s.v, o);
      if (lane >= o) s = seg_combine<Op>(Seg<Op>{yf != 0, yv}, s);
    }
    if (lane < WS_WARPS) {
      wf[lane] = s.f;
      wv[lane] = s.v;
    }
  }
  __syncthreads();
  // the exclusive prefix inside the warp: the inclusive value one lane down
  const int pf = __shfl_up_sync(WS_FULL, static_cast<int>(inc.f), 1);
  const T pv = __shfl_up_sync(WS_FULL, inc.v, 1);
  Seg<Op> ex = lane > 0 ? Seg<Op>{pf != 0, pv} : seg_id<Op>();
  if (w > 0) ex = seg_combine<Op>(Seg<Op>{wf[w - 1] != 0, wv[w - 1]}, ex);
  *total = Seg<Op>{wf[WS_WARPS - 1] != 0, wv[WS_WARPS - 1]};
  __syncthreads();
  return ex;
}
