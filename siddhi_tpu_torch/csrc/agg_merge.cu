// K10 agg_merge: fold one micro-batch's (bucket, group) segments of an
// incremental aggregation and merge them into the device-resident bucket
// ring of one duration, in place.
//
// Replaces the jitted step of siddhi_tpu/core/agg_device.py:102-143
// (`DeviceAggregationPlan._make_step`, jitted at :98): segment_sum /
// segment_min / segment_max of every f64 base over the batch's segment
// ids, a gather of the resident rows at the host-assigned slots, `old op
// new` (a fresh slot takes the partial), and the scatter back into the
// ring.  The JAX package's contract is byte identity with its host path
// (agg_device.py:22-27): every sum folds its segment's events in batch
// order from 0, `(((0 + x0) + x1) + ...)`, so sums take no tree and no
// atomics.  min/max are K6's MinF/MaxF (win_scan.cuh): jnp.minimum /
// jnp.maximum, NaN propagating and -0.0 below +0.0 in either order, which
// give the same value under any order and any tree (only which NaN
// payload survives may differ); counts are exact (hi - lo).  Segments come
// as `order` (the stable argsort of the segment ids, each segment's events
// in batch order) and `seg_off` (the offsets).
//
// Design: two warps per segment (segments are distinct slots, so no two
// segments write one ring row), one for the sums and counts, one for min
// and max, so the two folds run side by side on the SM; each writes its
// own bases of the row.  A warp walks its segment in chunks of 32 x U
// events.  Staging: for each chunk the 32 lanes load `order` (coalesced:
// within a segment `order` increases, and at a global rollup it is
// contiguous) and cp.async the value rows its bases read into a
// double-buffered shared stage, one padded row per distinct value row;
// `order` is loaded two chunks ahead and the values one chunk ahead, so
// the fold never waits on device memory.  Sums: lane b folds base b (and
// b + 32 where nb > 32) through the chunk's events in order, reading the
// stage into registers a batch ahead of the adds; every lane runs the
// same dependent DADD chain, so the lanes do not diverge and only the add
// sits on the chain.  min/max: each lane folds its U events of a chunk
// into a running value of its own (any order gives the same value), and a
// butterfly of shuffles reduces the warp once, after the walk.  The merge with the ring row comes after the
// whole segment.  U (16, 4 or 1) follows the mean segment length, as far as
// the stage fits in shared memory.  Bases beyond 64 go in further
// launches, each a pass of 64 bases over every segment, and a pass stages
// only its own bases' value rows, so a stage holds at most 64 rows a warp
// whatever the number of bases.
//
// Bound on the H100: bytes (order, the value rows and the per-segment
// arrays read once, m x nb f64 read and written once) over 3.35 TB/s, and
// the serial chain: the longest segment's dependent f64 adds, which at a
// global rollup (no group by: one segment holds the whole batch) is the
// limit.  `agg_chain_probe_launch` measures that chain on the card: one
// thread doing n dependent f64 adds from registers.  Python side:
// kernels/agg_merge.py.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "win_scan.cuh"

enum AggOp { AG_SUM = 0, AG_COUNT = 1, AG_MIN = 2, AG_MAX = 3 };

#define AG_GROUPS 2                   // bases a lane holds
#define AG_PASS (32 * AG_GROUPS)      // bases a launch: a pass over the segments
#define AG_SMEM_MAX 232448            // dynamic shared memory a block may use

struct AggParams {  // one pass; layout mirrored by kernels/agg_merge.py _Params
  long long m;                  // segments (two warps each)
  long long n;                  // events, the row stride of `vals`
  int nb;                       // the pass's bases (at most AG_PASS)
  int stride;                   // all bases: the row stride of `bases`
  int ns[2];                    // stage rows of the sum warp and the min/max warp
  int n_mm;                     // min/max bases
  double* bases;                // (capacity, stride) row-major from the pass's
                                // first base, merged in place
  const double* vals;           // (rows, n) row-major value rows
  const int* order;             // (n,) events, segment by segment, each in batch order
  const int* seg_off;           // (m + 1,) segment j is order[seg_off[j], seg_off[j+1])
  const int* slot;              // (m,) ring row of segment j
  const int* fresh;             // (m,) non-zero: a new slot, which takes the partial
  const int* op;                // (nb,) AggOp of each base (device table)
  const int* sidx;              // (nb,) stage row of each base in its warp's stage
  const int* srow[2];           // (ns[w],) value row of each stage row of warp w
  const int* mm;                // (n_mm,) the pass's min/max bases, in base order
};

template <int U>
__device__ __forceinline__ void load_order(const AggParams& p, int lo, int hi, int c, int lane,
                                           int (&idx)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = lo + c * 32 * U + u * 32 + lane;
    idx[u] = k < hi ? p.order[k] : -1;
  }
}

// cp.async one chunk's values of every stage row into `buf`
template <int U>
__device__ __forceinline__ void stage_chunk(const AggParams& p, int ns, const int* srow,
                                            double* buf, int lane, const int (&idx)[U]) {
  constexpr int STRIDE = 32 * U + 2;
  for (int s = 0; s < ns; ++s) {
    const double* row = p.vals + static_cast<long long>(srow[s]) * p.n;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (idx[u] >= 0) __pipeline_memcpy_async(buf + s * STRIDE + u * 32 + lane, row + idx[u], 8);
  }
}

// one min or max base over a chunk: the lane's U events into its own
// running value (any order gives the same value, so the warp is reduced
// once, after the walk)
template <class Op, int U>
__device__ __forceinline__ void lane_reduce(double* acc, const double* src, int cnt, int lane) {
  double r = *acc;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = u * 32 + lane;
    if (k < cnt) r = Op::op(r, src[k]);
  }
  *acc = r;
}

template <class Op>
__device__ __forceinline__ double warp_reduce(double r) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r = Op::op(r, __shfl_xor_sync(WS_FULL, r, o));
  return r;
}

// The sums of one full chunk, in event order.  The stage is read into a
// ring of registers, 32 / NG events a chain: each add is followed by the
// load of the event that takes its slot one round later, and the rounds
// stay a rolled loop, so the compiler cannot sink a load next to the add
// that uses it; only the adds wait on each other.
template <int CH, int NG>
__device__ __forceinline__ void fold_full(const double* s0, const double* s1, double& a,
                                          double& b) {
  constexpr int S = 16 / NG;   // 16-byte slots a chain
  const double2* v0 = reinterpret_cast<const double2*>(s0);
  const double2* v1 = reinterpret_cast<const double2*>(s1);
  double2 x0[S], x1[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    x0[i] = v0[i];
    if (NG > 1) x1[i] = v1[i];
  }
#pragma unroll 1
  for (int k = S; k < CH / 2 + S; k += S) {
    const bool more = k < CH / 2;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      a = a + x0[i].x;
      a = a + x0[i].y;
      if (NG > 1) {
        b = b + x1[i].x;
        b = b + x1[i].y;
      }
      if (more) {
        x0[i] = v0[k + i];
        if (NG > 1) x1[i] = v1[k + i];
      }
    }
  }
}

template <int U>
__global__ void agg_merge_kernel(const __grid_constant__ AggParams p) {
  constexpr int CH = 32 * U;       // events a chunk
  constexpr int STRIDE = CH + 2;   // a padded stage row (16-byte aligned): lanes
                                   // reading one event of different rows hit
                                   // different banks
  extern __shared__ __align__(16) double smem[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int role = wib & 1;        // 0: sums and counts, 1: min and max
  const long long j = static_cast<long long>(blockIdx.x) * (blockDim.x >> 6) + (wib >> 1);
  if (j >= p.m) return;
  const int ns = p.ns[role];
  const int* srow = p.srow[role];
  // per warp: the double-buffered stage, then each min/max base's running
  // value per lane
  const int nsmax = max(p.ns[0], p.ns[1]);
  double* stage = smem + static_cast<long long>(wib) * (2 * nsmax * STRIDE + 32 * p.n_mm);
  double* lane_acc = stage + 2 * nsmax * STRIDE + lane;
  const int lo = p.seg_off[j], hi = p.seg_off[j + 1];
  const int nchunks = (hi - lo + CH - 1) / CH;
  double* dst = p.bases + static_cast<long long>(p.slot[j]) * p.stride;
  const bool fresh = p.fresh[j] != 0;

  int bop[AG_GROUPS], bsrc[AG_GROUPS];
  bool mine[AG_GROUPS];
  double sacc[AG_GROUPS], macc[AG_GROUPS], old[AG_GROUPS];
#pragma unroll
  for (int g = 0; g < AG_GROUPS; ++g) {
    const int b = g * 32 + lane;
    bop[g] = b < p.nb ? p.op[b] : AG_COUNT;
    mine[g] = b < p.nb && (bop[g] == AG_MIN || bop[g] == AG_MAX) == (role == 1);
    bsrc[g] = b < p.nb ? p.sidx[b] : 0;
    sacc[g] = 0.0;
    macc[g] = bop[g] == AG_MIN ? MinF::id() : MaxF::id();
    old[g] = mine[g] && !fresh ? dst[b] : 0.0;   // in flight over the walk
  }
  const int ng = min(AG_GROUPS, (p.nb + 31) / 32);   // warp-uniform
  if (role == 1)
    for (int t = 0; t < p.n_mm; ++t)
      lane_acc[32 * t] = p.op[p.mm[t]] == AG_MIN ? MinF::id() : MaxF::id();
  if (ns > 0 && nchunks > 0) {
    int idx[U];
    load_order<U>(p, lo, hi, 0, lane, idx);
    stage_chunk<U>(p, ns, srow, stage, lane, idx);
    __pipeline_commit();
    if (nchunks > 1) load_order<U>(p, lo, hi, 1, lane, idx);
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) stage_chunk<U>(p, ns, srow, stage + ((c + 1) & 1) * ns * STRIDE, lane, idx);
      __pipeline_commit();          // possibly empty: wait_prior(1) below is chunk c
      if (c + 2 < nchunks) load_order<U>(p, lo, hi, c + 2, lane, idx);
      __pipeline_wait_prior(1);
      __syncwarp();
      const double* buf = stage + (c & 1) * ns * STRIDE;
      const int cnt = min(CH, hi - lo - c * CH);
      if (role == 0) {
        // sums: every lane folds its bases' rows in event order (a lane
        // without a sum base folds a row it then ignores)
        const double* s0 = buf + (bop[0] == AG_SUM ? bsrc[0] : 0) * STRIDE;
        const double* s1 = buf + (bop[AG_GROUPS - 1] == AG_SUM ? bsrc[AG_GROUPS - 1] : 0) * STRIDE;
        double a = sacc[0], b = sacc[AG_GROUPS - 1];
        if (cnt == CH) {
          if (ng == 1)
            fold_full<CH, 1>(s0, s1, a, b);
          else
            fold_full<CH, 2>(s0, s1, a, b);
        } else if (ng == 1) {
          for (int k = 0; k < cnt; ++k) a = a + s0[k];
        } else {
          for (int k = 0; k < cnt; ++k) {
            a = a + s0[k];
            b = b + s1[k];
          }
        }
        sacc[0] = a;
        sacc[AG_GROUPS - 1] = b;
      } else {
        // min/max: each lane folds its events of the chunk
        for (int t = 0; t < p.n_mm; ++t) {
          const int b = p.mm[t];
          const double* src = buf + p.sidx[b] * STRIDE;
          if (p.op[b] == AG_MIN)
            lane_reduce<MinF, U>(lane_acc + 32 * t, src, cnt, lane);
          else
            lane_reduce<MaxF, U>(lane_acc + 32 * t, src, cnt, lane);
        }
      }
      __syncwarp();                 // the stage of chunk c is free for c + 2
    }
  }
  if (role == 1)
    for (int t = 0; t < p.n_mm; ++t) {
      const int b = p.mm[t];
      const double r = p.op[b] == AG_MIN ? warp_reduce<MinF>(lane_acc[32 * t])
                                         : warp_reduce<MaxF>(lane_acc[32 * t]);
#pragma unroll
      for (int g = 0; g < AG_GROUPS; ++g)
        if (b == g * 32 + lane) macc[g] = r;
    }
#pragma unroll
  for (int g = 0; g < AG_GROUPS; ++g) {
    if (!mine[g]) continue;
    const int op = bop[g];
    double acc = op == AG_SUM ? sacc[g] : op == AG_COUNT ? static_cast<double>(hi - lo) : macc[g];
    if (!fresh)
      acc = op == AG_MIN ? MinF::op(old[g], acc) : op == AG_MAX ? MaxF::op(old[g], acc) : old[g] + acc;
    dst[g * 32 + lane] = acc;
  }
}

// shared bytes of a block of `spb` segments (two warps each)
static size_t stage_bytes(const AggParams& p, int spb, int u) {
  const size_t nsmax = p.ns[0] > p.ns[1] ? p.ns[0] : p.ns[1];
  return static_cast<size_t>(spb) * 2 * (2 * nsmax * (32 * u + 2) + 32 * p.n_mm) * sizeof(double);
}

template <int U>
static int launch_u(const AggParams& p, int spb, cudaStream_t stream) {
  const size_t bytes = stage_bytes(p, spb, U);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        agg_merge_kernel<U>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((p.m + spb - 1) / spb);
  agg_merge_kernel<U><<<blocks, 64 * spb, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

static int launch_pass(const AggParams& p, cudaStream_t stream) {
  // the chunk from the mean segment length (a global rollup's long chain
  // takes 512-event chunks, many short segments small stages and more
  // blocks on an SM), then the most segments a block whose stage fits; a
  // pass stages at most AG_PASS rows a warp, so one segment a block always
  // fits 32-event chunks (102,400 bytes)
  const long long mean = p.n / p.m;
  for (int spb = 4; spb >= 1; spb >>= 1) {
    if (mean >= 256 && stage_bytes(p, spb, 16) <= AG_SMEM_MAX) return launch_u<16>(p, spb, stream);
    if (mean >= 64 && stage_bytes(p, spb, 4) <= AG_SMEM_MAX) return launch_u<4>(p, spb, stream);
    if (stage_bytes(p, spb, 1) <= AG_SMEM_MAX) return launch_u<1>(p, spb, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// one launch a pass of at most AG_PASS bases (`params[q]`), each over
// every segment with a stage of its own bases' value rows only
extern "C" int agg_merge_launch(const AggParams* params, int passes, cudaStream_t stream) {
  if (passes <= 0 || params[0].m <= 0) return 0;
  for (int q = 0; q < passes; ++q) {
    const int err = launch_pass(params[q], stream);
    if (err != 0) return err;
  }
  return 0;
}

// The chain bound: one thread adds `x` to 0.0 n times, each add waiting on
// the one before (no fast math, so nvcc keeps every add), and writes the
// sum.  Not on any path: chip_smoke.py times it as K10's `chain_ms`.
__global__ void agg_chain_probe_kernel(long long n, double x, double* out) {
  double a = 0.0;
  for (long long i = 0; i < n; ++i) a = a + x;
  *out = a;
}

extern "C" int agg_chain_probe_launch(long long n, double x, double* out, cudaStream_t stream) {
  agg_chain_probe_kernel<<<1, 1, 0, stream>>>(n, x, out);
  return static_cast<int>(cudaGetLastError());
}
