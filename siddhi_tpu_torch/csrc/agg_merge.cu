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
// (agg_device.py:22-27): every segment folds its events in batch order
// from the identity (0 for sums and counts, +inf for min, -inf for max).
// So there are no atomics and no tree: one thread walks one segment's
// events in order, through `order` (the stable argsort of the segment ids,
// which the host already has from np.unique) and `seg_off` (the segment
// offsets).  min/max are K6's MinF/MaxF (win_scan.cuh): jnp.minimum /
// jnp.maximum, NaN propagating and -0.0 below +0.0 in either order.  Slots
// are distinct within a launch (the segment keys are unique), so no two
// threads write one row.
//
// Bound on the H100: bytes (order, the value rows and the per-segment
// arrays read once, m x nb f64 read and written once) over 3.35 TB/s, and
// the serial chain: the longest segment's dependent f64 adds.  At a global
// rollup (no group by) one segment holds the whole batch, and the chain is
// the limit; a warp per segment with an ordered fold is a later design.
// Python side: kernels/agg_merge.py.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "win_scan.cuh"

enum AggOp { AG_SUM = 0, AG_COUNT = 1, AG_MIN = 2, AG_MAX = 3 };

#define AG_THREADS 128

struct AggParams {  // layout mirrored by kernels/agg_merge.py _Params
  long long m;                  // segments (threads)
  long long n;                  // events, the row stride of `vals`
  int nb;                       // bases: the columns of `bases`
  int pad_;
  double* bases;                // (capacity, nb) row-major, merged in place
  const double* vals;           // (rows, n) row-major value rows
  const int* order;             // (n,) events, segment by segment, each in batch order
  const int* seg_off;           // (m + 1,) segment j is order[seg_off[j], seg_off[j+1])
  const int* slot;              // (m,) ring row of segment j
  const int* fresh;             // (m,) non-zero: a new slot, which takes the partial
  const int* op;                // (nb,) AggOp of each base (device table)
  const int* row;               // (nb,) value row of each base (counts read none)
};

__global__ void agg_merge_kernel(const __grid_constant__ AggParams p) {
  const long long j = static_cast<long long>(blockIdx.x) * AG_THREADS + threadIdx.x;
  if (j >= p.m) return;
  const int lo = p.seg_off[j], hi = p.seg_off[j + 1];
  double* dst = p.bases + static_cast<long long>(p.slot[j]) * p.nb;
  const bool fresh = p.fresh[j] != 0;
  for (int b = 0; b < p.nb; ++b) {
    const int op = p.op[b];
    double acc;
    if (op == AG_COUNT) {
      acc = static_cast<double>(hi - lo);  // the fold of hi - lo ones, exact
    } else {
      const double* v = p.vals + static_cast<long long>(p.row[b]) * p.n;
      if (op == AG_SUM) {
        acc = 0.0;
        for (int k = lo; k < hi; ++k) acc = acc + v[p.order[k]];
      } else if (op == AG_MIN) {
        acc = MinF::id();
        for (int k = lo; k < hi; ++k) acc = MinF::op(acc, v[p.order[k]]);
      } else {
        acc = MaxF::id();
        for (int k = lo; k < hi; ++k) acc = MaxF::op(acc, v[p.order[k]]);
      }
    }
    if (!fresh) {
      const double old = dst[b];
      acc = op == AG_MIN ? MinF::op(old, acc) : op == AG_MAX ? MaxF::op(old, acc) : old + acc;
    }
    dst[b] = acc;
  }
}

extern "C" int agg_merge_launch(const AggParams* params, cudaStream_t stream) {
  const AggParams& p = *params;
  if (p.m <= 0 || p.nb <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((p.m + AG_THREADS - 1) / AG_THREADS);
  agg_merge_kernel<<<blocks, AG_THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
