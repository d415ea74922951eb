// K7 win_range: the sliding windows' per-event range reductions.
//
// Replaces the range half of siddhi_tpu/core/window_device.py
// step_sliding: the left edges (:618-622, searchsorted side="right" over
// the valid count for length(L), over the monotone clock for time(D): an
// event exactly D old has expired), the window sums as prefix differences
// (:624-633, and per group `_seg_window_sum` :141 through the sorted
// (segment, position) keys), min/max over [left, i] from a log2 sparse
// table (`_sparse_table` :84, `_range_reduce` :99, `_seg_window_minmax`
// :148), avg = sum / max(count, 1) in the compute dtype (:652), and the
// carry's first kept entry `start_k` (:663-670).
//
// One thread per batch entry i (entries first .. first+m-1 of the N
// scanned ones).  Its left edge is a binary search; grouped, the range
// moves to the group-sorted order: hi = rank[i], lo = the first sorted
// slot whose key is >= seg[i] * N + left.  A sum site reads two prefixes
// (f64 or i64, from K6) and rounds the difference to its output type; a
// min/max site reads two rows of its sparse table.  The tables (levels
// rows of N doubles, row j reducing [i, i + 2^j), the neutral +-inf past
// the end and at invalid entries) are built first by the same launch, one
// pass per level.  Bound on the H100: bytes -- the prefix and table reads
// fall at random, one 32-byte sector each.  Python side:
// kernels/win_range.py.
#include "expr_vm.cuh"
#include "win_scan.cuh"

enum RangeOp { RG_SUM = 0, RG_AVG = 1, RG_MIN = 2, RG_MAX = 3 };
enum RangeKind { RK_LENGTH = 0, RK_TIME = 1 };

struct RangeParams {  // layout mirrored by kernels/win_range.py _Params
  long long n, first, m, span, last;
  int kind, grouped, n_sites, levels;  // levels 0: no min/max site
  const long long* vcnt;        // arrival order: valid count (length)
  const long long* clock;       // arrival order: monotone clock (time)
  const long long* ks;          // grouped: sorted (segment * N + position) keys
  const long long* seg;         // grouped: each arrival entry's segment
  const long long* rank;        // grouped: each arrival entry's sorted slot
  const unsigned char* valid;   // scanned order (the tables' neutral entries)
  long long* start_k;           // out: the carry's first kept entry
  const int* op;                // per site
  const void* const* pfx;       // sum/avg: prefix (f64 or i64), scanned order
  const int* pfx_vt;
  const void* const* cnt;       // avg: the valid-count prefix (i64)
  const void* const* vals;      // min/max: values (f32/f64), scanned order
  const int* val_vt;
  double* const* table;         // min/max: levels x n
  void* const* out;             // m entries each
  const int* out_vt;
};

__device__ __forceinline__ long long upper_bound(const long long* a, long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] > x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__device__ __forceinline__ long long lower_bound(const long long* a, long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] >= x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__device__ __forceinline__ double mm(int op, double a, double b) {
  return op == RG_MAX ? MaxF::op(a, b) : MinF::op(a, b);
}

__global__ void level0_kernel(const __grid_constant__ RangeParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  for (int s = 0; s < p.n_sites; ++s) {
    const int op = p.op[s];
    if (op != RG_MIN && op != RG_MAX) continue;
    double v = op == RG_MAX ? MaxF::id() : MinF::id();
    if (p.valid == nullptr || p.valid[i]) {
      const VmVal x = vm_read(p.vals[s], p.val_vt[s], i);
      v = p.val_vt[s] == VT_F32 ? static_cast<double>(x.f) : x.d;
    }
    p.table[s][i] = v;
  }
}

__global__ void level_kernel(const __grid_constant__ RangeParams p, int j) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const long long w = 1LL << (j - 1);
  for (int s = 0; s < p.n_sites; ++s) {
    const int op = p.op[s];
    if (op != RG_MIN && op != RG_MAX) continue;
    const double* prev = p.table[s] + (j - 1) * p.n;
    const double nb = i + w < p.n ? prev[i + w] : (op == RG_MAX ? MaxF::id() : MinF::id());
    p.table[s][j * p.n + i] = mm(op, prev[i], nb);
  }
}

__device__ __forceinline__ double pfx_f(const void* a, long long i) {
  return i < 0 ? 0.0 : static_cast<const double*>(a)[i];
}

__device__ __forceinline__ long long pfx_l(const void* a, long long i) {
  return i < 0 ? 0 : static_cast<const long long*>(a)[i];
}

// f64 -> the compute dtype (f32 rounds to nearest)
__device__ __forceinline__ VmVal to_out_f(double v, int vt) {
  return vt == VT_F32 ? vm_f(__double2float_rn(v)) : vm_d(v);
}

__global__ void query_kernel(const __grid_constant__ RangeParams p) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e == 0) {
    long long sk;
    if (p.kind == RK_LENGTH) {
      const long long tot = p.vcnt[p.n - 1];
      sk = upper_bound(p.vcnt, p.n, tot - p.span > 0 ? tot - p.span : 0);
    } else {
      sk = upper_bound(p.clock, p.n, p.clock[p.last > 0 ? p.last : 0] - p.span);
    }
    *p.start_k = sk;
  }
  if (e >= p.m) return;
  const long long i = p.first + e;
  long long left;
  if (p.kind == RK_LENGTH) {
    const long long want = p.vcnt[i] - p.span;
    left = upper_bound(p.vcnt, p.n, want > 0 ? want : 0);
  } else {
    left = upper_bound(p.clock, p.n, p.clock[i] - p.span);
  }
  long long lo = left, hi = i;
  if (p.grouped) {
    hi = p.rank[i];
    lo = lower_bound(p.ks, p.n, p.seg[i] * p.n + left);
  }
  for (int s = 0; s < p.n_sites; ++s) {
    const int op = p.op[s];
    const int ovt = p.out_vt[s];
    VmVal r;
    if (op == RG_SUM || op == RG_AVG) {
      const bool fl = p.pfx_vt[s] == VT_F64;
      const double df = fl ? pfx_f(p.pfx[s], hi) - pfx_f(p.pfx[s], lo - 1) : 0.0;
      const long long dl = fl ? 0 : pfx_l(p.pfx[s], hi) - pfx_l(p.pfx[s], lo - 1);
      if (op == RG_SUM) {
        r = fl ? to_out_f(df, ovt) : vm_l(dl);
      } else {
        const long long c = pfx_l(p.cnt[s], hi) - pfx_l(p.cnt[s], lo - 1);
        if (ovt == VT_F32) {
          const float sf = fl ? __double2float_rn(df) : __ll2float_rn(dl);
          const float cf = __ll2float_rn(c);
          r = vm_f(sf / (cf < 1.0f ? 1.0f : cf));
        } else {
          const double sd = fl ? df : __ll2double_rn(dl);
          const double cd = __ll2double_rn(c);
          r = vm_d(sd / (cd < 1.0 ? 1.0 : cd));
        }
      }
    } else {
      const long long l = lo < hi ? lo : hi;
      const long long len = hi - l + 1;
      int j = 63 - __clzll(len > 1 ? len : 1);
      if (j > p.levels - 1) j = p.levels - 1;
      const double* t = p.table[s] + static_cast<long long>(j) * p.n;
      r = to_out_f(mm(op, t[l], t[hi - (1LL << j) + 1]), ovt);
    }
    vm_write(p.out[s], ovt, e, r);
  }
}

extern "C" int win_range_launch(const RangeParams* params, cudaStream_t stream) {
  const RangeParams& p = *params;
  const int threads = 256;
  cudaError_t err;
  if (p.levels > 0) {  // some site is a min/max: build the tables first
    const unsigned blocks = static_cast<unsigned>((p.n + threads - 1) / threads);
    level0_kernel<<<blocks, threads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    for (int j = 1; j < p.levels; ++j) {
      level_kernel<<<blocks, threads, 0, stream>>>(p, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  const long long work = p.m > 1 ? p.m : 1;
  query_kernel<<<static_cast<unsigned>((work + threads - 1) / threads), threads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
