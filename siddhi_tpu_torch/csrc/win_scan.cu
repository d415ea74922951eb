// K6 win_scan: a multi-column inclusive segmented scan over the N entries
// of a window step's [carry | batch] sequence (or of its group-sorted
// order).
//
// Replaces the scans of siddhi_tpu/core/window_device.py: the prefix sums
// of the sliding windows (jnp.cumsum, :630, and `_segmented_prefix` :109
// grouped), the valid count (:617), the monotone clock (the cummax of :611)
// and the tumbling windows' running aggregates (`_mono_running_*` :189,
// :199, `_seg_running_*` :163, :168), plus the dense group ids of
// `group_seg` (:588).  Sums of float values accumulate in f64 and of
// integer values (and counts) in i64, whatever the compute precision; min
// and max keep their input type (max over i64 is the clock).  An optional
// segment-start flag per entry resets every column.  A column may be
// masked by the valid flags (an invalid entry adds the identity), and a
// column without input counts ones.
//
// The incremental aggregation's per-batch path (siddhi_tpu/core/
// aggregation.py:463-532, `_reduce_device` under
// @app:deviceAggregations('always')) runs it over each duration's
// (bucket, group)-sorted batch: f64 sums, counts, min and max, reset at
// every segment start.
//
// The `scan` pattern family runs it on its (L, F) lane grid, a segment
// per lane: occurrence ranks (a count of each count position's node mask,
// the jnp.cumsum of siddhi_tpu/core/nfa_parallel.py:843) and the prev-match
// pointers of `and` sides (_prev_static_scan :589, a max of the event
// index masked by the side's node mask: each column's own valid flags).
// There `period` = F: a segment starts at every multiple of F, and a max
// column without input reads the entry's index within its segment, so
// neither the flags nor the index column is materialized.
//
// Three phases, 1024 entries per block (256 threads x 4 entries):
//   reduce: each block's segmented total per column;
//   carry:  one block per column scans the block totals in rounds of 256;
//   rescan: each block rescans its tile from its carry and writes.
// Bound on the H100: bytes (each input read once, each output written once
// -- the rescan reads the inputs a second time).  Python side:
// kernels/win_scan.py.
#include "expr_vm.cuh"
#include "win_scan.cuh"

enum ScanOp { SC_SUM_F = 0, SC_SUM_I = 1, SC_MIN_F = 2, SC_MAX_F = 3, SC_MAX_I = 4 };

struct ScanParams {  // layout mirrored by kernels/win_scan.py _Params
  long long n;
  int n_cols, nblocks;
  long long period;            // > 0: segments of `period` entries, no flags
  const unsigned char* valid;  // null: every entry is valid
  const unsigned char* flags;  // null: one segment
  const void* const* in;       // per column; null: the value 1 (a count),
                               // or for a max the index within the period
  void* const* out;
  const int* in_vt;
  const int* out_vt;
  const int* op;
  const int* masked;
  const unsigned char* const* col_valid;  // per column; null: `valid`
  long long* agg;              // n_cols x nblocks block totals (raw 64 bits)
  long long* carry;            // n_cols x nblocks exclusive block prefixes
  unsigned char* blk_flag;     // nblocks: a segment starts in the block
};

template <class T>
__device__ __forceinline__ long long to_bits(T v);
template <>
__device__ __forceinline__ long long to_bits<double>(double v) { return __double_as_longlong(v); }
template <>
__device__ __forceinline__ long long to_bits<long long>(long long v) { return v; }
template <class T>
__device__ __forceinline__ T from_bits(long long b);
template <>
__device__ __forceinline__ double from_bits<double>(long long b) { return __longlong_as_double(b); }
template <>
__device__ __forceinline__ long long from_bits<long long>(long long b) { return b; }

__device__ __forceinline__ double as_double(VmVal v, int vt) {
  switch (vt) {
    case VT_F32: return static_cast<double>(v.f);
    case VT_F64: return v.d;
    case VT_I64: return static_cast<double>(v.l);
    default: return static_cast<double>(v.i);
  }
}

__device__ __forceinline__ long long as_long(VmVal v, int vt) {
  return vt == VT_I64 ? v.l : static_cast<long long>(v.i);
}

template <class Op>
__device__ __forceinline__ typename Op::T load_as(const VmVal v, int vt);
template <>
__device__ __forceinline__ double load_as<SumF>(const VmVal v, int vt) { return as_double(v, vt); }
template <>
__device__ __forceinline__ double load_as<MinF>(const VmVal v, int vt) { return as_double(v, vt); }
template <>
__device__ __forceinline__ double load_as<MaxF>(const VmVal v, int vt) { return as_double(v, vt); }
template <>
__device__ __forceinline__ long long load_as<SumI>(const VmVal v, int vt) { return as_long(v, vt); }
template <>
__device__ __forceinline__ long long load_as<MaxI>(const VmVal v, int vt) { return as_long(v, vt); }

// PER: the segments come from `period` (an instantiation of its own, so
// the window scans keep their code).
template <class Op, bool PER>
__device__ __forceinline__ Seg<Op> item(const ScanParams& p, int c, long long i) {
  if (i >= p.n) return seg_id<Op>();
  const long long k = PER ? i % p.period : -1;
  const bool f = PER ? k == 0 : (p.flags != nullptr && p.flags[i] != 0);
  const unsigned char* v = p.col_valid[c] != nullptr ? p.col_valid[c] : p.valid;
  if (p.masked[c] && v != nullptr && !v[i]) return Seg<Op>{f, Op::id()};
  if (p.in[c] == nullptr)
    return Seg<Op>{f, static_cast<typename Op::T>(p.op[c] == SC_MAX_I ? k : 1)};
  return Seg<Op>{f, load_as<Op>(vm_read(p.in[c], p.in_vt[c], i), p.in_vt[c])};
}

__device__ __forceinline__ void store(const ScanParams& p, int c, long long i, double v) {
  if (p.out_vt[c] == VT_F32) {
    static_cast<float*>(p.out[c])[i] = static_cast<float>(v);
  } else {
    static_cast<double*>(p.out[c])[i] = v;
  }
}

__device__ __forceinline__ void store(const ScanParams& p, int c, long long i, long long v) {
  static_cast<long long*>(p.out[c])[i] = v;
}

template <class Op, bool PER>
__device__ void reduce_col(const ScanParams& p, int c) {
  const long long base = static_cast<long long>(blockIdx.x) * WS_TILE + threadIdx.x * WS_ITEMS;
  Seg<Op> x = seg_id<Op>();
  for (int k = 0; k < WS_ITEMS; ++k) x = seg_combine<Op>(x, item<Op, PER>(p, c, base + k));
  Seg<Op> total;
  block_seg_scan<Op>(x, &total);
  if (threadIdx.x == 0) {
    p.agg[static_cast<long long>(c) * p.nblocks + blockIdx.x] = to_bits(total.v);
    if (c == 0) p.blk_flag[blockIdx.x] = total.f;
  }
}

template <class Op, bool PER>  // PER unused: the carry reads block totals
__device__ void carry_col(const ScanParams& p, int c) {
  Seg<Op> run = seg_id<Op>();
  const long long row = static_cast<long long>(c) * p.nblocks;
  for (int base = 0; base < p.nblocks; base += WS_THREADS) {
    const int j = base + threadIdx.x;
    Seg<Op> x = j < p.nblocks
        ? Seg<Op>{p.blk_flag[j] != 0, from_bits<typename Op::T>(p.agg[row + j])}
        : seg_id<Op>();
    Seg<Op> total;
    const Seg<Op> ex = block_seg_scan<Op>(x, &total);
    if (j < p.nblocks) p.carry[row + j] = to_bits(seg_combine<Op>(run, ex).v);
    run = seg_combine<Op>(run, total);
  }
}

template <class Op, bool PER>
__device__ void rescan_col(const ScanParams& p, int c) {
  const long long base = static_cast<long long>(blockIdx.x) * WS_TILE + threadIdx.x * WS_ITEMS;
  Seg<Op> items[WS_ITEMS];
  Seg<Op> x = seg_id<Op>();
  for (int k = 0; k < WS_ITEMS; ++k) {
    items[k] = item<Op, PER>(p, c, base + k);
    x = seg_combine<Op>(x, items[k]);
  }
  Seg<Op> total;
  const Seg<Op> ex = block_seg_scan<Op>(x, &total);
  const Seg<Op> cin = blockIdx.x == 0
      ? seg_id<Op>()
      : Seg<Op>{false, from_bits<typename Op::T>(
                           p.carry[static_cast<long long>(c) * p.nblocks + blockIdx.x])};
  Seg<Op> acc = seg_combine<Op>(cin, ex);
  for (int k = 0; k < WS_ITEMS; ++k) {
    const long long i = base + k;
    if (i >= p.n) break;
    acc = seg_combine<Op>(acc, items[k]);
    store(p, c, i, acc.v);
  }
}

#define WS_DISPATCH(FN, PER)                     \
  switch (p.op[c]) {                             \
    case SC_SUM_F: FN<SumF, PER>(p, c); break;   \
    case SC_SUM_I: FN<SumI, PER>(p, c); break;   \
    case SC_MIN_F: FN<MinF, PER>(p, c); break;   \
    case SC_MAX_F: FN<MaxF, PER>(p, c); break;   \
    default: FN<MaxI, PER>(p, c); break;         \
  }

template <bool PER>
__global__ void reduce_kernel(const __grid_constant__ ScanParams p) {
  for (int c = 0; c < p.n_cols; ++c) WS_DISPATCH(reduce_col, PER)
}

__global__ void carry_kernel(const __grid_constant__ ScanParams p) {
  const int c = blockIdx.x;
  WS_DISPATCH(carry_col, false)
}

template <bool PER>
__global__ void rescan_kernel(const __grid_constant__ ScanParams p) {
  for (int c = 0; c < p.n_cols; ++c) WS_DISPATCH(rescan_col, PER)
}

extern "C" int win_scan_launch(const ScanParams* params, cudaStream_t stream) {
  const ScanParams& p = *params;
  if (p.n <= 0 || p.n_cols == 0) return 0;
  cudaError_t err;
  const unsigned blocks = static_cast<unsigned>(p.nblocks);
  if (blocks > 1) {
    if (p.period > 0)
      reduce_kernel<true><<<blocks, WS_THREADS, 0, stream>>>(p);
    else
      reduce_kernel<false><<<blocks, WS_THREADS, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    carry_kernel<<<static_cast<unsigned>(p.n_cols), WS_THREADS, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (p.period > 0)
    rescan_kernel<true><<<blocks, WS_THREADS, 0, stream>>>(p);
  else
    rescan_kernel<false><<<blocks, WS_THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
