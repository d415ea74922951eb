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
// One single-pass kernel over 1024-entry tiles (256 threads x 4 entries)
// with a look-back over tile aggregates.  A block takes its tile from an
// atomic counter (not blockIdx, so every tile's predecessors are already
// running), stages the tile's entries of up to 16 columns in shared memory
// (striped, coalesced loads, a column's loads all in flight before any is
// used), scans each column and publishes each column's aggregate.  Tiles
// fall into look-back windows of 256: a tile whose nearest predecessor
// holds a segment start takes that predecessor's aggregate as its carry;
// any other folds the aggregates of its window's earlier tiles in one
// block scan (one a thread, every column in one walk) and, where no
// segment start was met, puts in front the inclusive prefix that the
// previous window's last tile publishes.  Inputs are read once, outputs
// written once.  A published value and its status share one 16-byte word,
// stored and loaded by one vector access that bypasses L1 (the tile
// descriptors of CUB's scans do the same), so the look-back needs no
// fence.  A tile whose first entry starts a segment needs no look-back;
// in `period` mode with a period below the tile every tile holds a start,
// so the look-back reads one word.  The launch clears the look-back state
// (the tile counter, the words) with a memset on the stream before the
// kernel, so a CUDA graph that replays the launch resets it each time.
//
// The association is fixed: unlike a decoupled look-back that stops at
// whichever predecessor has published an inclusive prefix (CUB's, whose
// float scans may differ from run to run), a tile's carry depends only on
// the published aggregates, so the same inputs give the same bits on
// every run, as the JAX scans do.  It is another association than a serial
// fold or the plain version's Hillis-Steele scan: on data whose f64
// prefixes are exact (the windows' quarter-grid prices, counts, ranks,
// indices) every association gives the same bits; on raw doubles the
// sums differ from the plain version's in the last bits, within the
// rounding bound of a sum (tests/test_torch_kernel_order.py emulates the
// association).  The cost: a window's tiles wait for every earlier tile
// of the window, and a window's last tile for the window before it (1025
// tiles: four such hops).  Bound on the H100: bytes (each input read once,
// each output written once).  Python side: kernels/win_scan.py.
#include "expr_vm.cuh"
#include "win_scan.cuh"

enum ScanOp { SC_SUM_F = 0, SC_SUM_I = 1, SC_MIN_F = 2, SC_MAX_F = 3, SC_MAX_I = 4 };

struct ScanParams {  // layout mirrored by kernels/win_scan.py _Params
  long long n;
  int n_cols, ntiles;
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
  long long* scratch;          // the look-back state, cleared by the launch:
                               // WS_HEAD longs (the tile counter), then a
                               // (value, status) word per column and tile
};

#define WS_COL_GROUP 16   // columns staged at once
#define WS_HEAD 2         // longs of `scratch` before the words

// status of a (column, tile) word: 0 not yet published, ST_AGG the value
// is the tile's aggregate and no segment starts in the tile, ST_START the
// tile holds a start (the value, its aggregate, is its inclusive prefix),
// ST_INC the value is the inclusive prefix of a window's last tile
enum { ST_AGG = 1, ST_START = 2, ST_INC = 3 };

__device__ __forceinline__ void put_word(long long* w, long long bits, long long status) {
  asm volatile("st.volatile.global.v2.s64 [%0], {%1, %2};" ::"l"(w), "l"(bits), "l"(status)
               : "memory");
}

__device__ __forceinline__ void get_word(const long long* w, long long& bits, long long& status) {
  asm volatile("ld.volatile.global.v2.s64 {%0, %1}, [%2];" : "=l"(bits), "=l"(status) : "l"(w)
               : "memory");
}

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

// f(Op()) for the column's op
template <class F>
__device__ __forceinline__ void with_op(int op, F&& f) {
  switch (op) {
    case SC_SUM_F: f(SumF()); break;
    case SC_SUM_I: f(SumI()); break;
    case SC_MIN_F: f(MinF()); break;
    case SC_MAX_F: f(MaxF()); break;
    default: f(MaxI()); break;
  }
}

// A column's parameters, read once a block into shared memory.
struct ColDesc {
  const void* in;
  void* out;
  const unsigned char* valid;  // the flags masking the column (null: none)
  int in_vt, out_vt, op, pad_;
};

template <class T, class R>
__device__ __forceinline__ T convert(R raw);   // a raw element in the accumulator type
template <>
__device__ __forceinline__ double convert<double, unsigned char>(unsigned char r) { return r != 0; }
template <>
__device__ __forceinline__ double convert<double, int>(int r) { return static_cast<double>(r); }
template <>
__device__ __forceinline__ double convert<double, long long>(long long r) { return static_cast<double>(r); }
template <>
__device__ __forceinline__ double convert<double, float>(float r) { return static_cast<double>(r); }
template <>
__device__ __forceinline__ double convert<double, double>(double r) { return r; }
template <>
__device__ __forceinline__ long long convert<long long, unsigned char>(unsigned char r) { return r != 0; }
template <>
__device__ __forceinline__ long long convert<long long, int>(int r) { return r; }
template <>
__device__ __forceinline__ long long convert<long long, long long>(long long r) { return r; }
template <>
__device__ __forceinline__ long long convert<long long, float>(float r) { return 0; }   // not a column
template <>
__device__ __forceinline__ long long convert<long long, double>(double r) { return 0; }  // not a column

// Stage column d's entries of the tile (striped) into `dst` as the scan
// sees them: the identity past n or where the column is masked off, else
// the value (of element type R) in the accumulator type.  Every load of
// the column is issued before any is used.  PER: the segments come from
// `period` (an instantiation of its own, so the window scans keep their
// code).
template <class Op, bool PER, class R>
__device__ __forceinline__ void stage_col(const ScanParams& p, const ColDesc& d, long long tile0,
                                          long long* dst) {
  typedef typename Op::T T;
  R raw[WS_ITEMS];
  bool ok[WS_ITEMS];
#pragma unroll
  for (int k = 0; k < WS_ITEMS; ++k) {
    const long long i = tile0 + k * WS_THREADS + threadIdx.x;
    ok[k] = i < p.n;
    raw[k] = ok[k] ? static_cast<const R*>(d.in)[i] : R(0);
    if (d.valid != nullptr) ok[k] = ok[k] && d.valid[i] != 0;
  }
#pragma unroll
  for (int k = 0; k < WS_ITEMS; ++k)
    dst[k * WS_THREADS + threadIdx.x] = to_bits(ok[k] ? convert<T, R>(raw[k]) : Op::id());
}

// The same for a column without input: the count's 1, or for a max the
// index within the period.
template <class Op, bool PER>
__device__ __forceinline__ void stage_count(const ScanParams& p, const ColDesc& d, long long tile0,
                                            long long* dst) {
  typedef typename Op::T T;
  bool ok[WS_ITEMS];
#pragma unroll
  for (int k = 0; k < WS_ITEMS; ++k) {
    const long long i = tile0 + k * WS_THREADS + threadIdx.x;
    ok[k] = i < p.n && (d.valid == nullptr || d.valid[i] != 0);
  }
#pragma unroll
  for (int k = 0; k < WS_ITEMS; ++k) {
    const long long i = tile0 + k * WS_THREADS + threadIdx.x;
    const T x = static_cast<T>(d.op == SC_MAX_I ? (PER ? i % p.period : -1) : 1);
    dst[k * WS_THREADS + threadIdx.x] = to_bits(ok[k] ? x : Op::id());
  }
}

template <bool PER>
__device__ __forceinline__ void stage(const ScanParams& p, const ColDesc& d, long long tile0,
                                      long long* dst) {
  with_op(d.op, [&](auto tag) {
    typedef decltype(tag) Op;
    if (d.in == nullptr) {
      stage_count<Op, PER>(p, d, tile0, dst);
      return;
    }
    switch (d.in_vt) {
      case VT_BOOL: stage_col<Op, PER, unsigned char>(p, d, tile0, dst); break;
      case VT_I32: stage_col<Op, PER, int>(p, d, tile0, dst); break;
      case VT_I64: stage_col<Op, PER, long long>(p, d, tile0, dst); break;
      case VT_F32: stage_col<Op, PER, float>(p, d, tile0, dst); break;
      default: stage_col<Op, PER, double>(p, d, tile0, dst); break;
    }
  });
}

__device__ __forceinline__ void store(const ColDesc& d, long long i, long long bits) {
  if (d.op == SC_SUM_I || d.op == SC_MAX_I)
    static_cast<long long*>(d.out)[i] = bits;
  else if (d.out_vt == VT_F32)
    static_cast<float*>(d.out)[i] = static_cast<float>(from_bits<double>(bits));
  else
    static_cast<double*>(d.out)[i] = from_bits<double>(bits);
}

// One tile of every column, in groups of WS_COL_GROUP columns:
//   stage   the columns' entries into shared memory, striped so the loads
//           coalesce;
//   scan    per column the block's segmented scan: each thread's exclusive
//           prefix and the tile's aggregate;
//   publish each column's word: its aggregate (ST_AGG, or ST_START where
//           the tile holds a segment start), or, for the last tile of a
//           look-back window of WS_THREADS tiles, its inclusive prefix;
//   look back at the nearest predecessor's word; where it holds no start,
//           fold the words of the window's earlier tiles (thread k reads
//           tile base + k) in one block scan, four columns' words in
//           flight at once; where no start was met, put the previous
//           window's inclusive prefix in front;
//   publish the window's inclusive prefix (its last tile), carry into
//           every entry, and write every column back striped.
// Which predecessors have finished never enters a value: a tile's carry
// is a fixed function of the words, so every run gives the same bits.
template <bool PER>
__global__ void __launch_bounds__(WS_THREADS) scan_kernel(const __grid_constant__ ScanParams p) {
  extern __shared__ long long stash[];
  __shared__ ColDesc desc[WS_COL_GROUP];
  __shared__ long long tot[WS_COL_GROUP], run[WS_COL_GROUP];
  __shared__ int run_f[WS_COL_GROUP];
  __shared__ int tile_s;
  const int group = min(p.n_cols, WS_COL_GROUP);
  long long* exs = stash + group * WS_TILE;                    // exclusive prefixes
  unsigned char* exf = reinterpret_cast<unsigned char*>(exs + group * WS_THREADS);
  unsigned char* starts = exf + group * WS_THREADS;            // segment starts
  const bool alone = p.ntiles == 1;
  // the tile and the first group's descriptors, side by side
  if (threadIdx.x == 0)
    tile_s = alone ? 0 : static_cast<int>(atomicAdd(reinterpret_cast<unsigned long long*>(p.scratch), 1ULL));
  for (int g0 = 0; g0 < p.n_cols; g0 += group) {
    const int ng = min(p.n_cols - g0, group);
    if (threadIdx.x < ng) {
      const int c = g0 + threadIdx.x;
      const unsigned char* v = p.col_valid[c] != nullptr ? p.col_valid[c] : p.valid;
      desc[threadIdx.x] = ColDesc{p.in[c], p.out[c], p.masked[c] ? v : nullptr, p.in_vt[c],
                                  p.out_vt[c], p.op[c], 0};
    }
    __syncthreads();
    const int tile = tile_s;
    const long long tile0 = static_cast<long long>(tile) * WS_TILE;
    if (g0 == 0) {
#pragma unroll
      for (int k = 0; k < WS_ITEMS; ++k) {
        const long long i = tile0 + k * WS_THREADS + threadIdx.x;
        starts[k * WS_THREADS + threadIdx.x] =
            i < p.n && (PER ? i % p.period == 0 : p.flags != nullptr && p.flags[i] != 0);
      }
    }
    // stage
    for (int c = 0; c < ng; ++c) stage<PER>(p, desc[c], tile0, stash + c * WS_TILE);
    __syncthreads();
    // scan
    const int e0 = threadIdx.x * WS_ITEMS;
    bool known = tile == 0;
    for (int c = 0; c < ng; ++c) {
      with_op(desc[c].op, [&](auto tag) {
        typedef decltype(tag) Op;
        Seg<Op> x = seg_id<Op>();
#pragma unroll
        for (int k = 0; k < WS_ITEMS; ++k)
          x = seg_combine<Op>(x, Seg<Op>{starts[e0 + k] != 0,
                                         from_bits<typename Op::T>(stash[c * WS_TILE + e0 + k])});
        Seg<Op> total;
        const Seg<Op> ex = block_seg_scan<Op>(x, &total);
        exs[c * WS_THREADS + threadIdx.x] = to_bits(ex.v);
        exf[c * WS_THREADS + threadIdx.x] = ex.f;
        known = known || total.f;   // a start in the tile: the same for every column
        if (threadIdx.x == 0) {
          tot[c] = to_bits(total.v);
          run[c] = to_bits(Op::id());
          run_f[c] = 0;
        }
      });
    }
    __syncthreads();
    long long* words = p.scratch + WS_HEAD + 2 * (static_cast<long long>(g0) * p.ntiles);
    // the tile's look-back window: tiles base .. base + WS_THREADS - 1; its
    // last tile publishes only its inclusive prefix, for the next window
    const int base = tile - tile % WS_THREADS;
    const bool closes = tile - base == WS_THREADS - 1;
    if (!alone && threadIdx.x < ng && (!closes || known))
      put_word(words + 2 * (static_cast<long long>(threadIdx.x) * p.ntiles + tile), tot[threadIdx.x],
               closes ? ST_INC : known ? ST_START : ST_AGG);
    // look back; the first entry starting a segment takes no carry
    if (tile > 0 && starts[0] == 0 && tile > base) {
      // the nearest predecessor first: one holding a segment start (every
      // tile, in `period` mode below the tile) gives the carry
      if (threadIdx.x < ng) {
        long long bits, st;
        do {
          get_word(words + 2 * (static_cast<long long>(threadIdx.x) * p.ntiles + tile - 1), bits, st);
        } while (st == 0);
        if (st == ST_START) {
          run[threadIdx.x] = bits;
          run_f[threadIdx.x] = 1;
        }
      }
      __syncthreads();
      // else the window's tiles before this one, thread k reading tile
      // base + k, four columns' words in flight at once
      const int t = base + static_cast<int>(threadIdx.x);
      for (int c0 = 0; c0 < ng; c0 += 4) {
        long long bits[4], st[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          st[cc] = 0;
          if (c0 + cc < ng && t < tile && !run_f[c0 + cc])
            get_word(words + 2 * (static_cast<long long>(c0 + cc) * p.ntiles + t), bits[cc], st[cc]);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int c = c0 + cc;
          if (c >= ng) break;
          if (run_f[c]) continue;        // the same for every thread
          const bool want = t < tile;
          while (want && st[cc] == 0)
            get_word(words + 2 * (static_cast<long long>(c) * p.ntiles + t), bits[cc], st[cc]);
          with_op(desc[c].op, [&](auto tag) {
            typedef decltype(tag) Op;
            const Seg<Op> x = want ? Seg<Op>{st[cc] == ST_START, from_bits<typename Op::T>(bits[cc])}
                                   : seg_id<Op>();
            Seg<Op> total;
            block_seg_scan<Op>(x, &total);
            if (threadIdx.x == 0) {
              run[c] = to_bits(total.v);
              run_f[c] = total.f;
            }
          });
        }
      }
      __syncthreads();
    }
    // a column with no segment start since the window began takes the
    // previous window's inclusive prefix
    if (tile > 0 && starts[0] == 0 && base > 0 && threadIdx.x < ng && !run_f[threadIdx.x]) {
      const int c = threadIdx.x;
      long long bits, st;
      do {
        get_word(words + 2 * (static_cast<long long>(c) * p.ntiles + base - 1), bits, st);
      } while (st != ST_INC);
      with_op(desc[c].op, [&](auto tag) {
        typedef decltype(tag) Op;
        typedef typename Op::T T;
        run[c] = tile == base ? bits
                              : to_bits(seg_combine<Op>(Seg<Op>{false, from_bits<T>(bits)},
                                                        Seg<Op>{false, from_bits<T>(run[c])}).v);
      });
    }
    if (!alone && closes && !known && threadIdx.x < ng) {
      const int c = threadIdx.x;
      with_op(desc[c].op, [&](auto tag) {
        typedef decltype(tag) Op;
        typedef typename Op::T T;
        const Seg<Op> inc = seg_combine<Op>(Seg<Op>{false, from_bits<T>(run[c])},
                                            Seg<Op>{false, from_bits<T>(tot[c])});
        put_word(words + 2 * (static_cast<long long>(c) * p.ntiles + tile), to_bits(inc.v),
                 ST_INC);
      });
    }
    __syncthreads();
    // carry into every entry
    for (int c = 0; c < ng; ++c) {
      with_op(desc[c].op, [&](auto tag) {
        typedef decltype(tag) Op;
        typedef typename Op::T T;
        Seg<Op> acc = seg_combine<Op>(
            Seg<Op>{false, from_bits<T>(run[c])},
            Seg<Op>{exf[c * WS_THREADS + threadIdx.x] != 0, from_bits<T>(exs[c * WS_THREADS + threadIdx.x])});
#pragma unroll
        for (int k = 0; k < WS_ITEMS; ++k) {
          long long* cell = stash + c * WS_TILE + e0 + k;
          acc = seg_combine<Op>(acc, Seg<Op>{starts[e0 + k] != 0, from_bits<T>(*cell)});
          *cell = to_bits(acc.v);
        }
      });
    }
    __syncthreads();
    // write back
    for (int c = 0; c < ng; ++c) {
#pragma unroll
      for (int k = 0; k < WS_ITEMS; ++k) {
        const long long i = tile0 + k * WS_THREADS + threadIdx.x;
        if (i < p.n) store(desc[c], i, stash[c * WS_TILE + k * WS_THREADS + threadIdx.x]);
      }
    }
    __syncthreads();   // the stash and the descriptors are free for the next group
  }
}

// shared bytes of a launch: the staged columns, the exclusive prefixes and
// their flags, and the starts
static size_t stash_bytes(const ScanParams& p) {
  const size_t group = p.n_cols < WS_COL_GROUP ? p.n_cols : WS_COL_GROUP;
  return group * (WS_TILE * sizeof(long long) + WS_THREADS * (sizeof(long long) + 1)) + WS_TILE;
}

extern "C" int win_scan_launch(const ScanParams* params, cudaStream_t stream) {
  const ScanParams& p = *params;
  if (p.n <= 0 || p.n_cols == 0) return 0;
  if (p.ntiles > 1) {
    const cudaError_t err = cudaMemsetAsync(
        p.scratch, 0, (WS_HEAD + 2 * static_cast<size_t>(p.n_cols) * p.ntiles) * sizeof(long long),
        stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t bytes = stash_bytes(p);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        p.period > 0 ? scan_kernel<true> : scan_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.period > 0)
    scan_kernel<true><<<static_cast<unsigned>(p.ntiles), WS_THREADS, bytes, stream>>>(p);
  else
    scan_kernel<false><<<static_cast<unsigned>(p.ntiles), WS_THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
