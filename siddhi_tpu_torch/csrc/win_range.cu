// K7 win_range: the sliding windows' per-event range reductions.
//
// Replaces the range half of siddhi_tpu/core/window_device.py
// step_sliding: the left edges (:618-622, searchsorted side="right" over
// the valid count for length(L), over the monotone clock for time(D): an
// event exactly D old has expired), the window sums as prefix differences
// (:624-633, and per group `_seg_window_sum` :141 through the sorted
// (segment, position) keys), min/max over [left, i] (the JAX package's
// log2 sparse table, `_sparse_table` :84, `_range_reduce` :99,
// `_seg_window_minmax` :148), avg = sum / max(count, 1) in the compute
// dtype (:652), and the carry's first kept entry `start_k` (:663-670).
//
// The scanned order (arrival, or group-sorted) is cut into tiles of
// WR_TILE entries and each tile into 32 sub-blocks of a warp's width.  A
// range [l, hi] reduces, with at most four reads besides its searches, as
//   across tiles:      suffix to l's tile end (+) the tiles between, from a
//                      sparse table over the tile extremes (+) the prefix
//                      of hi's tile to hi;
//   inside one tile:   the same one level down: suffix to l's sub-block end
//                      (+) the sub-blocks between, from the tile's table over
//                      its 32 sub-block extremes (+) hi's sub-block prefix;
//   inside a sub-block: a loop over its at most 32 values.
// Three launches at most, one without a min/max site, two with one tile:
//   tiles_kernel (min/max sites only): one block of WR_TILE threads a tile,
//           a thread an entry; writes each entry's prefix and suffix in its
//           sub-block and in its tile, the tile's sub-block table and its
//           extreme;
//   table_kernel (min/max sites, more than one tile): one block builds the
//           tile table's upper levels (O(T log T) for T tiles, no O(n log
//           n) array), so no launch keeps state for the next;
//   query_kernel: a thread a scanned slot s, which answers the arrival
//           entry whose range ends there (grouped: entry ks[s] % n, so hi =
//           s and the prefix reads at hi are coalesced).  Its left edge is
//           a binary search over the arrival order (grouped, then one over
//           ks); a sum site reads two prefixes (f64 or i64, from K6) and
//           rounds the difference to its output type; a min/max site reads
//           the pieces above.  One more block finds start_k.
// MinF/MaxF (win_scan.cuh) pick the same value whatever the operand order
// and grouping (the signed zero they prefer, a NaN from either side), so
// the result has the bits of the JAX package's table but for the payload
// of a NaN where two different NaNs meet; the checks compare NaN by
// position.  Bound on the H100: bytes -- the inputs and outputs once (the
// arrays between the launches are the design's own cost, not the
// function's).  Python side: kernels/win_range.py.
#include "expr_vm.cuh"
#include "win_scan.cuh"

#define WR_THREADS WS_THREADS
#define WR_TILE 1024
#define WR_SUBS (WR_TILE / 32)
#define WR_LEVELS 6  // the sub-block table: ranges of 1 .. 32 sub-blocks

enum RangeOp { RG_SUM = 0, RG_AVG = 1, RG_MIN = 2, RG_MAX = 3 };
enum RangeKind { RK_LENGTH = 0, RK_TIME = 1 };

struct RangeParams {  // layout mirrored by kernels/win_range.py _Params
  long long n, first, m, span, last;
  int kind, grouped, n_sites, n_mm;  // n_mm 0: no min/max site, one launch
  int ntiles, t0, qtiles, tlevels;   // T tiles of n; the queries' first tile
                                     // and tiles; the tile table's levels
  int launched;                      // out: kernels the last call launched
  const long long* vcnt;        // arrival order: valid count (length)
  const long long* clock;       // arrival order: monotone clock (time)
  const long long* ks;          // grouped: sorted (segment * n + position) keys; slot s
                                // holds entry ks[s] % n of segment ks[s] / n
  const unsigned char* valid;   // scanned order (min/max see the neutral at invalid entries)
  long long* start_k;           // out: the carry's first kept entry
  const int* op;                // per site
  const void* const* pfx;       // sum/avg: prefix (f64 or i64), scanned order
  const int* pfx_vt;
  const void* const* cnt;       // avg: the valid-count prefix (i64)
  const void* const* vals;      // min/max: values (f32/f64), scanned order
  const int* val_vt;
  double* const* scr;           // min/max: the site's arrays (Scratch below)
  void* const* out;             // m entries each
  const int* out_vt;
};

// One min/max site's arrays, written by tiles_kernel: each entry's prefix
// and suffix in its sub-block (pre32, suf32) and in its tile (pre1k,
// suf1k), each tile's table over its sub-blocks (sub[t][j][k]: sub-blocks
// k .. k + 2^j - 1, clipped), the tile table (tab[j][t]: tiles t .. t +
// 2^j - 1, clipped; level 0 the tile extremes).
struct Scratch {
  double *pre32, *suf32, *pre1k, *suf1k, *sub, *tab;
  __device__ Scratch(const RangeParams& p, int s) {
    pre32 = p.scr[s];
    suf32 = pre32 + p.n;
    pre1k = suf32 + p.n;
    suf1k = pre1k + p.n;
    sub = suf1k + p.n;
    tab = sub + static_cast<long long>(p.ntiles) * WR_LEVELS * WR_SUBS;
  }
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

__device__ __forceinline__ bool is_mm(int op) { return op == RG_MIN || op == RG_MAX; }

__device__ __forceinline__ double mm(int op, double a, double b) {
  return op == RG_MAX ? MaxF::op(a, b) : MinF::op(a, b);
}

__device__ __forceinline__ double mm_id(int op) {
  return op == RG_MAX ? MaxF::id() : MinF::id();
}

// Site s's value at scanned slot x as a double; the neutral past n and at
// invalid entries.
__device__ __forceinline__ double mm_load(const RangeParams& p, int s, int op, long long x) {
  if (x >= p.n) return mm_id(op);
  const bool ok = p.valid == nullptr || p.valid[x];  // loaded beside the value
  const double v = p.val_vt[s] == VT_F32 ? static_cast<double>(static_cast<const float*>(p.vals[s])[x])
                                         : static_cast<const double*>(p.vals[s])[x];
  return ok ? v : mm_id(op);
}

// The warp's inclusive prefix (lanes 0..l) or suffix (lanes l..31) under op.
__device__ __forceinline__ double warp_prefix(int op, double v) {
  const int l = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(WS_FULL, v, o);
    if (l >= o) v = mm(op, y, v);
  }
  return v;
}

__device__ __forceinline__ double warp_suffix(int op, double v) {
  const int l = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_down_sync(WS_FULL, v, o);
    if (l + o < 32) v = mm(op, v, y);
  }
  return v;
}

__global__ void __launch_bounds__(WR_TILE) tiles_kernel(const __grid_constant__ RangeParams p) {
  __shared__ double sub_ext[WR_SUBS], before[WR_SUBS], after[WR_SUBS];
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;  // warp w: sub-block w
  const long long t = blockIdx.x;
  const long long x = t * WR_TILE + threadIdx.x;
  for (int s = 0; s < p.n_sites; ++s) {
    const int op = p.op[s];
    if (!is_mm(op)) continue;
    const Scratch sc(p, s);
    const double v = mm_load(p, s, op, x);
    const double pr = warp_prefix(op, v), sf = warp_suffix(op, v);
    if (l == 31) sub_ext[w] = pr;
    __syncthreads();
    if (w == 0) {  // the sub-blocks before and after each one, the tile's tables
      const double e = sub_ext[l];
      const double inc = warp_prefix(op, e), sfx = warp_suffix(op, e);
      const double up = __shfl_up_sync(WS_FULL, inc, 1), down = __shfl_down_sync(WS_FULL, sfx, 1);
      before[l] = l > 0 ? up : mm_id(op);
      after[l] = l < 31 ? down : mm_id(op);
      double y = e;
      double* sub = sc.sub + t * WR_LEVELS * WR_SUBS;
      sub[l] = y;
      for (int j = 1; j < WR_LEVELS; ++j) {
        const int h = 1 << (j - 1);
        const double z = __shfl_down_sync(WS_FULL, y, h);
        if (l + h < 32) y = mm(op, y, z);
        sub[j * WR_SUBS + l] = y;
      }
      if (l == 0) sc.tab[t] = sfx;
    }
    __syncthreads();
    if (x < p.n) {
      sc.pre32[x] = pr;
      sc.suf32[x] = sf;
      sc.pre1k[x] = mm(op, before[w], pr);
      sc.suf1k[x] = mm(op, sf, after[w]);
    }
    __syncthreads();
  }
}

// The tile table's upper levels over the T tile extremes (level 0, from
// tiles_kernel): in shared memory up to WR_TILE tiles a level, level by
// level from L2 past that.
__global__ void __launch_bounds__(WR_TILE) table_kernel(const __grid_constant__ RangeParams p) {
  const long long T = p.ntiles;
  __shared__ double lev[2][WR_TILE];
  for (int s = 0; s < p.n_sites; ++s) {
    const int op = p.op[s];
    if (!is_mm(op)) continue;
    double* tab = Scratch(p, s).tab;
    if (T <= WR_TILE) {
      if (threadIdx.x < T) lev[0][threadIdx.x] = tab[threadIdx.x];
      __syncthreads();
      for (int j = 1; j < p.tlevels; ++j) {
        const double* a = lev[(j - 1) & 1];
        const int h = 1 << (j - 1), u = threadIdx.x;
        if (u < T) {
          const double v = u + h < T ? mm(op, a[u], a[u + h]) : a[u];
          lev[j & 1][u] = v;
          tab[j * T + u] = v;
        }
        __syncthreads();
      }
      continue;
    }
    for (int j = 1; j < p.tlevels; ++j) {
      const long long h = 1LL << (j - 1);
      for (long long u = threadIdx.x; u < T; u += WR_TILE) {
        const double a = __ldcg(tab + (j - 1) * T + u);
        tab[j * T + u] = u + h < T ? mm(op, a, __ldcg(tab + (j - 1) * T + u + h)) : a;
      }
      __syncthreads();
    }
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

__device__ __forceinline__ int floor_log2(long long x) { return 63 - __clzll(x); }

__global__ void __launch_bounds__(WR_THREADS) query_kernel(const __grid_constant__ RangeParams p) {
  if (blockIdx.x == gridDim.x - 1) {  // the last block: start_k alone
    if (threadIdx.x == 0) {
      long long sk;
      if (p.kind == RK_LENGTH) {
        const long long tot = p.vcnt[p.n - 1];
        sk = upper_bound(p.vcnt, p.n, tot - p.span > 0 ? tot - p.span : 0);
      } else {
        sk = upper_bound(p.clock, p.n, p.clock[p.last > 0 ? p.last : 0] - p.span);
      }
      *p.start_k = sk;
    }
    return;
  }
  const long long s = static_cast<long long>(p.t0) * WR_TILE +
                      static_cast<long long>(blockIdx.x) * WR_THREADS + threadIdx.x;
  if (s >= p.n) return;
  long long i = s, sg = 0;
  if (p.grouped) {
    const long long key = p.ks[s];
    sg = key / p.n;
    i = key - sg * p.n;
  }
  if (i < p.first || i >= p.first + p.m) return;
  const long long e = i - p.first, hi = s;
  long long left;
  if (p.kind == RK_LENGTH) {
    const long long want = p.vcnt[i] - p.span;
    left = upper_bound(p.vcnt, p.n, want > 0 ? want : 0);
  } else {
    left = upper_bound(p.clock, p.n, p.clock[i] - p.span);
  }
  // grouped, the range's first slot: when left <= i, its segment's
  // entries in [left, i] are at most i - left + 1 sorted slots ending at s
  long long lo = left;
  if (p.grouped) {
    const long long from = left > i ? 0 : (s - (i - left) > 0 ? s - (i - left) : 0);
    const long long to = left > i ? p.n : s + 1;
    lo = from + lower_bound(p.ks + from, to - from, sg * p.n + left);
  }
  for (int st = 0; st < p.n_sites; ++st) {
    const int op = p.op[st];
    const int ovt = p.out_vt[st];
    VmVal r;
    if (op == RG_SUM || op == RG_AVG) {
      const bool fl = p.pfx_vt[st] == VT_F64;
      const double df = fl ? pfx_f(p.pfx[st], hi) - pfx_f(p.pfx[st], lo - 1) : 0.0;
      const long long dl = fl ? 0 : pfx_l(p.pfx[st], hi) - pfx_l(p.pfx[st], lo - 1);
      if (op == RG_SUM) {
        r = fl ? to_out_f(df, ovt) : vm_l(dl);
      } else {
        const long long c = pfx_l(p.cnt[st], hi) - pfx_l(p.cnt[st], lo - 1);
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
      const Scratch sc(p, st);
      const long long l = lo < hi ? lo : hi;
      const long long tl = l / WR_TILE, t = hi / WR_TILE;
      double x;
      if (tl == t) {
        const long long sa = l >> 5, sb = hi >> 5;
        if (sa == sb) {
          x = mm_load(p, st, op, l);
          for (long long y = l + 1; y <= hi; ++y) x = mm(op, x, mm_load(p, st, op, y));
        } else {
          x = mm(op, sc.suf32[l], sc.pre32[hi]);
          const long long len = sb - sa - 1;
          if (len > 0) {
            const int j = floor_log2(len);
            const double* sub = sc.sub + (t * WR_LEVELS + j) * WR_SUBS;
            const long long a = sa + 1 - t * WR_SUBS, b = sb - (1LL << j) - t * WR_SUBS;
            x = mm(op, x, mm(op, sub[a], sub[b]));
          }
        }
      } else {
        x = mm(op, sc.suf1k[l], sc.pre1k[hi]);
        const long long len = t - tl - 1;
        if (len > 0) {
          const int j = floor_log2(len);
          const double* tab = sc.tab + j * static_cast<long long>(p.ntiles);
          x = mm(op, x, mm(op, tab[tl + 1], tab[t - (1LL << j)]));
        }
      }
      r = to_out_f(x, ovt);
    }
    vm_write(p.out[st], ovt, e, r);
  }
}

extern "C" int win_range_launch(RangeParams* params, cudaStream_t stream) {
  const RangeParams& p = *params;
  cudaError_t err;
  params->launched = 0;
  if (p.n < 1 || p.qtiles < 1 || p.t0 < 0 || p.t0 + p.qtiles > p.ntiles ||
      static_cast<long long>(p.ntiles) * WR_TILE < p.n ||
      (p.n_mm > 0 && (p.tlevels < 1 || (1LL << (p.tlevels - 1)) < p.ntiles)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.n_mm > 0) {  // some site is a min/max: its arrays first
    tiles_kernel<<<static_cast<unsigned>(p.ntiles), WR_TILE, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    params->launched += 1;
    if (p.tlevels > 1) {
      table_kernel<<<1, WR_TILE, 0, stream>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      params->launched += 1;
    }
  }
  const unsigned blocks = static_cast<unsigned>(p.qtiles) * (WR_TILE / WR_THREADS) + 1;
  query_kernel<<<blocks, WR_THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  params->launched += 1;
  return 0;
}
