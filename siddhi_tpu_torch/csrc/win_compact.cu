// K8 win_compact: stable compaction of the rows a mask keeps to the front.
//
// Replaces `compact` of siddhi_tpu/core/window_device.py (:803-807; used
// at :835-838): an i32 cumsum of the filter mask and one scatter per
// column, pads filled with a per-column value (the timestamp pad 2^62,
// zeros), and k = the number of kept rows.  The mask arrives as K1's
// ballot words (bit j of word w = row 32w+j); without one, rows 0..n-1
// are kept.  Rows >= n are never kept.  The window plan also compacts its
// output rows with it (the `emit & having` mask of K1's window_select use).
//
// Bound on the H100: bytes -- the mask words and the n rows of each
// column read once, the T slots of each output written once.  A
// compaction moves bits, so every copy is instantiated by the column's
// width (1, 4 or 8 bytes) and never looks at its value type; the host
// orders the columns by width (8, 4, 1), so the blocks of one width are
// neighbours.  One kernel launch a call:
//   * no mask (`copy_kernel`): k = n and row r goes to slot r, so there is
//     no scan.  A block takes one column's run of WC_THREADS * WC_UNITS
//     16-byte units of output; a thread's units lie WC_THREADS apart (the
//     warp's 32 units one 512-byte run) and their loads are in flight
//     together.  A unit holds 16 / width slots: one 16-byte load and
//     store where the input is aligned and every slot is below n, the
//     pad's bits where every slot is at or above n, slot by slot at the
//     ragged ends.  No look-back state and no memset; block 0 writes k.
//   * a mask (`mask_kernel`): tiles of WC_TILE = 1024 rows, 32 ballot
//     words.  Every warp reads the tile's words (lane j word j, one
//     128-byte line), and their popcounts and a warp scan give each
//     word's first place in the tile and the tile's count.  Warp 0 takes
//     the tile's first slot from a decoupled look-back over the earlier
//     tiles' counts (look_back.cuh, K5's; tiles from a ticket), while the
//     other warps list the tile's kept rows in shared memory: lane j of
//     word w puts row 32w + j at the word's place plus popc(w's bits
//     below j).  Each column then writes its kept rows to consecutive
//     slots (neighbouring threads, neighbouring slots) and its pads,
//     neither waiting for k: the dropped rows below n are exactly n - k,
//     dropped row r takes slot n - 1 - (r - pos_r) (pos_r kept rows
//     before it), so a tile whose rows start at r0 after `base` kept ones
//     fills its nd dropped rows' slots, the run ending at n - (r0 - base),
//     and the tiles' runs cover [k, n); slots [n, T) are pads whatever k
//     is, each written by the tile of its own row index.  Tiles wholly at
//     or above n only fill and take no ticket.  The look-back state (the
//     ticket, then a word a tile below n) is each prepared launch's own;
//     the launcher zeroes it with a memset where more than one tile lies
//     below n, so two launches on two streams never share it and a CUDA
//     graph's replays find it zero.  The last tile below n writes k.
// JAX's scatter drops the pads at index T (mode="drop"); here no pad is
// ever scattered.  The column descriptors ride in the parameter block up
// to WC_INLINE columns and in a device table past that (no bound on the
// columns).  The launcher writes the kernels it launched into `launched`.
// Python side: kernels/win_compact.py.
#include <cuda_runtime.h>

#include "look_back.cuh"

#define WC_THREADS 256
#define WC_WARPS (WC_THREADS / 32)
#define WC_TILE 1024        // rows of a masked tile: 32 ballot words
#define WC_UNITS 4          // 16-byte units a thread in the maskless form
#define WC_RUN (WC_THREADS * WC_UNITS * 16)  // output bytes a maskless block
#define WC_INLINE 16        // column descriptors the parameter block carries
#define WC_FULL 0xffffffffu

struct ColDesc {  // layout mirrored by kernels/win_compact.py _Col
  const void* in;
  void* out;                // 16-byte aligned (the host's layout)
  unsigned long long fill;  // the pad's bits, in the low `width` bytes
  int width;                // 1, 4 or 8 bytes
  int pad;
};

struct CompactParams {  // layout mirrored by kernels/win_compact.py _Params
  long long n, T;
  int n_cols;
  int launched;             // out: kernels the last call launched
  int n_w[3];               // columns of width 8, 4 and 1, in that order
  int pad;
  const unsigned* mask;     // ceil(n / 32) words, or null: keep rows < n
  unsigned long long* state;  // masked, more than one tile below n: the
                              // ticket and a word a tile; zeroed by the launcher
  int* k_out;               // 1: the number of kept rows
  const ColDesc* table;     // the descriptors when n_cols > WC_INLINE
  ColDesc inl[WC_INLINE];   // ... else here
};

template <int W>
struct Bits;
template <>
struct Bits<1> {
  typedef unsigned char T;
};
template <>
struct Bits<4> {
  typedef unsigned T;
};
template <>
struct Bits<8> {
  typedef unsigned long long T;
};

__device__ __forceinline__ ColDesc col_of(const CompactParams& p, int c) {
  return p.n_cols <= WC_INLINE ? p.inl[c] : p.table[c];
}

// Maskless blocks of one column of width w.
__host__ __device__ __forceinline__ long long runs_of(long long T, int w) {
  return (T * w + WC_RUN - 1) / WC_RUN;
}

// The pad's bits repeated over 8 bytes.
template <int W>
__device__ __forceinline__ unsigned long long spread(unsigned long long f) {
  if (W == 1) return (f & 0xffull) * 0x0101010101010101ull;
  if (W == 4) return (f & 0xffffffffull) * 0x0000000100000001ull;
  return f;
}

// Run `run` of one column: slots s < n copied from row s, slots n..T-1
// the pad.
template <int W>
__device__ __forceinline__ void copy_run(const ColDesc& d, long long run, long long n, long long T) {
  typedef typename Bits<W>::T E;
  constexpr int V = 16 / W;  // slots a unit
  union Unit {
    uint4 v;
    unsigned long long q[2];
    E e[V];
  };
  const E* in = static_cast<const E*>(d.in);
  E* out = static_cast<E*>(d.out);
  const bool vec_in = (reinterpret_cast<unsigned long long>(in) & 15ull) == 0;
  const unsigned long long f = spread<W>(d.fill);
  Unit u[WC_UNITS];
  long long s0[WC_UNITS];
#pragma unroll
  for (int q = 0; q < WC_UNITS; ++q) {
    s0[q] = ((run * WC_UNITS + q) * WC_THREADS + threadIdx.x) * V;
    if (s0[q] >= T) continue;
    if (s0[q] + V <= n && vec_in) {
      u[q].v = __ldg(reinterpret_cast<const uint4*>(in + s0[q]));
    } else if (s0[q] >= n) {
      u[q].q[0] = f;
      u[q].q[1] = f;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) u[q].e[j] = s0[q] + j < n ? in[s0[q] + j] : static_cast<E>(f);
    }
  }
#pragma unroll
  for (int q = 0; q < WC_UNITS; ++q) {
    if (s0[q] >= T) continue;
    if (s0[q] + V <= T) {
      *reinterpret_cast<uint4*>(out + s0[q]) = u[q].v;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (s0[q] + j < T) out[s0[q] + j] = u[q].e[j];
    }
  }
}

__global__ void __launch_bounds__(WC_THREADS) copy_kernel(const __grid_constant__ CompactParams p) {
  long long b = blockIdx.x;
  int c = 0;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const int w = g == 0 ? 8 : (g == 1 ? 4 : 1);
    const long long per = runs_of(p.T, w);
    const long long span = per * p.n_w[g];
    if (b < span) {
      const ColDesc d = col_of(p, c + static_cast<int>(b / per));
      if (g == 0)
        copy_run<8>(d, b % per, p.n, p.T);
      else if (g == 1)
        copy_run<4>(d, b % per, p.n, p.T);
      else
        copy_run<1>(d, b % per, p.n, p.T);
      break;
    }
    b -= span;
    c += p.n_w[g];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.k_out = static_cast<int>(p.n);
}

// One column of a masked tile: its cnt kept rows (offsets from r0 in
// `list`) to slots base.., the pad into its nd dropped rows' slots dlo..
// and into the slots [plo, phi) at or above n.
template <int W>
__device__ __forceinline__ void tile_run(const ColDesc& d, const unsigned short* list, long long r0,
                                         long long base, int cnt, long long dlo, int nd,
                                         long long plo, long long phi) {
  typedef typename Bits<W>::T E;
  constexpr int R = WC_TILE / WC_THREADS;
  const E* in = static_cast<const E*>(d.in) + r0;
  E* out = static_cast<E*>(d.out);
  const E f = static_cast<E>(d.fill);
  E v[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = q * WC_THREADS + threadIdx.x;
    if (i < cnt) v[q] = in[list[i]];
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = q * WC_THREADS + threadIdx.x;
    if (i < cnt) out[base + i] = v[q];
  }
  for (int i = threadIdx.x; i < nd; i += WC_THREADS) out[dlo + i] = f;
  for (long long s = plo + threadIdx.x; s < phi; s += WC_THREADS) out[s] = f;
}

__global__ void __launch_bounds__(WC_THREADS) mask_kernel(const __grid_constant__ CompactParams p) {
  __shared__ unsigned short s_list[WC_TILE];  // the tile's kept rows, from r0
  __shared__ int s_g;
  __shared__ long long s_base;
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long below = (p.n + WC_TILE - 1) / WC_TILE;  // tiles below n
  long long g = blockIdx.x;
  if (g < below && below > 1) {
    if (threadIdx.x == 0) s_g = static_cast<int>(atomicAdd(p.state, 1ull));
    __syncthreads();
    g = s_g;
  }
  const long long r0 = g * WC_TILE;
  long long base = 0, dlo = 0;
  int cnt = 0, nd = 0;
  if (g < below) {
    const long long row = r0 + 32 * l;
    unsigned word = 0u;
    if (row < p.n) {
      word = p.mask[row >> 5];
      if (p.n - row < 32) word &= (1u << (p.n - row)) - 1u;
    }
    const int c = __popc(word);
    int inc = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(WC_FULL, inc, o);
      if (l >= o) inc += y;
    }
    cnt = __shfl_sync(WC_FULL, inc, 31);
    if (w == 0) {
      const long long before =
          below > 1 ? look_back<false>(p.state + 1, static_cast<int>(g), 0, cnt, 0) : 0;
      if (l == 0) {
        s_base = before;
        if (g == below - 1) *p.k_out = static_cast<int>(before + cnt);
      }
    } else {
      const int place = inc - c;
      for (int j = w - 1; j < 32; j += WC_WARPS - 1) {
        const unsigned wd = __shfl_sync(WC_FULL, word, j);
        const int at = __shfl_sync(WC_FULL, place, j);
        if ((wd >> l) & 1u)
          s_list[at + __popc(wd & ((1u << l) - 1u))] = static_cast<unsigned short>(32 * j + l);
      }
    }
    __syncthreads();
    base = s_base;
    const long long rows = p.n - r0 < WC_TILE ? p.n - r0 : WC_TILE;
    nd = static_cast<int>(rows) - cnt;
    dlo = p.n - (r0 - base) - nd;
  } else if (g == 0 && threadIdx.x == 0) {  // n = 0: no tile below n
    *p.k_out = 0;
  }
  const long long plo = r0 > p.n ? r0 : p.n;
  const long long phi = r0 + WC_TILE < p.T ? r0 + WC_TILE : p.T;
  for (int c = 0; c < p.n_cols; ++c) {
    const ColDesc d = col_of(p, c);
    if (d.width == 8)
      tile_run<8>(d, s_list, r0, base, cnt, dlo, nd, plo, phi);
    else if (d.width == 4)
      tile_run<4>(d, s_list, r0, base, cnt, dlo, nd, plo, phi);
    else
      tile_run<1>(d, s_list, r0, base, cnt, dlo, nd, plo, phi);
  }
}

extern "C" int win_compact_launch(CompactParams* params, cudaStream_t stream) {
  const CompactParams& p = *params;
  params->launched = 0;
  if (p.n < 0 || p.T < p.n || p.n_cols < 0 || p.k_out == nullptr ||
      p.n_w[0] + p.n_w[1] + p.n_w[2] != p.n_cols || (p.n_cols > WC_INLINE && p.table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (p.mask == nullptr) {
    long long blocks = runs_of(p.T, 8) * p.n_w[0] + runs_of(p.T, 4) * p.n_w[1] + runs_of(p.T, 1) * p.n_w[2];
    if (blocks < 1) blocks = 1;  // block 0 writes k
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    copy_kernel<<<static_cast<unsigned>(blocks), WC_THREADS, 0, stream>>>(p);
  } else {
    const long long below = (p.n + WC_TILE - 1) / WC_TILE;
    long long tiles = (p.T + WC_TILE - 1) / WC_TILE;
    if (tiles < 1) tiles = 1;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    if (below > 1) {
      if (p.state == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      err = cudaMemsetAsync(p.state, 0, sizeof(unsigned long long) * (1 + below), stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    mask_kernel<<<static_cast<unsigned>(tiles), WC_THREADS, 0, stream>>>(p);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  params->launched = 1;
  return 0;
}
