// K11 dfa_tables: the stride-4 symbol tables of one `dfa` block.
//
// Replaces _dfa_tables of siddhi_tpu/core/nfa_parallel.py (:728, family
// `dfa`), vmapped there over the lane axis.  The chase nodes of a block
// (the static hops below the head and both sides of a logical position,
// at most 8) each own a bit of the event's symbol word: bit k is "event i
// matches chase node k" (valid, its stream, its pre-mask).  Over blocks of
// STRIDE = 4 events, per lane:
//   * suffix[lane][i]: for every chase node k, 3 bits at 3k holding the
//     offset in i's block of the first hit at or after i (4: none);
//   * packed[lane][b]: the same word at the block's first event, i.e. the
//     first-hit offsets of block b for every chase node;
//   * nblk[k][lane][b]: the first block at or after b holding a hit of
//     node k (NB: none), a reverse min-scan over the NB = ceil(F / 4)
//     blocks of the lane.
// K4 (scan_chase.cu, dfa mode) then answers "first event >= s matching
// node k" from the suffix word at s, else the packed word of the block
// nblk[k][b + 1] (nfa_parallel.py _dfa_next :777), instead of a descent
// of a K3 tree over the node's mask.
//
// Design: a lane's stride-blocks fall into tiles of 32 W (W warps a CUDA
// block, up to 8), and the grid is tiles x lanes, so one long lane fills
// the card.  Thread j of a tile owns stride-block b0 + j: it takes its
// four symbol bits of every node from the pre-mask words by a shift (one
// word, two where its cells straddle words; a warp's 32 threads read
// five words, broadcast), its stream codes with
// neighbouring threads on neighbouring events, builds its four suffix
// words by find-first-set on those bits and stores them as one 16-byte
// vector (a warp's stores are one contiguous 512-byte run), the packed
// word beside.  nblk comes in two parts: within the tile from each warp's
// ballot of blocks with a hit (the first set bit at or after the thread's
// own) and the warps to its right (shared memory); across tiles from a
// reverse decoupled look-back, one warp a node: a tile publishes its
// first hit block, then reads the tiles to its right 32 at a time until
// one that has published its inclusive value (the first hit from there
// to the lane's end), and publishes its own.  Min is exact and
// associative, so the result does not depend on which tiles had
// finished.  Tiles are taken from an atomic ticket, right to left within
// a lane, so every tile a block waits on is running already.  The ticket
// and the look-back words are each prepared launch's own tensor, zeroed by
// a memset in the launcher before the kernel, so a CUDA graph's replays
// find them zero and two launches on two streams never share them.  A
// lane of one tile (C4D's 326 events) needs neither.
// Words are u32 on the device (stored as int32: at most 24 bits).  A
// fused multi-query group's lanes share one row of events (ev_stride 0)
// with their own pre-masks.  Bound on the H100: bytes -- the pre-mask
// words and the stream codes read once, the suffix words (4 bytes an
// event) and the block rows written once.
// Python side: kernels/dfa_tables.py.
#include <cuda_runtime.h>

#define DFA_MAXK 8    // chase nodes (bits of the symbol word)
#define DFA_MAXW 8    // warps a CUDA block
#define DFA_STATUS_AGG (1ull << 62)   // a published word: the tile's own first hit
#define DFA_STATUS_INC (2ull << 62)   // ... or the first hit from the tile on
#define DFA_VAL 0xffffffffull

struct DfaParams {  // layout mirrored by kernels/dfa_tables.py _Params
  int L, F, NB, nk, ev_stride, W, T;
  int launched;                // out: kernels the last call launched
  const int* nev;
  const int* scode;
  const unsigned* const* pre;  // per chase node, over the (L*F,) lane grid
  const int* node_scode;       // per chase node, -1: any stream
  int* suffix;                 // (L, 4 NB)
  int* packed;                 // (L, NB)
  int* nblk;                   // (nk, L, NB)
  unsigned long long* state;   // T > 1: the ticket, then the (nk, L, T)
                               // look-back words; zeroed by the launcher
};

__device__ __forceinline__ void dfa_put(unsigned long long* w, unsigned long long v) {
  asm volatile("st.volatile.global.u64 [%0], %1;" ::"l"(w), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long dfa_get(const unsigned long long* w) {
  unsigned long long v;
  asm volatile("ld.volatile.global.u64 %0, [%1];" : "=l"(v) : "l"(w) : "memory");
  return v;
}

// One whole warp: publishes tile `tile`'s first hit block `mine` (NB:
// none) among the lane's T tiles' words, returns the first hit block of
// the tiles to its right and publishes the inclusive value.
__device__ int dfa_look_back(unsigned long long* words, int tile, int T, int mine, int NB) {
  const int l = threadIdx.x & 31;
  if (tile == T - 1) {
    if (l == 0) dfa_put(words + tile, DFA_STATUS_INC | static_cast<unsigned>(mine));
    return NB;
  }
  if (l == 0) dfa_put(words + tile, DFA_STATUS_AGG | static_cast<unsigned>(mine));
  int after = NB;
  for (int start = tile + 1;; start += 32) {
    const int k = start + l;
    unsigned long long v = 0;
    if (k < T) {
      do {
        v = dfa_get(words + k);
      } while ((v >> 62) == 0);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, k < T && (v >> 62) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    int x = (k < T && l <= stop) ? static_cast<int>(v & DFA_VAL) : NB;
    for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
    after = min(after, x);
    if (inc) break;
  }
  if (l == 0) dfa_put(words + tile, DFA_STATUS_INC | static_cast<unsigned>(min(mine, after)));
  return after;
}

__global__ void __launch_bounds__(32 * DFA_MAXW) dfa_tables_kernel(const __grid_constant__ DfaParams p) {
  __shared__ int warp_first[DFA_MAXK][DFA_MAXW];
  __shared__ int carry_in[DFA_MAXK];
  __shared__ int s_ticket;
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  int lane, tile;
  if (p.T > 1) {
    if (threadIdx.x == 0) s_ticket = static_cast<int>(atomicAdd(p.state, 1ull));
    __syncthreads();
    lane = s_ticket / p.T;
    tile = p.T - 1 - s_ticket % p.T;
  } else {
    lane = blockIdx.x;
    tile = 0;
  }
  const int nev = p.nev[lane];
  const long long row = static_cast<long long>(lane) * p.F;
  const long long erow = static_cast<long long>(lane) * p.ev_stride;
  const long long brow = static_cast<long long>(lane) * p.NB;
  const long long plane = static_cast<long long>(p.L) * p.NB;
  const int wb0 = (tile * p.W + w) * 32;  // the warp's first stride-block
  const int b = wb0 + l;
  const int i0 = 4 * b;                   // the thread's first event
  // valid events of the block (bit e: event i0 + e), and their stream codes
  const int nv = min(max(nev - i0, 0), 4);
  const unsigned valid = (1u << nv) - 1u;
  int sc[4] = {-1, -1, -1, -1};
  if (p.scode != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < nv) sc[e] = p.scode[erow + i0 + e];
  }
  unsigned acc[4];  // suffix words of the block's four events
  unsigned hits[DFA_MAXK];  // the warp's blocks with a hit of node k
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0u;
#pragma unroll
  for (int k = 0; k < DFA_MAXK; ++k) {
    hits[k] = 0u;
    if (k >= p.nk) continue;
    unsigned nib = valid;
    const unsigned* pw = p.pre[k];
    if (pw != nullptr && nv > 0) {
      const long long c = row + i0;
      const unsigned sh = static_cast<unsigned>(c & 31);
      unsigned x = pw[c >> 5] >> sh;
      if (sh > 28 && static_cast<int>(32 - sh) < nv) x |= pw[(c >> 5) + 1] << (32 - sh);
      nib &= x;
    }
    const int want = p.node_scode[k];
    if (want >= 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (sc[e] != want) nib &= ~(1u << e);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = __ffs(static_cast<int>(nib >> e));
      acc[e] |= static_cast<unsigned>(f ? e + f - 1 : 4) << (3 * k);
    }
    hits[k] = __ballot_sync(0xffffffffu, nib != 0u && b < p.NB);
    if (l == 0) warp_first[k][w] = hits[k] ? wb0 + __ffs(static_cast<int>(hits[k])) - 1 : p.NB;
  }
  if (b < p.NB) {
    const long long srow = static_cast<long long>(lane) * p.NB * 4;
    *reinterpret_cast<int4*>(p.suffix + srow + i0) =
        make_int4(static_cast<int>(acc[0]), static_cast<int>(acc[1]), static_cast<int>(acc[2]),
                  static_cast<int>(acc[3]));
    p.packed[brow + b] = static_cast<int>(acc[0]);
  }
  __syncthreads();
  // the first hit block to the right of the tile: one warp a node
  if (p.T == 1) {
    if (threadIdx.x < p.nk) carry_in[threadIdx.x] = p.NB;
  } else if (w < p.nk) {
    int mine = p.NB;
    for (int v = 0; v < p.W; ++v) mine = min(mine, warp_first[w][v]);
    unsigned long long* words = p.state + 1 + (static_cast<long long>(w) * p.L + lane) * p.T;
    const int after = dfa_look_back(words, tile, p.T, mine, p.NB);
    if (l == 0) carry_in[w] = after;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < DFA_MAXK; ++k) {
    if (k >= p.nk) continue;
    int run = carry_in[k];
    for (int v = w + 1; v < p.W; ++v) run = min(run, warp_first[k][v]);
    const unsigned h = hits[k] >> l;  // the warp's blocks from b on
    if (h) run = b + __ffs(static_cast<int>(h)) - 1;
    if (b < p.NB) p.nblk[k * plane + brow + b] = run;
  }
}

extern "C" int dfa_tables_launch(DfaParams* params, cudaStream_t stream) {
  const DfaParams& p = *params;
  params->launched = 0;
  if (p.nk < 1 || p.nk > DFA_MAXK || p.W < 1 || p.W > DFA_MAXW || p.T < 1 ||
      static_cast<long long>(p.T) * p.W * 32 < p.NB || (p.T > 1 && (p.W != DFA_MAXW || p.state == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (p.T > 1) {
    err = cudaMemsetAsync(p.state, 0,
                          sizeof(unsigned long long) * (1 + static_cast<long long>(p.nk) * p.L * p.T), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dfa_tables_kernel<<<static_cast<unsigned>(p.L) * p.T, 32 * p.W, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  params->launched = 1;
  return 0;
}
