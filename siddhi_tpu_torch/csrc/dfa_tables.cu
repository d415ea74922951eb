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
// Design: one CUDA block (up to 512 threads) per lane walks the lane's
// blocks from right to left in tiles of blockDim.x * R stride-blocks (R =
// 8, so a thread reads 32 consecutive events); a thread builds the suffix
// and packed words of its R blocks in registers, a block-wide suffix min (warp shuffles, then
// one shared row per warp) gives every thread the first hit block after
// its own, and the carry from the tiles to the right closes the scan.
// Words are u32 on the device (stored as int32: at most 24 bits).  A
// fused multi-query group's lanes share one row of events (ev_stride 0)
// with their own pre-masks.  Bound on the H100: bytes -- the pre-mask
// words and the stream codes read once, the suffix words (4 bytes an
// event) and the block rows written once.
// Python side: kernels/dfa_tables.py.
#include <cuda_runtime.h>

#define DFA_R 8          // stride-blocks a thread per tile
#define DFA_MAXK 8       // chase nodes (bits of the symbol word)

struct DfaParams {  // layout mirrored by kernels/dfa_tables.py _Params
  int L, F, NB, nk, ev_stride, pad0;
  const int* nev;
  const int* scode;
  const unsigned* const* pre;  // per chase node, over the (L*F,) lane grid
  const int* node_scode;       // per chase node, -1: any stream
  int* suffix;                 // (L, 4 NB)
  int* packed;                 // (L, NB)
  int* nblk;                   // (nk, L, NB)
};

__device__ __forceinline__ bool chase_bit(const DfaParams& p, int k, long long erow,
                                          long long row, int i, int nev) {
  if (i >= nev) return false;
  if (p.node_scode[k] >= 0 && p.scode[erow + i] != p.node_scode[k]) return false;
  const unsigned* w = p.pre[k];
  const long long cell = row + i;
  return w == nullptr || ((w[cell >> 5] >> (cell & 31)) & 1u);
}

__global__ void __launch_bounds__(512) dfa_tables_kernel(const __grid_constant__ DfaParams p) {
  __shared__ int warp_min[DFA_MAXK][32];
  const int lane = blockIdx.x;
  const int nev = p.nev[lane];
  const long long row = static_cast<long long>(lane) * p.F;
  const long long erow = static_cast<long long>(lane) * p.ev_stride;
  const long long srow = static_cast<long long>(lane) * p.NB * 4;
  const long long brow = static_cast<long long>(lane) * p.NB;
  const long long plane = static_cast<long long>(p.L) * p.NB;
  const int wl = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  const int tile = blockDim.x * DFA_R;
  int carry[DFA_MAXK];
#pragma unroll
  for (int k = 0; k < DFA_MAXK; ++k) carry[k] = p.NB;
  for (int t0 = (p.NB - 1) / tile * tile; t0 >= 0; t0 -= tile) {
    const int b0 = t0 + threadIdx.x * DFA_R;
    unsigned hit[DFA_MAXK];            // bit r: block b0 + r holds a hit of node k
    int mine[DFA_MAXK];                // the thread's first hit block
#pragma unroll
    for (int k = 0; k < DFA_MAXK; ++k) {
      hit[k] = 0u;
      mine[k] = p.NB;
    }
    for (int r = DFA_R - 1; r >= 0; --r) {
      const int b = b0 + r;
      if (b >= p.NB) continue;
      unsigned acc = 0u;               // 3 bits a node: first offset at or after e
      for (int k = 0; k < p.nk; ++k) acc |= 4u << (3 * k);
      for (int e = 3; e >= 0; --e) {
        const int i = 4 * b + e;
        for (int k = 0; k < p.nk; ++k)
          if (chase_bit(p, k, erow, row, i, nev))
            acc = (acc & ~(7u << (3 * k))) | (static_cast<unsigned>(e) << (3 * k));
        p.suffix[srow + i] = static_cast<int>(acc);
      }
      p.packed[brow + b] = static_cast<int>(acc);
#pragma unroll
      for (int k = 0; k < DFA_MAXK; ++k)
        if (k < p.nk && ((acc >> (3 * k)) & 7u) < 4u) {
          hit[k] |= 1u << r;
          mine[k] = b;
        }
    }
    // block-wide suffix min of `mine`: first hit block of the threads after
    // this one (within the tile), then the carry of the tiles to the right
#pragma unroll
    for (int k = 0; k < DFA_MAXK; ++k) {
      if (k >= p.nk) break;
      int v = mine[k];
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_down_sync(0xffffffffu, v, off);
        if (wl + off < 32 && o < v) v = o;
      }
      if (wl == 0) warp_min[k][wid] = v;
      int after = __shfl_down_sync(0xffffffffu, v, 1);
      if (wl == 31) after = p.NB;
      mine[k] = after;                 // exclusive, within the warp
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DFA_MAXK; ++k) {
      if (k >= p.nk) break;
      int later = carry[k];
      for (int w = wid + 1; w < nw; ++w) later = min(later, warp_min[k][w]);
      int run = min(mine[k], later);
      for (int r = DFA_R - 1; r >= 0; --r) {
        const int b = b0 + r;
        if (b >= p.NB) continue;
        if ((hit[k] >> r) & 1u) run = b;
        p.nblk[k * plane + brow + b] = run;
      }
      int tot = carry[k];
      for (int w = 0; w < nw; ++w) tot = min(tot, warp_min[k][w]);
      carry[k] = tot;
    }
    __syncthreads();
  }
}

extern "C" int dfa_tables_launch(const DfaParams* params, int threads, cudaStream_t stream) {
  if (params->nk < 1 || params->nk > DFA_MAXK || threads < 32 || threads > 512 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dfa_tables_kernel<<<params->L, threads, 0, stream>>>(*params);
  return static_cast<int>(cudaGetLastError());
}
