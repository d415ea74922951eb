// K4 scan_chase: the stateless state chase of one `scan` block.
//
// Replaces the chase loop of siddhi_tpu/core/nfa_parallel.py _block_impl
// (:887-974, family `scan`, single positions), vmapped there over the lane
// axis (_make_lane_block :646).  One thread per (lane, candidate head j):
// every event of the block is simulated as a head at once.  Per position
// below the head, from s = (previous match) + 1:
//   * the `within` killer: the first event at or after s whose timestamp
//     passes ts[head] + W, a first-hit on the lane's i64 timestamp max-tree
//     (it fires on a non-matching event too, as the sequential kernel's
//     expiry does, so out-of-order timestamps cannot revive an instance);
//   * a threshold hop: the rhs over the captures so far (predicate VM of
//     expr_vm.cuh, loads at the resolved indices), cast to the tree's
//     type, then a first-hit on the hop's tree;
//   * a static hop: a first-hit on the tree of its node mask (> 0);
//   * the match must land before the killer (step_fail: dead when the
//     killer is in the block and came first, pending when neither exists);
//   * a strict-sequence hop instead reads the event at s: its node mask
//     bit, its step conjunction through the VM, its own expiry.
// A head stops at its first failed hop (nothing after a failure changes
// ok or dead).  Outputs: status bits (1 ok, 2 dead, 4 head mask) and the
// resolved index per position below the head (0 where not ok).  The
// thread keeps the indices it resolved in its own column of `idx`, where
// the VM's loads read them, so no chain length is fixed; hop tables, loads,
// heaps and programs sit in a device table, the programs staged in shared
// memory.  Event columns are read at lane * ev_stride + i: a fused
// multi-query group's lanes share one row of events (ev_stride 0), with
// their own pre-masks, trees and `qparam` values (qparams[i * P + lane]).
// Python side: kernels/scan_chase.py.
#include "seg_tree.cuh"

enum HopKind { HOP_STATIC = 0, HOP_THRESHOLD = 1, HOP_STRICT = 2 };

struct ChaseParams {  // layout mirrored by kernels/scan_chase.py _Params
  int L, F, Lt, S, is_seq, ts_tree, n_loads, ev_stride, P, n_words, n_consts, stage;
  const int* nev;
  const int* ts;
  const int* scode;
  const long long* qparams;
  const unsigned* const* pre;
  const int* node_scode;
  const int* hop_kind;
  const int* hop_within;
  const int* hop_tree;
  const int* hop_op;
  const int* prog_off;
  const int* prog_len;
  const int* prog_vt;
  const void* const* heap;
  const int* heap_vt;
  const void* const* load_col;
  const int* load_vt;
  const int* load_pos;
  unsigned char* status;
  int* idx;
  const long long* consts;
  const int* words;
};

// VM environment of one head: a load reads its column at the index the
// chase resolved for its position (the head j at position 0, else the
// thread's own entry of idx), or at s (position -1).
struct ChaseEnv {
  const ChaseParams& p;
  long long erow;        // lane * ev_stride: the lane's row of events
  long long cell;        // lane * F + j: the head's cell
  long long plane;       // L * F
  int j;
  int s;
  int lane;
  __device__ VmVal load(int slot, int vt) {
    const int pos = p.load_pos[slot];
    const int i = pos < 0 ? s : (pos == 0 ? j : p.idx[(pos - 1) * plane + cell]);
    const int have = p.load_vt[slot];
    return vm_as(vm_read(p.load_col[slot], have, erow + i), have, vt);
  }
  __device__ VmVal param(int i, int vt) {
    return vm_const(p.qparams[static_cast<long long>(i) * p.P + lane], vt);
  }
};

__device__ __forceinline__ bool node_bit(const ChaseParams& p, int pi, long long erow,
                                         long long row, int j, int nev) {
  if (j >= nev) return false;
  if (p.node_scode[pi] >= 0 && p.scode[erow + j] != p.node_scode[pi]) return false;
  const unsigned* w = p.pre[pi];
  const long long cell = row + j;
  return w == nullptr || ((w[cell >> 5] >> (cell & 31)) & 1u);
}

__device__ __forceinline__ const void* lane_heap(const ChaseParams& p, int t, int lane) {
  const int esz = (p.heap_vt[t] == VT_I64 || p.heap_vt[t] == VT_F64) ? 8 : 4;
  return static_cast<const char*>(p.heap[t]) + static_cast<long long>(lane) * 2 * p.Lt * esz;
}

__global__ void scan_chase_kernel(const __grid_constant__ ChaseParams p) {
  extern __shared__ long long smem[];
  const int* words = p.words;
  const long long* consts = p.consts;
  if (p.stage) vm_stage(p.words, p.n_words, p.consts, p.n_consts, smem, &words, &consts);
  const int tiles = (p.F + blockDim.x - 1) / blockDim.x;
  const int lane = static_cast<int>(blockIdx.x / tiles);
  const int j = static_cast<int>(blockIdx.x % tiles) * blockDim.x + threadIdx.x;
  if (j >= p.F) return;
  const long long row = static_cast<long long>(lane) * p.F;
  const long long erow = static_cast<long long>(lane) * p.ev_stride;
  const long long plane = static_cast<long long>(p.L) * p.F;
  const int nev = p.nev[lane];
  const bool head = node_bit(p, 0, erow, row, j, nev);
  bool ok = head, dead = false;
  const long long hts = static_cast<long long>(p.ts[erow + j]);
  int cur = j;
  int pi = 1;
  for (; pi < p.S && ok; ++pi) {
    const int s = cur + 1;
    int jn;
    if (p.is_seq) {
      const int sc = s < p.F - 1 ? s : p.F - 1;
      bool m = node_bit(p, pi, erow, row, sc, nev);
      if (m && p.prog_len[pi] > 0) {
        ChaseEnv env{p, erow, row + j, plane, j, sc, lane};
        m = vm_run(words + p.prog_off[pi], p.prog_len[pi], consts, env).i != 0;
      }
      const bool expired =
          static_cast<long long>(p.ts[erow + sc]) > hts + static_cast<long long>(p.hop_within[pi]);
      const bool have = s < nev;
      jn = (have && m && !expired) ? s : p.Lt;
      if (have && (expired || !m)) dead = true;
      ok = jn < p.F;
    } else {
      const int kl = first_hit(lane_heap(p, p.ts_tree, lane), VT_I64, p.Lt, s,
                               vm_l(hts + static_cast<long long>(p.hop_within[pi])), TOP_GT);
      const int t = p.hop_tree[pi];
      const int hvt = p.heap_vt[t];
      VmVal v = vm_cast(vm_i(0), VT_I32, hvt);
      int op = TOP_GT;
      if (p.hop_kind[pi] == HOP_THRESHOLD) {
        ChaseEnv env{p, erow, row + j, plane, j, s, lane};
        v = vm_cast(vm_run(words + p.prog_off[pi], p.prog_len[pi], consts, env),
                    p.prog_vt[pi], hvt);
        op = p.hop_op[pi];
      }
      jn = first_hit(lane_heap(p, t, lane), hvt, p.Lt, s, v, op);
      const bool good = jn < kl;
      if (!good && kl < p.F) dead = true;
      ok = good;
    }
    cur = jn < 0 ? 0 : (jn > p.F - 1 ? p.F - 1 : jn);
    p.idx[(pi - 1) * plane + row + j] = cur;
  }
  p.status[row + j] = static_cast<unsigned char>((ok ? 1 : 0) | (dead ? 2 : 0) | (head ? 4 : 0));
  // positions never reached, and every position of a failed head, read 0
  for (int q = ok ? pi : 1; q < p.S; ++q) p.idx[(q - 1) * plane + row + j] = 0;
}

extern "C" int scan_chase_launch(const ChaseParams* params, int smem, cudaStream_t stream) {
  const int threads = 256;
  const long long tiles = (params->F + threads - 1) / threads;
  scan_chase_kernel<<<static_cast<unsigned>(tiles * params->L), threads, smem, stream>>>(*params);
  return static_cast<int>(cudaGetLastError());
}
