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
// resolved index per position below the head (0 where not ok).
// Python side: kernels/scan_chase.py.
#include "seg_tree.cuh"

#define SC_MAXS 8
#define SC_MAXT 9
#define SC_MAXLOAD 24
#define SC_MAXWORDS 256
#define SC_MAXCONST 32

enum HopKind { HOP_STATIC = 0, HOP_THRESHOLD = 1, HOP_STRICT = 2 };

struct ChaseParams {  // layout mirrored by kernels/scan_chase.py _Params
  int L, F, Lt, S, is_seq, ts_tree, n_loads, pad0;
  const int* nev;
  const int* ts;
  const int* scode;
  const unsigned* pre[SC_MAXS];
  int node_scode[SC_MAXS];
  int hop_kind[SC_MAXS];
  int hop_within[SC_MAXS];
  int hop_tree[SC_MAXS];
  int hop_op[SC_MAXS];
  int prog_off[SC_MAXS];
  int prog_len[SC_MAXS];
  int prog_vt[SC_MAXS];
  const void* heap[SC_MAXT];
  int heap_vt[SC_MAXT];
  const void* load_col[SC_MAXLOAD];
  int load_vt[SC_MAXLOAD];
  int load_pos[SC_MAXLOAD];
  unsigned char* status;
  int* idx;
  long long consts[SC_MAXCONST];
  int words[SC_MAXWORDS];
};

// VM environment of one head: a load reads its column at the index the
// chase resolved for its position, or at s (position -1).
struct ChaseEnv {
  const ChaseParams& p;
  long long row;
  const int* at;
  int s;
  __device__ VmVal load(int slot, int vt) {
    const int pos = p.load_pos[slot];
    const int i = pos >= 0 ? at[pos] : s;
    const int have = p.load_vt[slot];
    return vm_as(vm_read(p.load_col[slot], have, row + i), have, vt);
  }
};

__device__ __forceinline__ bool node_bit(const ChaseParams& p, int pi, long long row, int j,
                                         int nev) {
  if (j >= nev) return false;
  const long long cell = row + j;
  if (p.node_scode[pi] >= 0 && p.scode[cell] != p.node_scode[pi]) return false;
  const unsigned* w = p.pre[pi];
  return w == nullptr || ((w[cell >> 5] >> (cell & 31)) & 1u);
}

__device__ __forceinline__ const void* lane_heap(const ChaseParams& p, int t, int lane) {
  const int esz = (p.heap_vt[t] == VT_I64 || p.heap_vt[t] == VT_F64) ? 8 : 4;
  return static_cast<const char*>(p.heap[t]) + static_cast<long long>(lane) * 2 * p.Lt * esz;
}

__global__ void scan_chase_kernel(const __grid_constant__ ChaseParams p) {
  const int tiles = (p.F + blockDim.x - 1) / blockDim.x;
  const int lane = static_cast<int>(blockIdx.x / tiles);
  const int j = static_cast<int>(blockIdx.x % tiles) * blockDim.x + threadIdx.x;
  if (j >= p.F) return;
  const long long row = static_cast<long long>(lane) * p.F;
  const int nev = p.nev[lane];
  const bool head = node_bit(p, 0, row, j, nev);
  bool ok = head, dead = false;
  int at[SC_MAXS];
  for (int q = 0; q < SC_MAXS; ++q) at[q] = 0;
  at[0] = j;
  const long long hts = static_cast<long long>(p.ts[row + j]);
  int cur = j;
  for (int pi = 1; pi < p.S && ok; ++pi) {
    const int s = cur + 1;
    int jn;
    if (p.is_seq) {
      const int sc = s < p.F - 1 ? s : p.F - 1;
      bool m = node_bit(p, pi, row, sc, nev);
      if (m && p.prog_len[pi] > 0) {
        ChaseEnv env{p, row, at, sc};
        m = vm_run(p.words + p.prog_off[pi], p.prog_len[pi], p.consts, env).i != 0;
      }
      const bool expired =
          static_cast<long long>(p.ts[row + sc]) > hts + static_cast<long long>(p.hop_within[pi]);
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
        ChaseEnv env{p, row, at, s};
        v = vm_cast(vm_run(p.words + p.prog_off[pi], p.prog_len[pi], p.consts, env),
                    p.prog_vt[pi], hvt);
        op = p.hop_op[pi];
      }
      jn = first_hit(lane_heap(p, t, lane), hvt, p.Lt, s, v, op);
      const bool good = jn < kl;
      if (!good && kl < p.F) dead = true;
      ok = good;
    }
    cur = jn < 0 ? 0 : (jn > p.F - 1 ? p.F - 1 : jn);
    at[pi] = cur;
  }
  p.status[row + j] = static_cast<unsigned char>((ok ? 1 : 0) | (dead ? 2 : 0) | (head ? 4 : 0));
  const long long plane = static_cast<long long>(p.L) * p.F;
  for (int q = 1; q < p.S; ++q)
    p.idx[(q - 1) * plane + row + j] = ok ? at[q] : 0;
}

extern "C" int scan_chase_launch(const ChaseParams* params, cudaStream_t stream) {
  const int threads = 256;
  const long long tiles = (params->F + threads - 1) / threads;
  scan_chase_kernel<<<static_cast<unsigned>(tiles * params->L), threads, 0, stream>>>(*params);
  return static_cast<int>(cudaGetLastError());
}
