// K4 scan_chase: the stateless state chase of one `scan` block.
//
// Replaces the chase loop of siddhi_tpu/core/nfa_parallel.py _block_impl
// (:880-1027, family `scan`), vmapped there over the lane axis
// (_make_lane_block :646).  One thread per (lane, candidate head j): every
// event of the block is simulated as a head at once.  Per position below
// the head, from s = (previous match) + 1:
//   * the `within` killer: the first event at or after s whose timestamp
//     passes ts[head] + W, a first-hit on the lane's i64 timestamp max-tree
//     (it fires on a non-matching event too, as the sequential kernel's
//     expiry does, so out-of-order timestamps cannot revive an instance);
//     after a count the next hop takes the count's W;
//   * a threshold hop: the rhs over the captures so far (predicate VM of
//     expr_vm.cuh, loads at the resolved indices), cast to the tree's
//     type, then a first-hit on the hop's tree;
//   * a static hop: a first-hit on the tree of its node mask (> 0);
//   * a count (the head, or below it): rank/select, the first index >= s
//     whose inclusive occurrence rank (K6) reaches ra + min, a `ge`
//     first-hit on the count's i64 rank tree; ra is the head's rank less
//     one (the head is occurrence 1) or the rank at the entry event;
//   * a logical pair: first-hits on both sides' mask trees, done at their
//     min (`or`) or max (`and`); an `or` side captures its first match
//     and is present when it won (a bit of `pres`), an `and` side its
//     last match at or before the completion (the K6 prev pointer);
//   * the match must land before the killer (step_fail: dead when the
//     killer is in the block and came first, pending when neither exists);
//   * a strict-sequence hop instead reads the event at s: its node mask
//     bit, its step conjunction through the VM, its own expiry;
//   * a final count fans out into C candidates, occurrence min + c live
//     when it lands before the killer (bit c of `cand`, its completion in
//     idx row comp_row[c]).
// A head stops at its first failed hop (nothing after a failure changes
// ok or dead).  Outputs: status bits (1 resolved-live: the chain completed
// or, with a final count, its last candidate did; 2 dead; 4 head mask),
// the resolved index rows (0 where the chain failed), cand and pres.  The
// thread keeps the indices it resolved in its own column of `idx`, where
// the VM's loads read them, so no chain length is fixed; hop tables,
// loads, heaps and programs sit in a device table, the programs staged in
// shared memory.  Event columns are read at lane * ev_stride + i: a fused
// multi-query group's lanes share one row of events (ev_stride 0), with
// their own pre-masks, trees and `qparam` values (qparams[i * P + lane]).
// In `dfa` mode (the `dfa` family) a static hop's or logical side's first
// hit is the table lookup of nfa_parallel.py _dfa_next (:777) on K11's
// tables (dfa_tables.cu): the suffix word at s when s's block has a hit at
// or after s, else the packed word of the next block with a hit (the
// block's next pointer), else Lt -- the index a descent of the node's mask
// tree gives, so K3 builds no tree for those nodes.
// A chain with no count or logical position (alg 0) runs an instantiation
// without the rank, logical and candidate code, so it keeps the register
// count (and occupancy) of single-position chases.
// Python side: kernels/scan_chase.py.
#include "seg_tree.cuh"

enum HopKind {
  HOP_STATIC = 0, HOP_THRESHOLD = 1, HOP_STRICT = 2, HOP_LOGICAL = 3, HOP_COUNT = 4,
  HOP_FINAL = 5
};

struct ChaseParams {  // layout mirrored by kernels/scan_chase.py _Params
  int L, F, Lt, S, is_seq, ts_tree, n_loads, ev_stride, P, n_words, n_consts, stage;
  int n_idx, C, head_node, head_rank, head_min, head_within, alg;
  int dfa, NB;                  // dfa mode: K11's tables, NB stride-4 blocks a lane
  const int* nev;
  const int* ts;
  const int* scode;
  const long long* qparams;
  const unsigned* const* pre;   // per chain node
  const int* node_scode;
  const int* pos_node;          // first node of each position
  const int* hop_kind;
  const int* hop_within;
  const int* hop_tree;
  const int* hop_op;
  const int* hop_vt;
  const int* hop_tree2;         // logical: the right side's mask tree
  const int* hop_prev_l;        // logical `and`: prev columns per side
  const int* hop_prev_r;
  const int* hop_side_l;        // logical: idx rows of the sides
  const int* hop_side_r;
  const int* hop_bit_l;         // logical `or`: presence bits per side
  const int* hop_bit_r;
  const int* hop_rank;          // count: its rank column / tree
  const int* hop_min;
  const int* hop_row;           // idx row of the position
  const int* prog_off;
  const int* prog_len;
  const void* const* heap;
  const int* heap_vt;
  const long long* const* rank;       // (L, F) occurrence ranks (K6)
  const long long* const* rank_heap;  // (L, 2 Lt) i64 max-trees (K3)
  const long long* const* prev;       // (L, F) prev-match pointers (K6)
  const int* comp_row;          // idx row of candidate c's completion
  const void* const* load_col;
  const int* load_vt;
  const int* load_pos;          // loc: -1 s, 0 head, r + 1 idx row r
  unsigned char* status;
  int* idx;
  unsigned char* cand;
  int* pres;
  const long long* consts;
  const int* words;
  const int* hop_dfa_l;         // dfa: chase lane of a static hop / left side, -1 none
  const int* hop_dfa_r;         // dfa: chase lane of a logical right side
  const int* dfa_suffix;        // (L, 4 NB) in-block first-hit offsets, 3 bits a lane
  const int* dfa_packed;        // (L, NB) the blocks' first-hit offsets
  const int* dfa_nblk;          // (lanes, L, NB) next block with a hit
};

// VM environment of one head: a load reads its column at the index its
// loc resolved (the head j, or the thread's own entry of an idx row), or
// at s (loc -1).
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

__device__ __forceinline__ bool node_bit(const ChaseParams& p, int gi, long long erow,
                                         long long row, int j, int nev) {
  if (j >= nev) return false;
  if (p.node_scode[gi] >= 0 && p.scode[erow + j] != p.node_scode[gi]) return false;
  const unsigned* w = p.pre[gi];
  const long long cell = row + j;
  return w == nullptr || ((w[cell >> 5] >> (cell & 31)) & 1u);
}

__device__ __forceinline__ const void* lane_heap(const ChaseParams& p, int t, int lane) {
  const int esz = (p.heap_vt[t] == VT_I64 || p.heap_vt[t] == VT_F64) ? 8 : 4;
  return static_cast<const char*>(p.heap[t]) + static_cast<long long>(lane) * 2 * p.Lt * esz;
}

// rank/select: the first index >= s whose inclusive occurrence rank is at
// least r (Lt when none), a `ge` descent of the count's rank tree.
__device__ __forceinline__ int rank_select(const ChaseParams& p, int ci, int lane, int s, long long r) {
  return first_hit(p.rank_heap[ci] + static_cast<long long>(lane) * 2 * p.Lt, VT_I64, p.Lt, s,
                   vm_l(r), TOP_GE);
}

// dfa mode: the first index >= s of the lane's row matching chase lane k
// (Lt when none), from K11's tables.
__device__ __forceinline__ int dfa_next(const ChaseParams& p, int k, int lane, int s) {
  const long long Fp = 4ll * p.NB;
  if (s >= Fp) return p.Lt;
  const int sc = s < 0 ? 0 : s;
  const int b = sc >> 2;
  const int inb = (p.dfa_suffix[lane * Fp + sc] >> (3 * k)) & 7;
  if (inb < 4) return (b << 2) + inb;
  if (b + 1 >= p.NB) return p.Lt;
  const int b2 = p.dfa_nblk[(static_cast<long long>(k) * p.L + lane) * p.NB + b + 1];
  if (b2 >= p.NB) return p.Lt;
  return (b2 << 2) + ((p.dfa_packed[static_cast<long long>(lane) * p.NB + b2] >> (3 * k)) & 7);
}

__device__ __forceinline__ int clip(const ChaseParams& p, int x) {
  return x < 0 ? 0 : (x > p.F - 1 ? p.F - 1 : x);
}

template <bool ALG, bool DFA>
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
  const bool head = node_bit(p, p.head_node, erow, row, j, nev);
  bool ok = head, dead = false, live = false;
  const long long hts = static_cast<long long>(p.ts[erow + j]);
  const void* ts_heap = p.ts_tree >= 0 ? lane_heap(p, p.ts_tree, lane) : nullptr;
  unsigned cand = 0u;
  int pres = 0;
  int cur = j;
  int pend = -1;                       // within of a count awaiting its successor
  auto killer = [&](int s, int within) {
    return first_hit(ts_heap, VT_I64, p.Lt, s, vm_l(hts + static_cast<long long>(within)), TOP_GT);
  };
  auto step = [&](int jn, int kl) {
    const bool good = jn < kl;
    if (!good && kl < p.F) dead = true;
    ok = good;
  };
  if (ALG && p.head_rank >= 0 && ok) {  // a count head: it is occurrence 1
    const long long ra = p.rank[p.head_rank][row + j] - 1;
    const int jn = rank_select(p, p.head_rank, lane, j, ra + p.head_min);
    step(jn, killer(j + 1, p.head_within));
    cur = clip(p, jn);
    pend = p.head_within;
  }
  int pi = 1;
  for (; pi < p.S && ok; ++pi) {
    const int s = cur + 1;
    const int kind = p.hop_kind[pi];
    if (kind == HOP_STRICT) {
      const int sc = s < p.F - 1 ? s : p.F - 1;
      bool m = node_bit(p, p.pos_node[pi], erow, row, sc, nev);
      if (m && p.prog_len[pi] > 0) {
        ChaseEnv env{p, erow, row + j, plane, j, sc, lane};
        m = vm_run(words + p.prog_off[pi], p.prog_len[pi], consts, env).i != 0;
      }
      const bool expired =
          static_cast<long long>(p.ts[erow + sc]) > hts + static_cast<long long>(p.hop_within[pi]);
      const bool have = s < nev;
      const int jn = (have && m && !expired) ? s : p.Lt;
      if (have && (expired || !m)) dead = true;
      ok = jn < p.F;
      cur = clip(p, jn);
    } else if (kind == HOP_STATIC || kind == HOP_THRESHOLD) {
      const int kl = killer(s, pend >= 0 ? pend : p.hop_within[pi]);
      pend = -1;
      int jn;
      if (DFA && kind == HOP_STATIC && p.hop_dfa_l[pi] >= 0) {
        jn = dfa_next(p, p.hop_dfa_l[pi], lane, s);
      } else {
        const int t = p.hop_tree[pi];
        const int hvt = p.heap_vt[t];
        VmVal v = vm_cast(vm_i(0), VT_I32, hvt);
        int op = TOP_GT;
        if (kind == HOP_THRESHOLD) {
          ChaseEnv env{p, erow, row + j, plane, j, s, lane};
          v = vm_cast(vm_run(words + p.prog_off[pi], p.prog_len[pi], consts, env), p.hop_vt[pi],
                      hvt);
          op = p.hop_op[pi];
        }
        jn = first_hit(lane_heap(p, t, lane), hvt, p.Lt, s, v, op);
      }
      step(jn, kl);
      cur = clip(p, jn);
    } else if (ALG && kind == HOP_LOGICAL) {
      const VmVal zero = vm_i(0);
      const int jl = (DFA && p.hop_dfa_l[pi] >= 0)
                         ? dfa_next(p, p.hop_dfa_l[pi], lane, s)
                         : first_hit(lane_heap(p, p.hop_tree[pi], lane), VT_I32, p.Lt, s, zero, TOP_GT);
      const int jr = (DFA && p.hop_dfa_r[pi] >= 0)
                         ? dfa_next(p, p.hop_dfa_r[pi], lane, s)
                         : first_hit(lane_heap(p, p.hop_tree2[pi], lane), VT_I32, p.Lt, s, zero, TOP_GT);
      const bool is_or = p.hop_bit_l[pi] >= 0;
      const int jd = is_or ? (jl < jr ? jl : jr)
                           : ((jl < p.F && jr < p.F) ? (jl > jr ? jl : jr) : p.Lt);
      step(jd, killer(s, p.hop_within[pi]));
      cur = clip(p, jd);
      for (int ni = 0; ni < 2; ++ni) {
        const int jside = ni == 0 ? jl : jr;
        const int r = ni == 0 ? p.hop_side_l[pi] : p.hop_side_r[pi];
        int v;
        if (is_or) {
          v = clip(p, jside);
          if (jside == jd) pres |= 1 << (ni == 0 ? p.hop_bit_l[pi] : p.hop_bit_r[pi]);
        } else {
          const long long pv = p.prev[ni == 0 ? p.hop_prev_l[pi] : p.hop_prev_r[pi]][row + cur];
          v = pv < 0 ? 0 : (pv > p.F - 1 ? p.F - 1 : static_cast<int>(pv));
        }
        p.idx[r * plane + row + j] = v;
      }
    } else if (ALG && kind == HOP_COUNT) {
      const int ci = p.hop_rank[pi];
      const long long ra = p.rank[ci][row + cur];
      const int jn = rank_select(p, ci, lane, cur + 1, ra + p.hop_min[pi]);
      step(jn, killer(cur + 1, p.hop_within[pi]));
      cur = clip(p, jn);
      pend = p.hop_within[pi];
    } else if (ALG) {                  // the final count's candidates
      const int ci = p.hop_rank[pi];
      const long long ra = p.rank[ci][row + cur];
      const int kl = killer(cur + 1, p.hop_within[pi]);
      for (int c = 0; c < p.C; ++c) {
        const int jc = rank_select(p, ci, lane, cur + 1, ra + p.hop_min[pi] + c);
        live = ok && jc < kl;
        if (live) cand |= 1u << c;
        p.idx[p.comp_row[c] * plane + row + j] = clip(p, jc);
      }
    }
    p.idx[p.hop_row[pi] * plane + row + j] = cur;
  }
  if (!ALG || p.hop_kind[p.S - 1] != HOP_FINAL) {
    live = ok;
    cand = ok ? 1u : 0u;
  }
  p.status[row + j] = static_cast<unsigned char>((live ? 1 : 0) | (dead ? 2 : 0) | (head ? 4 : 0));
  p.cand[row + j] = static_cast<unsigned char>(ok ? cand : 0u);
  p.pres[row + j] = ok ? pres : 0;
  // every row of a failed head reads 0
  if (!ok)
    for (int r = 0; r < p.n_idx; ++r) p.idx[r * plane + row + j] = 0;
}

extern "C" int scan_chase_launch(const ChaseParams* params, int smem, cudaStream_t stream) {
  const int threads = 256;
  const long long tiles = (params->F + threads - 1) / threads;
  const unsigned blocks = static_cast<unsigned>(tiles * params->L);
  if (params->alg && params->dfa)
    scan_chase_kernel<true, true><<<blocks, threads, smem, stream>>>(*params);
  else if (params->alg)
    scan_chase_kernel<true, false><<<blocks, threads, smem, stream>>>(*params);
  else if (params->dfa)
    scan_chase_kernel<false, true><<<blocks, threads, smem, stream>>>(*params);
  else
    scan_chase_kernel<false, false><<<blocks, threads, smem, stream>>>(*params);
  return static_cast<int>(cudaGetLastError());
}
