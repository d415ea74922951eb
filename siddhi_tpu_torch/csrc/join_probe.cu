// K9 join_probe: one probe direction of the device window join.
//
// Replaces, for one direction, the jitted join block of
// siddhi_tpu/core/join_device.py (`DeviceJoinPlan._block_fn`, :261, jit
// :409): window visibility by rank arithmetic and the `on` grid
// (`probes`, :294-327), the pair compaction with its capacity
// (`compact_pairs`, :329-336), the device-computed selector columns
// (`computed_cols`, :338-357) and an outer side's miss words (:382-385).
// Python side: kernels/join_probe.py.
//
// JAX evaluates a dense (T_p, NO + T_o) grid.  A probe a sees exactly the
// opposite positions [max(nlt(a) - Mw, 0), nlt(a)), where nlt(a) = Lo +
// (passed opposite batch events with a smaller seq), Lo the opposite
// mirror's length and Mw its window length (0: windowless, nothing
// visible).  Position p < Lo is mirror slot p (union index p); p >= Lo is
// the (p - Lo)-th passed batch event j (union index NO + j).  So the
// kernel does O(T_p * Mw) pair tests, in one launch a direction (two with
// an opposite filter):
//   1. (opposite filter only) rank_kernel: the exclusive count of the
//      opposite pass bits (o_rank) and the batch index of each passed
//      event (o_idx), a single-pass scan: a pass word a thread, a tile of
//      8192 events a block, each tile's offset from a decoupled look-back
//      over the earlier tiles' published counts;
//   2. probe_kernel, persistent blocks that take tiles of TP consecutive
//      probes (TP = 4..32, picked at launch: enough tiles to fill the
//      card, a bitmap that fits) from an atomic counter, so every tile's
//      predecessors are already running.  A tile:
//        - finds each probe's visible range [lo, hi) (its seq's place
//          among the opposite batch's sorted seqs: the tile's first and
//          last probes by a 32-way warp search, the others by a binary
//          search between those two places) and stages its probes'
//          columns in shared memory;
//        - walks the union of its probes' ranges in chunks of 256
//          positions, each chunk's opposite columns copied into a
//          two-slot shared-memory ring with cp.async (a gather through
//          o_idx under an opposite filter) while the block tests the
//          chunk before it: thread t takes position c0 + t and runs the
//          `on` program against the tile's probes whose ranges hold it,
//          four probes a pass (one decode of each instruction and one
//          read of the opposite value for four independent evaluations
//          with the predicate VM's operations, expr_vm.cuh; the stacks
//          in shared memory, as deep as the program needs), so an
//          opposite row is read from device memory once per tile, not
//          once per probe;
//        - keeps each probe's match bits (a warp's ballot is one word of
//          the probe's row, positions counted from lo & ~31) and counts,
//          so `on` runs once per visible pair;
//        - publishes its pair count and takes its first pair slot from a
//          decoupled look-back over the earlier tiles' counts (integer
//          sums: the same slots whichever tiles have finished), writes
//          its miss bits (bit j of word w = probe 32w + j, `bits32`'s
//          layout), then walks the bits and writes each pair (a, b) at
//          its slot in (a, then b) order -- JAX's flat grid order -- with
//          every computed selector program evaluated into its column;
//          slots >= M are counted and not written (the plan re-launches
//          with a larger M);
//      and the last block to finish writes -1 / 0 into the slots from
//      the total to M (the outputs are a function of the inputs alone).
//      The look-back state (tickets, the finish counter, a word a tile)
//      is a prepared launch's own; the launcher zeroes it with a memset
//      before the kernels, so a CUDA graph's replays find it zero and
//      two launches on two streams never share it.
// Bound on the H100: operations -- T_p * Mw pair tests of the `on`
// program, each a few VM instructions, once the probes outnumber the
// window; each opposite row is read from L2 once per tile and tested
// from shared memory.  What the card showed (scripts/kernel_ab.py): the
// interpreter's stack in local memory (128 bytes a thread and probe)
// overflowed L1 at a thousand threads an SM and sent every stack access
// to L2 -- moving it to shared memory took J6W from 1.41 to 0.56 ms.
// Four probes a pass (JP_GROUP) and four blocks an SM (BLOCKS_PER_SM in
// kernels/join_probe.py) are fixed design points: one, two and eight probes a pass and
// six and eight blocks an SM were slower in development builds.  Built
// with --fmad=false like K1-K8, so f32 `on`
// and selector arithmetic equals the plain version's and the JAX
// package's bit for bit.
#include <climits>

#include "expr_vm.cuh"
#include "look_back.cuh"
#include "win_scan.cuh"

#define JP_THREADS WS_THREADS            // 256
#define JP_WARPS (JP_THREADS / 32)
#define JP_CHUNK JP_THREADS              // window positions a ring slot holds
#define JP_SLOT_BYTES (JP_CHUNK * 8)     // a staged column in one ring slot
#define JP_RANK_TILE (JP_THREADS * 32)   // opposite events a rank tile
#define JP_HEAD 3                        // look-back state: the probe ticket and
                                         // finish counter, the rank ticket, then
                                         // the tiles' words

struct JoinParams {  // layout mirrored by kernels/join_probe.py _Params
  int n_p, n_o, Lo, NO, Mw, M;
  int n_pc, n_oc, n_out, has_on, n_words, n_consts;
  int stage, tp, rw, ntiles;   // probes a tile, bitmap words a probe, tiles
  int nrt, chunk, group;       // rank tiles; the JP_CHUNK and JP_GROUP the
                               // host laid shared memory out for (checked)
  int launched, off_vt, off_probe;        // kernels the last call launched;
                                          // shared-memory offsets:
  int off_win, off_bits, off_stack, smem; // vts, probe rows, ring, bitmap,
                                          // the `on` program's stacks
  const void* const* p_cols;   // n_pc probe columns, rows [0, n_p)
  const void* const* o_mcols;  // n_oc opposite mirror columns, NO rows
  const void* const* o_bcols;  // n_oc opposite batch columns, rows [0, n_o)
  const int* p_vt;
  const int* o_vt;
  const long long* p_seq;      // probe seqs
  const long long* o_seq;      // opposite batch seqs, ascending
  const unsigned* p_pass;      // probe pass words; null: every probe passes
  const unsigned* o_pass;      // opposite pass words; null: all pass
  void* const* outs;           // n_out computed selector columns, M rows
  const int* out_vt;
  const int* prog_off;         // program 0 is `on` when has_on
  const int* prog_len;
  const long long* consts;
  const int* words;
  int* o_rank;                 // n_o + 1: passed opposite events before j
  int* o_idx;                  // n_o: batch index of the r-th passed one
  unsigned long long* state;   // look-back state, zeroed by the launcher
  unsigned* gbits;             // the blocks' bitmaps when a tile's do not
                               // fit in shared memory (null: they do)
  long long* total;            // [0]: pairs of this direction
  int* pa;                     // M: probe index of each pair
  int* pb;                     // M: union index of each pair
  unsigned* miss;              // ceil(n_p / 32) words, or null
};

__device__ __forceinline__ bool pass_bit(const unsigned* w, long long i) {
  return w == nullptr || ((w[i >> 5] >> (i & 31)) & 1u) != 0;
}

__device__ __forceinline__ int opp_rank(const JoinParams& p, int c) {
  return p.o_pass != nullptr ? p.o_rank[c] : c;
}

__device__ __forceinline__ int opp_index(const JoinParams& p, int r) {
  return p.o_pass != nullptr ? p.o_idx[r] : r;
}

__device__ __forceinline__ int union_index(const JoinParams& p, int pos) {
  return pos < p.Lo ? pos : p.NO + opp_index(p, pos - p.Lo);
}

// The opposite row of a window position: mirror slot, or batch row.
__device__ __forceinline__ const char* opp_row(const JoinParams& p, int j, int pos, int size) {
  return pos < p.Lo ? static_cast<const char*>(p.o_mcols[j]) + static_cast<long long>(pos) * size
                    : static_cast<const char*>(p.o_bcols[j]) +
                          static_cast<long long>(opp_index(p, pos - p.Lo)) * size;
}

__device__ __forceinline__ int vt_size(int vt) {
  return vt == VT_BOOL ? 1 : (vt == VT_I64 || vt == VT_F64) ? 8 : 4;
}

// The first batch event whose seq is not below s, in [l, h] (o_seq
// ascending over [l, h)), by one whole warp: each round tests 32 pivots
// at once, so 2^16 events take four rounds of loads instead of sixteen.
__device__ int warp_lower_bound(const long long* o_seq, int l, int h, long long s) {
  const int lane = threadIdx.x & 31;
  while (l < h) {
    const int width = h - l;
    const int stride = width <= 32 ? 1 : (width + 31) / 32;
    const int q = l + (lane + 1) * stride - 1;
    const unsigned below = __ballot_sync(0xffffffffu, q < h && o_seq[q] < s);
    const int c = __popc(below);          // the pivots below s come first
    if (stride == 1) return l + c;
    const int nl = l + c * stride;
    h = min(h, l + (c + 1) * stride - 1);
    l = nl;
  }
  return l;
}

// Called by every thread of a block after its last tile: true in the one
// block that finishes last (every other block has then taken its last
// ticket and published everything).
__device__ __forceinline__ bool last_block(unsigned long long* done) {
  __shared__ int s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(done, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last != 0;
}

// The opposite pass ranks: o_rank[i] = passed events before i (and
// o_rank[n_o], their total), o_idx[r] = the r-th passed event.
__global__ void __launch_bounds__(JP_THREADS) rank_kernel(const __grid_constant__ JoinParams p) {
  __shared__ int s_tile;
  __shared__ long long s_base;
  unsigned long long* st = p.state;
  unsigned long long* words = st + JP_HEAD;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(st + 2, 1ull));
  __syncthreads();
  const int tile = s_tile;
  const long long wd = static_cast<long long>(tile) * JP_THREADS + threadIdx.x;
  const long long i0 = wd * 32;
  unsigned bits = 0u;
  if (i0 < p.n_o) {
    bits = p.o_pass[wd];
    if (p.n_o - i0 < 32) bits &= (1u << (p.n_o - i0)) - 1u;
  }
  Seg<SumI> total;
  const Seg<SumI> ex = block_seg_scan<SumI>(Seg<SumI>{false, __popc(bits)}, &total);
  if (threadIdx.x < 32) {
    const long long base = look_back<false>(words, tile, 0, total.v, 0);
    if (threadIdx.x == 0) s_base = base;
  }
  __syncthreads();
  long long r = s_base + ex.v;
  for (int j = 0; j < 32 && i0 + j < p.n_o; ++j) {
    p.o_rank[i0 + j] = static_cast<int>(r);
    if ((bits >> j) & 1u) p.o_idx[r++] = static_cast<int>(i0 + j);
  }
  if (tile == p.nrt - 1 && threadIdx.x == 0) p.o_rank[p.n_o] = static_cast<int>(s_base + total.v);
}

#define JP_GROUP 4  // probes one pass of `on` tests

// `on` for G probes of the tile (i0 .. i0 + G - 1) against window position
// q of the chunk at once: one decode of each instruction, one read of the
// opposite row's staged value, G independent evaluations (the VM's own
// operations, expr_vm.cuh, so the results are vm_run's bit for bit).
// Probe slots read the tile's staged probe rows, opposite slots the ring
// slot.  The stack is the thread's column of a shared-memory array
// (entry (depth, k) at stk[(depth * G + k) * JP_THREADS]), as deep as the
// program needs: a local-memory stack at a thousand threads an SM spills
// out of L1.  out[k]: the program's truth for probe i0 + k.
template <int G>
__device__ __forceinline__ void on_group(const int* words, int len, const long long* consts,
                                         const VmVal* prow, const unsigned char* slot,
                                         const int* vt, int n_pc, int tp, int i0, int q,
                                         VmVal* stk, bool (&out)[G]) {
  VmVal* base = stk + threadIdx.x;
  auto st = [base](int d, int k) -> VmVal& { return base[(d * G + k) * JP_THREADS]; };
  int sp = 0;
  for (int pc = 0; pc < len; pc += 2) {
    const int w = words[pc];
    const int arg = words[pc + 1];
    const int op = w & 0xFF, t = (w >> 8) & 0xF, t2 = (w >> 12) & 0xF;
    switch (op) {
      case OP_LOAD: {
        const int have = vt[arg];
        if (arg < n_pc) {
#pragma unroll
          for (int k = 0; k < G; ++k) st(sp, k) = vm_as(prow[arg * tp + i0 + k], have, t);
        } else {
          const VmVal v = vm_as(vm_read(slot + (arg - n_pc) * JP_SLOT_BYTES, have, q), have, t);
#pragma unroll
          for (int k = 0; k < G; ++k) st(sp, k) = v;
        }
        ++sp;
        break;
      }
      case OP_CONST:
      case OP_QPARAM: {  // no lane parameters in a join
        const VmVal v = op == OP_CONST ? vm_const(consts[arg], t) : vm_i(0);
#pragma unroll
        for (int k = 0; k < G; ++k) st(sp, k) = v;
        ++sp;
        break;
      }
      case OP_CAST:
#pragma unroll
        for (int k = 0; k < G; ++k) st(sp - 1, k) = vm_cast(st(sp - 1, k), t2, t);
        break;
      case OP_ADD: case OP_SUB: case OP_MUL: case OP_DIV: case OP_MOD:
      case OP_MIN: case OP_MAX:
        --sp;
#pragma unroll
        for (int k = 0; k < G; ++k) st(sp - 1, k) = vm_arith(op, t, st(sp - 1, k), st(sp, k));
        break;
      case OP_LT: case OP_LE: case OP_GT: case OP_GE: case OP_EQ: case OP_NE:
        --sp;
#pragma unroll
        for (int k = 0; k < G; ++k) st(sp - 1, k) = vm_i(vm_cmp(op, t, st(sp - 1, k), st(sp, k)));
        break;
      case OP_AND:
        --sp;
#pragma unroll
        for (int k = 0; k < G; ++k) st(sp - 1, k) = vm_i(st(sp - 1, k).i & st(sp, k).i);
        break;
      case OP_OR:
        --sp;
#pragma unroll
        for (int k = 0; k < G; ++k) st(sp - 1, k) = vm_i(st(sp - 1, k).i | st(sp, k).i);
        break;
      case OP_SELECT:
        sp -= 2;
#pragma unroll
        for (int k = 0; k < G; ++k) st(sp - 1, k) = st(sp - 1, k).i ? st(sp, k) : st(sp + 1, k);
        break;
      default:
#pragma unroll
        for (int k = 0; k < G; ++k) st(sp - 1, k) = vm_unary(op, t, st(sp - 1, k));
        break;
    }
  }
#pragma unroll
  for (int k = 0; k < G; ++k) out[k] = st(0, k).i != 0;
}

// One chunk's pair tests: thread t takes window position c0 + t against
// the tile's probes, G at a time; a warp's ballot is one bitmap word of
// each probe, its popcount the probe's count.
template <int G>
__device__ __forceinline__ void test_chunk(const int* words, int len, const long long* consts,
                                           const VmVal* prow, const unsigned char* slot,
                                           const int* vt, int n_pc, int tp, int rw, int c0,
                                           const int* s_lo, const int* s_hi, int* s_cnt,
                                           unsigned* bits, VmVal* stk) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int pos = c0 + t;
  for (int i0 = 0; i0 < tp; i0 += G) {
    bool touch[G], act[G], m[G];
    bool any = false, live = false;
#pragma unroll
    for (int k = 0; k < G; ++k) {  // the same in every thread
      const int lo = s_lo[i0 + k], hi = s_hi[i0 + k];
      touch[k] = hi > c0 && lo < c0 + JP_CHUNK;
      act[k] = pos >= lo && pos < hi;
      any = any || touch[k];
      live = live || act[k];
      m[k] = false;
    }
    if (!any) continue;
    if (live) on_group<G>(words, len, consts, prow, slot, vt, n_pc, tp, i0, t, stk, m);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (!touch[k]) continue;
      const unsigned bal = __ballot_sync(0xffffffffu, act[k] && m[k]);
      if (lane == 0 && bal != 0u) {
        const int i = i0 + k;
        bits[i * rw + ((c0 + 32 * w - (s_lo[i] & ~31)) >> 5)] = bal;
        atomicAdd(&s_cnt[i], __popc(bal));
      }
    }
  }
}

// A pair's environment for the computed columns: slots [0, n_pc) read the
// probe's row a, the others the opposite union entry b (mirror slot, or
// batch row b - NO), both from device memory (a written pair's rows).
struct PairEnv {
  const JoinParams& p;
  int a;
  int b;
  __device__ VmVal load(int slot, int vt) {
    if (slot < p.n_pc) {
      const int have = p.p_vt[slot];
      return vm_as(vm_read(p.p_cols[slot], have, a), have, vt);
    }
    const int j = slot - p.n_pc;
    const int have = p.o_vt[j];
    const VmVal v = b < p.NO ? vm_read(p.o_mcols[j], have, b)
                             : vm_read(p.o_bcols[j], have, b - p.NO);
    return vm_as(v, have, vt);
  }
  __device__ VmVal param(int, int) { return vm_i(0); }  // no lane parameters
};

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(s))),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(s))),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the opposite columns of window positions [c0, c0 + JP_CHUNK) that
// lie below u1 into a ring slot: thread t copies position c0 + t of every
// column (4- and 8-byte values with cp.async, one commit group a chunk;
// BOOL bytes by a plain load, seen after the barrier that ends the wait).
__device__ __forceinline__ void stage_chunk(const JoinParams& p, const int* vt, unsigned char* slot,
                                            int c0, int u1) {
  const int pos = c0 + static_cast<int>(threadIdx.x);
  if (pos < u1) {
    for (int j = 0; j < p.n_oc; ++j) {
      const int have = vt[p.n_pc + j];
      const int size = vt_size(have);
      const char* src = opp_row(p, j, pos, size);
      unsigned char* dst = slot + j * JP_SLOT_BYTES + threadIdx.x * size;
      if (size == 8)
        cp_async8(dst, src);
      else if (size == 4)
        cp_async4(dst, src);
      else
        *dst = *reinterpret_cast<const unsigned char*>(src);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(JP_THREADS) probe_kernel(const __grid_constant__ JoinParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_lo[32], s_hi[32], s_cnt[32], s_pre[32];
  __shared__ int s_tile, s_u0, s_u1, s_lb[2];
  __shared__ long long s_base;
  unsigned long long* st = p.state;
  unsigned long long* words_lb = st + JP_HEAD + p.nrt;
  const int* words = p.words;
  const long long* consts = p.consts;
  if (p.stage) vm_stage(p.words, p.n_words, p.consts, p.n_consts,
                        reinterpret_cast<long long*>(smem), &words, &consts);
  int* vt = reinterpret_cast<int*>(smem + p.off_vt);
  VmVal* prow = reinterpret_cast<VmVal*>(smem + p.off_probe);
  unsigned char* ring = smem + p.off_win;
  VmVal* stk = reinterpret_cast<VmVal*>(smem + p.off_stack);
  unsigned* bits = p.gbits != nullptr
                       ? p.gbits + static_cast<long long>(blockIdx.x) * p.tp * p.rw
                       : reinterpret_cast<unsigned*>(smem + p.off_bits);
  for (int k = threadIdx.x; k < p.n_pc + p.n_oc; k += JP_THREADS)
    vt[k] = k < p.n_pc ? p.p_vt[k] : p.o_vt[k - p.n_pc];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int tp = p.tp, rw = p.rw;
  const int on_off = p.has_on ? p.prog_off[0] : 0;
  const int on_len = p.has_on ? p.prog_len[0] : 0;
  const int first = p.has_on ? 1 : 0;
  while (true) {
    if (t == 0) s_tile = static_cast<int>(atomicAdd(st, 1ull));
    __syncthreads();
    const int tile = s_tile;
    if (tile >= p.ntiles) break;
    const int a0 = tile * tp;
    const int np_t = min(tp, p.n_p - a0);
    // the tile's first and last probes' places among the opposite batch
    // (warps 0 and 1); the probes between them, whose seqs lie between,
    // search only that span
    if (w < 2 && p.Mw > 0)
      s_lb[w] = warp_lower_bound(p.o_seq, 0, p.n_o, p.p_seq[a0 + (w == 0 ? 0 : np_t - 1)]);
    __syncthreads();
    // the probes' visible ranges (empty: failed filter, no window) and rows
    if (t < tp) {
      int lo = 0, hi = 0;
      if (t < np_t && p.Mw > 0 && pass_bit(p.p_pass, a0 + t)) {
        const long long s = p.p_seq[a0 + t];
        int l = s_lb[0], h = s_lb[1];
        while (l < h) {  // first batch event whose seq is not below the probe's
          const int mid = (l + h) >> 1;
          if (p.o_seq[mid] < s)
            l = mid + 1;
          else
            h = mid;
        }
        hi = p.Lo + opp_rank(p, l);
        lo = max(hi - p.Mw, 0);
      }
      s_lo[t] = lo;
      s_hi[t] = hi;
      s_cnt[t] = p.has_on ? 0 : hi - lo;
    }
    if (p.has_on) {
      for (int x = t; x < p.n_pc * tp; x += JP_THREADS) {
        const int c = x / tp, i = x - c * tp;
        prow[x] = i < np_t ? vm_read(p.p_cols[c], vt[c], a0 + i) : vm_l(0);
      }
      for (int x = t; x < tp * rw; x += JP_THREADS) bits[x] = 0u;
    }
    __syncthreads();
    if (w == 0) {  // the union of the ranges, its start on a word boundary
      int lo = INT_MAX, hi = 0;
      if (lane < tp && s_lo[lane] < s_hi[lane]) {
        lo = s_lo[lane];
        hi = s_hi[lane];
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (lane == 0) {
        s_u0 = lo == INT_MAX ? 0 : (lo & ~31);
        s_u1 = lo == INT_MAX ? 0 : hi;
      }
    }
    __syncthreads();
    const int u0 = s_u0, u1 = s_u1;
    const int nch = p.has_on && u1 > u0 ? (u1 - u0 + JP_CHUNK - 1) / JP_CHUNK : 0;
    if (nch > 0) stage_chunk(p, vt, ring, u0, u1);
    for (int c = 0; c < nch; ++c) {
      const int c0 = u0 + c * JP_CHUNK;
      if (c + 1 < nch) {
        stage_chunk(p, vt, ring + ((c + 1) & 1) * p.n_oc * JP_SLOT_BYTES, c0 + JP_CHUNK, u1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const unsigned char* slot = ring + (c & 1) * p.n_oc * JP_SLOT_BYTES;
      if (tp >= JP_GROUP)
        test_chunk<JP_GROUP>(words + on_off, on_len, consts, prow, slot, vt, p.n_pc, tp, rw, c0,
                             s_lo, s_hi, s_cnt, bits, stk);
      else
        test_chunk<1>(words + on_off, on_len, consts, prow, slot, vt, p.n_pc, tp, rw, c0, s_lo,
                      s_hi, s_cnt, bits, stk);
      __syncthreads();  // the slot is refilled two chunks on
    }
    // the probes' first slots in the tile, the tile's, its miss bits
    if (w == 0) {
      const int cnt = lane < tp ? s_cnt[lane] : 0;
      int inc = cnt;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      if (lane < tp) s_pre[lane] = inc - cnt;
      const long long agg = __shfl_sync(0xffffffffu, inc, 31);
      const long long base = p.ntiles == 1 ? 0 : look_back<false>(words_lb, tile, 0, agg, 0);
      if (lane == 0) {
        s_base = base;
        if (tile == p.ntiles - 1) p.total[0] = base + agg;
      }
      if (p.miss != nullptr) {
        const bool m = lane < np_t && cnt == 0 && pass_bit(p.p_pass, a0 + lane);
        const unsigned bal = __ballot_sync(0xffffffffu, m);
        if (lane == 0) {
          unsigned* mw = p.miss + (a0 >> 5);
          const int sh = a0 & 31;
          if (tp == 32) {
            *mw = bal;
          } else {  // the tile's bits of the word; the last tile also the
                    // bits past n_p, so no bit of the word keeps old bits
            unsigned mask = ((1u << tp) - 1u) << sh;
            if (tile == p.ntiles - 1) mask = ~0u << sh;
            atomicAnd(mw, ~mask);
            atomicOr(mw, (bal & ((1u << tp) - 1u)) << sh);
          }
        }
      }
    }
    __syncthreads();
    // the pairs, probe by probe (a warp each), word by word (a lane each)
    const long long base = s_base;
    for (int i = w; i < tp && base < p.M; i += JP_WARPS) {
      const int lo = s_lo[i], hi = s_hi[i];
      long long run = base + s_pre[i];
      if (lo >= hi || run >= p.M) continue;
      const int rb = lo & ~31;
      const int nw = ((hi - 1 - rb) >> 5) + 1;
      for (int r0 = 0; r0 < nw && run < p.M; r0 += 32) {
        const int r = r0 + lane;
        unsigned word = 0u;
        if (r < nw) {
          if (p.has_on) {
            word = bits[i * rw + r];
          } else {  // no `on`: every visible position
            const int wlo = max(lo - (rb + 32 * r), 0), whi = min(hi - (rb + 32 * r), 32);
            word = whi > wlo ? ((whi - wlo == 32 ? ~0u : ((1u << (whi - wlo)) - 1u)) << wlo) : 0u;
          }
        }
        const int cnt = __popc(word);
        int inc = cnt;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += y;
        }
        long long slot = run + inc - cnt;
        while (word != 0u && slot < p.M) {
          const int pos = rb + 32 * r + __ffs(word) - 1;
          word &= word - 1u;
          const int a = a0 + i, b = union_index(p, pos);
          p.pa[slot] = a;
          p.pb[slot] = b;
          PairEnv env{p, a, b};
          for (int k = 0; k < p.n_out; ++k) {
            const VmVal v = vm_run(words + p.prog_off[first + k], p.prog_len[first + k], consts, env);
            vm_write(p.outs[k], p.out_vt[k], slot, v);
          }
          ++slot;
        }
        run += __shfl_sync(0xffffffffu, inc, 31);
      }
    }
    __syncthreads();  // the tile's shared state is free for the next one
  }
  if (last_block(st + 1)) {
    const long long total = *reinterpret_cast<volatile long long*>(p.total);
    for (long long s = total + t; s < p.M; s += JP_THREADS) {
      p.pa[s] = -1;
      p.pb[s] = -1;
      for (int k = 0; k < p.n_out; ++k) vm_write(p.outs[k], p.out_vt[k], s, vm_l(0));
    }
  }
}

extern "C" int join_probe_launch(JoinParams* params, int grid, cudaStream_t stream) {
  const JoinParams& p = *params;
  if (p.n_p <= 0 || p.M <= 0 || p.tp < 1 || p.tp > 32 || grid < 1 || p.chunk != JP_CHUNK ||
      p.group != JP_GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  params->launched = 0;
  if (p.state == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaMemsetAsync(p.state, 0, sizeof(unsigned long long) * (JP_HEAD + p.nrt + p.ntiles), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.o_pass != nullptr) {
    rank_kernel<<<static_cast<unsigned>(p.nrt), JP_THREADS, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    params->launched += 1;
  }
  if (p.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  probe_kernel<<<static_cast<unsigned>(grid), JP_THREADS, p.smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  params->launched += 1;
  return 0;
}
