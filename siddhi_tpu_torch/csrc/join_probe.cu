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
// kernel does O(T_p * Mw) pair tests:
//   1. (opposite filter only) the exclusive count of the opposite pass
//      bits and the batch index of each passed event: a three-phase block
//      scan (block totals, one block over the totals, rescan);
//   2. count: a warp per probe finds nlt by binary search of its seq in
//      the opposite batch's sorted seqs, then the lanes stride over its
//      visible positions running the `on` program of the predicate VM
//      (expr_vm.cuh) with a pair environment; the matches of each round
//      are counted with a ballot;
//   3. the exclusive scan of the counts (the first pair slot of each
//      probe and the total), with the miss words p_pass & count == 0
//      ballot-packed as `bits32` packs them (bit j of word w = probe
//      32w + j);
//   4. write: the same walk again, each match writing (a, b) at its slot
//      in (a, then b) order, JAX's flat grid order, and evaluating every
//      computed selector program into its typed column; slots >= M are
//      skipped (the plan re-launches with a larger M);
//   5. slots from the total to M get a = b = -1 and zero columns, so the
//      outputs are a function of the inputs alone.
// Bound on the H100: operations -- T_p * Mw pair tests of the `on`
// program, each a few VM instructions -- once the probes outnumber the
// window; at micro-batch sizes the nine launches' latency.  Built with
// --fmad=false like K1-K8, so f32 `on` and selector arithmetic equals the
// plain version's and the JAX package's bit for bit.
#include "expr_vm.cuh"
#include "win_scan.cuh"

#define JP_WARPS (WS_THREADS / 32)  // probes per block in the pair passes

struct JoinParams {  // layout mirrored by kernels/join_probe.py _Params
  int n_p, n_o, Lo, NO, Mw, M;
  int n_pc, n_oc, n_out, has_on, n_words, n_consts;
  int stage, nbp, nbo, pad0;
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
  int* count;                  // n_p: pairs of each probe
  long long* offset;           // n_p: first pair slot of each probe
  long long* blk;              // block totals, then their prefixes
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

// A pair's environment: slots [0, n_pc) read the probe's row a, the
// others the opposite union entry b (mirror slot, or batch row b - NO).
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

// kind 0: the opposite side's pass bits; kind 1: the probes' pair counts.
__device__ __forceinline__ long long scan_item(const JoinParams& p, int kind, long long i) {
  if (kind == 0) return (i < p.n_o && pass_bit(p.o_pass, i)) ? 1 : 0;
  return i < p.n_p ? p.count[i] : 0;
}

__global__ void scan_reduce(const __grid_constant__ JoinParams p, int kind) {
  const long long i = static_cast<long long>(blockIdx.x) * WS_THREADS + threadIdx.x;
  Seg<SumI> total;
  block_seg_scan<SumI>(Seg<SumI>{false, scan_item(p, kind, i)}, &total);
  if (threadIdx.x == 0) p.blk[blockIdx.x] = total.v;
}

// One block: the exclusive prefixes of the block totals, in place, and
// the grand total (o_rank[n_o], or the pair total).
__global__ void scan_carry(const __grid_constant__ JoinParams p, int kind) {
  const int nb = kind == 0 ? p.nbo : p.nbp;
  long long run = 0;
  for (int base = 0; base < nb; base += WS_THREADS) {
    const int j = base + threadIdx.x;
    const long long x = j < nb ? p.blk[j] : 0;
    Seg<SumI> total;
    const Seg<SumI> ex = block_seg_scan<SumI>(Seg<SumI>{false, x}, &total);
    if (j < nb) p.blk[j] = run + ex.v;
    run += total.v;
  }
  if (threadIdx.x == 0) {
    if (kind == 0)
      p.o_rank[p.n_o] = static_cast<int>(run);
    else
      p.total[0] = run;
  }
}

__global__ void scan_rescan(const __grid_constant__ JoinParams p, int kind) {
  const long long i = static_cast<long long>(blockIdx.x) * WS_THREADS + threadIdx.x;
  const long long x = scan_item(p, kind, i);
  Seg<SumI> total;
  const Seg<SumI> ex = block_seg_scan<SumI>(Seg<SumI>{false, x}, &total);
  const long long pre = p.blk[blockIdx.x] + ex.v;
  if (kind == 0) {
    if (i < p.n_o) {
      p.o_rank[i] = static_cast<int>(pre);
      if (x) p.o_idx[pre] = static_cast<int>(i);
    }
    return;
  }
  if (i < p.n_p) p.offset[i] = pre;
  if (p.miss != nullptr) {
    const bool m = i < p.n_p && pass_bit(p.p_pass, i) && x == 0;
    const unsigned w = __ballot_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0 && i < p.n_p) p.miss[i >> 5] = w;
  }
}

// The visible opposite positions [lo, hi) of probe a.
__device__ __forceinline__ void visible(const JoinParams& p, int a, int* lo, int* hi) {
  const long long s = p.p_seq[a];
  int l = 0, h = p.n_o;
  while (l < h) {  // first batch event whose seq is not below the probe's
    const int mid = (l + h) >> 1;
    if (p.o_seq[mid] < s)
      l = mid + 1;
    else
      h = mid;
  }
  const int nlt = p.Lo + opp_rank(p, l);
  *hi = nlt;
  *lo = p.Mw > 0 ? max(nlt - p.Mw, 0) : nlt;
}

__device__ __forceinline__ int union_index(const JoinParams& p, int pos) {
  return pos < p.Lo ? pos : p.NO + opp_index(p, pos - p.Lo);
}

__global__ void count_kernel(const __grid_constant__ JoinParams p) {
  extern __shared__ long long smem[];
  const int* words = p.words;
  const long long* consts = p.consts;
  if (p.stage) vm_stage(p.words, p.n_words, p.consts, p.n_consts, smem, &words, &consts);
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * JP_WARPS + (threadIdx.x >> 5);
  if (a >= p.n_p) return;
  int cnt = 0;
  if (pass_bit(p.p_pass, a)) {
    int lo, hi;
    visible(p, a, &lo, &hi);
    if (!p.has_on) {
      cnt = hi - lo;
    } else {
      for (int base = lo; base < hi; base += 32) {
        const int pos = base + lane;
        bool m = false;
        if (pos < hi) {
          PairEnv env{p, a, union_index(p, pos)};
          m = vm_run(words + p.prog_off[0], p.prog_len[0], consts, env).i != 0;
        }
        cnt += __popc(__ballot_sync(0xffffffffu, m));
      }
    }
  }
  if (lane == 0) p.count[a] = cnt;
}

__global__ void write_kernel(const __grid_constant__ JoinParams p) {
  extern __shared__ long long smem[];
  const int* words = p.words;
  const long long* consts = p.consts;
  if (p.stage) vm_stage(p.words, p.n_words, p.consts, p.n_consts, smem, &words, &consts);
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * JP_WARPS + (threadIdx.x >> 5);
  if (a >= p.n_p || p.count[a] == 0) return;
  long long run = p.offset[a];
  int lo, hi;
  visible(p, a, &lo, &hi);
  const int first = p.has_on ? 1 : 0;
  for (int base = lo; base < hi && run < p.M; base += 32) {
    const int pos = base + lane;
    bool m = false;
    int b = 0;
    if (pos < hi) {
      b = union_index(p, pos);
      PairEnv env{p, a, b};
      m = !p.has_on || vm_run(words + p.prog_off[0], p.prog_len[0], consts, env).i != 0;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (m) {
      const long long slot = run + __popc(bal & ((1u << lane) - 1u));
      if (slot < p.M) {
        p.pa[slot] = a;
        p.pb[slot] = b;
        PairEnv env{p, a, b};
        for (int k = 0; k < p.n_out; ++k) {
          const VmVal v = vm_run(words + p.prog_off[first + k], p.prog_len[first + k], consts, env);
          vm_write(p.outs[k], p.out_vt[k], slot, v);
        }
      }
    }
    run += __popc(bal);
  }
}

__global__ void fill_kernel(const __grid_constant__ JoinParams p) {
  const long long s = static_cast<long long>(blockIdx.x) * WS_THREADS + threadIdx.x;
  if (s >= p.M || s < p.total[0]) return;
  p.pa[s] = -1;
  p.pb[s] = -1;
  for (int k = 0; k < p.n_out; ++k) vm_write(p.outs[k], p.out_vt[k], s, vm_l(0));
}

extern "C" int join_probe_launch(const JoinParams* params, cudaStream_t stream) {
  const JoinParams& p = *params;
  if (p.n_p <= 0 || p.M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
#define JP_CHECK()                                         \
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err)
  const size_t smem = p.stage
      ? 8 * static_cast<size_t>(p.n_consts) + 4 * static_cast<size_t>(p.n_words) + 8
      : 0;
  if (p.o_pass != nullptr) {
    scan_reduce<<<p.nbo, WS_THREADS, 0, stream>>>(p, 0);
    JP_CHECK();
    scan_carry<<<1, WS_THREADS, 0, stream>>>(p, 0);
    JP_CHECK();
    scan_rescan<<<p.nbo, WS_THREADS, 0, stream>>>(p, 0);
    JP_CHECK();
  }
  const unsigned probe_blocks = static_cast<unsigned>((p.n_p + JP_WARPS - 1) / JP_WARPS);
  count_kernel<<<probe_blocks, WS_THREADS, smem, stream>>>(p);
  JP_CHECK();
  scan_reduce<<<p.nbp, WS_THREADS, 0, stream>>>(p, 1);
  JP_CHECK();
  scan_carry<<<1, WS_THREADS, 0, stream>>>(p, 1);
  JP_CHECK();
  scan_rescan<<<p.nbp, WS_THREADS, 0, stream>>>(p, 1);
  JP_CHECK();
  write_kernel<<<probe_blocks, WS_THREADS, smem, stream>>>(p);
  JP_CHECK();
  fill_kernel<<<static_cast<unsigned>((p.M + WS_THREADS - 1) / WS_THREADS), WS_THREADS, 0,
                stream>>>(p);
#undef JP_CHECK
  return static_cast<int>(cudaGetLastError());
}
