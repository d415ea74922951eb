// K1 expr_eval: one thread per row runs an optional mask program and K
// output programs of the predicate VM over C typed columns.  The mask
// leaves bit-packed, one 32-bit word per warp from __ballot_sync: bit j of
// word w is row 32w+j (siddhi_tpu/core/planner.py:324-330).  Replaces the
// filter/projection step (planner.py:306), the NFA pre-masks
// (nfa_device.py:1489, nfa_parallel.py:685, per-lane parameters of the
// fused multi-query lanes included) and the pattern selector/having pass
// (nfa_device.py:1619-1640).  Python side: kernels/expr_eval.py.
//
// Row r reads element (r / col_div) % col_mod of every column (col_mod 0:
// no modulo) and belongs to lane lane_col[r], or (r / lane_div) % lane_mod;
// a `qparam` operand reads qparams[i * P + lane].  Programs, constants and
// column pointers sit in a device table; each block stages the programs in
// shared memory when they fit (stage = 1).
#include "expr_vm.cuh"

struct ExprParams {  // layout mirrored by kernels/expr_eval.py _Params
  long long n, col_div, col_mod, lane_div, lane_mod;
  int n_cols, n_out, has_mask, P, n_words, n_consts, stage, pad0;
  unsigned* mask_words;
  const int* lane_col;
  const long long* qparams;
  const void* const* cols;
  void* const* outs;
  const int* col_vt;
  const int* out_vt;
  const int* prog_off;
  const int* prog_len;
  const long long* consts;
  const int* words;
};

struct RowEnv {
  const ExprParams& p;
  long long elem;
  long long lane;
  __device__ VmVal load(int slot, int vt) {
    const int have = p.col_vt[slot];
    return vm_as(vm_read(p.cols[slot], have, elem), have, vt);
  }
  __device__ VmVal param(int i, int vt) {
    return vm_const(p.qparams[static_cast<long long>(i) * p.P + lane], vt);
  }
};

__device__ __forceinline__ long long div_rows(long long x, long long d, long long n) {
  return n <= 0x7fffffffLL ? static_cast<long long>(static_cast<unsigned>(x) / static_cast<unsigned>(d))
                           : x / d;
}

__device__ __forceinline__ long long mod_rows(long long x, long long d, long long n) {
  return n <= 0x7fffffffLL ? static_cast<long long>(static_cast<unsigned>(x) % static_cast<unsigned>(d))
                           : x % d;
}

__global__ void expr_eval_kernel(const __grid_constant__ ExprParams p) {
  extern __shared__ long long smem[];
  const int* words = p.words;
  const long long* consts = p.consts;
  if (p.stage) vm_stage(p.words, p.n_words, p.consts, p.n_consts, smem, &words, &consts);
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = row < p.n;
  int bit = 0;
  if (live) {
    // the row map's divisions only where it is not the identity (uniform
    // branches), in 32 bits while the row count allows
    long long elem = row, lane = 0;
    if (p.col_div != 1) elem = div_rows(elem, p.col_div, p.n);
    if (p.col_mod) elem = mod_rows(elem, p.col_mod, p.n);
    if (p.qparams != nullptr) {
      if (p.lane_col != nullptr) {
        lane = p.lane_col[row];
      } else {
        lane = p.lane_div != 1 ? div_rows(row, p.lane_div, p.n) : row;
        if (p.lane_mod) lane = mod_rows(lane, p.lane_mod, p.n);
      }
    }
    RowEnv env{p, elem, lane};
    int prog = 0;
    if (p.has_mask) {
      bit = vm_run(words + p.prog_off[0], p.prog_len[0], consts, env).i != 0;
      prog = 1;
    }
    for (int k = 0; k < p.n_out; ++k) {
      VmVal v = vm_run(words + p.prog_off[prog + k], p.prog_len[prog + k], consts, env);
      vm_write(p.outs[k], p.out_vt[k], row, v);
    }
  }
  if (p.has_mask) {
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if ((threadIdx.x & 31) == 0 && live) p.mask_words[row >> 5] = word;
  }
}

extern "C" int expr_eval_launch(const ExprParams* params, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (params->n + threads - 1) / threads;
  const size_t smem = params->stage
      ? 8 * static_cast<size_t>(params->n_consts) + 4 * static_cast<size_t>(params->n_words) + 8
      : 0;
  expr_eval_kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(*params);
  return static_cast<int>(cudaGetLastError());
}
