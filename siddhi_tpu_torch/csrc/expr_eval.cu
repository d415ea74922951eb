// K1 expr_eval: one thread per row runs an optional mask program and K
// output programs of the predicate VM over C typed columns.  The mask
// leaves bit-packed, one 32-bit word per warp from __ballot_sync: bit j of
// word w is row 32w+j (siddhi_tpu/core/planner.py:324-330).  Replaces the
// filter/projection step (planner.py:306), the NFA pre-masks
// (nfa_device.py:1489) and the pattern selector/having pass
// (nfa_device.py:1619-1640).  Python side: kernels/expr_eval.py.
#include "expr_vm.cuh"

#define K1_MAXC 32
#define K1_MAXOUT 16
#define K1_MAXCONST 48
#define K1_MAXWORDS 512

struct ExprParams {
  long long n;
  int n_cols, n_out, has_mask, pad0;
  unsigned* mask_words;
  const void* cols[K1_MAXC];
  void* outs[K1_MAXOUT];
  int col_vt[K1_MAXC];
  int out_vt[K1_MAXOUT];
  int prog_off[K1_MAXOUT + 1];
  int prog_len[K1_MAXOUT + 1];
  long long consts[K1_MAXCONST];
  int words[K1_MAXWORDS];
};

struct RowEnv {
  const ExprParams& p;
  long long row;
  __device__ VmVal load(int slot, int vt) {
    const int have = p.col_vt[slot];
    return vm_as(vm_read(p.cols[slot], have, row), have, vt);
  }
};

__global__ void expr_eval_kernel(const __grid_constant__ ExprParams p) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = row < p.n;
  int bit = 0;
  if (live) {
    RowEnv env{p, row};
    int prog = 0;
    if (p.has_mask) {
      bit = vm_run(p.words + p.prog_off[0], p.prog_len[0], p.consts, env).i != 0;
      prog = 1;
    }
    for (int k = 0; k < p.n_out; ++k) {
      VmVal v = vm_run(p.words + p.prog_off[prog + k], p.prog_len[prog + k], p.consts, env);
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
  expr_eval_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(*params);
  return static_cast<int>(cudaGetLastError());
}
