// K2 nfa_block with float64 capture and output rows
// (@app:devicePrecision('f64')), 8 or 16 slots a thread (A from 129 to
// 512), the chain and algebra instantiations: the launch entry for the
// kernel of nfa_block.cuh.  Python side: kernels/nfa_block.py.
#define NFA_F64
#include "nfa_block.cuh"

extern "C" int nfa_block_wide_f64_launch(nfa_f64::NfaParams* params, cudaStream_t stream) {
  return nfa_f64::launch_wide<false>(params, stream);
}
