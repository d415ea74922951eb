// K2 nfa_block with float64 capture and output rows
// (@app:devicePrecision('f64')), 1-4 slots a thread (A up to 128), the
// chain and algebra instantiations in chunk mode (the `chunk` family's
// own-chunks of a flat flush): the launch entry for the kernel of
// nfa_block.cuh.  Python side: kernels/nfa_block.py.
#define NFA_F64
#include "nfa_block.cuh"

extern "C" int nfa_block_chunk_f64_launch(nfa_f64::NfaParams* params, cudaStream_t stream) {
  return nfa_f64::launch_narrow<false, true>(params, stream);
}
