// K2 nfa_block, 8 or 16 slots a thread (A from 129 to 512), the chain and
// algebra instantiations: the launch entry for the kernel of
// nfa_block.cuh.  Python side: kernels/nfa_block.py.
#include "nfa_block.cuh"

extern "C" int nfa_block_wide_launch(NfaParams* params, cudaStream_t stream) {
  return launch_wide<false>(params, stream);
}
