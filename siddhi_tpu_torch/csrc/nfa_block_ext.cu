// K2 nfa_block, 1-4 slots a thread (A up to 128), the EXT instantiation
// (init slots, slot forking, absent logical sides): the launch entry for
// the kernel of nfa_block.cuh.  Python side: kernels/nfa_block.py.
#include "nfa_block.cuh"

extern "C" int nfa_block_ext_launch(const NfaParams* params, cudaStream_t stream) {
  return launch_narrow<true, false>(params, stream);
}
