// K2 nfa_block, 8 or 16 slots a thread (A from 129 to 512): the launch
// entry for the kernel of nfa_block.cuh.  Python side:
// kernels/nfa_block.py.
#include "nfa_block.cuh"

extern "C" int nfa_block_wide_launch(const NfaParams* params, cudaStream_t stream) {
  NfaParams p = *params;
  const long long per_warp = nfa_setup(p);
  if (per_warp < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nj = (p.A + 31) / 32;
  if (nj <= 8) return launch<8>(p, per_warp, stream);
  if (nj <= 16) return launch<16>(p, per_warp, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
