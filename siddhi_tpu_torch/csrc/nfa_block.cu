// K2 nfa_block, 1-4 slots a thread (A up to 128): the launch entry for
// the kernel of nfa_block.cuh.  Python side: kernels/nfa_block.py.
#include "nfa_block.cuh"

extern "C" int nfa_block_launch(const NfaParams* params, cudaStream_t stream) {
  NfaParams p = *params;
  const long long per_warp = nfa_setup(p);
  if (per_warp < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nj = (p.A + 31) / 32;
  if (nj <= 1) return launch<1>(p, per_warp, stream);
  if (nj <= 2) return launch<2>(p, per_warp, stream);
  if (nj <= 4) return launch<4>(p, per_warp, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
