// The decoupled look-back of the single-pass compactions (K5
// scan_compact.cu, K8 win_compact.cu, K9 join_probe.cu's ranks and
// pair slots).
//
// Tiles take their index from a ticket, so every tile a tile waits on is
// already running.  A tile publishes its own value in its word (LB_AGG),
// folds the words of the tiles before it, 32 at a time, down to the
// nearest one that holds an inclusive value (LB_INC), and publishes its
// own inclusive value.  The words are the launch's own state, zero before
// the launch (the launchers memset them).
#pragma once
#include <cuda_runtime.h>

#define LB_AGG (1ull << 62)  // a published look-back word: the tile's own value
#define LB_INC (2ull << 62)  // ... or the inclusive value through the tile
#define LB_VAL ((1ull << 62) - 1)

__device__ __forceinline__ void lb_put(unsigned long long* w, unsigned long long v) {
  asm volatile("st.volatile.global.u64 [%0], %1;" ::"l"(w), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long lb_get(const unsigned long long* w) {
  unsigned long long v;
  asm volatile("ld.volatile.global.u64 %0, [%1];" : "=l"(v) : "l"(w) : "memory");
  return v;
}

// One whole warp: publishes tile g's own value `mine` among `words`,
// folds (sum, or min when MIN) the values of tiles g - 1, g - 2, ... down
// to the nearest inclusive one (tile `first` publishes inclusive at once),
// publishes g's inclusive value and returns the exclusive one.
template <bool MIN>
__device__ long long look_back(unsigned long long* words, int g, int first, long long mine,
                               long long id) {
  const int l = threadIdx.x & 31;
  if (g == first) {
    if (l == 0) lb_put(words + g, LB_INC | static_cast<unsigned long long>(mine));
    return id;
  }
  if (l == 0) lb_put(words + g, LB_AGG | static_cast<unsigned long long>(mine));
  long long before = id;
  for (int start = g - 1;; start -= 32) {
    const int k = start - l;  // lane l: the l-th tile down from `start`
    unsigned long long v = 0;
    if (k >= first) {
      do {
        v = lb_get(words + k);
      } while ((v >> 62) == 0);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, k >= first && (v >> 62) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    long long x = (k >= first && l <= stop) ? static_cast<long long>(v & LB_VAL) : id;
    for (int o = 16; o > 0; o >>= 1) {
      const long long y = __shfl_xor_sync(0xffffffffu, x, o);
      x = MIN ? (y < x ? y : x) : x + y;
    }
    before = MIN ? (x < before ? x : before) : before + x;
    if (inc || start - 31 <= first) break;
  }
  const long long incl = MIN ? (mine < before ? mine : before) : before + mine;
  if (l == 0) lb_put(words + g, LB_INC | static_cast<unsigned long long>(incl));
  return before;
}
