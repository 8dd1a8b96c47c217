// mesh_lookback.cuh: the decoupled look-back that mesh_route and
// mesh_merge use to carry running counts across tiles in ONE launch.
//
// A tile takes its index from a ticket counter (the call's workspace,
// zero-filled by the launcher), so every earlier tile is already running
// when a later one waits on it.  Each counter of a tile has one 64-bit
// status word: the top two bits say what it holds (0 nothing yet, 1 the
// tile's own total, 2 the total of the tile and every earlier one) and
// the low 62 bits the count.  A tile publishes its total at once, walks
// back over the earlier tiles' words until it meets an inclusive one, and
// then publishes its inclusive count.  Word and flag are one store, so a
// reader that sees the flag sees the count.

#pragma once

#include <cuda_runtime.h>

namespace mesh {

constexpr unsigned long long kFlagAgg = 1ull << 62;
constexpr unsigned long long kFlagInc = 2ull << 62;
constexpr unsigned long long kFlagMask = 3ull << 62;
constexpr unsigned long long kValueMask = kFlagAgg - 1;

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The exclusive count of counter `c` before tile `tile` (of `n_counters`
// counters a tile, status words tile-major), after publishing the tile's
// own `total`; publishes the inclusive count before returning.
__device__ __forceinline__ unsigned long long look_back(
    unsigned long long* status, int tile, int n_counters, int c,
    unsigned long long total) {
  unsigned long long* mine = status + static_cast<long long>(tile) *
                                          n_counters + c;
  if (tile == 0) {
    store_release(mine, kFlagInc | total);
    return 0;
  }
  store_release(mine, kFlagAgg | total);
  unsigned long long excl = 0;
  for (int p = tile - 1; p >= 0; --p) {
    const unsigned long long* w =
        status + static_cast<long long>(p) * n_counters + c;
    unsigned long long s;
    do {
      s = load_acquire(w);
    } while ((s & kFlagMask) == 0);
    excl += s & kValueMask;
    if ((s & kFlagMask) == kFlagInc) break;
  }
  store_release(mine, kFlagInc | (excl + total));
  return excl;
}

// The tile index of this block from the ticket counter (thread 0 draws,
// the block reads it from shared memory).
__device__ __forceinline__ int draw_tile(unsigned long long* ticket,
                                         int* s_tile) {
  if (threadIdx.x == 0) {
    *s_tile = static_cast<int>(atomicAdd(ticket, 1ull));
  }
  __syncthreads();
  return *s_tile;
}

}  // namespace mesh
