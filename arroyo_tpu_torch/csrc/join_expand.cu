// join_expand: the (query, ring position) pairs of a join probe's
// candidate ranges — keys-only, unverified.
//
// Replaces arroyo_tpu/ops/join.py:121 `_expand_kernel`.
//
// Semantics, for j < total = cum[mq - 1] (start i32[mq] and cum i64[mq]
// from join_probe):
//   lidx[j] = #{i : cum[i] <= j}, clipped to [0, mq - 1]
//   ridx[j] = start[lidx[j]] + j - (lidx[j] > 0 ? cum[lidx[j] - 1] : 0)
// Both i64 (the JAX kernel's are i32; every reader widens them), sized to
// the exact total (the JAX kernel pads to a power-of-two bucket and its
// caller slices).
//
// What bounds it on the H100: memory — 16 bytes written per pair and the
// probe's 12 bytes per query read; at join-stress's hundreds of pairs per
// partition probe, the launch.
//
// What the design does about it: one thread per output pair finds its
// query by an upper-bound binary search over cum (join_search.cuh), so a
// query with a huge fan-out (a Zipf head key) spreads over as many
// threads as it has pairs; a thread or a warp per query would leave one
// thread writing them all.  The TPU's scatter-histogram + cumsum form
// existed only to keep XLA off its sequential searchsorted.  Stores
// coalesce: neighbouring threads write neighbouring pairs.

#include <cuda_runtime.h>

#include "join_search.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void join_expand_kernel(const int* __restrict__ start,
                                   const long long* __restrict__ cum,
                                   long long mq, long long total,
                                   long long* __restrict__ lidx,
                                   long long* __restrict__ ridx) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= total) return;
  long long l, r;
  expand_pair(start, cum, mq, j, &l, &r);
  lidx[j] = l;
  ridx[j] = r;
}

}  // namespace

// start i32[mq], cum i64[mq] on the device; writes lidx and ridx
// i64[total].  One launch on `stream`; returns cudaGetLastError().
extern "C" int arroyo_join_expand(const void* start, const void* cum,
                                  long long mq, long long total, void* lidx,
                                  void* ridx, void* stream) {
  if (mq < 0 || total < 0 || (total > 0 && mq == 0)) {
    return cudaErrorInvalidValue;
  }
  if (total == 0) return cudaSuccess;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  join_expand_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(start), static_cast<const long long*>(cum), mq,
      total, static_cast<long long*>(lidx), static_cast<long long*>(ridx));
  return static_cast<int>(cudaGetLastError());
}
