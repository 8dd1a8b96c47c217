// join_expand: the (query, ring position) pairs of a join probe's
// candidate ranges — keys-only, unverified.
//
// Replaces arroyo_tpu/ops/join.py:121 `_expand_kernel`.
//
// Semantics, with total = cum[mq - 1] read on the device (0 when mq = 0)
// and n = min(total, capacity), for j < n (start i32[mq] and cum i64[mq]
// from join_probe):
//   lidx[j] = #{i : cum[i] <= j}, clipped to [0, mq - 1]
//   ridx[j] = start[lidx[j]] + j - (lidx[j] > 0 ? cum[lidx[j] - 1] : 0)
// Both i64 (the JAX kernel's are i32; every reader widens them), in ONE
// i64 buffer: word 0 the total, then lidx and ridx rows of `capacity`
// words (the JAX kernel pads to a power-of-two bucket the host sized from
// the total it read; here the host sizes the buffer before the probe has
// run, and launches again at the header's total when it exceeds the
// capacity).
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
                                   long long mq, long long capacity,
                                   long long* __restrict__ out) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long total = mq > 0 ? cum[mq - 1] : 0;
  if (j == 0) out[0] = total;
  if (j >= total || j >= capacity) return;
  long long l, r;
  expand_pair(start, cum, mq, j, &l, &r);
  out[1 + j] = l;
  out[1 + capacity + j] = r;
}

}  // namespace

// start i32[mq], cum i64[mq] on the device; writes `out`: the total, then
// lidx and ridx i64[capacity].  One launch on `stream` (at least one
// block, for the header); returns cudaGetLastError().
extern "C" int arroyo_join_expand(const void* start, const void* cum,
                                  long long mq, long long capacity,
                                  void* out, void* stream) {
  if (mq < 0 || capacity < 0) return cudaErrorInvalidValue;
  const long long blocks = (capacity + kThreads - 1) / kThreads;
  join_expand_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(start), static_cast<const long long*>(cum), mq,
      capacity, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
