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
// What the design does about it: expand_gather's staged expansion
// (join_search.cuh: a block of 512 pairs, `cum` and `start` in shared
// memory, a binary search in them per pair, in 32-bit steps of a compare
// and a select) followed by two coalesced stores a pair.  The total
// comes from the staged copy (or once a warp when `cum` is too long to
// stage), and blocks past it exit after that one load.  A query
// with a huge fan-out (a Zipf head key) spreads over as many threads as
// it has pairs.  The TPU's scatter-histogram + cumsum form existed only
// to keep XLA off its sequential searchsorted.

#include <cuda_runtime.h>

#include "join_search.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) join_expand_kernel(
    const int* __restrict__ start, const long long* __restrict__ cum,
    long long mq, long long capacity, long long* __restrict__ out) {
  PairBlock pb;
  const bool any = stage_pairs<kThreads>(start, cum, mq, capacity, &pb);
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = pb.total;
  if (!any) return;
  for (long long j = pb.j0 + threadIdx.x; j <= pb.j1; j += kThreads) {
    long long r;
    out[1 + j] = pair_query(pb, j, &r);
    out[1 + capacity + j] = r;
  }
}

}  // namespace

// start i32[mq], cum i64[mq] on the device; writes `out`: the total, then
// lidx and ridx i64[capacity].  One launch on `stream` (at least one
// block, for the header); returns cudaGetLastError().
extern "C" int arroyo_join_expand(const void* start, const void* cum,
                                  long long mq, long long capacity,
                                  void* out, void* stream) {
  if (mq < 0 || capacity < 0) return cudaErrorInvalidValue;
  const long long blocks = (capacity + kPairs - 1) / kPairs;
  join_expand_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(start), static_cast<const long long*>(cum), mq,
      capacity, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
