// join_probe: the candidate match ranges of sorted i32 queries in a hot
// join partition's sorted i32 ring — per query its lower bound, its match
// count and the inclusive prefix sum of the counts.
//
// Replaces arroyo_tpu/ops/join.py:76 `_probe_kernel` (both forms: the
// `searchsorted` one and the merged-rank one the TPU takes to stay off
// searchsorted's sequential lowering; they compute the same outputs).
//
// Semantics, for i < mq (q_hi[0, mq) sorted, the queries past m padded
// with the ring's sentinel; hi[0, cap) sorted, its rows past n_valid
// padded with the same sentinel):
//   s = min(lower_bound(hi[0, cap), q_hi[i]), n_valid)
//   e = min(upper_bound(hi[0, cap), q_hi[i]), n_valid)
//   start[i] = s, counts[i] = i < m ? e - s : 0 (both i32)
//   cum[i] = counts[0] + ... + counts[i] (i64; the JAX kernel's is i32)
//
// What bounds it on the H100: at join-stress's shapes (a few hundred
// queries against rings of a few thousand rows) the launch; the bytes
// (each query and ring row read once, 16 bytes written per query) are a
// few kilobytes.  The searches are 2 * log2(cap) dependent loads per
// query, latency that the other queries' threads hide.
//
// What the design does about it: one thread per query runs both binary
// searches (searchsorted, not the TPU's merged sort: Hopper has no reason
// to avoid it), then the prefix sum.  A block owns a tile of 1,024
// queries (four per thread) and scans it with warp shuffles; when the
// queries fill one tile — join-stress's partitions always do — that is
// the only launch.  Larger inputs add two stream-ordered launches: one
// block scans the tile totals into carries, a row-parallel pass adds
// them.

#include <cuda_runtime.h>

#include <climits>

#include "join_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

// Exclusive sum of one value per thread across the block (blockDim.x a
// multiple of 32); the block total goes to *total.  Ends with a barrier
// so it may be called again in a loop.
__device__ long long block_exclusive_sum(long long x, long long* total) {
  __shared__ long long warp_sums[32];
  __shared__ long long block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  long long inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < n_warps ? warp_sums[lane] : 0;
    long long winc = w;
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(0xffffffffu, winc, d);
      if (lane >= d) winc += o;
    }
    if (lane < n_warps) warp_sums[lane] = winc - w;
    if (lane == n_warps - 1) block_total = winc;
  }
  __syncthreads();
  const long long out = warp_sums[warp] + inc - x;
  *total = block_total;
  __syncthreads();
  return out;
}

// (1) per tile: both searches per query, the tile-local inclusive prefix
// sum of the counts into cum, and the tile's total into tile_sum.
__global__ void probe_tile(const int* __restrict__ q_hi, long long mq,
                           const int* __restrict__ hi, long long cap,
                           long long m, long long n_valid,
                           int* __restrict__ start, int* __restrict__ counts,
                           long long* __restrict__ cum,
                           long long* __restrict__ tile_sum) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int t0 = threadIdx.x * kItems;
  long long c[kItems];
  long long agg = 0;
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + t0 + k;
    c[k] = 0;
    if (i < mq) {
      const int q = q_hi[i];
      long long s = bound<false>(hi, cap, q);
      long long e = bound<true>(hi, cap, q);
      s = s < n_valid ? s : n_valid;
      e = e < n_valid ? e : n_valid;
      c[k] = i < m ? e - s : 0;
      start[i] = static_cast<int>(s);
      counts[i] = static_cast<int>(c[k]);
    }
    agg += c[k];
  }
  long long total;
  long long run = block_exclusive_sum(agg, &total);
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + t0 + k;
    run += c[k];
    if (i < mq) cum[i] = run;
  }
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// (2) one block: tile_sum becomes, in place, each tile's carry — the
// exclusive prefix sum of the tile totals.
__global__ void probe_carry(long long* __restrict__ tile_sum, int n_tiles) {
  long long running = 0;
  for (int b0 = 0; b0 < n_tiles; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const long long x = b < n_tiles ? tile_sum[b] : 0;
    long long total;
    const long long exc = block_exclusive_sum(x, &total);
    if (b < n_tiles) tile_sum[b] = running + exc;
    running += total;
  }
}

// (3) add each tile's carry to its rows (tile 0 has none).
__global__ void probe_fixup(long long* __restrict__ cum, long long mq,
                            const long long* __restrict__ carry) {
  const long long i = kTile + static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < mq) cum[i] += carry[i / kTile];
}

}  // namespace

// q_hi i32[mq], hi i32[cap] on the device; 0 <= m <= mq, 0 <= n_valid <=
// cap.  Writes start i32[mq], counts i32[mq], cum i64[mq]; scratch
// tile_sum i64[ceil(mq / 1024)].  One launch on `stream` when mq <= 1024,
// three otherwise; returns cudaGetLastError() after the last (or the
// first failing) one.
extern "C" int arroyo_join_probe(const void* q_hi, long long mq,
                                 const void* hi, long long cap, long long m,
                                 long long n_valid, void* start, void* counts,
                                 void* cum, void* tile_sum, void* stream) {
  if (mq < 0 || cap <= 0 || cap > INT_MAX || m < 0 || m > mq ||
      n_valid < 0 || n_valid > cap) {
    return cudaErrorInvalidValue;
  }
  if (mq == 0) return cudaSuccess;
  const long long n_tiles = (mq + kTile - 1) / kTile;
  if (n_tiles > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* sums = static_cast<long long*>(tile_sum);
  long long* out = static_cast<long long*>(cum);
  probe_tile<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const int*>(q_hi), mq, static_cast<const int*>(hi), cap, m,
      n_valid, static_cast<int*>(start), static_cast<int*>(counts), out, sums);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || n_tiles == 1) return static_cast<int>(rc);
  probe_carry<<<1, kThreads, 0, s>>>(sums, static_cast<int>(n_tiles));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long rest = mq - kTile;
  probe_fixup<<<static_cast<unsigned>((rest + kThreads - 1) / kThreads),
                kThreads, 0, s>>>(out, mq, sums);
  return static_cast<int>(cudaGetLastError());
}
