// The one-block exclusive scan and the ballot-rank write position shared
// by the kernels that compact flagged items in their original order
// (argmax_fire.cu, emit_compact.cu, segment_top_k.cu).
//
// exclusive_scan_kernel, launched as ONE block of kScanThreads threads:
// offsets[i] = sum(counts[:i]) for i < n and offsets[n] = the total.  Each
// thread sums a contiguous chunk, the block scans the chunk sums in shared
// memory, and each thread then writes its chunk's running offsets, so any
// n fits in one launch.
//
// compact_position: where flagged item t of a block of kThreads goes —
// the block's scanned offset plus the flagged items before t in the
// block (earlier warps' totals, then a ballot rank in t's warp), so
// flagged items keep ascending order across blocks.  Every thread of the
// block must call it (it synchronizes); the result is meaningful only
// where `flag` is set.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;

__global__ void exclusive_scan_kernel(const int* __restrict__ counts,
                                      int n, int* __restrict__ offsets) {
  __shared__ int sums[kScanThreads];
  const int tid = threadIdx.x;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, n);
  const int hi = min(lo + per, n);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  sums[tid] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int add = tid >= off ? sums[tid - off] : 0;
    __syncthreads();
    sums[tid] += add;
    __syncthreads();
  }
  int run = tid > 0 ? sums[tid - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (tid == kScanThreads - 1) offsets[n] = sums[tid];
}

template <int kThreads>
__device__ __forceinline__ int compact_position(
    int flag, const int* __restrict__ offsets) {
  __shared__ int warp_total[kThreads / 32];
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_total[warp] = __popc(ballot);
  __syncthreads();
  int pos = offsets[blockIdx.x] + __popc(ballot & ((1u << lane) - 1u));
  for (unsigned w = 0; w < warp; ++w) pos += warp_total[w];
  return pos;
}

}  // namespace
