// segment_agg: per-segment sum / min / max / count of k channels over
// rows grouped into contiguous segments.
//
// Replaces arroyo_tpu/ops/segment.py:30 `_segment_agg_kernel` (XLA's
// segment_sum / segment_min / segment_max over padded segment ids).
//
// Semantics, for s < n_seg and c < k, rows r in [off[s], off[s + 1]),
// where v(c) is the row of `values` that channel c reads: the count of
// non-count channels before c (count channels read no values, so their
// rows are never uploaded):
//   counts[s]  = off[s + 1] - off[s]
//   out[c, s]  = sum_r values[v(c), r]         (kind sum,   identity 0)
//              = min_r values[v(c), r]         (kind min,   identity +f64 max)
//              = max_r values[v(c), r]         (kind max,   identity -f64 max)
//              = (double) counts[s]            (kind count)
// The caller passes exact n and n_seg (no padding rows, no trash segment).
//
// What bounds it on the H100: memory.  Every row of every reduced
// channel is read once (count channels read nothing) and one f64 per (channel, segment) plus one i64
// per segment is written; one add or compare per value read.  At
// config5's shapes (k = 1 count channel, a few thousand rows) the call
// moves tens of kilobytes and launch overhead dominates.
//
// What the design does about it: one block per segment, its threads
// striding over the segment's rows (neighbouring threads on neighbouring
// rows, so loads coalesce), then a warp-shuffle tree and a shared-memory
// tree.  The order of additions is fixed by the row count alone, so the
// sums are deterministic from run to run (not XLA's order: rtol 1e-12).
// A skewed segment runs on ONE block, serially across its strides — a
// single 2^20-row segment is the case that shows it.  Splitting large
// segments across blocks is later work.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kMaxChannels = 64;
constexpr int kThreads = 256;

enum Kind : int { kSum = 0, kMin = 1, kMax = 2, kCount = 3 };

struct KindSpec {
  int k;
  int kind[kMaxChannels];
};

__device__ __forceinline__ double combine(int kind, double a, double b) {
  if (kind == kSum) return a + b;
  if (kind == kMin) return b < a ? b : a;
  return b > a ? b : a;
}

__global__ void segment_agg_kernel(const double* __restrict__ values,
                                   long long n,
                                   const long long* __restrict__ offsets,
                                   KindSpec spec, int n_seg,
                                   double* __restrict__ out,
                                   long long* __restrict__ counts) {
  __shared__ double warp_acc[kThreads / 32];
  const int s = blockIdx.x;
  const long long lo = offsets[s];
  const long long hi = offsets[s + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) counts[s] = hi - lo;
  long long row = 0;  // row of `values` read by the next reduced channel
  for (int c = 0; c < spec.k; ++c) {
    const int kind = spec.kind[c];  // uniform across the block
    const long long at = static_cast<long long>(c) * n_seg + s;
    if (kind == kCount) {
      if (threadIdx.x == 0) out[at] = static_cast<double>(hi - lo);
      continue;
    }
    const double ident =
        kind == kSum ? 0.0 : (kind == kMin ? DBL_MAX : -DBL_MAX);
    const double* v = values + (row++) * n;
    double acc = ident;
    for (long long r = lo + threadIdx.x; r < hi; r += kThreads) {
      acc = combine(kind, acc, v[r]);
    }
    for (int d = 16; d > 0; d >>= 1) {
      acc = combine(kind, acc, __shfl_down_sync(0xffffffffu, acc, d));
    }
    if (lane == 0) warp_acc[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      acc = lane < kThreads / 32 ? warp_acc[lane] : ident;
      for (int d = 16; d > 0; d >>= 1) {
        acc = combine(kind, acc, __shfl_down_sync(0xffffffffu, acc, d));
      }
      if (lane == 0) out[at] = acc;
    }
    __syncthreads();  // warp_acc is reused by the next channel
  }
}

}  // namespace

// values f64[k_r, n] (one row of n per channel that is not a count, in
// channel order; k_r may be 0), offsets i64[n_seg + 1] on the device
// (offsets[0] = 0, offsets[n_seg] = n, non-decreasing); kinds is a HOST
// array of k codes (0 sum, 1 min, 2 max, 3 count).  Writes out
// f64[k, n_seg] and counts i64[n_seg].  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int arroyo_segment_agg(const void* values, long long n,
                                  const void* offsets, int n_seg,
                                  const int* kinds, int k, void* out,
                                  void* counts, void* stream) {
  if (k < 0 || k > kMaxChannels || n_seg < 0 || n < 0)
    return cudaErrorInvalidValue;
  KindSpec spec;
  spec.k = k;
  for (int c = 0; c < k; ++c) {
    if (kinds[c] < kSum || kinds[c] > kCount) return cudaErrorInvalidValue;
    spec.kind[c] = kinds[c];
  }
  if (n_seg == 0) return cudaSuccess;
  segment_agg_kernel<<<n_seg, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(values), n,
      static_cast<const long long*>(offsets), spec, n_seg,
      static_cast<double*>(out), static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
