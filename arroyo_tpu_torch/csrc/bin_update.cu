// bin_update: scatter pre-aggregated (slot, bin) cells into the keyed
// bin ring, in place.
//
// Replaces arroyo_tpu/ops/keyed_bins.py:62 `_update_kernel` (the XLA
// scatter) and arroyo_tpu/ops/pallas_kernels.py:77 `_scatter_kernel`
// (the TPU's one-hot MXU form of the same additive update, reached via
// `update_bin_state`, pallas_kernels.py:212).
//
// Semantics (keyed_bins.py:67-104): for cell i with slot s, bin b and
// rowcount rc = packed[0, i]:
//   * rc <= 0.5 (padding) or s/b outside the planes: the cell is skipped,
//     never clipped into a real cell;
//   * counts[s, b] += (CountT)rc;
//   * channel j reads packed[src_j, i], or rc itself for COUNT(*)
//     channels (src_j < 0), and adds (sum/avg/count), or reduces with
//     min/max, into values[j, s, b].
//
// What bounds it on the H100: memory.  Each cell reads 8 B of indices and
// 8 B per packed row, and read-modify-writes 8 B per channel plus 4/8 B
// of counts at a scattered address; there are no operations to speak of.
// At nexmark q5's few-thousand-cell flushes the whole call moves well
// under a megabyte, so it is bound by the launch, not by bandwidth.
//
// What the design does about it: one thread per cell and one launch per
// flush, no shared-memory staging.  Duplicate cells stay correct without
// sorting: sums use the native f64 atomicAdd, min/max an atomicCAS loop on
// the 64-bit pattern, counts a 32- or 64-bit atomicAdd.  Faster variants
// (warp-aggregated atomics, fusing consecutive flushes) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 64;
constexpr int kThreads = 256;

enum Kind : int { kAdd = 0, kMin = 1, kMax = 2 };

struct ChannelSpec {
  int n;
  int kind[kMaxChannels];
  int src[kMaxChannels];  // packed row, or -1 for the rowcount itself
};

__device__ __forceinline__ void atomic_min_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a;
  while (v < __longlong_as_double(static_cast<long long>(old))) {
    unsigned long long assumed = old;
    old = atomicCAS(a, assumed,
                    static_cast<unsigned long long>(__double_as_longlong(v)));
    if (old == assumed) break;
  }
}

__device__ __forceinline__ void atomic_max_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a;
  while (v > __longlong_as_double(static_cast<long long>(old))) {
    unsigned long long assumed = old;
    old = atomicCAS(a, assumed,
                    static_cast<unsigned long long>(__double_as_longlong(v)));
    if (old == assumed) break;
  }
}

__device__ __forceinline__ void add_count(int* p, double rc) {
  atomicAdd(p, static_cast<int>(rc));
}

__device__ __forceinline__ void add_count(long long* p, double rc) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(static_cast<long long>(rc)));
}

template <typename CountT>
__global__ void bin_update_kernel(double* __restrict__ values,
                                  CountT* __restrict__ counts,
                                  const int* __restrict__ idx,
                                  const double* __restrict__ packed,
                                  ChannelSpec spec, int C, int B, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int s = idx[i];
  const int b = idx[m + i];
  const double rc = packed[i];
  if (!(rc > 0.5) || s < 0 || s >= C || b < 0 || b >= B) return;
  const long long cell = static_cast<long long>(s) * B + b;
  add_count(counts + cell, rc);
  const long long plane = static_cast<long long>(C) * B;
  for (int j = 0; j < spec.n; ++j) {
    const double x = spec.src[j] < 0
        ? rc
        : packed[static_cast<long long>(spec.src[j]) * m + i];
    double* dst = values + j * plane + cell;
    if (spec.kind[j] == kAdd) {
      atomicAdd(dst, x);
    } else if (spec.kind[j] == kMin) {
      atomic_min_f64(dst, x);
    } else {
      atomic_max_f64(dst, x);
    }
  }
}

}  // namespace

// values f64[n_ch, C, B], counts i32|i64[C, B] (both updated in place),
// idx i32[2, m], packed f64[n_src, m]; kinds/srcs are HOST arrays of n_ch
// ints.  Launches on `stream`; returns cudaGetLastError().
extern "C" int arroyo_bin_update(void* values, void* counts, int counts_i64,
                                 const void* idx, const void* packed,
                                 const int* kinds, const int* srcs, int n_ch,
                                 int C, int B, int m, void* stream) {
  if (n_ch < 0 || n_ch > kMaxChannels) return cudaErrorInvalidValue;
  ChannelSpec spec;
  spec.n = n_ch;
  for (int j = 0; j < n_ch; ++j) {
    spec.kind[j] = kinds[j];
    spec.src[j] = srcs[j];
  }
  if (m <= 0) return cudaSuccess;
  const int blocks = (m + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (counts_i64) {
    bin_update_kernel<long long><<<blocks, kThreads, 0, st>>>(
        static_cast<double*>(values), static_cast<long long*>(counts),
        static_cast<const int*>(idx), static_cast<const double*>(packed),
        spec, C, B, m);
  } else {
    bin_update_kernel<int><<<blocks, kThreads, 0, st>>>(
        static_cast<double*>(values), static_cast<int*>(counts),
        static_cast<const int*>(idx), static_cast<const double*>(packed),
        spec, C, B, m);
  }
  return static_cast<int>(cudaGetLastError());
}
