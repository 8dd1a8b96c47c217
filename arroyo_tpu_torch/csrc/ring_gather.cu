// ring_gather: the window-fire payload gather of a hot join partition —
// both payload stacks read at the given sorted-run positions.
//
// Replaces arroyo_tpu/ops/join.py:535 `_gather32_kernel`.
//
// Semantics: gf[r, t] = fstack[r, idx[t]] and gi[r, t] = istack[r, idx[t]]
// for t < m; an index outside [0, cap) is clamped into it, as the JAX
// gather clamps (callers pass in-range positions).
//
// What bounds it on the H100: memory — 8 bytes of index plus 8 * (nf + ni)
// bytes read and written per row.  q8's fires gather a few thousand rows
// per partition, well under a megabyte, so the launch dominates.
//
// What the design does about it: one thread per (stack row, output row),
// output row fastest, so stores are coalesced and the reads of a warp
// follow the sorted (mostly ascending) positions.  One launch per call.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void ring_gather_kernel(const long long* __restrict__ idx,
                                   long long m, const double* __restrict__ f,
                                   const long long* __restrict__ iv, int nf,
                                   int ni, long long cap,
                                   double* __restrict__ gf,
                                   long long* __restrict__ gi) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= m * (nf + ni)) return;
  const long long r = t / m;
  const long long j = t - r * m;
  long long p = idx[j];
  p = p < 0 ? 0 : (p >= cap ? cap - 1 : p);
  if (r < nf) {
    gf[r * m + j] = f[r * cap + p];
  } else {
    const long long q = r - nf;
    gi[q * m + j] = iv[q * cap + p];
  }
}

}  // namespace

// idx i64[m], fstack f64[nf, cap], istack i64[ni, cap]; writes gf f64[nf,
// m] and gi i64[ni, m].  Launches on `stream`; returns cudaGetLastError().
extern "C" int arroyo_ring_gather(const void* idx, long long m,
                                  const void* fstack, const void* istack,
                                  int nf, int ni, long long cap, void* gf,
                                  void* gi, void* stream) {
  if (m < 0 || nf < 0 || ni < 0 || cap <= 0) return cudaErrorInvalidValue;
  const long long n = m * (nf + ni);
  if (n == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  ring_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), m, static_cast<const double*>(fstack),
      static_cast<const long long*>(istack), nf, ni, cap,
      static_cast<double*>(gf), static_cast<long long*>(gi));
  return static_cast<int>(cudaGetLastError());
}
