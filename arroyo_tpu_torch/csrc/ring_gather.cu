// ring_gather: the window-fire payload gather of a hot join partition —
// both payload stacks read at the given sorted-run positions.
//
// Replaces arroyo_tpu/ops/join.py:535 `_gather32_kernel`.
//
// Semantics: rows[r, t] = fstack[r, idx[t]] (its bits) for r < nf and
// rows[nf + r, t] = istack[r, idx[t]] for r < ni, t < m; an index outside
// [0, cap) is clamped into it, as the JAX gather clamps (callers pass
// in-range positions).
//
// What bounds it on the H100: memory — 8 bytes of index plus 8 * (nf + ni)
// bytes read and written per output position.  q8's fires gather a few
// thousand positions per partition, well under a megabyte, so the launch
// (host side included) dominates.
//
// What the design does about it: one thread per output position reads
// and clamps its index once and copies the nf + ni stack words there as
// 64-bit words (f64 rows move as their bits), so stores stay coalesced
// along each output row and the reads of a warp follow the sorted
// (mostly ascending) positions.  Both stacks land in ONE i64 buffer
// [nf + ni, m], one allocation and one readback for the caller; one
// launch per call.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void ring_gather_kernel(const long long* __restrict__ idx,
                                   long long m,
                                   const long long* __restrict__ f,
                                   const long long* __restrict__ iv, int nf,
                                   int ni, long long cap,
                                   long long* __restrict__ rows) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= m) return;
  long long p = idx[t];
  p = p < 0 ? 0 : (p >= cap ? cap - 1 : p);
  for (int r = 0; r < nf; ++r) rows[r * m + t] = f[r * cap + p];
  for (int r = 0; r < ni; ++r) rows[(nf + r) * m + t] = iv[r * cap + p];
}

}  // namespace

// idx i64[m], fstack f64[nf, cap], istack i64[ni, cap]; writes rows i64[nf
// + ni, m].  Launches on `stream`; returns cudaGetLastError().
extern "C" int arroyo_ring_gather(const void* idx, long long m,
                                  const void* fstack, const void* istack,
                                  int nf, int ni, long long cap, void* rows,
                                  void* stream) {
  if (m < 0 || nf < 0 || ni < 0 || cap <= 0) return cudaErrorInvalidValue;
  if (m == 0 || nf + ni == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  ring_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), m,
      static_cast<const long long*>(fstack),
      static_cast<const long long*>(istack), nf, ni, cap,
      static_cast<long long*>(rows));
  return static_cast<int>(cudaGetLastError());
}
