// expand_gather: a hot join partition's fused probe emission — the
// candidate pairs' expansion, their full-key verify and the gather of
// both payload stacks at the matched ring rows, in one launch.
//
// Replaces arroyo_tpu/ops/join.py:487 `_expand_gather_kernel`.
//
// Semantics, for j < total = cum[mq - 1] (start, cum from join_probe):
//   (lidx[j], r) as join_expand computes them, ridx[j] = clip(r, 0, cap-1)
//   valid[j] = hi[ridx[j]] == q_hi[lidx[j]] && lo[ridx[j]] == q_lo[lidx[j]]
//   gf[k, j] = fstack[k, ridx[j]] for k < nf (f64; nf may be 0)
//   gi[k, j] = istack[k, ridx[j]] for k < ni (i64; row 0 the event time)
// lidx and ridx i64, valid a byte (torch.bool), all sized to the exact
// total.  A candidate whose top 32 hash bits match but whose low 32 do
// not is a false candidate: valid is False and the caller drops it.
//
// What bounds it on the H100: memory — per pair 8 bytes of key planes
// and 8 * (nf + ni) payload bytes read, 17 + 8 * (nf + ni) bytes written;
// at join-stress's few hundred pairs per partition probe, the launch.
//
// What the design does about it: one thread per pair (the upper-bound
// search over cum of join_search.cuh balances skewed fan-out, as in
// join_expand), and each thread writes column j of every stack row, so a
// warp's stores to one row coalesce while its loads follow the sorted,
// mostly ascending ring positions.

#include <cuda_runtime.h>

#include "join_search.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void expand_gather_kernel(
    const int* __restrict__ start, const long long* __restrict__ cum,
    long long mq, long long total, const int* __restrict__ hi,
    const int* __restrict__ lo, long long cap, const int* __restrict__ q_hi,
    const int* __restrict__ q_lo, const double* __restrict__ fstack, int nf,
    const long long* __restrict__ istack, int ni, long long* __restrict__ lidx,
    long long* __restrict__ ridx, unsigned char* __restrict__ valid,
    double* __restrict__ gf, long long* __restrict__ gi) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= total) return;
  long long l, r;
  expand_pair(start, cum, mq, j, &l, &r);
  r = r < 0 ? 0 : (r >= cap ? cap - 1 : r);
  lidx[j] = l;
  ridx[j] = r;
  valid[j] = hi[r] == q_hi[l] && lo[r] == q_lo[l];
  for (int k = 0; k < nf; ++k) gf[k * total + j] = fstack[k * cap + r];
  for (int k = 0; k < ni; ++k) gi[k * total + j] = istack[k * cap + r];
}

}  // namespace

// start i32[mq], cum i64[mq], hi and lo i32[cap], q_hi and q_lo i32[mq],
// fstack f64[nf, cap], istack i64[ni, cap] on the device.  Writes lidx,
// ridx i64[total], valid u8[total], gf f64[nf, total], gi i64[ni, total].
// One launch on `stream`; returns cudaGetLastError().
extern "C" int arroyo_expand_gather(const void* start, const void* cum,
                                    long long mq, long long total,
                                    const void* hi, const void* lo,
                                    long long cap, const void* q_hi,
                                    const void* q_lo, const void* fstack,
                                    int nf, const void* istack, int ni,
                                    void* lidx, void* ridx, void* valid,
                                    void* gf, void* gi, void* stream) {
  if (mq < 0 || total < 0 || (total > 0 && mq == 0) || cap <= 0 || nf < 0 ||
      ni < 0) {
    return cudaErrorInvalidValue;
  }
  if (total == 0) return cudaSuccess;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  expand_gather_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(start), static_cast<const long long*>(cum), mq,
      total, static_cast<const int*>(hi), static_cast<const int*>(lo), cap,
      static_cast<const int*>(q_hi), static_cast<const int*>(q_lo),
      static_cast<const double*>(fstack), nf,
      static_cast<const long long*>(istack), ni,
      static_cast<long long*>(lidx), static_cast<long long*>(ridx),
      static_cast<unsigned char*>(valid), static_cast<double*>(gf),
      static_cast<long long*>(gi));
  return static_cast<int>(cudaGetLastError());
}
