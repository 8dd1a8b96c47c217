// ring_merge: one hot join partition's merge — fresh power-of-two planes
// holding the resident run with the sorted delta inserted, keys and
// payload stacks in lockstep, written as a gather in one launch.
//
// Replaces arroyo_tpu/ops/join.py:372 `_merge32_kernel`.
//
// Semantics: the delta's positions delta_pos[0, m) are strictly
// increasing in [0, n_res + m), n_res + m <= cap.  For an output slot k:
//   k >= n_res + m:                      hi SENT32_HI, lo SENT32_LO, 0, 0
//   j = #{delta_pos < k}, delta_pos[j] == k:   delta entry j
//   otherwise:                           resident entry k - j
// That is `_merge32_kernel` with res_pos the ascending complement of
// delta_pos in [0, n_res + m) — resident i lands at i + #{j : delta_pos[j]
// <= i + j} — which is every input the join state makes (its merge is a
// pure insert), with nothing out of range to drop.
//
// What bounds it on the H100: memory, and at join-stress's and q8's
// shapes the launch.  It reads the n_res resident columns and the m delta
// columns once and writes all cap output columns once: n_res * w + m * (w
// + 8) + cap * w bytes, w = 8 + 8 * (nf + ni).  At cap = 65,536, nf = 2,
// ni = 6, 60% resident and 20% delta that is about 8.6 MB, 2.6 us of HBM
// time.
//
// What the design does about it: one thread per output slot, so every
// output byte is written once, coalesced, with no fill pass, and the
// resident reads are a shifted stream.  A block of 256 slots finds its
// first delta index j0 = #{delta_pos < k0} with one warp-cooperative
// search (warp_search.cuh), stages delta_pos[j0, j0 + 256) in shared
// memory (the positions are distinct integers, so at most 256 of them
// fall in its slots) and each thread finds its j by an 8-step binary
// search there.  A block wholly past the run writes padding only.  One
// launch into one output buffer: hi and lo, then the f64 stack, then the
// i64 stack.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "warp_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kSentHi = 0x7FFFFFFF;
constexpr int32_t kSentLo = -1;

struct Planes {
  int32_t* hi;
  int32_t* lo;
  double* f;
  long long* i;
};

__global__ void __launch_bounds__(kThreads) merge_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const double* __restrict__ f, const long long* __restrict__ iv,
    long long n_res, long long cap, const int32_t* __restrict__ d_hi,
    const int32_t* __restrict__ d_lo, const double* __restrict__ d_f,
    const long long* __restrict__ d_i, const long long* __restrict__ d_pos,
    long long m, int nf, int ni, Planes out) {
  __shared__ long long s_pos[kThreads];
  __shared__ long long s_j0;
  const long long k0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long k = k0 + threadIdx.x;
  const long long used = n_res + m;
  if (k0 < used) {  // the block holds run slots: place its delta first
    if (threadIdx.x < 32) {
      const long long j = warp_count_le(d_pos, m, k0 - 1);
      if (threadIdx.x == 0) s_j0 = j;
    }
    __syncthreads();
    const long long j0 = s_j0;
    s_pos[threadIdx.x] =
        j0 + threadIdx.x < m ? d_pos[j0 + threadIdx.x] : LLONG_MAX;
    __syncthreads();
    if (k < used) {
      int a = 0;  // #{staged positions < k}
      int b = kThreads;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (s_pos[mid] < k) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      const long long j = j0 + a;
      if (a < kThreads && s_pos[a] == k) {  // delta entry j
        out.hi[k] = d_hi[j];
        out.lo[k] = d_lo[j];
        for (int r = 0; r < nf; ++r) out.f[r * cap + k] = d_f[r * m + j];
        for (int r = 0; r < ni; ++r) out.i[r * cap + k] = d_i[r * m + j];
      } else {  // resident entry k - j
        const long long src = k - j;
        out.hi[k] = hi[src];
        out.lo[k] = lo[src];
        for (int r = 0; r < nf; ++r) out.f[r * cap + k] = f[r * cap + src];
        for (int r = 0; r < ni; ++r) out.i[r * cap + k] = iv[r * cap + src];
      }
      return;
    }
  }
  if (k >= cap) return;
  out.hi[k] = kSentHi;
  out.lo[k] = kSentLo;
  for (int r = 0; r < nf; ++r) out.f[r * cap + k] = 0.0;
  for (int r = 0; r < ni; ++r) out.i[r * cap + k] = 0;
}

}  // namespace

// Resident planes hi/lo i32[cap] (the first n_res entries live), fstack
// f64[nf, cap], istack i64[ni, cap]; delta d_hi/d_lo i32[m], d_f f64[nf,
// m], d_i i64[ni, m] at positions delta_pos i64[m] (strictly increasing,
// in [0, n_res + m)).  Writes `out`: out_hi i32[cap], out_lo i32[cap],
// out_f f64[nf, cap], out_i i64[ni, cap], back to back (nf = ni = 0:
// keys only, the stack pointers are not read).  One launch on `stream`;
// returns cudaGetLastError().
extern "C" int arroyo_ring_merge(const void* hi, const void* lo,
                                 const void* fstack, const void* istack,
                                 long long n_res, long long cap,
                                 const void* d_hi, const void* d_lo,
                                 const void* d_f, const void* d_i,
                                 const void* delta_pos, long long m, int nf,
                                 int ni, void* out, void* stream) {
  if (cap <= 0 || n_res < 0 || m < 0 || n_res + m > cap || nf < 0 ||
      ni < 0) {
    return cudaErrorInvalidValue;
  }
  Planes o;
  o.hi = static_cast<int32_t*>(out);
  o.lo = o.hi + cap;
  o.f = reinterpret_cast<double*>(o.lo + cap);
  o.i = reinterpret_cast<long long*>(o.f + nf * cap);
  const unsigned blocks = static_cast<unsigned>((cap + kThreads - 1) /
                                                kThreads);
  merge_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const double*>(fstack),
      static_cast<const long long*>(istack), n_res, cap,
      static_cast<const int32_t*>(d_hi), static_cast<const int32_t*>(d_lo),
      static_cast<const double*>(d_f), static_cast<const long long*>(d_i),
      static_cast<const long long*>(delta_pos), m, nf, ni, o);
  return static_cast<int>(cudaGetLastError());
}
