// ring_merge: one hot join partition's scatter-merge — fresh power-of-two
// planes holding the resident run moved to its new sorted positions and
// the sorted delta landed between, keys and payload stacks in lockstep.
//
// Replaces arroyo_tpu/ops/join.py:372 `_merge32_kernel`.
//
// Semantics: out_hi = SENT32_HI, out_lo = SENT32_LO, out_f = 0, out_i = 0
// over all cap positions; then for every resident entry i with
// 0 <= res_pos[i] < cap its hi, lo, f-column and i-column move to
// res_pos[i]; then every delta entry j with 0 <= delta_pos[j] < cap lands
// at delta_pos[j] (a position outside [0, cap) is dropped, the JAX
// kernel's mode="drop").  The delta pass runs after the resident pass, so
// on a (never intended) shared position the delta wins, as in JAX.
//
// What bounds it on the H100: memory, and at q8's shapes the launches.
// It reads the resident planes and the delta once and writes the new
// planes once: (8 + 8 * (nf + ni)) bytes per slot, plus 8 bytes of
// position per entry.  At cap = 65,536 with nf = 2, ni = 6 that is about
// 5 MB, 1.6 us of HBM time.
//
// What the design does about it: the output is NEW planes, never the
// resident ones — res_pos moves resident entries forward, so an in-place
// scatter would overwrite entries not yet moved.  Three launches in stream
// order (fill, resident scatter, delta scatter), one thread per slot or
// entry, each thread moving its entry's whole column of the stacks.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kSentHi = 0x7FFFFFFF;
constexpr int32_t kSentLo = -1;

__global__ void fill_kernel(int32_t* __restrict__ hi, int32_t* __restrict__ lo,
                            double* __restrict__ f, long long* __restrict__ iv,
                            int nf, int ni, long long cap) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= cap) return;
  hi[t] = kSentHi;
  lo[t] = kSentLo;
  for (int r = 0; r < nf; ++r) f[r * cap + t] = 0.0;
  for (int r = 0; r < ni; ++r) iv[r * cap + t] = 0;
}

// Moves n source entries (hi/lo/f/i columns of width src_w) to pos[].
__global__ void scatter_kernel(const int32_t* __restrict__ s_hi,
                               const int32_t* __restrict__ s_lo,
                               const double* __restrict__ s_f,
                               const long long* __restrict__ s_i,
                               const long long* __restrict__ pos, long long n,
                               long long src_w, int32_t* __restrict__ hi,
                               int32_t* __restrict__ lo,
                               double* __restrict__ f,
                               long long* __restrict__ iv, int nf, int ni,
                               long long cap) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const long long d = pos[t];
  if (d < 0 || d >= cap) return;
  hi[d] = s_hi[t];
  lo[d] = s_lo[t];
  for (int r = 0; r < nf; ++r) f[r * cap + d] = s_f[r * src_w + t];
  for (int r = 0; r < ni; ++r) iv[r * cap + d] = s_i[r * src_w + t];
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Resident planes hi/lo i32[cap], fstack f64[nf, cap], istack i64[ni, cap]
// with positions res_pos i64[cap]; delta d_hi/d_lo i32[db], d_f f64[nf,
// db], d_i i64[ni, db] with positions delta_pos i64[db]; writes the fresh
// planes out_hi/out_lo i32[cap], out_f f64[nf, cap], out_i i64[ni, cap]
// (nf = ni = 0: keys only, the stack pointers are not read).  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int arroyo_ring_merge(const void* hi, const void* lo,
                                 const void* fstack, const void* istack,
                                 const void* res_pos, const void* d_hi,
                                 const void* d_lo, const void* d_f,
                                 const void* d_i, const void* delta_pos,
                                 long long cap, long long db, int nf, int ni,
                                 void* out_hi, void* out_lo, void* out_f,
                                 void* out_i, void* stream) {
  if (cap <= 0 || db < 0 || nf < 0 || ni < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* o_hi = static_cast<int32_t*>(out_hi);
  int32_t* o_lo = static_cast<int32_t*>(out_lo);
  double* o_f = static_cast<double*>(out_f);
  long long* o_i = static_cast<long long*>(out_i);
  fill_kernel<<<blocks_for(cap), kThreads, 0, st>>>(o_hi, o_lo, o_f, o_i, nf,
                                                    ni, cap);
  scatter_kernel<<<blocks_for(cap), kThreads, 0, st>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const double*>(fstack), static_cast<const long long*>(istack),
      static_cast<const long long*>(res_pos), cap, cap, o_hi, o_lo, o_f, o_i,
      nf, ni, cap);
  if (db > 0) {
    scatter_kernel<<<blocks_for(db), kThreads, 0, st>>>(
        static_cast<const int32_t*>(d_hi), static_cast<const int32_t*>(d_lo),
        static_cast<const double*>(d_f), static_cast<const long long*>(d_i),
        static_cast<const long long*>(delta_pos), db, db, o_hi, o_lo, o_f,
        o_i, nf, ni, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
