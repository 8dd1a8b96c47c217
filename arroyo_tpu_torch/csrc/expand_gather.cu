// expand_gather: a hot join partition's fused probe emission — the
// candidate pairs' expansion, their full-key verify and the gather of
// both payload stacks at the matched ring rows, in one launch.
//
// Replaces arroyo_tpu/ops/join.py:487 `_expand_gather_kernel`.
//
// Semantics, with total = cum[mq - 1] read on the device (0 when mq = 0)
// and n = min(total, capacity), for j < n (start, cum from join_probe):
//   (lidx[j], r) as join_expand computes them, ridx[j] = clip(r, 0, cap-1)
//   valid[j] = hi[ridx[j]] == q_hi[lidx[j]] && lo[ridx[j]] == q_lo[lidx[j]]
//   gf[k, j] = fstack[k, ridx[j]] for k < nf (f64; nf may be 0)
//   gi[k, j] = istack[k, ridx[j]] for k < ni (i64; row 0 the event time)
// All land in ONE i64 buffer: word 0 the total, then rows [lidx, ridx, gf
// (as its bits), gi] of `capacity` words each, W = 2 + nf + ni rows, then
// valid as `capacity` bytes (torch.bool); entries past n are not written.
// The host sizes the buffer before it knows the total, so a probe and its
// expansion run back to back with no sync between them; a total above
// the capacity comes back in the header, and the caller launches again
// at that size.  A candidate whose top 32 hash bits match but whose low
// 32 do not is a false candidate: valid is False and the caller drops it.
//
// What bounds it on the H100: memory — per pair 8 bytes of key planes
// and 8 * (nf + ni) payload bytes read, 17 + 8 * (nf + ni) bytes written;
// at join-stress's few hundred pairs per partition probe, the launch.
//
// What the design does about it: a block expands 512 consecutive pairs.
// It stages `cum` in shared memory with one coalesced load: all of it
// when it holds at most 1,024 queries (join-stress's 1,024), else the
// stretch of the block's queries, which two of its warps find first with
// one warp-cooperative search of `cum` each (warp_search.cuh; a stretch
// of more than 1,024 queries, which only runs of queries without pairs
// make, is searched in global memory).  Each thread then finds its
// pairs' queries by a binary search in shared memory instead of about
// log2(mq) dependent loads of global memory (`start` and the query keys
// it reads once a pair, from global memory), and writes column j of
// every output row, so a warp's stores to one row coalesce while its
// loads follow the sorted, mostly ascending ring positions.  One buffer:
// the caller reads it back in one copy.

#include <cuda_runtime.h>

#include "join_search.cuh"
#include "warp_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 512;   // pairs a block expands
constexpr int kStage = 1024;  // queries a block stages

__global__ void __launch_bounds__(kThreads) expand_gather_kernel(
    const int* __restrict__ start, const long long* __restrict__ cum,
    long long mq, long long capacity, const int* __restrict__ hi,
    const int* __restrict__ lo, long long cap, const int* __restrict__ q_hi,
    const int* __restrict__ q_lo, const long long* __restrict__ fstack,
    int nf, const long long* __restrict__ istack, int ni,
    long long* __restrict__ out) {
  __shared__ long long s_cum[kStage];
  __shared__ long long s_l[2];
  const int tid = threadIdx.x;
  const long long total = mq > 0 ? cum[mq - 1] : 0;
  if (blockIdx.x == 0 && tid == 0) out[0] = total;
  const long long n = min(total, capacity);
  const long long j0 = static_cast<long long>(blockIdx.x) * kPairs;
  if (j0 >= n) return;  // the whole block: past the pairs
  const long long j1 = min(j0 + kPairs, n) - 1;
  // the block's queries [l_lo, l_hi] and the stretch of cum staged from
  // `first`: all of cum when it fits (one coalesced load, no search)
  long long l_lo = 0;
  long long l_hi = mq - 1;
  long long first = 0;
  long long span = mq;
  if (mq > kStage) {
    if (tid < 64) {
      const long long l = warp_count_le(cum, mq, tid < 32 ? j0 : j1);
      if ((tid & 31) == 0) s_l[tid >> 5] = l < mq - 1 ? l : mq - 1;
    }
    __syncthreads();
    l_lo = s_l[0];
    l_hi = s_l[1];
    first = l_lo > 0 ? l_lo - 1 : 0;  // l_lo - 1's cum starts l_lo's pairs
    span = l_hi - first + 1;
  }
  const bool staged = span <= kStage;
  if (staged) {
    for (long long x = tid; x < span; x += kThreads) {
      s_cum[x] = cum[first + x];
    }
  }
  __syncthreads();
  const long long* c = staged ? s_cum : cum + first;
  long long* rows = out + 1;
  const long long n_rows = 2 + nf + ni;
  unsigned char* valid =
      reinterpret_cast<unsigned char*>(rows + n_rows * capacity);
  for (long long j = j0 + tid; j <= j1; j += kThreads) {
    // l = #{i : cum[i] <= j}: every query before l_lo counts, none past
    // l_hi (cum[l_hi] > j1), so search [l_lo, l_hi) only
    const long long l = l_lo + bound<true>(c + (l_lo - first), l_hi - l_lo, j);
    const long long before = l > 0 ? c[l - first - 1] : 0;
    long long r = static_cast<long long>(start[l]) + (j - before);
    r = r < 0 ? 0 : (r >= cap ? cap - 1 : r);
    rows[j] = l;
    rows[capacity + j] = r;
    valid[j] = hi[r] == q_hi[l] && lo[r] == q_lo[l];
    long long* row = rows + 2 * capacity + j;
    for (int k = 0; k < nf; ++k, row += capacity) *row = fstack[k * cap + r];
    for (int k = 0; k < ni; ++k, row += capacity) *row = istack[k * cap + r];
  }
}

}  // namespace

// start i32[mq], cum i64[mq], hi and lo i32[cap], q_hi and q_lo i32[mq],
// fstack f64[nf, cap], istack i64[ni, cap] on the device.  Writes `out`:
// the total, i64[2 + nf + ni, capacity] (lidx, ridx, gf as bits, gi),
// then `capacity` bytes of valid.  One launch on `stream` (at least one
// block, for the header); returns cudaGetLastError().
extern "C" int arroyo_expand_gather(const void* start, const void* cum,
                                    long long mq, long long capacity,
                                    const void* hi, const void* lo,
                                    long long cap, const void* q_hi,
                                    const void* q_lo, const void* fstack,
                                    int nf, const void* istack, int ni,
                                    void* out, void* stream) {
  if (mq < 0 || capacity < 0 || cap <= 0 || nf < 0 || ni < 0) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = (capacity + kPairs - 1) / kPairs;
  expand_gather_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(start), static_cast<const long long*>(cum), mq,
      capacity, static_cast<const int*>(hi), static_cast<const int*>(lo), cap,
      static_cast<const int*>(q_hi), static_cast<const int*>(q_lo),
      static_cast<const long long*>(fstack), nf,
      static_cast<const long long*>(istack), ni,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
