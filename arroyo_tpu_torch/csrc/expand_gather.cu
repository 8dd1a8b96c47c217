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
// What the design does about it: the staged expansion join_expand also
// runs (join_search.cuh): a block expands 512 consecutive pairs, `cum`
// and `start` staged in shared memory in one round of copies (all of
// them up to 1,024 queries, else the block's stretch, found by two
// warp-cooperative searches), and a binary search in shared memory per
// pair (the query keys it reads once a pair, from global memory).  Each
// thread writes column j of every output row, so a warp's stores to one
// row coalesce while its loads follow the sorted, mostly ascending ring
// positions.  One buffer: the caller reads it back in one copy.

#include <cuda_runtime.h>

#include "join_search.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) expand_gather_kernel(
    const int* __restrict__ start, const long long* __restrict__ cum,
    long long mq, long long capacity, const int* __restrict__ hi,
    const int* __restrict__ lo, long long cap, const int* __restrict__ q_hi,
    const int* __restrict__ q_lo, const long long* __restrict__ fstack,
    int nf, const long long* __restrict__ istack, int ni,
    long long* __restrict__ out) {
  PairBlock pb;
  const bool any = stage_pairs<kThreads>(start, cum, mq, capacity, &pb);
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = pb.total;
  if (!any) return;
  long long* rows = out + 1;
  const long long n_rows = 2 + nf + ni;
  unsigned char* valid =
      reinterpret_cast<unsigned char*>(rows + n_rows * capacity);
  for (long long j = pb.j0 + threadIdx.x; j <= pb.j1; j += kThreads) {
    long long r;
    const long long l = pair_query(pb, j, &r);
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
