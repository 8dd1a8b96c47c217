// The scans and the ballot-rank write position shared by the kernels that
// compact flagged items in their original order (emit_compact.cu's count
// call, segment_top_k.cu).
//
// exclusive_scan_kernel, launched as ONE block of kScanThreads threads:
// offsets[i] = sum(counts[:i]) for i < n and offsets[n] = the total.  Each
// thread sums a contiguous chunk, the block scans the chunk sums in shared
// memory, and each thread then writes its chunk's running offsets, so any
// n fits in one launch.
//
// lookback_exclusive (emit_compact.cu's one-launch count): a decoupled
// look-back over tiles in block order.  The blocks of a 1-D grid start
// in index order, so every earlier tile is running or done when a tile
// looks back (the order CUB's single-pass scans rely on); a ticket
// counter would make every block wait its turn at one atomic.  Each tile
// publishes a status word with its aggregate as soon as it has one (tile
// 0 its inclusive prefix), then one warp reads the earlier tiles'
// words, 256 a round trip, newest first, back to the nearest inclusive
// prefix, and the tile publishes its own.  A status word is bits 63..34 the call's
// epoch, 33..32 the state (1 aggregate, 2 inclusive prefix) and 31..0 the
// value, so value and state land in one store and no fence is needed;
// a word of another epoch reads as unpublished, so the words are never
// zeroed between calls: each call brings a new epoch (1 .. 2^30 - 1) and
// the caller zeroes the words only when the epochs wrap.
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

constexpr unsigned long long kLookAggregate = 1;
constexpr unsigned long long kLookInclusive = 2;

__device__ __forceinline__ unsigned long long look_word(
    unsigned epoch, unsigned long long state, unsigned value) {
  return (static_cast<unsigned long long>(epoch) << 34) | (state << 32) |
         value;
}

__device__ __forceinline__ void look_publish(unsigned long long* status,
                                             int tile, unsigned epoch,
                                             unsigned long long state,
                                             unsigned value) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(status + tile),
               "l"(look_word(epoch, state, value))
               : "memory");
}

// The sum of the values of tiles 0 .. tile - 1 (tile > 0, which has
// published its aggregate).  All 32 lanes of one warp call it.  A round
// trip reads kLookDepth * 32 status words, lane l the kLookDepth words
// after the newest l * kLookDepth, so a tile far from the nearest
// inclusive prefix (every tile of a grid that finishes at once) walks
// back few rounds; while a word it needs is unpublished the warp backs
// off a little before it reads again, so the spinning warps leave the
// status words' L2 lines to the tiles still publishing.  Every earlier
// tile has started and publishes its aggregate without waiting on this
// one.
constexpr int kLookDepth = 8;

__device__ unsigned lookback_exclusive(const unsigned long long* status,
                                       int tile, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0;
  for (int hi = tile - 1;; hi -= 32 * kLookDepth) {
    unsigned v, inc, upto;
    for (unsigned backoff = 32;; backoff = min(backoff * 2, 1024u)) {
      // this lane's words, newest first: the value up to its newest
      // inclusive prefix (all of them when none is), and whether a word
      // on the way is unpublished
      v = 0;
      bool has_inc = false, bad = false;
#pragma unroll
      for (int j = 0; j < kLookDepth; ++j) {
        const int idx = hi - lane * kLookDepth - j;
        unsigned long long w = look_word(epoch, kLookInclusive, 0);
        if (idx >= 0) {
          asm volatile("ld.relaxed.gpu.u64 %0, [%1];"
                       : "=l"(w)
                       : "l"(status + idx)
                       : "memory");
        }
        const unsigned state =
            (w >> 34) == epoch ? static_cast<unsigned>((w >> 32) & 3) : 0;
        if (!has_inc) {
          bad |= state == 0;
          v += static_cast<unsigned>(w);
          has_inc = state == kLookInclusive;
        }
      }
      inc = __ballot_sync(0xffffffffu, has_inc);
      // the lanes up to the newest inclusive prefix (all when none is)
      upto = inc ? (inc & (0u - inc)) * 2u - 1u : 0xffffffffu;
      if ((__ballot_sync(0xffffffffu, bad) & upto) == 0) break;
      __nanosleep(backoff);
    }
    v = (upto >> lane) & 1u ? v : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (inc) return excl;
  }
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
