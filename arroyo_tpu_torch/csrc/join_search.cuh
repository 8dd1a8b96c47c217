// The binary search and the staged pair expansion shared by
// join_expand.cu and expand_gather.cu.
//
// bound<Strict>(a, n, q) is the first index i in [0, n) with a[i] >= q
// (Strict = false: the lower bound) or a[i] > q (Strict = true: the upper
// bound), and n when there is none; a[0, n) must be sorted ascending.

#pragma once

#include "warp_search.cuh"

template <bool Strict, typename T>
__device__ __forceinline__ long long bound(const T* __restrict__ a,
                                           long long n, T q) {
  long long lo = 0;
  long long hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const T v = a[mid];
    if (Strict ? v <= q : v < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The pair expansion of a probe's match ranges, staged, shared by
// join_expand.cu and expand_gather.cu.  Pair j belongs to the query l
// whose cumulative-count interval holds it (cum[l - 1] <= j < cum[l]),
// i.e. l = #{i : cum[i] <= j}, clipped to [0, mq - 1]; its ring position
// is start[l] plus j's offset inside the interval.
//
// A block expands kPairs consecutive pairs [j0, j1].  It stages `cum`
// and `start` in shared memory with one round of cp.async copies when
// they hold at most kStage queries, and reads the pair total from the
// staged copy; when the queries average more than 4 pairs, two warps
// then find the block's queries [l_lo, l_hi] with one warp-cooperative
// search each (warp_search.cuh) of the copy.  With
// more queries one warp reads the total, the two warps search global
// memory, and the block stages that stretch; a stretch of more than
// kStage queries (only runs of queries without pairs make one) stays in
// global memory.  Each thread then finds a pair's query by binary lifting
// over [l_lo, l_hi) of the staged stretch — none when the block's pairs
// all belong to one query — instead of about log2(mq) dependent loads of
// global memory, and its ring position without one.

constexpr int kPairs = 512;   // pairs a block expands
constexpr int kStage = 1024;  // queries a block stages

struct PairBlock {
  const long long* c;  // cum from entry `first`: staged or global
  const int* s;        // start from entry `first`, the same
  bool staged;
  long long first;
  long long l_lo;   // the block's queries [l_lo, l_hi]
  long long l_hi;
  long long j0;     // the block's pairs [j0, j1]
  long long j1;
  long long total;  // cum[mq - 1], 0 when mq = 0
};

template <int kBytes>
__device__ __forceinline__ void copy_async(void* smem, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
               "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
}

// Every thread of the block calls it (it synchronizes).  Fills
// pb->total always; returns false when the block holds no pair, i.e.
// j0 >= min(total, capacity) (the block then returns).
template <int kThreads>
__device__ __forceinline__ bool stage_pairs(const int* __restrict__ start,
                                            const long long* __restrict__ cum,
                                            long long mq, long long capacity,
                                            PairBlock* pb) {
  __shared__ long long s_cum[kStage];
  __shared__ int s_start[kStage];
  __shared__ long long s_word[3];  // the total, the two searched queries
  const int tid = threadIdx.x;
  const long long j0 = static_cast<long long>(blockIdx.x) * kPairs;
  const bool all = mq <= kStage;
  long long total;
  if (all) {
    for (int x = tid; x < mq; x += kThreads) {
      copy_async<8>(s_cum + x, cum + x);
      copy_async<4>(s_start + x, start + x);
    }
    wait_async();
    __syncthreads();
    total = mq > 0 ? s_cum[mq - 1] : 0;
  } else {
    if (tid < 32) {
      const long long t = cum[mq - 1];
      if (tid == 0) s_word[0] = t;
    }
    __syncthreads();
    total = s_word[0];
  }
  const long long n = total < capacity ? total : capacity;
  pb->total = total;
  if (j0 >= n) return false;
  const long long j1 = (j0 + kPairs < n ? j0 + kPairs : n) - 1;
  // a staged copy is searched whole unless the queries average more than
  // 4 pairs, when the block's stretch is short enough to save the two
  // searches and a barrier that find it
  if (all && total <= 4 * mq) {
    *pb = PairBlock{s_cum, s_start, true, 0, 0, mq - 1, j0, j1, total};
    return true;
  }
  // the block's queries [l_lo, l_hi]: two warp-cooperative searches, of
  // the staged copy or of global memory
  if (tid < 64) {
    const long long l =
        warp_count_le(all ? s_cum : cum, mq, tid < 32 ? j0 : j1);
    if ((tid & 31) == 0) s_word[1 + (tid >> 5)] = l < mq - 1 ? l : mq - 1;
  }
  __syncthreads();
  const long long l_lo = s_word[1];
  const long long l_hi = s_word[2];
  if (all) {
    *pb = PairBlock{s_cum, s_start, true, 0, l_lo, l_hi, j0, j1, total};
    return true;
  }
  const long long first = l_lo > 0 ? l_lo - 1 : 0;  // its cum starts l_lo's
  const long long span = l_hi - first + 1;
  const bool staged = span <= kStage;
  if (staged) {
    for (int x = tid; x < span; x += kThreads) {
      copy_async<8>(s_cum + x, cum + first + x);
      copy_async<4>(s_start + x, start + first + x);
    }
    wait_async();
  }
  __syncthreads();
  *pb = PairBlock{staged ? s_cum : cum + first,
                  staged ? s_start : start + first, staged, first, l_lo, l_hi,
                  j0, j1, total};
  return true;
}

// #{x < len : a[x] <= q} for a[0, len) sorted, len < 2^31: the upper
// bound by binary lifting, a compare and a select a step in 32-bit
// indices (for a staged stretch: at most 11 steps).
__device__ __forceinline__ int count_le(const long long* a, int len,
                                        long long q) {
  int pos = 0;
  if (len > 0) {
    for (int step = 1 << (31 - __clz(len)); step > 0; step >>= 1) {
      const int next = pos + step;
      if (next <= len && a[next - 1] <= q) pos = next;
    }
  }
  return pos;
}

// Pair j's query l (in [pb.l_lo, pb.l_hi]) and its ring position
// start[l] + j - cum[l - 1] (cum[-1] = 0): every query before l_lo
// counts, none past l_hi, so the search covers [l_lo, l_hi) only.
__device__ __forceinline__ long long pair_query(const PairBlock& pb,
                                                long long j, long long* r) {
  const long long* a = pb.c + (pb.l_lo - pb.first);
  const long long len = pb.l_hi - pb.l_lo;
  const long long l =
      pb.l_lo + (pb.staged ? count_le(a, static_cast<int>(len), j)
                           : bound<true>(a, len, j));
  const long long x = l - pb.first;
  *r = static_cast<long long>(pb.s[x]) + (j - (l > 0 ? pb.c[x - 1] : 0));
  return l;
}
