// A warp-cooperative search of a sorted array, shared by the kernels
// that find their block's place in a prefix array once (segment_agg.cu,
// expand_gather.cu).
//
// warp_count_le(a, n, q) is #{i < n : a[i] <= q} for a[0, n) sorted
// ascending: the upper bound of q.  All 32 lanes call it and get the same
// answer.  Each round the lanes probe 32 evenly spaced entries at once
// and keep the stretch between the last probe <= q and the first above
// it, so a search over n entries takes ceil(log32(n)) + 1 rounds of one
// parallel load each (4 at n = 65,537) where a binary search takes
// log2(n) dependent loads (17).

#pragma once

__device__ __forceinline__ long long warp_count_le(const long long* __restrict__ a,
                                                   long long n, long long q) {
  const int lane = threadIdx.x & 31;
  long long lo = 0;  // the answer lies in [lo, hi]
  long long hi = n;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + (lane + 1) * step - 1;
    const bool le = p < hi && a[p] <= q;
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    const long long top = lo + (c + 1) * step - 1;
    lo += c * step;
    if (top < hi) hi = top;
  }
  const bool le = lane < hi - lo && a[lo + lane] <= q;
  return lo + __popc(__ballot_sync(0xffffffffu, le));
}
