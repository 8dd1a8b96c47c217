// Binary searches shared by the join kernels (join_probe.cu,
// join_expand.cu, expand_gather.cu).
//
// bound<Strict>(a, n, q) is the first index i in [0, n) with a[i] >= q
// (Strict = false: the lower bound) or a[i] > q (Strict = true: the upper
// bound), and n when there is none; a[0, n) must be sorted ascending.

#pragma once

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

// The expansion of match ranges into pairs: pair j belongs to the query
// l whose cumulative-count interval holds it (cum[l - 1] <= j < cum[l]),
// i.e. l = #{i : cum[i] <= j}, clipped to [0, mq - 1]; its ring position
// is start[l] plus j's offset inside the interval.
__device__ __forceinline__ void expand_pair(const int* __restrict__ start,
                                            const long long* __restrict__ cum,
                                            long long mq, long long j,
                                            long long* l_out,
                                            long long* r_out) {
  long long l = bound<true>(cum, mq, j);
  if (l > mq - 1) l = mq - 1;
  const long long before = l > 0 ? cum[l - 1] : 0;
  *l_out = l;
  *r_out = static_cast<long long>(start[l]) + (j - before);
}
