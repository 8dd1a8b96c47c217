// join_probe: the match ranges of sorted queries in a sorted key plane —
// per query its lower bound, its match count and the inclusive prefix sum
// of the counts — in two forms: i32 keys (a hot join partition's ring
// `hi` plane: candidate ranges of the top 32 hash bits) and u64 keys (the
// legacy join layout's full key hashes, the bits of an i64 tensor ordered
// as unsigned).  One templated kernel serves both.
//
// Replaces arroyo_tpu/ops/join.py:76 `_probe_kernel` (both forms: the
// `searchsorted` one and the merged-rank one the TPU takes to stay off
// searchsorted's sequential lowering; they compute the same outputs).
//
// Semantics, for i < mq (q_hi[0, mq) sorted, the queries past m padded
// with the plane's sentinel — the i32 ring's, or SENTINEL (all ones) for
// u64; hi[0, cap) sorted, its rows past n_valid padded with the same
// sentinel):
//   s = min(lower_bound(hi[0, cap), q_hi[i]), n_valid)
//   e = min(upper_bound(hi[0, cap), q_hi[i]), n_valid)
//   start[i] = s, counts[i] = i < m ? e - s : 0 (both i32)
//   cum[i] = counts[0] + ... + counts[i] (i64; the JAX kernel's is i32)
// Because hi is sorted, both are the bounds in hi[0, n_valid): the
// kernel never reads past n_valid.
//
// What bounds it on the H100: at join-stress's shapes (a few hundred
// queries against rings of a few thousand rows) the launch; the bytes
// (the queries, the ring rows the searches touch, 16 bytes written per
// query) are kilobytes.  What the searches cost is latency: a binary
// search over global memory is log2(n_valid) dependent loads.
//
// What the design does about it:
// - The block stages the ring's search tree in shared memory: the whole
//   live `hi` plane (coalesced 16-byte loads) while it fits 32 KB (8,192
//   i32 rows, as join-stress's 8a rings do; 4,096 u64 rows) and 16 rows a
//   real query, else every 2^shift-th row within that budget (at least
//   256 rows), so the top levels of a search hit shared memory and only
//   the last `shift` levels go to global memory.  The legacy layout's
//   probes (a fire's sorted left keys against its sorted right keys, up to
//   2^20 of each) stage samples and finish in global memory.  A few
//   queries on a large ring stage a few samples: staging is one strided
//   load a row.
// - No search where the answer is known: a query above hi[n_valid - 1]
//   (every sentinel padding query, every query past the ring) has s = e
//   = n_valid; a query equal to it has e = n_valid.  This holds for any
//   input, so the semantics stay exact.
// - The upper bound starts at the lower bound and gallops (1, 2, 4, ...
//   rows) inside the stretch the staged rows bound, so an equal run of r
//   rows costs about log2(r) reads and a miss one.
// - A block owns a tile of 1,024 queries (four per thread) and scans it
//   with warp shuffles; when the queries fill one tile — join-stress's
//   probes always do — that is the only launch.  Larger inputs add two
//   stream-ordered launches: one block scans the tile totals into
//   carries, a row-parallel pass adds them.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kStageBytes = 32768;  // staged rows a block (8,192 i32)

// Exclusive sum of one value per thread across the block (blockDim.x a
// multiple of 32); the block total goes to *total.  Ends with a barrier
// so it may be called again in a loop.
__device__ long long block_exclusive_sum(long long x, long long* total) {
  __shared__ long long warp_sums[32];
  __shared__ long long block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  long long inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < n_warps ? warp_sums[lane] : 0;
    long long winc = w;
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(0xffffffffu, winc, d);
      if (lane >= d) winc += o;
    }
    if (lane < n_warps) warp_sums[lane] = winc - w;
    if (lane == n_warps - 1) block_total = winc;
  }
  __syncthreads();
  const long long out = warp_sums[warp] + inc - x;
  *total = block_total;
  __syncthreads();
  return out;
}

// #{t < n : a[t] < q} (Strict = false) or #{t < n : a[t] <= q} (Strict =
// true) in the sorted a[0, n): a binary search.
template <bool Strict, typename K>
__device__ __forceinline__ long long count_below(const K* a, long long lo,
                                                 long long hi, K q) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const K v = a[mid];
    if (Strict ? v <= q : v < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The first index in [lo, end) whose value exceeds q, or end — given
// that none before lo does: gallop from lo (1, 2, 4, ... rows), then a
// binary search inside the last step.
template <typename K>
__device__ __forceinline__ long long gallop_upper(const K* a, long long lo,
                                                  long long end, K q) {
  long long hi = end;  // the answer lies in [lo, hi]
  for (long long step = 1; lo < hi; step <<= 1) {
    const long long p = lo + step - 1;
    if (p >= hi) break;
    if (a[p] > q) {
      hi = p;
      break;
    }
    lo = p + 1;
  }
  return count_below<true, K>(a, lo, hi, q);
}

// (1) per tile: the staged search tree, the bounds per query, the
// tile-local inclusive prefix sum of the counts into cum, and the tile's
// total into tile_sum.  s_hi[t] = hi[t << shift] for t < ns.  K is int
// (i32 ring planes) or unsigned long long (u64 keys).
template <typename K>
__global__ void __launch_bounds__(kThreads) probe_tile(
    const K* __restrict__ q_hi, long long mq, const K* __restrict__ hi,
    long long m, long long n_valid, int shift, int ns,
    int* __restrict__ start, int* __restrict__ counts,
    long long* __restrict__ cum, long long* __restrict__ tile_sum) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  K* s_hi = reinterpret_cast<K*>(s_raw);
  const int tid = threadIdx.x;
  if (sizeof(K) == 4 && shift == 0 &&
      (reinterpret_cast<uintptr_t>(hi) & 15) == 0) {
    const int n4 = ns >> 2;
    const int4* h4 = reinterpret_cast<const int4*>(hi);
    int4* s4 = reinterpret_cast<int4*>(s_raw);
    for (int t = tid; t < n4; t += kThreads) s4[t] = h4[t];
    for (int t = (n4 << 2) + tid; t < ns; t += kThreads) s_hi[t] = hi[t];
  } else {
    for (int t = tid; t < ns; t += kThreads) {
      s_hi[t] = hi[static_cast<long long>(t) << shift];
    }
  }
  __syncthreads();
  // staged whole, the staged rows ARE the plane: search them alone
  const K* plane = shift == 0 ? s_hi : hi;
  const K last = n_valid > 0 ? plane[n_valid - 1] : K(0);
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int t0 = tid * kItems;
  long long c[kItems];
  long long agg = 0;
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + t0 + k;
    c[k] = 0;
    if (i < mq) {
      const K q = q_hi[i];
      long long s = n_valid;
      long long e = n_valid;
      if (n_valid > 0 && q <= last) {
        // lower bound: staged rows t - 1 (< q) and t (>= q) bound it
        const long long t = count_below<false, K>(s_hi, 0, ns, q);
        if (shift == 0) {
          s = t;
        } else {
          const long long a = t > 0 ? ((t - 1) << shift) + 1 : 0;
          const long long b = t < ns ? t << shift : n_valid;
          s = count_below<false, K>(hi, a, b, q);
        }
        if (i >= m) {
          e = s;  // padding counts 0
        } else if (q < last) {
          long long lo = s;
          long long end = n_valid;
          if (shift > 0) {  // the stretch of the last staged row <= q
            const long long t2 = count_below<true, K>(s_hi, t, ns, q);
            if (t2 > 0 && ((t2 - 1) << shift) + 1 > lo) {
              lo = ((t2 - 1) << shift) + 1;
            }
            if (t2 < ns) end = t2 << shift;
          }
          e = gallop_upper<K>(plane, lo, end, q);
        }
      }
      c[k] = i < m ? e - s : 0;
      start[i] = static_cast<int>(s);
      counts[i] = static_cast<int>(c[k]);
    }
    agg += c[k];
  }
  long long total;
  long long run = block_exclusive_sum(agg, &total);
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + t0 + k;
    run += c[k];
    if (i < mq) cum[i] = run;
  }
  if (tile_sum != nullptr && tid == 0) tile_sum[blockIdx.x] = total;
}

// (2) one block: tile_sum becomes, in place, each tile's carry — the
// exclusive prefix sum of the tile totals.
__global__ void probe_carry(long long* __restrict__ tile_sum, int n_tiles) {
  long long running = 0;
  for (int b0 = 0; b0 < n_tiles; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const long long x = b < n_tiles ? tile_sum[b] : 0;
    long long total;
    const long long exc = block_exclusive_sum(x, &total);
    if (b < n_tiles) tile_sum[b] = running + exc;
    running += total;
  }
}

// (3) add each tile's carry to its rows (tile 0 has none).
__global__ void probe_fixup(long long* __restrict__ cum, long long mq,
                            const long long* __restrict__ carry) {
  const long long i = kTile + static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < mq) cum[i] += carry[i / kTile];
}

// The launches of one probe over keys of type K (see arroyo_join_probe).
template <typename K>
int launch_probe(const void* q_hi, long long mq, const void* hi,
                 long long cap, long long m, long long n_valid, void* start,
                 void* counts, void* cum, void* tile_sum, void* stream) {
  if (mq < 0 || cap <= 0 || cap > INT_MAX || m < 0 || m > mq ||
      n_valid < 0 || n_valid > cap) {
    return cudaErrorInvalidValue;
  }
  if (mq == 0) return cudaSuccess;
  const long long n_tiles = (mq + kTile - 1) / kTile;
  if (n_tiles > INT_MAX) return cudaErrorInvalidValue;
  if (n_tiles > 1 && tile_sum == nullptr) return cudaErrorInvalidValue;
  // stage every 2^shift-th live row: at most 32 KB of rows, 16 a query
  const long long stage = kStageBytes / static_cast<long long>(sizeof(K));
  const long long budget = m * 16 < kThreads ? kThreads
                           : (m * 16 > stage ? stage : m * 16);
  int shift = 0;
  while (((n_valid - 1) >> shift) + 1 > budget) ++shift;
  const int ns = n_valid > 0 ? static_cast<int>(((n_valid - 1) >> shift) + 1)
                             : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* sums = n_tiles > 1 ? static_cast<long long*>(tile_sum) : nullptr;
  long long* out = static_cast<long long*>(cum);
  probe_tile<K><<<static_cast<unsigned>(n_tiles), kThreads,
                  static_cast<size_t>(ns) * sizeof(K), s>>>(
      static_cast<const K*>(q_hi), mq, static_cast<const K*>(hi), m, n_valid,
      shift, ns, static_cast<int*>(start), static_cast<int*>(counts), out,
      sums);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || n_tiles == 1) return static_cast<int>(rc);
  probe_carry<<<1, kThreads, 0, s>>>(sums, static_cast<int>(n_tiles));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long rest = mq - kTile;
  probe_fixup<<<static_cast<unsigned>((rest + kThreads - 1) / kThreads),
                kThreads, 0, s>>>(out, mq, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_hi i32[mq], hi i32[cap] on the device; 0 <= m <= mq, 0 <= n_valid <=
// cap <= INT_MAX.  Writes start i32[mq], counts i32[mq], cum i64[mq];
// scratch tile_sum i64[ceil(mq / 1024)], read only when mq > 1024 (it
// may be null otherwise).  One launch on `stream` when mq <= 1024, three
// otherwise; returns cudaGetLastError() after the last (or the first
// failing) one.
extern "C" int arroyo_join_probe(const void* q_hi, long long mq,
                                 const void* hi, long long cap, long long m,
                                 long long n_valid, void* start, void* counts,
                                 void* cum, void* tile_sum, void* stream) {
  return launch_probe<int>(q_hi, mq, hi, cap, m, n_valid, start, counts, cum,
                           tile_sum, stream);
}

// The same over u64 keys (q_hi, hi: the bits of i64 tensors, ordered as
// unsigned; the padding SENTINEL, all ones).
extern "C" int arroyo_join_probe_u64(const void* q_hi, long long mq,
                                     const void* hi, long long cap,
                                     long long m, long long n_valid,
                                     void* start, void* counts, void* cum,
                                     void* tile_sum, void* stream) {
  return launch_probe<unsigned long long>(q_hi, mq, hi, cap, m, n_valid,
                                          start, counts, cum, tile_sum,
                                          stream);
}
