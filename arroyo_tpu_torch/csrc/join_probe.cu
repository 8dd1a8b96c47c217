// join_probe: the match ranges of sorted queries in a sorted key plane —
// per query its lower bound, its match count and the inclusive prefix sum
// of the counts — in two forms: i32 keys (a hot join partition's ring
// `hi` plane: candidate ranges of the top 32 hash bits) and u64 keys (the
// legacy join layout's full key hashes, the bits of an i64 tensor ordered
// as unsigned).
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
// The i32 form (kept as it was for join-stress's hot rings).  What
// bounds it on the H100: at join-stress's shapes (a few hundred queries
// against rings of a few thousand rows) the launch; the bytes are
// kilobytes, and what the searches cost is latency (a binary search over
// global memory is log2(n_valid) dependent loads).  So:
// - The block stages the ring's search tree in shared memory: the whole
//   live `hi` plane (coalesced 16-byte loads) while it fits 32 KB (8,192
//   rows) and 16 rows a real query, else every 2^shift-th row within that
//   budget (at least 256 rows), so the top levels of a search hit shared
//   memory and only the last `shift` levels go to global memory.
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
//
// The u64 form (the legacy layout's pairing: a fire's sorted left keys
// against its sorted right keys, up to 2^20 of each) is a merge-path
// probe of its own, `probe_u64`.  Both inputs are sorted, so a tile of
// consecutive queries matches a window of consecutive plane rows.  What
// bounds it: bytes — 8 read a query, about 8 read a plane row, 16
// written a query (10 us at 2^20) — once the searches stop being
// dependent global loads a query.  So:
// - A block owns a tile of consecutive queries: 2,048 (256 threads,
//   eight each: four blocks an SM, so 2^20 queries run in one wave) past
//   512 tiles of 1,024 (four each), or 64 (a thread each) when the plane
//   holds over four rows a query, so that a sparse probe's windows fit
//   and more blocks share it.  Its first warp finds a =
//   lower_bound(first query) and b = upper_bound(last real query) over
//   the plane, a half-warp each, 16 probes a round (5 rounds at 2^20):
//   two searches a tile, not two a query; a plane within the staging
//   budget is the window whole.  Every real query of the tile has both
//   bounds in [a, b].
// - The block stages its queries and the window hi[a, b) in shared
//   memory, the window with 16-byte cp.async copies (8-byte ones at an
//   odd end), and merges them: a thread takes its consecutive queries,
//   finds the first one's lower bound by galloping from where an even
//   spread of the window would put it and each next one's by stepping
//   from the last upper bound (a row or two in a dense probe; a gallop
//   past four rows), and each upper bound by stepping from its lower; an
//   equal query repeats the last answer.  Global memory is read and
//   written 32 neighbours a warp; the answers go through shared memory.
//   A window over the staging budget (a hot key that covers much of the
//   plane, or a plane far larger than the queries) stages every
//   2^shift-th row of [a, b) instead and finishes each search in global
//   memory inside the 2^shift rows the samples leave, still restricted
//   to [a, b): exact (the tile's first and last real keys need none: a
//   and b are their bounds; a tile of one key stages nothing, when a and
//   b were searched — a whole-plane window bounds no key).  The
//   budget follows the expected window (twice tile x n_valid / m rows
//   plus 64, 256 to 4,096), so a dense probe keeps its shared memory
//   small.
// - A query above hi[n_valid - 1] (every SENTINEL padding query) needs no
//   search; a padding query at or below it (only when the plane holds
//   SENTINEL keys) searches the whole plane in global memory.
// - The counts' prefix sum `cum` is scanned in the same launch: each tile
//   takes a ticket (an atomic counter, so the tiles it looks back on have
//   started), publishes its total before its own scan, and one warp
//   looks back over the earlier tiles' status words, 64 a round trip (two
//   a lane, coalesced: deeper rounds wait on more unpublished words and
//   load the status lines more), newest first, to the nearest inclusive
//   prefix (a decoupled look-back; a status word is the state in bits
//   63..62 and the i64 value below, one store).  A single tile is one
//   launch; more are a memset of the ticket and status words and one
//   launch.  Every tile runs at once up to 2^20 queries, so the last
//   ones wait for the slowest: tools/join_probe_variants shows it.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
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


// ---- the u64 form: a merge-path probe with its scan in the same launch ----

using u64 = unsigned long long;

constexpr int kStageMin = 256;      // u64 rows staged a block, at least
constexpr int kStageMax = 4096;     // and at most (32 KB)
constexpr u64 kStateAgg = 1ull << 62;   // status: the tile's total
constexpr u64 kStateInc = 2ull << 62;   // status: its inclusive prefix
constexpr u64 kValueMask = (1ull << 62) - 1;
constexpr unsigned kFull = 0xffffffffu;

// A tile's window over the sorted plane a[0, n): lanes 0-15 find the
// first row >= qa (its lower bound) and lanes 16-31 the first row > qb
// (its upper bound), each half probing 16 evenly spaced rows of its
// stretch a round and keeping the stretch between the last probe below
// and the first not below (5 rounds at 2^20 rows: 32 loads a round for
// both bounds — the searches of a thousand tiles at once are bound by
// the loads, not by the rounds).  A half whose bound is known already
// (da, db false) answers n.  All 32 lanes of one warp call it; lane 0
// returns the lower bound, lane 16 the upper.
__device__ long long window_bounds(const u64* __restrict__ a, long long n,
                                   u64 qa, bool da, u64 qb, bool db) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int hl = lane & 15;
  const u64 q = half ? qb : qa;
  long long lo = (half ? db : da) ? 0 : n;  // the answer lies in [lo, hi]
  long long hi = n;
  while (__any_sync(kFull, hi - lo > 16)) {
    const long long step = (hi - lo + 15) / 16;
    const long long p = lo + (hl + 1) * step - 1;
    const bool below =
        hi - lo > 16 && p < hi && (half ? a[p] <= q : a[p] < q);
    const int c = __popc((__ballot_sync(kFull, below) >> (16 * half)) &
                         0xffffu);
    if (hi - lo > 16) {
      const long long top = lo + (c + 1) * step - 1;
      lo += c * step;
      if (top < hi) hi = top;
    }
  }
  const bool below = hl < hi - lo && (half ? a[lo + hl] <= q : a[lo + hl] < q);
  return lo + __popc((__ballot_sync(kFull, below) >> (16 * half)) & 0xffffu);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ u64 load_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The sum of the totals of tiles 0 .. tile - 1 (tile > 0).  All 32 lanes
// of one warp call it.  A round reads the 32 x kLookDepth status words
// below `top` at once, newest first and coalesced: load j of lane l reads
// tile top - l - 32 j.  It adds the values up to the newest inclusive
// prefix, or all of them and goes on, and reads the round again (after a
// short sleep) while a word on the way is unpublished.
constexpr int kLookDepth = 2;

__device__ long long look_back(const u64* status, int tile) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (int top = tile - 1;; top -= 32 * kLookDepth) {
    long long v;
    bool found;
    for (unsigned backoff = 16;; backoff = min(backoff * 2, 256u)) {
      u64 w[kLookDepth];
#pragma unroll
      for (int j = 0; j < kLookDepth; ++j) {
        const int idx = top - lane - 32 * j;
        w[j] = idx >= 0 ? load_status(status + idx) : kStateInc;
      }
      // the words up to the newest inclusive prefix, in (j, lane) order:
      // this lane's sum of them, and whether one is unpublished
      v = 0;
      found = false;
      bool bad = false;
#pragma unroll
      for (int j = 0; j < kLookDepth; ++j) {
        const unsigned inc = __ballot_sync(kFull, (w[j] >> 62) == 2);
        const unsigned take =
            found ? 0u : (inc ? ((inc & (0u - inc)) << 1) - 1u : kFull);
        if ((take >> lane) & 1u) {
          bad |= (w[j] >> 62) == 0;
          v += static_cast<long long>(w[j] & kValueMask);
        }
        found |= inc != 0;
      }
      if (!__any_sync(kFull, bad)) break;
      __nanosleep(backoff);
    }
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    excl += v;
    if (found) return excl;
  }
}

// Searches of the staged window w[0, n), int-indexed.  gallop32: the
// first index in [lo, n] whose row is >= q (Strict: > q), given that
// none before lo is: steps of 1, 2, 4, ... rows, then a binary search.
template <bool Strict>
__device__ __forceinline__ int gallop32(const u64* w, int lo, int n, u64 q) {
  int hi = n;  // the answer lies in [lo, hi]
  for (int step = 1; lo < hi; step <<= 1) {
    const int p = lo + step - 1;
    if (p >= hi) break;
    if (Strict ? w[p] > q : w[p] >= q) {
      hi = p;
      break;
    }
    lo = p + 1;
  }
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (Strict ? w[mid] <= q : w[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Moves r past the rows < q (Strict: <= q), keeping v = w[r] (0 at r =
// n): a row at a time for up to four rows — a merge's next bound is
// usually a row or two on, and v already holds the first — then a gallop.
template <bool Strict>
__device__ __forceinline__ void step_past(const u64* w, int n, u64 q, int& r,
                                          u64& v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r >= n || (Strict ? v > q : v >= q)) return;
    ++r;
    v = r < n ? w[r] : 0;
  }
  if (r < n && (Strict ? v <= q : v < q)) {
    r = gallop32<Strict>(w, r + 1, n, q);
    v = r < n ? w[r] : 0;
  }
}

// The first index in [0, n] whose row is >= q, galloping from the guess
// g (0 <= g <= n) in whichever direction the row before it says.
__device__ __forceinline__ int lower_from(const u64* w, int n, int g,
                                          u64 q) {
  if (g == 0 || w[g - 1] < q) return gallop32<false>(w, g, n, q);
  int hi = g - 1;  // w[hi] >= q: the answer lies in [lo, hi]
  int lo = 0;
  for (int step = 1;; step <<= 1) {
    const int p = hi - step;
    if (p < 0) break;
    if (w[p] < q) {
      lo = p + 1;
      break;
    }
    hi = p;
  }
  return gallop32<false>(w, lo, hi, q);
}

// Built with -DARROYO_PROBE_STAMPS (tools/join_probe_variants), each
// block's first thread writes a globaltimer stamp at each of the seven
// marks of probe_u64 (start, ticket, window found, window staged, queries
// merged, carry looked back, end); otherwise the marks are empty.
#ifdef ARROYO_PROBE_STAMPS
constexpr int kMaxStampedBlocks = 1 << 16;
__device__ u64 g_probe_stamps[kMaxStampedBlocks * 8];
#define PROBE_STAMP(j)                                                  \
  do {                                                                  \
    if (threadIdx.x == 0 && blockIdx.x < kMaxStampedBlocks) {           \
      u64 t_;                                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));            \
      g_probe_stamps[blockIdx.x * 8 + (j)] = t_;                        \
    }                                                                   \
  } while (0)
#else
#define PROBE_STAMP(j) \
  do {                 \
  } while (0)
#endif

// Query j of a tile sits at shared slot j + j / 8: a thread's eight
// consecutive queries are then 72 bytes apart from the next thread's, not
// 64, so a warp's 8-byte accesses to them spread over the banks.
__device__ __forceinline__ int slot(int j) { return j + (j >> 3); }

// One tile of kT x kI consecutive queries (see the top).  Global memory
// is read and written striped (item k of thread t is query k kT + t of
// the tile: a warp's accesses 32 neighbours) and shared memory turns it
// into blocks (thread t answers queries t kI .. t kI + kI - 1, so it
// merges them into the window).  `ws` is null for a single tile; else
// ws[0] is the ticket counter and ws[1 + t] tile t's status word, all
// zero at the launch.  Dynamic shared memory: the tile's queries (then
// their answers) in slot(kT kI) words, then `stage` + 2 window rows
// (then the tile's `cum`; at least slot(kT kI) rows).
template <int kT, int kI>
__global__ void __launch_bounds__(kT, 1024 / kT) probe_u64(
    const u64* __restrict__ q, long long mq, const u64* __restrict__ hi,
    long long m, long long n_valid, int stage, int* __restrict__ start,
    int* __restrict__ counts, long long* __restrict__ cum,
    u64* __restrict__ ws) {
  constexpr int kTileQ = kT * kI;
  extern __shared__ __align__(16) unsigned char s_raw[];
  u64* s_q = reinterpret_cast<u64*>(s_raw);
  int2* s_res = reinterpret_cast<int2*>(s_raw);  // over s_q, afterwards
  u64* s_win = s_q + slot(kTileQ);
  long long* s_cum = reinterpret_cast<long long*>(s_win);  // afterwards
  __shared__ long long s_a, s_b, s_excl;
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  PROBE_STAMP(0);
  if (tid == 0) {
    s_tile = ws != nullptr ? static_cast<int>(atomicAdd(ws, 1ull))
                           : static_cast<int>(blockIdx.x);
  }
  __syncthreads();
  const int tile = s_tile;
  PROBE_STAMP(1);
  const long long q0 = static_cast<long long>(tile) * kTileQ;
  const int nq = static_cast<int>(min(static_cast<long long>(kTileQ),
                                      mq - q0));
  const int nr = static_cast<int>(min(static_cast<long long>(nq),
                                      m > q0 ? m - q0 : 0));  // real ones
  for (int j = tid; j < nq; j += kT) s_q[slot(j)] = q[q0 + j];
  const u64 last = n_valid > 0 ? hi[n_valid - 1] : 0;
  // the window [a, b): every real query's bounds lie in it (the whole
  // plane when it fits the budget)
  if (warp == 0) {
    long long x = n_valid;
    if (nr > 0 && n_valid <= stage) {
      x = lane < 16 ? 0 : n_valid;
    } else if (nr > 0) {
      const u64 kf = q[q0];
      const u64 kl = q[q0 + nr - 1];
      x = window_bounds(hi, n_valid, kf, n_valid > 0 && kf <= last, kl,
                        n_valid > 0 && kl < last);
    }
    if (lane == 0) s_a = x;
    if (lane == 16) s_b = x;
  }
  __syncthreads();
  const long long a = s_a;
  PROBE_STAMP(2);
  const long long n_win = nr > 0 ? s_b - a : 0;
  // a tile of one key (a hot key's) has [a, b) as every real query's
  // match range when the window was searched (not the whole plane):
  // nothing to stage or search
  const bool one_key =
      nr > 0 && n_valid > stage && s_q[0] == s_q[slot(nr - 1)];
  int shift = 0;
  while (((n_win - 1) >> shift) + 1 > stage) ++shift;
  const int ns = n_win > 0 ? static_cast<int>(((n_win - 1) >> shift) + 1) : 0;
  int off = 0;  // the window's first row sits at s_win[off]
  if (one_key) {
    // nothing
  } else if (shift == 0) {
    // hi[a0, a + n_win), a0 = a rounded down to an even row: 16-byte
    // copies for whole pairs, an 8-byte one for an odd last row
    const long long a0 = a & ~1LL;
    off = static_cast<int>(a - a0);
    const int rows = off + static_cast<int>(n_win);
    if ((reinterpret_cast<uintptr_t>(hi) & 15) == 0) {
      for (int t = tid; t < (rows >> 1); t += kT) {
        cp_async16(s_win + 2 * t, hi + a0 + 2 * t);
      }
      if ((rows & 1) && tid == 0) {
        cp_async8(s_win + rows - 1, hi + a0 + rows - 1);
      }
    } else {
      for (int t = off + tid; t < rows; t += kT) {
        cp_async8(s_win + t, hi + a0 + t);
      }
    }
  } else {
    for (int t = tid; t < ns; t += kT) {
      cp_async8(s_win + t, hi + a + (static_cast<long long>(t) << shift));
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  __syncthreads();
  // this thread's kI consecutive queries, merged into the window: the
  // first real one by binary search, the next ones by galloping from the
  // last upper bound; an equal query repeats the last answer
  PROBE_STAMP(3);
  const u64* w = s_win + off;
  int rs[kI], rc[kI];
  bool have = false;
  u64 px = 0, pv = 0;  // pv: the window row at the last upper bound
  long long ps = 0, pe = 0;
  long long mine = 0;
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    const int j = tid * kI + k;
    rs[k] = rc[k] = 0;
    if (j >= nq) continue;
    const u64 x = s_q[slot(j)];
    long long s = n_valid;
    long long e = n_valid;
    if (n_valid > 0 && x <= last) {
      if (j >= nr) {  // padding at or below the last row
        s = count_below<false, u64>(hi, 0, n_valid, x);
        e = s;
      } else if (one_key) {
        s = a;
        e = a + n_win;
      } else if (have && x == px) {
        s = ps;
        e = pe;
      } else if (shift == 0) {
        // the first query from where the tile's rows would put it if
        // they were spread evenly, the next ones on from the last upper
        // bound: each row the thread passes is read once
        const int nw = static_cast<int>(n_win);
        int r;
        u64 v;
        if (have) {
          r = static_cast<int>(pe - a);
          v = pv;
          step_past<false>(w, nw, x, r, v);
        } else {
          r = lower_from(w, nw, static_cast<int>(n_win * j / nr), x);
          v = r < nw ? w[r] : 0;
        }
        s = a + r;
        step_past<true>(w, nw, x, r, v);
        e = a + r;
        pv = v;
      } else {
        // the samples bound each answer to a stretch of 2^shift rows;
        // the tile's first and last real keys have theirs already (a
        // hot key's tile: no search at all)
        const long long b = a + n_win;
        long long t = 0;
        if (x == s_q[0]) {
          s = a;
        } else {
          t = count_below<false, u64>(w, 0, ns, x);
          const long long lo = t > 0 ? a + ((t - 1) << shift) + 1 : a;
          const long long up = t < ns ? a + (t << shift) : b;
          s = count_below<false, u64>(hi, lo, up, x);
        }
        if (x == s_q[slot(nr - 1)]) {
          e = b;
        } else {
          const long long t2 = count_below<true, u64>(w, t, ns, x);
          long long lo2 = t2 > 0 ? a + ((t2 - 1) << shift) + 1 : a;
          if (lo2 < s) lo2 = s;
          const long long up2 = t2 < ns ? a + (t2 << shift) : b;
          e = count_below<true, u64>(hi, lo2, up2, x);
        }
      }
      if (j < nr) {
        have = true;
        px = x;
        ps = s;
        pe = e;
      }
    }
    rs[k] = static_cast<int>(s);
    rc[k] = j < nr ? static_cast<int>(e - s) : 0;
    mine += rc[k];
  }
  PROBE_STAMP(4);
  __syncthreads();  // the queries and the window are read
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    s_res[slot(tid * kI + k)] = make_int2(rs[k], rc[k]);
  }
  long long total;
  long long run = block_exclusive_sum(mine, &total);  // its barriers
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    run += rc[k];
    s_cum[slot(tid * kI + k)] = run;
  }
  for (int j = tid; j < nq; j += kT) {
    const int2 r = s_res[slot(j)];
    start[q0 + j] = r.x;
    counts[q0 + j] = r.y;
  }
  // the tile's total for the later tiles, then its carry
  if (warp == 0) {
    long long excl = 0;
    if (ws != nullptr) {
      u64* status = ws + 1;
      if (lane == 0) {
        store_status(status + tile,
                     (tile == 0 ? kStateInc : kStateAgg) |
                         static_cast<u64>(total));
      }
      if (tile > 0) {
        excl = look_back(status, tile);
        if (lane == 0) {
          store_status(status + tile,
                       kStateInc | static_cast<u64>(excl + total));
        }
      }
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const long long excl = s_excl;
  PROBE_STAMP(5);
  for (int j = tid; j < nq; j += kT) cum[q0 + j] = excl + s_cum[slot(j)];
  PROBE_STAMP(6);
}

// The tile a block owns: 64 queries (64 threads, one each) when the
// plane holds over four rows a query, so that a sparse probe's windows
// fit the staging budget and more blocks share the work; else 1,024 (256
// threads, four each) up to 512 tiles, and 2,048 (256 threads, eight
// each) above: at most 64 registers a thread and 51 KB of shared memory,
// so four blocks an SM and a 2^20 probe's 512 tiles at once, half as
// many tiles to look back over and to find windows for as with 1,024.
// tools/join_probe_variants times the two in turns at chip_smoke.py's
// buckets (PERF.md): 1,024 is faster up to 524,288 queries (512 tiles),
// 2,048 at 2^20.
constexpr int kBigItems = 8;
constexpr long long kBigTile = static_cast<long long>(kThreads) * kBigItems;
constexpr long long kWideTiles = 512;
constexpr int kSparseRatio = 4;
constexpr int kMaxProbeDevices = 64;

long long tile_of(long long mq, long long n_valid) {
  if (n_valid > kSparseRatio * mq) return 64;
#ifdef ARROYO_PROBE_TILE  // one dense tile (tools/join_probe_variants)
  return ARROYO_PROBE_TILE;
#endif
  return mq <= kWideTiles * kTile ? kTile : kBigTile;
}

// rows of the staging budget: twice the window a tile expects, plus 64,
// within [kStageMin, kStageMax], even
int stage_rows(long long tile, long long m, long long n_valid) {
  const long long expect = m > 0 ? (tile * n_valid + m - 1) / m : 0;
  long long rows = 2 * expect + 64;
  if (rows < kStageMin) rows = kStageMin;
  if (rows > kStageMax) rows = kStageMax;
  return static_cast<int>(rows & ~1LL);
}

// shared memory of a block: the tile's queries (slots), then the window
// (at least as many rows: `cum` takes its place)
size_t probe_smem(long long tile, int stage) {
  const long long slots = tile + tile / 8;
  const long long rows = std::max<long long>(stage + 2, slots);
  return static_cast<size_t>(slots + rows) * sizeof(u64);
}

std::atomic<int> g_probe_ready[kMaxProbeDevices];

// Lets the 2,048-query tile use more than 48 KB of shared memory, once a
// device.
cudaError_t prepare_probe() {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxProbeDevices) return cudaErrorInvalidDevice;
  if (g_probe_ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  rc = cudaFuncSetAttribute(probe_u64<kThreads, kBigItems>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(probe_smem(kBigTile, kStageMax)));
  if (rc != cudaSuccess) return rc;
  g_probe_ready[dev].store(1, std::memory_order_release);
  return cudaSuccess;
}

int launch_probe_u64(const void* q_hi, long long mq, const void* hi,
                     long long cap, long long m, long long n_valid,
                     void* start, void* counts, void* cum, void* ws,
                     void* stream) {
  if (mq < 0 || cap <= 0 || cap > INT_MAX || m < 0 || m > mq ||
      n_valid < 0 || n_valid > cap) {
    return cudaErrorInvalidValue;
  }
  if (mq == 0) return cudaSuccess;
  const long long tile = tile_of(mq, n_valid);
  const long long n_tiles = (mq + tile - 1) / tile;
  if (n_tiles > INT_MAX - 1) return cudaErrorInvalidValue;
  if (n_tiles > 1 && ws == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* words = n_tiles > 1 ? static_cast<u64*>(ws) : nullptr;
  if (words != nullptr) {
    const cudaError_t rc =
        cudaMemsetAsync(words, 0, (1 + n_tiles) * sizeof(u64), s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int stage = stage_rows(tile, m, n_valid);
  const size_t smem = probe_smem(tile, stage);
  const auto* qk = static_cast<const u64*>(q_hi);
  const auto* hk = static_cast<const u64*>(hi);
  auto* st = static_cast<int*>(start);
  auto* ct = static_cast<int*>(counts);
  auto* cm = static_cast<long long*>(cum);
  const unsigned grid = static_cast<unsigned>(n_tiles);
  if (tile == kTile) {
    probe_u64<kThreads, kItems><<<grid, kThreads, smem, s>>>(
        qk, mq, hk, m, n_valid, stage, st, ct, cm, words);
  } else if (tile == kBigTile) {
    const cudaError_t rc = prepare_probe();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    probe_u64<kThreads, kBigItems><<<grid, kThreads, smem, s>>>(
        qk, mq, hk, m, n_valid, stage, st, ct, cm, words);
  } else {
    probe_u64<64, 1><<<grid, 64, smem, s>>>(qk, mq, hk, m, n_valid, stage,
                                            st, ct, cm, words);
  }
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
// unsigned; the padding SENTINEL, all ones), by the merge-path probe:
// scratch ws i64[1 + ceil(mq / tile)] (the ticket and the tiles' status
// words; tile 64 when n_valid > 4 mq, else 1,024 up to 524,288 queries and
// 2,048 above), read only when
// there are several tiles (it may be null otherwise).  One launch on
// `stream` for one tile, else a memset of ws and one launch; returns
// cudaGetLastError() after the launch (or the memset's error).
#ifdef ARROYO_PROBE_STAMPS
// Copies the stamps (u64[65,536 x 8]: block b's at b x 8) to host `out`.
extern "C" int arroyo_probe_stamps(void* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_probe_stamps, sizeof(g_probe_stamps)));
}
#endif

extern "C" int arroyo_join_probe_u64(const void* q_hi, long long mq,
                                     const void* hi, long long cap,
                                     long long m, long long n_valid,
                                     void* start, void* counts, void* cum,
                                     void* ws, void* stream) {
  return launch_probe_u64(q_hi, mq, hi, cap, m, n_valid, start, counts, cum,
                          ws, stream);
}
