// mesh_merge: merge one key shard's sorted key table with the keys routed
// to it, and lay the routed cells out for the scatter.
//
// Replaces the merge half of arroyo_tpu/parallel/mesh_window.py:119
// `_update_step` (:194-250: one sort of old ++ incoming keys, the rank of
// each distinct key, the `count_less` searches of the old keys and of the
// routed rows) without the concatenated sorts: the old table is sorted
// already and the incoming keys arrive sorted (join_sort), so a merge is
// a scan and two binary searches.
//
// Semantics.  Keys are u64 bits in i64 words, ordered UNSIGNED; EMPTY
// (all ones) pads.  Inputs: old[C] (sorted, real keys first, EMPTY after),
// in_keys[R] (the routed keys sorted, EMPTY last), in_order[R] (their
// rows: in_keys[j] is the key of routed row in_order[j]) and the routed
// rows inc[F][R] (F = 4 + n_ch: key, validity, bin, row count, channel
// values; mesh_route's layout after the exchange).  A distinct real
// incoming key absent from old is NEW.  The merged table holds old's keys
// and the new keys in order, cut at C:
//   new_keys[C]  the merged table, EMPTY-padded;
//   src[C]       for each merged slot, the old slot its key had (-1: a
//                new key or padding) — the re-layout's inverse map;
//   cells        bin_update's buffer [2 + n_ch][R]: row 0 the i32 slots
//                of the routed rows in key order (-1: padding or a key
//                cut at C), then their i32 bins; row 1 their row counts
//                (f64); rows 2.. their channel values;
//   *drops       += keys cut at C (old or new), the JAX step's key_drop.
//
// What bounds it on the H100: memory — C and R keys read, a
// log2(C)-step search per routed row and a log2(R)-step search per old
// key (their sectors counted in the bound), 2C + (2 + n_ch) R words
// written; the routed rows' gather through in_order is scattered.
//
// What the design does about it: ONE launch after two memsets (the
// merged table and src start EMPTY / -1, so only real slots are
// written).  Blocks draw tiles from a ticket counter: the first
// ceil(R / 2,048) tiles scan the routed keys (a thread's 8 consecutive
// keys, a block scan, a look-back across tiles for the new keys' running
// count, which each key's slot needs), write each position's inclusive
// count to the workspace and then count themselves done; the later
// tiles place old keys, after every scan tile is done, at their slot
// plus the new keys below them (a search of the routed keys and a read of
// that count).

#include <cuda_runtime.h>

#include "mesh_lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr unsigned long long kEmpty = ~0ull;

// first index in sorted a[0, n) whose value is not below k (unsigned)
__device__ __forceinline__ long long lower_bound(
    const unsigned long long* __restrict__ a, long long n,
    unsigned long long k) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    mesh_merge_kernel(const unsigned long long* __restrict__ old, long long C,
                      const unsigned long long* __restrict__ in_keys,
                      const long long* __restrict__ in_order,
                      const long long* __restrict__ inc, long long R,
                      int n_ch, long long* __restrict__ new_keys,
                      long long* __restrict__ src, long long* __restrict__ cells,
                      unsigned long long* __restrict__ drops,
                      unsigned long long* __restrict__ ticket,
                      unsigned long long* __restrict__ done,
                      unsigned long long* __restrict__ status,
                      int* __restrict__ incl, int n_in_tiles) {
  __shared__ int s_tile;
  __shared__ int s_warp[kWarps];
  __shared__ long long s_excl;
  const int tile = mesh::draw_tile(ticket, &s_tile);
  unsigned long long dropped = 0;
  if (tile < n_in_tiles) {
    const long long base =
        static_cast<long long>(tile) * kTile + threadIdx.x * kItems;
    long long lb[kItems];
    unsigned present = 0, fresh = 0, real = 0;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long p = base + j;
      lb[j] = 0;
      if (p >= R) continue;
      const unsigned long long k = in_keys[p];
      if (k == kEmpty) continue;
      real |= 1u << j;
      const long long b = lower_bound(old, C, k);
      lb[j] = b;
      const bool have = b < C && old[b] == k;
      if (have) present |= 1u << j;
      if (!have && (p == 0 || in_keys[p - 1] != k)) {
        fresh |= 1u << j;
        ++cnt;
      }
    }
    // block-exclusive scan of the threads' new-key counts
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int x = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_warp[w];
        s_warp[w] = run;
        run += c;
      }
      s_excl = static_cast<long long>(mesh::look_back(
          status, tile, 1, 0, static_cast<unsigned long long>(run)));
    }
    __syncthreads();
    long long run = s_excl + s_warp[warp] + (x - cnt);
    int* slots = reinterpret_cast<int*>(cells);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long p = base + j;
      if (p >= R) break;
      if (fresh & (1u << j)) ++run;
      incl[p] = static_cast<int>(run);
      long long slot = -1;
      if (real & (1u << j)) {
        const long long s = lb[j] + run - ((present & (1u << j)) ? 0 : 1);
        if (s < C) {
          slot = s;
          if (fresh & (1u << j)) new_keys[s] = static_cast<long long>(
              in_keys[p]);
        } else if (fresh & (1u << j)) {
          ++dropped;
        }
      }
      const long long row = in_order[p];
      slots[p] = static_cast<int>(slot);
      slots[R + p] = static_cast<int>(inc[2 * R + row]);
      for (int c = 0; c <= n_ch; ++c) {
        cells[(1 + c) * R + p] = inc[(3 + c) * R + row];
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(done, 1ull);
  } else {
    if (threadIdx.x == 0) {
      while (mesh::load_acquire(done) <
             static_cast<unsigned long long>(n_in_tiles)) {
      }
      __threadfence();
    }
    __syncthreads();
    const long long base = static_cast<long long>(tile - n_in_tiles) * kTile;
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const long long i = base + j;
      if (i >= C) break;
      const unsigned long long k = old[i];
      if (k == kEmpty) continue;
      const long long b = lower_bound(in_keys, R, k);
      const long long below = b > 0 ? __ldcg(incl + b - 1) : 0;
      const long long s = i + below;
      if (s < C) {
        new_keys[s] = static_cast<long long>(k);
        src[s] = i;
      } else {
        ++dropped;
      }
    }
  }
  if (dropped) atomicAdd(drops, dropped);
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Words of the call's workspace: a drop counter, the ticket, the done
// count, one status word a scan tile, then R i32 inclusive counts.
extern "C" long long arroyo_mesh_merge_ws_words(long long R) {
  return 3 + tiles_of(R) + (R + 1) / 2;
}

// old u64[C], in_keys u64[R], in_order i64[R], inc i64[4 + n_ch][R];
// out = new_keys i64[C] then src i64[C]; cells i64[2 + n_ch][R]; drops a
// u64 counter (ws[0], or the caller's); ws of arroyo_mesh_merge_ws_words(R)
// words.  Two memsets (out to all ones, ws's counters to 0), then one
// launch on `stream`; returns cudaGetLastError().
extern "C" int arroyo_mesh_merge(const void* old, long long C,
                                 const void* in_keys, const void* in_order,
                                 const void* inc, long long R, int n_ch,
                                 void* out, void* cells, void* drops,
                                 void* ws, void* stream) {
  if (C < 1 || C >= (1ll << 31) || R < 0 || R >= (1ll << 31) || n_ch < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(out, 0xFF, 2 * C * sizeof(long long), st);
  if (rc == cudaSuccess) {
    rc = cudaMemsetAsync(ws, 0, (3 + tiles_of(R)) * sizeof(long long), st);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long n_in = tiles_of(R);
  const long long blocks = n_in + tiles_of(C);
  unsigned long long* w = static_cast<unsigned long long*>(ws);
  long long* o = static_cast<long long*>(out);
  mesh_merge_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const unsigned long long*>(old), C,
      static_cast<const unsigned long long*>(in_keys),
      static_cast<const long long*>(in_order),
      static_cast<const long long*>(inc), R, n_ch, o, o + C,
      static_cast<long long*>(cells),
      static_cast<unsigned long long*>(drops), w + 1, w + 2, w + 3,
      reinterpret_cast<int*>(w + 3 + n_in), static_cast<int>(n_in));
  return static_cast<int>(cudaGetLastError());
}
