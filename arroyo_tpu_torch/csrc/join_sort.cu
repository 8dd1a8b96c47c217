// join_sort: the stable ascending order of u64 keys and the keys in that
// order — equal keys keep their input order.
//
// Replaces arroyo_tpu/ops/join.py:66 `_sort_kernel` (`jnp.argsort(keys,
// stable=True)` and `keys[order]` over the legacy join layout's
// SENTINEL-padded key bucket, twice a `join_pairs`).
//
// Keys arrive as the raw bits of an i64 tensor and are ordered as
// UNSIGNED 64-bit integers (SENTINEL, all ones, sorts last).  The order
// is i64, as the JAX kernel returns it under x64.
//
// What bounds it on the H100: memory.  The least traffic is 24 bytes a
// key (read 8, write 8 for the sorted keys and 8 for the order): 7.5 us
// at 1,048,576 keys, 0.23 us at 32,768.
//
// The design: a least-significant-digit radix sort over 8-bit digits
// that carries each key's input index.
// - Digits that are the same in every key are skipped: one launch ORs
//   every key's difference from the first key into one word, and each
//   pass's kernels read that word and return at once when their digit
//   does not vary.  Which of the two ping-pong buffers a pass reads and
//   writes follows from the same word (the highest varying digit writes
//   the output), so the host never reads it: no host sync.  When no digit
//   varies, the top digit's pass runs and copies the keys in order.
// - A pass is three launches: per-tile digit histograms (a tile is 2,048
//   keys, 256 contiguous keys for each of its 8 warps), the exclusive
//   scan of each digit's row of tile counts (one block a digit, rows
//   contiguous, so the loads coalesce), and the scatter, whose blocks
//   each scan the 256 digit totals for the digits' bases.
// - The scatter is stable by construction, never by the order of atomics:
//   a warp walks its 256 keys in order, 32 at a time, and places a key at
//   its digit's running offset for that warp plus its rank among the
//   lanes of the round with the same digit (__match_any_sync).  A warp's
//   running offsets start at the tile's scanned offset plus the counts
//   of the same digit in the tile's earlier warps, read from the
//   histogram launch's per-warp counts.
// The whole call works in the caller's one buffer (the output, a second
// key/order pair to ping-pong with, the difference word and the
// histograms): one allocation, 1 + 3 x 8 launches and a memset, no sync.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

typedef unsigned long long u64;

constexpr int kBins = 256;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;  // one thread a digit value
constexpr int kRounds = 8;             // 32-key rounds a warp
constexpr int kWarpTile = 32 * kRounds;
constexpr int kTile = kWarps * kWarpTile;

static_assert(kThreads == kBins, "a block has one thread a digit value");

enum { kInput = 0, kOut = 1, kTmp = 2 };

struct Buffers {
  const u64* in;  // the keys as given (index = position)
  long long* out_order;
  u64* out_keys;
  long long* tmp_order;
  u64* tmp_keys;
};

// Bit d set when digit d (bits 8d .. 8d + 7) is not the same in every key;
// all keys equal gives the top digit alone, whose pass copies them.
__device__ __forceinline__ unsigned varying_digits(u64 diff) {
  unsigned v = 0;
  for (int d = 0; d < 8; ++d) {
    if ((diff >> (8 * d)) & 0xFFull) v |= 1u << d;
  }
  return v != 0 ? v : 0x80u;
}

// False when pass d has nothing to do; else the buffers it reads and
// writes: the highest varying digit writes the output, the one below it
// the scratch pair, and so on down; the lowest reads the input.
__device__ __forceinline__ bool plan_pass(const u64* diff, int d, int* src,
                                          int* dst) {
  const unsigned v = varying_digits(*diff);
  if (!((v >> d) & 1u)) return false;
  *dst = (__popc(v >> (d + 1)) & 1) ? kTmp : kOut;
  *src = (v & ((1u << d) - 1u)) == 0 ? kInput : (*dst == kOut ? kTmp : kOut);
  return true;
}

__device__ __forceinline__ const u64* keys_of(const Buffers& b, int which) {
  return which == kInput ? b.in : (which == kOut ? b.out_keys : b.tmp_keys);
}

// *diff |= keys[i] ^ keys[0] over every key (*diff zeroed before).
__global__ void sort_diff(const u64* __restrict__ keys, long long n,
                          u64* __restrict__ diff) {
  const u64 k0 = keys[0];
  u64 acc = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    acc |= keys[i] ^ k0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    acc |= __shfl_xor_sync(0xffffffffu, acc, o);
  }
  if ((threadIdx.x & 31) == 0 && acc != 0) atomicOr(diff, acc);
}

// Pass d, step 1: warp_counts[tile][warp][digit] = keys of the warp's 256
// with that digit; tile_counts[digit * n_tiles + tile] = the tile's sum.
// Each lane loads its kRounds keys before counting, so the loads overlap.
__global__ void __launch_bounds__(kThreads) sort_hist(
    Buffers b, long long n, int d, const u64* __restrict__ diff, int n_tiles,
    int* __restrict__ warp_counts, int* __restrict__ tile_counts) {
  int src, dst;
  if (!plan_pass(diff, d, &src, &dst)) return;
  const u64* __restrict__ keys = keys_of(b, src);
  __shared__ int h[kWarps][kBins];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int w = 0; w < kWarps; ++w) h[w][t] = 0;
  const int shift = 8 * d;
  const long long base = static_cast<long long>(blockIdx.x) * kTile +
                         warp * kWarpTile + lane;
  int dig[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * 32;
    dig[r] = i < n ? static_cast<int>((keys[i] >> shift) & 0xFFull) : kBins;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned peers = __match_any_sync(0xffffffffu, dig[r]);
    // one leader a digit value: no two lanes write one cell
    if (dig[r] < kBins && lane == __ffs(peers) - 1) {
      h[warp][dig[r]] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  int* wc = warp_counts + static_cast<long long>(blockIdx.x) * kWarps * kBins;
  int sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    wc[w * kBins + t] = h[w][t];
    sum += h[w][t];
  }
  tile_counts[static_cast<long long>(t) * n_tiles + blockIdx.x] = sum;
}

// Exclusive sum of one value a thread across a block of kThreads.
__device__ __forceinline__ int block_exclusive(int x, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  int all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_sums[w];
    all += warp_sums[w];
  }
  __syncthreads();
  *total = all;
  return before + inc - x;
}

// Pass d, step 2, one block a digit: row d of the digit-major table
// (the digit's count in each tile, contiguous) becomes its exclusive
// prefix sum in place, and row_total[d] the digit's count over all keys.
__global__ void __launch_bounds__(kThreads) sort_scan(
    const u64* __restrict__ diff, int d, int* __restrict__ counts,
    int n_tiles, int* __restrict__ row_total) {
  int src, dst;
  if (!plan_pass(diff, d, &src, &dst)) return;
  int* row = counts + static_cast<long long>(blockIdx.x) * n_tiles;
  int running = 0;
  for (int c0 = 0; c0 < n_tiles; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    const int x = c < n_tiles ? row[c] : 0;
    int total;
    const int exc = block_exclusive(x, &total);
    if (c < n_tiles) row[c] = running + exc;
    running += total;
  }
  if (threadIdx.x == 0) row_total[blockIdx.x] = running;
}

// Pass d, step 3: every key and its input index to its stable place: a
// digit's keys start at the sum of the smaller digits' totals, plus the
// digit's count in earlier tiles, plus its count in the tile's earlier
// warps.  Each lane loads its kRounds keys and indices first.
__global__ void __launch_bounds__(kThreads) sort_scatter(
    Buffers b, long long n, int d, const u64* __restrict__ diff, int n_tiles,
    const int* __restrict__ warp_counts,
    const int* __restrict__ tile_offsets,
    const int* __restrict__ row_total) {
  int src, dst;
  if (!plan_pass(diff, d, &src, &dst)) return;
  const u64* __restrict__ keys = keys_of(b, src);
  const long long* __restrict__ order = src == kOut ? b.out_order
                                                    : b.tmp_order;
  u64* __restrict__ dkeys = dst == kOut ? b.out_keys : b.tmp_keys;
  long long* __restrict__ dorder = dst == kOut ? b.out_order : b.tmp_order;
  __shared__ int run[kWarps][kBins];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int shift = 8 * d;
  const long long base = static_cast<long long>(blockIdx.x) * kTile +
                         warp * kWarpTile + lane;
  u64 k[kRounds];
  long long id[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * 32;
    k[r] = i < n ? keys[i] : 0;
    id[r] = i < n ? (src == kInput ? i : order[i]) : 0;
  }
  {
    int all;
    int off = block_exclusive(row_total[t], &all) +
              tile_offsets[static_cast<long long>(t) * n_tiles + blockIdx.x];
    const int* wc = warp_counts +
                    static_cast<long long>(blockIdx.x) * kWarps * kBins;
    for (int w = 0; w < kWarps; ++w) {
      run[w][t] = off;
      off += wc[w * kBins + t];
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const bool valid = base + r * 32 < n;
    const int dig = valid ? static_cast<int>((k[r] >> shift) & 0xFFull)
                          : kBins;
    const unsigned peers = __match_any_sync(0xffffffffu, dig);
    const int rank = __popc(peers & below);
    const int pos = valid ? run[warp][dig] + rank : 0;
    __syncwarp();
    if (valid && rank == 0) run[warp][dig] += __popc(peers);
    __syncwarp();
    if (valid) {
      dkeys[pos] = k[r];
      dorder[pos] = id[r];
    }
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// i64 words of the buffer arroyo_join_sort works in for n keys: the order
// and the sorted keys (2n, the result), the scratch pair (2n), the
// difference word, then the i32 per-warp, per-tile and per-digit counts.
extern "C" long long arroyo_join_sort_words(long long n) {
  const long long tiles = tiles_of(n);
  const long long ints = tiles * kWarps * kBins + tiles * kBins + kBins;
  return 4 * n + 1 + (ints + 1) / 2;
}

// keys u64[n] (an i64 tensor's bits) on the device, 1 <= n <= INT_MAX;
// buf i64[arroyo_join_sort_words(n)].  Writes the stable ascending order
// (i64) to buf[0, n) and the keys in that order to buf[n, 2n).  A memset
// and 25 launches on `stream`; returns cudaGetLastError() after the last
// (or the first failing) one.
extern "C" int arroyo_join_sort(const void* keys, long long n, void* buf,
                                void* stream) {
  if (n < 0 || n > INT_MAX) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long tiles = tiles_of(n);
  if (tiles * kBins > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* words = static_cast<long long*>(buf);
  Buffers b;
  b.in = static_cast<const u64*>(keys);
  b.out_order = words;
  b.out_keys = reinterpret_cast<u64*>(words + n);
  b.tmp_order = words + 2 * n;
  b.tmp_keys = reinterpret_cast<u64*>(words + 3 * n);
  u64* diff = reinterpret_cast<u64*>(words + 4 * n);
  int* warp_counts = reinterpret_cast<int*>(words + 4 * n + 1);
  int* tile_counts = warp_counts + tiles * kWarps * kBins;
  int* row_total = tile_counts + tiles * kBins;
  const int n_tiles = static_cast<int>(tiles);
  cudaError_t rc = cudaMemsetAsync(diff, 0, sizeof(u64), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long diff_blocks = tiles * kWarps < 1024 ? tiles * kWarps : 1024;
  sort_diff<<<static_cast<unsigned>(diff_blocks), kThreads, 0, s>>>(b.in, n,
                                                                   diff);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  for (int d = 0; d < 8; ++d) {
    sort_hist<<<n_tiles, kThreads, 0, s>>>(b, n, d, diff, n_tiles,
                                           warp_counts, tile_counts);
    sort_scan<<<kBins, kThreads, 0, s>>>(diff, d, tile_counts, n_tiles,
                                         row_total);
    sort_scatter<<<n_tiles, kThreads, 0, s>>>(b, n, d, diff, n_tiles,
                                              warp_counts, tile_counts,
                                              row_total);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return cudaSuccess;
}
