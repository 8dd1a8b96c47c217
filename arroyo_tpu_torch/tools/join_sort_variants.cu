// csrc/join_sort.cu with build-time knobs for the designs it does not
// use, kept to be measured against it (join_sort_variants.py).  Built
// with none of them, its kernels are the port's; its exports are named
// join_sort_variant*.
//   ARROYO_SORT_TRACE: thread 0 of each block records clock64 at the
//     phase boundaries of each pass and %globaltimer at its start and
//     end into the buffer given to join_sort_variant_trace;
//   ARROYO_SORT_MATCH_ANY: a round's equal digits found by
//     __match_any_sync;
//   ARROYO_SORT_BALLOTS: found by nine ballots where match_digit takes a
//     shared atomic;
//   ARROYO_SORT_SMALL_MAX=N: the one-block path up to N keys (at most
//     8,192), the onesweep path above;
//   ARROYO_SORT_G1_MAX=N: the one-block path in blocks of 256 threads up
//     to N keys (at most 4,096; the port's 2,048), of 1,024 above.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

typedef unsigned long long u64;

constexpr int kBins = 256;

// One block, up to kSmallMax keys.  Fixed shared memory: the
// varying-digit word, 32 warp sums and their total, part[4][256] (the
// digit counts of each group of 8 warps), the per-warp counts
// u16[32][256] and match words u32[32][256]; then keys u64[n] and order
// i32[n].
#ifdef ARROYO_SORT_SMALL_MAX
constexpr int kSmallMax = ARROYO_SORT_SMALL_MAX;
#else
constexpr int kSmallMax = 8192;
#endif
constexpr int kSmallRounds = 16;  // 32-key rounds a warp, at most
constexpr int kSmallFixed =
    8 + 33 * 4 + 4 * kBins * 4 + 32 * kBins * 2 + 32 * kBins * 4 + 4;
static_assert(kSmallFixed % 8 == 0, "keys must be 8-byte aligned");

// Onesweep.
constexpr int kPassWarps = 16;
constexpr int kPassThreads = kPassWarps * 32;
constexpr int kPassRounds = 8;
constexpr int kWarpKeys = 32 * kPassRounds;
constexpr int kTile = kPassWarps * kWarpKeys;  // 4,096 keys a tile
constexpr int kPassSmem = kTile * 8 + kTile * 4 + kPassWarps * kBins * 2 +
                          kPassWarps * kBins * 4 + 2 * kBins * 4 + 34 * 8;
constexpr int kLookBack = 8;  // status words a look-back step reads
constexpr int kUpThreads = 1024;
constexpr int kUpUnroll = 4;
static_assert(kPassThreads >= kBins, "a pass has a thread a digit value");

#ifdef ARROYO_SORT_G1_MAX
constexpr int kG1Max = ARROYO_SORT_G1_MAX;
#else
constexpr int kG1Max = 2048;
#endif
static_assert(kG1Max <= 4096, "256 threads rank at most 4,096 keys");

// g_trace[pass][tile][8], kTraceTiles tiles a pass
#ifdef ARROYO_SORT_TRACE
constexpr int kTraceTiles = 4096;
__device__ unsigned long long* g_trace;
__device__ __forceinline__ void stamp(int pass, int tile, int slot,
                                      bool wall = false) {
  if (threadIdx.x != 0 || g_trace == nullptr || tile >= kTraceTiles) return;
  unsigned long long t;
  if (wall) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } else {
    t = clock64();
  }
  g_trace[(static_cast<long long>(pass) * kTraceTiles + tile) * 8 + slot] = t;
}
#else
__device__ __forceinline__ void stamp(int, int, int, bool = false) {}
#endif

constexpr u64 kAggregate = 1ull << 32;
constexpr u64 kPrefix = 2ull << 32;

// The call's control words, zeroed by its memset; status words follow.
struct Ctl {
  u64 diff;                // OR of every key's difference from key 0
  unsigned tiles[8];       // tile counter a pass
  unsigned hist[8][kBins]; // digit counts over all keys
};
constexpr long long kCtlWords = sizeof(Ctl) / 8;
static_assert(sizeof(Ctl) % 8 == 0, "Ctl is whole words");

// Bit d set when digit d (bits 8d .. 8d + 7) is not the same in every
// key; 0 when all keys are equal.
__device__ __forceinline__ unsigned varying_digits(u64 diff) {
  unsigned v = 0;
  for (int d = 0; d < 8; ++d) {
    if ((diff >> (8 * d)) & 0xFFull) v |= 1u << d;
  }
  return v;
}

__device__ __forceinline__ int digit_of(u64 k, int shift) {
  return static_cast<int>((k >> shift) & 0xFFull);
}

__device__ __forceinline__ u64 warp_or(u64 x) {
  for (int o = 16; o > 0; o >>= 1) x |= __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Exclusive sum of one value a thread across the block, in thread order;
// *total the block's sum.  Every thread of the block calls it; scratch is
// T[33] of shared memory.  Warp 0 scans the warp sums.
template <typename T>
__device__ __forceinline__ T block_exclusive(T x, T* scratch, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const T v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < nw ? scratch[lane] : 0;
    T wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const T v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    if (lane < nw) scratch[lane] = wi - w;
    if (lane == 31) scratch[32] = wi;
  }
  __syncthreads();
  const T before = scratch[warp];
  *total = scratch[32];
  __syncthreads();
  return before + inc - x;
}

// The lanes of the warp whose `dig` (0 .. kBins - 1; kBins for a lane
// without a key, whose result is not used) equals this lane's.  Two warp
// reductions find the bits that are not the same in every lane.  Digits
// with few values, as in SENTINEL padding, differ in a bit or two: a
// ballot each.  Hash-like digits differ in most: each lane sets its bit in
// its digit's word of `masks` (the warp's kBins words, zero between
// rounds) with one shared atomic and reads the word back, which costs the
// warp three shared-memory accesses where nine ballots would queue on
// the SM's vote unit.  (__match_any_sync's cost grows with the number of
// distinct values in the warp.)
__device__ __forceinline__ unsigned match_digit(int dig, unsigned* masks) {
#ifdef ARROYO_SORT_MATCH_ANY
  return __match_any_sync(0xffffffffu, dig);
#endif
  const unsigned u = static_cast<unsigned>(dig);
  unsigned differ = __reduce_or_sync(0xffffffffu, u) ^
                    __reduce_and_sync(0xffffffffu, u);
  unsigned peers = 0xffffffffu;
  if (__popc(differ) > 2) {
#ifndef ARROYO_SORT_BALLOTS
    const bool valid = dig < kBins;
    if (valid) atomicOr(masks + dig, 1u << (threadIdx.x & 31));
    __syncwarp();
    peers = valid ? masks[dig] : 0u;
    __syncwarp();
    if (valid) masks[dig] = 0;
    return peers;
#else
#pragma unroll
    for (int bit = 0; bit < 9; ++bit) {
      const bool set = (u >> bit) & 1u;
      const unsigned ones = __ballot_sync(0xffffffffu, set);
      peers &= set ? ones : ~ones;
    }
    return peers;
#endif
  }
  while (differ != 0) {  // the same in every lane: no divergence
    const int bit = __ffs(differ) - 1;
    differ &= differ - 1;
    const bool set = (u >> bit) & 1u;
    const unsigned ones = __ballot_sync(0xffffffffu, set);
    peers &= set ? ones : ~ones;
  }
  return peers;
}

// One warp's round of 32 keys: `dig` the lane's digit (kBins when the
// lane has no key).  Returns the lane's place among the warp's keys of
// that digit so far (count[dig] + its rank among equal digits of the
// round) packed with the digit (place | dig << 16), and adds the round's
// keys to count.  `masks`: the warp's match words.
__device__ __forceinline__ int rank_round(int dig, unsigned short* count,
                                          unsigned* masks) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = match_digit(dig, masks);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int cur = dig < kBins ? count[dig] : 0;
  __syncwarp();
  if (dig < kBins && rank == 0) {
    count[dig] = static_cast<unsigned short>(cur + __popc(peers));
  }
  __syncwarp();
  return (cur + rank) | (dig << 16);
}

// The one-block sort of n <= kSmallMax keys with G groups of 8 warps
// (256 G threads).
template <int G>
__global__ void __launch_bounds__(256 * G) sort_one_block(
    const u64* __restrict__ in, int n, long long* __restrict__ out_order,
    u64* __restrict__ out_keys) {
  constexpr int kW = 8 * G;
  constexpr int kT = 32 * kW;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* diff = reinterpret_cast<u64*>(smem);
  int* scratch = reinterpret_cast<int*>(smem + 8);
  int* part = scratch + 33;                            // [4][kBins]
  unsigned short* hist = reinterpret_cast<unsigned short*>(part + 4 * kBins);
  unsigned* masks = reinterpret_cast<unsigned*>(hist + 32 * kBins);
  u64* keys = reinterpret_cast<u64*>(smem + kSmallFixed);
  int* idx = reinterpret_cast<int*>(keys + n);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) *diff = 0;
  const u64 k0 = in[0];
  __syncthreads();
  u64 acc = 0;
#pragma unroll 4
  for (int p = t; p < n; p += kT) {
    const u64 k = in[p];
    keys[p] = k;
    idx[p] = p;
    acc |= k ^ k0;
  }
  acc = warp_or(acc);
  if (lane == 0 && acc != 0) atomicOr(diff, acc);
  __syncthreads();
  const unsigned v = varying_digits(*diff);
  const int rounds = (n + kT - 1) / kT;  // a warp's 32-key rounds
  const int wbase = warp * rounds * 32 + lane;
  const int d = t & (kBins - 1);  // the digit value this thread sums
  const int g = t >> 8;           // over warps 8g .. 8g + 7
  unsigned short* my = hist + warp * kBins;
  unsigned* my_masks = masks + warp * kBins;
  for (int i = t; i < kW * kBins; i += kT) masks[i] = 0;
  for (int pass = 0; pass < 8; ++pass) {
    if (!((v >> pass) & 1u)) continue;
    stamp(pass, 0, 6, true);
    stamp(pass, 0, 0);
    const int shift = 8 * pass;
    for (int i = t; i < kW * kBins / 2; i += kT) {
      reinterpret_cast<unsigned*>(hist)[i] = 0;
    }
    int ii[kSmallRounds];
    int lp[kSmallRounds];
#pragma unroll
    for (int r = 0; r < kSmallRounds; ++r) {
      if (r < rounds) {
        const int p = wbase + r * 32;
        ii[r] = p < n ? idx[p] : 0;
        lp[r] = p < n ? digit_of(keys[ii[r]], shift) : kBins;
      }
    }
    __syncthreads();
    stamp(pass, 0, 1);
#pragma unroll
    for (int r = 0; r < kSmallRounds; ++r) {
      if (r < rounds) lp[r] = rank_round(lp[r], my, my_masks);
    }
    __syncthreads();
    stamp(pass, 0, 2);
    // hist[w][d] becomes the first place of warp w's keys of digit d:
    // the keys of smaller digits, then digit d's in earlier warps.
    int run = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) run += hist[(8 * g + j) * kBins + d];
    if (G > 1) {
      part[g * kBins + d] = run;
      __syncthreads();
      if (g == 0) {
        run = 0;
        for (int q = 0; q < G; ++q) run += part[q * kBins + d];
      }
    }
    int all;
    run = block_exclusive<int>(g == 0 ? run : 0, scratch, &all);
    if (G > 1) {
      if (g == 0) {
        for (int q = 0; q < G; ++q) {
          const int x = part[q * kBins + d];
          part[q * kBins + d] = run;
          run += x;
        }
      }
      __syncthreads();
      run = part[g * kBins + d];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = hist[(8 * g + j) * kBins + d];
      hist[(8 * g + j) * kBins + d] = static_cast<unsigned short>(run);
      run += x;
    }
    __syncthreads();
    stamp(pass, 0, 3);
    // every index was read before the first barrier of the pass
#pragma unroll
    for (int r = 0; r < kSmallRounds; ++r) {
      if (r < rounds) {
        const int dig = lp[r] >> 16;
        if (dig < kBins) idx[my[dig] + (lp[r] & 0xFFFF)] = ii[r];
      }
    }
    __syncthreads();
    stamp(pass, 0, 4);
    stamp(pass, 0, 7, true);
  }
#pragma unroll 4
  for (int p = t; p < n; p += kT) {
    const int i = idx[p];
    out_order[p] = i;
    out_keys[p] = keys[i];
  }
}

// Onesweep, step 1 (grid-stride, at most one block an SM): the eight
// digit histograms of all keys into ctl->hist and the varying-digit word
// into ctl->diff.  A warp whose keys share a digit adds them with one
// shared atomic.
__global__ void __launch_bounds__(kUpThreads) sort_upfront(
    const u64* __restrict__ keys, int n, Ctl* __restrict__ ctl) {
  __shared__ unsigned h[8 * kBins];
  for (int i = threadIdx.x; i < 8 * kBins; i += kUpThreads) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const u64 k0 = keys[0];
  u64 acc = 0;
  constexpr int kChunk = 32 * kUpUnroll;
  const long long stride =
      static_cast<long long>(gridDim.x) * (kUpThreads / 32) * kChunk;
  for (long long base =
           (static_cast<long long>(blockIdx.x) * (kUpThreads / 32) +
            (threadIdx.x >> 5)) * kChunk;
       base < n; base += stride) {
    u64 k[kUpUnroll];
#pragma unroll
    for (int u = 0; u < kUpUnroll; ++u) {
      const long long i = base + u * 32 + lane;
      k[u] = i < n ? keys[i] : k0;
    }
#pragma unroll
    for (int u = 0; u < kUpUnroll; ++u) {
      const bool valid = base + u * 32 + lane < n;
      const int cnt = __popc(__ballot_sync(0xffffffffu, valid));
      acc |= k[u] ^ k0;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int dig = digit_of(k[u], 8 * d);
        const int d0 = __shfl_sync(0xffffffffu, dig, 0);
        if (__all_sync(0xffffffffu, !valid || dig == d0)) {
          if (lane == 0 && cnt > 0) {
            atomicAdd(&h[d * kBins + d0], static_cast<unsigned>(cnt));
          }
        } else if (valid) {
          atomicAdd(&h[d * kBins + dig], 1u);
        }
      }
    }
  }
  acc = warp_or(acc);
  if (lane == 0 && acc != 0) atomicOr(&ctl->diff, acc);
  __syncthreads();
  unsigned* gh = &ctl->hist[0][0];
  for (int i = threadIdx.x; i < 8 * kBins; i += kUpThreads) {
    if (h[i] != 0) atomicAdd(gh + i, h[i]);
  }
}

struct Buffers {
  const u64* in;         // the keys as given (index = position)
  long long* out_order;  // the result's order (i64)
  u64* out_keys;         // slot 0: the result's keys
  u64* tmp_keys;         // slot 1: scratch keys
  int* idx0;             // i32 order beside each slot's keys
  int* idx1;
};

__device__ __forceinline__ u64 load_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Onesweep, step 2: the stable pass over digit `d` (see the top).
__global__ void __launch_bounds__(kPassThreads, 2) sort_pass(
    Buffers b, int n, int d, Ctl* __restrict__ ctl,
    u64* __restrict__ status) {
  unsigned v = varying_digits(ctl->diff);
  if (v == 0) v = 0x80u;
  if (!((v >> d) & 1u)) return;
  const bool top = (v >> (d + 1)) == 0;
  const int dst = __popc(v >> (d + 1)) & 1;
  const bool first = (v & ((1u << d) - 1u)) == 0;
  const u64* __restrict__ src_keys =
      first ? b.in : (dst ? b.out_keys : b.tmp_keys);
  const int* __restrict__ src_idx = dst ? b.idx0 : b.idx1;
  u64* __restrict__ dst_keys = dst ? b.tmp_keys : b.out_keys;
  int* __restrict__ dst_idx = dst ? b.idx1 : b.idx0;

  extern __shared__ __align__(16) unsigned char smem[];
  u64* sk = reinterpret_cast<u64*>(smem);                  // [kTile]
  int* si = reinterpret_cast<int*>(sk + kTile);            // [kTile]
  unsigned short* wh =
      reinterpret_cast<unsigned short*>(si + kTile);       // [warps][bins]
  unsigned* masks = reinterpret_cast<unsigned*>(wh + kPassWarps * kBins);
  int* delta = reinterpret_cast<int*>(masks + kPassWarps * kBins);
  int* tstart = delta + kBins;
  u64* scratch = reinterpret_cast<u64*>(tstart + kBins);  // [34]
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int shift = 8 * d;
  const u64 tag = static_cast<u64>(d + 1) << 40;

  if (t == 0) scratch[33] = atomicAdd(&ctl->tiles[d], 1u);
  for (int i = t; i < kPassWarps * kBins / 2; i += kPassThreads) {
    reinterpret_cast<unsigned*>(wh)[i] = 0;
  }
  for (int i = t; i < kPassWarps * kBins; i += kPassThreads) masks[i] = 0;
  __syncthreads();
  const int tile = static_cast<int>(scratch[33]);
  stamp(d, tile, 6, true);
  stamp(d, tile, 0);
  const int tile0 = tile * kTile;
  const int tile_n = min(kTile, n - tile0);
  const int wbase = tile0 + warp * kWarpKeys + lane;
  u64 k[kPassRounds];
  int id[kPassRounds];
  int lp[kPassRounds];
#pragma unroll
  for (int r = 0; r < kPassRounds; ++r) {
    const int p = wbase + r * 32;
    k[r] = p < n ? src_keys[p] : 0;
    id[r] = p < n ? (first ? p : src_idx[p]) : 0;
  }
  unsigned short* my = wh + warp * kBins;
#pragma unroll
  for (int r = 0; r < kPassRounds; ++r) {
    const int dig = wbase + r * 32 < n ? digit_of(k[r], shift) : kBins;
    lp[r] = rank_round(dig, my, masks + warp * kBins);
  }
  __syncthreads();
  stamp(d, tile, 1);
  // per digit value: warp offsets within the tile and the tile's count,
  // posted at once so that no later tile waits on this one's look-back
  int cnt = 0;
  const int total = t < kBins ? static_cast<int>(ctl->hist[d][t]) : 0;
  if (t < kBins) {
    int c[kPassWarps];
#pragma unroll
    for (int w = 0; w < kPassWarps; ++w) c[w] = wh[w * kBins + t];
#pragma unroll
    for (int w = 0; w < kPassWarps; ++w) {
      wh[w * kBins + t] = static_cast<unsigned short>(cnt);
      cnt += c[w];
    }
    if (total != 0) {  // a digit no key has is never looked up
      store_status(status + static_cast<long long>(tile) * kBins + t,
                   tag | (tile == 0 ? kPrefix : kAggregate) |
                       static_cast<unsigned>(cnt));
    }
  }
  // one scan: the digits' starts in the tile (low word) and their bases
  // over all keys (high word)
  u64 all;
  const u64 ex = block_exclusive<u64>(
      t < kBins ? (static_cast<u64>(total) << 32) | cnt : 0,
      scratch, &all);
  const int start = static_cast<int>(ex & 0xFFFFFFFFull);
  if (t < kBins) tstart[t] = start;
  __syncthreads();
  stamp(d, tile, 2);
  // the tile ordered by digit in shared memory
#pragma unroll
  for (int r = 0; r < kPassRounds; ++r) {
    const int dig = lp[r] >> 16;
    if (dig < kBins) {
      const int q = tstart[dig] + my[dig] + (lp[r] & 0xFFFF);
      sk[q] = k[r];
      si[q] = id[r];
    }
  }
  stamp(d, tile, 3);
  if (t < kBins) {
    // digit t's keys in earlier tiles: kLookBack status words read at
    // once, added in order down to the first inclusive one; a word not
    // yet posted is read again
    int before = 0;
    int j = tile - 1;
    bool done = j < 0 || total == 0;
    while (!done) {
      u64 ahead[kLookBack];
#pragma unroll
      for (int i = 0; i < kLookBack; ++i) {
        ahead[i] = j - i >= 0
                    ? load_status(status +
                                  static_cast<long long>(j - i) * kBins + t)
                    : (tag | kPrefix);
      }
#pragma unroll
      for (int i = 0; i < kLookBack; ++i) {
        const u64 s = ahead[i];
        if (done || (s & (0xFull << 40)) != tag || (s & (3ull << 32)) == 0) {
          break;
        }
        before += static_cast<int>(s & 0xFFFFFFFFull);
        --j;
        done = (s & kPrefix) != 0;
      }
    }
    if (tile > 0 && total != 0) {
      store_status(status + static_cast<long long>(tile) * kBins + t,
                   tag | kPrefix | static_cast<unsigned>(before + cnt));
    }
    delta[t] = static_cast<int>(ex >> 32) + before - start;
  }
  __syncthreads();
  stamp(d, tile, 4);
  // each digit's run leaves as one contiguous write
  for (int q = t; q < tile_n; q += kPassThreads) {
    const u64 key = sk[q];
    const int g = q + delta[digit_of(key, shift)];
    dst_keys[g] = key;
    if (top) {
      b.out_order[g] = si[q];
    } else {
      dst_idx[g] = si[q];
    }
  }
  stamp(d, tile, 5);
  stamp(d, tile, 7, true);
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

#ifdef ARROYO_SORT_TRACE
// Trace builds: where the kernels write their stamps (null: nowhere).
extern "C" int join_sort_variant_trace(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &buf, sizeof(buf)));
}
#endif

// i64 words of the buffer join_sort_variant works in for n keys: the order
// and the sorted keys (2n, the result); above the one-block limit also the
// scratch keys (n), two i32 orders (n), the control words and the status
// words.
extern "C" long long join_sort_variant_words(long long n) {
  if (n <= kSmallMax) return 2 * n;
  return 4 * n + kCtlWords + kBins * tiles_of(n);
}

// keys u64[n] (an i64 tensor's bits) on the device, 0 <= n <= INT_MAX -
// kTile; buf i64[join_sort_variant_words(n)].  Writes the stable ascending
// order (i64) to buf[0, n) and the keys in that order to buf[n, 2n).  Up
// to the one-block limit one launch on `stream`, above it a memset and 9
// launches; returns cudaGetLastError() after the last (or the first
// failing) one.
extern "C" int join_sort_variant(const void* keys, long long n, void* buf,
                                void* stream) {
  if (n < 0 || n > INT_MAX - kTile) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const u64* in = static_cast<const u64*>(keys);
  long long* words = static_cast<long long*>(buf);
  u64* out_keys = reinterpret_cast<u64*>(words + n);
  const int n32 = static_cast<int>(n);
  cudaError_t rc;
  if (n <= kSmallMax) {
    const int smem = kSmallFixed + 12 * n32;
    if (n <= kG1Max) {
      rc = cudaFuncSetAttribute(sort_one_block<1>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmallFixed + 12 * kG1Max);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      sort_one_block<1><<<1, 256, smem, s>>>(in, n32, words, out_keys);
    } else {
      rc = cudaFuncSetAttribute(sort_one_block<4>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmallFixed + 12 * kSmallMax);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      sort_one_block<4><<<1, 1024, smem, s>>>(in, n32, words, out_keys);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = tiles_of(n);
  Buffers b;
  b.in = in;
  b.out_order = words;
  b.out_keys = out_keys;
  b.tmp_keys = reinterpret_cast<u64*>(words + 2 * n);
  b.idx0 = reinterpret_cast<int*>(words + 3 * n);
  b.idx1 = b.idx0 + n;
  Ctl* ctl = reinterpret_cast<Ctl*>(words + 4 * n);
  u64* status = reinterpret_cast<u64*>(words + 4 * n + kCtlWords);
  rc = cudaMemsetAsync(ctl, 0, (kCtlWords + kBins * tiles) * 8, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int dev = 0;
  int sms = 0;
  rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long per_block = kUpThreads * kUpUnroll;
  const long long up_blocks = (n + per_block - 1) / per_block;
  sort_upfront<<<static_cast<unsigned>(up_blocks < sms ? up_blocks : sms),
                 kUpThreads, 0, s>>>(in, n32, ctl);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(sort_pass,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kPassSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  for (int d = 0; d < 8; ++d) {
    sort_pass<<<static_cast<unsigned>(tiles), kPassThreads, kPassSmem, s>>>(
        b, n32, d, ctl, status);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return cudaSuccess;
}
