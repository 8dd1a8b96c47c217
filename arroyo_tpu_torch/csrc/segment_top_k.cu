// segment_top_k: the rows of each segment whose rank by value (descending)
// is below k, as their indices in ascending original order.
//
// Replaces arroyo_tpu/ops/topk.py:25 `_topk_kernel` (one stable
// `lax.sort` over (segment, -value, index), rank = position - segment
// start, keep rank < k) together with the host `out.sort()` after it.
//
// Order: segment ascending, then value descending, then original index
// ascending.  -0.0 and +0.0 are equal and NaN of either sign sorts after
// every number, as `lax.sort` orders them.  Each value maps to a u64 that
// sorts ascending in that order: y = -x with -0 folded onto +0, its bits
// with every bit flipped when negative and the sign bit set otherwise, and
// all ones for NaN.
//
// What bounds it on the H100: memory, and below that the launches.  The
// least traffic is the 12 input bytes of a row (i32 segment, f64 value)
// and 4 bytes per kept index: 0.002 ms at 599,800 rows.  TopN's calls keep
// 10 rows of each of a few windows out of hundreds of thousands, so the
// design reads every row once and sorts only what can still be kept.
//
// The prefilter.  In (segment, key, index) order a row is kept exactly
// when the row k places earlier lies in another segment (or does not
// exist).  If a row has k rows of its own segment before it inside any
// subset of the rows that holds it, those rows come before it globally
// too, so it is not kept: keeping each tile's local top k per segment
// drops no row of the result, and the same holds when the filter runs
// again over its own output (kept in original order).  A round is one
// launch: each block takes tiles of kTileRows candidates (a tile counter
// hands them out in order).  Inside a tile the same filter runs twice:
// each warp sorts chunks of 128 composite keys (segment | order key |
// candidate position, 128 bits) in registers with a shuffle bitonic
// network and keeps the chunk's local top k per segment; the block sorts
// those survivors in shared memory (bitonic) and applies the rank test to
// the tile.  The 128-bit keys make shared-memory traffic the cost of a
// sort, so the register pass comes first: with one segment a tile's
// 2,048 candidates leave 160 for the shared-memory sort.  The tile's
// survivors go out in original order at its offset, found by a decoupled
// look-back over the earlier tiles' published counts, so no scan launch
// and no host decision sits between rounds.  A round reads its input
// count from device memory and passes its input on untouched when it
// already fits one tile or the round before kept more than half.  The
// final launch is one block that takes up to kFinalRows candidates into
// 152 KiB of dynamic shared memory, ranks them the same way, and writes
// the kept indices in ascending order with their count — the call's one
// readback.
//
// The general path.  Candidates that do not shrink below kFinalRows (many
// segments with fewer than k rows a tile, or k at least a tile) go to an
// LSD radix sort, written here, of candidate positions: 8-bit digits,
// only the digits that vary (a key kernel ORs each key's difference from
// the first into a mask, read back once), three launches a pass —
// per-tile digit histograms, one scan of the digit-major table, and a
// stable scatter that places a row at its digit's running offset plus
// the same digit's count in earlier warps plus its rank among equal
// digits in its warp (__match_any_sync).  The rank test marks kept
// positions, which are compacted in order and mapped back to rows.  No
// step of either path works per segment, so one segment holding every
// row costs what many small ones do.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;  // threads per block = radix buckets
constexpr int kRounds = 16;    // rounds of kThreads rows per radix tile
constexpr int kTile = kThreads * kRounds;
constexpr int kWarps = kThreads / 32;

constexpr int kTileRows = 2048;  // candidates per prefilter tile
constexpr int kTileThreads = 512;
constexpr int kFinalRows = 8192;  // candidates the final block holds
constexpr int kFinalThreads = 1024;
constexpr int kChunk = 128;  // candidates a warp sorts in registers
constexpr int kFinalSmem = kFinalRows * (2 * sizeof(u64) + 1) +
                           (kFinalThreads / 32) * kChunk * sizeof(unsigned);

constexpr u64 kAggregate = 1ull << 32;  // look-back status flags
constexpr u64 kInclusive = 2ull << 32;

__device__ __forceinline__ u64 order_key(double x) {
  if (isnan(x)) return ~0ull;
  u64 b = static_cast<u64>(__double_as_longlong(-x));
  if ((b << 1) == 0) b = 0;  // -0.0 -> +0.0
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

// -- the prefilter ------------------------------------------------------------

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v));
}

// Sorts the first P (a power of two) composite keys (hi, lo) ascending.
__device__ __forceinline__ void bitonic_sort(u64* hi, u64* lo, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int j = threadIdx.x; j < (P >> 1); j += blockDim.x) {
        const int a = 2 * j - (j & (stride - 1));
        const int b = a + stride;
        const u64 ha = hi[a], hb = hi[b], la = lo[a], lb = lo[b];
        const bool gt = ha > hb || (ha == hb && la > lb);
        if (gt == ((a & size) == 0)) {
          hi[a] = hb;
          hi[b] = ha;
          lo[a] = lb;
          lo[b] = la;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ bool less128(u64 ah, u64 al, u64 bh, u64 bl) {
  return ah < bh || (ah == bh && al < bl);
}

// Bitonic sort of a warp's 128 composite keys in registers: element
// e * 32 + lane sits in slot e of the lane; strides of 32 and 64 pair the
// lane's own slots, smaller ones pair lanes (shuffles).
__device__ __forceinline__ void warp_sort128(u64 (&h)[4], u64 (&l)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= kChunk; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = e * 32 + lane;
        const bool up = (idx & size) == 0;
        if (stride >= 32) {
          const int f = e ^ (stride >> 5);
          if (f > e) {
            const bool swap = up ? less128(h[f], l[f], h[e], l[e])
                                 : less128(h[e], l[e], h[f], l[f]);
            if (swap) {
              const u64 th = h[e], tl = l[e];
              h[e] = h[f];
              l[e] = l[f];
              h[f] = th;
              l[f] = tl;
            }
          }
        } else {
          const u64 oh = __shfl_xor_sync(0xffffffffu, h[e], stride);
          const u64 ol = __shfl_xor_sync(0xffffffffu, l[e], stride);
          const bool keep_min = ((idx & stride) == 0) == up;
          const bool take = keep_min ? less128(oh, ol, h[e], l[e])
                                     : less128(h[e], l[e], oh, ol);
          if (take) {
            h[e] = oh;
            l[e] = ol;
          }
        }
      }
    }
  }
}

// Candidate p as a composite key (segment | order key | p), ordered as
// the rank test needs: its row is in[p], or p when `in` is null.
__device__ __forceinline__ void composite(const int* __restrict__ seg,
                                          const double* __restrict__ val,
                                          const int* __restrict__ in, int p,
                                          u64& h, u64& l) {
  const int i = in ? in[p] : p;
  const u64 key = order_key(val[i]);
  h = (static_cast<u64>(static_cast<unsigned>(seg[i])) << 32) | (key >> 32);
  l = (key << 32) | static_cast<unsigned>(p);
}

// One warp's chunk of `valid` candidates (slots past it hold padding,
// ~0, which sorts after every segment id): sorted in registers when k <
// kChunk, its local top k per segment is appended to (hi, lo) at
// *count.  tmp holds kChunk words of the warp.
__device__ __forceinline__ void chunk_filter(u64 (&h)[4], u64 (&l)[4],
                                             int valid, int k,
                                             unsigned* tmp, u64* hi, u64* lo,
                                             int* count) {
  const int lane = threadIdx.x & 31;
  if (k < kChunk) warp_sort128(h, l);
#pragma unroll
  for (int e = 0; e < 4; ++e) tmp[e * 32 + lane] = static_cast<unsigned>(h[e] >> 32);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = e * 32 + lane;
    // unsorted (k >= kChunk): every candidate survives
    const bool kept = q < valid &&
                      (q < k || tmp[q - k] != static_cast<unsigned>(h[e] >> 32));
    const unsigned ballot = __ballot_sync(0xffffffffu, kept);
    int at = 0;
    if (lane == 0 && ballot) at = atomicAdd(count, __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(ballot & ((1u << lane) - 1u));
    if (kept) {
      hi[at] = h[e];
      lo[at] = l[e];
    }
  }
  __syncwarp();  // tmp is reused by the warp's next chunk
}

// Candidates base .. base + cnt - 1 of `in` (the rows themselves when
// `in` is null): sets keep[q] for local position q when the candidate
// ranks below k in its segment among them.  Each warp filters chunks of
// kChunk candidates in registers (chunk_filter), appending the survivors
// to (hi, lo); the block then sorts the survivors in shared memory and
// ranks them.  seg_tmp holds kChunk words per warp, count one int.  Ends
// synchronized.
__device__ __forceinline__ void tile_keep(
    const int* __restrict__ seg, const double* __restrict__ val,
    const int* __restrict__ in, int base, int cnt, int k, u64* hi, u64* lo,
    unsigned char* keep, unsigned* seg_tmp, int* count) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned* tmp = seg_tmp + warp * kChunk;
  for (int q = threadIdx.x; q < cnt; q += blockDim.x) keep[q] = 0;
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  for (int c = warp * kChunk; c < cnt; c += nwarps * kChunk) {
    u64 h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = c + e * 32 + lane;
      if (q < cnt) {
        composite(seg, val, in, base + q, h[e], l[e]);
      } else {
        h[e] = l[e] = ~0ull;
      }
    }
    chunk_filter(h, l, min(kChunk, cnt - c), k, tmp, hi, lo, count);
  }
  __syncthreads();
  const int s = *count;
  int P = 2;
  while (P < s) P <<= 1;
  for (int q = s + threadIdx.x; q < P; q += blockDim.x) hi[q] = lo[q] = ~0ull;
  __syncthreads();
  bitonic_sort(hi, lo, P);
  for (int q = threadIdx.x; q < s; q += blockDim.x) {
    const bool kept = q < k || (hi[q - k] >> 32) != (hi[q] >> 32);
    keep[static_cast<int>(lo[q] & 0xffffffffu) - base] = kept;
  }
  __syncthreads();
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
template <int kT>
__device__ __forceinline__ int block_exclusive_sum(int v, int* total) {
  __shared__ int warp_sum[kT / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kT / 32 ? warp_sum[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kT / 32) warp_sum[lane] = w;
  }
  __syncthreads();
  *total = warp_sum[kT / 32 - 1];
  const int before = warp > 0 ? warp_sum[warp - 1] : 0;
  __syncthreads();  // warp_sum is reused by the next call
  return before + x - v;
}

// This thread's share of a tile: local positions [*lo_q, *hi_q), their
// kept count, and the kept candidates before them in the tile.
template <int kT, int kRows>
__device__ __forceinline__ int thread_share(const unsigned char* keep,
                                            int cnt, int* lo_q, int* hi_q,
                                            int* total) {
  constexpr int kPer = kRows / kT;
  *lo_q = min(static_cast<int>(threadIdx.x) * kPer, cnt);
  *hi_q = min(*lo_q + kPer, cnt);
  int c = 0;
  for (int q = *lo_q; q < *hi_q; ++q) c += keep[q];
  return block_exclusive_sum<kT>(c, total);
}

// The tile's output offset by decoupled look-back (warp 0 calls it):
// publishes the tile's count, sums the counts of earlier tiles back to
// the nearest one that published its inclusive prefix, then publishes its
// own.  Tiles are handed out in order, so every earlier tile is running
// and publishes its count without waiting.
__device__ int look_back(u64* status, int tile, int count) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) st_relaxed(status, kInclusive | static_cast<unsigned>(count));
    return 0;
  }
  if (lane == 0) st_relaxed(status + tile, kAggregate | static_cast<unsigned>(count));
  int acc = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int idx = pred - lane;
    u64 s = idx >= 0 ? ld_relaxed(status + idx) : kInclusive;
    while (__any_sync(0xffffffffu, (s >> 32) == 0)) {
      if ((s >> 32) == 0) s = ld_relaxed(status + idx);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, (s >> 32) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(s & 0xffffffffu) : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    acc += v;
    if (inc) break;
  }
  if (lane == 0) {
    st_relaxed(status + tile, kInclusive | static_cast<unsigned>(acc + count));
  }
  return acc;
}

// One prefilter round r.  Candidates (row indices, ascending) come from
// the rows themselves (r = 0) or from buffer ctl[2r + 1] (1: a, 2: b),
// ctl[2r] of them; the survivors go to the other buffer and round r + 1's
// control words.  status u64[tiles] and *counter start at zero.
__global__ void __launch_bounds__(kTileThreads)
    round_kernel(const int* __restrict__ seg, const double* __restrict__ val,
                 int n, int k, int r, int* buf_a, int* buf_b,
                 u64* __restrict__ status, int* __restrict__ counter,
                 int* __restrict__ ctl) {
  __shared__ u64 hi[kTileRows], lo[kTileRows];
  __shared__ unsigned char keep[kTileRows];
  __shared__ unsigned seg_tmp[kTileThreads / 32 * kChunk];
  __shared__ int s_tile, s_offset, s_survivors;
  const int m = r == 0 ? n : ctl[2 * r];
  const int sel = r == 0 ? 0 : ctl[2 * r + 1];
  const int m_prev = r <= 1 ? n : ctl[2 * (r - 1)];
  if (m <= kTileRows || (r > 0 && 2ll * m > m_prev)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      ctl[2 * (r + 1)] = m;
      ctl[2 * (r + 1) + 1] = sel;
    }
    return;
  }
  const int* in = sel == 0 ? nullptr : (sel == 1 ? buf_a : buf_b);
  int* out = sel == 1 ? buf_b : buf_a;
  const int ntiles = (m + kTileRows - 1) / kTileRows;
  for (;;) {
    if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1);
    __syncthreads();
    const int tile = s_tile;
    if (tile >= ntiles) return;
    const int base = tile * kTileRows;
    const int cnt = min(kTileRows, m - base);
    tile_keep(seg, val, in, base, cnt, k, hi, lo, keep, seg_tmp,
              &s_survivors);
    int lo_q, hi_q, total;
    int pos = thread_share<kTileThreads, kTileRows>(keep, cnt, &lo_q, &hi_q,
                                                   &total);
    if (threadIdx.x < 32) {
      const int offset = look_back(status, tile, total);
      if (threadIdx.x == 0) {
        s_offset = offset;
        if (tile == ntiles - 1) {
          ctl[2 * (r + 1)] = offset + total;
          ctl[2 * (r + 1) + 1] = sel == 1 ? 2 : 1;
        }
      }
    }
    __syncthreads();
    pos += s_offset;
    for (int q = lo_q; q < hi_q; ++q) {
      if (keep[q]) out[pos++] = in ? in[base + q] : base + q;
    }
    __syncthreads();  // smem and s_tile are reused by the next tile
  }
}

// The final block: the candidates left after R rounds (the rows when R =
// 0) ranked among themselves; out i32 gets the kept row indices,
// ascending, and info i32[3] = {kept, candidates, buffer} — kept = -1
// when more than kFinalRows candidates are left for the general path.
__global__ void __launch_bounds__(kFinalThreads)
    final_kernel(const int* __restrict__ seg, const double* __restrict__ val,
                 int n, int k, int R, const int* buf_a, const int* buf_b,
                 const int* __restrict__ ctl, int* __restrict__ out,
                 int* __restrict__ info) {
  extern __shared__ u64 smem[];
  __shared__ int s_survivors;
  u64* hi = smem;
  u64* lo = smem + kFinalRows;
  unsigned* seg_tmp = reinterpret_cast<unsigned*>(smem + 2 * kFinalRows);
  unsigned char* keep = reinterpret_cast<unsigned char*>(
      seg_tmp + kFinalThreads / 32 * kChunk);
  const int m = R == 0 ? n : ctl[2 * R];
  const int sel = R == 0 ? 0 : ctl[2 * R + 1];
  if (m > kFinalRows) {
    if (threadIdx.x == 0) {
      info[0] = -1;
      info[1] = m;
      info[2] = sel;
    }
    return;
  }
  const int* in = sel == 0 ? nullptr : (sel == 1 ? buf_a : buf_b);
  tile_keep(seg, val, in, 0, m, k, hi, lo, keep, seg_tmp, &s_survivors);
  int lo_q, hi_q, total;
  int pos = thread_share<kFinalThreads, kFinalRows>(keep, m, &lo_q, &hi_q,
                                                   &total);
  for (int q = lo_q; q < hi_q; ++q) {
    if (keep[q]) out[pos++] = in ? in[q] : q;
  }
  if (threadIdx.x == 0) {
    info[0] = total;
    info[1] = m;
    info[2] = sel;
  }
}

// -- the general path: LSD radix sort of candidate positions ------------------

// key[p], seg_c[p] (when cand is given) and idx[p] = p for candidate p
// (row cand[p], or row p); masks[0] |= key[p] ^ key[0], masks[1] |=
// seg(p) ^ seg(0)
__global__ void key_kernel(const double* __restrict__ val,
                           const int* __restrict__ seg,
                           const int* __restrict__ cand, int n,
                           u64* __restrict__ key, int* __restrict__ seg_c,
                           int* __restrict__ idx, u64* __restrict__ masks) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  u64 dk = 0, ds = 0;
  if (p < n) {
    const int i = cand ? cand[p] : p;
    const int i0 = cand ? cand[0] : 0;
    const u64 k = order_key(val[i]);
    const int s = seg[i];
    key[p] = k;
    if (cand) seg_c[p] = s;
    idx[p] = p;
    dk = k ^ order_key(val[i0]);
    ds = static_cast<u64>(static_cast<unsigned>(s ^ seg[i0]));
  }
  for (int off = 16; off > 0; off >>= 1) {
    dk |= __shfl_down_sync(0xffffffffu, dk, off);
    ds |= __shfl_down_sync(0xffffffffu, ds, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (dk) atomicOr(masks, dk);
    if (ds) atomicOr(masks + 1, ds);
  }
}

// the radix digit of row `id` in this pass (kThreads: no row)
__device__ __forceinline__ int digit_of(const u64* key, const int* seg,
                                        int use_seg, int shift, int id) {
  return use_seg ? ((seg[id] >> shift) & 0xFF)
                 : static_cast<int>((key[id] >> shift) & 0xFF);
}

// hist[d * ntiles + tile] = rows of the tile whose digit is d
__global__ void hist_kernel(const u64* __restrict__ key,
                            const int* __restrict__ seg, int use_seg,
                            int shift, const int* __restrict__ idx_in, int n,
                            int ntiles, int* __restrict__ hist) {
  __shared__ int h[kThreads];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    const int d = i < n ? digit_of(key, seg, use_seg, shift, idx_in[i])
                        : kThreads;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < kThreads && lane == __ffs(peers) - 1) {
      atomicAdd(&h[d], __popc(peers));
    }
  }
  __syncthreads();
  hist[threadIdx.x * ntiles + blockIdx.x] = h[threadIdx.x];
}

// stable scatter of the tile's rows to offsets[d * ntiles + tile] onward
__global__ void scatter_kernel(const u64* __restrict__ key,
                               const int* __restrict__ seg, int use_seg,
                               int shift, const int* __restrict__ idx_in,
                               int n, int ntiles,
                               const int* __restrict__ offsets,
                               int* __restrict__ idx_out) {
  __shared__ int run[kThreads];
  __shared__ int warp_hist[kWarps][kThreads];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  run[tid] = offsets[tid * ntiles + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) warp_hist[w][tid] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * kThreads + tid;
    int id = 0;
    int d = kThreads;
    if (i < n) {
      id = idx_in[i];
      d = digit_of(key, seg, use_seg, shift, id);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (d < kThreads && rank == 0) warp_hist[warp][d] = __popc(peers);
    __syncthreads();
    if (d < kThreads) {
      int pos = run[d] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_hist[w][d];
      idx_out[pos] = id;
    }
    __syncthreads();
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      s += warp_hist[w][tid];
      warp_hist[w][tid] = 0;
    }
    run[tid] += s;
    __syncthreads();
  }
}

// flags[perm[p]] = rank of sorted row p in its segment < k
__global__ void keep_kernel(const int* __restrict__ perm,
                            const int* __restrict__ seg, int n, int k,
                            unsigned char* __restrict__ flags) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) {
    const int id = perm[p];
    flags[id] = (p < k || seg[perm[p - k]] != seg[id]) ? 1 : 0;
  }
}

__global__ void flag_count_kernel(const unsigned char* __restrict__ flags,
                                  int n, int* __restrict__ block_counts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = __syncthreads_count(t < n && flags[t]);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

__global__ void gather_kernel(const unsigned char* __restrict__ flags, int n,
                              const int* __restrict__ cand,
                              const int* __restrict__ offsets,
                              int* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int sel = t < n && flags[t];
  const int pos = compact_position<kThreads>(sel, offsets);
  if (sel) out[pos] = cand ? cand[t] : t;
}

}  // namespace

// Prefilter round r over seg i32[n] (dense ids >= 0) and val f64[n]:
// buf_a, buf_b i32[n] hold candidates, status u64[ceil(n / 2048)],
// counter i32 and ctl i32[2 * (r + 2)] are zeroed scratch shared with the
// other rounds (status and counter one per round); `grid` blocks.
extern "C" int arroyo_topk_round(const void* seg, const void* val, int n,
                                 int k, int r, void* buf_a, void* buf_b,
                                 void* status, void* counter, void* ctl,
                                 int grid, void* stream) {
  if (n <= 0 || k <= 0 || r < 0 || grid <= 0) return cudaErrorInvalidValue;
  round_kernel<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), static_cast<const double*>(val), n, k, r,
      static_cast<int*>(buf_a), static_cast<int*>(buf_b),
      static_cast<u64*>(status), static_cast<int*>(counter),
      static_cast<int*>(ctl));
  return static_cast<int>(cudaGetLastError());
}

// Round blocks resident per SM (registers and shared memory decide it):
// the grid of a round is this times the SM count, since a block beyond
// the resident ones finds no tile left when it starts.
extern "C" int arroyo_topk_round_blocks_per_sm(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, round_kernel, kTileThreads, 0));
}

// The final block after R rounds: out i32[min(n, 8192)], info i32[3].
extern "C" int arroyo_topk_final(const void* seg, const void* val, int n,
                                 int k, int R, const void* buf_a,
                                 const void* buf_b, const void* ctl,
                                 void* out, void* info, void* stream) {
  if (n <= 0 || k <= 0 || R < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      final_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFinalSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  final_kernel<<<1, kFinalThreads, kFinalSmem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), static_cast<const double*>(val), n, k, R,
      static_cast<const int*>(buf_a), static_cast<const int*>(buf_b),
      static_cast<const int*>(ctl), static_cast<int*>(out),
      static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}

// The general path's keys over n candidates (rows cand[p], or rows p when
// cand is null): key u64[n], seg_c i32[n] (the candidates' segment ids,
// written only with cand), idx i32[n] (the identity), and ORs into masks
// u64[2], which the caller zeroes.
extern "C" int arroyo_topk_keys(const void* val, const void* seg,
                                const void* cand, int n, void* key,
                                void* seg_c, void* idx, void* masks,
                                void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  key_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const double*>(val), static_cast<const int*>(seg),
      static_cast<const int*>(cand), n, static_cast<u64*>(key),
      static_cast<int*>(seg_c), static_cast<int*>(idx),
      static_cast<u64*>(masks));
  return static_cast<int>(cudaGetLastError());
}

// One stable radix pass over the digit at bit `shift` of the value keys
// (use_seg = 0) or the segment ids (use_seg = 1): idx_in -> idx_out, both
// i32[n].  hist is i32 scratch of 2 * (256 * ntiles) + 1 entries, ntiles =
// ceil(n / 4096).
extern "C" int arroyo_topk_pass(const void* key, const void* seg,
                                int use_seg, int shift, const void* idx_in,
                                int n, void* hist, void* idx_out,
                                void* stream) {
  if (n <= 0) return cudaSuccess;
  if (shift < 0 || shift > 56 || (use_seg && shift > 24))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + kTile - 1) / kTile;
  const int m = kThreads * ntiles;
  int* counts = static_cast<int*>(hist);
  int* offsets = counts + m;
  const auto* k = static_cast<const u64*>(key);
  const auto* s = static_cast<const int*>(seg);
  hist_kernel<<<ntiles, kThreads, 0, st>>>(
      k, s, use_seg, shift, static_cast<const int*>(idx_in), n, ntiles,
      counts);
  exclusive_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, m, offsets);
  scatter_kernel<<<ntiles, kThreads, 0, st>>>(
      k, s, use_seg, shift, static_cast<const int*>(idx_in), n, ntiles,
      offsets, static_cast<int*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}

// Keep flags u8[n] at candidate positions from the sorted order perm
// i32[n], per-block kept counts and their scan: offsets i32[nblocks + 1]
// (offsets[nblocks] = rows kept), block_counts i32[nblocks], nblocks =
// ceil(n / 256).
extern "C" int arroyo_topk_select(const void* perm, const void* seg, int n,
                                  int k, void* flags, void* block_counts,
                                  void* offsets, void* stream) {
  if (n <= 0 || k < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = (n + kThreads - 1) / kThreads;
  auto* f = static_cast<unsigned char*>(flags);
  auto* bc = static_cast<int*>(block_counts);
  keep_kernel<<<nblocks, kThreads, 0, st>>>(
      static_cast<const int*>(perm), static_cast<const int*>(seg), n, k, f);
  flag_count_kernel<<<nblocks, kThreads, 0, st>>>(f, n, bc);
  exclusive_scan_kernel<<<1, kScanThreads, 0, st>>>(
      bc, nblocks, static_cast<int*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// The kept row indices, ascending: out i32[offsets[nblocks]], each kept
// position t mapped to its row cand[t] (or t when cand is null).
extern "C" int arroyo_topk_gather(const void* flags, int n, const void* cand,
                                  const void* offsets, void* out,
                                  void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gather_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const unsigned char*>(flags), n,
      static_cast<const int*>(cand), static_cast<const int*>(offsets),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
