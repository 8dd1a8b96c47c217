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
// and 4 bytes per kept index: 0.002 ms at 599,800 rows.  A sort cannot
// reach that; this one reads each row's key once per radix pass.
//
// What the design does about it: an LSD radix sort, written here, of the
// row indices (the payload; keys are read through them from the key
// planes, which stay in L2 at these sizes).  Eight-bit digits, and only
// the digits that vary: the key kernel ORs every key's difference from
// row 0's into a mask (one for values, one for segment ids) and the
// wrapper reads the two masks back (one sync) and runs a pass for each
// varying digit, value digits low to high, then segment digits.  Counts
// of a few thousand vary in about three value digits, and one segment
// needs no segment pass.  A pass is three launches: per-tile digit
// histograms (warp-aggregated shared atomics), one exclusive scan of the
// digit-major histogram table, and a stable scatter in which each tile
// walks its rows in rounds of 256 and places a row at its digit's running
// offset plus the same digit's count in earlier warps plus its rank among
// equal digits in its warp (__match_any_sync).  Stability makes the index
// the last key.  In sorted order a row is in the top k exactly when the
// row k places earlier lies in another segment (or does not exist), so no
// segment starts are needed.  Keep flags land at each row's original
// position and are compacted in order with per-block counts and a scan.
// A segment holding every row costs the same as many small ones: no part
// of the design works per segment.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block = radix buckets
constexpr int kRounds = 16;    // rounds of kThreads rows per tile
constexpr int kTile = kThreads * kRounds;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned long long order_key(double x) {
  if (isnan(x)) return ~0ull;
  unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(-x));
  if ((b << 1) == 0) b = 0;  // -0.0 -> +0.0
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

// key[i], idx[i] = i and masks[0] |= key[i] ^ key[0],
// masks[1] |= seg[i] ^ seg[0]
__global__ void key_kernel(const double* __restrict__ val,
                           const int* __restrict__ seg, int n,
                           unsigned long long* __restrict__ key,
                           int* __restrict__ idx,
                           unsigned long long* __restrict__ masks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long dk = 0, ds = 0;
  if (i < n) {
    const unsigned long long k = order_key(val[i]);
    key[i] = k;
    idx[i] = i;
    dk = k ^ order_key(val[0]);
    ds = static_cast<unsigned long long>(
        static_cast<unsigned>(seg[i] ^ seg[0]));
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
__device__ __forceinline__ int digit_of(const unsigned long long* key,
                                        const int* seg, int use_seg,
                                        int shift, int id) {
  return use_seg ? ((seg[id] >> shift) & 0xFF)
                 : static_cast<int>((key[id] >> shift) & 0xFF);
}

// hist[d * ntiles + tile] = rows of the tile whose digit is d
__global__ void hist_kernel(const unsigned long long* __restrict__ key,
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
__global__ void scatter_kernel(const unsigned long long* __restrict__ key,
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
                              const int* __restrict__ offsets,
                              int* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int sel = t < n && flags[t];
  const int pos = compact_position<kThreads>(sel, offsets);
  if (sel) out[pos] = t;
}

}  // namespace

// Row keys and the varying-digit masks.  val f64[n], seg i32[n] (dense
// segment ids >= 0); writes key u64[n], idx i32[n] (the identity) and ORs
// into masks u64[2], which the caller zeroes.
extern "C" int arroyo_topk_keys(const void* val, const void* seg, int n,
                                void* key, void* idx, void* masks,
                                void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  key_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const double*>(val), static_cast<const int*>(seg), n,
      static_cast<unsigned long long*>(key), static_cast<int*>(idx),
      static_cast<unsigned long long*>(masks));
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
  const auto* k = static_cast<const unsigned long long*>(key);
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

// Keep flags u8[n] at original positions from the sorted order perm
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

// The kept row indices, ascending: out i32[offsets[nblocks]].
extern "C" int arroyo_topk_gather(const void* flags, int n,
                                  const void* offsets, void* out,
                                  void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gather_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const unsigned char*>(flags), n,
      static_cast<const int*>(offsets), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
