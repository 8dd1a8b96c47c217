// argmax_fire: candidate-only pane emission for nexmark q5's hot-items
// shape — the (key, pane) cells whose pane count equals their pane's
// extremum, compacted in row-major [C, kpad] order.
//
// Replaces arroyo_tpu/ops/keyed_bins.py:157 `_argmax_nnz_kernel` (pane
// counts, per-pane extremum, candidate mask and total) and :180
// `_argmax_gather_kernel` (`jnp.nonzero(..., size=npad)` compaction).
//
// Semantics: cnt[c, p] = sum_w bin_ok[p, w] ? counts[c, ring[p, w]] : 0;
// ext[p] = max_c cnt[c, p] (for 'min': the min over cnt > 0); selected
// cells are (cnt == ext[p]) & (cnt > 0), emitted as (key_idx, pane_idx)
// i32 pairs plus their counts, in ascending flat index c * kpad + p —
// exactly the order jnp.nonzero gives, never atomic-arrival order.
//
// What bounds it on the H100: memory, and below that the launches.  A fire
// reads C * kpad * W counts and writes and re-reads the C * kpad pane
// counts: about 2.6 MB for a one-pane fire at C = 131072, under a
// microsecond of HBM time, so the four launches and the one host sync for
// the candidate total dominate.
//
// What the design does about it: four small launches and one scalar
// readback, the same single sync the JAX version makes.  (1) one block per
// (key tile, pane) sums the pane's bins and folds a block-reduced extremum
// into ext[p] with one atomic per block; (2) per-block candidate counts;
// (3) one block scans them into output offsets and the total; the wrapper
// reads the total and sizes the outputs; (4) each block recomputes its
// candidates and writes them at offset + ballot rank, which keeps
// row-major order.  Fusing the phases into one persistent kernel is later
// work.

#include <cuda_runtime.h>

#include <climits>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;  // must match kernels/argmax_fire.py THREADS

template <typename T>
__device__ __forceinline__ T type_max();
template <>
__device__ __forceinline__ int type_max<int>() { return INT_MAX; }
template <>
__device__ __forceinline__ long long type_max<long long>() { return LLONG_MAX; }

template <typename T>
__device__ __forceinline__ T pick(T a, T b, int is_max) {
  return is_max ? (a > b ? a : b) : (a < b ? a : b);
}

template <typename T>
__device__ T block_reduce(T v, int is_max) {
  __shared__ T partial[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    v = pick(v, __shfl_down_sync(0xffffffffu, v, off), is_max);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? partial[lane] : partial[0];
    for (int off = 16; off > 0; off >>= 1) {
      v = pick(v, __shfl_down_sync(0xffffffffu, v, off), is_max);
    }
  }
  return v;
}

// grid (ceil(C / kThreads), kpad): block (x, p) covers keys of tile x in
// pane p
template <typename T>
__global__ void pane_counts_kernel(const T* __restrict__ counts,
                                   const int* __restrict__ ring,
                                   const unsigned char* __restrict__ ok,
                                   int C, int B, int W, int kpad, int is_max,
                                   T* __restrict__ cnt, T* __restrict__ ext) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  T acc = 0;
  if (c < C) {
    const T* row = counts + static_cast<long long>(c) * B;
    for (int w = 0; w < W; ++w) {
      if (ok[p * W + w]) acc += row[ring[p * W + w]];
    }
    cnt[static_cast<long long>(c) * kpad + p] = acc;
  }
  // counts are >= 0 and ext starts at 0 for max; min ignores empty cells
  T v = is_max ? acc : ((c < C && acc > 0) ? acc : type_max<T>());
  v = block_reduce(v, is_max);
  if (threadIdx.x == 0) {
    if (is_max) {
      atomicMax(ext + p, v);
    } else {
      atomicMin(ext + p, v);
    }
  }
}

template <typename T>
__device__ __forceinline__ int selected(const T* cnt, const T* ext,
                                        long long t, long long total,
                                        int kpad, T* v) {
  if (t >= total) return 0;
  *v = cnt[t];
  return (*v > 0) && (*v == ext[t % kpad]);
}

template <typename T>
__global__ void select_count_kernel(const T* __restrict__ cnt,
                                    const T* __restrict__ ext,
                                    long long total, int kpad,
                                    int* __restrict__ block_counts) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  T v = 0;
  const int n = __syncthreads_count(selected(cnt, ext, t, total, kpad, &v));
  if (threadIdx.x == 0) block_counts[blockIdx.x] = n;
}

template <typename T>
__global__ void gather_kernel(const T* __restrict__ cnt,
                              const T* __restrict__ ext, long long total,
                              int kpad, const int* __restrict__ offsets,
                              int nnz, int* __restrict__ idx2,
                              T* __restrict__ out_cnt) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  T v = 0;
  const int sel = selected(cnt, ext, t, total, kpad, &v);
  const int pos = compact_position<kThreads>(sel, offsets);
  if (!sel) return;
  idx2[pos] = static_cast<int>(t / kpad);
  idx2[nnz + pos] = static_cast<int>(t % kpad);
  out_cnt[pos] = v;
}

template <typename T>
int launch_count(const void* counts, const void* ring, const void* ok, int C,
                 int B, int W, int kpad, int is_max, void* cnt, void* ext,
                 void* block_counts, void* offsets, cudaStream_t st) {
  const long long total = static_cast<long long>(C) * kpad;
  const int nblocks = static_cast<int>((total + kThreads - 1) / kThreads);
  dim3 grid((C + kThreads - 1) / kThreads, kpad);
  pane_counts_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(counts), static_cast<const int*>(ring),
      static_cast<const unsigned char*>(ok), C, B, W, kpad, is_max,
      static_cast<T*>(cnt), static_cast<T*>(ext));
  select_count_kernel<T><<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(cnt), static_cast<const T*>(ext), total, kpad,
      static_cast<int*>(block_counts));
  exclusive_scan_kernel<<<1, kScanThreads, 0, st>>>(
      static_cast<const int*>(block_counts), nblocks,
      static_cast<int*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather(const void* cnt, const void* ext, int C, int kpad,
                  const void* offsets, int nnz, void* idx2, void* out_cnt,
                  cudaStream_t st) {
  const long long total = static_cast<long long>(C) * kpad;
  const int nblocks = static_cast<int>((total + kThreads - 1) / kThreads);
  gather_kernel<T><<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(cnt), static_cast<const T*>(ext), total, kpad,
      static_cast<const int*>(offsets), nnz, static_cast<int*>(idx2),
      static_cast<T*>(out_cnt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Phases 1-3.  counts i32|i64[C, B], ring i32[kpad, W], ok u8[kpad, W];
// scratch: cnt[C * kpad] and ext[kpad] of the counts type (ext pre-filled
// by the caller: 0 for max, the type's max for min), block_counts
// i32[nblocks], offsets i32[nblocks + 1] with nblocks =
// ceil(C * kpad / 256).  offsets[nblocks] ends up holding the total.
extern "C" int arroyo_argmax_count(const void* counts, int counts_i64,
                                   const void* ring, const void* ok, int C,
                                   int B, int W, int kpad, int is_max,
                                   void* cnt, void* ext, void* block_counts,
                                   void* offsets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 0 || kpad <= 0 || kpad > 65535) return cudaErrorInvalidValue;
  return counts_i64
      ? launch_count<long long>(counts, ring, ok, C, B, W, kpad, is_max, cnt,
                                ext, block_counts, offsets, st)
      : launch_count<int>(counts, ring, ok, C, B, W, kpad, is_max, cnt, ext,
                          block_counts, offsets, st);
}

// Phase 4: idx2 i32[2, nnz] (key_idx row, pane_idx row), out_cnt[nnz].
extern "C" int arroyo_argmax_gather(const void* cnt, int counts_i64,
                                    const void* ext, int C, int kpad,
                                    const void* offsets, int nnz, void* idx2,
                                    void* out_cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nnz <= 0) return cudaSuccess;
  return counts_i64
      ? launch_gather<long long>(cnt, ext, C, kpad, offsets, nnz, idx2,
                                 out_cnt, st)
      : launch_gather<int>(cnt, ext, C, kpad, offsets, nnz, idx2, out_cnt,
                           st);
}
