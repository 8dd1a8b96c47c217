// emit_compact: the compact pane fire — only the live (slot, pane) cells
// of a fire, in row-major [rows, k] order, with their row counts and each
// transferred channel's pane aggregate.
//
// Replaces arroyo_tpu/ops/keyed_bins.py:198 `_emit_count_kernel` (pane
// counts and the live total) with the count call, and :213
// `_emit_compact_kernel` (`jnp.nonzero` of the counts, then the channels'
// `_pane_reduce` gathered at the live cells) with the gather call.
//
// Semantics, for s < rows and p < k, t = s * k + p:
//   cnt[t] = sum_w ok[p, w] ? counts[s, ring[p, w]] : 0
// and, for the live cells (cnt[t] > 0) in ascending t, at output position
// j: idx2[0, j] = s, idx2[1, j] = p, out_cnt[j] = cnt[t], out[r, j] = the
// pane reduction of channel ch_r (pane_reduce.cuh, the dense fire's).
//
// What bounds it on the H100: memory.  The count call reads the W live
// count columns of `rows` slots and writes the pane counts (4-8 bytes a
// cell); the gather call re-reads those and, per live cell, the W bins of
// each transferred channel, and writes 8 + 4-8 + 8 * n_xfer bytes.
//
// What the design does about it: the [channels, C, k] grid of the dense
// fire is never written — channels are reduced only at live cells, and
// the outputs are sized to the live total (read back once, the sync the
// JAX version makes), not to a power-of-two bucket.  Order: the count
// kernel's blocks of 256 cells record their live counts, one block scans
// them, and each live cell lands at its block's offset plus its ballot
// rank (block_scan.cuh), so rows come out in np.nonzero's order.

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "pane_reduce.cuh"

namespace {

constexpr int kThreads = 256;  // must match kernels/emit_compact.py THREADS

template <typename CountT>
__global__ void count_kernel(const CountT* __restrict__ counts,
                             const int* __restrict__ ring,
                             const bool* __restrict__ ok, int B, int W,
                             int k, long long total,
                             CountT* __restrict__ cnt,
                             int* __restrict__ block_counts) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  CountT c = 0;
  if (t < total) {
    const long long s = t / k;
    const int p = static_cast<int>(t - s * k);
    const CountT* row = counts + s * B;
    const int* pr = ring + static_cast<long long>(p) * W;
    const bool* po = ok + static_cast<long long>(p) * W;
    for (int w = 0; w < W; ++w) {
      if (po[w]) c += row[pr[w]];
    }
    cnt[t] = c;
  }
  const int live = __syncthreads_count(c > 0);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = live;
}

template <typename CountT>
__global__ void gather_kernel(const double* __restrict__ values,
                              const CountT* __restrict__ cnt,
                              const int* __restrict__ ring,
                              const bool* __restrict__ ok, XferSpec spec,
                              int C, int B, int W, int k, long long total,
                              const int* __restrict__ offsets, int nnz,
                              int* __restrict__ idx2,
                              CountT* __restrict__ out_cnt,
                              double* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const CountT c = t < total ? cnt[t] : 0;
  const int live = c > 0;
  const int pos = compact_position<kThreads>(live, offsets);
  if (!live) return;
  const long long s = t / k;
  const int p = static_cast<int>(t - s * k);
  idx2[pos] = static_cast<int>(s);
  idx2[nnz + pos] = p;
  out_cnt[pos] = c;
  const long long plane = static_cast<long long>(C) * B;
  const int* pr = ring + static_cast<long long>(p) * W;
  const bool* po = ok + static_cast<long long>(p) * W;
  for (int r = 0; r < spec.n; ++r) {
    out[static_cast<long long>(r) * nnz + pos] = pane_reduce(
        values + spec.ch[r] * plane + s * B, pr, po, W, spec.kind[r]);
  }
}

}  // namespace

// Count call.  counts i32|i64[C, B], ring i32[k, W], ok bool[k, W], over
// the first `rows` slots; writes cnt[rows * k] (the counts dtype),
// block_counts i32[nblocks] and offsets i32[nblocks + 1] with nblocks =
// ceil(rows * k / 256); offsets[nblocks] is the live total.
extern "C" int arroyo_emit_count(const void* counts, int counts_i64,
                                 const void* ring, const void* ok, int B,
                                 int W, int k, int rows, void* cnt,
                                 void* block_counts, void* offsets,
                                 void* stream) {
  if (rows <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(rows) * k;
  const int nblocks = static_cast<int>((total + kThreads - 1) / kThreads);
  auto* bc = static_cast<int*>(block_counts);
  if (counts_i64) {
    count_kernel<long long><<<nblocks, kThreads, 0, st>>>(
        static_cast<const long long*>(counts), static_cast<const int*>(ring),
        static_cast<const bool*>(ok), B, W, k, total,
        static_cast<long long*>(cnt), bc);
  } else {
    count_kernel<int><<<nblocks, kThreads, 0, st>>>(
        static_cast<const int*>(counts), static_cast<const int*>(ring),
        static_cast<const bool*>(ok), B, W, k, total, static_cast<int*>(cnt),
        bc);
  }
  exclusive_scan_kernel<<<1, kScanThreads, 0, st>>>(
      bc, nblocks, static_cast<int*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// Gather call.  values f64[n_ch, C, B]; cnt and offsets from the count
// call; chans/kinds are HOST arrays of n_xfer ints.  Writes idx2 i32[2,
// nnz], out_cnt[nnz] (the counts dtype) and out f64[n_xfer, nnz].
extern "C" int arroyo_emit_gather(const void* values, const void* cnt,
                                  int counts_i64, const void* ring,
                                  const void* ok, const int* chans,
                                  const int* kinds, int n_xfer, int C, int B,
                                  int W, int k, int rows, const void* offsets,
                                  int nnz, void* idx2, void* out_cnt,
                                  void* out, void* stream) {
  XferSpec spec;
  if (!make_spec(chans, kinds, n_xfer, &spec) || rows > C || k <= 0)
    return cudaErrorInvalidValue;
  if (nnz <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(rows) * k;
  const int nblocks = static_cast<int>((total + kThreads - 1) / kThreads);
  if (counts_i64) {
    gather_kernel<long long><<<nblocks, kThreads, 0, st>>>(
        static_cast<const double*>(values),
        static_cast<const long long*>(cnt), static_cast<const int*>(ring),
        static_cast<const bool*>(ok), spec, C, B, W, k, total,
        static_cast<const int*>(offsets), nnz, static_cast<int*>(idx2),
        static_cast<long long*>(out_cnt), static_cast<double*>(out));
  } else {
    gather_kernel<int><<<nblocks, kThreads, 0, st>>>(
        static_cast<const double*>(values), static_cast<const int*>(cnt),
        static_cast<const int*>(ring), static_cast<const bool*>(ok), spec, C,
        B, W, k, total, static_cast<const int*>(offsets), nnz,
        static_cast<int*>(idx2), static_cast<int*>(out_cnt),
        static_cast<double*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
