// pane_emit: the dense pane fire — per (key slot, pane) the pane's row
// count and, for each transferred channel, its aggregate over the pane's
// ring bins.
//
// Replaces arroyo_tpu/ops/keyed_bins.py:123 `_emit_kernel` together with
// the channel reduction it shares with the compact branch, :109
// `_pane_reduce`.
//
// Semantics, for s < c_slice and p < k:
//   cnt[s, p]     = sum_w  ok[p, w] ? counts[s, ring[p, w]] : 0
//   out[r, s, p]  = reduce_w ok[p, w] ? values[ch_r, s, ring[p, w]] : ident
// where channel ch_r of kind sum/avg/count adds (identity 0), min takes the
// minimum (identity +f64 max) and max the maximum (identity -f64 max).
// Only the first c_slice slots and the k real panes are written, so the
// readback is exactly what the host flattens.
//
// What bounds it on the H100: memory.  Each output element reads W count
// cells and W cells per channel and writes one count and one f64 per
// channel; there is one add or compare per cell read.  At nexmark q8's
// shape (W = 1, k = 1, c_slice up to 2^20, COUNT(*) only) the fire reads
// 4 MB of counts and writes 4 MB, about 2.5 us of HBM time.
//
// What the design does about it: one thread per output element, pane
// index fastest, so the threads of a warp walk neighbouring slots and the
// W (<= a handful) bins of one slot sit in one 32-64 byte row.  Channels
// are reduced one after another so no per-channel register array is
// needed at any channel count.  Staging rows through shared memory is
// later work.

#include <cuda_runtime.h>

#include "pane_reduce.cuh"

namespace {

constexpr int kThreads = 256;

template <typename CountT>
__global__ void pane_emit_kernel(const double* __restrict__ values,
                                 const CountT* __restrict__ counts,
                                 const int* __restrict__ ring,
                                 const bool* __restrict__ ok, XferSpec spec,
                                 int C, int B, int W, int k, int c_slice,
                                 double* __restrict__ out,
                                 CountT* __restrict__ out_cnt) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long n_out = static_cast<long long>(c_slice) * k;
  if (i >= n_out) return;
  const int s = static_cast<int>(i / k);
  const int p = static_cast<int>(i - static_cast<long long>(s) * k);
  const long long row = static_cast<long long>(s) * B;
  const int* pr = ring + static_cast<long long>(p) * W;
  const bool* po = ok + static_cast<long long>(p) * W;

  CountT cnt = 0;
  for (int w = 0; w < W; ++w) {
    if (po[w]) cnt += counts[row + pr[w]];
  }
  out_cnt[i] = cnt;

  const long long plane = static_cast<long long>(C) * B;
  for (int r = 0; r < spec.n; ++r) {
    out[static_cast<long long>(r) * n_out + i] =
        pane_reduce(values + spec.ch[r] * plane + row, pr, po, W, spec.kind[r]);
  }
}

}  // namespace

// values f64[n_ch, C, B], counts i32|i64[C, B], ring i32[k, W] (entries in
// [0, B)), ok bool[k, W]; chans/kinds are HOST arrays of n_xfer ints (the
// channel read for each output row and its reduction).  Writes out
// f64[n_xfer, c_slice, k] and out_cnt[c_slice, k] (the counts dtype).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int arroyo_pane_emit(const void* values, const void* counts,
                                int counts_i64, const void* ring,
                                const void* ok, const int* chans,
                                const int* kinds, int n_xfer, int C, int B,
                                int W, int k, int c_slice, void* out,
                                void* out_cnt, void* stream) {
  XferSpec spec;
  if (!make_spec(chans, kinds, n_xfer, &spec) || c_slice > C)
    return cudaErrorInvalidValue;
  const long long n_out = static_cast<long long>(c_slice) * k;
  if (n_out <= 0) return cudaSuccess;
  const unsigned blocks =
      static_cast<unsigned>((n_out + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (counts_i64) {
    pane_emit_kernel<long long><<<blocks, kThreads, 0, st>>>(
        static_cast<const double*>(values),
        static_cast<const long long*>(counts), static_cast<const int*>(ring),
        static_cast<const bool*>(ok), spec, C, B, W, k, c_slice,
        static_cast<double*>(out), static_cast<long long*>(out_cnt));
  } else {
    pane_emit_kernel<int><<<blocks, kThreads, 0, st>>>(
        static_cast<const double*>(values), static_cast<const int*>(counts),
        static_cast<const int*>(ring), static_cast<const bool*>(ok), spec, C,
        B, W, k, c_slice, static_cast<double*>(out),
        static_cast<int*>(out_cnt));
  }
  return static_cast<int>(cudaGetLastError());
}
