// pane_emit: the dense pane fire — per (key slot, pane) the pane's row
// count and, for each transferred channel, its aggregate over the pane's
// ring bins.
//
// Replaces arroyo_tpu/ops/keyed_bins.py:123 `_emit_kernel` together with
// the channel reduction it shares with the compact branch, :109
// `_pane_reduce`.
//
// The fire's geometry comes as scalars, not as ring arrays: pane p's bin
// w is the absolute bin first_bin + p + w (p < k, w < W), live when
// lo <= bin <= hi, at ring column bin mod B.  Semantics, for s < c_slice:
//   cnt[s, p]    = sum_w  live ? counts[s, bin mod B] : 0
//   out[r, s, p] = fold_w live ? values[ch_r, s, bin mod B] : identity
// with the bins folded in ascending w (pane_reduce.cuh: kind add onto
// 0.0, min and max onto +/- the largest f64), so a dense and a compact
// fire emit bit-equal values.  Only the first c_slice slots and the k
// real panes are written, into one buffer: out f64[n_xfer, c_slice, k],
// then cnt[c_slice, k] in the counts dtype.
//
// What bounds it on the H100: memory.  Each slot's row is read at the
// 32-byte sectors that hold live columns, and (count itemsize + 8 n_xfer)
// bytes are written a (slot, pane).  At q8's fire (W = 1, k = 1, i32 rows
// of 32 B) that is a sector read and 4 bytes written a slot.
//
// What the design does about it: one thread per (slot, pane), the pane
// fastest, which folds its pane's live bins in the counts plane and then
// in each transferred channel's plane.  The k threads of a slot are
// neighbours in a warp, so a warp's loads fall in 32 / k rows and its
// stores are coalesced runs; a row's sectors come from memory once and
// the slot's other panes find them in L1.  The thread derives its bins
// from the scalars once: no ring or flag array is read, and the host
// copies none to the card.  (One thread per slot and plane folding all k
// panes from its row in registers, or from a shared-memory tile, ties at
// k = 1 and loses at k > 1 on the H100, as does a grid row a plane:
// arroyo_tpu_torch/tools/pane_emit_variants.py.)

#include <cuda_runtime.h>

#include "pane_reduce.cuh"

namespace {

constexpr int kThreads = 256;

// the fire relative to its first bin: bin first_bin + j sits at ring
// column (c0 + j) mod B and is live when j0 <= j <= j1
struct Fire {
  int c0;
  int j0;
  int j1;
};

// the fold of one row's live bins of a pane, in ascending w: `n` bins
// from ring column `col`
template <typename T, typename Fold>
__device__ __forceinline__ T fold_bins(const T* __restrict__ row, int col,
                                       int n, int B, T acc, Fold fold) {
  for (int w = 0; w < n; ++w) {
    acc = fold(acc, row[col]);
    col = col + 1 == B ? 0 : col + 1;
  }
  return acc;
}

template <typename CountT>
__global__ void __launch_bounds__(kThreads)
    pane_emit_kernel(const double* __restrict__ values,
                     const CountT* __restrict__ counts, XferSpec spec,
                     Fire f, int C, int B, int W, int k, int c_slice,
                     double* __restrict__ out, CountT* __restrict__ out_cnt) {
  const long long n_out = static_cast<long long>(c_slice) * k;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n_out) return;
  const long long s = i / k;
  const int p = static_cast<int>(i - s * k);
  // pane p's live bins: w in [wlo, whi]
  const int wlo = f.j0 - p > 0 ? f.j0 - p : 0;
  const int whi = f.j1 - p < W - 1 ? f.j1 - p : W - 1;
  const int n = whi - wlo + 1;
  const int col = (f.c0 + p + wlo) % B;
  const long long row = s * B;
  const auto add = [](CountT a, CountT x) { return a + x; };
  out_cnt[i] = fold_bins(counts + row, col, n, B, CountT(0), add);
  const long long plane = static_cast<long long>(C) * B;
  for (int r = 0; r < spec.n; ++r) {
    const int kind = spec.kind[r];
    const auto fold = [kind](double a, double x) {
      return kind_fold(kind, a, x);
    };
    out[r * n_out + i] = fold_bins(values + spec.ch[r] * plane + row, col, n,
                                   B, kind_identity(kind), fold);
  }
}

long long clamp_ll(long long x, long long a, long long b) {
  return x < a ? a : (x > b ? b : x);
}

}  // namespace

// values f64[n_ch, C, B], counts i32|i64[C, B] (counts_i64 says which),
// spec a HOST XferSpec (the channel read for each output row and its
// reduction).  The fire: panes p < k of W bins, pane p's bin w the
// absolute bin first_bin + p + w, live when lo <= bin <= hi (at most B
// live bins).  Writes `out`, one buffer: f64[n_xfer, c_slice, k] then
// cnt[c_slice, k] in the counts dtype.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int arroyo_pane_emit(const void* values, const void* counts,
                                int counts_i64, const void* spec, int C,
                                int B, long long first_bin, long long lo,
                                long long hi, int W, int k, int c_slice,
                                void* out, void* stream) {
  const XferSpec* xs = static_cast<const XferSpec*>(spec);
  if (xs->n < 0 || xs->n > kMaxChannels || c_slice < 0 || c_slice > C ||
      k < 0 || W < 1 || B < 1)
    return cudaErrorInvalidValue;
  const long long n_out = static_cast<long long>(c_slice) * k;
  if (n_out == 0) return cudaSuccess;
  const long long last = static_cast<long long>(k) + W - 2;  // the last j
  const long long j0 = clamp_ll(lo - first_bin, 0, last + 1);
  const long long j1 = clamp_ll(hi - first_bin, -1, last);
  if (j1 - j0 >= B) return cudaErrorInvalidValue;  // live bins alias
  const Fire f{static_cast<int>(((first_bin % B) + B) % B),
               static_cast<int>(j0), static_cast<int>(j1)};
  double* out_f = static_cast<double*>(out);
  void* out_cnt = out_f + xs->n * n_out;
  const unsigned blocks =
      static_cast<unsigned>((n_out + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* v = static_cast<const double*>(values);
  if (counts_i64) {
    pane_emit_kernel<long long><<<blocks, kThreads, 0, st>>>(
        v, static_cast<const long long*>(counts), *xs, f, C, B, W, k, c_slice,
        out_f, static_cast<long long*>(out_cnt));
  } else {
    pane_emit_kernel<int><<<blocks, kThreads, 0, st>>>(
        v, static_cast<const int*>(counts), *xs, f, C, B, W, k, c_slice,
        out_f, static_cast<int*>(out_cnt));
  }
  return static_cast<int>(cudaGetLastError());
}
