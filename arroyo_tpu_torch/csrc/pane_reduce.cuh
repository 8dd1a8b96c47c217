// The reduction of one channel over a pane's ring bins, shared by the
// dense (pane_emit.cu) and compact (emit_compact.cu) pane fires so the
// two branches fold in one order and emit bit-equal sums — the port of
// arroyo_tpu/ops/keyed_bins.py:109 `_pane_reduce`.  The compact fire
// calls `pane_reduce` on its ring arrays; the dense fire folds the same
// bins in the same order with `kind_identity` and `kind_fold`.
//
// For the bins w = 0..W-1 of pane p with ok[p, w] set, in that order:
// kind add (sum/avg/count channels) adds onto 0.0, min and max fold onto
// +/- the largest f64 (the channels' identities).

#pragma once

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kMaxChannels = 64;

enum Kind : int { kAdd = 0, kMin = 1, kMax = 2 };

// the transferred channels of a dense fire (pane_emit.cu): the channel
// read for each output row and its reduction, passed by value
struct XferSpec {
  int n;
  int ch[kMaxChannels];
  int kind[kMaxChannels];
};

// the channel's identity: the value a pane with no live bin emits
__device__ __forceinline__ double kind_identity(int kind) {
  return kind == kMin ? DBL_MAX : (kind == kMax ? -DBL_MAX : 0.0);
}

// one step of the reduction: acc (+ | min | max) x
__device__ __forceinline__ double kind_fold(int kind, double acc, double x) {
  if (kind == kAdd) return acc + x;
  if (kind == kMin) return x < acc ? x : acc;
  return x > acc ? x : acc;
}

// `row` points at the slot's B bins of the channel; pr/po at pane p's W
// ring indices and ok flags
__device__ __forceinline__ double pane_reduce(const double* __restrict__ row,
                                              const int* __restrict__ pr,
                                              const bool* __restrict__ po,
                                              int W, int kind) {
  double acc = kind_identity(kind);
  for (int w = 0; w < W; ++w) {
    if (po[w]) acc = kind_fold(kind, acc, row[pr[w]]);
  }
  return acc;
}

}  // namespace
