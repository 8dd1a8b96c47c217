// ring_emit: the long-window pane fire — per (key slot, pane) the trailing
// W-bin aggregate of each transferred channel and of the counts plane,
// from one sweep over the fire's linear bin span.
//
// Replaces arroyo_tpu/ops/keyed_bins.py:242 `_linearize_kernel` together
// with arroyo_tpu/parallel/ring_panes.py:106 `_ring_step_2d` (and, at one
// row, :39 `_ring_step`), which `KeyedBinState._emit_ring` runs one after
// the other: the first materializes the span [n_ch, C, L] from the
// modular ring, the second sweeps all L positions of each channel, and
// the caller keeps the last k.
//
// The fire's geometry comes as scalars, as in pane_emit.cu: span position
// j < L = k + W - 1 is the absolute bin first_bin + j, live when
// lo <= bin <= hi, at ring column bin mod B; pane p < k covers positions
// p .. p + W - 1.  For s < rows, a plane's x[j] is its cell at that
// column when j is live, else its identity (0 for the additive kinds and
// the counts, -/+ the largest f64 for max/min), and:
//   add kinds:  P[j] = x[0] + ... + x[j] (counts in i64), and
//               out[s, p] = P[p + W - 1] - P[p - 1] with P[-1] = 0 — the
//               cumsum difference of `_ring_step_2d`; an f64 P is summed
//               in chunks of 32 (a warp scan on the previous chunk's
//               total), so a non-integer sum differs from a sequential
//               one in its last bits;
//   min, max:   out[s, p] = the fold of x[p .. p + W - 1], in XLA's order
//               (jnp.minimum / jnp.maximum): a NaN wins, -0.0 is below
//               +0.0.  That order is total, so the value does not depend
//               on how the fold is grouped; the sweep groups it as van
//               Herk does (blocks of W from j = 0: the suffix folds of a
//               block, then the prefix folds of the next).
// Only the first `rows` slots and the k panes are written, into one
// buffer: out f64[n_xfer, rows, k], then cnt[rows, k] in the counts
// dtype (no counts plane: `counts` null).
//
// What bounds it on the H100: memory — each live span cell of a row read
// once, (count itemsize + 8 n_xfer) bytes written a (slot, pane).  The
// sweep itself is O(L) a row against O(k W) for pane_emit's fold a pane.
//
// What the design does about it: one warp per (plane, slot) walks its
// row's span in chunks of 32 positions, a lane a position, so each load
// instruction reads 256 contiguous bytes of one row (a thread a row
// would touch 32 rows' sectors per load).  A chunk's running sums and
// folds are warp scans (shuffles) on top of the previous chunk's carry;
// dead positions are not read.  A pane's P[p - 1] waits in its own output
// cell until P[p + W - 1] arrives, and van Herk's suffix folds wait there
// for the next block's prefix folds.

#include <cuda_runtime.h>

#include <cmath>

#include "pane_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// the span relative to first_bin: position j sits at ring column
// (c0 + j) mod B and is live when j0 <= j <= j1; L positions
struct Span {
  int c0;
  int j0;
  int j1;
  int L;
};

// the row's cell at span position j, or `dead` outside the live range
template <typename T>
__device__ __forceinline__ T span_at(const T* __restrict__ row,
                                     const Span& sp, int j, int B, T dead) {
  if (j < sp.j0 || j > sp.j1) return dead;
  int col = sp.c0 + j;
  if (col >= B) col %= B;
  return row[col];
}

// an f64 as an i64 in the same order, -0.0 below +0.0
__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
}

// one step of min or max in XLA's order: a NaN wins, -0.0 < +0.0
__device__ __forceinline__ double ext_fold(bool is_max, double acc,
                                           double x) {
  if (acc != acc) return acc;
  if (x != x) return x;
  const long long a = order_key(acc);
  const long long b = order_key(x);
  return (is_max ? b > a : b < a) ? x : acc;
}

// the sum of lanes 0 .. lane
template <typename T>
__device__ __forceinline__ T warp_prefix_sum(T x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// the fold of lanes 0 .. lane
__device__ __forceinline__ double warp_prefix_fold(bool is_max, double x,
                                                   int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const double y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = ext_fold(is_max, y, x);
  }
  return x;
}

// the fold of lanes lane .. 31
__device__ __forceinline__ double warp_suffix_fold(bool is_max, double x,
                                                   int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const double y = __shfl_down_sync(kFull, x, d);
    if (lane + d < 32) x = ext_fold(is_max, x, y);
  }
  return x;
}

// the additive sweep of one row by one warp: `row` its B cells, `out` its
// k panes
template <typename T, typename Acc>
__device__ void sweep_add(const T* __restrict__ row, const Span& sp, int B,
                          int W, int k, T* __restrict__ out, int lane) {
  Acc carry = Acc(0);
  for (int base = 0; base < sp.L; base += 32) {
    const int j = base + lane;
    const Acc x = j < sp.L ? static_cast<Acc>(span_at(row, sp, j, B, T(0)))
                           : Acc(0);
    const Acc prefix = carry + warp_prefix_sum(x, lane);  // P[j]
    carry = __shfl_sync(kFull, prefix, 31);
    // P[j] is the head that pane j + 1 subtracts: keep it in its cell
    if (j + 1 < k) out[j + 1] = static_cast<T>(prefix);
    __syncwarp();
    const int p = j - (W - 1);  // the pane that ends at j
    if (j < sp.L && p >= 0) {
      const Acc head = p > 0 ? static_cast<Acc>(out[p]) : Acc(0);
      out[p] = static_cast<T>(prefix - head);
    }
    __syncwarp();
  }
}

// the min / max sweep of one row by one warp (van Herk, blocks of W from
// j = 0)
__device__ void sweep_ext(const double* __restrict__ row, const Span& sp,
                          int B, int W, int k, bool is_max, double ident,
                          double* __restrict__ out, int lane) {
  const double none = is_max ? -INFINITY : INFINITY;  // neutral: no value
  for (int b0 = 0; b0 < k; b0 += W) {
    // the suffix folds of the block [b0, b0 + W - 1], which lies inside
    // the span (b0 + W - 1 <= k + W - 2), in chunks from its end: pane
    // p's head part
    double carry = none;  // the fold of the block after this chunk
    for (int top = b0 + W - 1; top >= b0; top -= 32) {
      const int j = top - 31 + lane;
      const double x = j >= b0 ? span_at(row, sp, j, B, ident) : none;
      const double suf = ext_fold(is_max, warp_suffix_fold(is_max, x, lane),
                                  carry);
      carry = __shfl_sync(kFull, suf, 0);
      if (j >= b0 && j < k) out[j] = suf;
    }
    __syncwarp();
    // the prefix folds of the next block: pane p = j - W + 1's tail part
    carry = none;
    const int stop = min(b0 + 2 * W - 2, sp.L - 1);
    for (int base = b0 + W; base <= stop; base += 32) {
      const int j = base + lane;
      const double x = j <= stop ? span_at(row, sp, j, B, ident) : none;
      const double pre = ext_fold(is_max, carry,
                                  warp_prefix_fold(is_max, x, lane));
      carry = __shfl_sync(kFull, pre, 31);
      if (j <= stop) {
        const int p = j - W + 1;
        out[p] = ext_fold(is_max, out[p], pre);
      }
    }
    __syncwarp();
  }
}

// grid: x over slots (a warp each), y over planes (the transferred
// channels in order, then the counts plane when there is one)
template <typename CountT>
__global__ void __launch_bounds__(kThreads)
    ring_emit_kernel(const double* __restrict__ values,
                     const CountT* __restrict__ counts, XferSpec spec,
                     Span sp, int C, int B, int W, int k, int rows,
                     double* __restrict__ out, CountT* __restrict__ out_cnt) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= rows) return;  // the whole warp
  const int r = blockIdx.y;
  const long long row = static_cast<long long>(s) * B;
  const long long cell = static_cast<long long>(s) * k;
  if (r == spec.n) {  // the counts plane: exact in i64
    sweep_add<CountT, long long>(counts + row, sp, B, W, k, out_cnt + cell,
                                 lane);
    return;
  }
  const double* plane =
      values + static_cast<long long>(spec.ch[r]) * C * B + row;
  double* o = out + static_cast<long long>(r) * rows * k + cell;
  const int kind = spec.kind[r];
  if (kind == kAdd) {
    sweep_add<double, double>(plane, sp, B, W, k, o, lane);
  } else {
    sweep_ext(plane, sp, B, W, k, kind == kMax, kind_identity(kind), o,
              lane);
  }
}

long long clamp_ll(long long x, long long a, long long b) {
  return x < a ? a : (x > b ? b : x);
}

}  // namespace

// values f64[n_ch, C, B], counts i32|i64[C, B] (counts_i64 says which) or
// null for no counts plane, spec a HOST XferSpec (the channel read for
// each output row and its reduction).  The fire: panes p < k of W bins,
// pane p's bin w the absolute bin first_bin + p + w, live when
// lo <= bin <= hi (at most B live bins).  Writes `out`, one buffer:
// f64[n_xfer, rows, k] then, with counts, cnt[rows, k] in the counts
// dtype.  Launches on `stream`; returns cudaGetLastError().
extern "C" int arroyo_ring_emit(const void* values, const void* counts,
                                int counts_i64, const void* spec, int C,
                                int B, long long first_bin, long long lo,
                                long long hi, int W, int k, int rows,
                                void* out, void* stream) {
  const XferSpec* xs = static_cast<const XferSpec*>(spec);
  if (xs->n < 0 || xs->n > kMaxChannels || rows < 0 || rows > C || k < 0 ||
      W < 1 || B < 1)
    return cudaErrorInvalidValue;
  const int planes = xs->n + (counts != nullptr);
  if (static_cast<long long>(rows) * k == 0 || planes == 0)
    return cudaSuccess;
  const long long L = static_cast<long long>(k) + W - 1;
  if (L > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long j0 = clamp_ll(lo - first_bin, 0, L);
  const long long j1 = clamp_ll(hi - first_bin, -1, L - 1);
  if (j1 - j0 >= B) return cudaErrorInvalidValue;  // live bins alias
  const Span sp{static_cast<int>(((first_bin % B) + B) % B),
                static_cast<int>(j0), static_cast<int>(j1),
                static_cast<int>(L)};
  double* out_f = static_cast<double*>(out);
  void* out_cnt = out_f + static_cast<long long>(xs->n) * rows * k;
  const dim3 grid((rows + kWarps - 1) / kWarps, planes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* v = static_cast<const double*>(values);
  if (counts_i64) {
    ring_emit_kernel<long long><<<grid, kThreads, 0, st>>>(
        v, static_cast<const long long*>(counts), *xs, sp, C, B, W, k, rows,
        out_f, static_cast<long long*>(out_cnt));
  } else {
    ring_emit_kernel<int><<<grid, kThreads, 0, st>>>(
        v, static_cast<const int*>(counts), *xs, sp, C, B, W, k, rows,
        out_f, static_cast<int*>(out_cnt));
  }
  return static_cast<int>(cudaGetLastError());
}
