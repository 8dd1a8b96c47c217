// ring_emit: the long-window pane fire — per (key slot, pane) the trailing
// W-bin aggregate of each transferred channel and of the counts plane,
// from one pass over the fire's linear bin span.
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
// the counts, -/+ the largest f64 for max/min), and out[s, p] is the sum
// (add kinds; counts in i64) or the fold (min, max) of x[p .. p + W - 1].
// MIN/MAX fold in XLA's order (jnp.minimum / jnp.maximum): a NaN wins and
// comes out as the canonical quiet NaN, -0.0 is below +0.0.  That order
// is total, so those values do not depend on the grouping; nor do the
// counts and integer-valued sums.  A non-integer f64 sum does, in its
// last bits (see the grouping below; the plain version's cumsum
// difference groups another way).
// Only the first `rows` slots and the k panes are written, into one
// buffer: out f64[n_xfer, rows, k], then cnt[rows, k] in the counts
// dtype (no counts plane: `counts` null).
//
// What bounds it on the H100: memory — each live span cell of a row read
// once, (count itemsize + 8 n_xfer) bytes written a (slot, pane).  A fire
// reads short rows (phase 19's median fire: 201 live cells of 10,004
// rows, 5 planes; a warp has about ten loads to make), so a design has to
// keep its loads in flight and spend few instructions a cell.  A running
// sum over the span (the JAX package's cumsum difference, this kernel's
// first design) costs a 5-step warp scan — 12 shuffles — every 32 cells
// and chains them: that, not the bytes, bound it (2.1 ms at 262,144 rows
// against 0.85).
//
// What the design does about it: panes are taken in groups of at most
// W + 1 consecutive panes (and 512).  Every pane p0 + i of a group of g
// panes holds the middle M = x[p0 + g - 1 .. p0 + W - 1], so
//   pane p0 + i = (H[i] o M) o T[i], H[i] = x[p0 + i .. p0 + g - 2] (the
//   head part), T[i] = x[p0 + W .. p0 + W + i - 1] (the tail part),
// and M is a plain reduction: one warp per (plane, slot), each lane folds
// the cells 32 apart (a lane a position of each 256-byte chunk of the
// row), then one butterfly across the lanes.  Only the head's suffix
// folds and the tail's prefix folds are warp scans, over g - 1 cells
// each: none at k = 1.  The loads of the middle's first 10 chunks (320
// positions: every W = 300 fire's middle) and of the head's and the
// tail's first 2 are all issued before the first fold, so a warp waits
// for memory about once a group.  The group's cells wait in the warp's
// slice of shared memory and leave in one coalesced pass.  MIN/MAX fold
// order keys (a NaN the winning key), so a fold is one integer min or
// max.  An f64 sum groups as ((H + M) + T), M's cells by lane, then the
// butterfly.  A design that stages a tile of rows in shared memory, a
// thread walking a row, is timed against this one by
// tools/ring_emit_variants.
//
// A narrow window (W <= 64: q5's W = 5 fire over 120k slots) has too few
// cells a pane for a warp's group: its loads, butterfly and scans cost
// more than the pane (a W = 37, k = 5 fire took 26 us that way, the
// running sums of the design before it 22).  There a thread owns four
// consecutive panes of a slot and reads their W + 3 cells once, in
// order, folding each into the panes that hold it (the neighbouring
// threads' cells come from the same sectors: L1 serves the repeats); an
// f64 sum is then the sequential sum of the pane.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <type_traits>

#include "pane_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 10;   // middle chunks of 32 a lane loads at once,
constexpr int kEdge = 2;     // and head or tail chunks
constexpr int kCells = 512;  // panes a group, at most
constexpr int kDirectW = 64;  // W up to which a thread folds panes,
constexpr int kPanes = 4;     // this many consecutive ones

// the span relative to first_bin: position j is live when j0 <= j <= j1,
// live position j at ring column (cl + j - j0) mod B, cl the column of
// bin first_bin + j0; L positions
struct Span {
  int cl;
  int j0;
  int j1;
  int L;
};

// an f64 as an i64 in XLA's order for `Kind` (-0.0 below +0.0; a NaN the
// largest key for max, the smallest for min), and back
template <int Kind>
__device__ __forceinline__ long long to_key(double x) {
  if (x != x) return Kind == kMax ? LLONG_MAX : LLONG_MIN;
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
}

template <int Kind>
__device__ __forceinline__ double from_key(long long k) {
  if (k == (Kind == kMax ? LLONG_MAX : LLONG_MIN)) {
    return __longlong_as_double(0x7ff8000000000000LL);  // the quiet NaN
  }
  return __longlong_as_double(k ^ ((k >> 63) & 0x7fffffffffffffffLL));
}

// A plane's reduction: T the cell type, Acc what is folded (the sum, or
// the order key for min and max)
template <int Kind, typename T>
struct Red {
  using Acc = typename std::conditional<
      Kind == kAdd && std::is_floating_point<T>::value, double,
      long long>::type;
  // the neutral element (no cell)
  __device__ static Acc none() {
    if constexpr (Kind == kAdd) {
      return Acc(0);
    } else {
      return Kind == kMax ? LLONG_MIN : LLONG_MAX;
    }
  }
  __device__ static Acc lift(T x) {
    if constexpr (Kind == kAdd) {
      return static_cast<Acc>(x);
    } else {
      return to_key<Kind>(static_cast<double>(x));
    }
  }
  __device__ static Acc op(Acc a, Acc b) {
    if constexpr (Kind == kAdd) {
      return a + b;
    } else {
      return Kind == kMax ? (a > b ? a : b) : (a < b ? a : b);
    }
  }
  __device__ static T lower(Acc a) {
    if constexpr (Kind == kAdd) {
      return static_cast<T>(a);
    } else {
      return from_key<Kind>(a);
    }
  }
};

// the row's cell at span position j folded as Acc, or the identity's
// (`dead`) outside the live range
template <typename R, typename T>
__device__ __forceinline__ typename R::Acc cell_at(const T* __restrict__ row,
                                                   const Span& sp, int j,
                                                   int B,
                                                   typename R::Acc dead) {
  if (j < sp.j0 || j > sp.j1) return dead;
  int col = sp.cl + (j - sp.j0);
  if (col >= B) col -= B;
  return R::lift(row[col]);
}

// One group of g panes from p0 (g <= W + 1) of one row by one warp:
// `cells` the warp's g shared cells, `out` the row's k outputs.  The
// loads of the middle's first kGroup chunks and of the head's and the
// tail's first kEdge chunks are all issued before the first fold.
template <typename R, typename T>
__device__ void fire_group(const T* __restrict__ row, const Span& sp, int B,
                           int W, int p0, int g, typename R::Acc dead,
                           typename R::Acc* cells, T* __restrict__ out,
                           int lane) {
  using Acc = typename R::Acc;
  const int a = p0 + g - 1;  // the middle [a, b]
  const int b = p0 + W - 1;
  const int h0 = p0;  // the head [h0, h1]
  const int h1 = p0 + g - 2;
  const int t0 = p0 + W;  // the tail [t0, t1]
  const int t1 = p0 + W + g - 2;
  Acc xm[kGroup], xh[kEdge], xt[kEdge];
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    const int j = a + 32 * c + lane;
    xm[c] = j <= b ? cell_at<R>(row, sp, j, B, dead) : R::none();
  }
#pragma unroll
  for (int c = 0; c < kEdge; ++c) {
    const int j = h1 - 32 * c - 31 + lane;
    xh[c] = j >= h0 ? cell_at<R>(row, sp, j, B, dead) : R::none();
  }
#pragma unroll
  for (int c = 0; c < kEdge; ++c) {
    const int j = t0 + 32 * c + lane;
    xt[c] = j <= t1 ? cell_at<R>(row, sp, j, B, dead) : R::none();
  }
  // the middle: each lane folds its cells 32 apart in order, then a
  // butterfly
  Acc mid = R::none();
#pragma unroll
  for (int c = 0; c < kGroup; ++c) mid = R::op(mid, xm[c]);
  for (int base0 = a + 32 * kGroup; base0 <= b; base0 += 32 * kGroup) {
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      const int j = base0 + 32 * c + lane;
      xm[c] = j <= b ? cell_at<R>(row, sp, j, B, dead) : R::none();
    }
#pragma unroll
    for (int c = 0; c < kGroup; ++c) mid = R::op(mid, xm[c]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mid = R::op(mid, __shfl_xor_sync(kFull, mid, d));
  }
  // the head: cells[i] = H[i] o M, by suffix folds in chunks from its end
  Acc carry = R::none();  // the fold of the head after this chunk
  for (int c0 = 0; h1 - 32 * c0 >= h0; c0 += kEdge) {
    if (c0 > 0) {
#pragma unroll
      for (int c = 0; c < kEdge; ++c) {
        const int j = h1 - 32 * (c0 + c) - 31 + lane;
        xh[c] = j >= h0 ? cell_at<R>(row, sp, j, B, dead) : R::none();
      }
    }
#pragma unroll
    for (int c = 0; c < kEdge; ++c) {
      const int top = h1 - 32 * (c0 + c);
      if (top < h0) break;  // the whole warp
      Acc suf = xh[c];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Acc y = __shfl_down_sync(kFull, suf, d);
        if (lane + d < 32) suf = R::op(suf, y);
      }
      suf = R::op(suf, carry);
      carry = __shfl_sync(kFull, suf, 0);
      const int j = top - 31 + lane;
      if (j >= h0) cells[j - p0] = R::op(suf, mid);
    }
  }
  if (lane == 0) cells[g - 1] = mid;
  __syncwarp();
  // the tail: cells[i] o= T[i], by prefix folds in chunks from its start
  carry = R::none();  // the fold of the tail before this chunk
  for (int c0 = 0; t0 + 32 * c0 <= t1; c0 += kEdge) {
    if (c0 > 0) {
#pragma unroll
      for (int c = 0; c < kEdge; ++c) {
        const int j = t0 + 32 * (c0 + c) + lane;
        xt[c] = j <= t1 ? cell_at<R>(row, sp, j, B, dead) : R::none();
      }
    }
#pragma unroll
    for (int c = 0; c < kEdge; ++c) {
      const int base = t0 + 32 * (c0 + c);
      if (base > t1) break;  // the whole warp
      Acc pre = xt[c];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Acc y = __shfl_up_sync(kFull, pre, d);
        if (lane >= d) pre = R::op(y, pre);
      }
      pre = R::op(carry, pre);
      carry = __shfl_sync(kFull, pre, 31);
      const int j = base + lane;
      if (j <= t1) {
        const int i = j - t0 + 1;
        cells[i] = R::op(cells[i], pre);
      }
    }
  }
  __syncwarp();
  for (int i = lane; i < g; i += 32) out[p0 + i] = R::lower(cells[i]);
  __syncwarp();  // the cells serve the next group
}

// every group of one row
template <typename R, typename T>
__device__ void fire_row(const T* __restrict__ row, const Span& sp, int B,
                         int W, int k, typename R::Acc dead,
                         unsigned char* smem, T* __restrict__ out,
                         int lane) {
  const int gmax = min(min(k, W + 1), kCells);
  auto* cells =
      reinterpret_cast<typename R::Acc*>(smem) + (threadIdx.x >> 5) * gmax;
  for (int p0 = 0; p0 < k; p0 += gmax) {
    fire_group<R>(row, sp, B, W, p0, min(gmax, k - p0), dead, cells, out,
                  lane);
  }
}

// grid: x over slots (a warp each), y over planes (the transferred
// channels in order, then the counts plane when there is one); dynamic
// shared memory: 8 bytes a cell, min(k, W + 1, kCells) cells a warp
template <typename CountT>
__global__ void __launch_bounds__(kThreads)
    ring_emit_kernel(const double* __restrict__ values,
                     const CountT* __restrict__ counts, XferSpec spec,
                     Span sp, int C, int B, int W, int k, int rows,
                     double* __restrict__ out, CountT* __restrict__ out_cnt) {
  extern __shared__ __align__(16) unsigned char s_cells[];
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= rows) return;  // the whole warp
  const int r = blockIdx.y;
  const long long row = static_cast<long long>(s) * B;
  const long long cell = static_cast<long long>(s) * k;
  if (r == spec.n) {  // the counts plane: exact in i64
    using R = Red<kAdd, CountT>;
    fire_row<R>(counts + row, sp, B, W, k, R::none(), s_cells,
                out_cnt + cell, lane);
    return;
  }
  const double* plane =
      values + static_cast<long long>(spec.ch[r]) * C * B + row;
  double* o = out + static_cast<long long>(r) * rows * k + cell;
  const int kind = spec.kind[r];
  if (kind == kAdd) {
    fire_row<Red<kAdd, double>>(plane, sp, B, W, k, 0.0, s_cells, o,
                                   lane);
  } else if (kind == kMax) {
    fire_row<Red<kMax, double>>(plane, sp, B, W, k,
                                   to_key<kMax>(-DBL_MAX), s_cells, o, lane);
  } else {
    fire_row<Red<kMin, double>>(plane, sp, B, W, k,
                                   to_key<kMin>(DBL_MAX), s_cells, o, lane);
  }
}

// Up to kPanes consecutive panes p0 .. p0 + np - 1 of one row folded by
// one thread: each cell of their span read once and folded into every
// pane that holds it, so each pane takes its W cells in order from the
// identity.
template <typename R, typename T>
__device__ __forceinline__ void fold_panes(const T* __restrict__ row,
                                           const Span& sp, int B, int W,
                                           int p0, int np,
                                           typename R::Acc dead,
                                           T* __restrict__ out) {
  typename R::Acc acc[kPanes];
#pragma unroll
  for (int i = 0; i < kPanes; ++i) acc[i] = R::none();
  for (int j = 0; j < W + np - 1; ++j) {
    const typename R::Acc x = cell_at<R>(row, sp, p0 + j, B, dead);
#pragma unroll
    for (int i = 0; i < kPanes; ++i) {
      if (i < np && j >= i && j < i + W) acc[i] = R::op(acc[i], x);
    }
  }
#pragma unroll
  for (int i = 0; i < kPanes; ++i) {
    if (i < np) out[i] = R::lower(acc[i]);
  }
}

// grid: x over (slot, group of kPanes panes), a thread each, y over
// planes as above; no shared memory
template <typename CountT>
__global__ void __launch_bounds__(kThreads)
    ring_emit_direct(const double* __restrict__ values,
                     const CountT* __restrict__ counts, XferSpec spec,
                     Span sp, int C, int B, int W, int k, int rows,
                     double* __restrict__ out, CountT* __restrict__ out_cnt) {
  const int per_row = (k + kPanes - 1) / kPanes;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(rows) * per_row) return;
  const int s = static_cast<int>(t / per_row);
  const int p0 = static_cast<int>(t - static_cast<long long>(s) * per_row) *
                 kPanes;
  const int np = min(kPanes, k - p0);
  const int r = blockIdx.y;
  const long long row = static_cast<long long>(s) * B;
  const long long cell = static_cast<long long>(s) * k + p0;
  if (r == spec.n) {
    using R = Red<kAdd, CountT>;
    fold_panes<R>(counts + row, sp, B, W, p0, np, R::none(), out_cnt + cell);
    return;
  }
  const double* plane =
      values + static_cast<long long>(spec.ch[r]) * C * B + row;
  double* o = out + static_cast<long long>(r) * rows * k + cell;
  const int kind = spec.kind[r];
  if (kind == kAdd) {
    fold_panes<Red<kAdd, double>>(plane, sp, B, W, p0, np, 0.0, o);
  } else if (kind == kMax) {
    fold_panes<Red<kMax, double>>(plane, sp, B, W, p0, np,
                                  to_key<kMax>(-DBL_MAX), o);
  } else {
    fold_panes<Red<kMin, double>>(plane, sp, B, W, p0, np,
                                  to_key<kMin>(DBL_MAX), o);
  }
}

long long clamp_ll(long long x, long long a, long long b) {
  return x < a ? a : (x > b ? b : x);
}

long long mod_ll(long long x, long long m) { return ((x % m) + m) % m; }

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
  if (L > 0x7fffffffLL - 32 * kGroup) return cudaErrorInvalidValue;
  const long long j0 = clamp_ll(lo - first_bin, 0, L);
  const long long j1 = clamp_ll(hi - first_bin, -1, L - 1);
  if (j1 - j0 >= B) return cudaErrorInvalidValue;  // live bins alias
  const Span sp{static_cast<int>(mod_ll(first_bin + j0, B)),
                static_cast<int>(j0), static_cast<int>(j1),
                static_cast<int>(L)};
  double* out_f = static_cast<double*>(out);
  void* out_cnt = out_f + static_cast<long long>(xs->n) * rows * k;
  const dim3 grid((rows + kWarps - 1) / kWarps, planes);
  const long long gmax = std::min<long long>(
      std::min<long long>(k, static_cast<long long>(W) + 1), kCells);
  const size_t smem = static_cast<size_t>(kWarps) * gmax * 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* v = static_cast<const double*>(values);
  if (W <= kDirectW) {
    const long long n = static_cast<long long>(rows) * ((k + kPanes - 1) /
                                                        kPanes);
    const dim3 dgrid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                     planes);
    if (counts_i64) {
      ring_emit_direct<long long><<<dgrid, kThreads, 0, st>>>(
          v, static_cast<const long long*>(counts), *xs, sp, C, B, W, k, rows,
          out_f, static_cast<long long*>(out_cnt));
    } else {
      ring_emit_direct<int><<<dgrid, kThreads, 0, st>>>(
          v, static_cast<const int*>(counts), *xs, sp, C, B, W, k, rows,
          out_f, static_cast<int*>(out_cnt));
    }
  } else if (counts_i64) {
    ring_emit_kernel<long long><<<grid, kThreads, smem, st>>>(
        v, static_cast<const long long*>(counts), *xs, sp, C, B, W, k, rows,
        out_f, static_cast<long long*>(out_cnt));
  } else {
    ring_emit_kernel<int><<<grid, kThreads, smem, st>>>(
        v, static_cast<const int*>(counts), *xs, sp, C, B, W, k, rows, out_f,
        static_cast<int*>(out_cnt));
  }
  return static_cast<int>(cudaGetLastError());
}
