// bin_update: scatter pre-aggregated (slot, bin) cells into the keyed
// bin ring, in place.
//
// Replaces arroyo_tpu/ops/keyed_bins.py:62 `_update_kernel` (the XLA
// scatter) and arroyo_tpu/ops/pallas_kernels.py:77 `_scatter_kernel`
// (the TPU's one-hot MXU form of the same additive update, reached via
// `update_bin_state`, pallas_kernels.py:212).
//
// Semantics (keyed_bins.py:67-104): for cell i with slot s, bin b and
// rowcount rc:
//   * rc <= 0.5 (padding) or s/b outside the planes: the cell is skipped,
//     never clipped into a real cell;
//   * counts[s, b] += (CountT)rc;
//   * channel j takes rc itself when it is a COUNT(*) channel (bit j of
//     `dup`), else the next transferred row, and adds it (sum/avg/count),
//     or reduces it with min (bit j of `mn`) or max (bit j of `mx`), into
//     values[j, s, b].  MIN/MAX order -0.0 below +0.0, as XLA does.
//
// The cells arrive as ONE i64 buffer [2 + n_xfer, m] (the caller's one
// upload): row 0 holds i32 slots[m] then i32 bins[m], row 1 the f64
// rowcounts, rows 2.. the transferred channels' f64 values.
//
// What bounds it on the H100: memory.  Each cell reads 8 B of indices and
// 8 B per f64 row, and read-modify-writes 8 B per channel plus 4/8 B of
// counts at a scattered address; there are no operations to speak of.
// At nexmark q5's flushes of up to 65,536 cells the call moves about a
// megabyte, so the launch, not the bandwidth, sets its time.
//
// What the design does about it: one thread per cell, one launch per
// flush, the channel plan as three 64-bit masks passed by value (no
// per-call host arrays, no struct).  A warp reads each row of the buffer
// as one coalesced run.  Duplicate cells stay exact without sorting:
// sums use the f64 atomicAdd, whose result is unused (a fire-and-forget
// reduction), counts a 32- or 64-bit atomicAdd, and MIN/MAX at most one
// integer atomic on the f64 bit pattern: a value with the sign bit clear
// orders like its bits as a signed integer (atomicMax / atomicMin), one
// with the sign bit set in reverse of its bits as an unsigned integer
// (atomicMin / atomicMax), and either kind of value compares right
// against the other under both.  A plain read first skips the atomic
// when the cell already holds a value at least as good, as a CAS loop
// does: without it, flushes whose cells repeat issue an atomic for every
// MIN/MAX value and ran slower than a CAS loop (PERF.md §6).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// An f64 as an integer key in the same order, -0.0 below +0.0.
__device__ __forceinline__ long long order_key(long long bits) {
  return bits ^ ((bits >> 63) & 0x7fffffffffffffffll);
}

// A cell under MIN only ever falls during a launch, so a value read from
// it at any moment is at or above its value now: when that read is
// already at or below v, v changes nothing and no atomic is issued.
__device__ __forceinline__ void atomic_min_f64(double* addr, double v) {
  const long long bits = __double_as_longlong(v);
  if (order_key(*reinterpret_cast<const long long*>(addr)) <=
      order_key(bits)) {
    return;
  }
  if (bits >= 0) {
    atomicMin(reinterpret_cast<long long*>(addr), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned long long*>(addr),
              static_cast<unsigned long long>(bits));
  }
}

__device__ __forceinline__ void atomic_max_f64(double* addr, double v) {
  const long long bits = __double_as_longlong(v);
  if (order_key(*reinterpret_cast<const long long*>(addr)) >=
      order_key(bits)) {
    return;
  }
  if (bits >= 0) {
    atomicMax(reinterpret_cast<long long*>(addr), bits);
  } else {
    atomicMin(reinterpret_cast<unsigned long long*>(addr),
              static_cast<unsigned long long>(bits));
  }
}

__device__ __forceinline__ void add_count(int* p, double rc) {
  atomicAdd(p, static_cast<int>(rc));
}

__device__ __forceinline__ void add_count(long long* p, double rc) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(static_cast<long long>(rc)));
}

template <typename CountT>
__global__ void __launch_bounds__(kThreads)
    bin_update_kernel(double* __restrict__ values,
                      CountT* __restrict__ counts,
                      const long long* __restrict__ cells, long long m,
                      int C, int B, int n_ch, unsigned long long dup,
                      unsigned long long mn, unsigned long long mx) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int* idx = reinterpret_cast<const int*>(cells);
  const double* rows = reinterpret_cast<const double*>(cells + m);
  const int s = __ldg(idx + i);
  const int b = __ldg(idx + m + i);
  const double rc = __ldg(rows + i);
  if (!(rc > 0.5) || s < 0 || s >= C || b < 0 || b >= B) return;
  const long long cell = static_cast<long long>(s) * B + b;
  add_count(counts + cell, rc);
  const long long plane = static_cast<long long>(C) * B;
  const double* src = rows + m + i;  // the next transferred row's value
  for (int j = 0; j < n_ch; ++j) {
    const unsigned long long bit = 1ull << j;
    double x = rc;
    if (!(dup & bit)) {
      x = __ldg(src);
      src += m;
    }
    double* dst = values + j * plane + cell;
    if (mn & bit) {
      atomic_min_f64(dst, x);
    } else if (mx & bit) {
      atomic_max_f64(dst, x);
    } else {
      atomicAdd(dst, x);
    }
  }
}

}  // namespace

// values f64[n_ch, C, B], counts i32|i64[C, B] (both updated in place),
// cells i64[2 + n_xfer, m] as above; `dup`, `mn`, `mx` the channel plan's
// masks (n_ch <= 64; n_xfer = n_ch - popcount(dup)).  One launch on
// `stream`; returns cudaGetLastError().
extern "C" int arroyo_bin_update(void* values, void* counts, int counts_i64,
                                 const void* cells, long long m, int C,
                                 int B, int n_ch, unsigned long long dup,
                                 unsigned long long mn, unsigned long long mx,
                                 void* stream) {
  if (n_ch < 0 || n_ch > 64 || m < 0 || C < 0 || B < 0)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const long long*>(cells);
  if (counts_i64) {
    bin_update_kernel<long long><<<static_cast<unsigned>(blocks), kThreads,
                                   0, st>>>(
        static_cast<double*>(values), static_cast<long long*>(counts), c, m,
        C, B, n_ch, dup, mn, mx);
  } else {
    bin_update_kernel<int><<<static_cast<unsigned>(blocks), kThreads, 0,
                             st>>>(
        static_cast<double*>(values), static_cast<int*>(counts), c, m, C, B,
        n_ch, dup, mn, mx);
  }
  return static_cast<int>(cudaGetLastError());
}
