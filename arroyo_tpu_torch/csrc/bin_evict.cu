// bin_evict: reset expired ring columns of the keyed bin ring, in place —
// counts to 0 and every channel to its aggregation identity.
//
// Replaces arroyo_tpu/ops/keyed_bins.py:262 `_evict_kernel` (which builds
// a [B] column mask and rewrites both planes whole through jnp.where).
//
// Semantics: the expired columns are e <= B consecutive ring columns
// c0, c0 + 1, ... (mod B) — the absolute bins a fire expires are
// consecutive.  For each of them and every slot s < rows:
// counts[s, col] = 0 and values[j, s, col] = init[j] for each channel j.
// Slots at and past `rows` are not written: the caller passes its
// occupied slots, past which every cell already holds its identity.
//
// What bounds it on the H100: memory — pure stores.  Each plane row of an
// occupied slot gets e cells written, which touch the row's 32-byte
// sectors that hold expired columns.  Evicting one column of q8's person
// state (i32 rows of 32 B, f64 rows of 64 B) writes part of one sector of
// each row: two sectors a slot.
//
// What the design does about it: no reads at all, no column list in
// device memory (the columns and the identities come by value in the
// launch), only the occupied slots, and one thread per (slot, expired
// column) of one plane (a grid row a plane), the column fastest: the e
// cells of a row are neighbouring threads, so a warp's stores cover
// 32 / e rows with e contiguous cells each (one cell of 32 rows at
// e = 1).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 64;
constexpr int kThreads = 256;

struct InitSpec {
  int n;
  double init[kMaxChannels];
};

// blockIdx.y picks the plane: 0 the counts, 1 + j channel j
template <typename CountT>
__global__ void __launch_bounds__(kThreads)
    bin_evict_kernel(double* __restrict__ values, CountT* __restrict__ counts,
                     InitSpec spec, int C, int B, int rows, int c0, int e) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(rows) * e) return;
  const long long s = i / e;
  const int col = c0 + static_cast<int>(i - s * e);
  const long long cell = s * B + (col < B ? col : col - B);
  const int plane = blockIdx.y;
  if (plane == 0) {
    counts[cell] = 0;
  } else {
    values[(plane - 1) * (static_cast<long long>(C) * B) + cell] =
        spec.init[plane - 1];
  }
}

}  // namespace

// values f64[n_ch, C, B] and counts i32|i64[C, B] (both updated in place;
// counts_i64 says which); the e ring columns c0, c0 + 1, ... (mod B) of
// the first `rows` slots are reset; inits is a HOST array of n_ch
// identities.  Launches on `stream`; returns cudaGetLastError().
extern "C" int arroyo_bin_evict(void* values, void* counts, int counts_i64,
                                const double* inits, int n_ch, int C, int B,
                                int rows, int c0, int e, void* stream) {
  if (n_ch < 0 || n_ch > kMaxChannels || rows < 0 || rows > C || B < 1 ||
      c0 < 0 || c0 >= B || e < 0 || e > B)
    return cudaErrorInvalidValue;
  if (rows == 0 || e == 0) return cudaSuccess;
  InitSpec spec;
  spec.n = n_ch;
  for (int j = 0; j < n_ch; ++j) spec.init[j] = inits[j];
  const long long n = static_cast<long long>(rows) * e;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(1 + n_ch));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* v = static_cast<double*>(values);
  if (counts_i64) {
    bin_evict_kernel<long long><<<grid, kThreads, 0, st>>>(
        v, static_cast<long long*>(counts), spec, C, B, rows, c0, e);
  } else {
    bin_evict_kernel<int><<<grid, kThreads, 0, st>>>(
        v, static_cast<int*>(counts), spec, C, B, rows, c0, e);
  }
  return static_cast<int>(cudaGetLastError());
}
