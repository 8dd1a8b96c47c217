// mesh_remap: re-lay a key shard's bin planes — every row from a source
// row, every column from a shifted source column, one gather of all
// planes into new planes.
//
// Replaces arroyo_tpu/parallel/mesh_window.py:376 `_roll_step` (shift the
// linear bin axis left, fill the tail with the identity) and the re-layout
// half of :119 `_update_step` (:222-241: old rows scattered to their
// merged slots), and serves the shard's ring growth, rebase and capacity
// growth (:542-618), which the JAX package does on the host.
//
// Semantics, for r < C_out, c < B_out, with sr = src[r] (src null: sr = r
// when r < C_in, else -1) and sc = c + shift:
//   ok             = 0 <= sr < C_in and 0 <= sc < B_in
//   counts'[r, c]  = ok ? counts[sr, sc] : 0
//   values'[j,r,c] = ok ? values[j, sr, sc] : init[j]
// The counts keep their type (i32 or i64).  With src the merge's inverse
// map and shift 0 it is the update's re-layout; with src null it is the
// roll (shift > 0), the rebase (shift < 0, B_out > B_in), the ring growth
// (B_out > B_in) and the capacity growth (C_out > C_in).
//
// What bounds it on the H100: memory — every output cell written once and
// read from its source once: (1 + n_ch) planes of C_out x B_out cells,
// 8 bytes a value and 4 or 8 a count, each way.
//
// What the design does about it: one thread per output cell of one plane
// (a grid row a plane), the column fastest, so a warp writes 32
// consecutive cells and reads a run of its source row; the identities
// come by value in the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 64;
constexpr int kThreads = 256;

struct InitSpec {
  double init[kMaxChannels];
};

template <typename CountT>
__global__ void __launch_bounds__(kThreads)
    mesh_remap_kernel(const double* __restrict__ vin,
                      const CountT* __restrict__ cin,
                      const long long* __restrict__ src, int C_in, int B_in,
                      int C_out, int B_out, int shift, InitSpec spec,
                      double* __restrict__ v_out, CountT* __restrict__ c_out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long cells = static_cast<long long>(C_out) * B_out;
  if (i >= cells) return;
  const long long r = i / B_out;
  const int c = static_cast<int>(i - r * B_out);
  const long long sr = src != nullptr ? src[r] : (r < C_in ? r : -1);
  const long long sc = static_cast<long long>(c) + shift;
  const bool ok = sr >= 0 && sr < C_in && sc >= 0 && sc < B_in;
  const long long from = sr * B_in + sc;
  const int plane = blockIdx.y;
  if (plane == 0) {
    c_out[i] = ok ? cin[from] : CountT(0);
  } else {
    const long long in_plane = static_cast<long long>(C_in) * B_in;
    v_out[(plane - 1) * cells + i] =
        ok ? vin[(plane - 1) * in_plane + from] : spec.init[plane - 1];
  }
}

}  // namespace

// values f64[n_ch, C_in, B_in] and counts i32|i64[C_in, B_in] (counts_i64
// says which) into v_out f64[n_ch, C_out, B_out] and c_out[C_out, B_out];
// src i64[C_out] or null; inits a HOST array of n_ch identities.  One
// launch on `stream`; returns cudaGetLastError().
extern "C" int arroyo_mesh_remap(const void* values, const void* counts,
                                 int counts_i64, const void* src,
                                 const double* inits, int n_ch, int C_in,
                                 int B_in, int C_out, int B_out, int shift,
                                 void* v_out, void* c_out, void* stream) {
  if (n_ch < 0 || n_ch > kMaxChannels || C_in < 0 || B_in < 1 ||
      C_out < 0 || B_out < 1)
    return cudaErrorInvalidValue;
  const long long cells = static_cast<long long>(C_out) * B_out;
  if (cells == 0) return cudaSuccess;
  InitSpec spec;
  for (int j = 0; j < n_ch; ++j) spec.init[j] = inits[j];
  const dim3 grid(static_cast<unsigned>((cells + kThreads - 1) / kThreads),
                  static_cast<unsigned>(1 + n_ch));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* s = static_cast<const long long*>(src);
  if (counts_i64) {
    mesh_remap_kernel<long long><<<grid, kThreads, 0, st>>>(
        static_cast<const double*>(values),
        static_cast<const long long*>(counts), s, C_in, B_in, C_out, B_out,
        shift, spec, static_cast<double*>(v_out),
        static_cast<long long*>(c_out));
  } else {
    mesh_remap_kernel<int><<<grid, kThreads, 0, st>>>(
        static_cast<const double*>(values), static_cast<const int*>(counts),
        s, C_in, B_in, C_out, B_out, shift, spec, static_cast<double*>(v_out),
        static_cast<int*>(c_out));
  }
  return static_cast<int>(cudaGetLastError());
}
