// Three designs of the dense pane fire that csrc/pane_emit.cu does not
// use, kept to be measured against it (pane_emit_variants.py).  They take
// the geometry of csrc/pane_emit.cu (cell j is the absolute bin
// first_bin + j at ring column (c0 + j) mod B, live when j0 <= j <= j1;
// pane p folds cells p .. p + W - 1), emit the same buffer, bit for bit,
// and run a grid row a plane (the counts, or one transferred channel).
// Variants 1 and 2 run one thread per (slot, plane) folding every pane:
//   variant 1, registers: the thread loads its row's 16-byte chunks that
//     hold live cells once into registers (fires of at most 32 cells),
//     folds pane p from cells by compile-time index, shifting the cells
//     down a place a pane;
//   variant 2, tile: the block loads its rows' live 16-byte chunks with
//     neighbouring threads on neighbouring chunks into a shared-memory
//     tile of odd pitch, then each thread folds its row's panes from it.
// Both stage a block's [slots, k] results in shared memory for k > 1 so
// the stores are coalesced.  Variant 3 runs csrc/pane_emit.cu's thread
// per (slot, pane), the pane fastest, for one plane.  B must be a multiple
// of 4, the planes 16-byte aligned, k at most 23.

#include <cuda_runtime.h>

#include <cstring>

#include "../csrc/pane_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 23;
constexpr int kTileChunks = 10;  // live 16-byte chunks a row, at most

struct Fire {
  int c0;
  int n;
  int j0;
  int j1;
};

__device__ __forceinline__ void pane_bins(const Fire& f, int p, int W,
                                          int* wlo, int* whi) {
  *wlo = f.j0 - p > 0 ? f.j0 - p : 0;
  *whi = f.j1 - p < W - 1 ? f.j1 - p : W - 1;
}

template <typename T>
__device__ __forceinline__ void flush_tile(T* __restrict__ out, const T* stage,
                                           int s0, int n_here, int k) {
  __syncthreads();
  T* dst = out + static_cast<long long>(s0) * k;
  for (int i = threadIdx.x; i < n_here * k; i += kThreads) {
    const int slot = i / k;
    dst[i] = stage[slot * (k + 1) + (i - slot * k)];
  }
}

template <typename T, int N>
__device__ __forceinline__ void shift_down(T (&cell)[N]) {
#pragma unroll
  for (int i = 0; i + 1 < N; ++i) cell[i] = cell[i + 1];
}

// variant 1: the row's live chunks in registers (kSpan >= n cells)
template <int kSpan, typename T, typename Fold>
__device__ __forceinline__ void registers_plane(const T* __restrict__ plane,
                                                T* __restrict__ out,
                                                char* smem, const Fire& f,
                                                T start, Fold fold, int B,
                                                int W, int k, int c_slice) {
  constexpr int V = 16 / sizeof(T);
  constexpr int N = kSpan + V;
  T* stage = reinterpret_cast<T*>(smem);
  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kThreads;
  const int s = s0 + t;
  const bool active = s < c_slice;
  const int off = f.c0 % V;
  const uint4* chunks =
      reinterpret_cast<const uint4*>(plane + static_cast<long long>(s) * B);
  T cell[N];
  int q_at = f.c0 / V;
#pragma unroll
  for (int q = 0; q < N / V; ++q) {
    T x[V] = {};
    if (active && q * V - off <= f.j1 && q * V - off + V - 1 >= f.j0) {
      const uint4 v = __ldg(chunks + q_at);
      memcpy(x, &v, sizeof(v));
    }
#pragma unroll
    for (int u = 0; u < V; ++u) cell[q * V + u] = x[u];
    q_at = q_at + 1 == B / V ? 0 : q_at + 1;
  }
  for (int i = 0; i < off; ++i) shift_down(cell);  // cell[j]: bin j
  for (int p = 0; p < k; ++p) {
    int wlo, whi;
    pane_bins(f, p, W, &wlo, &whi);
    T acc = start;
#pragma unroll
    for (int w = 0; w < kSpan; ++w) {
      if (w > whi) break;
      if (w >= wlo) acc = fold(acc, cell[w]);
    }
    if (k == 1) {
      if (active) out[s] = acc;
    } else {
      stage[t * (k + 1) + p] = acc;
    }
    if (p + 1 < k) shift_down(cell);  // cell[w]: bin p + 1 + w
  }
  if (k > 1)
    flush_tile(out, stage, s0,
               c_slice - s0 < kThreads ? c_slice - s0 : kThreads, k);
}

// variant 2: the block's live chunks in a shared-memory tile
template <typename T, typename Fold>
__device__ __forceinline__ void tile_plane(const T* __restrict__ plane,
                                           T* __restrict__ out, char* smem,
                                           const Fire& f, T start, Fold fold,
                                           int B, int W, int k,
                                           int c_slice) {
  constexpr int V = 16 / sizeof(T);
  constexpr int P = kTileChunks * V + 1;  // odd pitch: no bank conflicts
  T* tile = reinterpret_cast<T*>(smem);
  T* stage = tile + kThreads * P;
  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kThreads;
  const int n_here = c_slice - s0 < kThreads ? c_slice - s0 : kThreads;
  const int off = f.c0 % V;
  const int qa = (f.j0 + off) / V;
  const int nq = f.j1 >= f.j0 ? (f.j1 + off) / V - qa + 1 : 0;
  const int rowq = B / V;
  const uint4* base =
      reinterpret_cast<const uint4*>(plane + static_cast<long long>(s0) * B);
  for (int idx = t; idx < n_here * nq; idx += kThreads) {
    const int r = idx / nq;
    const int q = qa + (idx - r * nq);
    const uint4 v =
        __ldg(base + static_cast<long long>(r) * rowq + (f.c0 / V + q) % rowq);
    T x[V];
    memcpy(x, &v, sizeof(v));
#pragma unroll
    for (int u = 0; u < V; ++u) tile[r * P + (q - qa) * V + u] = x[u];
  }
  __syncthreads();
  const T* mine = tile + t * P + off - qa * V;  // mine[j]: cell j
  for (int p = 0; p < k; ++p) {
    int wlo, whi;
    pane_bins(f, p, W, &wlo, &whi);
    T acc = start;
    for (int w = wlo; w <= whi; ++w) acc = fold(acc, mine[p + w]);
    if (k == 1) {
      if (t < n_here) out[s0 + t] = acc;
    } else {
      stage[t * (k + 1) + p] = acc;
    }
  }
  if (k > 1) flush_tile(out, stage, s0, n_here, k);
}

// variant 3: one thread per (slot, pane) of the plane
template <typename T, typename Fold>
__device__ __forceinline__ void pane_plane(const T* __restrict__ plane,
                                           T* __restrict__ out, const Fire& f,
                                           T start, Fold fold, int B, int W,
                                           int k, int c_slice) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(c_slice) * k) return;
  const long long s = i / k;
  const int p = static_cast<int>(i - s * k);
  int wlo, whi;
  pane_bins(f, p, W, &wlo, &whi);
  const T* row = plane + s * B;
  T acc = start;
  int col = (f.c0 + p + wlo) % B;
  for (int w = wlo; w <= whi; ++w) {
    acc = fold(acc, row[col]);
    col = col + 1 == B ? 0 : col + 1;
  }
  out[i] = acc;
}

template <typename CountT, int kVariant, int kSpan>
__global__ void __launch_bounds__(kThreads)
    variant_kernel(const double* __restrict__ values,
                   const CountT* __restrict__ counts, XferSpec spec, Fire f,
                   int C, int B, int W, int k, int c_slice,
                   double* __restrict__ out, CountT* __restrict__ out_cnt) {
  extern __shared__ __align__(16) char smem[];
  if (blockIdx.y == 0) {
    const auto add = [](CountT a, CountT x) { return a + x; };
    if constexpr (kVariant == 1)
      registers_plane<kSpan>(counts, out_cnt, smem, f, CountT(0), add, B, W,
                             k, c_slice);
    else if constexpr (kVariant == 2)
      tile_plane(counts, out_cnt, smem, f, CountT(0), add, B, W, k, c_slice);
    else
      pane_plane(counts, out_cnt, f, CountT(0), add, B, W, k, c_slice);
    return;
  }
  const int r = blockIdx.y - 1;
  const int kind = spec.kind[r];
  const auto fold = [kind](double a, double x) {
    return kind_fold(kind, a, x);
  };
  const double* plane = values + spec.ch[r] * (static_cast<long long>(C) * B);
  double* o = out + r * (static_cast<long long>(c_slice) * k);
  if constexpr (kVariant == 1)
    registers_plane<kSpan>(plane, o, smem, f, kind_identity(kind), fold, B,
                           W, k, c_slice);
  else if constexpr (kVariant == 2)
    tile_plane(plane, o, smem, f, kind_identity(kind), fold, B, W, k,
               c_slice);
  else
    pane_plane(plane, o, f, kind_identity(kind), fold, B, W, k, c_slice);
}

template <typename CountT, int kVariant, int kSpan>
int launch(const double* v, const void* counts, const XferSpec& xs,
           const Fire& f, int C, int B, int W, int k, int c_slice,
           double* out_f, void* out_cnt, cudaStream_t st) {
  const size_t stage =
      k > 1 && kVariant != 3 ? sizeof(double) * kThreads * (k + 1) : 0;
  const size_t smem =
      stage + (kVariant == 2 ? sizeof(double) * kThreads *
                                   (kTileChunks * 2 + 1)
                             : 0);
  auto kernel = variant_kernel<CountT, kVariant, kSpan>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const long long threads =
      kVariant == 3 ? static_cast<long long>(c_slice) * k : c_slice;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(1 + xs.n));
  kernel<<<grid, kThreads, smem, st>>>(v, static_cast<const CountT*>(counts),
                                       xs, f, C, B, W, k, c_slice, out_f,
                                       static_cast<CountT*>(out_cnt));
  return static_cast<int>(cudaGetLastError());
}

long long clamp_ll(long long x, long long a, long long b) {
  return x < a ? a : (x > b ? b : x);
}

}  // namespace

// arroyo_pane_emit's arguments (csrc/pane_emit.cu), the variant first
extern "C" int pane_emit_variant(int variant, const void* values,
                                 const void* counts, int counts_i64,
                                 const void* spec, int C, int B,
                                 long long first_bin, long long lo,
                                 long long hi, int W, int k, int c_slice,
                                 void* out, void* stream) {
  const XferSpec* xs = static_cast<const XferSpec*>(spec);
  const long long n = static_cast<long long>(k) + W - 1;
  if (variant < 1 || variant > 3 || B % 4 != 0 || k < 1 || k > kMaxK ||
      n > 32 || c_slice < 1 || c_slice > C)
    return cudaErrorInvalidValue;
  const long long j0 = clamp_ll(lo - first_bin, 0, n);
  const long long j1 = clamp_ll(hi - first_bin, -1, n - 1);
  if (variant == 2 && j1 >= j0 && (j1 - j0) / 2 + 2 > kTileChunks)
    return cudaErrorInvalidValue;
  const Fire f{static_cast<int>(((first_bin % B) + B) % B),
               static_cast<int>(n), static_cast<int>(j0),
               static_cast<int>(j1)};
  double* out_f = static_cast<double*>(out);
  void* out_cnt = out_f + xs->n * static_cast<long long>(c_slice) * k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* v = static_cast<const double*>(values);
#define VARIANT_ARGS v, counts, *xs, f, C, B, W, k, c_slice, out_f, out_cnt, st
  if (variant == 2)
    return counts_i64 ? launch<long long, 2, 0>(VARIANT_ARGS)
                      : launch<int, 2, 0>(VARIANT_ARGS);
  if (variant == 3)
    return counts_i64 ? launch<long long, 3, 0>(VARIANT_ARGS)
                      : launch<int, 3, 0>(VARIANT_ARGS);
  if (n <= 8)
    return counts_i64 ? launch<long long, 1, 8>(VARIANT_ARGS)
                      : launch<int, 1, 8>(VARIANT_ARGS);
  if (n <= 16)
    return counts_i64 ? launch<long long, 1, 16>(VARIANT_ARGS)
                      : launch<int, 1, 16>(VARIANT_ARGS);
  return counts_i64 ? launch<long long, 1, 32>(VARIANT_ARGS)
                    : launch<int, 1, 32>(VARIANT_ARGS);
#undef VARIANT_ARGS
}
