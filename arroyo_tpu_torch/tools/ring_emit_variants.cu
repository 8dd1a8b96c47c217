// A design of the long-window pane fire (csrc/ring_emit.cu's function)
// that the port does not use, kept to be timed against it by
// ring_emit_variants.py: a block of 256 threads owns a tile of 256 rows of
// one plane, a thread a row.  The block stages the rows' span in windows
// of 32 positions into shared memory with cp.async copies (a warp copies
// 32 rows, a lane a position: 256 contiguous bytes of a row a copy
// instruction), double-buffered, so window w + 1 is in flight while the
// threads sweep window w; each thread walks its row sequentially, so an
// f64 running sum associates as torch.cumsum on the CPU does.  MIN/MAX
// fold forward only: pane p is fold(x[p .. k - 2]) o fold(x[k - 1 .. W -
// 1]) o fold(x[W .. p + W - 1]), the head part's suffix folds taken in
// the output cells once the walk passes k - 2, which needs k <= W + 1
// (the fires it is timed at); a fire with k > W + 1 is refused.
//
// Two windows of 256 rows x 33 cells (the pad keeps a warp's reads of
// its rows' cells on distinct banks) of 8 bytes: 135,168 bytes of shared
// memory, so one block a SM.

#include <cuda_runtime.h>

#include <cmath>

#include "../csrc/pane_reduce.cuh"

namespace {

constexpr int kRows = 256;    // threads and rows a block
constexpr int kWin = 32;      // span positions a window
constexpr int kPitch = kWin + 1;
constexpr size_t kSmem = 2ull * kRows * kPitch * 8;

struct Span {
  int c0;
  int j0;
  int j1;
  int L;
};

__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
}

__device__ __forceinline__ double ext_fold(bool is_max, double acc,
                                           double x) {
  if (acc != acc) return acc;
  if (x != x) return x;
  const long long a = order_key(acc);
  const long long b = order_key(x);
  return (is_max ? b > a : b < a) ? x : acc;
}

template <typename T>
__device__ __forceinline__ void copy_cell(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  }
}

// issue the copies of window `w` (positions 32 w ..) of the tile's rows
// into buffer `buf`; dead positions are not read
template <typename T>
__device__ void stage(T* buf, const T* __restrict__ plane, const Span& sp,
                      int B, int s0, int rows, int w) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = w * kWin + lane;
  if (j < sp.j0 || j > sp.j1 || j >= sp.L) return;
  int col = sp.c0 + j;
  if (col >= B) col %= B;
  for (int r = warp * 32; r < warp * 32 + 32; ++r) {
    if (s0 + r < rows) {
      copy_cell(buf + r * kPitch + lane,
                plane + static_cast<long long>(s0 + r) * B + col);
    }
  }
}

template <typename T, typename Acc>
__device__ void walk(const T* __restrict__ plane, const Span& sp, int B,
                     int W, int k, int rows, int kind, double ident,
                     T* __restrict__ out, unsigned char* smem) {
  T* bufs = reinterpret_cast<T*>(smem);
  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kRows;
  const int s = s0 + t;
  const bool is_max = kind == kMax;
  const int n_win = (sp.L + kWin - 1) / kWin;
  T* o = out + static_cast<long long>(s) * k;
  Acc P = Acc(0);          // add: the running sum
  double mid = is_max ? -INFINITY : INFINITY;  // ext: the middle fold
  double tail = mid;       // ext: the tail part's running fold
  stage(bufs, plane, sp, B, s0, rows, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int w = 0; w < n_win; ++w) {
    if (w + 1 < n_win) {
      stage(bufs + ((w + 1) & 1) * kRows * kPitch, plane, sp, B, s0, rows,
            w + 1);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" :::
                     "memory");
    __syncthreads();
    const T* cell = bufs + (w & 1) * kRows * kPitch + t * kPitch;
    if (s < rows) {
      for (int i = 0; i < kWin; ++i) {
        const int j = w * kWin + i;
        if (j >= sp.L) break;
        const bool live = j >= sp.j0 && j <= sp.j1;
        if (kind == kAdd) {
          P += live ? static_cast<Acc>(cell[i]) : Acc(0);
          if (j + 1 < k) o[j + 1] = static_cast<T>(P);
          const int p = j - (W - 1);
          if (p >= 0) {
            o[p] = static_cast<T>(P - (p > 0 ? static_cast<Acc>(o[p]) : 0));
          }
        } else {
          const double x = live ? static_cast<double>(cell[i]) : ident;
          if (j < k - 1) {
            o[j] = static_cast<T>(x);  // the head part, raw
          } else if (j <= W - 1) {
            mid = ext_fold(is_max, mid, x);
          } else {
            tail = ext_fold(is_max, tail, x);
            const int p = j - W + 1;
            o[p] = static_cast<T>(ext_fold(is_max, o[p], tail));
          }
          if (j == W - 1) {
            // the head part's suffix folds, then the middle: every pane's
            // head and middle
            double suf = mid;
            o[k - 1] = static_cast<T>(mid);
            for (int p = k - 2; p >= 0; --p) {
              suf = ext_fold(is_max, static_cast<double>(o[p]), suf);
              o[p] = static_cast<T>(suf);
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled next round
  }
}

template <typename CountT>
__global__ void __launch_bounds__(kRows, 1)
    ring_emit_tile(const double* __restrict__ values,
                   const CountT* __restrict__ counts, XferSpec spec, Span sp,
                   int C, int B, int W, int k, int rows,
                   double* __restrict__ out, CountT* __restrict__ out_cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.y;
  if (r == spec.n) {
    walk<CountT, long long>(counts, sp, B, W, k, rows, kAdd, 0.0, out_cnt,
                            smem);
    return;
  }
  const int kind = spec.kind[r];
  walk<double, double>(values + static_cast<long long>(spec.ch[r]) * C * B,
                       sp, B, W, k, rows, kind, kind_identity(kind),
                       out + static_cast<long long>(r) * rows * k, smem);
}

long long clamp_ll(long long x, long long a, long long b) {
  return x < a ? a : (x > b ? b : x);
}

}  // namespace

// arroyo_ring_emit's arguments and output layout (csrc/ring_emit.cu);
// refuses k > W + 1.
extern "C" int ring_emit_variant(const void* values, const void* counts,
                                 int counts_i64, const void* spec, int C,
                                 int B, long long first_bin, long long lo,
                                 long long hi, int W, int k, int rows,
                                 void* out, void* stream) {
  const XferSpec* xs = static_cast<const XferSpec*>(spec);
  if (xs->n < 0 || xs->n > kMaxChannels || rows < 0 || rows > C || k < 0 ||
      W < 1 || B < 1 || k > W + 1)
    return cudaErrorInvalidValue;
  const int planes = xs->n + (counts != nullptr);
  if (static_cast<long long>(rows) * k == 0 || planes == 0)
    return cudaSuccess;
  const long long L = static_cast<long long>(k) + W - 1;
  const long long j0 = clamp_ll(lo - first_bin, 0, L);
  const long long j1 = clamp_ll(hi - first_bin, -1, L - 1);
  if (j1 - j0 >= B) return cudaErrorInvalidValue;
  const Span sp{static_cast<int>(((first_bin % B) + B) % B),
                static_cast<int>(j0), static_cast<int>(j1),
                static_cast<int>(L)};
  double* out_f = static_cast<double*>(out);
  void* out_cnt = out_f + static_cast<long long>(xs->n) * rows * k;
  const dim3 grid((rows + kRows - 1) / kRows, planes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* v = static_cast<const double*>(values);
  cudaError_t rc;
  if (counts_i64) {
    rc = cudaFuncSetAttribute(ring_emit_tile<long long>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ring_emit_tile<long long><<<grid, kRows, kSmem, st>>>(
        v, static_cast<const long long*>(counts), *xs, sp, C, B, W, k, rows,
        out_f, static_cast<long long*>(out_cnt));
  } else {
    rc = cudaFuncSetAttribute(ring_emit_tile<int>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ring_emit_tile<int><<<grid, kRows, kSmem, st>>>(
        v, static_cast<const int*>(counts), *xs, sp, C, B, W, k, rows, out_f,
        static_cast<int*>(out_cnt));
  }
  return static_cast<int>(cudaGetLastError());
}
