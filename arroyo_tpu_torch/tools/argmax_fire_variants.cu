// Designs of the argmax fire that the port does not use, for
// tools/argmax_fire_variants.py to time against csrc/argmax_fire.cu:
//
// - per_sm > 0: the port's cooperative kernel (argmax_kernel, included
//   from its source) on a grid of at most `per_sm` blocks a SM, so a
//   block counts a longer chunk and the grid barrier waits for fewer
//   blocks;
// - per_sm == 0, "two launches": the first launch counts the cells and
//   folds the extremum (no barrier); the second counts them again, selects
//   and compacts with a decoupled look-back over epoch-tagged status words
//   (block_scan.cuh), its last block writing the total.  Blocks need not
//   be resident, so each takes about 256 cells.
//
// All write the port's output buffer (kernels/argmax_fire.py
// argmax_layout) and use its workspace as the port's kernel does.

#include "../csrc/argmax_fire.cu"
#include "../csrc/block_scan.cuh"

namespace {

// the launch's panes, staged (every fire the tool times fits)
#define STAGE_PANES()                                                     \
  extern __shared__ unsigned long long s_key[];                          \
  int* s_col = reinterpret_cast<int*>(s_key + kpad);                     \
  int* s_ncol = s_col + kpad * W;                                        \
  int* s_pane = s_ncol + kpad;                                           \
  __shared__ int s_warp[kThreads / 32];                                  \
  __shared__ int s_np;                                                   \
  stage_panes(ring, ok, B, W, kpad, s_key, s_col, s_ncol, s_pane, s_warp, \
              &s_np);                                                    \
  const Panes<true> P{s_col, s_ncol, s_pane, ring, ok, s_np, W, B};     \
  const Walk<T, true> k(counts, B, P, rows, chunk)

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ext_kernel(const T* __restrict__ counts, const int* __restrict__ ring,
               const bool* __restrict__ ok, int B, int W, int kpad,
               int rows, int chunk, int is_max,
               unsigned long long* __restrict__ ws) {
  STAGE_PANES();
  T kept[kKeep];
  k.extremum(s_key, is_max, kept);
  __syncthreads();
  unsigned long long* ext = ws + kWsFixed;
  for (int j = threadIdx.x; j < P.np; j += kThreads) {
    if (s_key[j]) atomicMax(ext + j, s_key[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    select_kernel(const T* __restrict__ counts, const int* __restrict__ ring,
                  const bool* __restrict__ ok, int B, int W, int kpad,
                  int rows, int chunk, int is_max,
                  unsigned long long* __restrict__ ws,
                  unsigned long long* __restrict__ status, unsigned epoch,
                  int capacity, int* __restrict__ out_total,
                  int* __restrict__ out_key, int* __restrict__ out_pane,
                  T* __restrict__ out_cnt) {
  STAGE_PANES();
  __shared__ int s_n;
  __shared__ unsigned s_excl;
  const unsigned long long* ext = ws + kWsFixed;
  for (int j = threadIdx.x; j < P.np; j += kThreads) s_key[j] = ext[j];
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  const Keys<true> key{s_key, ext};
  T kept[kKeep];
  const int mine = count_hits(k, key, is_max, false, kept);
  if (mine) atomicAdd(&s_n, mine);
  __syncthreads();
  const unsigned agg = static_cast<unsigned>(s_n);
  const int tile = blockIdx.x;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      look_publish(status, tile, epoch,
                   tile == 0 ? kLookInclusive : kLookAggregate, agg);
    }
    const unsigned excl =
        tile == 0 ? 0u : lookback_exclusive(status, tile, epoch);
    if (threadIdx.x == 0) {
      if (tile > 0) look_publish(status, tile, epoch, kLookInclusive,
                                 excl + agg);
      s_excl = excl;
      if (tile == static_cast<int>(gridDim.x) - 1) {
        *out_total = static_cast<int>(excl + agg);
      }
    }
  }
  __syncthreads();
  if (agg > 0) {
    emit_hits(k, key, is_max, false, kept, static_cast<int>(s_excl),
              capacity, s_warp, out_key, out_pane, out_cnt);
  }
  finish(ws, P.np);
}

template <typename T>
int variant(int per_sm, const void* counts, const void* ring, const void* ok,
            int B, int W, int kpad, int rows, int is_max, void* ws,
            void* status, unsigned epoch, int capacity, void* out,
            cudaStream_t st) {
  if (per_sm > 0) {
    return launch<T>(counts, ring, ok, B, W, kpad, rows, is_max, ws, epoch,
                     capacity, out, per_sm, st);
  }
  // ordinary launches: blocks need not be resident, about 256 cells each
  const int smem = kpad * (16 + 4 * W);
  const long long tiles =
      (static_cast<long long>(rows) * kpad + kThreads - 1) / kThreads;
  int chunk = tiles > 0 ? static_cast<int>((rows + tiles - 1) / tiles) : 1;
  if (chunk < 1) chunk = 1;
  int grid = (rows + chunk - 1) / chunk;
  if (grid < 1) grid = 1;
  int* total = static_cast<int*>(out);
  int* key = total + 1;
  int* pane = key + capacity;
  long long cnt_word = 1 + 2ll * capacity;
  if (sizeof(T) == 8) cnt_word += cnt_word & 1;
  T* cnt = reinterpret_cast<T*>(total + cnt_word);
  const T* c = static_cast<const T*>(counts);
  const int* r = static_cast<const int*>(ring);
  const bool* o = static_cast<const bool*>(ok);
  auto* w = static_cast<unsigned long long*>(ws);
  ext_kernel<T><<<grid, kThreads, smem, st>>>(c, r, o, B, W, kpad, rows,
                                               chunk, is_max, w);
  select_kernel<T><<<grid, kThreads, smem, st>>>(
      c, r, o, B, W, kpad, rows, chunk, is_max, w,
      static_cast<unsigned long long*>(status), epoch, capacity, total, key,
      pane, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// per_sm > 0: the port's kernel on at most per_sm blocks a SM; 0: two
// launches.  `status`: a look-back word a block of the second launch
// (zero when made), `epoch` in 1 .. 2^30 - 1, new for every call.  The
// rest as arroyo_argmax_fire; the two-launch form's panes must fit in 48
// KiB of shared memory.
extern "C" int argmax_fire_variant(int per_sm, const void* counts,
                                   int counts_i64, const void* ring,
                                   const void* ok, int B, int W, int kpad,
                                   int rows, int is_max, void* ws,
                                   int ws_panes, void* status,
                                   unsigned epoch, int capacity, void* out,
                                   void* stream) {
  if (rows < 0 || kpad <= 0 || ws_panes < kpad || per_sm < 0 ||
      epoch == 0 || epoch >= (1u << 30) ||
      (per_sm == 0 && kpad * (16 + 4 * W) > 48 * 1024))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return counts_i64
             ? variant<long long>(per_sm, counts, ring, ok, B, W, kpad, rows,
                                  is_max, ws, status, epoch, capacity, out,
                                  st)
             : variant<int>(per_sm, counts, ring, ok, B, W, kpad, rows,
                            is_max, ws, status, epoch, capacity, out, st);
}
