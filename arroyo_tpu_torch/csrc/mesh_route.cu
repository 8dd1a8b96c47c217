// mesh_route: bucket one source shard's rows by destination shard — a
// stable counting sort into fixed-capacity buckets, the route half of the
// keyed mesh's update step and of the co-located device shuffle.
//
// Replaces the route halves of arroyo_tpu/parallel/mesh_window.py:119
// `_update_step` (:153-178: argsort by destination, one-hot cumsum
// positions, scatter into [nk, N] buckets) and of
// arroyo_tpu/parallel/shuffle.py:193 `_route_step` (:221-233).
//
// Semantics.  The input is ONE i64 buffer rows[F][N]: row 0 the key hash
// (u64 bits), row 1 a validity word (0: padding), rows 2.. a stack of raw
// 64-bit words (f64 bits or i64) that ride along.  A valid row's
// destination is, by `rule`:
//   0 (mesh):    the top lg = log2(nk) bits of (key << shift), as
//                mesh_window.py:154-156;
//   1 (shuffle): min(key / (U64_MAX / nk), nk - 1), server_for_hash as
//                shuffle.py:214-222.
// The output is out[F][nk][N]: bucket d of field f at (f * nk + d) * N.
// A valid row goes to the next free position of its bucket, in source
// order (stable), with all F words copied; invalid rows are not placed.
// Unused positions hold EMPTY (all ones) in the key row and 0 in every
// other row — what the JAX step leaves there.  A row whose position
// reaches N is dropped and counted into *drops (a bucket holds N and a
// source holds N rows, so this cannot happen; the counter proves it).
//
// What bounds it on the H100: memory.  It reads the F words of each row
// once and writes nk * F * N words, (nk - 1) / nk of them padding, which
// a memset writes first (the real rows are written twice).
//
// What the design does about it: ONE launch after two memsets.  A block
// takes a tile of 2,048 consecutive rows from a ticket counter; each warp
// walks 32 rows a step in order, ranks each row among the warp's rows of
// its destination by __match_any_sync, and keeps per-warp running counts
// in shared memory.  The tile's count per destination is carried across
// tiles by a decoupled look-back (mesh_lookback.cuh), one counter a
// destination, so every position is final once the walk back ends.  The
// rows are read a second time, coalesced, only for the copy.

#include <cuda_runtime.h>

#include "mesh_lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;  // steps of 32 rows a warp
constexpr int kTile = kThreads * kItems;
constexpr int kMaxDest = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int dest_of(unsigned long long key, int nk,
                                       int rule, int shift, int lg,
                                       unsigned long long range) {
  if (nk == 1) return 0;
  if (rule == 0) return static_cast<int>((key << shift) >> (64 - lg));
  const unsigned long long q = key / range;
  return q >= static_cast<unsigned long long>(nk - 1) ? nk - 1
                                                      : static_cast<int>(q);
}

__global__ void __launch_bounds__(kThreads)
    mesh_route_kernel(const long long* __restrict__ rows, long long N, int F,
                      int nk, int rule, int shift, int lg,
                      unsigned long long range, long long* __restrict__ out,
                      unsigned long long* __restrict__ drops,
                      unsigned long long* __restrict__ ticket,
                      unsigned long long* __restrict__ status) {
  __shared__ int s_tile;
  __shared__ int s_cnt[kWarps][kMaxDest];  // counts, then warp offsets
  __shared__ long long s_base[kMaxDest];
  for (int i = threadIdx.x; i < kWarps * kMaxDest; i += kThreads) {
    (&s_cnt[0][0])[i] = 0;
  }
  const int tile = mesh::draw_tile(ticket, &s_tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long long warp_base =
      static_cast<long long>(tile) * kTile + static_cast<long long>(warp) *
                                                 32 * kItems;
  int dst[kItems];
  int rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long r = warp_base + j * 32 + lane;
    int d = -1;
    if (r < N && rows[N + r] != 0) {
      d = dest_of(static_cast<unsigned long long>(rows[r]), nk, rule, shift,
                  lg, range);
    }
    const unsigned peers = __match_any_sync(kFull, d);
    const int before = d >= 0 ? s_cnt[warp][d] : 0;
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers) - 1) {
      s_cnt[warp][d] = before + __popc(peers);
    }
    __syncwarp();
    dst[j] = d;
    rank[j] = before + __popc(peers & lt);
  }
  __syncthreads();
  if (threadIdx.x < nk) {
    const int d = threadIdx.x;
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cnt[w][d];
      s_cnt[w][d] = run;
      run += c;
    }
    s_base[d] = static_cast<long long>(mesh::look_back(
        status, tile, nk, d, static_cast<unsigned long long>(run)));
  }
  __syncthreads();
  unsigned long long dropped = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int d = dst[j];
    if (d < 0) continue;
    const long long r = warp_base + j * 32 + lane;
    const long long pos = s_base[d] + s_cnt[warp][d] + rank[j];
    if (pos >= N) {
      ++dropped;
      continue;
    }
    for (int f = 0; f < F; ++f) {
      out[(static_cast<long long>(f) * nk + d) * N + pos] =
          rows[static_cast<long long>(f) * N + r];
    }
  }
  if (dropped) atomicAdd(drops, dropped);
}

}  // namespace

// Words of the call's workspace after the output: a drop counter, the
// ticket, one status word a (tile, destination).
extern "C" long long arroyo_mesh_route_ws_words(long long N, int nk) {
  const long long tiles = (N + kTile - 1) / kTile;
  return 2 + tiles * nk;
}

// rows i64[F][N] (key, validity, stack); out i64[F][nk][N]; drops a u64
// counter the dropped rows are added to (ws[0], or the caller's); ws the
// workspace of arroyo_mesh_route_ws_words(N, nk) words, right after out.
// Fills out and ws first (two memsets: out's key row to all ones, the
// rest of out and ws to 0), then one launch on `stream`; returns
// cudaGetLastError().
extern "C" int arroyo_mesh_route(const void* rows, long long N, int F,
                                 int nk, int rule, int shift, void* out,
                                 void* drops, void* ws, void* stream) {
  if (N < 0 || N >= (1ll << 40) || F < 2 || nk < 1 || nk > kMaxDest ||
      (nk & (nk - 1)) != 0 || (rule != 0 && rule != 1) || shift < 0 ||
      shift > 32)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t plane = static_cast<size_t>(nk) * N * sizeof(long long);
  if (static_cast<char*>(ws) !=
      static_cast<char*>(out) + plane * F)
    return cudaErrorInvalidValue;
  cudaError_t rc = cudaMemsetAsync(out, 0xFF, plane, st);
  if (rc == cudaSuccess) {
    rc = cudaMemsetAsync(static_cast<char*>(out) + plane, 0,
                         plane * (F - 1) +
                             arroyo_mesh_route_ws_words(N, nk) *
                                 sizeof(long long),
                         st);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (N == 0) return cudaSuccess;
  int lg = 0;
  while ((1 << lg) < nk) ++lg;
  const unsigned long long range = ~0ull / static_cast<unsigned>(nk);
  const long long tiles = (N + kTile - 1) / kTile;
  unsigned long long* w = static_cast<unsigned long long*>(ws);
  mesh_route_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const long long*>(rows), N, F, nk, rule, shift, lg, range,
      static_cast<long long*>(out),
      static_cast<unsigned long long*>(drops), w + 1, w + 2);
  return static_cast<int>(cudaGetLastError());
}
