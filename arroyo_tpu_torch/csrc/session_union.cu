// session_union: the interval-union scan of session windows — per row of
// (key, start)-sorted intervals, the running max of ends within the
// row's key run and the new-session flag.
//
// Replaces arroyo_tpu/ops/session.py:75 `_union_kernel` (a Hillis-Steele
// log-doubling scan under jit).
//
// Semantics, for i < n:
//   newkey[i] = i == 0 || kh[i] != kh[i - 1]
//   run_en[i] = max(en[j]) over j <= i in i's key run     (exact int64)
//   new[i]    = newkey[i] || st[i] > run_en[i - 1]
// Touching intervals (st == run_en of the predecessors) merge.  Key
// hashes arrive as int64 bit views of the u64 hashes; only == is used.
// The caller passes exact n (no padding rows).
//
// What bounds it on the H100: memory.  Three i64 reads and one i64 plus
// one byte written per row, a compare and a max per row; at config5's
// per-batch n of a few hundred rows the launches themselves dominate.
//
// What the design does about it: a segmented max-scan over
// (head flag, value) pairs, whose combine
//   (fa, va) . (fb, vb) = (fa | fb, fb ? vb : max(va, vb))
// is associative.  A key run may span many tiles (one key spanning the
// whole input is the extreme), so the scan crosses blocks in three
// stream-ordered launches: (1) each 1024-row tile scans itself (four rows
// a thread, warp shuffles, one shared-memory pass) and records its total
// and its first head; (2) one block scans the tile totals into each
// tile's incoming carry; (3) a row-parallel pass folds the carry into the
// rows before the tile's first head and computes the flags.  Everything
// stays in int64: the per-group offset trick would overflow with
// microsecond timestamps.  A decoupled look-back single pass is later
// work.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr long long kI64Min = LLONG_MIN;

struct Seg {
  int f;        // a head (new key) occurs in the span
  long long v;  // running max of the span's last key run
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{a.f | b.f, b.f ? b.v : (a.v > b.v ? a.v : b.v)};
}

__device__ __forceinline__ Seg shfl_up(Seg x, int d) {
  return Seg{__shfl_up_sync(0xffffffffu, x.f, d),
             __shfl_up_sync(0xffffffffu, x.v, d)};
}

// Exclusive scan of one Seg per thread across the block (blockDim.x a
// multiple of 32, at most 1024).  Returns the thread's exclusive prefix
// and the block total in *total.  Ends with a barrier so it may be
// called again in a loop.
__device__ Seg block_exclusive_scan(Seg x, Seg* total) {
  __shared__ int warp_f[32];
  __shared__ long long warp_v[32];
  __shared__ int total_f;
  __shared__ long long total_v;
  const Seg ident{0, kI64Min};
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  Seg inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const Seg o = shfl_up(inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  const Seg up = shfl_up(inc, 1);
  const Seg texc = lane == 0 ? ident : up;
  if (lane == 31) {
    warp_f[warp] = inc.f;
    warp_v[warp] = inc.v;
  }
  __syncthreads();
  if (warp == 0) {
    const Seg w = lane < n_warps ? Seg{warp_f[lane], warp_v[lane]} : ident;
    Seg winc = w;
    for (int d = 1; d < 32; d <<= 1) {
      const Seg o = shfl_up(winc, d);
      if (lane >= d) winc = combine(o, winc);
    }
    const Seg wup = shfl_up(winc, 1);
    if (lane < n_warps) {
      const Seg wexc = lane == 0 ? ident : wup;
      warp_f[lane] = wexc.f;
      warp_v[lane] = wexc.v;
    }
    if (lane == n_warps - 1) {
      total_f = winc.f;
      total_v = winc.v;
    }
  }
  __syncthreads();
  const Seg wexc{warp_f[warp], warp_v[warp]};
  *total = Seg{total_f, total_v};
  const Seg out = combine(wexc, texc);
  __syncthreads();
  return out;
}

// (1) per-tile segmented scan: local[i] is the running max from the tile
// start (or the row's head, if later); the tile's total and the offset
// of its first head (kTile when it has none) go to the tile arrays.
__global__ void union_tile_scan(const long long* __restrict__ kh,
                                const long long* __restrict__ en,
                                long long n, long long* __restrict__ local,
                                int* __restrict__ tile_f,
                                long long* __restrict__ tile_v,
                                int* __restrict__ first_head) {
  __shared__ int head;
  if (threadIdx.x == 0) head = kTile;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int t0 = threadIdx.x * kItems;
  int f[kItems];
  long long v[kItems];
  Seg agg{0, kI64Min};
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + t0 + j;
    if (i < n) {
      f[j] = i == 0 || kh[i] != kh[i - 1];
      v[j] = en[i];
      if (f[j]) atomicMin(&head, t0 + j);
    } else {
      f[j] = 0;
      v[j] = kI64Min;
    }
    agg = combine(agg, Seg{f[j], v[j]});
  }
  Seg total;
  Seg run = block_exclusive_scan(agg, &total);
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + t0 + j;
    run = combine(run, Seg{f[j], v[j]});
    if (i < n) local[i] = run.v;
  }
  if (threadIdx.x == 0) {
    tile_f[blockIdx.x] = total.f;
    tile_v[blockIdx.x] = total.v;
    first_head[blockIdx.x] = head;
  }
}

// (2) one block: carry[b] = the running max at the end of tile b - 1,
// i.e. the exclusive scan of the tile totals.
__global__ void union_carry_scan(const int* __restrict__ tile_f,
                                 const long long* __restrict__ tile_v,
                                 int n_tiles, long long* __restrict__ carry) {
  Seg running{0, kI64Min};
  for (int b0 = 0; b0 < n_tiles; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const Seg x = b < n_tiles ? Seg{tile_f[b], tile_v[b]} : Seg{0, kI64Min};
    Seg total;
    const Seg exc = block_exclusive_scan(x, &total);
    if (b < n_tiles) carry[b] = combine(running, exc).v;
    running = combine(running, total);
  }
}

__device__ __forceinline__ long long fixed_run(
    const long long* __restrict__ local, const long long* __restrict__ carry,
    const int* __restrict__ first_head, long long i) {
  const long long b = i / kTile;
  const long long r = local[i];
  if (i - b * kTile < first_head[b]) {
    const long long c = carry[b];
    return c > r ? c : r;
  }
  return r;
}

// (3) fold each tile's carry into its rows before the first head, then
// the new-session flags (reading the predecessor's folded value).
__global__ void union_finish(const long long* __restrict__ kh,
                             const long long* __restrict__ st,
                             const long long* __restrict__ local,
                             const long long* __restrict__ carry,
                             const int* __restrict__ first_head, long long n,
                             unsigned char* __restrict__ new_flag,
                             long long* __restrict__ run_en) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  run_en[i] = fixed_run(local, carry, first_head, i);
  unsigned char flag = 1;
  if (i > 0 && kh[i] == kh[i - 1]) {
    flag = st[i] > fixed_run(local, carry, first_head, i - 1);
  }
  new_flag[i] = flag;
}

}  // namespace

// kh, st, en i64[n] on the device, sorted by (kh, st).  Scratch: local
// i64[n], tile_v and carry i64[n_tiles], tile_f and first_head
// i32[n_tiles] with n_tiles = ceil(n / 1024).  Writes new_flag u8[n]
// (0/1, a torch.bool) and run_en i64[n].  Three launches on `stream`;
// returns cudaGetLastError() after the last (or the first failing) one.
extern "C" int arroyo_session_union(const void* kh, const void* st,
                                    const void* en, long long n, void* local,
                                    void* tile_f, void* tile_v, void* carry,
                                    void* first_head, void* new_flag,
                                    void* run_en, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  union_tile_scan<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const long long*>(kh), static_cast<const long long*>(en), n,
      static_cast<long long*>(local), static_cast<int*>(tile_f),
      static_cast<long long*>(tile_v), static_cast<int*>(first_head));
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  union_carry_scan<<<1, kThreads, 0, s>>>(
      static_cast<const int*>(tile_f), static_cast<const long long*>(tile_v),
      static_cast<int>(n_tiles), static_cast<long long*>(carry));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  union_finish<<<blocks, kThreads, 0, s>>>(
      static_cast<const long long*>(kh), static_cast<const long long*>(st),
      static_cast<const long long*>(local),
      static_cast<const long long*>(carry),
      static_cast<const int*>(first_head), n,
      static_cast<unsigned char*>(new_flag), static_cast<long long*>(run_en));
  return static_cast<int>(cudaGetLastError());
}
