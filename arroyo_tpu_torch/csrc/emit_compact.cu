// emit_compact: the compact pane fire — only the live (slot, pane) cells
// of a fire, in row-major [rows, k] order, with their row counts and each
// transferred channel's pane aggregate.
//
// Replaces arroyo_tpu/ops/keyed_bins.py:198 `_emit_count_kernel` (pane
// counts and the live total) with the count call, and :213
// `_emit_compact_kernel` (`jnp.nonzero` of the counts, then the channels'
// `_pane_reduce` gathered at the live cells) with the gather call.
//
// Semantics, for s < rows and p < k, t = s * k + p:
//   cnt[t] = sum_w ok[p, w] ? counts[s, ring[p, w]] : 0
// and, for the live cells (cnt[t] > 0) in ascending t, at output position
// j: key[j] = s, pane[j] = p, out_cnt[j] = cnt[t], out[r, j] = the pane
// reduction of the r-th transferred channel (pane_reduce.cuh, the dense
// fire's).
//
// What bounds it on the H100: memory.  The count call reads the live
// count columns of `rows` slots and writes the pane counts (4-8 bytes a
// cell); the gather call re-reads those and, per live cell, the W bins of
// each transferred channel, and writes 8 + 4-8 + 8 * n_xfer bytes.
//
// What the design does about it: the [channels, C, k] grid of the dense
// fire is never written — channels are reduced only at live cells, and
// the outputs are sized to the live total (read back once, the sync the
// JAX version makes), not to a power-of-two bucket.
// - The count call is ONE launch, a block four groups of 256 cells (the
//   offsets' groups), one thread a (slot, pane) cell of each in
//   row-major order with a 32-bit division by k, each reading its pane's
//   live bins from the slot's row, the panes' columns in shared memory;
//   the k panes of a slot sit in neighbouring lanes, so one warp load
//   fetches the row's sectors once for all of them.  cnt is stored
//   coalesced.
// - `offsets` keeps its contract: offsets[g] the live cells before cell
//   256 g, offsets[groups] the live total.  A block leaves its groups'
//   live cells in their offsets words and counts itself in at its
//   superblock of 64 groups (then stores cnt, so the arrival's fence
//   does not wait for those stores); the last block of a superblock to
//   arrive scans its 64 counts, finds the superblock's carry by a
//   decoupled look-back over the earlier superblocks (block_scan.cuh:
//   epoch-tagged status words in a persistent workspace, never zeroed
//   between calls) and writes the 64 offsets.  Superblocks finish in
//   about block order, so a look-back mostly finds its predecessor's
//   inclusive prefix at once.  A look-back a group, one group a block, a
//   grid of the blocks the card holds at once with a look-back a block's
//   chunk, or the rows staged in shared memory first, were slower
//   (tools/emit_count_variants.py; PERF.md §6).
// - The gather call is ONE launch writing ONE buffer
//   (kernels/emit_compact.py compact_layout): the key row, the pane row,
//   the counts, then the transferred channels.  A warp takes one
//   256-cell group and skips it when its offsets say it has no live cell
//   (cnt is not read); otherwise a lane loads 8 consecutive pane counts
//   with 16-byte loads, the warp ranks the live ones by a shuffle scan of
//   the lanes' counts (row-major order, np.nonzero's), stages their cells
//   in shared memory, and writes the group's outputs at its offset with
//   consecutive lanes on consecutive positions, so every row is stored
//   coalesced.  Index math is 32-bit (rows * k < 2^31).  The channels
//   come as the state's channel plan (kernels/bin_update.py
//   ChannelPlan: `dup` channels are not transferred, `mn`/`mx` reduce by
//   min/max), three 64-bit scalars built once per state, not a per-call
//   struct; with no transferred channel `values` is never touched.

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "pane_reduce.cuh"

namespace {

constexpr int kThreads = 256;  // must match kernels/emit_compact.py THREADS
constexpr int kBlockGroups = 4;  // offsets groups a count block takes
constexpr int kSuper = 64;       // offsets groups a count superblock scans

template <typename CountT>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const CountT* __restrict__ counts,
                 const int* __restrict__ ring, const bool* __restrict__ ok,
                 int B, int W, int k, int total, int groups,
                 CountT* __restrict__ cnt, int* __restrict__ offsets,
                 unsigned long long* __restrict__ status,
                 unsigned* __restrict__ arrived, unsigned epoch) {
  extern __shared__ int pcol[];  // pane p's bins [k][W]: ring column or -1
  __shared__ bool s_last;
  __shared__ int s_live[kBlockGroups];
  const int tid = threadIdx.x;
  for (int j = tid; j < k * W; j += kThreads) {
    const int c = ring[j];
    pcol[j] = ok[j] && c >= 0 && c < B ? c : -1;
  }
  __syncthreads();
  const int g0 = blockIdx.x * kBlockGroups;  // this block's first group
  CountT c[kBlockGroups];
#pragma unroll
  for (int u = 0; u < kBlockGroups; ++u) {
    const int t = (g0 + u) * kThreads + tid;
    c[u] = 0;
    if (t < total) {
      const int s = t / k;
      const CountT* row = counts + static_cast<long long>(s) * B;
      const int* pc = pcol + (t - s * k) * W;
      for (int w = 0; w < W; ++w) {
        if (pc[w] >= 0) c[u] += __ldg(row + pc[w]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kBlockGroups; ++u) {
    const int live = __syncthreads_count(c[u] > 0);
    if (tid == 0) s_live[u] = live;
  }
  const int sup = g0 / kSuper;
  const int first = sup * kSuper;
  const int n_in = min(kSuper, groups - first);
  if (tid == 0) {
    // the groups' live cells wait in their offsets words for the last of
    // the superblock's blocks, which turns the words into offsets
    for (int u = 0; u < kBlockGroups && g0 + u < groups; ++u) {
      offsets[g0 + u] = s_live[u];
    }
    __threadfence();
    const unsigned before = atomicAdd(arrived + sup, 1u);
    const int blocks_in = (n_in + kBlockGroups - 1) / kBlockGroups;
    s_last = before == static_cast<unsigned>(blocks_in - 1);
    if (s_last) arrived[sup] = 0;  // every block has arrived: reset
  }
  // stored after the arrival, so its fence does not wait for them
#pragma unroll
  for (int u = 0; u < kBlockGroups; ++u) {
    const int t = (g0 + u) * kThreads + tid;
    if (t < total) cnt[t] = c[u];
  }
  __syncthreads();
  if (!s_last || tid >= 32) return;
  __threadfence();
  // lane l holds groups 2l and 2l + 1 of the superblock
  const int i0 = 2 * tid;
  const int a0 = i0 < n_in ? __ldcg(offsets + first + i0) : 0;
  const int a1 = i0 + 1 < n_in ? __ldcg(offsets + first + i0 + 1) : 0;
  unsigned incl = static_cast<unsigned>(a0 + a1);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(0xffffffffu, incl, d);
    if (tid >= d) incl += o;
  }
  const unsigned agg = __shfl_sync(0xffffffffu, incl, 31);
  if (tid == 0) {
    look_publish(status, sup, epoch,
                 sup == 0 ? kLookInclusive : kLookAggregate, agg);
  }
  const unsigned excl =
      sup == 0 ? 0u : lookback_exclusive(status, sup, epoch);
  if (tid == 0 && sup > 0) {
    look_publish(status, sup, epoch, kLookInclusive, excl + agg);
  }
  const unsigned base = excl + incl - static_cast<unsigned>(a0 + a1);
  if (i0 < n_in) offsets[first + i0] = static_cast<int>(base);
  if (i0 + 1 < n_in) {
    offsets[first + i0 + 1] =
        static_cast<int>(base + static_cast<unsigned>(a0));
  }
  if (first + n_in == groups && tid == 0) {
    offsets[groups] = static_cast<int>(excl + agg);
  }
}

constexpr int kGatherWarps = 8;            // groups a gather block takes
constexpr int kLaneCells = kThreads / 32;  // cells a lane loads

template <typename CountT>
__device__ __forceinline__ void load_cells(const CountT* __restrict__ p,
                                           CountT (&c)[kLaneCells]) {
  if constexpr (sizeof(CountT) == 4) {
    const int4* v = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int i = 0; i < kLaneCells / 4; ++i) {
      const int4 x = __ldg(v + i);
      c[4 * i] = x.x;
      c[4 * i + 1] = x.y;
      c[4 * i + 2] = x.z;
      c[4 * i + 3] = x.w;
    }
  } else {
    const longlong2* v = reinterpret_cast<const longlong2*>(p);
#pragma unroll
    for (int i = 0; i < kLaneCells / 2; ++i) {
      const longlong2 x = __ldg(v + i);
      c[2 * i] = x.x;
      c[2 * i + 1] = x.y;
    }
  }
}

// one warp a 256-cell group of the offsets
template <typename CountT>
__global__ void __launch_bounds__(kGatherWarps * 32)
    gather_kernel(const double* __restrict__ values,
                  const CountT* __restrict__ cnt,
                  const int* __restrict__ ring, const bool* __restrict__ ok,
                  int n_ch, unsigned long long dup, unsigned long long mn,
                  unsigned long long mx, long long plane, int B, int W,
                  int k, int total, int groups,
                  const int* __restrict__ offsets, int nnz,
                  int* __restrict__ key, int* __restrict__ pane,
                  CountT* __restrict__ out_cnt, double* __restrict__ out) {
  __shared__ int s_t[kGatherWarps][kThreads];
  __shared__ CountT s_c[kGatherWarps][kThreads];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * kGatherWarps + warp;
  if (g >= groups) return;
  const int base = __ldg(offsets + g);
  if (__ldg(offsets + g + 1) == base) return;  // no live cell
  const int t0 = g * kThreads + lane * kLaneCells;
  CountT c[kLaneCells];
  if (t0 + kLaneCells <= total) {
    load_cells(cnt + t0, c);
  } else {
#pragma unroll
    for (int i = 0; i < kLaneCells; ++i) {
      c[i] = t0 + i < total ? cnt[t0 + i] : CountT(0);
    }
  }
  int n = 0;
#pragma unroll
  for (int i = 0; i < kLaneCells; ++i) n += c[i] > 0;
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  const int live = __shfl_sync(0xffffffffu, incl, 31);
  int at = incl - n;
#pragma unroll
  for (int i = 0; i < kLaneCells; ++i) {
    if (c[i] > 0) {
      s_t[warp][at] = t0 + i;
      s_c[warp][at] = c[i];
      ++at;
    }
  }
  __syncwarp();
  for (int i = lane; i < live; i += 32) {
    const int t = s_t[warp][i];
    const int s = t / k;
    const int p = t - s * k;
    const int o = base + i;
    key[o] = s;
    pane[o] = p;
    out_cnt[o] = s_c[warp][i];
    const int* pr = ring + p * W;
    const bool* po = ok + p * W;
    long long r = 0;
    for (int j = 0; j < n_ch; ++j) {
      if ((dup >> j) & 1ull) continue;
      const int kind =
          (mn >> j) & 1ull ? kMin : ((mx >> j) & 1ull ? kMax : kAdd);
      out[r * nnz + o] = pane_reduce(
          values + j * plane + static_cast<long long>(s) * B, pr, po, W,
          kind);
      ++r;
    }
  }
}

}  // namespace

// Count call, one launch.  counts i32|i64[C, B], ring i32[k, W], ok
// bool[k, W], over the first `rows` slots; writes cnt[rows * k] (the
// counts dtype) and offsets i32[groups + 1], groups = ceil(rows * k /
// 256): four groups a block, 64 a superblock.  The caller's
// persistent workspace: `ws` a status word a superblock (ceil(groups /
// 64)), `arrive` as many u32 arrival counters, zero between calls;
// `epoch` in 1 .. 2^30 - 1, new for every call.
extern "C" int arroyo_emit_count(const void* counts, int counts_i64,
                                 const void* ring, const void* ok, int B,
                                 int W, int k, int rows, void* cnt,
                                 void* offsets, void* ws, void* arrive,
                                 unsigned epoch, void* stream) {
  if (rows <= 0 || k <= 0 || W < 0 || B <= 0 || epoch == 0 ||
      epoch >= (1u << 30) || static_cast<long long>(rows) * k >= (1ll << 31))
    return cudaErrorInvalidValue;
  const int total = rows * k;
  const int groups = (total + kThreads - 1) / kThreads;
  const size_t smem = sizeof(int) * static_cast<size_t>(k) * W;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* status = static_cast<unsigned long long*>(ws);
  auto* arrived = static_cast<unsigned*>(arrive);
  const int blocks = (groups + kBlockGroups - 1) / kBlockGroups;
  if (counts_i64) {
    count_kernel<long long><<<blocks, kThreads, smem, st>>>(
        static_cast<const long long*>(counts), static_cast<const int*>(ring),
        static_cast<const bool*>(ok), B, W, k, total, groups,
        static_cast<long long*>(cnt), static_cast<int*>(offsets), status,
        arrived, epoch);
  } else {
    count_kernel<int><<<blocks, kThreads, smem, st>>>(
        static_cast<const int*>(counts), static_cast<const int*>(ring),
        static_cast<const bool*>(ok), B, W, k, total, groups,
        static_cast<int*>(cnt), static_cast<int*>(offsets), status, arrived,
        epoch);
  }
  return static_cast<int>(cudaGetLastError());
}

// Gather call, one launch.  values f64[n_ch, C, B]; cnt (16-byte
// aligned) and offsets from the count call; the channel plan as masks
// over the n_ch channels: `dup` channels are not transferred, the others
// are, in channel order, reduced by min (`mn`), max (`mx`) or addition.
// Writes ONE buffer of i32 words at `out` (kernels/emit_compact.py
// compact_layout): key[nnz], pane[nnz], the counts (nnz of the counts
// dtype), then, from an even word, the transferred channels f64[n_xfer,
// nnz].
extern "C" int arroyo_emit_gather(const void* values, const void* cnt,
                                  int counts_i64, const void* ring,
                                  const void* ok, int n_ch,
                                  unsigned long long dup,
                                  unsigned long long mn,
                                  unsigned long long mx, int C, int B, int W,
                                  int k, int rows, const void* offsets,
                                  int nnz, void* out, void* stream) {
  if (rows <= 0 || rows > C || k <= 0 || W < 0 || n_ch < 0 || n_ch > 64 ||
      static_cast<long long>(rows) * k >= (1ll << 31) ||
      reinterpret_cast<unsigned long long>(cnt) % 16)
    return cudaErrorInvalidValue;
  if (nnz <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = rows * k;
  const int groups = (total + kThreads - 1) / kThreads;
  const int blocks = (groups + kGatherWarps - 1) / kGatherWarps;
  const long long plane = static_cast<long long>(C) * B;
  int* key = static_cast<int*>(out);
  int* pane = key + nnz;
  const long long words = (counts_i64 ? 4ll : 3ll) * nnz;
  double* ch = reinterpret_cast<double*>(key + words + (words & 1));
  const auto* v = static_cast<const double*>(values);
  const auto* r = static_cast<const int*>(ring);
  const auto* o = static_cast<const bool*>(ok);
  const auto* off = static_cast<const int*>(offsets);
  if (counts_i64) {
    gather_kernel<long long><<<blocks, kGatherWarps * 32, 0, st>>>(
        v, static_cast<const long long*>(cnt), r, o, n_ch, dup, mn, mx,
        plane, B, W, k, total, groups, off, nnz, key, pane,
        reinterpret_cast<long long*>(pane + nnz), ch);
  } else {
    gather_kernel<int><<<blocks, kGatherWarps * 32, 0, st>>>(
        v, static_cast<const int*>(cnt), r, o, n_ch, dup, mn, mx, plane, B,
        W, k, total, groups, off, nnz, key, pane, pane + nnz, ch);
  }
  return static_cast<int>(cudaGetLastError());
}
