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
// j: idx2[0, j] = s, idx2[1, j] = p, out_cnt[j] = cnt[t], out[r, j] = the
// pane reduction of channel ch_r (pane_reduce.cuh, the dense fire's).
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
// - The gather call: each live cell lands at its 256-cell group's offset
//   plus its ballot rank (block_scan.cuh), so rows come out in
//   np.nonzero's order.

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

template <typename CountT>
__global__ void gather_kernel(const double* __restrict__ values,
                              const CountT* __restrict__ cnt,
                              const int* __restrict__ ring,
                              const bool* __restrict__ ok, XferSpec spec,
                              int C, int B, int W, int k, long long total,
                              const int* __restrict__ offsets, int nnz,
                              int* __restrict__ idx2,
                              CountT* __restrict__ out_cnt,
                              double* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const CountT c = t < total ? cnt[t] : 0;
  const int live = c > 0;
  const int pos = compact_position<kThreads>(live, offsets);
  if (!live) return;
  const long long s = t / k;
  const int p = static_cast<int>(t - s * k);
  idx2[pos] = static_cast<int>(s);
  idx2[nnz + pos] = p;
  out_cnt[pos] = c;
  const long long plane = static_cast<long long>(C) * B;
  const int* pr = ring + static_cast<long long>(p) * W;
  const bool* po = ok + static_cast<long long>(p) * W;
  for (int r = 0; r < spec.n; ++r) {
    out[static_cast<long long>(r) * nnz + pos] = pane_reduce(
        values + spec.ch[r] * plane + s * B, pr, po, W, spec.kind[r]);
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

// Gather call.  values f64[n_ch, C, B]; cnt and offsets from the count
// call; chans/kinds are HOST arrays of n_xfer ints.  Writes idx2 i32[2,
// nnz], out_cnt[nnz] (the counts dtype) and out f64[n_xfer, nnz].
extern "C" int arroyo_emit_gather(const void* values, const void* cnt,
                                  int counts_i64, const void* ring,
                                  const void* ok, const int* chans,
                                  const int* kinds, int n_xfer, int C, int B,
                                  int W, int k, int rows, const void* offsets,
                                  int nnz, void* idx2, void* out_cnt,
                                  void* out, void* stream) {
  XferSpec spec;
  if (!make_spec(chans, kinds, n_xfer, &spec) || rows > C || k <= 0)
    return cudaErrorInvalidValue;
  if (nnz <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(rows) * k;
  const int nblocks = static_cast<int>((total + kThreads - 1) / kThreads);
  if (counts_i64) {
    gather_kernel<long long><<<nblocks, kThreads, 0, st>>>(
        static_cast<const double*>(values),
        static_cast<const long long*>(cnt), static_cast<const int*>(ring),
        static_cast<const bool*>(ok), spec, C, B, W, k, total,
        static_cast<const int*>(offsets), nnz, static_cast<int*>(idx2),
        static_cast<long long*>(out_cnt), static_cast<double*>(out));
  } else {
    gather_kernel<int><<<nblocks, kThreads, 0, st>>>(
        static_cast<const double*>(values), static_cast<const int*>(cnt),
        static_cast<const int*>(ring), static_cast<const bool*>(ok), spec, C,
        B, W, k, total, static_cast<const int*>(offsets), nnz,
        static_cast<int*>(idx2), static_cast<int*>(out_cnt),
        static_cast<double*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
