// Designs of the compact fire's count call that csrc/emit_compact.cu does
// not use, kept to be measured against it (emit_count_variants.py).  Each
// writes the same cnt[rows * k] and offsets[groups + 1] in one launch,
// finding its carry by block_scan.cuh's look-back over its own status
// words (one a tile, in `ws`).
//   variant 1, cell: one block a 256-cell group, one thread a (slot,
//     pane) cell reading its pane's live bins from the slot's row, and a
//     look-back for every group instead of every superblock of 64;
//   variant 2, stage: a block takes a tile of up to 1,024 slots (as many
//     as 44 KB of shared memory holds), copies the columns some pane reads
//     of the tile's rows into shared memory by cp.async (each live bin of
//     a slot loaded once for all its panes), then one thread a cell sums
//     its pane from there; one look-back a tile;
//   variant 3, cell_ticket: variant 1 with each block's tile taken from a
//     ticket counter (ws word 0, reset by the last tile) instead of its
//     block index, as csrc/session_union.cu and csrc/segment_agg.cu do;
//   variant 4, chunk: a grid of the blocks the card holds at once (the
//     occupancy API's count), each a chunk of whole 256-slot runs taken
//     eight groups a pass, one thread a cell, one look-back a chunk;
//   variants 5 and 6, g1 and g4: the port's kernel (four groups a block,
//     the cells' counts stored after the block counts itself in at its
//     superblock) with one group a block and the counts stored before
//     the arrival (g1), or with the counts stored before (g4).

#include <cuda_runtime.h>

#include "../csrc/block_scan.cuh"

namespace {

constexpr int kThreads = 256;

template <typename CountT, int kCells, bool kTicket>
__global__ void __launch_bounds__(kThreads)
    count_cells(const CountT* __restrict__ counts,
                const int* __restrict__ ring, const bool* __restrict__ ok,
                int B, int W, int k, long long total, int tiles, int groups,
                CountT* __restrict__ cnt, int* __restrict__ offsets,
                unsigned long long* __restrict__ ws, unsigned epoch) {
  extern __shared__ int pcol[];  // [k][W]: the ring column, or -1
  __shared__ int s_tile;
  __shared__ unsigned s_excl;
  __shared__ unsigned s_before[kCells];
  const int tid = threadIdx.x;
  unsigned long long* status = kTicket ? ws + 1 : ws;
  if (kTicket && tid == 0) {
    auto* ticket = reinterpret_cast<unsigned*>(ws);
    const int t = static_cast<int>(atomicAdd(ticket, 1u));
    if (t == tiles - 1) atomicExch(ticket, 0u);
    s_tile = t;
  }
  for (int j = tid; j < k * W; j += kThreads) {
    const int c = ring[j];
    pcol[j] = ok[j] && c >= 0 && c < B ? c : -1;
  }
  __syncthreads();
  const int tile = kTicket ? s_tile : static_cast<int>(blockIdx.x);
  CountT c[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const long long t =
        (static_cast<long long>(tile) * kCells + i) * kThreads + tid;
    c[i] = 0;
    if (t < total) {
      const int s = static_cast<int>(t) / k;
      const int p = static_cast<int>(t) - s * k;
      const CountT* row = counts + static_cast<long long>(s) * B;
      const int* pc = pcol + p * W;
      for (int w = 0; w < W; ++w) {
        if (pc[w] >= 0) c[i] += __ldg(row + pc[w]);
      }
      cnt[t] = c[i];
    }
  }
  unsigned run = 0;
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int live = __syncthreads_count(c[i] > 0);
    if (tid == 0) s_before[i] = run;
    run += static_cast<unsigned>(live);
  }
  if (tid == 0) {
    look_publish(status, tile, epoch,
                 tile == 0 ? kLookInclusive : kLookAggregate, run);
  }
  if (tid < 32) {
    const unsigned excl =
        tile == 0 ? 0u : lookback_exclusive(status, tile, epoch);
    if (tid == 0) {
      if (tile > 0) look_publish(status, tile, epoch, kLookInclusive,
                                 excl + run);
      s_excl = excl;
    }
  }
  __syncthreads();
  if (tid < kCells) {
    const long long g = static_cast<long long>(tile) * kCells + tid;
    if (g < groups) offsets[g] = static_cast<int>(s_excl + s_before[tid]);
  }
  if (tile == tiles - 1 && tid == 0) {
    offsets[groups] = static_cast<int>(s_excl + run);
  }
}

template <typename CountT, int kCells, bool kTicket>
int launch(const void* counts, const void* ring, const void* ok, int B,
           int W, int k, int rows, void* cnt, void* offsets, void* ws,
           unsigned epoch, cudaStream_t st) {
  const long long total = static_cast<long long>(rows) * k;
  const int groups = static_cast<int>((total + kThreads - 1) / kThreads);
  const int tiles = (groups + kCells - 1) / kCells;
  count_cells<CountT, kCells, kTicket>
      <<<tiles, kThreads, sizeof(int) * k * W, st>>>(
          static_cast<const CountT*>(counts), static_cast<const int*>(ring),
          static_cast<const bool*>(ok), B, W, k, total, tiles, groups,
          static_cast<CountT*>(cnt), static_cast<int*>(offsets),
          static_cast<unsigned long long*>(ws), epoch);
  return static_cast<int>(cudaGetLastError());
}

template <typename CountT>
__global__ void __launch_bounds__(kThreads)
    stage_kernel(const CountT* __restrict__ counts,
                 const int* __restrict__ ring, const bool* __restrict__ ok,
                 int B, int W, int k, int rows, int ts, int tiles,
                 int groups, CountT* __restrict__ cnt,
                 int* __restrict__ offsets,
                 unsigned long long* __restrict__ status, unsigned epoch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ncols;
  __shared__ unsigned s_excl;
  const int tid = threadIdx.x;
  const int steps = (ts * k + kThreads - 1) / kThreads;
  // pane p's bins as local columns [k][W] (-1: not read), each step's
  // live cells before its group start (or -1), each ring column's local
  // column (-1: no pane reads it), the local columns' ring columns, then
  // the tile: [ts][ncols + 1] counts of the columns some pane reads
  int* pcol = reinterpret_cast<int*>(smem);
  int* gpos = pcol + k * W;
  int* lidx = gpos + steps;
  int* gcol = lidx + B;
  CountT* tile_v = reinterpret_cast<CountT*>(
      smem + ((sizeof(int) * (static_cast<size_t>(k) * W + steps + 2 * B) +
               15) & ~static_cast<size_t>(15)));

  for (int c = tid; c < B; c += kThreads) lidx[c] = -1;
  __syncthreads();
  for (int j = tid; j < k * W; j += kThreads) {
    const int c = ring[j];
    const bool read = ok[j] && c >= 0 && c < B;
    pcol[j] = read ? c : -1;
    if (read) lidx[c] = 0;
  }
  __syncthreads();
  if (tid < 32) {  // number the columns some pane reads, in ring order
    int n = 0;
    for (int base = 0; base < B; base += 32) {
      const int c = base + tid;
      const bool read = c < B && lidx[c] == 0;
      const unsigned bits = __ballot_sync(0xffffffffu, read);
      if (read) {
        const int l = n + __popc(bits & ((1u << tid) - 1u));
        lidx[c] = l;
        gcol[l] = c;
      }
      n += __popc(bits);
    }
    if (tid == 0) s_ncols = n;
  }
  __syncthreads();
  for (int j = tid; j < k * W; j += kThreads) {
    if (pcol[j] >= 0) pcol[j] = lidx[pcol[j]];
  }
  const int ncols = s_ncols;
  const int stride = ncols + 1;  // the pad spreads a column over the banks
  const int tile = blockIdx.x;
  const int s0 = tile * ts;
  const int n_s = min(ts, rows - s0);
  {  // the read columns of the tile's rows, a warp's words consecutive
    const CountT* src = counts + static_cast<long long>(s0) * B;
    const int words = n_s * ncols;
    for (int e = tid; e < words; e += kThreads) {
      const int r = e / ncols;
      const int l = e - r * ncols;
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(tile_v + r * stride + l));
      const CountT* at = src + static_cast<long long>(r) * B + gcol[l];
      if (sizeof(CountT) == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst),
                     "l"(at)
                     : "memory");
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                     "l"(at)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                     : "memory");
  }
  __syncthreads();

  const long long cell0 = static_cast<long long>(s0) * k;
  const int n_cells = n_s * k;
  unsigned run = 0;  // live cells of the tile before this step
  for (int i = 0; i < steps; ++i) {
    const int q = i * kThreads + tid;
    int live = 0;
    if (q < n_cells) {
      const int sl = q / k;
      const int p = q - sl * k;
      const CountT* row = tile_v + sl * stride;
      const int* pc = pcol + p * W;
      CountT c = 0;
      for (int w = 0; w < W; ++w) {
        if (pc[w] >= 0) c += row[pc[w]];
      }
      cnt[cell0 + q] = c;
      live = c > 0;
    }
    // the one group start in this step's 256 cells, `r` cells in
    const long long t0 = cell0 + static_cast<long long>(i) * kThreads;
    const int r = static_cast<int>((kThreads - t0 % kThreads) % kThreads);
    const int before = __syncthreads_count(live && tid < r);
    const int all = __syncthreads_count(live);
    if (tid == 0) {
      gpos[i] = i * kThreads + r < n_cells ? static_cast<int>(run) + before
                                           : -1;
    }
    run += static_cast<unsigned>(all);
  }

  if (tid == 0) {
    look_publish(status, tile, epoch,
                 tile == 0 ? kLookInclusive : kLookAggregate, run);
  }
  if (tid < 32) {
    const unsigned excl =
        tile == 0 ? 0u : lookback_exclusive(status, tile, epoch);
    if (tid == 0) {
      if (tile > 0) look_publish(status, tile, epoch, kLookInclusive,
                                 excl + run);
      s_excl = excl;
    }
  }
  __syncthreads();
  const unsigned excl = s_excl;
  for (int i = tid; i < steps; i += kThreads) {
    if (gpos[i] >= 0) {
      const long long g = (cell0 + static_cast<long long>(i) * kThreads +
                           kThreads - 1) / kThreads;
      offsets[g] = static_cast<int>(excl + static_cast<unsigned>(gpos[i]));
    }
  }
  if (tile == tiles - 1 && tid == 0) {
    offsets[groups] = static_cast<int>(excl + run);
  }
}

// Shared memory of a count block: its panes' columns, step offsets and
// column maps, then a tile of `ts` rows of at most `ncols` read columns.
template <typename CountT>
size_t stage_smem(int ts, int B, int W, int k, int ncols) {
  const int steps = (ts * k + kThreads - 1) / kThreads;
  const size_t head =
      (sizeof(int) * (static_cast<size_t>(k) * W + steps + 2 * B) + 15) &
      ~static_cast<size_t>(15);
  return head + static_cast<size_t>(ts) * (ncols + 1) * sizeof(CountT);
}

template <typename CountT>
int launch_stage(const void* counts, const void* ring, const void* ok, int B,
                 int W, int k, int rows, int ts, int tiles, int groups,
                 void* cnt, void* offsets, void* ws, unsigned epoch,
                 cudaStream_t st) {
  const int ncols = min(B, k * W);  // the most columns the panes can read
  const size_t smem = stage_smem<CountT>(ts, B, W, k, ncols);
  // the H100's 227 KB a block, less the kernel's static words
  if (smem > 232448 - 64) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        stage_kernel<CountT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  stage_kernel<CountT><<<tiles, kThreads, smem, st>>>(
      static_cast<const CountT*>(counts), static_cast<const int*>(ring),
      static_cast<const bool*>(ok), B, W, k, rows, ts, tiles, groups,
      static_cast<CountT*>(cnt), static_cast<int*>(offsets),
      static_cast<unsigned long long*>(ws), epoch);
  return static_cast<int>(cudaGetLastError());
}

// Variant 4's kernel: a chunk of whole 256-slot runs a block, kG groups
// of cells a pass, one look-back a chunk.
template <typename CountT, int kG>
__global__ void __launch_bounds__(kThreads)
    chunk_kernel(const CountT* __restrict__ counts,
                 const int* __restrict__ ring, const bool* __restrict__ ok,
                 int B, int W, int k, int rows, int chunk, int groups,
                 CountT* __restrict__ cnt, int* __restrict__ offsets,
                 unsigned long long* __restrict__ status, unsigned epoch) {
  extern __shared__ int pcol[];
  int* before = pcol + k * W;
  __shared__ unsigned s_excl;
  const int tid = threadIdx.x;
  for (int j = tid; j < k * W; j += kThreads) {
    const int c = ring[j];
    pcol[j] = ok[j] && c >= 0 && c < B ? c : -1;
  }
  __syncthreads();
  const int tile = blockIdx.x;
  const long long cell0 = static_cast<long long>(tile) * chunk * k;
  const int n_cells = (min(chunk, rows - tile * chunk)) * k;
  const int n_groups = (n_cells + kThreads - 1) / kThreads;
  unsigned run = 0;
  for (int g = 0; g < n_groups; g += kG) {
    CountT c[kG];
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      const int q = (g + u) * kThreads + tid;
      c[u] = 0;
      if (q < n_cells) {
        const int t = static_cast<int>(cell0) + q;
        const int s = t / k;
        const CountT* row = counts + static_cast<long long>(s) * B;
        const int* pc = pcol + (t - s * k) * W;
        for (int w = 0; w < W; ++w) {
          if (pc[w] >= 0) c[u] += __ldg(row + pc[w]);
        }
        cnt[t] = c[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      if (g + u < n_groups) {
        const int live = __syncthreads_count(c[u] > 0);
        if (tid == 0) before[g + u] = static_cast<int>(run);
        run += static_cast<unsigned>(live);
      }
    }
  }
  if (tid == 0) {
    look_publish(status, tile, epoch,
                 tile == 0 ? kLookInclusive : kLookAggregate, run);
  }
  if (tid < 32) {
    const unsigned e =
        tile == 0 ? 0u : lookback_exclusive(status, tile, epoch);
    if (tid == 0) s_excl = e;
  }
  __syncthreads();
  const unsigned excl = s_excl;
  if (tid == 0 && tile > 0) {
    look_publish(status, tile, epoch, kLookInclusive, excl + run);
  }
  const long long g0 = cell0 / kThreads;
  for (int i = tid; i < n_groups; i += kThreads) {
    offsets[g0 + i] = static_cast<int>(excl + before[i]);
  }
  if (tile == static_cast<int>(gridDim.x) - 1 && tid == 0) {
    offsets[groups] = static_cast<int>(excl + run);
  }
}

template <typename CountT, int kG>
int launch_chunk(const void* counts, const void* ring, const void* ok, int B,
                 int W, int k, int rows, void* cnt, void* offsets, void* ws,
                 unsigned epoch, cudaStream_t st) {
  const long long total = static_cast<long long>(rows) * k;
  const int groups = static_cast<int>((total + kThreads - 1) / kThreads);
  const int runs = (rows + kThreads - 1) / kThreads;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chunk_kernel<CountT, kG>, kThreads,
      sizeof(int) * (static_cast<size_t>(k) * W + 64));
  const int grid = max(1, per_sm * sms);
  const int chunk = (runs + grid - 1) / grid * kThreads;
  const int tiles = (rows + chunk - 1) / chunk;
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(k) * W +
                     static_cast<size_t>(chunk) / kThreads * k);
  chunk_kernel<CountT, kG><<<tiles, kThreads, smem, st>>>(
      static_cast<const CountT*>(counts), static_cast<const int*>(ring),
      static_cast<const bool*>(ok), B, W, k, rows, chunk, groups,
      static_cast<CountT*>(cnt), static_cast<int*>(offsets),
      static_cast<unsigned long long*>(ws), epoch);
  return static_cast<int>(cudaGetLastError());
}

// The port's kernel with kG groups a block (a thread's kG cells 256
// apart) and the cells' counts stored before the block counts itself in
// at its superblock, so the arrival's fence waits for those stores.
template <typename CountT, int kG>
__global__ void __launch_bounds__(kThreads)
    super_kernel(const CountT* __restrict__ counts,
                 const int* __restrict__ ring, const bool* __restrict__ ok,
                 int B, int W, int k, int total, int groups,
                 CountT* __restrict__ cnt, int* __restrict__ offsets,
                 unsigned long long* __restrict__ status,
                 unsigned* __restrict__ arrived, unsigned epoch) {
  constexpr int kSuper = 64;
  extern __shared__ int pcol[];
  __shared__ bool s_last;
  __shared__ int s_live[kG];
  const int tid = threadIdx.x;
  for (int j = tid; j < k * W; j += kThreads) {
    const int c = ring[j];
    pcol[j] = ok[j] && c >= 0 && c < B ? c : -1;
  }
  __syncthreads();
  const int blk = blockIdx.x;
  CountT c[kG];
#pragma unroll
  for (int u = 0; u < kG; ++u) {
    const int t = (blk * kG + u) * kThreads + tid;
    c[u] = 0;
    if (t < total) {
      const int s = t / k;
      const CountT* row = counts + static_cast<long long>(s) * B;
      const int* pc = pcol + (t - s * k) * W;
      for (int w = 0; w < W; ++w) {
        if (pc[w] >= 0) c[u] += __ldg(row + pc[w]);
      }
      cnt[t] = c[u];
    }
  }
#pragma unroll
  for (int u = 0; u < kG; ++u) {
    const int live = __syncthreads_count(c[u] > 0);
    if (tid == 0) s_live[u] = live;
  }
  // a superblock: kSuper groups, kSuper / kG blocks
  const int g0 = blk * kG;
  const int sup = g0 / kSuper;
  const int first = sup * kSuper;
  const int n_in = min(kSuper, groups - first);
  const int blocks_in = (n_in + kG - 1) / kG;
  if (tid == 0) {
    for (int u = 0; u < kG && g0 + u < groups; ++u) offsets[g0 + u] = s_live[u];
    __threadfence();
    const unsigned before = atomicAdd(arrived + sup, 1u);
    s_last = before == static_cast<unsigned>(blocks_in - 1);
    if (s_last) arrived[sup] = 0;
  }
  __syncthreads();
  if (!s_last || tid >= 32) return;
  __threadfence();
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

// the arrival counters follow the status words in `ws`: ceil(groups /
// 64) of each, the counters as u32
template <typename CountT, int kG>
int launch_super(const void* counts, const void* ring, const void* ok, int B,
                 int W, int k, int rows, void* cnt, void* offsets, void* ws,
                 unsigned epoch, cudaStream_t st) {
  const int total = rows * k;
  const int groups = (total + kThreads - 1) / kThreads;
  const int supers = (groups + 63) / 64;
  auto* status = static_cast<unsigned long long*>(ws);
  super_kernel<CountT, kG>
      <<<(groups + kG - 1) / kG, kThreads, sizeof(int) * k * W, st>>>(
          static_cast<const CountT*>(counts), static_cast<const int*>(ring),
          static_cast<const bool*>(ok), B, W, k, total, groups,
          static_cast<CountT*>(cnt), static_cast<int*>(offsets), status,
          reinterpret_cast<unsigned*>(status + supers), epoch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant 1 (cell), 2 (stage), 3 (cell_ticket), 4 (chunk), 5 (g1) or 6
// (g4); the arguments of
// arroyo_emit_count but the tile size.  `ws` needs ceil(groups / cells a
// block) words, and one more for the ticket.
extern "C" int emit_count_variant(int variant, const void* counts,
                                  int counts_i64, const void* ring,
                                  const void* ok, int B, int W, int k,
                                  int rows, void* cnt, void* offsets,
                                  void* ws, unsigned epoch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARROYO_VARIANT(CELLS, TICKET)                                       \
  return counts_i64                                                        \
             ? launch<long long, CELLS, TICKET>(counts, ring, ok, B, W, k, \
                                                rows, cnt, offsets, ws,    \
                                                epoch, st)                 \
             : launch<int, CELLS, TICKET>(counts, ring, ok, B, W, k, rows, \
                                          cnt, offsets, ws, epoch, st)
  if (variant == 1) ARROYO_VARIANT(1, false);
  if (variant == 2) {  // up to 1,024 slots, as many as 44 KB holds
    const int item = counts_i64 ? 8 : 4;
    int ts = (44 * 1024) / ((min(B, k * W) + 1) * item);
    ts = ts > 1024 ? 1024 : (ts >= kThreads ? ts / kThreads * kThreads : ts);
    if (ts < 1) return cudaErrorInvalidValue;
    const long long total = static_cast<long long>(rows) * k;
    const int groups = static_cast<int>((total + kThreads - 1) / kThreads);
    const int tiles = (rows + ts - 1) / ts;
    return counts_i64 ? launch_stage<long long>(counts, ring, ok, B, W, k,
                                                rows, ts, tiles, groups, cnt,
                                                offsets, ws, epoch, st)
                      : launch_stage<int>(counts, ring, ok, B, W, k, rows, ts,
                                          tiles, groups, cnt, offsets, ws,
                                          epoch, st);
  }
  if (variant == 3) ARROYO_VARIANT(1, true);
#undef ARROYO_VARIANT
  if (variant == 4) {
    return counts_i64 ? launch_chunk<long long, 8>(counts, ring, ok, B, W, k,
                                                   rows, cnt, offsets, ws,
                                                   epoch, st)
                      : launch_chunk<int, 8>(counts, ring, ok, B, W, k, rows,
                                             cnt, offsets, ws, epoch, st);
  }
#define ARROYO_SUPER(G)                                                    \
  return counts_i64 ? launch_super<long long, G>(counts, ring, ok, B, W, k, \
                                                 rows, cnt, offsets, ws,   \
                                                 epoch, st)                \
                    : launch_super<int, G>(counts, ring, ok, B, W, k, rows, \
                                           cnt, offsets, ws, epoch, st)
  if (variant == 5) ARROYO_SUPER(1);
  if (variant == 6) ARROYO_SUPER(4);
#undef ARROYO_SUPER
  return cudaErrorInvalidValue;
}
