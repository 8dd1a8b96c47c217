// argmax_fire: candidate-only pane emission for nexmark q5's argmax fire
// (the local argmax of a sliding COUNT(*) window) — the (key, pane) cells
// whose pane count equals their pane's extremum, compacted in row-major
// [C, kpad] order.
//
// Replaces arroyo_tpu/ops/keyed_bins.py:157 `_argmax_nnz_kernel` (pane
// counts, per-pane extremum, candidate mask and total) and :180
// `_argmax_gather_kernel` (`jnp.nonzero(..., size=npad)` compaction).
//
// Semantics: cnt[c, p] = sum_w ok[p, w] ? counts[c, ring[p, w]] : 0;
// ext[p] = max_c cnt[c, p] (for 'min': the min over cnt > 0); selected
// cells are (cnt == ext[p]) & (cnt > 0), emitted as (key_idx, pane_idx)
// i32 pairs plus their counts, in ascending flat index c * kpad + p —
// exactly the order jnp.nonzero gives, never atomic-arrival order.  Only
// the first `rows` slots are read: the state's slots at and past its
// next_slot hold count 0 in every bin, so they are never candidates, never
// raise a max (counts are >= 0) and never lower a min (taken over
// cnt > 0) — the output equals the JAX kernels' over all C.
//
// What bounds it on the H100: memory — one 64-byte row atom a slot at q5
// (16 i32 bins; its fire's live panes read one or a few columns of each
// row), 7.7 MB at q5's 119,938 occupied slots, ~2.3 us — and, at that
// size, the chain of dependent round trips to memory that one global
// dependency forces: no cell is a candidate before every slot has been
// counted.
//
// What the design does about it: ONE cooperative launch of the blocks
// the card holds at once, each a chunk of whole slots, no count plane in
// device memory, no fill and no host sync.
// - A block stages the live panes (a bin_ok row with a live bin; padded
//   panes cost nothing) and their live ring columns in shared memory
//   (up to the card's opt-in limit, 227 KiB on the H100).  Its cells are
//   (slot, live pane) pairs in row-major order with a slot's panes in
//   neighbouring lanes, so one warp load fetches a row's sectors once for
//   all of them.  A block step covers a whole number of slots and up to
//   kThreads panes (more panes take several pane tiles a slot), so a
//   thread keeps its pane within a tile: it reads its column of kKeep
//   steps' rows at once (a load of each row in flight together), folds
//   its extremum in a register and, with one tile, keeps those counts in
//   registers across the barrier; a longer chunk is read again in groups
//   of kKeep (from L2 at these sizes).  A fire whose panes do not fit in
//   shared memory reads ring and ok from global memory (L1-cached), every
//   pane taken as live, and folds its extrema in global memory.
// - Extrema are u64 keys under one atomicMax, whatever the mode and
//   type: the count for max, its complement for min over cnt > 0, so 0
//   means "no candidate" and is the identity of both.  A block folds its
//   lanes in shared memory and makes one global atomic a pane.
// - One grid barrier (every block is resident: the cooperative launch
//   refuses a grid the card cannot hold; a fence, a reduction that
//   returns nothing, an acquire poll) separates the extremum from the
//   selection.  Each block then publishes its candidate count; only the
//   blocks with candidates (a few at q5) and the last block read the
//   earlier blocks' words, in one round of loads, not a chained
//   look-back, and the last block writes the total.  Each candidate lands
//   at its block's offset plus its rank in the block (ballots), up to the
//   caller's capacity; the total is written even when it exceeds it.
// - The extrema, the barrier counter and the published counts sit in a
//   persistent workspace that no call fills.  The counts are tagged with
//   the call's epoch; the extrema and the counter are left zero by the
//   call that wrote them: with staged panes by the last block, once
//   every earlier block has published (each has read its keys by then),
//   else by the last block to finish.  A call that never ran (a refused
//   launch) writes nothing, and calls in any order on one stream find
//   the workspace as they need it; never launch it on two streams at
//   once (the wrapper keeps a workspace per stream).
// - Two launches (the extremum, then the selection with a decoupled
//   look-back) and fewer blocks a SM were slower
//   (tools/argmax_fire_variants.py; PERF.md §6).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeep = 8;       // pane counts a thread keeps in registers
constexpr int kMaxBlocks = 4096;
// workspace, u64 words: a block's published candidate count (epoch <<
// 32 | count) [kMaxBlocks], the barrier and done counters (two u32),
// then the extremum keys [panes]
constexpr int kWsFixed = kMaxBlocks + 1;

template <typename T>
__device__ __forceinline__ unsigned long long ext_key(T c, int is_max) {
  if (is_max) return static_cast<unsigned long long>(c);
  return c > 0 ? ~static_cast<unsigned long long>(c) : 0ull;
}

// the exclusive rank of `flag` among the block's threads and, in *total,
// the block's flagged threads; every thread calls it
__device__ __forceinline__ int block_rank(int flag, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int n = s_warp[w];
    before += w < warp ? n : 0;
    all += n;
  }
  __syncthreads();  // s_warp is free for the next call
  *total = all;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// every block of the (resident) grid arrives (a fence, then a reduction
// that returns nothing), then waits until `target` blocks have arrived
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;" ::"l"(bar)
                 : "memory");
    for (;;) {
      unsigned v;
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(bar)
                   : "memory");
      if (v >= target) break;
      __nanosleep(32);
    }
  }
  __syncthreads();
}

// stage the live panes (a bin_ok row with a live bin, in pane order)
// and their live ring columns in shared memory; their count lands in
// *s_np, their extremum keys start at 0.  Every thread calls it.
__device__ void stage_panes(const int* __restrict__ ring,
                            const bool* __restrict__ ok, int B, int W,
                            int kpad, unsigned long long* s_key, int* s_col,
                            int* s_ncol, int* s_pane, int* s_warp,
                            int* s_np) {
  const int tid = threadIdx.x;
  if (tid == 0) *s_np = 0;
  for (int base = 0; base < kpad; base += kThreads) {
    const int p = base + tid;
    int n = 0;
    if (p < kpad) {
      for (int w = 0; w < W; ++w) {
        const int c = ring[p * W + w];
        n += ok[p * W + w] && c >= 0 && c < B;
      }
    }
    int round_live;
    const int r = block_rank(n > 0, s_warp, &round_live);
    const int j = *s_np + r;
    if (n > 0) {
      int m = 0;
      for (int w = 0; w < W; ++w) {
        const int c = ring[p * W + w];
        if (ok[p * W + w] && c >= 0 && c < B) s_col[j * W + m++] = c;
      }
      s_ncol[j] = n;
      s_pane[j] = p;
      s_key[j] = 0;
    }
    __syncthreads();
    if (tid == 0) *s_np += round_live;
    __syncthreads();
  }
}

// The panes of a fire: kStaged, the live ones and their live columns in
// shared memory; else read from ring / ok in global memory, every pane
// taken as live.  A template parameter, so the staged kernel carries
// none of the other's registers.
template <bool kStaged>
struct Panes {
  const int* col;   // staged: live pane j's columns, col[j * W ..]
  const int* ncol;  // staged: how many
  const int* pane;  // staged: its pane index in [0, kpad)
  const int* ring;
  const bool* ok;
  int np, W, B;

  __device__ __forceinline__ int ncols(int j) const {
    if constexpr (kStaged) return ncol[j];
    return W;
  }
  // pane j's w-th column, or -1 where that bin is not live
  __device__ __forceinline__ int column(int j, int w) const {
    if constexpr (kStaged) return col[j * W + w];
    const int c = __ldg(ring + j * W + w);
    const bool live =
        __ldg(reinterpret_cast<const unsigned char*>(ok) + j * W + w);
    return live && c >= 0 && c < B ? c : -1;
  }
  __device__ __forceinline__ int index(int j) const {
    if constexpr (kStaged) return pane[j];
    return j;
  }
};

// How a block walks its chunk [s0, s1) of slots: a step covers q slots
// and a tile of `tile` panes (tile * q <= kThreads), lane tid the pane
// t * tile + tid % tile of slot s0 + tid / tile + i * q at step i, tile t.
template <typename T, bool kStaged>
struct Walk {
  const T* counts;
  int B, s0, s1, tile, q, tiles, iters, lp, sbase;
  bool active;
  Panes<kStaged> P;

  __device__ Walk(const T* c, int b, const Panes<kStaged>& panes, int rows,
                  int chunk)
      : counts(c), B(b), P(panes) {
    const int np = panes.np;
    const long long first = static_cast<long long>(blockIdx.x) * chunk;
    s0 = static_cast<int>(min(first, static_cast<long long>(rows)));
    s1 = static_cast<int>(min(first + chunk, static_cast<long long>(rows)));
    tile = np < kThreads ? np : kThreads;
    q = tile > 0 ? kThreads / tile : 1;
    tiles = tile > 0 ? (np + tile - 1) / tile : 0;
    iters = tiles > 0 ? (s1 - s0 + q - 1) / q : 0;
    active = tile > 0 && static_cast<int>(threadIdx.x) < tile * q;
    lp = active ? threadIdx.x % tile : 0;
    sbase = s0 + (active ? threadIdx.x / tile : 0);
  }
  __device__ __forceinline__ int slot(int i) const { return sbase + i * q; }
  __device__ __forceinline__ bool valid(int i) const {
    return active && slot(i) < s1;
  }
  __device__ __forceinline__ int pane(int t) const { return t * tile + lp; }
  __device__ __forceinline__ bool live(int t) const {
    return active && pane(t) < P.np;
  }
  __device__ __forceinline__ int groups() const {
    return (iters + kKeep - 1) / kKeep;
  }
  // the counts of tile t's pane at steps g * kKeep .. g * kKeep + kKeep - 1
  __device__ __forceinline__ void load(int t, int g, T (&v)[kKeep]) const {
#pragma unroll
    for (int u = 0; u < kKeep; ++u) v[u] = 0;
    if (!live(t)) return;
    const int j = pane(t);
    const int n = P.ncols(j);
    for (int w = 0; w < n; ++w) {
      const int cw = P.column(j, w);
      if (!kStaged && cw < 0) continue;
#pragma unroll
      for (int u = 0; u < kKeep; ++u) {
        const int i = g * kKeep + u;
        if (valid(i)) {
          v[u] += __ldg(counts + static_cast<long long>(slot(i)) * B + cw);
        }
      }
    }
  }
  // the count of pane j at slot s
  __device__ __forceinline__ T count(int s, int j) const {
    const T* row = counts + static_cast<long long>(s) * B;
    T acc = 0;
    const int n = P.ncols(j);
    for (int w = 0; w < n; ++w) {
      const int cw = P.column(j, w);
      if (kStaged || cw >= 0) acc += __ldg(row + cw);
    }
    return acc;
  }
  // fold the extremum keys of the chunk into keys[pane] (shared or
  // global), one atomic a thread and tile; `kept` keeps the last group
  // loaded (all of the chunk with one tile and one group)
  __device__ void extremum(unsigned long long* keys, int is_max,
                           T (&kept)[kKeep]) const {
    for (int t = 0; t < tiles; ++t) {
      unsigned long long best = 0;
      for (int g = 0; g < groups(); ++g) {
        load(t, g, kept);
#pragma unroll
        for (int u = 0; u < kKeep; ++u) {
          const unsigned long long key = ext_key(kept[u], is_max);
          if (valid(g * kKeep + u) && key > best) best = key;
        }
      }
      if (best) atomicMax(keys + pane(t), best);
    }
  }
};

// The extremum key of pane j after the barrier: staged in shared
// memory, else read from the workspace.
template <bool kStaged>
struct Keys {
  const unsigned long long* s_key;
  const unsigned long long* ext;
  __device__ __forceinline__ unsigned long long operator()(int j) const {
    if constexpr (kStaged) return s_key[j];
    return __ldcg(ext + j);
  }
};

template <typename T>
__device__ __forceinline__ bool hit(T c, unsigned long long key, int is_max) {
  return c > 0 && ext_key(c, is_max) == key;
}

// the chunk's candidates; `keep`: `kept` holds them (one tile, one group)
template <typename T, bool S>
__device__ int count_hits(const Walk<T, S>& k, const Keys<S>& key, int is_max,
                          bool keep, T (&kept)[kKeep]) {
  int mine = 0;
  for (int t = 0; t < k.tiles; ++t) {
    const unsigned long long kj = k.live(t) ? key(k.pane(t)) : 0;
    for (int g = 0; g < k.groups(); ++g) {
      if (!keep) k.load(t, g, kept);
#pragma unroll
      for (int u = 0; u < kKeep; ++u) {
        mine += k.valid(g * kKeep + u) && k.live(t) && hit(kept[u], kj,
                                                          is_max);
      }
    }
  }
  return mine;
}

// write the chunk's candidates from position `run` on, in row-major
// order, up to `capacity`; every thread of the block takes every step
// (block_rank synchronizes)
template <typename T, bool S>
__device__ void emit_hits(const Walk<T, S>& k, const Keys<S>& key, int is_max,
                          bool keep, T (&kept)[kKeep], int run, int capacity,
                          int* s_warp, int* __restrict__ out_key,
                          int* __restrict__ out_pane, T* __restrict__ out_cnt) {
  auto emit = [&](bool sel, int s, int j, T c) {
    int n;
    const int pos = run + block_rank(sel, s_warp, &n);
    if (sel && pos < capacity) {
      out_key[pos] = s;
      out_pane[pos] = k.P.index(j);
      out_cnt[pos] = c;
    }
    run += n;
  };
  if (k.tiles == 1) {  // a step: q slots, all panes
    const unsigned long long kj = k.live(0) ? key(k.pane(0)) : 0;
    for (int g = 0; g < k.groups(); ++g) {
      if (!keep) k.load(0, g, kept);
#pragma unroll
      for (int u = 0; u < kKeep; ++u) {
        const int i = g * kKeep + u;
        if (i < k.iters) {
          emit(k.valid(i) && k.live(0) && hit(kept[u], kj, is_max),
               k.slot(i), k.pane(0), kept[u]);
        }
      }
    }
    return;
  }
  for (int i = 0; i < k.iters; ++i) {  // a step: one slot, a pane tile
    for (int t = 0; t < k.tiles; ++t) {
      const int j = k.pane(t);
      const bool in = k.valid(i) && k.live(t);
      const T c = in ? k.count(k.slot(i), j) : T(0);
      emit(in && hit(c, key(j), is_max), k.slot(i), j, c);
    }
  }
}

// zero the np extremum keys and both counters a call wrote; every
// thread of one block calls it
__device__ __forceinline__ void clear_call(unsigned long long* ws, int np) {
  unsigned long long* ext = ws + kWsFixed;
  for (int j = threadIdx.x; j < np; j += kThreads) ext[j] = 0;
  if (threadIdx.x == 0) ws[kMaxBlocks] = 0;
}

// the last block of the grid to get here clears what the call wrote.
// Every thread calls it after its last read of the workspace.
__device__ void finish(unsigned long long* ws, int np) {
  __shared__ bool s_last;
  unsigned* counters = reinterpret_cast<unsigned*>(ws + kMaxBlocks);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(counters + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  clear_call(ws, np);
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    argmax_kernel(const T* __restrict__ counts, const int* __restrict__ ring,
                  const bool* __restrict__ ok, int B, int W, int kpad,
                  int rows, int chunk, int is_max,
                  unsigned long long* __restrict__ ws, unsigned epoch,
                  int capacity, int* __restrict__ out_total, int* __restrict__ out_key,
                  int* __restrict__ out_pane, T* __restrict__ out_cnt) {
  extern __shared__ unsigned long long s_key[];  // staged: [kpad]
  int* s_col = reinterpret_cast<int*>(s_key + kpad);  // [kpad * W]
  int* s_ncol = s_col + kpad * W;                     // [kpad]
  int* s_pane = s_ncol + kpad;                        // [kpad]
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_np, s_n, s_excl;
  const int tid = threadIdx.x;
  unsigned long long* words = ws;
  unsigned* bar = reinterpret_cast<unsigned*>(ws + kMaxBlocks);
  unsigned long long* ext = ws + kWsFixed;
  if constexpr (kStaged) {
    stage_panes(ring, ok, B, W, kpad, s_key, s_col, s_ncol, s_pane, s_warp,
                &s_np);
  } else if (tid == 0) {
    s_np = kpad;
  }
  if (tid == 0) s_n = 0;
  __syncthreads();
  const Panes<kStaged> P{s_col, s_ncol, s_pane, ring, ok, s_np, W, B};
  const Walk<T, kStaged> k(counts, B, P, rows, chunk);
  // with one pane tile and one group of steps, the counts stay in
  // registers across the barrier
  const bool keep = k.tiles == 1 && k.groups() <= 1;

  // phase 1: pane counts and the extremum keys
  T kept[kKeep];
  k.extremum(kStaged ? s_key : ext, is_max, kept);
  __syncthreads();
  if constexpr (kStaged) {
    for (int j = tid; j < P.np; j += kThreads) {
      if (s_key[j]) atomicMax(ext + j, s_key[j]);
    }
  }
  grid_barrier(bar, gridDim.x);
  if constexpr (kStaged) {
    for (int j = tid; j < P.np; j += kThreads) s_key[j] = __ldcg(ext + j);
    __syncthreads();
  }
  const Keys<kStaged> key{s_key, ext};

  // phase 2: the block's candidates, its count published, its offset
  const int mine = count_hits(k, key, is_max, keep, kept);
  if (mine) atomicAdd(&s_n, mine);
  __syncthreads();
  const int n_b = s_n;
  // relaxed: the count is computed from the keys the block read (and it
  // got here past the barrier), so those reads are done before the store;
  // a release would put a fence on every block's path
  if (tid == 0) {
    const unsigned long long w =
        (static_cast<unsigned long long>(epoch) << 32) |
        static_cast<unsigned>(n_b);
    asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(words + blockIdx.x),
                 "l"(w)
                 : "memory");
  }
  const bool last = blockIdx.x == gridDim.x - 1;
  if (n_b > 0 || last) {
    // the earlier blocks' counts: every block is resident and past the
    // barrier, so each word is published or about to be
    int v = 0;
    for (int b = tid; b < static_cast<int>(blockIdx.x); b += kThreads) {
      unsigned long long w;
      for (;;) {
        asm volatile("ld.relaxed.gpu.u64 %0, [%1];"
                     : "=l"(w)
                     : "l"(words + b)
                     : "memory");
        if ((w >> 32) == epoch) break;
        __nanosleep(32);
      }
      v += static_cast<int>(static_cast<unsigned>(w));
    }
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    if (tid == 0) s_excl = 0;
    __syncthreads();
    if ((tid & 31) == 0 && v) atomicAdd(&s_excl, v);
    __syncthreads();
    const int run = s_excl;
    if (last) {
      if (tid == 0) *out_total = run + n_b;
      // every block has published, so has read its staged keys and
      // passed the barrier
      if constexpr (kStaged) clear_call(ws, P.np);
    }
    if (n_b > 0) {
      emit_hits(k, key, is_max, keep, kept, run, capacity, s_warp, out_key,
                out_pane, out_cnt);
    }
  }
  // unstaged blocks read the keys from the workspace until they finish
  if constexpr (!kStaged) finish(ws, P.np);
}

struct Shape {
  int smem_limit;  // dynamic shared memory a block may take (opt-in)
  int smem, per_sm, sms;
};

// for argmax_kernel<T, kStaged> with `want_smem` bytes of dynamic shared
// memory: the card's SMs and the blocks it holds at once a SM (0 when
// the bytes pass the card's opt-in limit, which is raised for the kernel
// on first use), remembered per device
template <typename T, bool kStaged>
int shape_for(long long want_smem, Shape* out) {
  static Shape cache[64] = {};
  const auto kernel = argmax_kernel<T, kStaged>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Shape& c = cache[dev];
  if (c.smem_limit == 0) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    const int limit = optin - static_cast<int>(attr.sharedSizeBytes);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
    if (e != cudaSuccess) return e;
    c.smem_limit = limit;
    c.smem = -1;
  }
  if (want_smem > c.smem_limit) {
    *out = c;
    out->per_sm = 0;
    return cudaSuccess;
  }
  if (want_smem != c.smem) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, static_cast<size_t>(want_smem));
    if (e != cudaSuccess) return e;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    c.smem = static_cast<int>(want_smem);
    c.per_sm = per_sm;
  }
  *out = c;
  return cudaSuccess;
}

// `max_per_sm` > 0 caps the grid at that many blocks a SM
template <typename T>
int launch(const void* counts, const void* ring, const void* ok, int B,
           int W, int kpad, int rows, int is_max, void* ws, unsigned epoch,
           int capacity, void* out, int max_per_sm, cudaStream_t st) {
  // staged: extremum key, column count and pane index, W columns a pane
  const long long staged_smem = static_cast<long long>(kpad) * (16 + 4ll * W);
  Shape sh;
  int e = shape_for<T, true>(staged_smem, &sh);
  if (e != cudaSuccess) return e;
  const bool staged = sh.per_sm > 0;
  if (!staged) {
    e = shape_for<T, false>(0, &sh);
    if (e != cudaSuccess) return e;
  }
  long long resident = static_cast<long long>(sh.sms) *
                       (max_per_sm > 0 && max_per_sm < sh.per_sm
                            ? max_per_sm
                            : sh.per_sm);
  if (resident > kMaxBlocks) resident = kMaxBlocks;
  // no more blocks than the cells need (kpad bounds the live panes)
  const long long tiles =
      (static_cast<long long>(rows) * kpad + kThreads - 1) / kThreads;
  const int want = static_cast<int>(tiles < resident ? tiles : resident);
  int chunk = want > 0 ? (rows + want - 1) / want : 1;
  if (chunk < 1) chunk = 1;
  int grid = (rows + chunk - 1) / chunk;
  if (grid < 1) grid = 1;
  // the output buffer (kernels/argmax_fire.py argmax_layout): the total,
  // the key row, the pane row, then the counts, 8-byte aligned for i64
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
  void* args[] = {&c,     &r,      &o, &B,     &W,        &kpad,
                  &rows,  &chunk,  &is_max, &w, &epoch, &capacity,
                  &total, &key,   &pane,   &cnt};
  const void* kernel =
      staged ? reinterpret_cast<const void*>(argmax_kernel<T, true>)
             : reinterpret_cast<const void*>(argmax_kernel<T, false>);
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args,
      static_cast<size_t>(staged ? staged_smem : 0), st);
  if (rc != cudaSuccess) cudaGetLastError();  // not left for the next launch
  return rc;
}

}  // namespace

// u64 words of a workspace for fires of up to `panes` panes
extern "C" int arroyo_argmax_workspace_words(int panes) {
  return kWsFixed + panes;
}

// One cooperative launch.  counts i32|i64[C, B] of which the first `rows`
// slots are read, ring i32[kpad, W], ok bool[kpad, W]; `ws` a workspace
// of arroyo_argmax_workspace_words(ws_panes) u64 words, ws_panes >= kpad,
// zero when made and used by one stream; `epoch` non-zero and new for
// every call on it (the caller zeroes the workspace before its epochs
// wrap); writes the candidate total and up to `capacity` candidates into
// `out` (layout in launch()).
extern "C" int arroyo_argmax_fire(const void* counts, int counts_i64,
                                  const void* ring, const void* ok, int B,
                                  int W, int kpad, int rows, int is_max,
                                  void* ws, int ws_panes, unsigned epoch,
                                  int capacity, void* out, void* stream) {
  if (rows < 0 || kpad <= 0 || W <= 0 || B <= 0 || capacity < 0 ||
      ws_panes < kpad || epoch == 0 ||
      static_cast<long long>(rows) * kpad >= (1ll << 31) ||
      static_cast<long long>(kpad) * W >= (1ll << 31))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return counts_i64
             ? launch<long long>(counts, ring, ok, B, W, kpad, rows, is_max,
                                 ws, epoch, capacity, out, 0, st)
             : launch<int>(counts, ring, ok, B, W, kpad, rows, is_max, ws,
                           epoch, capacity, out, 0, st);
}
