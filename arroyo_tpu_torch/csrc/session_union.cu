// session_union: the interval-union scan of session windows — per row of
// (key, start)-sorted intervals, the running max of ends within the
// row's key run and the new-session flag; or, in the buffer form, the
// sessions themselves: each one's first row and merged end.
//
// Replaces arroyo_tpu/ops/session.py:75 `_union_kernel` (a Hillis-Steele
// log-doubling scan under jit) and the host reductions its caller ran
// after it (`np.nonzero`, `np.cumsum`, `np.maximum.reduceat`).
//
// Semantics, for i < n:
//   newkey[i] = i == 0 || kh[i] != kh[i - 1]
//   run_en[i] = max(en[j]) over j <= i in i's key run     (exact int64)
//   new[i]    = newkey[i] || st[i] > run_en[i - 1]
// Touching intervals (st == run_en of the predecessors) merge.  Key
// hashes arrive as int64 bit views of the u64 hashes; only == is used.
// The flags form writes new u8[n] (0/1, a torch.bool) and run_en i64[n].
// The buffer form writes ONE i64 buffer of 1 + 2n words: word 0 the
// session count S, words 1.. the first row of each session (S of them),
// words 1 + n.. the merged end of each session, the max of its rows'
// ends (S of them); words past S in either row are not written.  S <= n,
// so the buffer cannot overflow.  The merged end equals run_en at the
// session's last row whenever every interval ends at or after its start;
// the kernel keeps it exact for any input.
//
// What bounds it on the H100: memory at large n — 24 bytes read per row,
// and 9 written per row (flags form) or 16 per session (buffer form).
// At config5's merges (64-192 rows a call) the launch and its round
// trips are all there is.
//
// What the design does about it: ONE kernel launch a call.  A segmented
// max-scan over (head flag, value) pairs, whose combine
//   (fa, va) . (fb, vb) = (fa | fb, fb ? vb : max(va, vb))
// is associative, in int64 throughout (the per-group offset trick would
// overflow with microsecond timestamps).  A warp walks a stretch of
// consecutive rows 128 at a time, four consecutive rows a lane: a lane
// folds its four, one shuffle scan joins the lanes, and a row's
// neighbours are in its lane or a shuffle away.  The warp carries its
// running prefix from step to step, and warp 0 scans the warps' totals.
// The walk runs in passes over rows held on chip: (1) the key scan's
// totals; (2) each row's running end and new-session flag, which the
// flags form writes; in the buffer form (2) also totals the session scan
// over (new-session flag, end), whose running value is a session's
// running end and whose head count numbers the sessions, and (3) writes
// each session's first row and its merged end at its last row.
// - n <= 1,024 (every config5 merge): one block of ceil(n / 128) warps,
//   a warp's 128 rows in its registers.  No workspace, no zero-fill, no
//   second launch.
// - n > 1,024: one block a tile of 1,024-4,096 consecutive rows (about
//   two tiles an SM while a tile fits 4,096 rows), copied into shared
//   memory with cp.async as the block starts; the tile comes from a
//   ticket counter in the call's own workspace, so every earlier tile is
//   already running.  After each scan's first pass a tile publishes its
//   total (aggregate) and finds its carry by a look-back over the earlier
//   tiles' status words, 256 at a time, one a thread, back to the nearest
//   tile that published its inclusive prefix (tile 0 at once, the others
//   as they finish).  The session scan's tile totals depend on the key
//   scan's carry, so its look-back comes second.  Values are
//   written before their status word, with __threadfence() between;
//   readers load the status with acquire semantics.  The status words and
//   the ticket start at zero: the launcher zero-fills them with one
//   cudaMemsetAsync ahead of the kernel (the wrapper counts it).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;  // threads of a multi-tile block
constexpr int kItems = 4;      // consecutive rows a lane takes a step
constexpr int kWarpRows = 32 * kItems;
constexpr int kTile = kThreads * kItems;  // rows of a one-step tile
constexpr int kMaxChunks = 4;  // steps a warp: a tile copy of 96 KB
constexpr int kWarps = kThreads / 32;
constexpr long long kI64Min = LLONG_MIN;
constexpr unsigned kFull = 0xffffffffu;

struct Seg {
  int f;        // a head occurs in the span
  long long v;  // running max of the span's last segment
};

// a span's Seg and its count of heads (the sessions it opens)
struct Agg {
  int f;
  long long v;
  long long c;
};

__device__ __forceinline__ Seg identity() { return Seg{0, kI64Min}; }

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{a.f | b.f, b.f ? b.v : (a.v > b.v ? a.v : b.v)};
}

__device__ __forceinline__ Agg combine(Agg a, Agg b) {
  return Agg{a.f | b.f, b.f ? b.v : (a.v > b.v ? a.v : b.v), a.c + b.c};
}

__device__ __forceinline__ Seg shfl_up(Seg x, int d) {
  return Seg{__shfl_up_sync(kFull, x.f, d), __shfl_up_sync(kFull, x.v, d)};
}

__device__ __forceinline__ Seg shfl_idx(Seg x, int src) {
  return Seg{__shfl_sync(kFull, x.f, src), __shfl_sync(kFull, x.v, src)};
}

__device__ __forceinline__ Agg shfl_up(Agg x, int d) {
  return Agg{__shfl_up_sync(kFull, x.f, d), __shfl_up_sync(kFull, x.v, d),
             __shfl_up_sync(kFull, x.c, d)};
}

__device__ __forceinline__ Agg shfl_down(Agg x, int d) {
  return Agg{__shfl_down_sync(kFull, x.f, d),
             __shfl_down_sync(kFull, x.v, d),
             __shfl_down_sync(kFull, x.c, d)};
}

__device__ __forceinline__ Agg shfl_idx(Agg x, int src) {
  return Agg{__shfl_sync(kFull, x.f, src), __shfl_sync(kFull, x.v, src),
             __shfl_sync(kFull, x.c, src)};
}

// Inclusive scan of one value per lane across the warp.
template <typename T>
__device__ __forceinline__ T warp_inclusive(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = shfl_up(x, d);
    if (lane >= d) x = combine(o, x);
  }
  return x;
}

// look-back states: the low byte of a status word (0: not yet published)
constexpr unsigned long long kAggregate = 1;
constexpr unsigned long long kInclusive = 2;

// One look-back chain of a multi-tile call, T tiles: status words (state
// | f << 8) and each tile's aggregate and inclusive (v, c).
struct Chain {
  unsigned long long* status;
  long long* agg;  // [T][2]
  long long* inc;  // [T][2]
};

// The workspace (i64 words): the ticket and both chains' status words —
// these 1 + 2T are zero-filled — then the chains' values, 8T words.
__device__ __forceinline__ Chain chain(long long* ws, int tiles, int which) {
  auto* status = reinterpret_cast<unsigned long long*>(ws) + 1;
  long long* values = ws + 1 + 2 * tiles + 4 * tiles * which;
  return Chain{status + tiles * which, values, values + 2 * tiles};
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ long long load_relaxed(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.s64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// Publish a tile's value: the value words, a fence, then its status word.
__device__ __forceinline__ void publish(const Chain& ch, int tile,
                                        unsigned long long state, Agg a) {
  volatile long long* v = (state == kInclusive ? ch.inc : ch.agg) + 2 * tile;
  v[0] = a.v;
  v[1] = a.c;
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(ch.status + tile) =
      state | (static_cast<unsigned long long>(a.f) << 8);
}

// Tile `tile`'s carry on one chain: the combine of every earlier tile's
// total.  Publishes the tile's aggregate, then reads the earlier tiles'
// status words blockDim.x at a time, one a thread, newest first, back to
// the nearest one that has published its inclusive prefix (tile 0's
// aggregate is one), and combines them in tile order.  Every thread calls
// it (it synchronizes) and gets the carry.  Tiles are handed out in
// order, so every earlier tile is running and publishes its aggregate
// without waiting on a later one.
__device__ Agg look_back(const Chain& ch, int tile, Agg agg) {
  __shared__ Agg s_part[kWarps];
  __shared__ Agg s_acc;
  __shared__ int s_stop;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = static_cast<int>(blockDim.x);
  const Agg none{0, kI64Min, 0};
  // the last thread publishes: its fence overlaps the other threads'
  // loads (it has none of its own while the tile is below blockDim.x)
  if (tid == threads - 1) {
    publish(ch, tile, tile == 0 ? kInclusive : kAggregate, agg);
  }
  Agg acc = none;  // the tiles after the window, up to tile - 1
  for (int hi = tile - 1; hi >= 0; hi -= threads) {
    const int idx = hi - tid;  // thread 0 the newest
    unsigned long long s = kInclusive;  // before tile 0: nothing to add
    if (idx >= 0) {
      do {
        s = load_acquire(ch.status + idx);
      } while (s == 0);
    }
    if (tid == 0) s_stop = threads;
    __syncthreads();
    if ((s & 0xff) == kInclusive) atomicMin(&s_stop, tid);
    __syncthreads();
    const int stop = s_stop;  // the nearest inclusive tile's thread
    Agg x = none;
    if (idx >= 0 && tid <= stop) {
      const long long* v =
          ((s & 0xff) == kInclusive ? ch.inc : ch.agg) + 2 * idx;
      x = Agg{static_cast<int>((s >> 8) & 1), load_relaxed(v),
              load_relaxed(v + 1)};
    }
    // combine the window in tile order: higher threads are older tiles,
    // on the left
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Agg o = shfl_down(x, d);
      if (lane + d < 32) x = combine(o, x);
    }
    if (lane == 0) s_part[warp] = x;
    __syncthreads();
    if (warp == 0) {
      Agg y = lane < (threads >> 5) ? s_part[lane] : none;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Agg o = shfl_down(y, d);
        if (lane + d < 32) y = combine(o, y);
      }
      if (lane == 0) s_acc = combine(y, acc);
    }
    __syncthreads();
    acc = s_acc;
    if (stop < threads) break;
    __syncthreads();  // s_stop, s_part and s_acc are written next round
  }
  return acc;
}

// The warps' totals (f, v, c) in shared memory -> each warp's exclusive
// prefix there, with the tile's carry combined in front (found by
// look-back on `ch` when the call has several tiles).  Every thread
// calls it after the barrier that published the totals; it returns the
// carry combined with the tile's total, and the prefixes are visible
// after the next barrier.
__device__ __forceinline__ Agg tile_prefixes(int* wf, long long* wv,
                                             long long* wc, int n_warps,
                                             bool multi, const Chain& ch,
                                             int tile) {
  __shared__ Agg s_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Agg none{0, kI64Min, 0};
  Agg ex = none;
  if (warp == 0) {
    const Agg x = lane < n_warps ? Agg{wf[lane], wv[lane], wc[lane]} : none;
    const Agg inc = warp_inclusive(x);
    ex = shfl_up(inc, 1);
    if (lane == 0) ex = none;
    const Agg total = shfl_idx(inc, 31);
    if (lane == 0) s_total = total;
  }
  __syncthreads();
  const Agg total = s_total;
  const Agg carry = multi ? look_back(ch, tile, total) : none;
  if (warp == 0 && lane < n_warps) {
    const Agg pre = combine(carry, ex);
    wf[lane] = pre.f;
    wv[lane] = pre.v;
    wc[lane] = pre.c;
  }
  return combine(carry, total);
}

// A row's word in a tile's shared-memory copy: a permutation inside each
// aligned 16 words, so that a warp reading row 4 lane + j, or 32
// consecutive rows, touches every bank pair twice (two wavefronts).
__device__ __forceinline__ long long swz(long long x) {
  return x ^ ((x >> 4) & 3);
}

// Where a walk reads rows: global memory (off 0), or the copy of the
// tile starting at row `off` in shared memory.
struct Src {
  const long long* k;
  const long long* s;
  const long long* e;
  long long off;
  bool stash;
  __device__ __forceinline__ long long at(long long i) const {
    return stash ? swz(i - off) : i - off;
  }
};

// One step of a warp's walk: rows base + 4 lane + j (j < kItems), four
// consecutive rows a lane, past n the scan's identity, with their
// new-key flags; lane 0's `k_prev` is the key of the row before them.
// Returns the key of the step's last row in every lane: the next step's
// k_prev.
struct Rows {
  long long k[kItems], s[kItems], e[kItems];
  int f[kItems];
};

__device__ __forceinline__ long long load_rows(const Src& src, long long n,
                                               long long base,
                                               long long k_prev, Rows& r) {
  const int lane = threadIdx.x & 31;
  const long long i0 = base + kItems * lane;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool ok = i0 + j < n;
    const long long x = src.at(i0 + j);
    r.k[j] = ok ? src.k[x] : 0;
    r.s[j] = ok ? src.s[x] : 0;
    r.e[j] = ok ? src.e[x] : kI64Min;
  }
  const long long up = __shfl_up_sync(kFull, r.k[kItems - 1], 1);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long left = j > 0 ? r.k[j > 0 ? j - 1 : 0]
                                 : (lane == 0 ? k_prev : up);
    r.f[j] = i0 + j < n && (i0 + j == 0 || r.k[j] != left);
  }
  return __shfl_sync(kFull, r.k[kItems - 1], 31);
}

// The key scan over a step's rows from the warp's running prefix `pre`
// (advanced past them): each row's running end and new-session flag.
__device__ __forceinline__ void key_step(const Rows& r, long long n,
                                         long long i0, Seg* pre,
                                         long long* run, int* head) {
  Seg a = identity();
#pragma unroll
  for (int j = 0; j < kItems; ++j) a = combine(a, Seg{r.f[j], r.e[j]});
  const Seg inc = warp_inclusive(a);
  Seg cur = shfl_up(inc, 1);
  if ((threadIdx.x & 31) == 0) cur = identity();
  cur = combine(*pre, cur);
  *pre = combine(*pre, shfl_idx(inc, 31));
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    head[j] = i0 + j < n && (r.f[j] || r.s[j] > cur.v);
    cur = combine(cur, Seg{r.f[j], r.e[j]});
    run[j] = cur.v;
  }
}

// The session scan over a step's rows, (new-session flag, end) with the
// heads counted, from the warp's running prefix `pre` (advanced past
// them); returns the lane's exclusive prefix.
__device__ __forceinline__ Agg session_step(const Rows& r, const int* head,
                                            Agg* pre) {
  Agg a{0, kI64Min, 0};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    a = combine(a, Agg{head[j], r.e[j], head[j]});
  }
  const Agg inc = warp_inclusive(a);
  Agg ex = shfl_up(inc, 1);
  if ((threadIdx.x & 31) == 0) ex = Agg{0, kI64Min, 0};
  ex = combine(*pre, ex);
  *pre = combine(*pre, shfl_idx(inc, 31));
  return ex;
}

// Copy rows [base, base + rows) of kh, st and en into shared memory
// (three runs of `cap` words, each row at swz(row - base)) with
// cp.async, and wait for them.
__device__ __forceinline__ void stash_rows(const long long* __restrict__ kh,
                                           const long long* __restrict__ st,
                                           const long long* __restrict__ en,
                                           long long base, int rows, int cap,
                                           long long* smem) {
  const long long* src[3] = {kh + base, st + base, en + base};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int x = threadIdx.x; x < rows; x += blockDim.x) {
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(smem + a * cap + swz(x)));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst),
                   "l"(src[a] + x)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
  __syncthreads();
}

// One block a tile of `chunks` * blockDim.x * kItems consecutive rows
// (kBuffer: the buffer form, else the flags form); warp w walks the
// tile's w-th stretch of chunks * 128 rows, a step of 128 at a time.  A
// single-tile call launches ceil(n / 128) warps and one chunk, and a
// warp keeps its rows in registers across the passes; a multi-tile call
// launches kThreads a block and copies the tile's rows into dynamic
// shared memory (3 * chunks * 1,024 words) first.
template <bool kBuffer>
__global__ void __launch_bounds__(kThreads) union_kernel(
    const long long* __restrict__ kh, const long long* __restrict__ st,
    const long long* __restrict__ en, long long n, int n_tiles, int chunks,
    long long* __restrict__ out, unsigned char* __restrict__ new_flag,
    long long* __restrict__ ws) {
  extern __shared__ long long stash[];
  __shared__ int s_tile;
  __shared__ int key_f[kWarps], ses_f[kWarps];
  __shared__ long long key_v[kWarps], ses_v[kWarps];
  __shared__ long long key_c[kWarps], ses_c[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool multi = n_tiles > 1;
  int tile = 0;
  if (multi) {
    if (threadIdx.x == 0) {
      s_tile = static_cast<int>(
          atomicAdd(reinterpret_cast<unsigned long long*>(ws), 1ull));
    }
    __syncthreads();
    tile = s_tile;
  }
  const long long stretch = static_cast<long long>(chunks) * kWarpRows;
  const long long t0 = static_cast<long long>(tile) * n_warps * stretch;
  const long long w0 = t0 + warp * stretch;
  const long long w1 = w0 + stretch < n ? w0 + stretch : n;
  // the key of the row before the warp's stretch (lane 0)
  const long long k_first = lane == 0 && w0 > 0 && w0 < n ? kh[w0 - 1] : 0;
  Src src{kh, st, en, 0, false};
  Rows r;
  const int cap = n_warps * static_cast<int>(stretch);
  if (multi) {
    const long long left = n - t0;
    stash_rows(kh, st, en, t0, left < cap ? static_cast<int>(left) : cap,
               cap, stash);
    src = Src{stash, stash + cap, stash + 2 * cap, t0, true};
  } else {
    load_rows(src, n, w0, k_first, r);  // one step: it stays in registers
  }
  long long run[kItems];
  int head[kItems];

  // pass 1: the warp's key-scan total
  Seg pre = identity();
  long long k_prev = k_first;
  for (long long base = w0; base < w1; base += kWarpRows) {
    if (multi) k_prev = load_rows(src, n, base, k_prev, r);
    key_step(r, n, base + kItems * lane, &pre, run, head);
  }
  if (lane == 0) {
    key_f[warp] = pre.f;
    key_v[warp] = pre.v;
    key_c[warp] = 0;
  }
  __syncthreads();
  const Chain key_chain = multi ? chain(ws, n_tiles, 0) : Chain{};
  const Agg key_all =
      tile_prefixes(key_f, key_v, key_c, n_warps, multi, key_chain, tile);
  __syncthreads();
  const Seg key_pre{key_f[warp], key_v[warp]};

  // pass 2: running ends and new-session flags (the flags form writes
  // them); the buffer form totals the session scan
  pre = key_pre;
  Agg spre{0, kI64Min, 0};
  k_prev = k_first;
  for (long long base = w0; base < w1; base += kWarpRows) {
    if (multi) k_prev = load_rows(src, n, base, k_prev, r);
    const long long i0 = base + kItems * lane;
    key_step(r, n, i0, &pre, run, head);
    if (kBuffer) {
      session_step(r, head, &spre);
    } else if (multi) {
      // through the step's rows of the copy (read for the last time), so
      // that 32 lanes store 32 consecutive rows
      long long* s_run = stash + 2 * cap;
      long long* s_new = stash + cap;
      __syncwarp();  // every lane has read the step's rows
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        s_run[src.at(i0 + j)] = run[j];
        s_new[src.at(i0 + j)] = head[j];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const long long i = base + 32 * q + lane;
        if (i < n) {
          out[i] = s_run[src.at(i)];
          new_flag[i] = static_cast<unsigned char>(s_new[src.at(i)]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (i0 + j < n) {
          out[i0 + j] = run[j];
          new_flag[i0 + j] = static_cast<unsigned char>(head[j]);
        }
      }
    }
  }
  if (!kBuffer) {
    // a later tile may stop its look-back here (off this tile's path)
    if (multi && threadIdx.x == 0 && tile > 0) {
      publish(key_chain, tile, kInclusive, key_all);
    }
    return;
  }

  if (lane == 0) {
    ses_f[warp] = spre.f;
    ses_v[warp] = spre.v;
    ses_c[warp] = spre.c;
  }
  __syncthreads();
  const Chain ses_chain = multi ? chain(ws, n_tiles, 1) : Chain{};
  const Agg all =
      tile_prefixes(ses_f, ses_v, ses_c, n_warps, multi, ses_chain, tile);
  if (threadIdx.x == 0 && tile == n_tiles - 1) out[0] = all.c;  // S
  __syncthreads();

  // pass 3: each session's first row and merged end (at its last row);
  // a session's number is the heads before it
  long long* first = out + 1;
  long long* m_en = out + 1 + n;
  pre = key_pre;
  spre = Agg{ses_f[warp], ses_v[warp], ses_c[warp]};
  k_prev = k_first;
  for (long long base = w0; base < w1; base += kWarpRows) {
    // the row after the step's last row (lane 31)
    const long long i_after = base + kWarpRows;
    long long k_after = 0, s_after = 0;
    if (lane == 31 && i_after < n) {
      // in the copy only while the row is the warp's own: another warp
      // overwrites its rows of the copy in this pass
      const bool in_copy = multi && i_after < w1;
      k_after = in_copy ? src.k[src.at(i_after)] : kh[i_after];
      s_after = in_copy ? src.s[src.at(i_after)] : st[i_after];
    }
    if (multi) k_prev = load_rows(src, n, base, k_prev, r);
    const long long i0 = base + kItems * lane;
    key_step(r, n, i0, &pre, run, head);
    const long long h0 = spre.c;  // the heads before the step
    Agg cur = session_step(r, head, &spre);
    // the head flag of the row after the lane's last: the next lane's
    // first, or the next step's
    int f_after = __shfl_down_sync(kFull, r.f[0], 1);
    long long st_after = __shfl_down_sync(kFull, r.s[0], 1);
    if (lane == 31) {
      f_after = k_after != r.k[kItems - 1];
      st_after = s_after;
    }
    // the step's sessions: heads numbered h0.., ends from the session of
    // its first row, e0 = h0 - 1 + its head flag
    const long long e0 = h0 - 1 + __shfl_sync(kFull, head[0], 0);
    int ends = 0;
    __syncwarp();  // every lane has read the step's rows
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = i0 + j;
      cur = combine(cur, Agg{head[j], r.e[j], head[j]});
      const int f_next = j + 1 < kItems ? r.f[j + 1 < kItems ? j + 1 : j]
                                        : f_after;
      const long long s_next =
          j + 1 < kItems ? r.s[j + 1 < kItems ? j + 1 : j] : st_after;
      // cur.c counts the heads up to and including row i
      const bool end = i < n && (i == n - 1 || f_next || s_next > run[j]);
      if (multi) {
        // into the step's rows of the copy (read for the last time): the
        // first rows at k[h0..], the merged ends at s[e0..]
        if (head[j]) stash[src.at(base + (cur.c - 1 - h0))] = i;
        if (end) stash[cap + src.at(base + (cur.c - 1 - e0))] = cur.v;
      } else if (i < n) {
        if (head[j]) first[cur.c - 1] = i;
        if (end) m_en[cur.c - 1] = cur.v;
      }
      ends += __popc(__ballot_sync(kFull, end));
    }
    if (multi) {  // 32 lanes store 32 consecutive sessions
      __syncwarp();
      const int heads = static_cast<int>(spre.c - h0);
      for (int x = lane; x < heads; x += 32) {
        first[h0 + x] = stash[src.at(base + x)];
      }
      for (int x = lane; x < ends; x += 32) {
        m_en[e0 + x] = stash[cap + src.at(base + x)];
      }
    }
  }  if (multi && threadIdx.x == 0 && tile > 0) {
    publish(key_chain, tile, kInclusive, key_all);
    publish(ses_chain, tile, kInclusive, all);
  }
}

// Let a kernel take a tile's shared-memory copy above the default 48 KB
// of dynamic shared memory (on the current device).
template <bool kBuffer>
cudaError_t stash_limit(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(union_kernel<kBuffer>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// kh, st, en i64[n] on the device, sorted by (kh, st).  buffer_form 0:
// writes run_en i64[n] to `out` and new u8[n] to `new_flag`; 1: writes
// the i64[1 + 2n] session buffer to `out` (new_flag unused).  `ws`: for
// n > 1,024 a workspace of 1 + 10 * ceil(n / 1024) i64 words (null
// otherwise), whose first 1 + 2T words (T tiles) this launcher
// zero-fills.  One kernel launch on `stream` and, for n > 1,024, the
// zero-fill before it; returns cudaGetLastError() or the first error.
extern "C" int arroyo_session_union(const void* kh, const void* st,
                                    const void* en, long long n,
                                    int buffer_form, void* out,
                                    void* new_flag, void* ws, void* stream) {
  if (n <= 0) return n == 0 ? cudaSuccess : cudaErrorInvalidValue;
  if (n >= (1ll << 40)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long chunks = 1;
  long long n_tiles = 1;
  unsigned threads = kThreads;
  size_t smem = 0;
  if (n > kTile) {
    // about two tiles an SM, a tile at most kMaxChunks steps a warp
    int dev = 0, sms = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) {
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (ws == nullptr || sms <= 0) return cudaErrorInvalidValue;
    const long long per = static_cast<long long>(kTile) * 2 * sms;
    chunks = (n + per - 1) / per;
    if (chunks > kMaxChunks) chunks = kMaxChunks;
    n_tiles = (n + chunks * kTile - 1) / (chunks * kTile);
    if (n_tiles > INT_MAX / 16) return cudaErrorInvalidValue;
    smem = static_cast<size_t>(3 * chunks * kTile) * sizeof(long long);
    rc = cudaMemsetAsync(
        ws, 0, static_cast<size_t>(1 + 2 * n_tiles) * sizeof(long long), s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  } else {
    threads = static_cast<unsigned>((n + kWarpRows - 1) / kWarpRows) * 32;
  }
  const auto* a = static_cast<const long long*>(kh);
  const auto* b = static_cast<const long long*>(st);
  const auto* c = static_cast<const long long*>(en);
  auto* o = static_cast<long long*>(out);
  auto* w = static_cast<long long*>(ws);
  const unsigned blocks = static_cast<unsigned>(n_tiles);
  const int tiles = static_cast<int>(n_tiles);
  const int steps = static_cast<int>(chunks);
  const cudaError_t rc =
      buffer_form ? stash_limit<true>(smem) : stash_limit<false>(smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (buffer_form) {
    union_kernel<true><<<blocks, threads, smem, s>>>(a, b, c, n, tiles,
                                                     steps, o, nullptr, w);
  } else {
    union_kernel<false><<<blocks, threads, smem, s>>>(
        a, b, c, n, tiles, steps, o, static_cast<unsigned char*>(new_flag),
        w);
  }
  return static_cast<int>(cudaGetLastError());
}
