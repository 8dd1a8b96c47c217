// segment_agg: per-segment sum / min / max / count of k channels over
// rows grouped into contiguous segments.
//
// Replaces arroyo_tpu/ops/segment.py:30 `_segment_agg_kernel` (XLA's
// segment_sum / segment_min / segment_max over padded segment ids).
//
// Semantics, for s < n_seg and c < k, rows r in [off[s], off[s + 1]),
// where v(c) is the row of `values` that channel c reads: the count of
// non-count channels before c (count channels read no values, so their
// rows are never uploaded):
//   counts[s]  = off[s + 1] - off[s]
//   out[c, s]  = sum_r values[v(c), r]         (kind sum,   identity 0)
//              = min_r values[v(c), r]         (kind min,   identity +inf)
//              = max_r values[v(c), r]         (kind max,   identity -inf)
//              = (double) counts[s]            (kind count)
// An empty segment (off[s] == off[s + 1]) gets the identities and count
// 0.  The caller passes exact n and n_seg (no padding rows, no trash
// segment).
//
// What bounds it on the H100: memory.  Every row of every reduced
// channel is read once (count channels read nothing) and one f64 per
// (channel, segment) plus one i64 per segment is written; one add or
// compare per value read.  At config5's shapes (k = 1 count channel, a
// few thousand rows) the call moves kilobytes and the launch dominates.
//
// What the design does about it: the work is cut by rows, not by
// segments, so every block does the same work whatever the segment
// lengths.  One launch a call, into one buffer.
// - Block b writes the counts and count channels of segments [b * 256,
//   (b + 1) * 256), and the identities of those that are empty: one
//   thread per segment, no value read.  A call with no value to reduce
//   (config5's COUNT(*)) launches a lean kernel that does only this.
// - Block b < tiles also reduces tile b's rows [b * 2048, (b + 1) *
//   2048), 8 consecutive rows a thread.  A thread's rows of a value row
//   land in its slot of shared memory by cp.async (no register holds
//   them in flight): the first row's before anything else, each next
//   one's while the current one's scan runs.  Meanwhile two warps find
//   the tile's first and last segment with one warp-cooperative search
//   of `offsets` each (warp_search.cuh), and the block stages that
//   stretch of `offsets` in shared memory (a stretch holding thousands
//   of empty segments stays in global memory).  Each thread folds its
//   rows in order; a segmented scan across the block joins the pieces
//   of a segment that several threads hold.  The scan's keys (each
//   thread's last segment) are the same for every channel, so their
//   part is planned once a tile and a channel's scan moves values only:
//   five shuffles and one barrier.  A segment inside the tile writes its
//   value; the piece of a segment that begins before the tile (its head)
//   and of one that goes on past it (its tail) go to scratch.  Capped at
//   64 registers, four blocks fit an SM, so the 512 tiles of 2^20 rows
//   run in one wave.
// - The last tile block to finish (an atomic ticket) joins the pieces of
//   every segment that crosses a tile edge, in tile order, and writes
//   them: each thread folds a stretch of the tiles' scratch (staged in
//   shared memory a channel at a time), then the same planned scan joins
//   the stretches.
// The order of additions is fixed by n and `offsets` alone, so the sums
// are deterministic from run to run (not XLA's order: rtol 1e-12).  A
// 2^20-row segment spreads over 512 blocks; 16-row segments keep every
// thread busy.  The ticket is one device-global counter that the last
// block sets back to 0: two launches of this kernel must not run at once
// on one device (the port launches on one stream).

#include <cuda_runtime.h>


#include "warp_search.cuh"

namespace {

constexpr int kMaxChannels = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                 // rows a thread folds
constexpr int kTile = kThreads * kPer;  // rows a block reduces
constexpr int kSegTile = kThreads;      // segments a block writes counts of
constexpr int kSlice = kTile + 2;       // offsets a block stages
constexpr int kPad = kPer + 1;          // a thread's slot: no bank conflict
constexpr int kBlocksPerSm = 4;         // all 512 tiles of 2^20 rows at once

enum Kind : int { kSum = 0, kMin = 1, kMax = 2, kCount = 3 };

// The channels' kinds, two bits each, in registers (an array indexed by
// the channel would live in local memory).
struct Spec {
  int k;
  unsigned long long lo, hi;  // channels 0-31, 32-63
  __device__ __forceinline__ int kind(int c) const {
    return static_cast<int>(((c < 32 ? lo : hi) >> (2 * (c & 31))) & 3);
  }
};

__device__ unsigned int g_tiles_done = 0;

// An empty segment's MIN/MAX is XLA's segment_min/segment_max value:
// +inf/-inf.
__device__ __forceinline__ double identity(int kind) {
  const double inf = __longlong_as_double(0x7FF0000000000000LL);
  return kind == kSum ? 0.0 : (kind == kMin ? inf : -inf);
}

__device__ __forceinline__ double combine(int kind, double a, double b) {
  if (kind == kSum) return a + b;
  if (kind == kMin) return b < a ? b : a;
  return b > a ? b : a;
}

// offsets[x] for x in [lo, hi], from the staged copy when there is one.
struct Offsets {
  const long long* p;
  long long base;
  __device__ __forceinline__ long long operator()(long long x) const {
    return p[x - base];
  }
};

// The first x in [lo, hi) with off(x) > q, or hi.
__device__ __forceinline__ long long first_above(const Offsets& off,
                                                 long long lo, long long hi,
                                                 long long q) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (off(mid) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The segment holding row r, given that segment s ended at or before r
// (s < s_hi): the next one, unless empty segments lie between.
__device__ __forceinline__ long long next_segment(const Offsets& off,
                                                  long long s, long long s_hi,
                                                  long long r) {
  if (off(s + 2) > r) return s + 1;
  return first_above(off, s + 2, s_hi + 1, r) - 1;
}

// A segmented scan across the block of one element a thread whose keys
// (the thread's last segment, -1 for a thread without rows) are the same
// for every channel of a tile: the keys' part is planned once, so a
// channel's scan moves values only.  For each shuffle step of the warp
// scan, whether a lane keeps its value, combines the one d lanes before
// into it, or takes that one; then the run of earlier warps whose totals
// it folds in (warps [u0, warp)) and how.
enum Step : int { kKeep = 0, kJoin = 1, kTake = 2 };

struct ScanPlan {
  int steps;   // 2 bits a shuffle step
  int last;    // how the earlier warps' fold joins this lane's value
  int u0;      // the first earlier warp in that fold
  int incl;    // this thread's inclusive key
  int excl;    // the key of the element before it (-1: none)
};

__device__ __forceinline__ int step_of(int k, int kp) {
  if (kp < 0) return kKeep;
  if (k < 0) return kTake;
  return kp == k ? kJoin : kKeep;
}

// Every thread calls it (one barrier); s_wkey holds a key a warp.
__device__ ScanPlan plan_scan(int key, int* s_wkey) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  ScanPlan p;
  p.steps = 0;
  int k = key;
#pragma unroll
  for (int i = 0, d = 1; d < 32; ++i, d <<= 1) {
    const int kp = __shfl_up_sync(0xffffffffu, k, d);
    const int st = lane >= d ? step_of(k, kp) : kKeep;
    p.steps |= st << (2 * i);
    if (st == kTake) k = kp;
  }
  if (lane == 31) s_wkey[warp] = k;
  __syncthreads();
  const int pk = warp > 0 ? s_wkey[warp - 1] : -1;  // the earlier warps' key
  p.u0 = warp;
  while (pk >= 0 && p.u0 > 0 && s_wkey[p.u0 - 1] == pk) --p.u0;
  p.last = step_of(k, pk);
  if (p.last == kTake) k = pk;
  p.incl = k;
  p.excl = __shfl_up_sync(0xffffffffu, k, 1);
  if (lane == 0) p.excl = pk;
  return p;
}

// The channel's scan under `p`: *incl the fold of this thread's segment
// up to and with it, *excl that of the element before it.  One barrier;
// s_val (a value a warp) must not be written again before the next.
__device__ __forceinline__ void planned_scan(int kind, const ScanPlan& p,
                                             double v, double* s_val,
                                             double* incl, double* excl) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0, d = 1; d < 32; ++i, d <<= 1) {
    const double vp = __shfl_up_sync(0xffffffffu, v, d);
    const int st = (p.steps >> (2 * i)) & 3;
    if (st == kJoin) {
      v = combine(kind, vp, v);
    } else if (st == kTake) {
      v = vp;
    }
  }
  if (lane == 31) s_val[warp] = v;
  __syncthreads();
  double pv = identity(kind);
  for (int u = p.u0; u < warp; ++u) pv = combine(kind, pv, s_val[u]);
  if (p.last == kJoin) {
    v = combine(kind, pv, v);
  } else if (p.last == kTake) {
    v = pv;
  }
  double e = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) e = pv;
  *incl = v;
  *excl = e;
}

// Counts, count channels and the identities of empty segments, for the
// segments [blockIdx.x * kSegTile, (blockIdx.x + 1) * kSegTile): one
// thread per segment, no value read.
__device__ __forceinline__ void write_segments(
    const long long* __restrict__ offsets, int n_seg, const Spec& spec,
    long long* __restrict__ counts, double* __restrict__ out) {
  const long long seg_end =
      min(static_cast<long long>(blockIdx.x + 1) * kSegTile,
          static_cast<long long>(n_seg));
  for (long long s = static_cast<long long>(blockIdx.x) * kSegTile +
                     threadIdx.x;
       s < seg_end; s += kThreads) {
    const long long cnt = offsets[s + 1] - offsets[s];
    counts[s] = cnt;
    for (int c = 0; c < spec.k; ++c) {
      const int kind = spec.kind(c);
      if (kind == kCount) {
        out[static_cast<long long>(c) * n_seg + s] = static_cast<double>(cnt);
      } else if (cnt == 0) {
        out[static_cast<long long>(c) * n_seg + s] = identity(kind);
      }
    }
  }
}

// A call that reduces no value (only count channels, or no rows).
__global__ void __launch_bounds__(kThreads)
    segment_count_kernel(const long long* __restrict__ offsets, int n_seg,
                         Spec spec, long long* __restrict__ buf) {
  write_segments(offsets, n_seg, spec, buf,
                 reinterpret_cast<double*>(buf + n_seg));
}

// Starts the copy of a thread's rows [a, b) of one value row into its
// slot in shared memory (cp.async: no register holds them in flight);
// cp.async.wait_all ends it.
__device__ __forceinline__ void copy_rows(const double* __restrict__ v,
                                          long long a, long long b,
                                          double* slot) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (a + i < b) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(slot + i));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                   "l"(v + a + i));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    segment_agg_kernel(const double* __restrict__ values, long long n,
                       const long long* __restrict__ offsets, int n_seg,
                       Spec spec, int k_r, long long tiles,
                       long long* __restrict__ buf,
                       long long* __restrict__ codes,
                       double* __restrict__ parts) {
  __shared__ long long s_off[kSlice];  // then the tiles' codes
  // each thread's slot of the value row it folds next, then a channel's
  // tile pieces
  __shared__ double s_v[kThreads * kPad];
  __shared__ int s_wkey[kWarps];
  __shared__ double s_val[2][kWarps];  // a channel's scan, by parity
  __shared__ long long s_bounds[2];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  long long* counts = buf;
  double* out = reinterpret_cast<double*>(buf + n_seg);  // [k, n_seg]
  write_segments(offsets, n_seg, spec, counts, out);
  const long long tile = blockIdx.x;
  if (tile >= tiles) return;

  // this thread's rows [a, b) of the tile's [base, end); the first value
  // row is loaded before the searches, so its latency hides theirs
  const long long base = tile * kTile;
  const long long end = min(base + kTile, n);
  const long long a = min(base + static_cast<long long>(tid) * kPer, end);
  const long long b = min(a + kPer, end);
  const bool rows = a < b;
  // the first value row starts loading before the searches
  double* slot = s_v + tid * kPad;
  copy_rows(values, a, b, slot);

  // the tile's first and last segment
  if (tid < 64) {
    const long long q = tid < 32 ? base : end - 1;
    const long long s = warp_count_le(offsets, n_seg + 1, q) - 1;
    if ((tid & 31) == 0) s_bounds[tid >> 5] = s;
  }
  __syncthreads();
  const long long s_lo = s_bounds[0];
  const long long s_hi = s_bounds[1];
  const long long span = s_hi - s_lo + 2;  // offsets[s_lo .. s_hi + 1]
  Offsets off{offsets, 0};
  if (span <= kSlice) {
    for (long long i = tid; i < span; i += kThreads) {
      s_off[i] = offsets[s_lo + i];
    }
    off = Offsets{s_off, s_lo};
  }
  __syncthreads();
  const bool head_in = off(s_lo) < base;  // s_lo began in an earlier tile
  const bool tail_out = off(s_hi + 1) > end;  // s_hi goes on past the tile
  // a tile inside one segment keeps its one piece as that segment's head
  const bool tail_piece = tail_out && !(head_in && s_hi == s_lo);
  if (tid == 0 && tiles > 1) {
    codes[2 * tile] =
        head_in ? 2 * s_lo + (off(s_lo + 1) <= end ? 1 : 0) : -1;
    codes[2 * tile + 1] = tail_piece ? 2 * s_hi : -1;
  }
  long long s_first = s_lo;  // the segments of this thread's first and
  long long s_end = -1;      // last row
  if (rows) {
    s_first = first_above(off, s_lo + 1, s_hi + 1, a) - 1;
    s_end = first_above(off, s_first + 1, s_hi + 1, b - 1) - 1;
  }
  const ScanPlan plan = plan_scan(
      rows ? static_cast<int>(s_end - s_lo) : -1, s_wkey);
  const long long s_before = plan.excl < 0 ? -1 : s_lo + plan.excl;

  int r_ch = 0;  // value row of the next reduced channel
  for (int c = 0; c < spec.k; ++c) {
    const int kind = spec.kind(c);
    if (kind == kCount) continue;
    const double ident = identity(kind);
    double* oc = out + static_cast<long long>(c) * n_seg;
    double* pc = parts + static_cast<long long>(r_ch) * 2 * tiles;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    double x[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) x[i] = slot[i];
    // fold the rows in order: a segment that ends inside the rows is
    // done; the first one may have begun in an earlier thread
    long long s = s_first;
    long long s_next = off(s + 1);
    bool first_open = true;
    double first_val = ident;
    double acc = ident;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long r = a + i;
      if (r < b) {
        if (r >= s_next) {
          if (first_open) {
            first_val = acc;
            first_open = false;
          } else {
            oc[s] = acc;  // began and ended in this thread's rows
          }
          s = next_segment(off, s, s_hi, r);
          s_next = off(s + 1);
          acc = ident;
        }
        acc = combine(kind, acc, x[i]);
      }
    }
    if (r_ch + 1 < k_r) {  // x is folded: the slot takes the next row
      copy_rows(values + static_cast<long long>(r_ch + 1) * n, a, b, slot);
    }
    ++r_ch;
    double iv, ev;
    planned_scan(kind, plan, rows ? acc : ident, s_val[r_ch & 1], &iv, &ev);
    if (!rows) continue;
    if (!first_open) {
      const double val =
          s_before == s_first ? combine(kind, ev, first_val) : first_val;
      if (head_in && s_first == s_lo) {
        pc[2 * tile] = val;
      } else {
        oc[s_first] = val;
      }
    }
    if (s_next <= b) {  // the last segment ends with this thread's rows
      if (head_in && s == s_lo) {
        pc[2 * tile] = iv;
      } else {
        oc[s] = iv;
      }
    } else if (b == end) {  // it goes on past the tile
      pc[2 * tile + (tail_piece ? 1 : 0)] = iv;
    }
  }
  if (tiles == 1) return;

  // the last tile block to finish joins the pieces across tile edges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(&g_tiles_done, 1u) ==
             static_cast<unsigned int>(tiles - 1);
  }
  __syncthreads();
  if (!s_last) return;
  // the tiles' pieces in tile order, thread t folding items [t * per,
  // (t + 1) * per), then the same planned segmented scan as a tile's:
  // the codes, and each channel's pieces in turn, staged in shared memory
  // first when they fit
  const long long items = 2 * tiles;
  const bool staged = items <= kSlice;
  const bool parts_staged = staged && items <= kThreads * kPad;
  if (staged) {
    for (long long j = tid; j < items; j += kThreads) {
      s_off[j] = __ldcg(codes + j);
    }
  }
  __syncthreads();
  const long long* sc = staged ? s_off : codes;
  const long long per = (items + kThreads - 1) / kThreads;
  const long long j_lo = min(tid * per, items);
  const long long j_hi = min(j_lo + per, items);
  long long first_key = -1;  // this thread's first and last segment, and
  long long last_key = -1;   // whether the last one's last piece is here
  bool ends = false;
  for (long long j = j_lo; j < j_hi; ++j) {
    const long long code = staged ? sc[j] : __ldcg(sc + j);
    if (code < 0) continue;
    if (first_key < 0) first_key = code >> 1;
    last_key = code >> 1;
    ends = code & 1;
  }
  const ScanPlan cplan = plan_scan(static_cast<int>(last_key), s_wkey);
  r_ch = 0;
  for (int c = 0; c < spec.k; ++c) {
    const int kind = spec.kind(c);
    if (kind == kCount) continue;
    const double ident = identity(kind);
    double* oc = out + static_cast<long long>(c) * n_seg;
    const double* pc = parts + r_ch * items;
    if (parts_staged) {  // the last channel's folds are done: s_v is free
      for (long long j = tid; j < items; j += kThreads) s_v[j] = __ldcg(pc + j);
      pc = s_v;
      __syncthreads();
    }
    ++r_ch;
    long long s = -1;  // the segment of the piece folded last
    bool first_open = true;
    double first_val = ident;
    double acc = ident;
    for (long long j = j_lo; j < j_hi; ++j) {
      const long long code = staged ? sc[j] : __ldcg(sc + j);
      if (code < 0) continue;
      const double p = parts_staged ? pc[j] : __ldcg(pc + j);
      const long long key = code >> 1;
      if (key != s) {
        if (s >= 0) {
          if (first_open) {
            first_val = acc;
            first_open = false;
          } else {
            oc[s] = acc;  // every piece of it lies in these items
          }
        }
        s = key;
        acc = ident;
      }
      acc = combine(kind, acc, p);
    }
    double iv, ev;
    planned_scan(kind, cplan, s >= 0 ? acc : ident, s_val[r_ch & 1], &iv,
                 &ev);
    if (s < 0) continue;
    if (!first_open) {
      oc[first_key] =
          cplan.excl == first_key ? combine(kind, ev, first_val) : first_val;
    }
    if (ends) oc[s] = iv;
  }
  if (tid == 0) g_tiles_done = 0;
}

}  // namespace

// values f64[k_r, n] (one row of n per channel that is not a count, in
// channel order; k_r may be 0), offsets i64[n_seg + 1] on the device
// (offsets[0] = 0, offsets[n_seg] = n, non-decreasing); kinds is a HOST
// array of k codes (0 sum, 1 min, 2 max, 3 count).  buf i64 holds
// [k + 1, n_seg] — row 0 the counts, rows 1.. the f64 channels as their
// bits — then `scratch` words, at least 2 * (k_r + 1) * tiles when more
// than one tile of 2,048 rows is reduced.  One launch on `stream`;
// returns cudaGetLastError().
extern "C" int arroyo_segment_agg(const void* values, long long n,
                                  const void* offsets, int n_seg,
                                  const int* kinds, int k, void* buf,
                                  long long scratch, void* stream) {
  if (k < 0 || k > kMaxChannels || n_seg < 0 || n < 0)
    return cudaErrorInvalidValue;
  Spec spec{k, 0, 0};
  int k_r = 0;
  for (int c = 0; c < k; ++c) {
    if (kinds[c] < kSum || kinds[c] > kCount) return cudaErrorInvalidValue;
    (c < 32 ? spec.lo : spec.hi) |=
        static_cast<unsigned long long>(kinds[c]) << (2 * (c & 31));
    k_r += kinds[c] != kCount;
  }
  if (n_seg == 0) return cudaSuccess;
  const long long tiles = k_r > 0 ? (n + kTile - 1) / kTile : 0;
  const long long need = tiles > 1 ? 2 * (k_r + 1) * tiles : 0;
  if (scratch < need) return cudaErrorInvalidValue;
  const long long seg_blocks = (n_seg + kSegTile - 1) / kSegTile;
  const long long blocks = tiles > seg_blocks ? tiles : seg_blocks;
  long long* out = static_cast<long long*>(buf);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiles == 0) {
    segment_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const long long*>(offsets), n_seg, spec, out);
  } else {
    long long* codes = out + static_cast<long long>(k + 1) * n_seg;
    segment_agg_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const double*>(values), n,
        static_cast<const long long*>(offsets), n_seg, spec, k_r, tiles, out,
        codes, reinterpret_cast<double*>(codes + 2 * tiles));
  }
  return static_cast<int>(cudaGetLastError());
}
