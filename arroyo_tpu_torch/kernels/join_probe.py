"""K9 ``join_probe``: the match ranges of sorted query keys in a sorted key
plane — per query its lower bound in the plane, its match count, and the
inclusive prefix sum of the counts.  Two forms, two kernels:

* i32 keys: a hot join partition's ring — the queries' i32 ``hi`` images
  in the ring's sorted ``hi`` plane (candidate ranges on the top 32 hash
  bits; the caller verifies the full keys);
* u64 keys (i64 tensors holding the bits, ordered as UNSIGNED, as
  ``kernels/join_sort.py`` sets out; padding SENTINEL, all ones): the
  legacy join layout's full key hashes, a fire's sorted left keys against
  its sorted right keys (exact ranges).

Replaces arroyo_tpu/ops/join.py:76 ``_probe_kernel`` (both its
``searchsorted`` form and the merged-rank form the TPU takes; they agree).

Outputs: ``start`` i32[mq] and ``counts`` i32[mq], as the JAX kernel
returns them, and ``cum`` **i64**[mq] where the JAX kernel's is i32 — every
reader widens it, and a skewed partition's pair total may pass 2^31.
No caller in the port reads ``counts`` (the expansions work from ``start``
and ``cum``); it is kept so that the kernel's outputs stay those of the
JAX kernel and are held against them output for output, at 4 bytes
written per query.

The i32 form (csrc/join_probe.cu ``probe_tile``) serves join-stress's
hot rings, where a probe is bound by its launch (the bytes are
kilobytes) and by the latency of its searches: it stages the ring's live
rows in shared memory (all of them up to 32 KB — 8,192 rows — and 16 a
query, else evenly spaced samples, so only the last levels of a search
read global memory), answers a query above the plane's last row without
a search, gallops from the lower bound to the upper, and scans the
counts per 1,024-query tile: one launch up to 1,024 queries, three (tile
scan, carry scan, fix-up) beyond.

The u64 form (``probe_u64``) is a merge-path probe: both inputs are
sorted, so a block's tile of consecutive queries (:func:`u64_tile`:
1,024 or 2,048, or 64 on a plane of over four rows a query) matches the
plane window ``[lower_bound(first query), upper_bound(last real
query))``, found by two warp searches a tile.  The block stages the
window in shared memory (16-byte ``cp.async`` copies) and answers each
query there, merging each thread's consecutive queries into it by
gallops; a window over the staging budget (:func:`u64_stage_rows`)
stages every 2^shift-th row of it and finishes each search in global
memory within the window, still exact.  The counts' prefix sum is
scanned in the same launch by a decoupled look-back over the tiles'
totals: one launch for one tile, a memset of the ticket and status
words and one launch beyond.  ``tests/test_torch_probe_tiles.py``
writes its tile co-ranking in plain PyTorch.

The three outputs are views of ONE buffer (the scratch words after them
only when there are several tiles): one allocation and no host sync a
call.

``join_probe_reference`` is the plain PyTorch version (the same bisection,
vectorized over the queries, on the keys' unsigned order for the u64
form); the wrapper takes it only for tensors on the CPU.
``join_probe.launches`` counts both forms' launches,
``join_probe.u64_launches`` the u64 form's alone."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build
from .join_sort import unsigned_order

TILE = 1024  # queries per block (csrc/join_probe.cu)
BIG_TILE, WIDE_TILES = 2048, 512  # the u64 form's tile past 512 of TILE
SPARSE_TILE, SPARSE_RATIO = 64, 4  # and on sparse probes
U64_STAGE_MIN, U64_STAGE_MAX = 256, 4096  # u64 rows a block stages


def u64_tile(mq: int, n_valid: int) -> int:
    """The u64 form's queries a block (csrc/join_probe.cu ``tile_of``):
    64 when the plane holds over four rows a query, else 1,024 up to
    524,288 queries and 2,048 above."""
    if n_valid > SPARSE_RATIO * mq:
        return SPARSE_TILE
    return TILE if mq <= WIDE_TILES * TILE else BIG_TILE


def u64_stage_rows(m: int, n_valid: int, tile: int) -> int:
    """The u64 form's staging budget in rows (csrc/join_probe.cu
    ``stage_rows``): twice the plane window a tile of ``tile`` real
    queries expects, plus 64, within [256, 4,096], even.  A larger window
    is sampled."""
    expect = -(-tile * n_valid // m) if m > 0 else 0
    return min(max(2 * expect + 64, U64_STAGE_MIN), U64_STAGE_MAX) & ~1


def _check(q_hi: torch.Tensor, hi: torch.Tensor, m: int,
           n_valid: int) -> Tuple[int, int]:
    for name, t in (("q_hi", q_hi), ("hi", hi)):
        if t.dtype not in (torch.int32, torch.int64) or t.dim() != 1:
            raise TypeError(f"{name} must be i32 or i64 [n]")
    if q_hi.dtype != hi.dtype:
        raise TypeError(f"q_hi is {q_hi.dtype} but hi is {hi.dtype}")
    mq, cap = q_hi.shape[0], hi.shape[0]
    if cap <= 0 or not 0 <= m <= mq or not 0 <= n_valid <= cap:
        raise ValueError(f"join_probe: need cap > 0, 0 <= m <= mq and "
                         f"0 <= n_valid <= cap (m={m}, mq={mq}, "
                         f"n_valid={n_valid}, cap={cap})")
    if q_hi.device != hi.device:
        raise ValueError(f"tensors on several devices: {q_hi.device}, "
                         f"{hi.device}")
    if not (q_hi.is_contiguous() and hi.is_contiguous()):
        raise ValueError("join_probe needs contiguous tensors")
    return mq, cap


def bisect(a: torch.Tensor, q: torch.Tensor, strict: bool) -> torch.Tensor:
    """i64 per query: the first index i of sorted ``a`` with ``a[i] >= q``
    (``a[i] > q`` when ``strict``), ``len(a)`` when there is none — the
    kernels' binary search (csrc/join_search.cuh), vectorized."""
    n = a.shape[0]
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    for _ in range(n.bit_length()):
        mid = (lo + hi) // 2
        v = a[mid.clamp(max=max(n - 1, 0))]
        right = (v <= q) if strict else (v < q)
        active = lo < hi
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def join_probe_reference(q_hi: torch.Tensor, hi: torch.Tensor, m: int,
                         n_valid: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (start i32[mq], counts i32[mq], cum
    i64[mq]); i64 keys are searched in their unsigned order."""
    if hi.dtype == torch.int64:
        q_hi, hi = unsigned_order(q_hi), unsigned_order(hi)
    s = bisect(hi, q_hi, False).clamp(max=n_valid)
    e = bisect(hi, q_hi, True).clamp(max=n_valid)
    live = torch.arange(q_hi.shape[0], device=q_hi.device) < m
    counts = torch.where(live, e - s, 0)
    return s.to(torch.int32), counts.to(torch.int32), torch.cumsum(counts, 0)


@functools.lru_cache(maxsize=None)
def _c_fn(u64: bool):
    lib = build.load()
    fn = lib.arroyo_join_probe_u64 if u64 else lib.arroyo_join_probe
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p, ll, p, ll, ll, ll, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def join_probe(q_hi: torch.Tensor, hi: torch.Tensor, m: int, n_valid: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(start i32[mq], counts i32[mq], cum i64[mq]) of the sorted queries
    ``q_hi`` [mq] (``m`` real, the rest sentinel padding) in the sorted
    plane ``hi`` [cap] holding ``n_valid`` rows: both i32 (a ring's
    ``hi`` plane) or both i64 (u64 key bits, ordered as unsigned)."""
    mq, cap = _check(q_hi, hi, m, n_valid)
    dev = q_hi.device
    if dev.type == "cpu":
        return join_probe_reference(q_hi, hi, m, n_valid)
    if dev.type != "cuda":
        raise ValueError(f"join_probe: unsupported device {dev}")
    u64 = hi.dtype == torch.int64
    tile = u64_tile(mq, n_valid) if u64 else TILE
    n_tiles = (mq + tile - 1) // tile
    # scratch: the i32 form's tile totals, the u64 form's ticket and
    # status words
    scratch = 0 if n_tiles == 1 else n_tiles + u64
    buf = torch.empty(2 * mq + scratch, dtype=torch.int64, device=dev)
    cum, ws = buf[:mq], buf[2 * mq:]
    keys = buf[mq:2 * mq].view(torch.int32)
    start, counts = keys[:mq], keys[mq:]
    if mq == 0:
        return start, counts, cum  # nothing to launch
    build.launch("join_probe", _c_fn(u64), dev, q_hi.data_ptr(), mq,
                 hi.data_ptr(), cap, m, n_valid, start.data_ptr(),
                 counts.data_ptr(), cum.data_ptr(),
                 ws.data_ptr() if scratch else 0)
    join_probe.launches += 1
    join_probe.u64_launches += u64
    return start, counts, cum


join_probe.launches = 0
join_probe.u64_launches = 0
