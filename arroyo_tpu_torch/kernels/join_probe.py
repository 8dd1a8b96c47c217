"""K9 ``join_probe``: the candidate match ranges of sorted query keys in a
hot join partition's ring — per query the lower bound of its i32 ``hi``
image in the ring's sorted ``hi`` plane, its match count, and the
inclusive prefix sum of the counts.

Replaces arroyo_tpu/ops/join.py:76 ``_probe_kernel`` (both its
``searchsorted`` form and the merged-rank form the TPU takes; they agree).

Outputs: ``start`` i32[mq] and ``counts`` i32[mq], as the JAX kernel
returns them, and ``cum`` **i64**[mq] where the JAX kernel's is i32 — every
reader widens it, and a skewed partition's pair total may pass 2^31.
No caller in the port reads ``counts`` (the expansions work from ``start``
and ``cum``); it is kept so that the kernel's outputs stay those of the
JAX kernel and are held against them output for output, at 4 bytes
written per query.

On the H100 a probe at join-stress's shapes is bound by its launch (the
bytes are kilobytes).  The CUDA kernel (``csrc/join_probe.cu``) runs one
thread per query with two binary searches and scans the counts per 1,024
query tile: one launch for up to 1,024 queries, three (tile scan, carry
scan, fix-up) beyond.

``join_probe_reference`` is the plain PyTorch version (the same bisection,
vectorized over the queries); the wrapper takes it only for tensors on
the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

TILE = 1024  # queries per block of the tile scan (csrc/join_probe.cu)


def _check(q_hi: torch.Tensor, hi: torch.Tensor, m: int,
           n_valid: int) -> Tuple[int, int]:
    for name, t in (("q_hi", q_hi), ("hi", hi)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be i32 [n]")
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
    i64[mq])."""
    s = bisect(hi, q_hi, False).clamp(max=n_valid)
    e = bisect(hi, q_hi, True).clamp(max=n_valid)
    live = torch.arange(q_hi.shape[0], device=q_hi.device) < m
    counts = torch.where(live, e - s, 0)
    return s.to(torch.int32), counts.to(torch.int32), torch.cumsum(counts, 0)


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_join_probe
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p, ll, p, ll, ll, ll, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def join_probe(q_hi: torch.Tensor, hi: torch.Tensor, m: int, n_valid: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(start i32[mq], counts i32[mq], cum i64[mq]) of the sorted queries
    ``q_hi`` i32[mq] (``m`` real, the rest sentinel padding) in the sorted
    ring plane ``hi`` i32[cap] holding ``n_valid`` rows."""
    mq, cap = _check(q_hi, hi, m, n_valid)
    dev = q_hi.device
    if dev.type == "cpu":
        return join_probe_reference(q_hi, hi, m, n_valid)
    if dev.type != "cuda":
        raise ValueError(f"join_probe: unsupported device {dev}")
    n_tiles = (mq + TILE - 1) // TILE
    i32 = torch.empty(2 * mq, dtype=torch.int32, device=dev)
    i64 = torch.empty(mq + n_tiles, dtype=torch.int64, device=dev)
    start, counts = i32[:mq], i32[mq:]
    cum, tile_sum = i64[:mq], i64[mq:]
    if mq == 0:
        return start, counts, cum  # nothing to launch
    build.launch("join_probe", _c_fn(), dev, q_hi.data_ptr(), mq,
                 hi.data_ptr(), cap, m, n_valid, start.data_ptr(),
                 counts.data_ptr(), cum.data_ptr(), tile_sum.data_ptr())
    join_probe.launches += 1
    return start, counts, cum


join_probe.launches = 0
