"""K10 ``join_expand``: a join probe's candidate ranges expanded into
(query, ring position) pairs — keys-only, unverified (the caller checks
the full keys against its host mirror).

Replaces arroyo_tpu/ops/join.py:121 ``_expand_kernel``.

For pair j < total: ``lidx[j]`` = #{i : cum[i] <= j} clipped to
[0, mq - 1], ``ridx[j]`` = start[lidx[j]] + j - cum[lidx[j] - 1] (0 for
the first query).  Both are i64 (the JAX kernel returns i32 padded to a
power-of-two bucket; its caller widens and slices).

On the H100 it is bound by memory (16 bytes written per pair) and, at
join-stress's shapes, by its launch.  The CUDA kernel
(``csrc/join_expand.cu``) runs ``expand_gather``'s staged expansion
(``csrc/join_search.cuh``): a block of 512 pairs stages ``cum`` (or its
stretch of it) in shared memory and each pair finds its query by a
binary search there, so a skewed query's pairs spread over as many
threads as it has pairs.  It reads the pair total on the device
(``cum[mq - 1]``) and writes it, then the first min(total, capacity)
pairs, into ONE i64 buffer (:func:`join_expand_buffer`; split it with
:func:`pair_views`), so the join launches it right behind the probe and
reads the buffer back in one copy; :func:`join_expand` is the JAX
kernel's form, sized to a known total.

``join_expand_reference`` is the plain PyTorch version (the same search,
vectorized over the pairs); the wrapper takes it only for tensors on the
CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build
from .join_probe import bisect


def check_ranges(start: torch.Tensor, cum: torch.Tensor, total: int) -> int:
    """Validate a probe's (start i32[mq], cum i64[mq]) and the pair total
    to expand; returns mq."""
    if start.dtype != torch.int32 or start.dim() != 1:
        raise TypeError("start must be i32 [mq]")
    if cum.dtype != torch.int64 or cum.shape != start.shape:
        raise TypeError(f"cum must be i64 [{start.shape[0]}]")
    mq = start.shape[0]
    if total < 0 or (total > 0 and mq == 0):
        raise ValueError(f"bad pair total {total} for {mq} queries")
    if start.device != cum.device:
        raise ValueError(f"tensors on several devices: {start.device}, "
                         f"{cum.device}")
    if not (start.is_contiguous() and cum.is_contiguous()):
        raise ValueError("start and cum must be contiguous")
    return mq


def join_expand_reference(start: torch.Tensor, cum: torch.Tensor, total: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (lidx i64[total], ridx i64[total]) — the
    expansion every pair kernel shares (csrc/join_search.cuh)."""
    mq = start.shape[0]
    j = torch.arange(total, dtype=torch.int64, device=start.device)
    lidx = bisect(cum, j, True).clamp(0, max(mq - 1, 0))
    before = torch.where(lidx > 0, cum[(lidx - 1).clamp(min=0)], 0)
    return lidx, start[lidx].to(torch.int64) + (j - before)


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_join_expand
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p, p, ll, ll, p, p]
    fn.restype = ctypes.c_int
    return fn


def pair_views(buf, total: int, capacity: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lidx, ridx) of ``total`` pairs viewing a :func:`join_expand_buffer`
    of ``capacity`` pairs (default: the total) — a tensor or its numpy
    copy."""
    capacity = total if capacity is None else capacity
    rows = buf[1:1 + 2 * capacity].reshape(2, capacity)
    return rows[0, :total], rows[1, :total]


def join_expand_buffer(start: torch.Tensor, cum: torch.Tensor, capacity: int
                       ) -> torch.Tensor:
    """i64[1 + 2 * capacity]: the pair total ``cum[mq - 1]``, read on the
    device, then the lidx and ridx rows of the first min(total,
    ``capacity``) pairs of the candidate ranges ``start`` i32[mq] /
    ``cum`` i64[mq] that :func:`join_probe` returned."""
    mq = check_ranges(start, cum, 0)
    if capacity < 0:
        raise ValueError(f"join_expand: capacity {capacity} < 0")
    dev = start.device
    buf = torch.empty(1 + 2 * capacity, dtype=torch.int64, device=dev)
    if dev.type == "cpu":
        total = int(cum[-1]) if mq else 0
        n = min(total, capacity)
        buf[0] = total
        for view, part in zip(pair_views(buf, n, capacity),
                              join_expand_reference(start, cum, n)):
            view.copy_(part)
        return buf
    if dev.type != "cuda":
        raise ValueError(f"join_expand: unsupported device {dev}")
    build.launch("join_expand", _c_fn(), dev, start.data_ptr(), cum.data_ptr(),
                 mq, capacity, buf.data_ptr())
    join_expand.launches += 1
    return buf


def join_expand(start: torch.Tensor, cum: torch.Tensor, total: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lidx i64[total], ridx i64[total]) of the candidate ranges
    ``start`` i32[mq] / ``cum`` i64[mq] that :func:`join_probe`
    returned; ``total`` is ``cum[mq - 1]``, which the caller has read.
    On the card: views of one :func:`join_expand_buffer`."""
    check_ranges(start, cum, total)
    dev = start.device
    if dev.type == "cpu":
        return join_expand_reference(start, cum, total)
    if total == 0:  # nothing to launch
        return pair_views(torch.zeros(1, dtype=torch.int64, device=dev), 0)
    return pair_views(join_expand_buffer(start, cum, total), total)


join_expand.launches = 0
