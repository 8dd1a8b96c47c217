"""K10 ``join_expand``: a join probe's candidate ranges expanded into
(query, ring position) pairs — keys-only, unverified (the caller checks
the full keys against its host mirror).

Replaces arroyo_tpu/ops/join.py:121 ``_expand_kernel``.

For pair j < total: ``lidx[j]`` = #{i : cum[i] <= j} clipped to
[0, mq - 1], ``ridx[j]`` = start[lidx[j]] + j - cum[lidx[j] - 1] (0 for
the first query).  Both are i64 and sized to the exact ``total`` (the JAX
kernel returns i32 padded to a power-of-two bucket; its caller widens and
slices).

On the H100 it is bound by memory (16 bytes written per pair) and, at
join-stress's shapes, by its launch.  The CUDA kernel
(``csrc/join_expand.cu``) runs one thread per pair with an upper-bound
binary search over ``cum``, so a skewed query's pairs spread over as many
threads as it has pairs.

``join_expand_reference`` is the plain PyTorch version (the same search,
vectorized over the pairs); the wrapper takes it only for tensors on the
CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

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
    fn.argtypes = [p, p, ll, ll, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def join_expand(start: torch.Tensor, cum: torch.Tensor, total: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lidx i64[total], ridx i64[total]) of the candidate ranges
    ``start`` i32[mq] / ``cum`` i64[mq] that :func:`join_probe`
    returned; ``total`` is ``cum[mq - 1]``, which the caller has read."""
    mq = check_ranges(start, cum, total)
    dev = start.device
    if dev.type == "cpu":
        return join_expand_reference(start, cum, total)
    if dev.type != "cuda":
        raise ValueError(f"join_expand: unsupported device {dev}")
    out = torch.empty((2, total), dtype=torch.int64, device=dev)
    lidx, ridx = out[0], out[1]
    if total == 0:
        return lidx, ridx  # nothing to launch
    build.launch("join_expand", _c_fn(), dev, start.data_ptr(), cum.data_ptr(),
                 mq, total, lidx.data_ptr(), ridx.data_ptr())
    join_expand.launches += 1
    return lidx, ridx


join_expand.launches = 0
