"""K1 ``bin_update``: scatter pre-aggregated (slot, bin) cells into the
keyed bin ring, in place.

Replaces arroyo_tpu/ops/keyed_bins.py:62 ``_update_kernel`` (XLA scatter)
and arroyo_tpu/ops/pallas_kernels.py:77 ``_scatter_kernel`` (its one-hot
MXU form on the TPU, reached through ``update_bin_state``, :212).

On the H100 it is bound by memory — scattered 8-byte read-modify-writes
per channel per cell — and, at nexmark q5's few-thousand-cell flushes,
by the launch itself.  The CUDA kernel (``csrc/bin_update.cu``) runs one
thread per cell with native f64 atomics, so duplicate cells are correct
without sorting and every flush is one launch.

Unlike the JAX kernel, which returns new arrays, the port updates
``values`` and ``counts`` where they lie.  ``bin_update_reference`` is
the plain PyTorch version of the same function; the wrapper takes it only
for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import build

KIND_CODES = {"sum": 0, "avg": 0, "count": 0, "min": 1, "max": 2}
F64_MAX = float(torch.finfo(torch.float64).max)


def channel_identity(kind: str) -> float:
    """Aggregation identity of a channel kind: +/- the f64 maximum for
    min/max (f32 extremes would clip values beyond 3.4e38), 0 for the
    additive kinds."""
    if kind == "min":
        return F64_MAX
    if kind == "max":
        return -F64_MAX
    return 0.0


def channel_sources(n_ch: int, dup: Sequence[int]) -> np.ndarray:
    """Packed row read by each channel: -1 for COUNT(*) channels (their
    value is the rowcount, packed row 0), else 1.. in channel order."""
    dup_set = frozenset(dup)
    srcs = np.empty(n_ch, dtype=np.int32)
    r = 1
    for j in range(n_ch):
        if j in dup_set:
            srcs[j] = -1
        else:
            srcs[j] = r
            r += 1
    return srcs


def _check(values: torch.Tensor, counts: torch.Tensor, idx: torch.Tensor,
           packed: torch.Tensor, kinds: Sequence[str],
           dup: Sequence[int]) -> Tuple[int, int, int, int]:
    if values.dtype != torch.float64 or values.dim() != 3:
        raise TypeError("values must be f64 [n_ch, C, B]")
    n_ch, C, B = values.shape
    if counts.dtype not in (torch.int32, torch.int64) or \
            tuple(counts.shape) != (C, B):
        raise TypeError("counts must be i32/i64 [C, B]")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != 2:
        raise TypeError("idx must be i32 [2, m]")
    m = idx.shape[1]
    n_src = 1 + n_ch - len(frozenset(dup))
    if packed.dtype != torch.float64 or tuple(packed.shape) != (n_src, m):
        raise TypeError(f"packed must be f64 [{n_src}, {m}]")
    if len(kinds) != n_ch or any(k not in KIND_CODES for k in kinds):
        raise ValueError(f"kinds {kinds!r} do not match {n_ch} channels")
    devs = {t.device for t in (values, counts, idx, packed)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in (values, counts, idx, packed)):
        raise ValueError("bin_update needs contiguous tensors")
    return n_ch, C, B, m


def bin_update_reference(values: torch.Tensor, counts: torch.Tensor,
                         idx: torch.Tensor, packed: torch.Tensor,
                         kinds: Sequence[str], dup: Sequence[int] = ()
                         ) -> None:
    """Plain PyTorch version: masked ``index_put_(accumulate=True)`` for
    counts and additive channels, ``scatter_reduce_`` for min/max."""
    n_ch, C, B = values.shape
    s = idx[0].long()
    b = idx[1].long()
    rc = packed[0]
    ok = (rc > 0.5) & (s >= 0) & (s < C) & (b >= 0) & (b < B)
    s, b, rc = s[ok], b[ok], rc[ok]
    counts.index_put_((s, b), rc.to(counts.dtype), accumulate=True)
    srcs = channel_sources(n_ch, dup)
    flat = s * B + b
    for j, kind in enumerate(kinds):
        x = rc if srcs[j] < 0 else packed[int(srcs[j])][ok]
        if KIND_CODES[kind] == 0:
            values[j].index_put_((s, b), x, accumulate=True)
        else:
            values[j].view(-1).scatter_reduce_(
                0, flat, x, reduce="amin" if kind == "min" else "amax",
                include_self=True)


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_bin_update
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, p, p, i, i, i, i, p]
    fn.restype = i
    return fn


def bin_update(values: torch.Tensor, counts: torch.Tensor,
               idx: torch.Tensor, packed: torch.Tensor,
               kinds: Sequence[str], dup: Sequence[int] = ()) -> None:
    """Apply cells to the planes in place.

    ``values`` f64[n_ch, C, B], ``counts`` i32|i64[C, B], ``idx``
    i32[2, m] (slots, bins), ``packed`` f64[1 + n_xfer, m] (rowcount, then
    the non-COUNT(*) channels in order), ``kinds`` one of
    sum/avg/count/min/max per channel, ``dup`` the COUNT(*) channels whose
    value is the rowcount.  A cell with rowcount <= 0.5, or a slot or bin
    outside the planes, is skipped."""
    n_ch, C, B, m = _check(values, counts, idx, packed, kinds, dup)
    if values.device.type == "cpu":
        bin_update_reference(values, counts, idx, packed, kinds, dup)
        return
    if values.device.type != "cuda":
        raise ValueError(f"bin_update: unsupported device {values.device}")
    kinds_np = np.array([KIND_CODES[k] for k in kinds], dtype=np.int32)
    srcs = channel_sources(n_ch, dup)
    build.launch("bin_update", _c_fn(), values.device, values.data_ptr(),
                 counts.data_ptr(), int(counts.dtype == torch.int64),
                 idx.data_ptr(), packed.data_ptr(), kinds_np.ctypes.data,
                 srcs.ctypes.data, n_ch, C, B, m)
    bin_update.launches += 1


bin_update.launches = 0
