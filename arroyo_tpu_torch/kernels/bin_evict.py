"""K4 ``bin_evict``: reset expired ring columns of the keyed bin ring, in
place — counts to 0, each channel to its aggregation identity.

Replaces arroyo_tpu/ops/keyed_bins.py:262 ``_evict_kernel``.

On the H100 it is bound by memory: pure stores of (count itemsize + 8 per
channel) bytes for every (slot, expired column).  The CUDA kernel
(``csrc/bin_evict.cu``) writes only the expired columns, one thread per
(slot, column), where the JAX kernel rewrites both planes whole.

``bin_evict_reference`` is the plain PyTorch version; the wrapper takes it
only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from . import build
from .bin_update import KIND_CODES, channel_identity


def _check(values: torch.Tensor, counts: torch.Tensor, cols: torch.Tensor,
           kinds: Sequence[str]) -> None:
    if values.dtype != torch.float64 or values.dim() != 3:
        raise TypeError("values must be f64 [n_ch, C, B]")
    n_ch, C, B = values.shape
    if counts.dtype not in (torch.int32, torch.int64) or \
            tuple(counts.shape) != (C, B):
        raise TypeError("counts must be i32/i64 [C, B]")
    if cols.dtype != torch.int32 or cols.dim() != 1:
        raise TypeError("cols must be i32 [e]")
    if len(kinds) != n_ch or any(k not in KIND_CODES for k in kinds):
        raise ValueError(f"kinds {kinds!r} do not match {n_ch} channels")
    devs = {t.device for t in (values, counts, cols)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in (values, counts, cols)):
        raise ValueError("bin_evict needs contiguous tensors")


def bin_evict_reference(values: torch.Tensor, counts: torch.Tensor,
                        cols: torch.Tensor, kinds: Sequence[str]) -> None:
    """Plain PyTorch version: a [B] column mask, then ``masked_fill_``
    per plane.  Columns outside [0, B) are skipped."""
    B = counts.shape[1]
    c = cols.long()
    c = c[(c >= 0) & (c < B)]
    mask = torch.zeros(B, dtype=torch.bool, device=counts.device)
    mask[c] = True
    counts.masked_fill_(mask[None, :], 0)
    for j, kind in enumerate(kinds):
        values[j].masked_fill_(mask[None, :], channel_identity(kind))


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_bin_evict
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, p, i, i, i, p]
    fn.restype = i
    return fn


def bin_evict(values: torch.Tensor, counts: torch.Tensor, cols: torch.Tensor,
              kinds: Sequence[str]) -> None:
    """Reset the ring columns ``cols`` i32[e] of ``values`` f64[n_ch, C, B]
    and ``counts`` i32|i64[C, B] in place; ``kinds`` gives each channel's
    identity (sum/avg/count 0, min +f64 max, max -f64 max)."""
    _check(values, counts, cols, kinds)
    dev = values.device
    if dev.type == "cpu":
        bin_evict_reference(values, counts, cols, kinds)
        return
    if dev.type != "cuda":
        raise ValueError(f"bin_evict: unsupported device {dev}")
    n_ch, C, B = values.shape
    inits = np.asarray([channel_identity(k) for k in kinds], dtype=np.float64)
    build.launch("bin_evict", _c_fn(), dev, values.data_ptr(),
                 counts.data_ptr(), int(counts.dtype == torch.int64),
                 cols.data_ptr(), cols.shape[0], inits.ctypes.data, n_ch, C, B)
    bin_evict.launches += 1


bin_evict.launches = 0
