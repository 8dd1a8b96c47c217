"""K3 ``pane_emit``: the dense pane fire — per (key slot, pane) the pane's
row count and each transferred channel's aggregate over the pane's ring
bins, for the occupied slots and real panes only.

Replaces arroyo_tpu/ops/keyed_bins.py:123 ``_emit_kernel`` and the channel
reduction it shares, :109 ``_pane_reduce``.

On the H100 it is bound by memory: W count cells and W cells per channel
read, one count and one f64 per channel written, for each output element
(about 8 MB at nexmark q8's C = 2^20, W = 1, COUNT(*) fire).  The CUDA
kernel (``csrc/pane_emit.cu``) runs one thread per output element and
writes only ``[c_slice, k]``, so the readback needs no device-side slice.

``pane_emit_reference`` is the plain PyTorch version; the wrapper takes it
only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import build
from .bin_update import KIND_CODES, channel_identity


def _check(values: torch.Tensor, counts: torch.Tensor, ring: torch.Tensor,
           bin_ok: torch.Tensor, kinds: Sequence[str],
           xfer: Sequence[int], c_slice: int) -> Tuple[int, int, int, int]:
    if values.dtype != torch.float64 or values.dim() != 3:
        raise TypeError("values must be f64 [n_ch, C, B]")
    n_ch, C, B = values.shape
    if counts.dtype not in (torch.int32, torch.int64) or \
            tuple(counts.shape) != (C, B):
        raise TypeError("counts must be i32/i64 [C, B]")
    if ring.dtype != torch.int32 or ring.dim() != 2:
        raise TypeError("ring must be i32 [k, W]")
    k, W = ring.shape
    if bin_ok.dtype != torch.bool or tuple(bin_ok.shape) != (k, W):
        raise TypeError(f"bin_ok must be bool [{k}, {W}]")
    if len(kinds) != n_ch or any(x not in KIND_CODES for x in kinds):
        raise ValueError(f"kinds {kinds!r} do not match {n_ch} channels")
    if any(not 0 <= j < n_ch for j in xfer):
        raise ValueError(f"xfer channels {xfer!r} outside {n_ch} channels")
    if not 0 <= c_slice <= C:
        raise ValueError(f"c_slice {c_slice} outside [0, {C}]")
    devs = {t.device for t in (values, counts, ring, bin_ok)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in (values, counts, ring, bin_ok)):
        raise ValueError("pane_emit needs contiguous tensors")
    return C, B, k, W


def pane_emit_reference(values: torch.Tensor, counts: torch.Tensor,
                        ring: torch.Tensor, bin_ok: torch.Tensor,
                        kinds: Sequence[str], xfer: Sequence[int],
                        c_slice: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: gather [c_slice, k, W] per plane, mask the
    bins outside the pane, reduce over W."""
    ring_l = ring.long()
    ok = bin_ok[None]  # [1, k, W]
    cnt = counts[:c_slice]
    cnts = torch.where(ok, cnt[:, ring_l], 0).sum(-1, dtype=counts.dtype)
    outs = []
    for j in xfer:
        g = values[j, :c_slice][:, ring_l]  # [c_slice, k, W]
        kind = kinds[j]
        masked = torch.where(ok, g, channel_identity(kind))
        if kind == "min":
            outs.append(masked.amin(-1))
        elif kind == "max":
            outs.append(masked.amax(-1))
        else:
            outs.append(masked.sum(-1))
    if outs:
        return torch.stack(outs), cnts
    return (torch.zeros((0, c_slice, ring.shape[0]), dtype=torch.float64,
                        device=values.device), cnts)


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_pane_emit
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def pane_emit(values: torch.Tensor, counts: torch.Tensor, ring: torch.Tensor,
              bin_ok: torch.Tensor, kinds: Sequence[str], xfer: Sequence[int],
              c_slice: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outs f64[len(xfer), c_slice, k], cnts[c_slice, k]) for the panes
    ``ring`` i32[k, W] / ``bin_ok`` bool[k, W] over ``values`` f64[n_ch,
    C, B] and ``counts`` i32|i64[C, B]; ``kinds`` names each channel's
    reduction (sum/avg/count add, min, max) and ``xfer`` the channels that
    are read out.  ``cnts`` keeps the counts dtype."""
    C, B, k, W = _check(values, counts, ring, bin_ok, kinds, xfer, c_slice)
    dev = values.device
    if dev.type == "cpu":
        return pane_emit_reference(values, counts, ring, bin_ok, kinds, xfer,
                                   c_slice)
    if dev.type != "cuda":
        raise ValueError(f"pane_emit: unsupported device {dev}")
    outs = torch.empty((len(xfer), c_slice, k), dtype=torch.float64,
                       device=dev)
    cnts = torch.empty((c_slice, k), dtype=counts.dtype, device=dev)
    chans = np.asarray(list(xfer), dtype=np.int32)
    codes = np.asarray([KIND_CODES[kinds[j]] for j in xfer], dtype=np.int32)
    build.launch("pane_emit", _c_fn(), dev, values.data_ptr(),
                 counts.data_ptr(), int(counts.dtype == torch.int64),
                 ring.data_ptr(), bin_ok.data_ptr(), chans.ctypes.data,
                 codes.ctypes.data, len(xfer), C, B, W, k, c_slice,
                 outs.data_ptr(), cnts.data_ptr())
    pane_emit.launches += 1
    return outs, cnts


pane_emit.launches = 0
