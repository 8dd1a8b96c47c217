"""K4 ``bin_evict``: reset expired ring columns of the keyed bin ring, in
place — counts to 0, each channel to its aggregation identity — for the
occupied key slots.

Replaces arroyo_tpu/ops/keyed_bins.py:262 ``_evict_kernel``.

The expired columns are the consecutive absolute bins ``first_bin ..
first_bin + n_bins - 1`` (at ring columns ``bin mod B``; ``n_bins >= B``
is every column), and only the slots below ``rows`` are written.  The JAX
kernel rewrites both planes whole; the port may stop at ``rows`` because
of an invariant of ``ops.keyed_bins.KeyedBinState``, which passes its
``next_slot``: **every cell at a slot >= next_slot holds its channel's
identity and count 0.**  Those cells are born so — ``__init__``
(identity planes), ``_grow`` (identity padding), ``_grow_ring`` and
``restore`` (identity planes, then only directory slots written) — and
``bin_update`` writes only slots the key directory handed out, which are
below ``next_slot``.  So after an evict both planes equal the JAX
kernel's whole-plane result (tests/test_torch_pane_evict.py holds them
equal).

On the H100 it is bound by memory: pure stores into the 32-byte sectors
that hold the expired columns of each occupied slot's rows.  The CUDA
kernel (``csrc/bin_evict.cu``) takes the columns and the identities by
value in the launch (no copy to the card, no column list in device
memory) and runs one thread per (slot, expired column) of a plane.

``bin_evict_reference`` is the plain PyTorch version; the wrapper takes it
only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import build
from .bin_update import KIND_CODES, channel_identity


def _columns(first_bin: int, n_bins: int, B: int) -> Tuple[int, int]:
    """(first ring column, column count) of the expired bins."""
    if n_bins < 0:
        raise ValueError(f"n_bins {n_bins} < 0")
    return int(first_bin) % B, min(int(n_bins), B)


@functools.lru_cache(maxsize=None)
def _inits(kinds: Tuple[str, ...]):
    """The channels' identities for the launch (a host array the launcher
    copies into the launch's arguments) and its address, built once per
    kinds."""
    if any(k not in KIND_CODES for k in kinds):
        raise ValueError(f"unknown channel kind in {kinds!r}")
    inits = (ctypes.c_double * max(len(kinds), 1))(
        *[channel_identity(k) for k in kinds])
    return inits, ctypes.addressof(inits)


def _check(values: torch.Tensor, counts: torch.Tensor, rows: int,
           kinds: Sequence[str]) -> None:
    if values.dtype != torch.float64 or values.dim() != 3:
        raise TypeError("values must be f64 [n_ch, C, B]")
    n_ch, C, B = values.shape
    if counts.dtype not in (torch.int32, torch.int64) or \
            counts.shape != (C, B):
        raise TypeError("counts must be i32/i64 [C, B]")
    if len(kinds) != n_ch:
        raise ValueError(f"kinds {kinds!r} do not match {n_ch} channels")
    if not 0 <= rows <= C:
        raise ValueError(f"rows {rows} outside [0, {C}]")
    if values.device != counts.device:
        raise ValueError(f"tensors on several devices: {values.device}, "
                         f"{counts.device}")
    if not (values.is_contiguous() and counts.is_contiguous()):
        raise ValueError("bin_evict needs contiguous tensors")


def bin_evict_reference(values: torch.Tensor, counts: torch.Tensor,
                        first_bin: int, n_bins: int, rows: int,
                        kinds: Sequence[str]) -> None:
    """Plain PyTorch version: a [B] column mask, then ``masked_fill_`` per
    plane over the first ``rows`` slots."""
    B = counts.shape[1]
    c0, e = _columns(first_bin, n_bins, B)
    mask = torch.zeros(B, dtype=torch.bool, device=counts.device)
    mask[(c0 + torch.arange(e, device=counts.device)) % B] = True
    counts[:rows].masked_fill_(mask[None, :], 0)
    for j, kind in enumerate(kinds):
        values[j, :rows].masked_fill_(mask[None, :], channel_identity(kind))


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_bin_evict
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, i, i, i, i, i, p]
    fn.restype = i
    return fn


def bin_evict(values: torch.Tensor, counts: torch.Tensor, first_bin: int,
              n_bins: int, rows: int, kinds: Tuple[str, ...]) -> None:
    """Reset the ring columns of the absolute bins ``first_bin ..
    first_bin + n_bins - 1`` of the first ``rows`` slots of ``values``
    f64[n_ch, C, B] and ``counts`` i32|i64[C, B], in place; ``kinds`` gives
    each channel's identity (sum/avg/count 0, min +f64 max, max -f64
    max).  No allocation, no copy to the card, no host sync."""
    _check(values, counts, rows, kinds)
    dev = values.device
    if dev.type == "cpu":
        bin_evict_reference(values, counts, first_bin, n_bins, rows, kinds)
        return
    if dev.type != "cuda":
        raise ValueError(f"bin_evict: unsupported device {dev}")
    n_ch, C, B = values.shape
    c0, e = _columns(first_bin, n_bins, B)
    build.launch("bin_evict", _c_fn(), dev, values.data_ptr(),
                 counts.data_ptr(), int(counts.dtype == torch.int64),
                 _inits(tuple(kinds))[1], n_ch, C, B, rows, c0, e)
    bin_evict.launches += 1


bin_evict.launches = 0
