"""K3 ``pane_emit``: the dense pane fire — per (key slot, pane) the pane's
row count and each transferred channel's aggregate over the pane's ring
bins, for the occupied slots and real panes only.

Replaces arroyo_tpu/ops/keyed_bins.py:123 ``_emit_kernel`` and the channel
reduction it shares, :109 ``_pane_reduce``.

A fire's geometry is a few scalars: pane p < k covers the absolute bins
``first_bin + p + w`` (w < W), a bin is live when ``lo <= bin <= hi``,
and it sits in ring column ``bin mod B``.  :func:`fire_geometry` turns
those scalars into the ``(ring, bin_ok)`` arrays that the JAX kernels,
``argmax_fire``, ``emit_count``/``emit_gather`` and the plain version take,
so every branch of a fire shares one definition; the CUDA kernel
(``csrc/pane_emit.cu``) takes the scalars themselves and derives each bin,
so a dense fire copies nothing to the card.

On the H100 it is bound by memory: the 32-byte sectors of each occupied
slot's row that hold the fire's live columns, and (count itemsize + 8 per
transferred channel) bytes written per (slot, pane).  The kernel runs one
thread per (slot, pane), the pane fastest, folding its pane's live bins
in the counts and in each transferred channel.  :func:`pane_emit` returns ONE buffer,
``f64[n_xfer, c_slice, k]`` then the counts ``[c_slice, k]``, so a fire
allocates once and reads back once; :func:`pane_views` splits it, on the
card or after the readback.

``pane_emit_reference`` is the plain PyTorch version; the wrappers take it
only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import build
from .bin_update import KIND_CODES, channel_identity

MAX_CHANNELS = 64  # csrc/pane_reduce.cuh kMaxChannels


class _XferSpec(ctypes.Structure):
    # csrc/pane_reduce.cuh XferSpec
    _fields_ = [("n", ctypes.c_int), ("ch", ctypes.c_int * MAX_CHANNELS),
                ("kind", ctypes.c_int * MAX_CHANNELS)]


def fire_geometry(first_bin: int, lo: int, hi: int, W: int, k: int, B: int,
                  kpad: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(ring i32[kpad, W], bin_ok bool[kpad, W]) of a fire: pane p < k,
    bin w is the absolute bin ``first_bin + p + w`` at ring column ``bin
    mod B``, ok when ``lo <= bin <= hi``; rows k..kpad-1 (``kpad`` > k pads
    to a bucket) are column 0 and not ok.  The bin arithmetic is 64-bit,
    on the host."""
    kpad = max(kpad, k)
    abs_bins = (first_bin + np.arange(k, dtype=np.int64)[:, None]
                + np.arange(W, dtype=np.int64)[None, :])
    ring = np.zeros((kpad, W), dtype=np.int32)
    ring[:k] = abs_bins % B
    bin_ok = np.zeros((kpad, W), dtype=bool)
    bin_ok[:k] = (abs_bins >= lo) & (abs_bins <= hi)
    return ring, bin_ok


@functools.lru_cache(maxsize=None)
def _xfer_spec(kinds: Tuple[str, ...], xfer: Tuple[int, ...]
               ) -> Tuple[_XferSpec, int]:
    """The transferred channels' spec for the launch and its address,
    validated and built once per (kinds, xfer)."""
    if any(x not in KIND_CODES for x in kinds):
        raise ValueError(f"unknown channel kind in {kinds!r}")
    if any(not 0 <= j < len(kinds) for j in xfer):
        raise ValueError(f"xfer channels {xfer!r} outside {len(kinds)} "
                         "channels")
    if len(xfer) > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} transferred channels")
    spec = _XferSpec()
    spec.n = len(xfer)
    for r, j in enumerate(xfer):
        spec.ch[r] = j
        spec.kind[r] = KIND_CODES[kinds[j]]
    return spec, ctypes.addressof(spec)


def _check(values: torch.Tensor, counts: torch.Tensor, W: int, k: int,
           kinds: Tuple[str, ...], xfer: Tuple[int, ...],
           c_slice: int) -> int:
    """The spec's address, once the arguments are ones the kernel takes."""
    if values.dtype != torch.float64 or values.dim() != 3:
        raise TypeError("values must be f64 [n_ch, C, B]")
    n_ch, C, B = values.shape
    if counts.dtype not in (torch.int32, torch.int64) or \
            counts.shape != (C, B):
        raise TypeError("counts must be i32/i64 [C, B]")
    if len(kinds) != n_ch:
        raise ValueError(f"kinds {kinds!r} do not match {n_ch} channels")
    if W < 1 or k < 0 or not 0 <= c_slice <= C:
        raise ValueError(f"bad fire: W={W} k={k} c_slice={c_slice} C={C}")
    if values.device != counts.device:
        raise ValueError(f"tensors on several devices: {values.device}, "
                         f"{counts.device}")
    if not (values.is_contiguous() and counts.is_contiguous()):
        raise ValueError("pane_emit needs contiguous tensors")
    return _xfer_spec(tuple(kinds), tuple(xfer))[1]


def pane_reduce_reference(values: torch.Tensor, counts: torch.Tensor,
                          ring: torch.Tensor, bin_ok: torch.Tensor,
                          kinds: Sequence[str], xfer: Sequence[int],
                          c_slice: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch pane reduction over ring arrays (i32[k, W] columns,
    bool[k, W] flags): gather [c_slice, k, W] per plane, mask the bins
    outside the pane, reduce over W.  The compact fire's plain version
    reads its channels from here."""
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


def pane_emit_reference(values: torch.Tensor, counts: torch.Tensor,
                        first_bin: int, lo: int, hi: int, W: int, k: int,
                        kinds: Sequence[str], xfer: Sequence[int],
                        c_slice: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the fire's ring arrays from
    :func:`fire_geometry`, then :func:`pane_reduce_reference`."""
    ring, bin_ok = fire_geometry(first_bin, lo, hi, W, k, values.shape[2])
    return pane_reduce_reference(
        values, counts, torch.from_numpy(ring).to(values.device),
        torch.from_numpy(bin_ok).to(values.device), kinds, xfer, c_slice)


def pane_views(buf: torch.Tensor, n_xfer: int, c_slice: int, k: int,
               counts_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outs f64[n_xfer, c_slice, k], cnts[c_slice, k]) viewing a
    :func:`pane_emit` buffer, on the card or on the host."""
    n_f = 8 * n_xfer * c_slice * k
    outs = buf[:n_f].view(torch.float64).view(n_xfer, c_slice, k)
    cnts = buf[n_f:].view(counts_dtype).view(c_slice, k)
    return outs, cnts


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_pane_emit
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, i, p, i, i, q, q, q, i, i, i, p, p]
    fn.restype = i
    return fn


def _launch(values: torch.Tensor, counts: torch.Tensor, spec: int,
            first_bin: int, lo: int, hi: int, W: int, k: int, c_slice: int,
            buf: torch.Tensor) -> None:
    """Launch the kernel into ``buf`` (checked arguments, a CUDA device)."""
    C, B = counts.shape
    build.launch("pane_emit", _c_fn(), values.device, values.data_ptr(),
                 counts.data_ptr(), int(counts.dtype == torch.int64), spec,
                 C, B, first_bin, lo, hi, W, k, c_slice, buf.data_ptr())


def pane_emit(values: torch.Tensor, counts: torch.Tensor, first_bin: int,
              lo: int, hi: int, W: int, k: int, kinds: Tuple[str, ...],
              xfer: Tuple[int, ...], c_slice: int) -> torch.Tensor:
    """One u8 buffer holding the fire's outputs (split by :func:`pane_views`)
    for the panes p < k of W bins, pane p's bin w the absolute bin
    ``first_bin + p + w``, live when ``lo <= bin <= hi`` (at most B live
    bins), over ``values`` f64[n_ch, C, B] and ``counts`` i32|i64[C, B];
    ``kinds`` names each channel's reduction (sum/avg/count add, min, max)
    and ``xfer`` the channels that are read out; the counts keep their
    dtype.  One allocation, no host sync."""
    spec = _check(values, counts, W, k, kinds, xfer, c_slice)
    n_f = 8 * len(xfer) * c_slice * k
    nbytes = n_f + counts.element_size() * c_slice * k
    dev = values.device
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    if dev.type == "cpu":
        outs, cnts = pane_emit_reference(values, counts, first_bin, lo, hi,
                                         W, k, kinds, xfer, c_slice)
        v_outs, v_cnts = pane_views(buf, len(xfer), c_slice, k, counts.dtype)
        v_outs.copy_(outs)
        v_cnts.copy_(cnts)
        return buf
    if dev.type != "cuda":
        raise ValueError(f"pane_emit: unsupported device {dev}")
    _launch(values, counts, spec, first_bin, lo, hi, W, k, c_slice, buf)
    pane_emit.launches += 1
    return buf


pane_emit.launches = 0
