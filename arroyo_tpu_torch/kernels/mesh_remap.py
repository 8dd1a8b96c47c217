"""K-c ``mesh_remap``: re-lay a key shard's bin planes — each new row from
a source row, each new column from a shifted source column — in one
gather of every plane.

Replaces arroyo_tpu/parallel/mesh_window.py:376 ``_roll_step`` and the
re-layout half of :119 ``_update_step`` (:222-241); it also serves the
shard's ring growth, rebase and capacity growth, which the JAX package
re-lays on the host (:542-618).

For new row ``r`` and column ``c``, with ``sr = src[r]`` (``src`` None:
``r`` below the old row count, else -1) and ``sc = c + shift``, the cell
takes the old cell ``(sr, sc)`` when both are in range, else the
channel's identity (its count 0).  The counts keep their type.  The new
planes are two views of ONE allocation (:func:`remap_views`): the values
f64[n_ch, C_out, B_out], then the counts [C_out, B_out].

On the H100 it is bound by memory: each new cell written once and read
from its source once.  The CUDA kernel (``csrc/mesh_remap.cu``) runs one
thread per new cell of a plane, the column fastest.
``mesh_remap_reference`` is the plain PyTorch version; the wrapper takes
it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import build
from .bin_evict import _inits
from .bin_update import channel_identity


def _check(values: torch.Tensor, counts: torch.Tensor,
           src: Optional[torch.Tensor], C_out: int, B_out: int,
           kinds: Sequence[str]) -> None:
    if values.dtype != torch.float64 or values.dim() != 3:
        raise TypeError("values must be f64 [n_ch, C, B]")
    n_ch, C, B = values.shape
    if counts.dtype not in (torch.int32, torch.int64) or \
            counts.shape != (C, B):
        raise TypeError("counts must be i32/i64 [C, B]")
    if len(kinds) != n_ch:
        raise ValueError(f"kinds {kinds!r} do not match {n_ch} channels")
    if C_out < 0 or B_out < 1 or max(C, C_out, B, B_out) >= 2**31:
        raise ValueError(f"bad shape: C_out {C_out}, B_out {B_out}")
    if src is not None and (src.dtype != torch.int64
                            or src.shape != (C_out,)
                            or src.device != values.device
                            or not src.is_contiguous()):
        raise TypeError(f"src must be a contiguous i64 [{C_out}] on "
                        f"{values.device}")
    if values.device != counts.device:
        raise ValueError(f"tensors on several devices: {values.device}, "
                         f"{counts.device}")
    if not (values.is_contiguous() and counts.is_contiguous()):
        raise ValueError("mesh_remap needs contiguous tensors")


def remap_views(buf: torch.Tensor, n_ch: int, C_out: int, B_out: int,
                counts_dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values f64[n_ch, C_out, B_out], counts [C_out, B_out]) of a
    :func:`mesh_remap` buffer."""
    n_v = 8 * n_ch * C_out * B_out
    return (buf[:n_v].view(torch.float64).view(n_ch, C_out, B_out),
            buf[n_v:].view(counts_dtype).view(C_out, B_out))


def mesh_remap_reference(values: torch.Tensor, counts: torch.Tensor,
                         src: Optional[torch.Tensor], shift: int, C_out: int,
                         B_out: int, kinds: Sequence[str]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a row and a column index with their
    in-range masks, one gather a plane, ``where`` to the identities."""
    n_ch, C, B = values.shape
    dev = values.device
    rows = (src if src is not None
            else torch.arange(C_out, device=dev).masked_fill(
                torch.arange(C_out, device=dev) >= C, -1))
    cols = torch.arange(B_out, device=dev) + shift
    ok = ((rows >= 0) & (rows < C))[:, None] & ((cols >= 0) & (cols < B))
    r = rows.clamp(0, max(C - 1, 0))[:, None]
    c = cols.clamp(0, B - 1)[None, :]
    if C == 0:
        cnt = torch.zeros((C_out, B_out), dtype=counts.dtype, device=dev)
        vals = torch.empty((n_ch, C_out, B_out), dtype=torch.float64,
                           device=dev)
        for j, kind in enumerate(kinds):
            vals[j] = channel_identity(kind)
        return vals, cnt
    cnt = torch.where(ok, counts[r, c], 0).to(counts.dtype)
    vals = torch.stack([torch.where(ok, values[j][r, c],
                                    channel_identity(kinds[j]))
                        for j in range(n_ch)]) if n_ch else \
        torch.empty((0, C_out, B_out), dtype=torch.float64, device=dev)
    return vals, cnt


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_mesh_remap
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, i, i, i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def mesh_remap(values: torch.Tensor, counts: torch.Tensor,
               src: Optional[torch.Tensor], shift: int, C_out: int,
               B_out: int, kinds: Tuple[str, ...]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The re-laid planes (values f64[n_ch, C_out, B_out], counts [C_out,
    B_out] in the counts' type), two views of one allocation; ``kinds``
    gives each channel's identity.  No host sync."""
    _check(values, counts, src, C_out, B_out, kinds)
    n_ch, C, B = values.shape
    dev = values.device
    nbytes = (8 * n_ch + counts.element_size()) * C_out * B_out
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    v_out, c_out = remap_views(buf, n_ch, C_out, B_out, counts.dtype)
    if dev.type == "cpu":
        vals, cnt = mesh_remap_reference(values, counts, src, shift, C_out,
                                         B_out, kinds)
        v_out.copy_(vals)
        c_out.copy_(cnt)
        return v_out, c_out
    if dev.type != "cuda":
        raise ValueError(f"mesh_remap: unsupported device {dev}")
    build.launch("mesh_remap", _c_fn(), dev, values.data_ptr(),
                 counts.data_ptr(), int(counts.dtype == torch.int64),
                 src.data_ptr() if src is not None else None,
                 _inits(tuple(kinds))[1], n_ch, C, B, C_out, B_out, shift,
                 v_out.data_ptr(), c_out.data_ptr())
    mesh_remap.launches += 1
    return v_out, c_out


mesh_remap.launches = 0
