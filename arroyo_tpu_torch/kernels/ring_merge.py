"""K5 ``ring_merge``: one hot join partition's scatter-merge into fresh
power-of-two planes — resident entries moved to their new sorted-run
positions and the sorted delta landed between, split-hash key planes and
payload stacks in lockstep.

Replaces arroyo_tpu/ops/join.py:372 ``_merge32_kernel``.

On the H100 it is bound by memory — every plane read once and written
once — and at nexmark q8's rings (cap 16,384-65,536, a few MB) by its
launches.  The CUDA kernel (``csrc/ring_merge.cu``) writes NEW planes:
positions move resident entries forward, so an in-place scatter would
race with itself.  Fill, resident scatter and delta scatter are three
stream-ordered launches per call, one thread per slot or entry.

``ring_merge_reference`` is the plain PyTorch version; the wrapper takes
it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import build

# biased-i32 image of u32 0xFFFFFFFF (the hi pad) and the lo pad
SENT32_HI = np.int32(0x7FFFFFFF)
SENT32_LO = np.int32(-1)

Planes = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
               Optional[torch.Tensor]]


def _check(hi, lo, fstack, istack, res_pos, d_hi, d_lo, d_f, d_i,
           delta_pos) -> Tuple[int, int, int, int]:
    if hi.dtype != torch.int32 or hi.dim() != 1 or lo.dtype != torch.int32 \
            or lo.shape != hi.shape:
        raise TypeError("hi/lo must be i32 [cap]")
    cap = hi.shape[0]
    if res_pos.dtype != torch.int64 or tuple(res_pos.shape) != (cap,):
        raise TypeError(f"res_pos must be i64 [{cap}]")
    if d_hi.dtype != torch.int32 or d_hi.dim() != 1 or \
            d_lo.dtype != torch.int32 or d_lo.shape != d_hi.shape:
        raise TypeError("d_hi/d_lo must be i32 [db]")
    db = d_hi.shape[0]
    if delta_pos.dtype != torch.int64 or tuple(delta_pos.shape) != (db,):
        raise TypeError(f"delta_pos must be i64 [{db}]")
    tensors = [hi, lo, res_pos, d_hi, d_lo, delta_pos]
    if (fstack is None) != (istack is None) or \
            (fstack is None) != (d_f is None) or (d_f is None) != (d_i is None):
        raise ValueError("payload stacks must be all given or all None")
    nf = ni = 0
    if fstack is not None:
        nf, ni = fstack.shape[0], istack.shape[0]
        if fstack.dtype != torch.float64 or tuple(fstack.shape) != (nf, cap):
            raise TypeError(f"fstack must be f64 [nf, {cap}]")
        if istack.dtype != torch.int64 or tuple(istack.shape) != (ni, cap):
            raise TypeError(f"istack must be i64 [ni, {cap}]")
        if d_f.dtype != torch.float64 or tuple(d_f.shape) != (nf, db):
            raise TypeError(f"d_f must be f64 [{nf}, {db}]")
        if d_i.dtype != torch.int64 or tuple(d_i.shape) != (ni, db):
            raise TypeError(f"d_i must be i64 [{ni}, {db}]")
        tensors += [fstack, istack, d_f, d_i]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ring_merge needs contiguous tensors")
    return cap, db, nf, ni


def ring_merge_reference(hi, lo, fstack, istack, res_pos, d_hi, d_lo, d_f,
                         d_i, delta_pos) -> Planes:
    """Plain PyTorch version: sentinel/zero planes, then masked
    ``index_copy_`` of the resident entries and then of the delta
    (positions outside [0, cap) dropped)."""
    cap = hi.shape[0]
    dev = hi.device

    def scatter(dst: torch.Tensor, pos: torch.Tensor, src: torch.Tensor,
                dim: int) -> None:
        ok = (pos >= 0) & (pos < cap)
        dst.index_copy_(dim, pos[ok], src[..., ok] if dim else src[ok])

    out_hi = torch.full((cap,), int(SENT32_HI), dtype=torch.int32, device=dev)
    out_lo = torch.full((cap,), int(SENT32_LO), dtype=torch.int32, device=dev)
    out_f = out_i = None
    if fstack is not None:
        out_f = torch.zeros((fstack.shape[0], cap), dtype=torch.float64,
                            device=dev)
        out_i = torch.zeros((istack.shape[0], cap), dtype=torch.int64,
                            device=dev)
    for pos, srcs in ((res_pos, (hi, lo, fstack, istack)),
                      (delta_pos, (d_hi, d_lo, d_f, d_i))):
        scatter(out_hi, pos, srcs[0], 0)
        scatter(out_lo, pos, srcs[1], 0)
        if out_f is not None:
            scatter(out_f, pos, srcs[2], 1)
            scatter(out_i, pos, srcs[3], 1)
    return out_hi, out_lo, out_f, out_i


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_ring_merge
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p, ll, ll, i, i, p, p, p, p, p]
    fn.restype = i
    return fn


def ring_merge(hi: torch.Tensor, lo: torch.Tensor,
               fstack: Optional[torch.Tensor], istack: Optional[torch.Tensor],
               res_pos: torch.Tensor, d_hi: torch.Tensor, d_lo: torch.Tensor,
               d_f: Optional[torch.Tensor], d_i: Optional[torch.Tensor],
               delta_pos: torch.Tensor) -> Planes:
    """Fresh (hi, lo, fstack, istack) planes of the ring's ``cap``: the
    resident planes (hi/lo i32[cap], fstack f64[nf, cap], istack i64[ni,
    cap]) moved to ``res_pos`` i64[cap], then the delta (d_hi/d_lo
    i32[db], d_f f64[nf, db], d_i i64[ni, db]) landed at ``delta_pos``
    i64[db]; a position outside [0, cap) is dropped.  The stacks are all
    None for a keys-only ring."""
    cap, db, nf, ni = _check(hi, lo, fstack, istack, res_pos, d_hi, d_lo,
                             d_f, d_i, delta_pos)
    dev = hi.device
    if dev.type == "cpu":
        return ring_merge_reference(hi, lo, fstack, istack, res_pos, d_hi,
                                    d_lo, d_f, d_i, delta_pos)
    if dev.type != "cuda":
        raise ValueError(f"ring_merge: unsupported device {dev}")
    out_hi = torch.empty(cap, dtype=torch.int32, device=dev)
    out_lo = torch.empty(cap, dtype=torch.int32, device=dev)
    out_f = out_i = None
    ptrs = [0, 0, 0, 0, 0, 0]  # fstack, istack, d_f, d_i, out_f, out_i
    if fstack is not None:
        out_f = torch.empty((nf, cap), dtype=torch.float64, device=dev)
        out_i = torch.empty((ni, cap), dtype=torch.int64, device=dev)
        ptrs = [t.data_ptr() for t in (fstack, istack, d_f, d_i, out_f,
                                       out_i)]
    build.launch("ring_merge", _c_fn(), dev, hi.data_ptr(), lo.data_ptr(),
                 ptrs[0], ptrs[1], res_pos.data_ptr(), d_hi.data_ptr(),
                 d_lo.data_ptr(), ptrs[2], ptrs[3], delta_pos.data_ptr(), cap,
                 db, nf, ni, out_hi.data_ptr(), out_lo.data_ptr(), ptrs[4],
                 ptrs[5])
    ring_merge.launches += 1
    return out_hi, out_lo, out_f, out_i


ring_merge.launches = 0
