"""K6 ``ring_gather``: the window-fire payload gather of a hot join
partition — both payload stacks read at the given sorted-run positions.

Replaces arroyo_tpu/ops/join.py:535 ``_gather32_kernel``.

On the H100 it is bound by memory (8 bytes of index plus 8 bytes per
stack row read and written per output row) and, at nexmark q8's few
thousand rows per partition fire, by its launch.  The CUDA kernel
(``csrc/ring_gather.cu``) runs one thread per (stack row, output row)
with coalesced stores, one launch per call.

``ring_gather_reference`` is the plain PyTorch version; the wrapper takes
it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build


def _check(idx: torch.Tensor, fstack: torch.Tensor,
           istack: torch.Tensor) -> Tuple[int, int, int, int]:
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise TypeError("idx must be i64 [m]")
    if fstack.dtype != torch.float64 or fstack.dim() != 2:
        raise TypeError("fstack must be f64 [nf, cap]")
    if istack.dtype != torch.int64 or istack.dim() != 2 or \
            istack.shape[1] != fstack.shape[1]:
        raise TypeError(f"istack must be i64 [ni, {fstack.shape[1]}]")
    cap = fstack.shape[1]
    if cap <= 0:
        raise ValueError("ring_gather needs cap > 0")
    devs = {t.device for t in (idx, fstack, istack)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in (idx, fstack, istack)):
        raise ValueError("ring_gather needs contiguous tensors")
    return idx.shape[0], fstack.shape[0], istack.shape[0], cap


def ring_gather_reference(idx: torch.Tensor, fstack: torch.Tensor,
                          istack: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``index_select`` per stack, indices clamped
    into [0, cap) as the JAX gather clamps."""
    i = idx.clamp(0, fstack.shape[1] - 1)
    return fstack.index_select(1, i), istack.index_select(1, i)


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_ring_gather
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, p, p, i, i, ll, p, p, p]
    fn.restype = i
    return fn


def ring_gather(idx: torch.Tensor, fstack: torch.Tensor, istack: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gf f64[nf, m], gi i64[ni, m]): ``fstack`` f64[nf, cap] and
    ``istack`` i64[ni, cap] read at the positions ``idx`` i64[m]."""
    m, nf, ni, cap = _check(idx, fstack, istack)
    dev = idx.device
    if dev.type == "cpu":
        return ring_gather_reference(idx, fstack, istack)
    if dev.type != "cuda":
        raise ValueError(f"ring_gather: unsupported device {dev}")
    gf = torch.empty((nf, m), dtype=torch.float64, device=dev)
    gi = torch.empty((ni, m), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _c_fn()(idx.data_ptr(), m, fstack.data_ptr(), istack.data_ptr(),
                     nf, ni, cap, gf.data_ptr(), gi.data_ptr(), stream)
    build.check(rc, "ring_gather")
    ring_gather.launches += 1
    return gf, gi


ring_gather.launches = 0
