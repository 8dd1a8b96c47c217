"""K6 ``ring_gather``: the window-fire payload gather of a hot join
partition — both payload stacks read at the given sorted-run positions.

Replaces arroyo_tpu/ops/join.py:535 ``_gather32_kernel``.

On the H100 it is bound by memory (8 bytes of index plus 8 bytes per
stack row read and written per output row) and, at nexmark q8's few
thousand rows per partition fire, by its launch.  The CUDA kernel
(``csrc/ring_gather.cu``) runs one thread per output position, which
reads its index once, and writes both stacks into ONE i64 buffer: one
launch, one allocation and no host sync per call.  ``ring_gather_rows``
returns that buffer, which the join reads back in one copy a fire;
``ring_gather`` is the kernel's public function in the JAX kernel's
form, (f64 rows, i64 rows), and returns two views of it, so the
semantics the plain version and the tests hold stay as they were.

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
    nf, cap = fstack.shape
    if istack.dtype != torch.int64 or istack.dim() != 2 or \
            istack.shape[1] != cap:
        raise TypeError(f"istack must be i64 [ni, {cap}]")
    if cap <= 0:
        raise ValueError("ring_gather needs cap > 0")
    if not idx.device == fstack.device == istack.device:
        raise ValueError(f"tensors on several devices: {idx.device}, "
                         f"{fstack.device}, {istack.device}")
    if not (idx.is_contiguous() and fstack.is_contiguous()
            and istack.is_contiguous()):
        raise ValueError("ring_gather needs contiguous tensors")
    return idx.shape[0], nf, istack.shape[0], cap


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
    fn.argtypes = [p, ll, p, p, i, i, ll, p, p]
    fn.restype = i
    return fn


def ring_gather_rows(idx: torch.Tensor, fstack: torch.Tensor,
                     istack: torch.Tensor) -> torch.Tensor:
    """rows i64[nf + ni, m]: ``fstack`` f64[nf, cap] (as its bits) over
    ``istack`` i64[ni, cap], read at the positions ``idx`` i64[m] — one
    buffer, so a caller reads both stacks back in one copy."""
    m, nf, ni, cap = _check(idx, fstack, istack)
    dev = idx.device
    if dev.type == "cpu":
        gf, gi = ring_gather_reference(idx, fstack, istack)
        return torch.cat([gf.view(torch.int64), gi])
    if dev.type != "cuda":
        raise ValueError(f"ring_gather: unsupported device {dev}")
    rows = torch.empty((nf + ni, m), dtype=torch.int64, device=dev)
    if m and nf + ni:
        build.launch("ring_gather", _c_fn(), dev, idx.data_ptr(), m,
                     fstack.data_ptr(), istack.data_ptr(), nf, ni, cap,
                     rows.data_ptr())
        ring_gather.launches += 1
    return rows


def ring_gather(idx: torch.Tensor, fstack: torch.Tensor, istack: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gf f64[nf, m], gi i64[ni, m]): ``fstack`` f64[nf, cap] and
    ``istack`` i64[ni, cap] read at the positions ``idx`` i64[m]; on the
    card both are views of one ``ring_gather_rows`` buffer."""
    if idx.device.type == "cpu":
        _check(idx, fstack, istack)
        return ring_gather_reference(idx, fstack, istack)
    rows = ring_gather_rows(idx, fstack, istack)
    nf = fstack.shape[0]
    return rows[:nf].view(torch.float64), rows[nf:]


ring_gather.launches = 0
