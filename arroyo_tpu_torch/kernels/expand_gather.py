"""K11 ``expand_gather``: a hot join partition's fused probe emission — the
candidate pairs of a :func:`~arroyo_tpu_torch.kernels.join_probe.join_probe`
expanded, verified against the full split key and gathered from both
payload stacks, in one launch.

Replaces arroyo_tpu/ops/join.py:487 ``_expand_gather_kernel``.

For pair j < total: ``lidx``/``ridx`` as :func:`join_expand` computes them,
``ridx`` clipped to [0, cap - 1]; ``valid[j]`` is True when the ring row's
``hi`` and ``lo`` planes both equal the query's (a top-32-equal but
low-32-different row is a false candidate); ``gf`` f64[nf, total] and
``gi`` i64[ni, total] are the stacks at ``ridx`` (``gi[0]`` the event
time).  ``nf`` may be 0.  All outputs are sized to the exact ``total``.

On the H100 it is bound by memory (8 + 8 * (nf + ni) bytes read and 17 +
8 * (nf + ni) written per pair) and, at join-stress's shapes, by its
launch.  The CUDA kernel (``csrc/expand_gather.cu``) runs one thread per
pair; each thread writes column j of every stack row, so stores
coalesce.

``expand_gather_reference`` is the plain PyTorch version; the wrapper
takes it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build
from .join_expand import check_ranges, join_expand_reference

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def _check(start, cum, total, hi, lo, q_hi, q_lo, fstack, istack
           ) -> Tuple[int, int, int, int]:
    mq = check_ranges(start, cum, total)
    for name, t, n in (("hi", hi, None), ("lo", lo, hi.shape[0]),
                       ("q_hi", q_hi, mq), ("q_lo", q_lo, mq)):
        if t.dtype != torch.int32 or t.dim() != 1 or (
                n is not None and t.shape[0] != n):
            raise TypeError(f"{name} must be i32 [{n or 'cap'}]")
    cap = hi.shape[0]
    if cap <= 0:
        raise ValueError("expand_gather needs cap > 0")
    if fstack.dtype != torch.float64 or fstack.dim() != 2 or \
            fstack.shape[1] != cap:
        raise TypeError(f"fstack must be f64 [nf, {cap}]")
    if istack.dtype != torch.int64 or istack.dim() != 2 or \
            istack.shape[1] != cap:
        raise TypeError(f"istack must be i64 [ni, {cap}]")
    ts = (start, cum, hi, lo, q_hi, q_lo, fstack, istack)
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("expand_gather needs contiguous tensors")
    return mq, cap, fstack.shape[0], istack.shape[0]


def expand_gather_reference(start, cum, total, hi, lo, q_hi, q_lo, fstack,
                            istack) -> Outputs:
    """Plain PyTorch version: (lidx i64, ridx i64, valid bool, gf f64[nf],
    gi i64[ni]), each over ``total`` pairs."""
    lidx, ridx = join_expand_reference(start, cum, total)
    ridx = ridx.clamp(0, hi.shape[0] - 1)
    valid = (hi[ridx] == q_hi[lidx]) & (lo[ridx] == q_lo[lidx])
    return (lidx, ridx, valid, fstack.index_select(1, ridx),
            istack.index_select(1, ridx))


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_expand_gather
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, ll, ll, p, p, ll, p, p, p, i, p, i, p, p, p, p, p,
                   p]
    fn.restype = i
    return fn


def expand_gather(start: torch.Tensor, cum: torch.Tensor, total: int,
                  hi: torch.Tensor, lo: torch.Tensor, q_hi: torch.Tensor,
                  q_lo: torch.Tensor, fstack: torch.Tensor,
                  istack: torch.Tensor) -> Outputs:
    """(lidx i64[total], ridx i64[total], valid bool[total], gf
    f64[nf, total], gi i64[ni, total]) for the candidate ranges ``start``
    i32[mq] / ``cum`` i64[mq] of the queries ``q_hi``/``q_lo`` i32[mq] in
    the ring planes ``hi``/``lo`` i32[cap] with payload stacks ``fstack``
    f64[nf, cap] and ``istack`` i64[ni, cap]."""
    mq, cap, nf, ni = _check(start, cum, total, hi, lo, q_hi, q_lo, fstack,
                             istack)
    dev = start.device
    if dev.type == "cpu":
        return expand_gather_reference(start, cum, total, hi, lo, q_hi,
                                       q_lo, fstack, istack)
    if dev.type != "cuda":
        raise ValueError(f"expand_gather: unsupported device {dev}")
    idx = torch.empty((2, total), dtype=torch.int64, device=dev)
    lidx, ridx = idx[0], idx[1]
    valid = torch.empty(total, dtype=torch.bool, device=dev)
    gf = torch.empty((nf, total), dtype=torch.float64, device=dev)
    gi = torch.empty((ni, total), dtype=torch.int64, device=dev)
    if total == 0:
        return lidx, ridx, valid, gf, gi  # nothing to launch
    build.launch("expand_gather", _c_fn(), dev, start.data_ptr(),
                 cum.data_ptr(), mq, total, hi.data_ptr(), lo.data_ptr(), cap,
                 q_hi.data_ptr(), q_lo.data_ptr(), fstack.data_ptr(), nf,
                 istack.data_ptr(), ni, lidx.data_ptr(), ridx.data_ptr(),
                 valid.data_ptr(), gf.data_ptr(), gi.data_ptr())
    expand_gather.launches += 1
    return lidx, ridx, valid, gf, gi


expand_gather.launches = 0
