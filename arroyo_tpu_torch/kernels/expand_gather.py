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
time).  ``nf`` may be 0.

On the H100 it is bound by memory (8 + 8 * (nf + ni) bytes read and 17 +
8 * (nf + ni) written per pair) and, at join-stress's shapes, by its
launch.  The CUDA kernel (``csrc/expand_gather.cu``) expands 512 pairs a
block with the staged expansion it shares with :func:`join_expand`
(``csrc/join_search.cuh``): ``cum``, or the stretch of it that holds the
block's queries, in shared memory, so a pair's search stays off global
memory; each thread writes column j of every output row, so stores
coalesce.  Every output lands in ONE i64 buffer —
the pair total in word 0, then rows ``lidx``, ``ridx``, ``gf`` (as its
bits), ``gi`` of ``capacity`` words each, then ``valid`` as bytes — so a
probe makes one allocation, one launch and no host sync.  The kernel
reads the total on the device (``cum[mq - 1]``) and writes the first
min(total, capacity) pairs: the join sizes the buffer from the ring's
last totals, launches it right behind the probe, reads it back in one
copy and launches again at the header's total only when that exceeds
the capacity.  :func:`expand_gather_buffer` returns the buffer and
:func:`expand_views` splits it, on the card or on the host.
:func:`expand_gather` is the kernel's public function in the JAX
kernel's form (the capacity is the known total) and returns the five
views.

``expand_gather_reference`` is the plain PyTorch version; the wrappers
take it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import build
from .join_expand import check_ranges, join_expand_reference

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def _check(start, cum, capacity, hi, lo, q_hi, q_lo, fstack, istack
           ) -> Tuple[int, int, int, int]:
    """What the C launcher cannot see: dtypes, shapes, one device and
    contiguity; returns (mq, cap, nf, ni)."""
    mq = check_ranges(start, cum, 0)
    if capacity < 0:
        raise ValueError(f"expand_gather: capacity {capacity} < 0")
    cap = hi.shape[0]
    i32 = torch.int32
    if not (hi.dtype == lo.dtype == q_hi.dtype == q_lo.dtype == i32
            and hi.dim() == lo.dim() == q_hi.dim() == q_lo.dim() == 1
            and lo.shape[0] == cap and q_hi.shape[0] == q_lo.shape[0] == mq):
        raise TypeError(f"hi, lo must be i32 [cap], q_hi, q_lo i32 [{mq}]")
    if cap <= 0:
        raise ValueError("expand_gather needs cap > 0")
    if fstack.dtype != torch.float64 or fstack.dim() != 2 or \
            fstack.shape[1] != cap:
        raise TypeError(f"fstack must be f64 [nf, {cap}]")
    if istack.dtype != torch.int64 or istack.dim() != 2 or \
            istack.shape[1] != cap:
        raise TypeError(f"istack must be i64 [ni, {cap}]")
    dev = start.device
    if not (hi.device == lo.device == q_hi.device == q_lo.device
            == fstack.device == istack.device == dev):
        raise ValueError("expand_gather: tensors on several devices")
    if not (hi.is_contiguous() and lo.is_contiguous()
            and q_hi.is_contiguous() and q_lo.is_contiguous()
            and fstack.is_contiguous() and istack.is_contiguous()):
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


def buffer_words(capacity: int, nf: int, ni: int) -> int:
    """i64 words of an :func:`expand_gather_buffer`: the total, 2 + nf +
    ni rows of ``capacity``, then ``capacity`` bytes of ``valid``."""
    return 1 + (2 + nf + ni) * capacity + (capacity + 7) // 8


def expand_views(buf, total: int, nf: int, ni: int,
                 capacity: Optional[int] = None) -> Outputs:
    """(lidx, ridx, valid, gf f64[nf, total], gi i64[ni, total]) viewing an
    :func:`expand_gather_buffer` of ``capacity`` pairs (default: the
    total) — a tensor on the card or the host, or its numpy copy;
    ``total`` is at most the capacity."""
    capacity = total if capacity is None else capacity
    rows = 2 + nf + ni
    f64, flag = ((np.float64, np.bool_) if isinstance(buf, np.ndarray)
                 else (torch.float64, torch.bool))
    words = buf[1:1 + rows * capacity].reshape(rows, capacity)[:, :total]
    valid = buf[1 + rows * capacity:].view(flag)[:total]
    return (words[0], words[1], valid, words[2:2 + nf].view(f64),
            words[2 + nf:])


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_expand_gather
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, ll, ll, p, p, ll, p, p, p, i, p, i, p, p]
    fn.restype = i
    return fn


def _launch(start, cum, mq, capacity, hi, lo, cap, q_hi, q_lo, fstack, nf,
            istack, ni, buf) -> None:
    """Launch the kernel into ``buf`` (checked arguments, a CUDA device)."""
    build.launch("expand_gather", _c_fn(), start.device, start.data_ptr(),
                 cum.data_ptr(), mq, capacity, hi.data_ptr(), lo.data_ptr(),
                 cap, q_hi.data_ptr(), q_lo.data_ptr(), fstack.data_ptr(), nf,
                 istack.data_ptr(), ni, buf.data_ptr())


def expand_gather_buffer(start: torch.Tensor, cum: torch.Tensor,
                         capacity: int, hi: torch.Tensor, lo: torch.Tensor,
                         q_hi: torch.Tensor, q_lo: torch.Tensor,
                         fstack: torch.Tensor, istack: torch.Tensor
                         ) -> torch.Tensor:
    """The pair total (word 0) and the five outputs of
    :func:`expand_gather` for the first min(total, ``capacity``) pairs in
    one i64 buffer of :func:`buffer_words` words (split it with
    :func:`expand_views`); the total is read on the device, so the call
    does not wait for the probe."""
    mq, cap, nf, ni = _check(start, cum, capacity, hi, lo, q_hi, q_lo,
                             fstack, istack)
    dev = start.device
    buf = torch.empty(buffer_words(capacity, nf, ni), dtype=torch.int64,
                      device=dev)
    if dev.type == "cpu":
        total = int(cum[-1]) if mq else 0
        n = min(total, capacity)
        buf[0] = total
        got = expand_gather_reference(start, cum, n, hi, lo, q_hi, q_lo,
                                      fstack, istack)
        for view, part in zip(expand_views(buf, n, nf, ni, capacity), got):
            view.copy_(part)
        return buf
    if dev.type != "cuda":
        raise ValueError(f"expand_gather: unsupported device {dev}")
    _launch(start, cum, mq, capacity, hi, lo, cap, q_hi, q_lo, fstack, nf,
            istack, ni, buf)
    expand_gather.launches += 1
    return buf


def expand_gather(start: torch.Tensor, cum: torch.Tensor, total: int,
                  hi: torch.Tensor, lo: torch.Tensor, q_hi: torch.Tensor,
                  q_lo: torch.Tensor, fstack: torch.Tensor,
                  istack: torch.Tensor) -> Outputs:
    """(lidx i64[total], ridx i64[total], valid bool[total], gf
    f64[nf, total], gi i64[ni, total]) for the candidate ranges ``start``
    i32[mq] / ``cum`` i64[mq] of the queries ``q_hi``/``q_lo`` i32[mq] in
    the ring planes ``hi``/``lo`` i32[cap] with payload stacks ``fstack``
    f64[nf, cap] and ``istack`` i64[ni, cap]; on the card, views of one
    :func:`expand_gather_buffer`."""
    check_ranges(start, cum, total)
    if start.device.type == "cpu":
        _check(start, cum, total, hi, lo, q_hi, q_lo, fstack, istack)
        return expand_gather_reference(start, cum, total, hi, lo, q_hi,
                                       q_lo, fstack, istack)
    nf, ni = fstack.shape[0], istack.shape[0]
    if total == 0:  # nothing to launch
        _check(start, cum, 0, hi, lo, q_hi, q_lo, fstack, istack)
        return expand_views(torch.zeros(buffer_words(0, nf, ni),
                                        dtype=torch.int64,
                                        device=start.device), 0, nf, ni)
    buf = expand_gather_buffer(start, cum, total, hi, lo, q_hi, q_lo, fstack,
                               istack)
    return expand_views(buf, total, nf, ni)


expand_gather.launches = 0
