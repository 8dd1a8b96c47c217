"""K5 ``ring_merge``: one hot join partition's merge into fresh
power-of-two planes — the resident run with the sorted delta inserted,
split-hash key planes and payload stacks in lockstep.

Replaces arroyo_tpu/ops/join.py:372 ``_merge32_kernel``.

The join state's merge is a pure insert, so the delta's positions alone
place every resident entry: the delta's m positions are strictly
increasing in [0, n_res + m), and resident i lands at the i-th position
they leave free (the ascending complement — the JAX kernel's ``res_pos``,
which the port never builds).  Slots from n_res + m on hold the sentinel
keys and zero payload.

On the H100 it is bound by memory — each resident and delta column read
once, each output column written once — and at join-stress's and q8's
rings (cap 8,192-65,536, a few MB) by its launch.  The CUDA kernel
(``csrc/ring_merge.cu``) is a gather: one thread per output slot finds
its source from the delta positions its block stages in shared memory,
so every output byte is written once, coalesced, in one launch into ONE
buffer (:func:`ring_planes` splits it: ``hi`` and ``lo``, then the f64
stack, then the i64 stack).  It writes new planes: the resident run
moves forward, so an in-place merge would overwrite entries not yet
moved.

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


def ring_words(cap: int, nf: int, ni: int) -> int:
    """i64 words of one ring buffer: ``hi`` and ``lo`` (i32[cap] each),
    then ``nf`` f64 rows and ``ni`` i64 rows of ``cap``."""
    return cap * (1 + nf + ni)


def ring_planes(buf, cap: int, nf: int, ni: int, payload: bool):
    """(hi i32[cap], lo i32[cap], fstack f64[nf, cap], istack i64[ni,
    cap]) viewing the first :func:`ring_words` words of the i64 ``buf``
    — a tensor or a numpy array; the stacks are None when ``payload`` is
    False (a keys-only ring)."""
    i32, f64 = ((np.int32, np.float64) if isinstance(buf, np.ndarray)
                else (torch.int32, torch.float64))
    keys = buf[:cap].view(i32)
    if not payload:
        return keys[:cap], keys[cap:], None, None
    f_end = cap * (1 + nf)
    return (keys[:cap], keys[cap:], buf[cap:f_end].view(f64).reshape(nf, cap),
            buf[f_end:ring_words(cap, nf, ni)].reshape(ni, cap))


def _check(hi, lo, fstack, istack, n_res, d_hi, d_lo, d_f, d_i,
           delta_pos) -> Tuple[int, int, int, int]:
    if hi.dtype != torch.int32 or hi.dim() != 1 or lo.dtype != torch.int32 \
            or lo.shape != hi.shape:
        raise TypeError("hi/lo must be i32 [cap]")
    cap = hi.shape[0]
    if d_hi.dtype != torch.int32 or d_hi.dim() != 1 or \
            d_lo.dtype != torch.int32 or d_lo.shape != d_hi.shape:
        raise TypeError("d_hi/d_lo must be i32 [m]")
    m = d_hi.shape[0]
    if delta_pos.dtype != torch.int64 or tuple(delta_pos.shape) != (m,):
        raise TypeError(f"delta_pos must be i64 [{m}]")
    if cap <= 0 or not 0 <= n_res <= cap - m:
        raise ValueError(f"ring_merge: need 0 <= n_res and n_res + m <= "
                         f"cap (n_res={n_res}, m={m}, cap={cap})")
    tensors = [hi, lo, d_hi, d_lo, delta_pos]
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
        if d_f.dtype != torch.float64 or tuple(d_f.shape) != (nf, m):
            raise TypeError(f"d_f must be f64 [{nf}, {m}]")
        if d_i.dtype != torch.int64 or tuple(d_i.shape) != (ni, m):
            raise TypeError(f"d_i must be i64 [{ni}, {m}]")
        tensors += [fstack, istack, d_f, d_i]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ring_merge needs contiguous tensors")
    return cap, m, nf, ni


def ring_merge_reference(hi, lo, fstack, istack, n_res, d_hi, d_lo, d_f,
                         d_i, delta_pos) -> Planes:
    """Plain PyTorch version: sentinel/zero planes, then ``index_copy_``
    of the resident run to the ascending complement of ``delta_pos`` and
    of the delta to ``delta_pos``.  Raises unless the positions are
    strictly increasing in [0, n_res + m)."""
    cap, m = hi.shape[0], d_hi.shape[0]
    dev = hi.device
    used = n_res + m
    if m and not (int(delta_pos[0]) >= 0 and int(delta_pos[-1]) < used
                  and bool((delta_pos[1:] > delta_pos[:-1]).all())):
        raise ValueError("ring_merge: delta positions must be strictly "
                         f"increasing in [0, {used})")
    free = torch.ones(used, dtype=torch.bool, device=dev)
    free[delta_pos] = False
    res_pos = torch.nonzero(free).squeeze(1)
    payload = fstack is not None
    nf, ni = (fstack.shape[0], istack.shape[0]) if payload else (0, 0)
    buf = torch.zeros(ring_words(cap, nf, ni), dtype=torch.int64, device=dev)
    out = ring_planes(buf, cap, nf, ni, payload)
    out[0].fill_(int(SENT32_HI))
    out[1].fill_(int(SENT32_LO))
    for dst, res, delta in zip(out, (hi, lo, fstack, istack),
                               (d_hi, d_lo, d_f, d_i)):
        if dst is not None:
            dim = dst.dim() - 1
            dst.index_copy_(dim, res_pos, res[..., :n_res])
            dst.index_copy_(dim, delta_pos, delta)
    return out


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_ring_merge
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, ll, ll, p, p, p, p, p, ll, i, i, p, p]
    fn.restype = i
    return fn


def ring_merge(hi: torch.Tensor, lo: torch.Tensor,
               fstack: Optional[torch.Tensor], istack: Optional[torch.Tensor],
               n_res: int, d_hi: torch.Tensor, d_lo: torch.Tensor,
               d_f: Optional[torch.Tensor], d_i: Optional[torch.Tensor],
               delta_pos: torch.Tensor) -> Planes:
    """Fresh (hi, lo, fstack, istack) planes of the ring's ``cap``: the
    first ``n_res`` entries of the resident planes (hi/lo i32[cap],
    fstack f64[nf, cap], istack i64[ni, cap]) with the delta (d_hi/d_lo
    i32[m], d_f f64[nf, m], d_i i64[ni, m]) inserted at ``delta_pos``
    i64[m] — strictly increasing in [0, n_res + m), which the card does
    not check — and sentinel/zero padding after them.  The stacks are all
    None for a keys-only ring.  On the card: views of one buffer, one
    launch, no host sync."""
    cap, m, nf, ni = _check(hi, lo, fstack, istack, n_res, d_hi, d_lo, d_f,
                            d_i, delta_pos)
    dev = hi.device
    if dev.type == "cpu":
        return ring_merge_reference(hi, lo, fstack, istack, n_res, d_hi,
                                    d_lo, d_f, d_i, delta_pos)
    if dev.type != "cuda":
        raise ValueError(f"ring_merge: unsupported device {dev}")
    payload = fstack is not None
    buf = torch.empty(ring_words(cap, nf, ni), dtype=torch.int64, device=dev)
    stacks = ((fstack.data_ptr(), istack.data_ptr(), d_f.data_ptr(),
               d_i.data_ptr()) if payload else (0, 0, 0, 0))
    build.launch("ring_merge", _c_fn(), dev, hi.data_ptr(), lo.data_ptr(),
                 stacks[0], stacks[1], n_res, cap, d_hi.data_ptr(),
                 d_lo.data_ptr(), stacks[2], stacks[3], delta_pos.data_ptr(),
                 m, nf, ni, buf.data_ptr())
    ring_merge.launches += 1
    return ring_planes(buf, cap, nf, ni, payload)


ring_merge.launches = 0
