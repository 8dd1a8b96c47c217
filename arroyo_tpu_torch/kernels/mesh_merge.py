"""K-b ``mesh_merge``: merge one key shard's sorted key table with the keys
routed to it, and lay the routed cells out for ``bin_update``.

Replaces the merge half of arroyo_tpu/parallel/mesh_window.py:119
``_update_step`` (:194-250: the sort of old ++ incoming keys, the distinct
keys' ranks, ``count_less`` of the old keys and of the routed rows).

Keys are u64 bits in i64 words, ordered UNSIGNED, EMPTY (-1) padding.
Inputs: the shard's table ``old`` i64[C] (sorted, real keys first), the
routed keys sorted (``in_keys`` i64[R], EMPTY last) with their rows
(``in_order`` i64[R]: :func:`~arroyo_tpu_torch.kernels.join_sort.join_sort`
gives both) and the routed rows ``inc`` i64[4 + n_ch, R] (key, validity,
bin, row count, channel values: ``mesh_route``'s buckets after the
exchange).  The output is ONE i64 buffer (:func:`merge_views`):

* ``new_keys`` i64[C]: old's keys and the NEW keys (distinct, real,
  absent from old) in order, cut at C, EMPTY-padded;
* ``src`` i64[C]: each merged slot's old slot, -1 for a new key or
  padding (``mesh_remap``'s map);
* ``cells`` i64[2 + n_ch, R]: ``bin_update``'s cell buffer over the
  routed rows in key order — their slots (-1: padding or cut at C) and
  bins, row counts and channel values;
* a key-drop counter: keys cut at C, old or new (the JAX step's
  ``key_drop``), or the caller's ``counter``.

On the H100 it is bound by memory; the CUDA kernel
(``csrc/mesh_merge.cu``) is one launch after two memsets: a scan of the
routed keys with a look-back across tiles, then the old keys placed by a
search of the routed keys.  ``mesh_merge_reference`` is the plain PyTorch
version (``searchsorted`` on top-bit-flipped keys, ``cumsum``); the
wrapper takes it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build
from .join_sort import unsigned_order

EMPTY = -1


def merge_views(buf: torch.Tensor, C: int, R: int, n_ch: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """(new_keys i64[C], src i64[C], cells i64[2 + n_ch, R], key-drop
    counter i64[1]) of a :func:`mesh_merge` buffer."""
    n = (2 + n_ch) * R
    return (buf[:C], buf[C:2 * C], buf[2 * C:2 * C + n].view(2 + n_ch, R),
            buf[2 * C + n:2 * C + n + 1])


def _check(old: torch.Tensor, in_keys: torch.Tensor, in_order: torch.Tensor,
           inc: torch.Tensor) -> Tuple[int, int, int]:
    for t, what in ((old, "old"), (in_keys, "in_keys"),
                    (in_order, "in_order")):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{what} must be a contiguous i64 vector")
    C, R = old.shape[0], in_keys.shape[0]
    if C < 1 or in_order.shape[0] != R:
        raise ValueError(f"C {C}, {R} keys, {in_order.shape[0]} rows")
    if inc.dtype != torch.int64 or inc.dim() != 2 or inc.shape[0] < 4 or \
            inc.shape[1] != R or not inc.is_contiguous():
        raise TypeError(f"inc must be contiguous i64 [4 + n_ch, {R}]")
    devs = {old.device, in_keys.device, in_order.device, inc.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    return C, R, inc.shape[0] - 4


def mesh_merge_reference(old: torch.Tensor, in_keys: torch.Tensor,
                         in_order: torch.Tensor, inc: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    int]:
    """Plain PyTorch version: (new_keys, src, cells, keys dropped)."""
    C, R, n_ch = _check(old, in_keys, in_order, inc)
    dev = old.device
    u_old, u_in = unsigned_order(old), unsigned_order(in_keys)
    real = in_keys != EMPTY
    head = real.clone()
    head[1:] &= in_keys[1:] != in_keys[:-1]
    lb = torch.searchsorted(u_old, u_in)
    present = real & (old[lb.clamp(max=C - 1)] == in_keys) & (lb < C)
    fresh = head & ~present
    incl = torch.cumsum(fresh.long(), 0)
    slot = lb + incl - (~present).long()
    keep = real & (slot < C)
    dropped = int((fresh & (slot >= C)).sum())
    new_keys = torch.full((C,), EMPTY, dtype=torch.int64, device=dev)
    src = torch.full((C,), -1, dtype=torch.int64, device=dev)
    put = fresh & keep
    new_keys[slot[put]] = in_keys[put]
    old_real = old != EMPTY
    below = torch.searchsorted(u_in, u_old)
    lt = torch.where(below > 0, incl[(below - 1).clamp(min=0)]
                     if R else torch.zeros_like(below), 0)
    moved = torch.arange(C, device=dev) + lt
    placed = old_real & (moved < C)
    dropped += int((old_real & (moved >= C)).sum())
    new_keys[moved[placed]] = old[placed]
    src[moved[placed]] = torch.nonzero(placed).flatten()
    cells = torch.empty((2 + n_ch, R), dtype=torch.int64, device=dev)
    idx = cells[0].view(torch.int32)
    idx[:R] = torch.where(keep, slot, -1).to(torch.int32)
    idx[R:] = inc[2, in_order].to(torch.int32)
    cells[1:] = inc[3:, in_order]
    return new_keys, src, cells, dropped


@functools.lru_cache(maxsize=None)
def _c_fns():
    lib = build.load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.arroyo_mesh_merge
    fn.argtypes = [p, ll, p, p, p, ll, i, p, p, p, p, p]
    fn.restype = i
    words = lib.arroyo_mesh_merge_ws_words
    words.argtypes = [ll]
    words.restype = ll
    return fn, words


def mesh_merge(old: torch.Tensor, in_keys: torch.Tensor,
               in_order: torch.Tensor, inc: torch.Tensor,
               counter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ONE i64 buffer (:func:`merge_views`), then the card's workspace.
    Keys cut at C are added to ``counter`` (an i64 element on the same
    device) when given, else to the buffer's counter word.  One
    allocation, no host sync."""
    C, R, n_ch = _check(old, in_keys, in_order, inc)
    dev = old.device
    if counter is not None and (counter.device != dev
                                or counter.dtype != torch.int64):
        raise ValueError("counter must be an i64 element on the keys' "
                         "device")
    n = 2 * C + (2 + n_ch) * R
    if dev.type == "cpu":
        new_keys, src, cells, dropped = mesh_merge_reference(
            old, in_keys, in_order, inc)
        buf = torch.empty(n + 1, dtype=torch.int64)
        v_keys, v_src, v_cells, v_drop = merge_views(buf, C, R, n_ch)
        v_keys.copy_(new_keys)
        v_src.copy_(src)
        v_cells.copy_(cells)
        if counter is not None:
            counter += dropped
            dropped = 0
        v_drop.fill_(dropped)
        return buf
    if dev.type != "cuda":
        raise ValueError(f"mesh_merge: unsupported device {dev}")
    fn, words = _c_fns()
    buf = torch.empty(n + words(R), dtype=torch.int64, device=dev)
    drops = counter if counter is not None else buf[n:n + 1]
    build.launch("mesh_merge", fn, dev, old.data_ptr(), C,
                 in_keys.data_ptr(), in_order.data_ptr(), inc.data_ptr(), R,
                 n_ch, buf.data_ptr(), buf[2 * C:].data_ptr(),
                 drops.data_ptr(), buf[n:].data_ptr())
    mesh_merge.launches += 1
    return buf


mesh_merge.launches = 0
