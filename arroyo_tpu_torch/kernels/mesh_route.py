"""K-a ``mesh_route``: bucket one source shard's rows by destination shard,
the route half of the keyed mesh's update step and of the co-located
device shuffle.

Replaces the route halves of arroyo_tpu/parallel/mesh_window.py:119
``_update_step`` (:153-178) and arroyo_tpu/parallel/shuffle.py:193
``_route_step`` (:221-233).

A source's rows travel as ONE i64 buffer ``[F, N]``: row 0 the key hash
(u64 bits), row 1 a validity word (0: padding), rows 2.. raw 64-bit words
that ride along (f64 bits or i64).  A valid row's destination follows
``rule``: :data:`RULE_MESH` the top ``log2(nk)`` bits of ``key <<
shift`` (the mesh's key-range owner after the subtask bits), or
:data:`RULE_SHUFFLE` ``min(key // (U64_MAX // nk), nk - 1)`` (the host
collector's ``server_for_hash``).  The output buffer starts with
``[F, nk, N]`` (:func:`route_views`): bucket ``d`` of field ``f`` holds
the valid rows bound for ``d`` in source order, EMPTY (-1) in the key row
and 0 in the others past them — the JAX step's buckets word for word.
Rows past a bucket's capacity ``N`` are dropped and counted into
``counter`` (a source holds N rows, so none is).

On the H100 it is bound by memory: F words a row read, ``nk * F * N``
words written.  The CUDA kernel (``csrc/mesh_route.cu``) is one launch
after two memsets: a stable counting sort whose per-destination offsets
cross tiles by a decoupled look-back.  ``mesh_route_reference`` is the
plain PyTorch version; the wrapper takes it only for tensors on the
CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build

RULE_MESH = 0
RULE_SHUFFLE = 1
MAX_DEST = 64  # csrc/mesh_route.cu kMaxDest
EMPTY = -1  # the u64 all-ones key as i64 bits


def _check(rows: torch.Tensor, nk: int, rule: int, shift: int) -> None:
    if rows.dtype != torch.int64 or rows.dim() != 2 or rows.shape[0] < 2:
        raise TypeError("rows must be i64 [F >= 2, N]")
    if not rows.is_contiguous():
        raise ValueError("mesh_route needs a contiguous tensor")
    if not 1 <= nk <= MAX_DEST or nk & (nk - 1):
        raise ValueError(f"nk {nk}: a power of two up to {MAX_DEST}")
    if rule not in (RULE_MESH, RULE_SHUFFLE) or not 0 <= shift <= 32:
        raise ValueError(f"rule {rule}, shift {shift}")


def destinations(keys: torch.Tensor, nk: int, rule: int, shift: int = 0
                 ) -> torch.Tensor:
    """The destination shard of each u64 key (i64 bits) under ``rule``,
    for a power-of-two ``nk``, in i64 arithmetic (torch has no u64):
    top bits by an arithmetic shift and a mask; the range rule as
    ``q + (r >= R - q)`` with ``q`` the top bits, ``r`` the rest and ``R =
    2**(64 - lg) - 1 == U64_MAX // nk``, which is ``key // R`` exactly."""
    if nk == 1:
        return torch.zeros_like(keys)
    lg = nk.bit_length() - 1
    s = 64 - lg
    if rule == RULE_MESH:
        return ((keys << shift) >> s) & (nk - 1)
    q = (keys >> s) & (nk - 1)
    r_max = (1 << s) - 1
    r = keys & r_max
    return torch.clamp(q + (r >= r_max - q).long(), max=nk - 1)


def route_views(buf: torch.Tensor, F: int, nk: int, N: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(buckets i64[F, nk, N], the drop counter i64[1]) of a
    :func:`mesh_route` buffer."""
    n = F * nk * N
    return buf[:n].view(F, nk, N), buf[n:n + 1]


def mesh_route_reference(rows: torch.Tensor, nk: int, rule: int,
                         shift: int = 0) -> Tuple[torch.Tensor, int]:
    """Plain PyTorch version: (buckets i64[F, nk, N], dropped rows) by a
    stable sort of the valid rows' destinations."""
    F, N = rows.shape
    out = torch.zeros((F, nk, N), dtype=torch.int64, device=rows.device)
    out[0] = EMPTY
    ok = rows[1] != 0
    idx = torch.nonzero(ok).flatten()
    dest = destinations(rows[0, idx], nk, rule, shift)
    order = torch.sort(dest, stable=True).indices
    idx, dest = idx[order], dest[order]
    start = torch.searchsorted(dest, torch.arange(nk, device=rows.device))
    pos = torch.arange(len(idx), device=rows.device) - start[dest]
    keep = pos < N
    out[:, dest[keep], pos[keep]] = rows[:, idx[keep]]
    return out, int((~keep).sum())


@functools.lru_cache(maxsize=None)
def _c_fns():
    lib = build.load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.arroyo_mesh_route
    fn.argtypes = [p, ll, i, i, i, i, p, p, p, p]
    fn.restype = i
    words = lib.arroyo_mesh_route_ws_words
    words.argtypes = [ll, i]
    words.restype = ll
    return fn, words


def mesh_route(rows: torch.Tensor, nk: int, rule: int, shift: int = 0,
               counter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ONE i64 buffer: the buckets ``[F, nk, N]`` and a drop counter
    (:func:`route_views`), then the card's workspace.  Dropped rows are
    added to ``counter`` (an i64 element on the same device) when given,
    else to the buffer's own counter word.  One allocation, no host
    sync."""
    _check(rows, nk, rule, shift)
    F, N = rows.shape
    dev = rows.device
    if counter is not None and (counter.device != dev
                                or counter.dtype != torch.int64):
        raise ValueError("counter must be an i64 element on the rows' "
                         "device")
    if dev.type == "cpu":
        out, dropped = mesh_route_reference(rows, nk, rule, shift)
        buf = torch.empty(F * nk * N + 1, dtype=torch.int64)
        v_out, v_drop = route_views(buf, F, nk, N)
        v_out.copy_(out)
        if counter is not None:
            counter += dropped
            dropped = 0
        v_drop.fill_(dropped)
        return buf
    if dev.type != "cuda":
        raise ValueError(f"mesh_route: unsupported device {dev}")
    fn, words = _c_fns()
    n = F * nk * N
    buf = torch.empty(n + words(N, nk), dtype=torch.int64, device=dev)
    drops = counter if counter is not None else buf[n:n + 1]
    build.launch("mesh_route", fn, dev, rows.data_ptr(), N, F, nk, rule,
                 shift, buf.data_ptr(), drops.data_ptr(),
                 buf[n:].data_ptr())
    mesh_route.launches += 1
    return buf


mesh_route.launches = 0
