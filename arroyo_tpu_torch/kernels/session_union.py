"""``session_union``: the interval-union scan of session windows — for rows
sorted by (key, start), the inclusive running max of ends within each
key run and the new-session flags (a row opens a session when its key
differs from its predecessor's or its start lies past the running end of
every earlier interval of its key; touching intervals merge).

Replaces arroyo_tpu/ops/session.py:75 ``_union_kernel``.

On the H100 it is bound by memory: three int64 reads and one int64 plus
one flag byte written per row.  The CUDA kernel (``csrc/session_union.cu``)
is a segmented max-scan in three stream-ordered launches — per-tile scan,
one-block scan of the tile carries, row-parallel fix-up — because a key
run may span every tile.  It stays in int64 throughout.

``session_union_reference`` is the plain PyTorch version (log-doubling
with a same-key guard, as the JAX kernel scans); the wrapper takes it
only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

TILE = 1024  # rows per block of the tile scan (csrc/session_union.cu)


def _check(kh: torch.Tensor, st: torch.Tensor, en: torch.Tensor) -> int:
    for name, t in (("kh", kh), ("st", st), ("en", en)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{name} must be i64 [n]")
    n = kh.shape[0]
    if st.shape[0] != n or en.shape[0] != n:
        raise ValueError("kh, st and en must have one length")
    devs = {t.device for t in (kh, st, en)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in (kh, st, en)):
        raise ValueError("session_union needs contiguous tensors")
    return n


def session_union_reference(kh: torch.Tensor, st: torch.Tensor,
                            en: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (new bool[n], run_en i64[n])."""
    n = kh.shape[0]
    newkey = torch.ones(n, dtype=torch.bool, device=kh.device)
    if n > 1:
        newkey[1:] = kh[1:] != kh[:-1]
    gid = torch.cumsum(newkey.to(torch.int64), 0)
    run = en.clone()
    d = 1
    while d < n:
        same = gid[d:] == gid[:-d]
        run = torch.cat([run[:d], torch.where(
            same, torch.maximum(run[d:], run[:-d]), run[d:])])
        d <<= 1
    new = newkey.clone()
    if n > 1:
        new[1:] |= st[1:] > run[:-1]
    return new, run


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_session_union
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_longlong, p, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def session_union(kh: torch.Tensor, st: torch.Tensor, en: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new bool[n], run_en i64[n]) for interval rows ``kh``/``st``/``en``
    i64[n] sorted by (kh, st); ``kh`` holds the u64 key hashes as int64
    bit views."""
    n = _check(kh, st, en)
    dev = kh.device
    if dev.type == "cpu":
        return session_union_reference(kh, st, en)
    if dev.type != "cuda":
        raise ValueError(f"session_union: unsupported device {dev}")
    new = torch.empty(n, dtype=torch.bool, device=dev)
    run_en = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return new, run_en  # nothing to launch
    n_tiles = (n + TILE - 1) // TILE
    local = torch.empty(n + 2 * n_tiles, dtype=torch.int64, device=dev)
    tile_i32 = torch.empty(2 * n_tiles, dtype=torch.int32, device=dev)
    tile_v, carry = local[n:n + n_tiles], local[n + n_tiles:]
    tile_f, first_head = tile_i32[:n_tiles], tile_i32[n_tiles:]
    build.launch("session_union", _c_fn(), dev, kh.data_ptr(), st.data_ptr(),
                 en.data_ptr(), n, local.data_ptr(), tile_f.data_ptr(),
                 tile_v.data_ptr(), carry.data_ptr(), first_head.data_ptr(),
                 new.data_ptr(), run_en.data_ptr())
    session_union.launches += 1
    return new, run_en


session_union.launches = 0
