"""``session_union``: the interval-union scan of session windows — for rows
sorted by (key, start), the inclusive running max of ends within each
key run and the new-session flags (a row opens a session when its key
differs from its predecessor's or its start lies past the running end of
every earlier interval of its key; touching intervals merge).

Replaces arroyo_tpu/ops/session.py:75 ``_union_kernel`` and, in the
buffer form, the host reductions its caller ran after it.

Two forms of one kernel (``csrc/session_union.cu``):

- :func:`session_union` — ``(new bool[n], run_en i64[n])``, the JAX
  kernel's form, as two views of one allocation;
- :func:`session_union_buffer` — ONE i64 buffer of ``1 + 2n`` words: the
  session count S, the first row of each session, then (from word
  ``1 + n``) each session's merged end, the max of its rows' ends;
  :func:`union_views` splits it.
  The session union's caller reads it back in one copy.

On the H100 it is bound by memory at large n (24 bytes read a row) and
by its launch at config5's merges of 64-192 rows.  Up to 1,024 rows a
call is one block and one launch, with no workspace; above that a block
a tile (about two tiles an SM) finds its carry by a look-back over the
earlier tiles' totals, after one zero-fill of the call's status words.
``session_union.last_launches`` holds the device operations of the last
call, zero-fill included.  It stays in int64 throughout.

``session_union_reference`` and ``session_union_buffer_reference`` are
the plain PyTorch versions (log-doubling with a same-key guard, as the
JAX kernel scans); the wrappers take them only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

TILE = 1024  # rows a block scans (csrc/session_union.cu kTile)


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


def session_union_buffer_reference(kh: torch.Tensor, st: torch.Tensor,
                                   en: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the buffer form: i64[1 + 2n] (words past
    the session count in either row are 0)."""
    n = kh.shape[0]
    new, _run = session_union_reference(kh, st, en)
    first = torch.nonzero(new).squeeze(1)
    s = first.shape[0]
    sid = torch.cumsum(new.to(torch.int64), 0) - 1
    buf = torch.zeros(1 + 2 * n, dtype=torch.int64, device=kh.device)
    buf[0] = s
    buf[1:1 + s] = first
    buf[1 + n:1 + n + s] = torch.full(
        (s,), torch.iinfo(torch.int64).min, dtype=torch.int64,
        device=kh.device).scatter_reduce_(0, sid, en, "amax")
    return buf


def union_views(buf, n: int):
    """(S, sess_first[S], m_en[S]) of a :func:`session_union_buffer` over
    n rows — a tensor or its numpy copy (a tensor's S is read from it)."""
    s = int(buf[0])
    return s, buf[1:1 + s], buf[1 + n:1 + n + s]


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_session_union
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _workspace_words(n: int) -> int:
    """i64 words of a call's look-back workspace (none for one tile): room
    for ceil(n / 1,024) tiles; the launcher may take fewer, larger ones."""
    tiles = (n + TILE - 1) // TILE
    return 1 + 10 * tiles if tiles > 1 else 0


def _launch(kh, st, en, n, buffer_form, out, new_flag, ws) -> None:
    build.launch("session_union", _c_fn(), kh.device, kh.data_ptr(),
                 st.data_ptr(), en.data_ptr(), n, int(buffer_form),
                 out.data_ptr(), 0 if new_flag is None else
                 new_flag.data_ptr(), 0 if ws is None else ws.data_ptr())
    session_union.launches += 1
    session_union.last_launches = 1 + (ws is not None)  # + the zero-fill


def _device(kh: torch.Tensor) -> torch.device:
    dev = kh.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"session_union: unsupported device {dev}")
    return dev


def session_union(kh: torch.Tensor, st: torch.Tensor, en: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new bool[n], run_en i64[n]) for interval rows ``kh``/``st``/``en``
    i64[n] sorted by (kh, st); ``kh`` holds the u64 key hashes as int64
    bit views.  On the card: views of one allocation."""
    n = _check(kh, st, en)
    dev = _device(kh)
    if dev.type == "cpu":
        return session_union_reference(kh, st, en)
    flag_words = (n + 7) // 8
    ws_words = _workspace_words(n)
    buf = torch.empty(n + flag_words + ws_words, dtype=torch.int64,
                      device=dev)
    run_en = buf[:n]
    new = buf[n:n + flag_words].view(torch.bool)[:n]
    if n:
        _launch(kh, st, en, n, False, run_en, new,
                buf[n + flag_words:] if ws_words else None)
    return new, run_en


def session_union_buffer(kh: torch.Tensor, st: torch.Tensor,
                         en: torch.Tensor) -> torch.Tensor:
    """i64[1 + 2n]: the session count S of interval rows ``kh``/``st``/
    ``en`` i64[n] sorted by (kh, st), the first row of each session
    (words 1..S), and each session's merged end (words 1 + n..n + S)."""
    n = _check(kh, st, en)
    dev = _device(kh)
    if dev.type == "cpu":
        return session_union_buffer_reference(kh, st, en)
    if n == 0:  # nothing to launch
        return torch.zeros(1, dtype=torch.int64, device=dev)
    ws_words = _workspace_words(n)
    buf = torch.empty(1 + 2 * n + ws_words, dtype=torch.int64, device=dev)
    _launch(kh, st, en, n, True, buf, None,
            buf[1 + 2 * n:] if ws_words else None)
    return buf[:1 + 2 * n]


session_union.launches = 0
session_union.last_launches = 0
