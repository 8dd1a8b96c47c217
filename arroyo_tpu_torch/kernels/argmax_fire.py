"""K2 ``argmax_fire``: candidate-only pane emission — the (key, pane)
cells whose pane count equals their pane's extremum, compacted in
row-major ``[C, kpad]`` order.

Replaces arroyo_tpu/ops/keyed_bins.py:157 ``_argmax_nnz_kernel`` and
:180 ``_argmax_gather_kernel``.

The caller's form is :func:`argmax_fire_buffer`: ONE allocation, i32
words laid out by :func:`argmax_layout` — word 0 the candidate total
(even when it exceeds ``capacity``), then the key row, the pane row and
the counts, each ``capacity`` long; :func:`argmax_views` splits it, on
the card or after one readback.  Only the first ``rows`` slots are read
(the state passes its ``next_slot``: every slot past it holds count 0,
so the output equals the JAX kernels' over all C).  The tuple form
:func:`argmax_fire` reads the total back (one sync) and launches again
when the candidates overflow the first capacity.

On the H100 it is bound by memory — one 64-byte row atom a slot, 7.7 MB
at q5's fire — and, at that size, by its launch and its one global
dependency (the extremum before the selection).  The CUDA kernel
(``csrc/argmax_fire.cu``) is one cooperative launch: each resident block
counts a chunk of whole slots for the live panes only, folds the
extremum, waits at a grid barrier, then selects from the counts it kept
in registers and writes at its offset among the blocks, with no count
plane, no fill and no host sync.  Any number of panes and ring width:
the panes are staged in shared memory up to the card's opt-in limit,
else read from global memory.  Its extrema, barrier counters and block
counts sit in a persistent workspace (:class:`_Workspace`) that no call
fills: the counts carry the call's epoch, and each call leaves the rest
zero.  There is one a device and stream, since two calls that ran at
once on one workspace would mix their words.

``argmax_fire_reference`` and ``argmax_fire_buffer_reference`` are the
plain PyTorch versions; the wrappers take them only for tensors on the
CPU."""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple, Union

import numpy as np
import torch

from . import build

WORKSPACE_PANES = 1024  # panes a first workspace holds; it grows past them
EPOCHS = 1 << 32  # call epochs 1 .. EPOCHS - 1, then the words are zeroed

Array = Union[torch.Tensor, np.ndarray]


def _check(counts: torch.Tensor, ring: torch.Tensor, bin_ok: torch.Tensor,
           minmax: str) -> Tuple[int, int, int, int]:
    if counts.dtype not in (torch.int32, torch.int64) or counts.dim() != 2:
        raise TypeError("counts must be i32/i64 [C, B]")
    C, B = counts.shape
    if ring.dtype != torch.int32 or ring.dim() != 2:
        raise TypeError("ring must be i32 [kpad, W]")
    kpad, W = ring.shape
    if bin_ok.dtype != torch.bool or tuple(bin_ok.shape) != (kpad, W):
        raise TypeError(f"bin_ok must be bool [{kpad}, {W}]")
    if minmax not in ("max", "min"):
        raise ValueError(minmax)
    devs = {t.device for t in (counts, ring, bin_ok)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in (counts, ring, bin_ok)):
        raise ValueError("argmax_fire needs contiguous tensors")
    if C * kpad >= 2**31:
        raise ValueError("C * kpad must stay below 2^31")
    return C, B, kpad, W


def argmax_fire_reference(counts: torch.Tensor, ring: torch.Tensor,
                          bin_ok: torch.Tensor, minmax: str
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: gather + masked sum, extremum, ``nonzero``."""
    kpad = ring.shape[0]
    g = counts[:, ring.long()]  # [C, kpad, W]
    cnt = torch.where(bin_ok[None], g, 0).sum(-1, dtype=counts.dtype)
    if minmax == "max":
        ext = cnt.max(dim=0).values
    else:
        big = torch.iinfo(counts.dtype).max
        ext = torch.where(cnt > 0, cnt, big).min(dim=0).values
    sel = (cnt == ext[None]) & (cnt > 0)
    flat = torch.nonzero(sel.reshape(-1)).squeeze(1)
    idx2 = torch.stack([(flat // kpad).to(torch.int32),
                        (flat % kpad).to(torch.int32)])
    return idx2, cnt.reshape(-1)[flat]


def argmax_layout(capacity: int, itemsize: int) -> Tuple[int, int]:
    """(first word of the counts, i32 words) of a buffer of ``capacity``
    candidates whose counts take ``itemsize`` bytes: word 0 the total,
    words 1.. the key row, then the pane row, then the counts (an i64 row
    starts on an even word)."""
    cnt_word = 1 + 2 * capacity
    if itemsize == 8:
        cnt_word += cnt_word & 1
    return cnt_word, cnt_word + capacity * itemsize // 4


def argmax_views(buf: Array, total: int, capacity: int,
                 dtype: torch.dtype) -> Tuple[Array, Array, Array]:
    """(key_idx i32, pane_idx i32, counts) of the first ``min(total,
    capacity)`` candidates of an :func:`argmax_fire_buffer` (a tensor, or
    its numpy copy); ``dtype`` is the counts plane's."""
    n = min(total, capacity)
    cnt_word, words = argmax_layout(capacity, torch.empty(
        0, dtype=dtype).element_size())
    if isinstance(buf, torch.Tensor):
        cnt = buf[cnt_word:words].view(dtype)
    else:
        cnt = buf[cnt_word:words].view(np.dtype(str(dtype).split(".")[-1]))
    return buf[1:1 + n], buf[1 + capacity:1 + capacity + n], cnt[:n]


def argmax_fire_buffer_reference(counts: torch.Tensor, ring: torch.Tensor,
                                 bin_ok: torch.Tensor, rows: int,
                                 minmax: str, capacity: int) -> torch.Tensor:
    """Plain version of :func:`argmax_fire_buffer`, from
    :func:`argmax_fire_reference` over the first ``rows`` slots."""
    idx2, cnt = argmax_fire_reference(counts[:rows], ring, bin_ok, minmax)
    total = idx2.shape[1]
    n = min(total, capacity)
    cnt_word, words = argmax_layout(capacity, counts.element_size())
    buf = torch.zeros(words, dtype=torch.int32, device=counts.device)
    buf[0] = total
    buf[1:1 + n] = idx2[0, :n]
    buf[1 + capacity:1 + capacity + n] = idx2[1, :n]
    buf[cnt_word:words].view(counts.dtype)[:n] = cnt[:n]
    return buf


class _Workspace:
    """The kernel's persistent words (``csrc/argmax_fire.cu``) for fires
    of up to ``panes`` panes: a candidate count a block tagged with the
    call's epoch, the grid barrier's counters and the extremum keys.
    Zero when made and never filled: each call takes a new epoch, and
    leaves the counters and keys zero (a refused launch writes nothing).
    The words are zeroed again only when the epochs wrap."""

    def __init__(self, dev: torch.device, panes: int):
        self.panes = panes
        self.words = torch.zeros(_c_fns()[1](panes), dtype=torch.int64,
                                 device=dev)
        self.epoch = 0

    def take(self) -> int:
        """The next call's epoch (under ``_lock``)."""
        self.epoch += 1
        if self.epoch == EPOCHS:
            self.words.zero_()
            self.epoch = 1
        return self.epoch


# one workspace a (device, stream): calls on one stream run one after
# another, and two streams never share one
_workspaces: Dict[Tuple[int, int], _Workspace] = {}
_lock = threading.Lock()


def _workspace(dev: torch.device, kpad: int) -> Tuple[_Workspace, int]:
    """The current stream's workspace for ``kpad`` panes and a new epoch."""
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    with _lock:
        ws = _workspaces.get(key)
        if ws is None or ws.panes < kpad:
            ws = _workspaces[key] = _Workspace(dev,
                                               max(kpad, WORKSPACE_PANES))
        return ws, ws.take()


@functools.lru_cache(maxsize=None)
def _c_fns():
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    fire = lib.arroyo_argmax_fire
    fire.argtypes = [p, i, p, p, i, i, i, i, i, p, i, ctypes.c_uint, i, p,
                     p]
    fire.restype = i
    words = lib.arroyo_argmax_workspace_words
    words.argtypes = [i]
    words.restype = i
    return fire, words


def argmax_fire_buffer(counts: torch.Tensor, ring: torch.Tensor,
                       bin_ok: torch.Tensor, rows: int, minmax: str,
                       capacity: int) -> torch.Tensor:
    """The candidates of the first ``rows`` slots of ``counts``
    i32|i64[C, B] under the pane ring ``ring`` i32[kpad, W] / ``bin_ok``
    bool[kpad, W] (``minmax`` 'max' or 'min') as ONE i32 buffer on the
    input device (:func:`argmax_layout`): the total in word 0, then up to
    ``capacity`` candidates.  One launch, no host sync."""
    C, _B, kpad, W = _check(counts, ring, bin_ok, minmax)
    if not 0 <= rows <= C or capacity < 0:
        raise ValueError(f"rows {rows} of {C} slots, capacity {capacity}")
    dev = counts.device
    if dev.type == "cpu":
        return argmax_fire_buffer_reference(counts, ring, bin_ok, rows,
                                            minmax, capacity)
    if dev.type != "cuda":
        raise ValueError(f"argmax_fire: unsupported device {dev}")
    _cnt_word, words = argmax_layout(capacity, counts.element_size())
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    ws, epoch = _workspace(dev, kpad)
    build.launch("argmax_fire", _c_fns()[0], dev, counts.data_ptr(),
                 int(counts.dtype == torch.int64), ring.data_ptr(),
                 bin_ok.data_ptr(), counts.shape[1], W, kpad, rows,
                 int(minmax == "max"), ws.words.data_ptr(), ws.panes, epoch,
                 capacity, buf.data_ptr())
    argmax_fire.launches += 1
    return buf


def argmax_fire(counts: torch.Tensor, ring: torch.Tensor,
                bin_ok: torch.Tensor, minmax: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx2 i32[2, nnz] = (key_idx, pane_idx) rows, counts[nnz]) for the
    candidate cells of all of ``counts``: :func:`argmax_fire_buffer` at a
    capacity of 1,024, its total read back (the one host sync, as in the
    JAX version) and, when it overflows, once more at the total.  Outputs
    lie on the input device."""
    C, _B, _kpad, _W = _check(counts, ring, bin_ok, minmax)
    if counts.device.type == "cpu":
        return argmax_fire_reference(counts, ring, bin_ok, minmax)
    cap = 1024
    buf = argmax_fire_buffer(counts, ring, bin_ok, C, minmax, cap)
    total = int(buf[0].item())
    if total > cap:
        cap = total
        buf = argmax_fire_buffer(counts, ring, bin_ok, C, minmax, cap)
    key, pane, cnt = argmax_views(buf, total, cap, counts.dtype)
    return torch.stack([key, pane]), cnt


argmax_fire.launches = 0
