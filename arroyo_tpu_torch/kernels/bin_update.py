"""K1 ``bin_update``: scatter pre-aggregated (slot, bin) cells into the
keyed bin ring, in place.

Replaces arroyo_tpu/ops/keyed_bins.py:62 ``_update_kernel`` (XLA scatter)
and arroyo_tpu/ops/pallas_kernels.py:77 ``_scatter_kernel`` (its one-hot
MXU form on the TPU, reached through ``update_bin_state``, :212).

A flush's cells travel as ONE i64 buffer ``[2 + n_xfer, m]``
(:func:`pack_cells` builds it on the host, :func:`cell_views` splits it):
row 0 the i32 slots then the i32 bins, row 1 the f64 rowcounts, rows 2..
the transferred channels' f64 values.  The channels' kinds and sources
are a :class:`ChannelPlan` of three 64-bit masks, built once per state
by :func:`channel_plan`.

On the H100 it is bound by memory — scattered 8-byte read-modify-writes
per channel per cell — and, at nexmark q5's flushes, by the launch
itself.  The CUDA kernel (``csrc/bin_update.cu``) runs one thread per
cell with native atomics (MIN/MAX one integer atomic on the f64 bits),
so duplicate cells are exact without sorting and every flush is one
launch; the wrapper allocates nothing.

Unlike the JAX kernel, which returns new arrays, the port updates
``values`` and ``counts`` where they lie.  ``bin_update_reference`` is
the plain PyTorch version of the same function; the wrapper takes it only
for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from . import build

KIND_CODES = {"sum": 0, "avg": 0, "count": 0, "min": 1, "max": 2}
F64_MAX = float(torch.finfo(torch.float64).max)
MAX_CHANNELS = 64  # one bit a channel in the plan's masks


def channel_identity(kind: str) -> float:
    """Aggregation identity of a channel kind: +/- the f64 maximum for
    min/max (f32 extremes would clip values beyond 3.4e38), 0 for the
    additive kinds."""
    if kind == "min":
        return F64_MAX
    if kind == "max":
        return -F64_MAX
    return 0.0


class ChannelPlan(NamedTuple):
    """What each of ``n_ch`` channels does with a cell, as bit masks
    (bit j: channel j).  ``dup``: a COUNT(*) channel, whose value is the
    rowcount itself; the others read the transferred rows in channel
    order.  ``mn`` / ``mx``: reduced by min / max; the rest add."""
    n_ch: int
    dup: int
    mn: int
    mx: int

    @property
    def n_xfer(self) -> int:
        return self.n_ch - bin(self.dup).count("1")


def channel_plan(kinds: Sequence[str], dup: Sequence[int] = ()
                 ) -> ChannelPlan:
    """The plan of channels ``kinds`` (sum/avg/count/min/max) whose
    COUNT(*) channels are ``dup``."""
    if len(kinds) > MAX_CHANNELS or any(k not in KIND_CODES for k in kinds):
        raise ValueError(f"kinds {kinds!r}: at most {MAX_CHANNELS} of "
                         f"{sorted(KIND_CODES)}")
    if any(not 0 <= j < len(kinds) for j in dup):
        raise ValueError(f"COUNT(*) channels {dup!r} outside {len(kinds)}")

    def mask(js):
        return sum(1 << j for j in set(js))

    return ChannelPlan(len(kinds), mask(dup),
                       mask(j for j, k in enumerate(kinds) if k == "min"),
                       mask(j for j, k in enumerate(kinds) if k == "max"))


def pack_cells(slots: np.ndarray, bins: np.ndarray, rowcnt: np.ndarray,
               vals: np.ndarray) -> np.ndarray:
    """The one host buffer of a flush: i64 ``[2 + n_xfer, m]`` from the
    cells' slots, bins, rowcounts and transferred values ``[n_xfer, m]``."""
    m = len(slots)
    buf = np.empty((2 + len(vals), m), dtype=np.int64)
    idx = buf[0].view(np.int32)
    idx[:m] = slots
    idx[m:] = bins
    f = buf[1:].view(np.float64)
    f[0] = rowcnt
    f[1:] = vals
    return buf


Array = Union[torch.Tensor, np.ndarray]


def cell_views(cells: Array) -> Tuple[Array, Array, Array]:
    """(slots i32[m], bins i32[m], rows f64[1 + n_xfer, m]) of a cell
    buffer, as views (a tensor or a numpy array)."""
    m = cells.shape[1]
    i32, f64 = ((torch.int32, torch.float64) if isinstance(cells, torch.Tensor)
                else (np.int32, np.float64))
    idx = cells[0].view(i32)
    return idx[:m], idx[m:], cells[1:].view(f64)


def _check(values: torch.Tensor, counts: torch.Tensor, cells: torch.Tensor,
           plan: ChannelPlan) -> Tuple[int, int, int]:
    if values.dtype != torch.float64 or values.dim() != 3:
        raise TypeError("values must be f64 [n_ch, C, B]")
    n_ch, C, B = values.shape
    if n_ch != plan.n_ch:
        raise ValueError(f"plan of {plan.n_ch} channels for {n_ch}")
    if counts.dtype not in (torch.int32, torch.int64) or \
            tuple(counts.shape) != (C, B):
        raise TypeError("counts must be i32/i64 [C, B]")
    if cells.dtype != torch.int64 or cells.dim() != 2 or \
            cells.shape[0] != 2 + plan.n_xfer:
        raise TypeError(f"cells must be i64 [{2 + plan.n_xfer}, m]")
    if not (values.device == counts.device == cells.device):
        raise ValueError("tensors on several devices: "
                         f"{values.device}, {counts.device}, {cells.device}")
    if not (values.is_contiguous() and counts.is_contiguous()
            and cells.is_contiguous()):
        raise ValueError("bin_update needs contiguous tensors")
    return C, B, cells.shape[1]


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """f64 values as i64 keys in the same order, -0.0 below +0.0 (its own
    inverse on the keys' bits)."""
    b = x.view(torch.int64)
    return b ^ ((b >> 63) & 0x7FFF_FFFF_FFFF_FFFF)


def bin_update_reference(values: torch.Tensor, counts: torch.Tensor,
                         cells: torch.Tensor, plan: ChannelPlan) -> None:
    """Plain PyTorch version: masked ``index_put_(accumulate=True)`` for
    counts and additive channels; min/max by ``scatter_reduce_`` over the
    touched cells' order-preserving integer keys."""
    n_ch, C, B = values.shape
    slots, bins, rows = cell_views(cells)
    s, b, rc = slots.long(), bins.long(), rows[0]
    ok = (rc > 0.5) & (s >= 0) & (s < C) & (b >= 0) & (b < B)
    s, b, rc = s[ok], b[ok], rc[ok]
    counts.index_put_((s, b), rc.to(counts.dtype), accumulate=True)
    flat = s * B + b
    touched, inv = torch.unique(flat, return_inverse=True)
    r = 1
    for j in range(n_ch):
        bit = 1 << j
        if plan.dup & bit:
            x = rc
        else:
            x = rows[r][ok]
            r += 1
        if plan.mn & bit or plan.mx & bit:
            plane = values[j].view(-1)
            cur = _ordered(plane[touched].contiguous())
            cur.scatter_reduce_(0, inv, _ordered(x.contiguous()),
                                reduce="amin" if plan.mn & bit else "amax",
                                include_self=True)
            plane[touched] = _ordered(cur).view(torch.float64)
        else:
            values[j].index_put_((s, b), x, accumulate=True)


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_bin_update
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    fn.argtypes = [p, p, i, p, ctypes.c_longlong, i, i, i, q, q, q, p]
    fn.restype = i
    return fn


def bin_update(values: torch.Tensor, counts: torch.Tensor,
               cells: torch.Tensor, plan: ChannelPlan) -> None:
    """Apply a flush's cells to the planes in place.

    ``values`` f64[n_ch, C, B], ``counts`` i32|i64[C, B], ``cells`` the
    i64 ``[2 + n_xfer, m]`` buffer of :func:`pack_cells`, ``plan`` the
    channels' :class:`ChannelPlan`.  A cell with rowcount <= 0.5, or a
    slot or bin outside the planes, is skipped."""
    C, B, m = _check(values, counts, cells, plan)
    dev = values.device
    if dev.type == "cpu":
        bin_update_reference(values, counts, cells, plan)
        return
    if dev.type != "cuda":
        raise ValueError(f"bin_update: unsupported device {dev}")
    if m == 0:
        return
    build.launch("bin_update", _c_fn(), dev, values.data_ptr(),
                 counts.data_ptr(), int(counts.dtype == torch.int64),
                 cells.data_ptr(), m, C, B, plan.n_ch, plan.dup, plan.mn,
                 plan.mx)
    bin_update.launches += 1


bin_update.launches = 0
