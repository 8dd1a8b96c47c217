"""``segment_agg``: per-segment reduction of k f64 channels over rows that
are grouped into contiguous segments — sum, min, max or the segment's row
count, per channel — plus the rows per segment.  Count channels read no
values, so ``values`` holds one row per channel of another kind only.

Replaces arroyo_tpu/ops/segment.py:30 ``_segment_agg_kernel``.

On the H100 it is bound by memory: each value of a reduced channel is
read once and one f64 per (channel, segment) and one i64 per segment are
written.  The CUDA kernel (``csrc/segment_agg.cu``) cuts the work by rows:
a block reduces a tile of 2,048 rows whatever the segment lengths, joins
a segment's pieces inside the tile with a segmented scan, and the last
block to finish joins the pieces of segments that cross tile edges, in
tile order, so the sums are deterministic from run to run.  Everything
lands in ONE i64 buffer, row 0 the counts and rows 1..k the channels as
their bits, with the tiles' scratch after it: a call makes one
allocation, one launch and no host sync.  :func:`segment_agg_buffer`
returns the ``[k + 1, n_seg]`` buffer, which the segment reduce reads
back in one copy; :func:`segment_agg` is the kernel's public function in
the JAX kernel's form, (out, counts), and returns two views of it.

``segment_agg_reference`` is the plain PyTorch version; the wrappers take
it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import build

KIND_CODES = {"sum": 0, "min": 1, "max": 2, "count": 3}
TILE_ROWS = 2048  # csrc/segment_agg.cu kTile


@functools.lru_cache(maxsize=None)
def _codes(kinds: Tuple[str, ...]) -> Tuple[np.ndarray, int, int]:
    """(i32 kind codes, their address, value rows k_r) of a kinds tuple,
    built once per tuple: the C launcher reads the codes on the host."""
    if any(x not in KIND_CODES for x in kinds):
        raise ValueError(f"unknown kinds in {kinds!r}")
    codes = np.asarray([KIND_CODES[x] for x in kinds], dtype=np.int32)
    return codes, codes.ctypes.data, sum(x != "count" for x in kinds)


def _check(values: torch.Tensor, offsets: torch.Tensor,
           kinds: Tuple[str, ...]) -> Tuple[Tuple[np.ndarray, int, int],
                                            torch.device]:
    """What the C launcher cannot see: dtypes, shapes, one device and
    contiguity; returns (``_codes(kinds)``, the device)."""
    codes = _codes(kinds)
    if values.dtype != torch.float64 or values.dim() != 2:
        raise TypeError("values must be f64 [k_r, n]")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 or \
            offsets.shape[0] < 1:
        raise TypeError("offsets must be i64 [n_seg + 1]")
    if codes[2] != values.shape[0]:
        raise ValueError(f"kinds {kinds!r} do not match "
                         f"{values.shape[0]} value rows")
    dev = values.device
    if offsets.device != dev:
        raise ValueError("values and offsets on different devices")
    if not (values.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("segment_agg needs contiguous tensors")
    return codes, dev


def segment_agg_reference(values: torch.Tensor, offsets: torch.Tensor,
                          kinds: Sequence[str]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (out f64[k, n_seg], counts i64[n_seg]) —
    index_add_ for sums, scatter_reduce_ from the identity for min/max."""
    _, dev = _check(values, offsets, tuple(kinds))
    k, n_seg = len(kinds), offsets.shape[0] - 1
    counts = offsets[1:] - offsets[:-1]
    seg = torch.repeat_interleave(torch.arange(n_seg, device=dev), counts)
    out = torch.empty((k, n_seg), dtype=torch.float64, device=dev)
    rows = iter(values)  # one row per channel that is not a count
    for c, kind in enumerate(kinds):
        if kind == "count":
            out[c] = counts.to(torch.float64)
        elif kind == "sum":
            out[c] = torch.zeros(n_seg, dtype=torch.float64,
                                 device=dev).index_add_(0, seg, next(rows))
        else:
            ident = np.inf if kind == "min" else -np.inf
            out[c] = torch.full((n_seg,), ident, dtype=torch.float64,
                                device=dev).scatter_reduce_(
                0, seg, next(rows), "amin" if kind == "min" else "amax")
    return out, counts


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_segment_agg
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, p, i, p, i, p, ll, p]
    fn.restype = i
    return fn


def segment_agg_buffer(values: torch.Tensor, offsets: torch.Tensor,
                       kinds: Sequence[str]) -> torch.Tensor:
    """i64[k + 1, n_seg]: row 0 the rows per segment, row 1 + c channel
    c of :func:`segment_agg` as its f64 bits — one buffer, so a caller
    reads the whole result back in one copy."""
    kinds = tuple(kinds)
    (_, codes_ptr, k_r), dev = _check(values, offsets, kinds)
    if dev.type == "cpu":
        out, counts = segment_agg_reference(values, offsets, kinds)
        return torch.cat([counts[None], out.view(torch.int64)])
    if dev.type != "cuda":
        raise ValueError(f"segment_agg: unsupported device {dev}")
    k, n, n_seg = len(kinds), values.shape[1], offsets.shape[0] - 1
    # scratch: the head and tail pieces of every tile when more than one
    # tile of rows is reduced, as whole rows after the outputs (one
    # allocation and, without scratch, no view to make)
    tiles = -(-n // TILE_ROWS) if k_r else 0
    scratch = 2 * (k_r + 1) * tiles if tiles > 1 else 0
    extra = -(-scratch // n_seg) if scratch and n_seg else 0
    buf = torch.empty((k + 1 + extra, n_seg), dtype=torch.int64, device=dev)
    if n_seg:
        build.launch("segment_agg", _c_fn(), dev, values.data_ptr(), n,
                     offsets.data_ptr(), n_seg, codes_ptr, k, buf.data_ptr(),
                     extra * n_seg)
        segment_agg.launches += 1
    return buf[:k + 1] if extra else buf


def segment_agg(values: torch.Tensor, offsets: torch.Tensor,
                kinds: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out f64[k, n_seg], counts i64[n_seg]) over rows whose
    ``offsets[s]:offsets[s + 1]`` form segment s (``offsets``
    i64[n_seg + 1], 0 first, n last, non-decreasing).  ``kinds`` names
    each of the k channels' reduction: sum, min, max or count (rows per
    segment, as f64); ``values`` f64[k_r, n] holds one row per channel
    that is not a count, in channel order (k_r may be 0).  On the card
    both are views of one :func:`segment_agg_buffer`."""
    if values.device.type == "cpu":
        return segment_agg_reference(values, offsets, kinds)
    buf = segment_agg_buffer(values, offsets, kinds)
    return buf[1:].view(torch.float64), buf[0]


segment_agg.launches = 0
