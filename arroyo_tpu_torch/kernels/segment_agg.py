"""``segment_agg``: per-segment reduction of k f64 channels over rows that
are grouped into contiguous segments — sum, min, max or the segment's row
count, per channel — plus the rows per segment.  Count channels read no
values, so ``values`` holds one row per channel of another kind only.

Replaces arroyo_tpu/ops/segment.py:30 ``_segment_agg_kernel``.

On the H100 it is bound by memory: each value of a reduced channel is
read once and one f64 per (channel, segment) and one i64 per segment are
written.  The CUDA kernel (``csrc/segment_agg.cu``) runs one block per
segment with a fixed reduction order, so sums are deterministic; a
skewed segment is reduced by a single block.

``segment_agg_reference`` is the plain PyTorch version; the wrapper takes
it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import build

KIND_CODES = {"sum": 0, "min": 1, "max": 2, "count": 3}
F64_MAX = float(np.finfo(np.float64).max)


def _check(values: torch.Tensor, offsets: torch.Tensor,
           kinds: Sequence[str]) -> Tuple[int, int, int]:
    if values.dtype != torch.float64 or values.dim() != 2:
        raise TypeError("values must be f64 [k_r, n]")
    k_r, n = values.shape
    if offsets.dtype != torch.int64 or offsets.dim() != 1 or \
            offsets.shape[0] < 1:
        raise TypeError("offsets must be i64 [n_seg + 1]")
    if any(x not in KIND_CODES for x in kinds) or \
            sum(x != "count" for x in kinds) != k_r:
        raise ValueError(f"kinds {kinds!r} do not match {k_r} value rows")
    if values.device != offsets.device:
        raise ValueError("values and offsets on different devices")
    if not (values.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("segment_agg needs contiguous tensors")
    return len(kinds), n, offsets.shape[0] - 1


def segment_agg_reference(values: torch.Tensor, offsets: torch.Tensor,
                          kinds: Sequence[str]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (out f64[k, n_seg], counts i64[n_seg]) —
    index_add_ for sums, scatter_reduce_ from the identity for min/max."""
    k, n, n_seg = _check(values, offsets, kinds)
    dev = values.device
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
            ident = F64_MAX if kind == "min" else -F64_MAX
            out[c] = torch.full((n_seg,), ident, dtype=torch.float64,
                                device=dev).scatter_reduce_(
                0, seg, next(rows), "amin" if kind == "min" else "amax")
    return out, counts


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_segment_agg
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, p, i, p, i, p, p, p]
    fn.restype = i
    return fn


def segment_agg(values: torch.Tensor, offsets: torch.Tensor,
                kinds: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out f64[k, n_seg], counts i64[n_seg]) over rows whose
    ``offsets[s]:offsets[s + 1]`` form segment s (``offsets``
    i64[n_seg + 1], 0 first, n last, non-decreasing).  ``kinds`` names
    each of the k channels' reduction: sum, min, max or count (rows per
    segment, as f64); ``values`` f64[k_r, n] holds one row per channel
    that is not a count, in channel order (k_r may be 0)."""
    k, n, n_seg = _check(values, offsets, kinds)
    dev = values.device
    if dev.type == "cpu":
        return segment_agg_reference(values, offsets, kinds)
    if dev.type != "cuda":
        raise ValueError(f"segment_agg: unsupported device {dev}")
    out = torch.empty((k, n_seg), dtype=torch.float64, device=dev)
    counts = torch.empty(n_seg, dtype=torch.int64, device=dev)
    if n_seg == 0:
        return out, counts  # nothing to launch
    codes = np.asarray([KIND_CODES[x] for x in kinds], dtype=np.int32)
    build.launch("segment_agg", _c_fn(), dev, values.data_ptr(), n,
                 offsets.data_ptr(), n_seg, codes.ctypes.data, k,
                 out.data_ptr(), counts.data_ptr())
    segment_agg.launches += 1
    return out, counts


segment_agg.launches = 0
