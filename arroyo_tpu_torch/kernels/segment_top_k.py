"""K12 ``segment_top_k``: per segment, the rows whose rank by value
(descending; ties by original index) is below ``k``, returned as their
indices in ascending original order.

Replaces arroyo_tpu/ops/topk.py:25 ``_topk_kernel`` (and the host sort of
its output, topk.py:65).  -0.0 equals +0.0 and NaN of either sign ranks
last, as ``lax.sort`` orders them.

On the H100 it is bound by memory — 12 bytes read per row and 4 written
per kept row — and, at TopN's sizes, by its launches and two scalar
readbacks.  The CUDA kernels (``csrc/segment_top_k.cu``) radix-sort the
row indices by (segment, value) over the 8-bit digits that vary (a mask
read back after the key pass picks them), mark each sorted row whose
k-th predecessor lies in another segment, and compact the marks in
original order; no step works per segment, so one segment holding every
row costs what many small ones do.

``segment_top_k_reference`` is the plain PyTorch version (two stable
sorts); the wrapper takes it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

THREADS = 256  # rows per block of the select/gather kernels
TILE = 4096  # rows per tile of a radix pass (csrc/segment_top_k.cu)
_SIGN = -(2**63)


def _check(seg: torch.Tensor, val: torch.Tensor, k: int) -> int:
    if seg.dtype != torch.int32 or seg.dim() != 1:
        raise TypeError("seg must be i32 [n]")
    if val.dtype != torch.float64 or tuple(val.shape) != tuple(seg.shape):
        raise TypeError("val must be f64 [n], like seg")
    if seg.device != val.device:
        raise ValueError(f"tensors on several devices: "
                         f"{{{seg.device}, {val.device}}}")
    if not (seg.is_contiguous() and val.is_contiguous()):
        raise ValueError("segment_top_k needs contiguous tensors")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    n = seg.shape[0]
    if n >= 2**31:
        raise ValueError("segment_top_k takes fewer than 2^31 rows")
    return n


def order_keys(val: torch.Tensor) -> torch.Tensor:
    """i64 keys that sort ascending as ``val`` sorts descending, with -0.0
    equal to +0.0 and every NaN last (the sign-flipped form of the
    kernel's u64 keys)."""
    bits = (-val).view(torch.int64)
    bits = torch.where(bits == _SIGN, 0, bits)  # -0.0 -> +0.0
    key = torch.where(bits < 0, bits ^ (2**63 - 1), bits)
    return torch.where(torch.isnan(val), 2**63 - 1, key)


def segment_top_k_reference(seg: torch.Tensor, val: torch.Tensor, k: int
                            ) -> torch.Tensor:
    """Plain PyTorch version: a stable sort by value key, then a stable
    sort by segment, rank by the k-th predecessor's segment, keep flags
    at original positions, ``nonzero``."""
    n = seg.shape[0]
    by_val = torch.sort(order_keys(val), stable=True).indices
    by_seg = torch.sort(seg[by_val], stable=True).indices
    perm = by_val[by_seg]
    s = seg[perm]
    keep_sorted = torch.zeros(n, dtype=torch.bool, device=seg.device)
    keep_sorted[:k] = True
    if 0 < k < n:
        keep_sorted[k:] = s[k:] != s[:-k]
    flags = torch.zeros(n, dtype=torch.bool, device=seg.device)
    flags[perm] = keep_sorted
    return torch.nonzero(flags).squeeze(1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _c_fns():
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    keys = lib.arroyo_topk_keys
    keys.argtypes = [p, p, i, p, p, p, p]
    keys.restype = i
    pass_ = lib.arroyo_topk_pass
    pass_.argtypes = [p, p, i, i, p, i, p, p, p]
    pass_.restype = i
    select = lib.arroyo_topk_select
    select.argtypes = [p, p, i, i, p, p, p, p]
    select.restype = i
    gather = lib.arroyo_topk_gather
    gather.argtypes = [p, i, p, p, p]
    gather.restype = i
    return keys, pass_, select, gather


def _digits(mask: int, width: int) -> list:
    """Bit shifts of the 8-bit digits of a ``width``-bit mask that vary."""
    return [s for s in range(0, width, 8) if (mask >> s) & 0xFF]


def segment_top_k(seg: torch.Tensor, val: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """Kept row indices i32[m], ascending, for dense segment ids ``seg``
    i32[n] (>= 0) and values ``val`` f64[n]: the rows ranked below ``k``
    in their segment by ``val`` descending, ties by index.  Reading the
    varying digits and the kept total are the call's two host syncs."""
    n = _check(seg, val, k)
    dev = seg.device
    if dev.type == "cpu":
        return segment_top_k_reference(seg, val, k)
    if dev.type != "cuda":
        raise ValueError(f"segment_top_k: unsupported device {dev}")
    if n == 0 or k == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    k = min(k, n)  # every row of a segment of n rows ranks below n
    keys_fn, pass_fn, select_fn, gather_fn = _c_fns()
    key = torch.empty(n, dtype=torch.int64, device=dev)
    idx = torch.empty((2, n), dtype=torch.int32, device=dev)
    masks = torch.zeros(2, dtype=torch.int64, device=dev)
    ntiles = -(-n // TILE)
    hist = torch.empty(2 * 256 * ntiles + 1, dtype=torch.int32, device=dev)
    nblocks = -(-n // THREADS)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    scan = torch.empty(2 * nblocks + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(keys_fn(val.data_ptr(), seg.data_ptr(), n,
                            key.data_ptr(), idx[0].data_ptr(),
                            masks.data_ptr(), stream), "segment_top_k keys")
        m_val, m_seg = (int(x) & (2**64 - 1) for x in masks.tolist())
        passes = ([(0, s) for s in _digits(m_val, 64)]
                  + [(1, s) for s in _digits(m_seg, 32)])
        src = 0
        for use_seg, shift in passes:
            build.check(pass_fn(key.data_ptr(), seg.data_ptr(), use_seg,
                                shift, idx[src].data_ptr(), n,
                                hist.data_ptr(), idx[1 - src].data_ptr(),
                                stream), "segment_top_k pass")
            src = 1 - src
        build.check(select_fn(idx[src].data_ptr(), seg.data_ptr(), n, k,
                              flags.data_ptr(), scan.data_ptr(),
                              scan[nblocks:].data_ptr(), stream),
                    "segment_top_k select")
        kept = int(scan[2 * nblocks].item())
        out = torch.empty(kept, dtype=torch.int32, device=dev)
        build.check(gather_fn(flags.data_ptr(), n, scan[nblocks:].data_ptr(),
                              out.data_ptr(), stream),
                    "segment_top_k gather")
    segment_top_k.launches += 1
    return out


segment_top_k.launches = 0
