"""K2 ``argmax_fire``: candidate-only pane emission — the (key, pane)
cells whose pane count equals their pane's extremum, compacted in
row-major ``[C, kpad]`` order.

Replaces arroyo_tpu/ops/keyed_bins.py:157 ``_argmax_nnz_kernel`` and
:180 ``_argmax_gather_kernel``.

On the H100 it is bound by memory (C * kpad * W count reads plus the
C * kpad pane-count write and re-read, ~2.6 MB for a one-pane fire at
C = 131072) and in practice by its launches and the one host sync.  The
CUDA kernels (``csrc/argmax_fire.cu``) make four launches and one scalar
readback per fire — the same single sync the JAX version makes — and
write candidates at scanned offsets plus ballot ranks, so the order is
exactly ``jnp.nonzero``'s.

``argmax_fire_reference`` is the plain PyTorch version; the wrapper takes
it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

THREADS = 256  # block size of the count/gather kernels (argmax_fire.cu)


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


@functools.lru_cache(maxsize=None)
def _c_fns():
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    count = lib.arroyo_argmax_count
    count.argtypes = [p, i, p, p, i, i, i, i, i, p, p, p, p, p]
    count.restype = i
    gather = lib.arroyo_argmax_gather
    gather.argtypes = [p, i, p, i, i, p, i, p, p, p]
    gather.restype = i
    return count, gather


def argmax_fire(counts: torch.Tensor, ring: torch.Tensor,
                bin_ok: torch.Tensor, minmax: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx2 i32[2, nnz] = (key_idx, pane_idx) rows, counts[nnz]) for the
    candidate cells of ``counts`` i32|i64[C, B] under the pane ring
    ``ring`` i32[kpad, W] / ``bin_ok`` bool[kpad, W]; ``minmax`` is 'max'
    or 'min'.  Outputs lie on the input device; reading the candidate
    total is the call's one host sync."""
    C, B, kpad, W = _check(counts, ring, bin_ok, minmax)
    dev = counts.device
    if dev.type == "cpu":
        return argmax_fire_reference(counts, ring, bin_ok, minmax)
    if dev.type != "cuda":
        raise ValueError(f"argmax_fire: unsupported device {dev}")
    nblocks = -(-C * kpad // THREADS)
    fill = 0 if minmax == "max" else torch.iinfo(counts.dtype).max
    ext = torch.full((kpad,), fill, dtype=counts.dtype, device=dev)
    cnt = torch.empty(C * kpad, dtype=counts.dtype, device=dev)
    block_counts = torch.empty(nblocks, dtype=torch.int32, device=dev)
    offsets = torch.empty(nblocks + 1, dtype=torch.int32, device=dev)
    i64 = int(counts.dtype == torch.int64)
    count_fn, gather_fn = _c_fns()
    build.launch("argmax_fire count", count_fn, dev, counts.data_ptr(), i64,
                 ring.data_ptr(), bin_ok.data_ptr(), C, B, W, kpad,
                 int(minmax == "max"), cnt.data_ptr(), ext.data_ptr(),
                 block_counts.data_ptr(), offsets.data_ptr())
    argmax_fire.launches += 1
    nnz = int(offsets[nblocks].item())  # the one host sync
    idx2 = torch.empty((2, nnz), dtype=torch.int32, device=dev)
    out_cnt = torch.empty(nnz, dtype=counts.dtype, device=dev)
    build.launch("argmax_fire gather", gather_fn, dev, cnt.data_ptr(), i64,
                 ext.data_ptr(), C, kpad, offsets.data_ptr(), nnz,
                 idx2.data_ptr(), out_cnt.data_ptr())
    return idx2, out_cnt


argmax_fire.launches = 0
