"""K13 ``emit_count`` and K14 ``emit_gather``: the compact pane fire —
only the live (key slot, pane) cells of a fire, in row-major order, with
their row counts and each transferred channel's pane aggregate.

Replace arroyo_tpu/ops/keyed_bins.py:198 ``_emit_count_kernel`` (pane
counts and the live total) and :213 ``_emit_compact_kernel`` (the
nonzero compaction and the channels' ``_pane_reduce`` at the live cells).

On the H100 both are bound by memory: the count call reads the fire's
count columns of the occupied slots and writes one pane count a cell;
the gather call re-reads those and, per live cell, W bins of each
transferred channel.  The CUDA kernels (``csrc/emit_compact.cu``) never
write the dense ``[channels, C, k]`` grid: channels are reduced at live
cells only (with the dense fire's reduction, ``csrc/pane_reduce.cuh``, so
the two branches' sums are bit-equal), and the outputs are sized to the
live total, read back between the two calls (one sync, as in JAX).  The
count call is one launch and one allocation (``cnt`` and ``offsets``
together): a block counts four groups of 256 cells, one thread a cell;
the last block of a superblock's 64 groups to arrive scans them and
finds the superblock's offset by a decoupled look-back, whose status
words and arrival counters sit in a persistent per-device workspace (so
never launch ``emit_count`` on two streams at once).

``emit_count_reference`` and ``emit_gather_reference`` are the plain
PyTorch versions; the wrappers take them only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from .bin_update import KIND_CODES
from .pane_emit import pane_reduce_reference

THREADS = 256  # cells per offsets group; threads of the count/gather blocks
SUPER = 64  # offsets groups a count superblock scans (csrc kSuper)
EPOCHS = 1 << 30  # look-back epochs 1 .. EPOCHS - 1, then the words reset


def _check_panes(ring: torch.Tensor, bin_ok: torch.Tensor, rows: int
                 ) -> Tuple[int, int]:
    if ring.dtype != torch.int32 or ring.dim() != 2:
        raise TypeError("ring must be i32 [k, W]")
    k, W = ring.shape
    if bin_ok.dtype != torch.bool or tuple(bin_ok.shape) != (k, W):
        raise TypeError(f"bin_ok must be bool [{k}, {W}]")
    if rows <= 0 or k == 0:
        raise ValueError(f"a fire needs rows > 0 and a pane ({rows}, {k})")
    if rows * k >= 2**31:
        raise ValueError("rows * k must stay below 2^31")
    return k, W


def _same_device_contiguous(what: str, *tensors: torch.Tensor) -> None:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous tensors")


def _nblocks(cells: int) -> int:
    return -(-cells // THREADS)


def pack_panes(ring: np.ndarray, bin_ok: np.ndarray) -> np.ndarray:
    """A fire's panes as one host byte buffer (one upload): ``ring`` i32
    [k, W], then ``bin_ok`` bool [k, W]."""
    return np.concatenate([np.ascontiguousarray(ring, dtype=np.int32)
                           .reshape(-1).view(np.uint8),
                           np.ascontiguousarray(bin_ok, dtype=bool)
                           .reshape(-1).view(np.uint8)])


def panes_views(buf: torch.Tensor, k: int, W: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ring i32[k, W], bin_ok bool[k, W]) views of :func:`pack_panes`'s
    buffer as a u8 tensor."""
    n = k * W
    return (buf[:4 * n].view(torch.int32).view(k, W),
            buf[4 * n:5 * n].view(torch.bool).view(k, W))


class _Workspace:
    """A device's look-back state for the count kernel
    (``csrc/emit_compact.cu``): a status word and an arrival counter a
    superblock of 64 groups, zero when made and grown.  The counters
    return to zero at the end of every call; each call takes the next
    epoch, and the status words are zeroed again only when the epochs
    wrap."""

    def __init__(self):
        self.status: Optional[torch.Tensor] = None
        self.arrived: Optional[torch.Tensor] = None
        self.epoch = 0

    def take(self, supers: int, dev: torch.device
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        if self.status is None or self.status.numel() < supers:
            n = max(supers, 1024)
            self.status = torch.zeros(n, dtype=torch.int64, device=dev)
            self.arrived = torch.zeros(n, dtype=torch.int32, device=dev)
        self.epoch += 1
        if self.epoch == EPOCHS:
            self.status.zero_()
            self.epoch = 1
        return self.status, self.arrived, self.epoch


_workspaces: Dict[int, _Workspace] = {}


def emit_count_reference(counts: torch.Tensor, ring: torch.Tensor,
                         bin_ok: torch.Tensor, rows: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the masked gather-sum of the pane counts,
    then live cells per block of 256 and their exclusive prefix sum."""
    k = ring.shape[0]
    g = counts[:rows][:, ring.long()]  # [rows, k, W]
    cnt = torch.where(bin_ok[None], g, 0).sum(-1, dtype=counts.dtype)
    live = (cnt.reshape(-1) > 0).to(torch.int32)
    nb = _nblocks(rows * k)
    per_block = torch.zeros(nb * THREADS, dtype=torch.int32,
                            device=counts.device)
    per_block[:rows * k] = live
    offsets = torch.zeros(nb + 1, dtype=torch.int32, device=counts.device)
    offsets[1:] = torch.cumsum(per_block.reshape(nb, THREADS).sum(1), 0)
    return cnt, offsets


def emit_gather_reference(values: torch.Tensor, cnt: torch.Tensor,
                          ring: torch.Tensor, bin_ok: torch.Tensor,
                          kinds: Sequence[str], xfer: Sequence[int],
                          offsets: torch.Tensor, nnz: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain PyTorch version: ``nonzero`` of the pane counts, then the
    dense fire's channel reduction read at the live cells."""
    rows, k = cnt.shape
    flat = torch.nonzero(cnt.reshape(-1) > 0).squeeze(1)
    idx2 = torch.stack([(flat // k).to(torch.int32),
                        (flat % k).to(torch.int32)])
    zero = torch.zeros((rows, values.shape[2]), dtype=cnt.dtype,
                       device=cnt.device)
    outs, _ = pane_reduce_reference(values, zero, ring, bin_ok, kinds, xfer,
                                    rows)
    return (idx2, cnt.reshape(-1)[flat],
            outs.reshape(len(xfer), rows * k)[:, flat])


@functools.lru_cache(maxsize=None)
def _c_fns():
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    count = lib.arroyo_emit_count
    count.argtypes = [p, i, p, p, i, i, i, i, p, p, p, p, ctypes.c_uint, p]
    count.restype = i
    gather = lib.arroyo_emit_gather
    gather.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, i, p, i, p, p, p,
                       p]
    gather.restype = i
    return count, gather


def emit_count(counts: torch.Tensor, ring: torch.Tensor, bin_ok: torch.Tensor,
               rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cnt[rows, k] in the counts dtype, offsets i32[nblocks + 1]) for the
    panes ``ring`` i32[k, W] / ``bin_ok`` bool[k, W] over the first
    ``rows`` slots of ``counts`` i32|i64[C, B]: the pane counts and, per
    block of 256 cells in row-major order, where its live cells start;
    ``offsets[-1]`` is the live total."""
    if counts.dtype not in (torch.int32, torch.int64) or counts.dim() != 2:
        raise TypeError("counts must be i32/i64 [C, B]")
    C, B = counts.shape
    k, W = _check_panes(ring, bin_ok, rows)
    if rows > C:
        raise ValueError(f"rows {rows} beyond the {C} slots")
    _same_device_contiguous("emit_count", counts, ring, bin_ok)
    dev = counts.device
    if dev.type == "cpu":
        return emit_count_reference(counts, ring, bin_ok, rows)
    if dev.type != "cuda":
        raise ValueError(f"emit_count: unsupported device {dev}")
    nb = _nblocks(rows * k)
    # one allocation: cnt's words, then offsets
    words = rows * k * (counts.element_size() // 4)
    buf = torch.empty(words + nb + 1, dtype=torch.int32, device=dev)
    cnt = buf[:words]
    if counts.dtype == torch.int64:
        cnt = cnt.view(torch.int64)
    ws = _workspaces.get(dev.index)
    if ws is None:
        ws = _workspaces[dev.index] = _Workspace()
    status, arrived, epoch = ws.take(-(-nb // SUPER), dev)
    base = buf.data_ptr()
    build.launch("emit_count", _c_fns()[0], dev, counts.data_ptr(),
                 int(counts.dtype == torch.int64), ring.data_ptr(),
                 bin_ok.data_ptr(), B, W, k, rows, base, base + 4 * words,
                 status.data_ptr(), arrived.data_ptr(), epoch)
    emit_count.launches += 1
    return cnt.view(rows, k), buf[words:]


def emit_gather(values: torch.Tensor, cnt: torch.Tensor, ring: torch.Tensor,
                bin_ok: torch.Tensor, kinds: Sequence[str],
                xfer: Sequence[int], offsets: torch.Tensor, nnz: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx2 i32[2, nnz] = (key slot, pane) rows, counts[nnz],
    outs f64[len(xfer), nnz]) for the ``nnz`` live cells of ``cnt`` (from
    :func:`emit_count`, with its ``offsets``), in row-major order; each
    transferred channel ``xfer`` of ``values`` f64[n_ch, C, B] is reduced
    by its kind (sum/avg/count add, min, max) over the pane's bins."""
    if values.dtype != torch.float64 or values.dim() != 3:
        raise TypeError("values must be f64 [n_ch, C, B]")
    n_ch, C, B = values.shape
    if cnt.dtype not in (torch.int32, torch.int64) or cnt.dim() != 2:
        raise TypeError("cnt must be i32/i64 [rows, k]")
    rows, k = cnt.shape
    if _check_panes(ring, bin_ok, rows)[0] != k or rows > C:
        raise ValueError(f"cnt [{rows}, {k}] does not fit ring "
                         f"{tuple(ring.shape)} and {C} slots")
    if len(kinds) != n_ch or any(x not in KIND_CODES for x in kinds):
        raise ValueError(f"kinds {kinds!r} do not match {n_ch} channels")
    if any(not 0 <= j < n_ch for j in xfer):
        raise ValueError(f"xfer channels {xfer!r} outside {n_ch} channels")
    if offsets.dtype != torch.int32 or offsets.shape[0] != \
            _nblocks(rows * k) + 1:
        raise TypeError("offsets must be emit_count's i32 [nblocks + 1]")
    _same_device_contiguous("emit_gather", values, cnt, ring, bin_ok,
                            offsets)
    dev = values.device
    if dev.type == "cpu":
        return emit_gather_reference(values, cnt, ring, bin_ok, kinds, xfer,
                                     offsets, nnz)
    if dev.type != "cuda":
        raise ValueError(f"emit_gather: unsupported device {dev}")
    idx2 = torch.empty((2, nnz), dtype=torch.int32, device=dev)
    out_cnt = torch.empty(nnz, dtype=cnt.dtype, device=dev)
    outs = torch.empty((len(xfer), nnz), dtype=torch.float64, device=dev)
    chans = np.asarray(list(xfer), dtype=np.int32)
    codes = np.asarray([KIND_CODES[kinds[j]] for j in xfer], dtype=np.int32)
    build.launch("emit_gather", _c_fns()[1], dev, values.data_ptr(),
                 cnt.data_ptr(), int(cnt.dtype == torch.int64),
                 ring.data_ptr(), bin_ok.data_ptr(), chans.ctypes.data,
                 codes.ctypes.data, len(xfer), C, B, ring.shape[1], k, rows,
                 offsets.data_ptr(), nnz, idx2.data_ptr(), out_cnt.data_ptr(),
                 outs.data_ptr())
    emit_gather.launches += 1
    return idx2, out_cnt, outs


emit_count.launches = 0
emit_gather.launches = 0
