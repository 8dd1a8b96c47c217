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
the two branches' sums are bit-equal), and the gather's output is sized
to the live total, read between the two calls (one sync, as in JAX).
The count call is one launch and one allocation (``cnt`` and
``offsets`` together): a block counts four groups of 256 cells, one
thread a cell; the last block of a superblock's 64 groups to arrive
scans them and finds the superblock's offset by a decoupled look-back,
whose status words and arrival counters sit in a persistent per-device
workspace (so never launch ``emit_count`` on two streams at once).  The
gather call, :func:`emit_gather_buffer`, is one launch into ONE buffer
(:func:`compact_layout`: the key row, the pane row, the counts, the
transferred channels; :func:`compact_views` splits it, on the card or
after one readback): a warp a 256-cell group, skipped when its offsets
hold no live cell, 16-byte loads of the counts and a shuffle-scan rank;
the channels come as the state's :class:`~.bin_update.ChannelPlan`,
built once, not as per-call arrays.

``emit_count_reference``, ``emit_gather_reference`` and
``emit_gather_buffer_reference`` are the plain PyTorch versions; the
wrappers take them only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from .bin_update import KIND_CODES, Array, ChannelPlan, channel_plan
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
    u64 = ctypes.c_ulonglong
    gather.argtypes = [p, p, i, p, p, i, u64, u64, u64, i, i, i, i, i, p, i,
                       p, p]
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


def compact_layout(nnz: int, n_xfer: int, itemsize: int
                   ) -> Tuple[int, int, int]:
    """(first word of the counts, first word of the channels, i32 words)
    of an :func:`emit_gather_buffer` of ``nnz`` cells: the key row, the
    pane row, the counts (``itemsize`` bytes each), then, from an even
    word, the ``n_xfer`` channels f64[n_xfer, nnz]."""
    cnt_word = 2 * nnz
    ch_word = cnt_word + nnz * itemsize // 4
    ch_word += ch_word & 1
    return cnt_word, ch_word, ch_word + 2 * n_xfer * nnz


def compact_views(buf: Array, nnz: int, n_xfer: int, count_dtype
                  ) -> Tuple[Array, Array, Array, Array]:
    """(key i32[nnz], pane i32[nnz], counts[nnz], outs f64[n_xfer, nnz])
    viewing an :func:`emit_gather_buffer` (a tensor, or its numpy copy);
    ``count_dtype`` is the counts plane's torch dtype."""
    itemsize = torch.empty(0, dtype=count_dtype).element_size()
    cnt_word, ch_word, words = compact_layout(nnz, n_xfer, itemsize)
    if isinstance(buf, torch.Tensor):
        cdt, f64 = count_dtype, torch.float64
    else:
        cdt, f64 = np.dtype(str(count_dtype).split(".")[-1]), np.float64
    return (buf[:nnz], buf[nnz:cnt_word], buf[cnt_word:cnt_word + nnz *
                                              itemsize // 4].view(cdt),
            buf[ch_word:words].view(f64).reshape(n_xfer, nnz))


def _plan_channels(plan: ChannelPlan) -> Tuple[Tuple[str, ...],
                                               Tuple[int, ...]]:
    """(reduction kind a channel, the transferred channels) of a plan."""
    kinds = tuple("min" if plan.mn >> j & 1 else
                  "max" if plan.mx >> j & 1 else "sum"
                  for j in range(plan.n_ch))
    return kinds, tuple(j for j in range(plan.n_ch) if not plan.dup >> j & 1)


def emit_gather_buffer_reference(values: torch.Tensor, cnt: torch.Tensor,
                                 ring: torch.Tensor, bin_ok: torch.Tensor,
                                 plan: ChannelPlan, offsets: torch.Tensor,
                                 nnz: int) -> torch.Tensor:
    """Plain version of :func:`emit_gather_buffer`, from
    :func:`emit_gather_reference`."""
    kinds, xfer = _plan_channels(plan)
    idx2, cc, outs = emit_gather_reference(values, cnt, ring, bin_ok, kinds,
                                           xfer, offsets, nnz)
    cnt_word, ch_word, words = compact_layout(nnz, len(xfer),
                                              cnt.element_size())
    buf = torch.zeros(words, dtype=torch.int32, device=cnt.device)
    buf[:cnt_word] = idx2.reshape(-1)
    buf[cnt_word:ch_word].view(cnt.dtype)[:nnz] = cc
    buf[ch_word:].view(torch.float64)[:] = outs.reshape(-1)
    return buf


def emit_gather_buffer(values: torch.Tensor, cnt: torch.Tensor,
                       ring: torch.Tensor, bin_ok: torch.Tensor,
                       plan: ChannelPlan, offsets: torch.Tensor, nnz: int
                       ) -> torch.Tensor:
    """The ``nnz`` live cells of ``cnt`` (from :func:`emit_count`, with its
    ``offsets``) in row-major order as ONE i32 buffer on the input device
    (:func:`compact_layout`): their (key slot, pane) rows, counts and the
    pane aggregates of the channels ``plan`` transfers (its non-``dup``
    channels of ``values`` f64[n_ch, C, B], reduced by min, max or
    addition).  One launch, no host sync."""
    if values.dtype != torch.float64 or values.dim() != 3:
        raise TypeError("values must be f64 [n_ch, C, B]")
    n_ch, C, B = values.shape
    if cnt.dtype not in (torch.int32, torch.int64) or cnt.dim() != 2:
        raise TypeError("cnt must be i32/i64 [rows, k]")
    rows, k = cnt.shape
    if _check_panes(ring, bin_ok, rows)[0] != k or rows > C:
        raise ValueError(f"cnt [{rows}, {k}] does not fit ring "
                         f"{tuple(ring.shape)} and {C} slots")
    if plan.n_ch != n_ch:
        raise ValueError(f"a plan of {plan.n_ch} channels for {n_ch}")
    if offsets.dtype != torch.int32 or offsets.shape[0] != \
            _nblocks(rows * k) + 1:
        raise TypeError("offsets must be emit_count's i32 [nblocks + 1]")
    if nnz < 0:
        raise ValueError(f"nnz {nnz}")
    _same_device_contiguous("emit_gather", values, cnt, ring, bin_ok,
                            offsets)
    dev = values.device
    if dev.type == "cpu":
        return emit_gather_buffer_reference(values, cnt, ring, bin_ok, plan,
                                            offsets, nnz)
    if dev.type != "cuda":
        raise ValueError(f"emit_gather: unsupported device {dev}")
    if cnt.data_ptr() % 16:
        raise ValueError("emit_gather reads cnt in 16-byte loads: it must "
                         "start on 16 bytes (emit_count's does)")
    _c, _x, words = compact_layout(nnz, plan.n_xfer, cnt.element_size())
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    if nnz == 0:
        return buf
    build.launch("emit_gather", _c_fns()[1], dev, values.data_ptr(),
                 cnt.data_ptr(), int(cnt.dtype == torch.int64),
                 ring.data_ptr(), bin_ok.data_ptr(), n_ch, plan.dup, plan.mn,
                 plan.mx, C, B, ring.shape[1], k, rows, offsets.data_ptr(),
                 nnz, buf.data_ptr())
    emit_gather.launches += 1
    return buf


def emit_gather(values: torch.Tensor, cnt: torch.Tensor, ring: torch.Tensor,
                bin_ok: torch.Tensor, kinds: Sequence[str],
                xfer: Sequence[int], offsets: torch.Tensor, nnz: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx2 i32[2, nnz] = (key slot, pane) rows, counts[nnz],
    outs f64[len(xfer), nnz]) for the ``nnz`` live cells of ``cnt``: the
    views of :func:`emit_gather_buffer` with the plan that transfers the
    channels ``xfer`` (ascending) of ``values`` f64[n_ch, C, B], each
    reduced by its kind (sum/avg/count add, min, max)."""
    n_ch = values.shape[0] if values.dim() == 3 else -1
    if len(kinds) != n_ch or any(x not in KIND_CODES for x in kinds):
        raise ValueError(f"kinds {kinds!r} do not match {n_ch} channels")
    if any(not 0 <= j < n_ch for j in xfer) or \
            list(xfer) != sorted(set(xfer)):
        raise ValueError(f"xfer channels {xfer!r}: ascending, within "
                         f"{n_ch} channels")
    plan = channel_plan(kinds, [j for j in range(n_ch) if j not in xfer])
    buf = emit_gather_buffer(values, cnt, ring, bin_ok, plan, offsets, nnz)
    _key, _pane, cc, outs = compact_views(buf, nnz, len(xfer), cnt.dtype)
    return buf[:2 * nnz].view(2, nnz), cc, outs


emit_count.launches = 0
emit_gather.launches = 0
