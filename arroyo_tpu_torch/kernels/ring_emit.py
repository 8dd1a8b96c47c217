"""K16 ``ring_emit``: the long-window pane fire — per (key slot, pane) the
trailing W-bin aggregate of each transferred channel and of the counts
plane, from one sweep over the fire's linear bin span.

Replaces arroyo_tpu/ops/keyed_bins.py:242 ``_linearize_kernel`` together
with arroyo_tpu/parallel/ring_panes.py:106 ``_ring_step_2d`` (and, at one
row, :39 ``_ring_step``): the JAX package gathers the span ``[n_ch, C,
L]`` out of the modular ring, sweeps every position of every channel and
keeps the last k panes; here one launch reads each live span cell of the
occupied rows once and writes the k panes only.

The geometry is :func:`~arroyo_tpu_torch.kernels.pane_emit.pane_emit`'s:
pane p < k covers the absolute bins ``first_bin + p + w`` (w < W), a bin
is live when ``lo <= bin <= hi`` and sits in ring column ``bin mod B``.
The span is positions j < L = k + W - 1 (bin ``first_bin + j``), dead
positions reading as each plane's identity, and:

* additive channels (sum, avg, count) and the counts plane take the
  cumsum difference ``P[p + W - 1] - P[p - 1]`` of the running sum P
  (counts in int64, then the plane's dtype: exact);
* min and max fold the pane's W positions in XLA's order (a NaN wins,
  -0.0 is below +0.0), which is total, so the CUDA kernel's grouping
  and the plain version's van Herk blocks give the same bits as the JAX
  package's.

An f64 sum differs in the last bits only where its values are not
integers, because the kernel groups its additions otherwise than the
plain version's cumsum difference (sequential on the CPU) and
``jnp.cumsum`` (neither): :func:`grouped_sums` writes the kernel's
grouping in plain PyTorch, tests/test_torch_ring_panes.py holds it to the
plain version and the JAX package within 1e-12 of a row's absolute mass,
and the card's tests hold the kernel to it bit for bit.  Integer-valued
data (every Nexmark price and count) is exact.

On the H100 it is bound by memory — each live span cell of a row read
once, (count itemsize + 8 per transferred channel) bytes written a (slot,
pane) — once few instructions are spent a cell.  The kernel
(``csrc/ring_emit.cu``) takes the panes in groups of at most W + 1 (and
512): every pane of a group holds the group's middle positions, which one
warp per (plane, slot) reduces — each lane folds the cells 32 apart,
then one butterfly — and only the head and tail parts that the panes do
not share are warp scans (none at k = 1); the loads of 10 coalesced
chunks of the middle and 2 of the head and the tail are in flight at
once.  ``tools/ring_emit_variants`` times it against a
block staging a tile of rows in shared memory, a thread a row.  A narrow
window (W <= 64, as q5's W = 5 fire on the ring) takes another form: a
thread a (slot, pane), folding its W cells in order.
:func:`ring_emit` returns ONE buffer laid out as ``pane_emit``'s
(``pane_views`` splits it); ``counts=None`` computes the channels
alone.  ``ring_emit_reference`` is
the plain PyTorch version: the linear gather, then ``torch.cumsum``
differences and van Herk's block scans over order keys (the JAX steps);
the wrapper takes it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import build
from .bin_update import _ordered, channel_identity
from .pane_emit import _xfer_spec

_NAN_KEY = {"max": torch.iinfo(torch.int64).max,
            "min": torch.iinfo(torch.int64).min}
CELLS = 512  # panes the kernel takes in one group, at most
DIRECT_W = 64  # W up to which the kernel folds each pane in a thread
LANES = 32


def _check(values: torch.Tensor, counts: Optional[torch.Tensor], W: int,
           k: int, kinds: Tuple[str, ...], xfer: Tuple[int, ...],
           rows: int) -> int:
    """The spec's address, once the arguments are ones the kernel takes."""
    if values.dtype != torch.float64 or values.dim() != 3:
        raise TypeError("values must be f64 [n_ch, C, B]")
    n_ch, C, B = values.shape
    if counts is not None:
        if counts.dtype not in (torch.int32, torch.int64) or \
                counts.shape != (C, B):
            raise TypeError("counts must be i32/i64 [C, B]")
        if counts.device != values.device:
            raise ValueError(f"tensors on several devices: {values.device}, "
                             f"{counts.device}")
        if not counts.is_contiguous():
            raise ValueError("ring_emit needs contiguous tensors")
    if len(kinds) != n_ch:
        raise ValueError(f"kinds {kinds!r} do not match {n_ch} channels")
    if W < 1 or k < 0 or not 0 <= rows <= C:
        raise ValueError(f"bad fire: W={W} k={k} rows={rows} C={C}")
    if not values.is_contiguous():
        raise ValueError("ring_emit needs contiguous tensors")
    return _xfer_spec(tuple(kinds), tuple(xfer))[1]


def _sliding_extremum(g: torch.Tensor, W: int, k: int, kind: str
                      ) -> torch.Tensor:
    """The last k width-W min or max of each row of ``g`` [rows, L], as
    ``_ring_step_2d`` computes it: the row front-padded with the identity
    to whole blocks of W, running extrema within each block from both
    ends, pane j = combine(suffix[j - W + 1], prefix[j]).  The extrema run
    on order keys (-0.0 below +0.0) with NaN as the winning key."""
    rows, L = g.shape
    nan = torch.isnan(g)
    key = torch.where(nan, _NAN_KEY[kind], _ordered(g))
    n_pad = -(-L // W) * W - L
    pad = _ordered(torch.full((rows, n_pad), channel_identity(kind),
                              dtype=torch.float64, device=g.device))
    x = torch.cat([pad, key], dim=1).view(rows, -1, W)
    scan = torch.cummax if kind == "max" else torch.cummin
    pre = scan(x, dim=2).values.view(rows, -1)
    suf = scan(x.flip(2), dim=2).values.flip(2).reshape(rows, -1)
    j = torch.arange(n_pad + L - k, n_pad + L, device=g.device)
    a, b = suf[:, j - W + 1], pre[:, j]
    out = torch.maximum(a, b) if kind == "max" else torch.minimum(a, b)
    return torch.where(out == _NAN_KEY[kind], float("nan"),
                       _ordered(out).view(torch.float64))


def _prefix_difference(g: torch.Tensor, W: int, k: int) -> torch.Tensor:
    """``P[p + W - 1] - P[p - 1]`` for p < k, P the running sum along each
    row of ``g`` [rows, L] (P[-1] = 0)."""
    c = torch.cumsum(g, dim=1)
    head = torch.cat([torch.zeros_like(c[:, :1]), c[:, :k - 1]], dim=1)
    return c[:, W - 1:W - 1 + k] - head


def ring_emit_reference(values: torch.Tensor,
                        counts: Optional[torch.Tensor], first_bin: int,
                        lo: int, hi: int, W: int, k: int,
                        kinds: Sequence[str], xfer: Sequence[int], rows: int
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version, step by step the JAX package's: gather the
    span's L = k + W - 1 positions (dead ones the identity, counts 0) for
    the first ``rows`` slots, then each plane's trailing-W sweep, kept at
    the k panes.  Returns (outs f64[n_xfer, rows, k], cnts[rows, k] or
    None)."""
    dev = values.device
    if k == 0:
        return (torch.zeros((len(xfer), rows, 0), dtype=torch.float64,
                            device=dev),
                None if counts is None else counts[:rows, :0].clone())
    L = k + W - 1
    abs_bins = first_bin + torch.arange(L, dtype=torch.int64, device=dev)
    ok = ((abs_bins >= lo) & (abs_bins <= hi))[None, :]
    cols = abs_bins % values.shape[2]
    outs = []
    for j in xfer:
        kind = kinds[j]
        g = torch.where(ok, values[j, :rows][:, cols],
                        channel_identity(kind))
        if kind in ("min", "max"):
            outs.append(_sliding_extremum(g, W, k, kind))
        else:
            outs.append(_prefix_difference(g, W, k))
    out = (torch.stack(outs) if outs else
           torch.zeros((0, rows, k), dtype=torch.float64, device=dev))
    if counts is None:
        return out, None
    cg = torch.where(ok, counts[:rows][:, cols].long(), 0)
    return out, _prefix_difference(cg, W, k).to(counts.dtype)


def grouped_sums(g: torch.Tensor, W: int, k: int) -> torch.Tensor:
    """The CUDA kernel's sums of the k panes of each row of ``g`` [rows,
    L] (f64, dead positions 0), grouped as it groups them: panes in groups
    of g' = min(W + 1, 512) from p0 = 0; pane p0 + i is (H[i] + M) + T[i]
    with M the group's middle x[p0 + g' - 1 .. p0 + W - 1] — 32 lane sums
    of the cells 32 apart, then a butterfly (xor 16, 8, 4, 2, 1) — H[i]
    the head x[p0 + i .. p0 + g' - 2] by suffix scans of 32-cell chunks
    from its end, each plus the later chunks' sum, and T[i] the tail
    x[p0 + W .. p0 + W + i - 1] by prefix scans of chunks from its start,
    each the earlier chunks' sum plus the chunk's scan (Hillis-Steele
    steps 1, 2, 4, 8, 16, as the warp's shuffles).  When W <= DIRECT_W
    each pane is the sequential sum of its W cells from 0.0."""
    rows, L = g.shape
    if W <= DIRECT_W:
        acc = g.new_zeros((rows, k))
        for w in range(W):
            acc = acc + g[:, w:w + k]
        return acc
    lanes = torch.arange(LANES, device=g.device)
    out = torch.empty((rows, k), dtype=g.dtype, device=g.device)
    gmax = min(k, W + 1, CELLS)

    def at(j, ok):  # [rows, 32]: cells at positions j, 0 where not ok
        return torch.where(ok, g[:, j.clamp(0, max(L - 1, 0))], 0.0)

    for p0 in range(0, k, gmax):
        gg = min(gmax, k - p0)
        acc = g.new_zeros((rows, LANES))
        a, b = p0 + gg - 1, p0 + W - 1
        for base in range(a, b + 1, LANES):
            acc = acc + at(base + lanes, base + lanes <= b)
        for d in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lanes ^ d]
        mid = acc[:, :1]
        cells = g.new_zeros((rows, gg))
        carry = g.new_zeros((rows, 1))
        for top in range(p0 + gg - 2, p0 - 1, -LANES):
            j = top - LANES + 1 + lanes
            ok = j >= p0
            suf = at(j, ok)
            for d in (1, 2, 4, 8, 16):
                y = suf[:, (lanes + d).clamp(max=LANES - 1)]
                suf = torch.where(lanes + d < LANES, suf + y, suf)
            suf = suf + carry
            carry = suf[:, :1]
            cells[:, j[ok] - p0] = (suf + mid)[:, ok]
        cells[:, gg - 1] = mid[:, 0]
        carry = g.new_zeros((rows, 1))
        t0, t1 = p0 + W, p0 + W + gg - 2
        for base in range(t0, t1 + 1, LANES):
            j = base + lanes
            ok = j <= t1
            pre = at(j, ok)
            for d in (1, 2, 4, 8, 16):
                y = pre[:, (lanes - d).clamp(min=0)]
                pre = torch.where(lanes >= d, y + pre, pre)
            pre = carry + pre
            carry = pre[:, LANES - 1:]
            i = j[ok] - t0 + 1
            cells[:, i] = cells[:, i] + pre[:, ok]
        out[:, p0:p0 + gg] = cells
    return out


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = build.load().arroyo_ring_emit
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, i, p, i, i, q, q, q, i, i, i, p, p]
    fn.restype = i
    return fn


def ring_emit(values: torch.Tensor, counts: Optional[torch.Tensor],
              first_bin: int, lo: int, hi: int, W: int, k: int,
              kinds: Tuple[str, ...], xfer: Tuple[int, ...], rows: int
              ) -> torch.Tensor:
    """One u8 buffer holding the fire's outputs (split by ``pane_views``
    with ``c_slice = rows``) for the panes p < k of W bins, pane p's bin w
    the absolute bin ``first_bin + p + w``, live when ``lo <= bin <= hi``
    (at most B live bins), over ``values`` f64[n_ch, C, B] and ``counts``
    i32|i64[C, B] (or None: no counts part) for the first ``rows`` slots;
    ``kinds`` names each channel's reduction (sum/avg/count add, min, max)
    and ``xfer`` the channels that are read out.  One allocation, no host
    sync."""
    spec = _check(values, counts, W, k, kinds, xfer, rows)
    n_f = 8 * len(xfer) * rows * k
    nbytes = n_f + (0 if counts is None else
                    counts.element_size() * rows * k)
    dev = values.device
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    if dev.type == "cpu":
        outs, cnts = ring_emit_reference(values, counts, first_bin, lo, hi,
                                         W, k, kinds, xfer, rows)
        buf[:n_f].view(torch.float64).copy_(outs.reshape(-1))
        if cnts is not None:
            buf[n_f:].view(counts.dtype).copy_(cnts.reshape(-1))
        return buf
    if dev.type != "cuda":
        raise ValueError(f"ring_emit: unsupported device {dev}")
    C, B = values.shape[1:]
    build.launch("ring_emit", _c_fn(), dev, values.data_ptr(),
                 None if counts is None else counts.data_ptr(),
                 int(counts is not None and counts.dtype == torch.int64),
                 spec, C, B, first_bin, lo, hi, W, k, rows, buf.data_ptr())
    ring_emit.launches += 1
    return buf


ring_emit.launches = 0
