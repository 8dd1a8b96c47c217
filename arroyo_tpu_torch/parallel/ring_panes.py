"""Trailing-window pane aggregation along the bin axis — the port of
``arroyo_tpu.parallel.ring_panes``.

A pane ending at bin t aggregates bins ``(t - W, t]``; positions whose
window starts before bin 0 aggregate only the existing prefix (the
identity fills the rest), as a stream's warm-up panes do.  Sum and count
take the difference of a running sum, min and max van Herk's block scans
(:func:`~arroyo_tpu_torch.kernels.ring_emit.ring_emit`, the kernel of
``KeyedBinState``'s ring fire: here with one channel, no counts plane, a
fully live span and a pane at every position).

The JAX package block-shards the bin axis over ``n_shards`` devices and
rebuilds each shard's window from ``ppermute`` halos of the previous
shards' bins, so the shard count changes no value beyond the association
of float sums.  The port's state lives on one device: ``n_shards`` only
checks the layout (the bin count must divide by it) and the sweep runs
whole on the input's device.  Placing blocks across several cards is
ROADMAP A.10's work."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.ring_emit import ring_emit

KINDS = ("sum", "count", "min", "max")

Bins = Union[np.ndarray, torch.Tensor]


def ring_pane_aggregate_2d(bins: Bins, width_bins: int, kind: str,
                           n_shards: int, device: DeviceLike = None) -> Bins:
    """[C, n_bins] batch form of :func:`ring_pane_aggregate`: every row's
    trailing aggregates at once.  A tensor is swept on its own device and
    the result stays there; a numpy array goes to ``device`` (None: the
    card) and comes back as numpy."""
    if kind not in KINDS:
        raise ValueError(f"ring_pane_aggregate_2d: unsupported {kind!r}")
    as_numpy = not isinstance(bins, torch.Tensor)
    if as_numpy:
        t = torch.as_tensor(np.asarray(bins, dtype=np.float64),
                            device=resolve_device(device))
    else:
        t = bins.to(torch.float64)
    C, n = t.shape
    assert n % n_shards == 0
    W = int(width_bins)
    assert W >= 1
    buf = ring_emit(t.contiguous().view(1, C, n), None, 1 - W, 0, n - 1, W,
                    n, (kind,), (0,), C)
    out = buf.view(torch.float64).view(C, n)
    return out.cpu().numpy() if as_numpy else out


def ring_pane_aggregate(bins: Bins, width_bins: int, kind: str,
                        n_shards: int, device: DeviceLike = None) -> Bins:
    """Aggregate of the trailing ``width_bins`` bins ending at every bin
    position, over a bin axis laid out in ``n_shards`` blocks.

    ``bins`` length must divide evenly by ``n_shards``; positions whose
    window starts before bin 0 aggregate only the existing prefix
    (identity-padded), matching a stream's warm-up panes.
    """
    if kind not in KINDS:
        # avg must divide by the per-pane non-null count — callers
        # combine a sum ring with a count ring instead (as keyed_bins
        # does); accepting 'avg' here would silently return sums
        raise ValueError(f"ring_pane_aggregate: unsupported kind {kind!r}")
    n = len(bins)
    assert n % n_shards == 0, "bin count must divide the shard count"
    assert width_bins >= 1
    rows = bins[None] if isinstance(bins, torch.Tensor) else \
        np.asarray(bins)[None]
    return ring_pane_aggregate_2d(rows, width_bins, kind, n_shards,
                                  device)[0]
