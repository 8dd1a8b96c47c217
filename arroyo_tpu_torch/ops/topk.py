"""Segment top-k: the TopN hot path (port of ``arroyo_tpu.ops.topk``).

The whole (partition, window) top-k of a batch is one device call:
rows are ranked by (segment, -value, row index) and kept while their
rank inside their segment is below k — ties keep row order, as the host
lexsort of the small-batch path does.  Segment ids are dense i32 codes
of the partition column, computed on the host (``np.unique`` +
``searchsorted``) as in the JAX package.

The JAX package pads rows to power-of-two buckets (with a sentinel
segment) to bound XLA recompiles and sorts the kept indices on the
host; the kernel takes the exact row count and returns the kept indices
already in ascending order."""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.segment_top_k import segment_top_k as _segment_top_k
from ..obs import perf


def segment_top_k(part: np.ndarray, values: np.ndarray, k: int,
                  device: DeviceLike = None) -> np.ndarray:
    """Row indices (ascending) of the top ``k`` rows by ``values``
    (descending) within each ``part`` group, computed on ``device``."""
    dev = resolve_device(device)
    uniq = np.unique(part)
    seg = np.searchsorted(uniq, part).astype(np.int32)
    val = np.asarray(values, dtype=np.float64)
    out = perf.timed_device(_segment_top_k, torch.tensor(seg, device=dev),
                            torch.tensor(val, device=dev), k)
    return out.cpu().numpy()
