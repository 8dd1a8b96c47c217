"""Host helpers of the windowing hot path: the numpy versions of
``arroyo_tpu.native`` (window-bin assignment, key-hash combination and
shuffle routing).

The JAX package binds the same functions to a C++ library
(``native/src/host_ops.cpp``) when one builds; that library is not part
of the port yet, so ``HAVE_NATIVE`` is False and these numpy versions —
the ones ``tests/test_native.py`` holds the C++ library against — are
the only path: cell pre-aggregation is ``ops.keyed_bins.preaggregate``
and key directories use the sorted-array path."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..types import hash_u64, server_for_hash_array

HAVE_NATIVE = False


def hash_combine(acc: np.ndarray, h: np.ndarray) -> np.ndarray:
    """acc = splitmix64(acc * 31 + h), elementwise, on a copy."""
    a = np.ascontiguousarray(acc, dtype=np.uint64).copy()
    hs = np.ascontiguousarray(h, dtype=np.uint64)
    with np.errstate(over="ignore"):
        return hash_u64(a * np.uint64(31) + hs)


def partition_route(key_hash: np.ndarray, n_parts: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dest[n] i32, order[n] i64 stable by dest, bounds[n_parts+1] i64):
    ``order[bounds[p]:bounds[p+1]]`` are the rows destined for shard p."""
    kh = np.ascontiguousarray(key_hash, dtype=np.uint64)
    dest = server_for_hash_array(kh, n_parts).astype(np.int32)
    order = np.argsort(dest, kind="stable").astype(np.int64)
    bounds = np.searchsorted(
        dest[order], np.arange(n_parts + 1)).astype(np.int64)
    return dest, order, bounds


def assign_bins(ts: np.ndarray, slide: int, ring: int,
                threshold: Optional[int]
                ) -> Tuple[np.ndarray, np.ndarray, int, Optional[int],
                           Optional[int]]:
    """Window-bin assignment + liveness: (bins i32, live bool, n_live,
    abs_min, abs_max) where abs_* cover live rows only."""
    t = np.ascontiguousarray(ts, dtype=np.int64)
    thr = -(2**63) if threshold is None else int(threshold)
    abs_bins = t // slide
    live = abs_bins >= thr
    bins = (abs_bins % ring).astype(np.int32)
    n_live = int(live.sum())
    if n_live:
        lo = int(abs_bins[live].min())
        hi = int(abs_bins[live].max())
    else:
        lo = hi = None
    return bins, live, n_live, lo, hi
