"""The sharded data plane: co-located device shuffles and the resharding
invariant — the port of ``arroyo_tpu.parallel.shuffle``.

The keyed mesh's route step (``mesh_window.py``) generalizes here into an
exchange any SHUFFLE edge can ride when its producer and consumers share
the process: each of the ``n`` mesh devices takes a slice of the batch,
``mesh_route`` buckets the slice by destination on that device, and
:func:`exchange` moves bucket d of every slice to device d (``n**2``
device-to-device copies: the JAX package's ``all_to_all``).  The host
route (``native.partition_route``) stays the fallback, and
``ARROYO_SHUFFLE_DEVICE=off`` reproduces it.

Destinations are the host collector's (``server_for_hash``: ``min(kh //
(U64_MAX // n), n - 1)``), and each destination gets its rows in the
host route's order (stable by destination, source order within), so
device and host routes emit identical rows.

Two counters, under the JAX package's names:

* ``reshard_transfers`` (:func:`ensure_sharded`): a shard tensor found off
  its shard's device is moved and counted (Prometheus
  ``arroyo_worker_reshards_total``); 0 in steady state.  Host arrays
  staged onto a device count as ``mesh_ingest_transfers`` instead.
* ``shuffle_collectives`` / ``shuffle_collective_rows`` (Prometheus
  ``arroyo_worker_shuffle_collectives_total``): each device exchange
  that replaced a host shuffle (the mesh state's routes count too);
  ``shuffle_host_routes`` each host route of a multi-destination edge.

Knobs: ``ARROYO_SHUFFLE_DEVICE=auto|on|off`` (only ``on`` engages the
exchange, when the mesh has the destinations; ``auto`` and ``off`` take
the host route, see :func:`device_shuffle_enabled`) and ``ARROYO_MESH``
(``mesh_window.mesh_key_shards``)."""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import on_device, to_device, to_host
from ..kernels.mesh_route import RULE_SHUFFLE, mesh_route, route_views
from ..obs import perf, profiler
from ..types import Batch

RESHARDS = "reshard_transfers"
COLLECTIVES = "shuffle_collectives"
COLLECTIVE_ROWS = "shuffle_collective_rows"
HOST_ROUTES = "shuffle_host_routes"
INGEST_TRANSFERS = "mesh_ingest_transfers"

_MIN_ROWS = 256  # per-slice row floor (power-of-two bucketed)


def _bucket(n: int, floor: int = _MIN_ROWS) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def device_shuffle_enabled(n_dests: int,
                           devices: Sequence[torch.device]) -> bool:
    """Should an ``n_dests``-way co-located SHUFFLE edge ride the device
    exchange over the mesh ``devices``?  Only under ``on``, and with a
    power-of-two fan-out the mesh covers.  ``auto`` (the default) takes
    the host route: the edge's input and output are host batches, so the
    exchange adds two transfers to the host route's work and has won no
    measured run (PERF.md section 7)."""
    mode = os.environ.get("ARROYO_SHUFFLE_DEVICE", "auto").lower()
    if mode != "on":
        return False
    if n_dests < 2 or n_dests & (n_dests - 1):
        return False
    from .mesh_window import mesh_key_shards

    return mesh_key_shards(devices) >= n_dests


def partition_device(p: int, devices: Sequence[torch.device]
                     ) -> Optional[torch.device]:
    """The mesh device that holds join-state partition ``p``'s ring
    (round robin over the key shards), or None when the mesh is off:
    rings then stay on the buffer's device."""
    from .mesh_window import mesh_key_shards

    nk = mesh_key_shards(devices)
    if nk <= 1:
        return None
    return devices[p % nk]


def shuffle_stats() -> Dict[str, int]:
    """Process-wide sharded-data-plane counters (tests read deltas)."""
    return {
        "reshards": perf.counter(RESHARDS),
        "collectives": perf.counter(COLLECTIVES),
        "collective_rows": perf.counter(COLLECTIVE_ROWS),
        "host_routes": perf.counter(HOST_ROUTES),
        "ingest_transfers": perf.counter(INGEST_TRANSFERS),
    }


# -- resharding invariant ------------------------------------------------------


def ensure_sharded(t: Any, device: torch.device,
                   op_id: str = "__mesh__") -> torch.Tensor:
    """``t`` on ``device``: a tensor already there passes through (the
    steady state); one elsewhere is an implicit reshard — moved, counted
    (``reshard_transfers``, ``arroyo_worker_reshards_total``) and charged
    to the profiler's ``reshard`` phase; a host array is ingest staging,
    counted as ``mesh_ingest_transfers``."""
    if not isinstance(t, torch.Tensor):
        return stage(np.asarray(t), device)
    if t.device == device:
        return t
    perf.count(RESHARDS)
    from ..obs.metrics import reshard_counter

    reshard_counter().inc()
    prof = profiler.active()
    frame = prof.begin(op_id, "reshard") if prof is not None else None
    try:
        with on_device(device):
            return t.to(device)
    finally:
        if frame is not None:
            prof.end(frame)


def stage(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on a mesh device (one upload, non-blocking from
    pinned memory on a card), counted as ``mesh_ingest_transfers``."""
    perf.count(INGEST_TRANSFERS)
    return to_device(np.ascontiguousarray(arr), device)


def exchange(routes: List[torch.Tensor],
             devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The all_to_all: ``routes[s]`` holds source s's buckets i64[F, nk,
    N] on ``devices[s]``; returns, for each destination d, i64[F, nk, N]
    on ``devices[d]`` whose block s is source s's bucket d — nk**2
    copies, none through the host."""
    nk = len(devices)
    F, _, N = routes[0].shape
    out = []
    for d, dev in enumerate(devices):
        with on_device(dev):
            inc = torch.empty((F, nk, N), dtype=torch.int64, device=dev)
            for s in range(nk):
                inc[:, s].copy_(routes[s][:, d])
        out.append(inc)
    return out


# -- co-located device shuffle ---------------------------------------------------
#
# Payload: one i64 buffer a source slice — the key row and a validity row
# (mesh_route's), the float columns as f64 bits (f32 round-trips through
# f64), then the i-stack of the JAX package (slot 0 the timestamp, slot 1
# the key hash's bits, then ints and bools).  Object (string) columns
# cannot ride; such an edge falls back to the host route, sticky, so its
# output sharding spec never flips (the sanitizer's stability invariant).

_F_KINDS = "f"


def _to_i64(v: np.ndarray) -> np.ndarray:
    if v.dtype == np.uint64:
        return v.view(np.int64)  # bit-preserving
    if v.dtype == np.int64:
        return v
    return v.astype(np.int64)


def _from_i64(v: np.ndarray, dtype: np.dtype) -> np.ndarray:
    if dtype == np.uint64:
        return v.view(np.uint64)
    if dtype == np.bool_:
        return v != 0
    return v.astype(dtype)


class DeviceShuffle:
    """Route keyed batches to ``n`` co-located destinations with one
    device exchange a batch over the first ``n`` mesh ``devices``.
    ``route`` returns the non-empty (destination, sub-batch) pairs, or
    None when the edge cannot ride the device (non-numeric columns,
    sticky): the caller then takes the host route."""

    def __init__(self, n: int, devices: Sequence[torch.device],
                 op_id: str = ""):
        if len(devices) < n:
            raise ValueError(f"{n} destinations over {len(devices)} "
                             "devices")
        self.n = n
        self.devices = list(devices[:n])
        self.op_id = op_id
        self._disabled = False  # sticky host fallback (sharding-stable)

    def _plan(self, batch: Batch
              ) -> Optional[List[Tuple[str, str, Any, int]]]:
        """(name, stack, dtype, index) per column, or None if a column
        cannot ride the device transport."""
        plan: List[Tuple[str, str, Any, int]] = []
        nf = 0
        ni = 2  # i-stack slots 0/1: timestamp, key hash bits
        for name, v in batch.columns.items():
            k = v.dtype.kind
            if k in _F_KINDS:
                plan.append((name, "f", v.dtype, nf))
                nf += 1
            elif k in "iub":
                plan.append((name, "i", v.dtype, ni))
                ni += 1
            else:
                return None
        return plan

    def _stacks(self, batch: Batch, plan, N: int
               ) -> Tuple[np.ndarray, int, int]:
        """(rows i64[2 + nf + ni, n * N], nf, ni): the transport of
        ``batch`` padded to ``n`` slices of ``N``."""
        m = len(batch)
        nf = sum(1 for _c, s, _d, _i in plan if s == "f")
        ni = 2 + sum(1 for _c, s, _d, _i in plan if s == "i")
        rows = np.zeros((2 + nf + ni, self.n * N), np.int64)
        kh = _to_i64(batch.key_hash)
        rows[0] = -1
        rows[0, :m] = kh
        rows[1, :m] = 1
        fv = rows[2:2 + nf].view(np.float64)
        iv = rows[2 + nf:]
        iv[0, :m] = batch.timestamp
        iv[1, :m] = kh
        for name, stack, _dt, idx in plan:
            if stack == "f":
                fv[idx, :m] = batch.columns[name]
            else:
                iv[idx, :m] = _to_i64(batch.columns[name])
        return rows, nf, ni

    def exchange_rows(self, rows: np.ndarray, N: int) -> List[np.ndarray]:
        """Route and exchange the transport ``rows``; each destination's
        rows i64[F, n * N] on the host (block s: source slice s)."""
        nk, F = self.n, rows.shape[0]
        routes = []
        for s, dev in enumerate(self.devices):
            with on_device(dev):
                part = stage(rows[:, s * N:(s + 1) * N], dev)
                routes.append(route_views(mesh_route(part, nk, RULE_SHUFFLE),
                                          F, nk, N)[0])
        incoming = exchange(routes, self.devices)
        out = []
        for d, dev in enumerate(self.devices):
            with on_device(dev):
                out.append(to_host(incoming[d]).reshape(F, nk * N))
        return out

    def route(self, batch: Batch) -> Optional[List[Tuple[int, Batch]]]:
        if self._disabled or batch.key_hash is None:
            return None
        plan = self._plan(batch)
        if plan is None:
            self._disabled = True  # sticky: the edge's spec must not flip
            return None
        nk = self.n
        m = len(batch)
        N = _bucket(-(-m // nk))
        rows, nf, ni = self._stacks(batch, plan, N)
        prof = profiler.active()
        frame = (prof.begin(self.op_id, "shuffle_collective")
                 if prof is not None else None)
        try:
            per_dest = perf.timed_device(self.exchange_rows, rows, N)
        finally:
            if frame is not None:
                prof.end(frame)
        perf.count(COLLECTIVES)
        perf.count(COLLECTIVE_ROWS, m)
        # the device-memory ledger (obs/latency.py): the staged stacks are
        # the shuffle's transient device footprint for this batch
        perf.note("shuffle_stack_bytes", int(rows.nbytes))
        from ..obs.metrics import shuffle_collective_counter

        shuffle_collective_counter().inc()

        parts: List[Tuple[int, Batch]] = []
        for d, got in enumerate(per_dest):
            sel = got[1] != 0
            if not sel.any():
                continue
            idxs = np.nonzero(sel)[0]
            f_h = got[2:2 + nf].view(np.float64)
            i_h = got[2 + nf:]
            cols: Dict[str, np.ndarray] = {}
            for name, stack, dt, idx in plan:
                if stack == "f":
                    col = f_h[idx][idxs]
                    cols[name] = (col if dt == np.float64
                                  else col.astype(dt))
                else:
                    cols[name] = _from_i64(i_h[idx][idxs], dt)
            sub = Batch(i_h[0][idxs], cols,
                        _from_i64(i_h[1][idxs], np.dtype(np.uint64)),
                        batch.key_cols, lat_stamp=batch.lat_stamp)
            parts.append((d, sub))
        return parts
