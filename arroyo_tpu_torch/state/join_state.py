"""Partition-adaptive join state — the port of
``arroyo_tpu.state.join_state`` for window joins and joins with
expiration.

* each side's rows hash-partition by the low bits of ``key_hash``;
* each partition keeps its rows in arrival order plus an **incrementally
  maintained sorted run**: an arriving delta is sorted alone and merged
  into the resident run positionally — never a full re-sort;
* TTL eviction is a **valid-range advance**; dead rows are compacted
  only when they outnumber live rows;
* **hot partitions** (EWMA of rows per operation, with hysteresis) keep
  their sorted key run and payload columns on the buffer's device (or,
  with a key mesh, round robin over its devices) in a power-of-two ring (``ops/join.py``), maintained by one merge launch
  per append; window fires gather matched rows from the ring in
  one launch (``join_device_gather_rows`` vs ``join_host_gather_rows``
  count the split).  Object (string) columns flip the buffer's STICKY
  host-gather fallback.  Promotion depends only on the observed data
  sequence, so it is deterministic.

:class:`PartitionedJoinBuffer` subclasses :class:`BatchBuffer` and keeps
its ``snapshot_batch``/``restore_batch`` interface, so a checkpoint
written by either package's buffer restores in the other.

Knobs, as in the JAX package:
  ARROYO_JOIN_STATE=partitioned|legacy   state layout (default partitioned)
  ARROYO_JOIN_PARTITIONS=16              partitions per side (power of two)
  ARROYO_JOIN_HOT_PARTITIONS=4           device-resident partition budget
  ARROYO_JOIN_HOT_MIN_ROWS=4096          EWMA rows to qualify as hot

Joins with expiration probe the state with each arriving batch
(``probe_batch``): a hot partition with payload planes answers with one
``join_probe`` and one fused ``expand_gather`` launch (``probe_rows``), a
keys-only ring with ``join_probe`` + ``join_expand`` and a host verify
(``probe``), a cold partition on the host mirror.  Outer joins look keys
up with ``contains_keys`` and ``rows_with_keys`` (``probe`` + ``gather``).
Every buffer notes its ``stats()`` in the ``join_state_registry`` perf
note every 16th append, and the join with expiration once more when it
closes; ``aggregate_stats_registry`` folds the notes.

``remove_keys`` drops a set of keys (the semi join's emitted left rows).
The legacy layout (:func:`make_join_buffer` under ``ARROYO_JOIN_STATE=
legacy``) is a flat host ``BatchBuffer`` on every device, re-sorted at
each fire or arrival by ``ops/join.join_pairs``, which joins on the
operator's device.  Not ported: the Prometheus mirrors and the profiler
frames."""

from __future__ import annotations

import itertools
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, on_device, resolve_device
from ..obs import perf, profiler
from ..obs.metrics import join_gather_counter
from ..types import Batch
from .tables import BatchBuffer

_NEG_INF = np.iinfo(np.int64).min

# dtype kinds the payload planes can transport (ops/join.payload_plan);
# anything else — object/str — flips the buffer's sticky host fallback
_PAYLOAD_KINDS = "fiubMm"


def _count_gather(dev_rows: int, host_rows: int) -> None:
    """Account materialized join rows to the device/host gather split
    (perf counters and their metric mirrors)."""
    if dev_rows:
        perf.count("join_device_gather_rows", dev_rows)
        join_gather_counter("device").inc(dev_rows)
    if host_rows:
        perf.count("join_host_gather_rows", host_rows)
        join_gather_counter("host").inc(host_rows)


def _gather_frame():
    """The profiler's ``gather`` phase around a materialization, charged
    to the running task's operator, or None when the profiler is off."""
    prof = profiler.active()
    return (prof.begin(perf.active_operator_id() or "join", "gather")
            if prof is not None else None)


def _fill_cols(cols: Dict[str, np.ndarray], n: int, sel: Any,
               pcols: Dict[str, np.ndarray]) -> None:
    """Fill output rows ``sel`` from one partition's gathered columns,
    null-initializing and dtype-promoting so a partition lacking a column
    can never expose garbage."""
    for c, v in pcols.items():
        if c not in cols:
            if v.dtype == object:
                cols[c] = np.full(n, None, dtype=object)
            elif v.dtype.kind == "f":
                cols[c] = np.full(n, np.nan, dtype=v.dtype)
            else:
                cols[c] = np.zeros(n, dtype=v.dtype)
        tgt = cols[c]
        if tgt.dtype != v.dtype:
            cols[c] = tgt = tgt.astype(
                object if (tgt.dtype == object or v.dtype == object)
                else np.result_type(tgt.dtype, v.dtype))
        tgt[sel] = v


def partitioned_join_enabled() -> bool:
    return os.environ.get("ARROYO_JOIN_STATE", "partitioned") != "legacy"


def join_partitions() -> int:
    p = int(os.environ.get("ARROYO_JOIN_PARTITIONS", 16))
    # clamp to a power of two so routing is a mask
    b = 1
    while b * 2 <= max(p, 1):
        b *= 2
    return b


def _hot_budget() -> int:
    return int(os.environ.get("ARROYO_JOIN_HOT_PARTITIONS", 4))


def _hot_min_rows() -> float:
    return float(os.environ.get("ARROYO_JOIN_HOT_MIN_ROWS", 4096))


def _grow(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.empty(cap, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class _Partition:
    """One hash partition of one join side: columnar storage in arrival
    order plus an incrementally merged key-sorted run over it."""

    __slots__ = ("cols", "keys", "ts", "n", "cap", "order", "skeys", "sts",
                 "valid_from", "dead", "_evicts_since_scan", "touches", "dev",
                 "dev_device", "payload_on")

    def __init__(self) -> None:
        self.cols: Dict[str, np.ndarray] = {}
        self.keys = np.empty(0, dtype=np.uint64)
        self.ts = np.empty(0, dtype=np.int64)
        self.n = 0
        self.cap = 0
        # sorted run: order[i] = storage position of the i-th smallest key
        # (stable by arrival); skeys/sts mirror keys/ts in sorted order
        self.order = np.empty(0, dtype=np.int64)
        self.skeys = np.empty(0, dtype=np.uint64)
        self.sts = np.empty(0, dtype=np.int64)
        self.valid_from = _NEG_INF
        self.dead = 0  # estimated rows below valid_from
        self._evicts_since_scan = 0
        self.touches = 0.0  # EWMA of rows handled per operation
        # device-resident split-hash ring (ops/join.SplitRing) and the
        # device it lives on
        self.dev: Optional[Any] = None
        self.dev_device: Optional[torch.device] = None
        self.payload_on = False  # buffer policy at last promotion

    # -- storage -----------------------------------------------------------

    def _ensure_cap(self, need: int) -> None:
        if need <= self.cap:
            return
        cap = max(self.cap, 256)
        while cap < need:
            cap *= 2
        self.keys = _grow(self.keys[: self.n], cap)
        self.ts = _grow(self.ts[: self.n], cap)
        for c in list(self.cols):
            self.cols[c] = _grow(self.cols[c][: self.n], cap)
        self.cap = cap

    def _coerce_col(self, name: str, v: np.ndarray) -> np.ndarray:
        """Dtype-promote storage when a later batch widens a column."""
        cur = self.cols.get(name)
        if cur is None or cur.dtype == v.dtype:
            return v
        if cur.dtype == object or v.dtype == object:
            tgt = np.dtype(object)
        else:
            tgt = np.result_type(cur.dtype, v.dtype)
        if cur.dtype != tgt:
            self.cols[name] = self.cols[name].astype(tgt)
        return v.astype(tgt) if v.dtype != tgt else v

    def append(self, keys: np.ndarray, ts: np.ndarray,
               cols: Dict[str, np.ndarray]) -> None:
        m = len(keys)
        if m == 0:
            return
        n = self.n
        self._ensure_cap(n + m)
        self.keys[n:n + m] = keys
        self.ts[n:n + m] = ts
        for c, v in cols.items():
            if c not in self.cols:
                col = np.empty(self.cap, dtype=v.dtype)
                if n:  # column appeared late: null-fill history
                    if v.dtype == object:
                        col[:n] = None
                    elif v.dtype.kind == "f":
                        col[:n] = np.nan
                    else:
                        col = col.astype(np.float64)
                        col[:n] = np.nan
                self.cols[c] = col
            v = self._coerce_col(c, v)
            self.cols[c][n:n + m] = v
        for c in self.cols:
            if c not in cols:  # missing column: null-fill the delta
                cur = self.cols[c]
                if cur.dtype == object:
                    cur[n:n + m] = None
                else:
                    if cur.dtype.kind != "f":
                        self.cols[c] = cur = cur.astype(np.float64)
                    cur[n:n + m] = np.nan

        # incremental sorted-run maintenance: sort ONLY the delta, then
        # positionally merge against the resident run
        dorder = np.argsort(keys, kind="stable")
        dkeys = keys[dorder]
        ins = np.searchsorted(self.skeys[:n], dkeys, side="right")
        dpos = ins + np.arange(m, dtype=np.int64)
        total = n + m
        new_order = np.empty(total, dtype=np.int64)
        new_skeys = np.empty(total, dtype=np.uint64)
        new_sts = np.empty(total, dtype=np.int64)
        keep = np.ones(total, dtype=bool)
        keep[dpos] = False
        new_order[dpos] = n + dorder
        new_skeys[dpos] = dkeys
        new_sts[dpos] = ts[dorder]
        new_order[keep] = self.order[:n]
        new_skeys[keep] = self.skeys[:n]
        new_sts[keep] = self.sts[:n]
        self.order, self.skeys, self.sts = new_order, new_skeys, new_sts
        self.n = total
        perf.count("join_state_merges")
        self.touches = 0.9 * self.touches + 0.1 * m * 10  # EWMA over ops
        if self.dev is not None:
            dts = ts[dorder]
            dcols = ({c: self.cols[c][n:n + m][dorder] for c in self.cols}
                     if self.dev.plan is not None else None)
            self._device_merge(dkeys, dpos, n, dts, dcols)

    # -- device residency --------------------------------------------------

    def _device_merge(self, dkeys: np.ndarray, dpos: np.ndarray,
                      n_res: int, dts: np.ndarray,
                      dcols: Optional[Dict[str, np.ndarray]]) -> None:
        from ..ops import join as dj

        ring = self.dev
        if self.n > ring.cap:
            # ring overflow: regrow to the next power-of-two ring — the
            # restage keeps key AND payload placement in lockstep
            perf.count("join_state_ring_regrows")
            self.promote()
            return
        if self.payload_on:
            # payload plan drift (a column appeared, widened, or went
            # string): restage so the planes always mirror storage
            want = {c: v.dtype for c, v in self.cols.items()}
            want_plan = dj.payload_plan(want)
            if want_plan is not None and (
                    ring.plan is None or ring.plan_schema() != want):
                self.promote()
                return
            if want_plan is None and ring.plan is not None:
                self.promote()
                return
        with on_device(self.dev_device):
            merged = dj.merge_ring(ring, n_res, dkeys, dpos, delta_ts=dts,
                                   delta_cols=dcols)
        if merged is None:  # delta hit the top-32 sentinel: exactness
            self.demote()   # over speed — the host mirror takes over
            return
        self.dev = merged
        perf.count("join_state_device_merges")

    def promote(self, device: Optional[torch.device] = None,
                payload: Optional[bool] = None) -> None:
        """Stage this partition's sorted keys — plus, when the payload
        policy is on, its payload columns in sorted-run order — into
        power-of-two device planes (also used to regrow and to re-plan
        after schema drift; restages keep the device of the first
        promotion)."""
        from ..ops import join as dj

        if device is not None:
            self.dev_device = device
        if payload is not None:
            self.payload_on = payload
        n = self.n
        cols = None
        if self.payload_on:
            order = self.order[:n]
            cols = {c: v[:n][order] for c, v in self.cols.items()}
        with on_device(self.dev_device):
            ring = dj.stage_ring(self.skeys[:n], self.dev_device,
                                 sorted_ts=self.sts[:n], sorted_cols=cols)
        if ring is None:
            # a key's top-32 bits collide with the ring sentinel: this
            # partition stays host — exactness first
            self.dev = None
            return
        if self.dev is not None:  # a restage keeps the probes' pair capacity
            ring.pair_cap = self.dev.pair_cap
        self.dev = ring
        perf.count("join_state_promotions")

    def demote(self) -> None:
        if self.dev is not None:
            self.dev = None
            perf.count("join_state_demotions")

    # -- TTL ---------------------------------------------------------------

    def evict_before(self, t: int) -> None:
        """Valid-range advance: no data movement here.  The dead-row
        rescan is throttled to every 8th advance; compaction runs only
        when dead rows outnumber live ones."""
        if t <= self.valid_from or self.n == 0:
            return
        self.valid_from = t
        self._evicts_since_scan += 1
        if self.n >= 1024 and self._evicts_since_scan >= 8:
            self._evicts_since_scan = 0
            self.dead = int((self.sts[: self.n] < t).sum())
            if self.dead * 2 > self.n:
                self._compact()

    def _compact(self) -> None:
        live = self.ts[: self.n] >= self.valid_from
        for c in list(self.cols):
            self.cols[c] = self.cols[c][: self.n][live].copy()
        self.keys = self.keys[: self.n][live].copy()
        self.ts = self.ts[: self.n][live].copy()
        self.n = int(live.sum())
        self.cap = self.n
        # rebuild the sorted run from the compacted storage: positions
        # shifted by the cumulative dead count before them
        shift = np.cumsum(~live) if len(live) else np.zeros(0, np.int64)
        old_order = self.order[: len(live)]
        okeep = live[old_order]
        kept = old_order[okeep]
        self.order = (kept - shift[kept]).astype(np.int64)
        self.skeys = self.skeys[: len(live)][okeep].copy()
        self.sts = self.sts[: len(live)][okeep].copy()
        self.dead = 0
        perf.count("join_state_compactions")
        if self.dev is not None:
            self.promote()  # restage the compacted run

    # -- queries -----------------------------------------------------------

    def live_mask_sorted(self, start: Optional[int] = None,
                         end: Optional[int] = None) -> np.ndarray:
        sts = self.sts[: self.n]
        m = sts >= (self.valid_from if start is None
                    else max(self.valid_from, start))
        if end is not None:
            m &= sts < end
        return m

    def live_count(self) -> int:
        if self.n == 0:
            return 0
        if self.valid_from == _NEG_INF:
            return self.n
        return int((self.ts[: self.n] >= self.valid_from).sum())

    def probe(self, qkeys_sorted: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Match ranges of sorted query keys against the resident run.
        Returns (qidx, spos): for every (query row, live matching state
        row) pair, the index into ``qkeys_sorted`` and the SORTED-RUN
        position of the match (``gather`` maps it to storage or into the
        ring's payload planes)."""
        from ..ops import join as dj

        n = self.n
        z = np.zeros(0, dtype=np.int64)
        if n == 0 or len(qkeys_sorted) == 0:
            return z, z
        self.touches = 0.9 * self.touches + 0.1 * len(qkeys_sorted) * 10
        if self.dev is not None:
            with on_device(self.dev_device):
                hit = dj.probe_ring(self.dev, qkeys_sorted, n)
                qidx, sidx = dj.expand_hit(self.dev, hit)
            if not len(qidx):
                return z, z
            # full-key verify on the host mirror: the candidates are
            # top-32-equal ranges; i32-equal-but-u64-distinct rows die here
            ok = self.skeys[sidx] == qkeys_sorted[qidx]
            if not ok.all():
                qidx, sidx = qidx[ok], sidx[ok]
        else:
            skeys = self.skeys[:n]
            start = np.searchsorted(skeys, qkeys_sorted, side="left")
            end = np.searchsorted(skeys, qkeys_sorted, side="right")
            counts = end - start
            if not counts.any():
                return z, z
            qidx, offs = dj.expand_counts(counts)
            sidx = np.repeat(start, counts) + offs  # sorted-run positions
        if self.valid_from != _NEG_INF and len(sidx):
            alive = self.sts[sidx] >= self.valid_from
            qidx, sidx = qidx[alive], sidx[alive]
        return qidx, sidx

    def probe_rows(self, qkeys_sorted: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray,
                              Optional[Dict[str, np.ndarray]],
                              Optional[np.ndarray]]:
        """:meth:`probe` fused with the payload materialization: when this
        partition's payload planes are resident, the candidate expansion,
        the full-key verify AND the payload gather are one
        ``expand_gather`` launch.  Returns (qidx, spos, cols, ts); cols
        and ts are None when the caller must host-gather (a cold
        partition or a keys-only ring)."""
        from ..ops import join as dj

        ring = self.dev
        if ring is None or ring.plan is None:
            qidx, spos = self.probe(qkeys_sorted)
            return qidx, spos, None, None
        n = self.n
        z = np.zeros(0, dtype=np.int64)
        if n == 0 or len(qkeys_sorted) == 0:
            return z, z, None, None
        self.touches = 0.9 * self.touches + 0.1 * len(qkeys_sorted) * 10
        with on_device(self.dev_device):
            hit = dj.probe_ring(ring, qkeys_sorted, n)
            qidx, sidx, valid, gf, gi = dj.expand_gather(ring, hit)
        if not len(qidx):
            return z, z, None, None
        keep = valid
        if self.valid_from != _NEG_INF:
            keep = keep & (gi[0] >= self.valid_from)
        if not keep.all():
            qidx, sidx = qidx[keep], sidx[keep]
            gf, gi = gf[:, keep], gi[:, keep]
        ts, cols = dj.unpack_payload(ring, gf, gi)
        return qidx, sidx, cols, ts

    def range_view(self, start: Optional[int], end: Optional[int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(keys_sorted, sorted_run_positions) of live rows with
        start <= ts < end — mask-compress of the sorted run, which stays
        key-sorted, so fires never re-sort."""
        if self.n == 0:
            return (np.zeros(0, dtype=np.uint64),
                    np.zeros(0, dtype=np.int64))
        m = self.live_mask_sorted(start, end)
        return self.skeys[: self.n][m], np.nonzero(m)[0]


class PartitionedJoinBuffer(BatchBuffer):
    """Drop-in BatchBuffer replacement for window-join sides on ``device``
    (None means CUDA, as everywhere in the port).  With a key ``mesh`` of
    more than one shard, hot partition p's ring lives on its device p mod
    nk (``parallel/shuffle.partition_device``), as the JAX package places
    rings over its mesh."""

    def __init__(self, n_partitions: Optional[int] = None,
                 device: DeviceLike = None, mesh: Sequence[Any] = ()):
        super().__init__()
        self.device = resolve_device(device)
        self.mesh = list(mesh)
        self.P = n_partitions or join_partitions()
        self.parts = [_Partition() for _ in range(self.P)]
        self.key_cols: Tuple[str, ...] = ()
        self._schema: Dict[str, np.dtype] = {}
        self._appends = 0
        self._uid = next(_BUF_UIDS)
        # STICKY string fallback: the first object/string column flips
        # payload residency off for this buffer's whole life
        self._payload_sticky_host = False

    # -- routing -----------------------------------------------------------

    def _route(self, kh: np.ndarray) -> np.ndarray:
        return (kh & np.uint64(self.P - 1)).astype(np.int64)

    def append(self, batch: Batch) -> None:
        if not len(batch):
            return
        if batch.key_hash is None:
            raise ValueError("join state requires keyed rows")
        from ..ops.join import device_join_enabled

        if batch.key_cols:
            self.key_cols = batch.key_cols
        self._schema = {c: v.dtype for c, v in batch.columns.items()}
        if not self._payload_sticky_host and any(
                dt.kind not in _PAYLOAD_KINDS
                for dt in self._schema.values()):
            self._payload_sticky_host = True
        dest = self._route(batch.key_hash)
        order = np.argsort(dest, kind="stable")
        bounds = np.searchsorted(dest[order], np.arange(self.P + 1))
        for p in range(self.P):
            lo, hi = bounds[p], bounds[p + 1]
            if lo == hi:
                continue
            rows = order[lo:hi]
            self.parts[p].append(
                batch.key_hash[rows], batch.timestamp[rows],
                {c: v[rows] for c, v in batch.columns.items()})
        if device_join_enabled(self.device):
            self._rebalance_hot()
        elif any(pt.dev is not None for pt in self.parts):
            for pt in self.parts:
                pt.demote()
        self._appends += 1
        if self._appends % 16 == 1:
            self.note_stats()  # throttled

    def note_stats(self) -> None:
        """Note this buffer's ``stats()`` in the ``join_state_registry``
        perf note, one entry a buffer (a join has two sides); the reader
        clears the registry and folds it.  The entry also carries
        ``ring_key_bytes``, the keys-only rings' bytes (their ``hi``/``lo``
        planes), for the device-memory ledger (obs/latency.py)."""
        reg = perf.get_note("join_state_registry")
        if not isinstance(reg, dict):
            reg = {}
            perf.note("join_state_registry", reg)
        key_bytes = sum(part.dev.payload_bytes() for part in self.parts
                        if part.dev is not None and part.dev.plan is None)
        reg[self._uid] = {**self.stats(), "ring_key_bytes": key_bytes}

    def _rebalance_hot(self) -> None:
        """Deterministic hot-set maintenance: the top-``budget`` partitions
        by EWMA row frequency hold device rings, with 2x hysteresis; every
        partition's EWMA decays here so a partition that stops seeing
        rows cools below the demotion floor."""
        budget = _hot_budget()
        floor = _hot_min_rows()
        for part in self.parts:
            part.touches *= 0.98
        ranked = sorted(range(self.P),
                        key=lambda p: (-self.parts[p].touches, p))
        hot = {p for p in ranked[:budget]
               if self.parts[p].touches >= floor}
        # rank-based demotion with 2-slot hysteresis
        grace = set(ranked[: budget + 2])
        from ..parallel.shuffle import partition_device

        for p, part in enumerate(self.parts):
            if p in hot and part.dev is None:
                # round robin over the key mesh (deterministic: promotion
                # stays a function of the data); payload planes ride along
                part.promote(device=partition_device(p, self.mesh)
                             or self.device,
                             payload=not self._payload_sticky_host)
            elif part.dev is not None and p not in hot and (
                    part.touches < floor / 2 or p not in grace):
                part.demote()

    # -- BatchBuffer interface --------------------------------------------

    def evict_before(self, time: int) -> None:
        for part in self.parts:
            part.evict_before(time)

    def _materialize(self, start: Optional[int] = None,
                     end: Optional[int] = None) -> Optional[Batch]:
        parts: List[Batch] = []
        for part in self.parts:
            n = part.n
            if n == 0:
                continue
            ts = part.ts[:n]
            m = ts >= (part.valid_from if start is None
                       else max(part.valid_from, start))
            if end is not None:
                m &= ts < end
            if not m.any():
                continue
            cols = {c: v[:n][m] for c, v in part.cols.items()}
            parts.append(Batch(ts[m], cols, part.keys[:n][m],
                               self.key_cols))
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else Batch.concat(parts)

    def all(self) -> Optional[Batch]:
        return self._materialize()

    def query_range(self, start: int, end: int) -> Optional[Batch]:
        return self._materialize(start, end)

    def contains_keys(self, key_hashes: np.ndarray) -> np.ndarray:
        """Per element: does a live row carry this key hash?"""
        out = np.zeros(len(key_hashes), dtype=bool)
        if not len(key_hashes):
            return out
        sorter = np.argsort(key_hashes, kind="stable")
        qidx, _pos = self.probe_positions(key_hashes[sorter])
        if len(qidx):
            out[sorter[np.unique(qidx)]] = True
        return out

    def remove_keys(self, key_hashes: np.ndarray) -> None:
        """Drop the rows whose key hash is in ``key_hashes``: each
        partition that holds one compacts to its live rows without them
        and rebuilds its sorted run (a full re-sort, counted as
        ``join_state_resorts``: key removal is the semi join's, rare); a
        hot partition restages its ring."""
        for part in self.parts:
            n = part.n
            if n == 0:
                continue
            keep = ~np.isin(part.keys[:n], key_hashes)
            if keep.all():
                continue
            live = keep & (part.ts[:n] >= part.valid_from)
            for c in list(part.cols):
                part.cols[c] = part.cols[c][:n][live].copy()
            part.keys = part.keys[:n][live].copy()
            part.ts = part.ts[:n][live].copy()
            part.n = int(live.sum())
            part.cap = part.n
            part.order = np.argsort(part.keys, kind="stable")
            part.skeys = part.keys[part.order].copy()
            part.sts = part.ts[part.order].copy()
            part.dead = 0
            perf.count("join_state_resorts")
            if part.dev is not None:
                part.promote()

    def __len__(self) -> int:
        return sum(part.live_count() for part in self.parts)

    def snapshot_batch(self) -> Optional[Batch]:
        return self._materialize()

    def restore_batch(self, batch: Optional[Batch]) -> None:
        self.parts = [_Partition() for _ in range(self.P)]
        if batch is not None and len(batch):
            if batch.key_hash is None and batch.key_cols:
                batch = batch.with_key(batch.key_cols)
            self.append(batch)

    # -- probes ------------------------------------------------------------

    def probe_positions(self, qkeys_sorted: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(qidx, encoded part << 48 | sorted-run pos) for every live match
        of the sorted query keys; used by contains_keys and
        rows_with_keys."""
        dest = self._route(qkeys_sorted)
        qi_parts: List[np.ndarray] = []
        gp_parts: List[np.ndarray] = []
        for p in range(self.P):
            sel = np.nonzero(dest == p)[0]
            if not len(sel):
                continue
            qidx, pos = self.parts[p].probe(qkeys_sorted[sel])
            if len(qidx):
                qi_parts.append(sel[qidx])
                gp_parts.append(p * (1 << 48) + pos)
        if not qi_parts:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        return np.concatenate(qi_parts), np.concatenate(gp_parts)

    def probe_batch(self, batch: Batch
                    ) -> Tuple[np.ndarray, Batch, np.ndarray]:
        """Join an arriving batch against this (opposite-side) state
        without materializing or re-sorting it: sort only the batch's
        keys and probe each partition's resident run (hot partitions with
        payload planes through :meth:`_Partition.probe_rows`' fused device
        path).  Returns ``(bsel, state_rows, counts)``: matched-pair batch
        row indices, the aligned state rows, and per-batch-row live match
        counts in batch order (for outer-join unmatched masks)."""
        kh = batch.key_hash
        nq = len(kh)
        sorter = np.argsort(kh, kind="stable")
        qk = kh[sorter]
        dest = self._route(qk)
        counts = np.zeros(nq, dtype=np.int64)
        qi_parts: List[np.ndarray] = []
        blocks: List[Tuple[_Partition, np.ndarray,
                           Optional[Dict[str, np.ndarray]],
                           Optional[np.ndarray]]] = []
        total = 0
        for p in range(self.P):
            sel = np.nonzero(dest == p)[0]
            if not len(sel) or self.parts[p].n == 0:
                continue
            qidx, spos, dcols, dts = self.parts[p].probe_rows(qk[sel])
            if not len(qidx):
                continue
            qi_parts.append(sel[qidx])
            blocks.append((self.parts[p], spos, dcols, dts))
            total += len(qidx)
        if not total:
            return np.zeros(0, dtype=np.int64), self._empty_rows(), counts
        bsel = sorter[np.concatenate(qi_parts)]
        np.add.at(counts, bsel, 1)
        return bsel, self._assemble_blocks(blocks, total), counts

    def _assemble_blocks(self, blocks, total: int) -> Batch:
        """One output batch from per-partition probe results, each block
        device- or host-gathered (the null-init and promotion rules of
        :meth:`gather`)."""
        ts = np.empty(total, dtype=np.int64)
        kh = np.empty(total, dtype=np.uint64)
        cols: Dict[str, np.ndarray] = {}
        dev_rows = host_rows = 0
        at = 0
        frame = _gather_frame()
        try:
            for part, spos, dcols, dts in blocks:
                m = len(spos)
                sel = slice(at, at + m)
                kh[sel] = part.skeys[spos]
                if dcols is not None:
                    ts[sel] = dts
                    pcols = dcols
                    dev_rows += m
                else:
                    ts[sel] = part.sts[spos]
                    rows = part.order[spos]
                    pcols = {c: v[rows] for c, v in part.cols.items()}
                    host_rows += m
                _fill_cols(cols, total, sel, pcols)
                at += m
        finally:
            if frame is not None:
                profiler.active().end(frame)
        _count_gather(dev_rows, host_rows)
        return Batch(ts, cols, kh, self.key_cols)

    def rows_with_keys(self, keys: np.ndarray) -> Batch:
        """Live rows whose key hash is in ``keys`` (each row once)."""
        ks = np.sort(np.asarray(keys, dtype=np.uint64))
        _qidx, gpos = self.probe_positions(ks)
        return self.gather(gpos)

    # -- window fires ------------------------------------------------------

    def _empty_rows(self) -> Batch:
        cols = {c: np.empty(0, dtype=dt) for c, dt in self._schema.items()}
        return Batch(np.zeros(0, dtype=np.int64), cols,
                     np.zeros(0, dtype=np.uint64), self.key_cols)

    def gather(self, gpos: np.ndarray) -> Batch:
        """Materialize rows by encoded (part << 48 | sorted-run pos)
        positions, preserving the given order.  Hot partitions with
        payload planes gather on the device (one launch per partition);
        cold partitions host-gather through the sorted-run order."""
        from ..ops import join as dj

        n = len(gpos)
        if n == 0:
            return self._empty_rows()
        part_of = (gpos >> 48).astype(np.int64)
        pos = (gpos & ((1 << 48) - 1)).astype(np.int64)
        ts = np.empty(n, dtype=np.int64)
        kh = np.empty(n, dtype=np.uint64)
        cols: Dict[str, np.ndarray] = {}
        dev_rows = host_rows = 0
        frame = _gather_frame()
        try:
            for p in np.unique(part_of).tolist():
                part = self.parts[p]
                sel = part_of == p
                spos = pos[sel]
                kh[sel] = part.skeys[spos]
                ring = part.dev
                if ring is not None and ring.plan is not None:
                    with on_device(part.dev_device):
                        gf, gi = dj.gather_ring(ring, spos)
                    pts, pcols = dj.unpack_payload(ring, gf, gi)
                    ts[sel] = pts
                    dev_rows += len(spos)
                else:
                    ts[sel] = part.sts[spos]
                    rows = part.order[spos]
                    pcols = {c: v[rows] for c, v in part.cols.items()}
                    host_rows += len(spos)
                _fill_cols(cols, n, sel, pcols)
        finally:
            if frame is not None:
                profiler.active().end(frame)
        _count_gather(dev_rows, host_rows)
        return Batch(ts, cols, kh, self.key_cols)

    def range_join(self, other: "PartitionedJoinBuffer", start: int,
                   end: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
        """Equi-join both sides' rows with ts in [start, end): per
        partition, mask-compress each sorted run (stays key-sorted — no
        sort) and merge-probe the two.  Returns (l_gpos, r_gpos — aligned
        pair positions; l_unmatched_gpos, r_unmatched_gpos)."""
        from ..ops.join import expand_counts

        lg: List[np.ndarray] = []
        rg: List[np.ndarray] = []
        lu: List[np.ndarray] = []
        ru: List[np.ndarray] = []
        for p in range(self.P):
            lk, lpos = self.parts[p].range_view(start, end)
            rk, rpos = other.parts[p].range_view(start, end)
            enc_l = p * (1 << 48) + lpos
            enc_r = p * (1 << 48) + rpos
            if len(lk) == 0 or len(rk) == 0:
                if len(lk):
                    lu.append(enc_l)
                if len(rk):
                    ru.append(enc_r)
                continue
            s = np.searchsorted(rk, lk, side="left")
            e = np.searchsorted(rk, lk, side="right")
            counts = e - s
            if counts.any():
                lidx, offs = expand_counts(counts)
                ridx = np.repeat(s, counts) + offs
                lg.append(enc_l[lidx])
                rg.append(enc_r[ridx])
                rmatched = np.zeros(len(rk), dtype=bool)
                rmatched[ridx] = True
                if not rmatched.all():
                    ru.append(enc_r[~rmatched])
            else:
                ru.append(enc_r)
            lun = counts == 0
            if lun.any():
                lu.append(enc_l[lun])
        z = np.zeros(0, dtype=np.int64)

        def cat(xs: List[np.ndarray]) -> np.ndarray:
            return np.concatenate(xs) if xs else z

        return cat(lg), cat(rg), cat(lu), cat(ru)

    def stats(self) -> Dict[str, Any]:
        """Join-state shape: hot partitions, spill bytes (host-resident
        bytes of cold partitions), live-row estimate, devices holding
        rings, payload rings, their bytes and the total ring capacity."""
        hot = sum(1 for part in self.parts if part.dev is not None)
        host_bytes = 0
        for part in self.parts:
            if part.dev is not None:
                continue
            n = part.n
            host_bytes += int(sum(v[:n].nbytes if v.dtype != object
                                  else n * 8 for v in part.cols.values())
                              + part.keys[:n].nbytes + part.ts[:n].nbytes)
        rows = sum(max(part.n - part.dead, 0) for part in self.parts)
        ring_devs = {str(part.dev_device) for part in self.parts
                     if part.dev is not None}
        payload_rings = ring_cap = payload_bytes = 0
        for part in self.parts:
            if part.dev is None:
                continue
            ring_cap += part.dev.cap
            if part.dev.plan is not None:
                payload_rings += 1
                payload_bytes += part.dev.payload_bytes()
        return {"partitions": self.P, "hot_partitions": hot,
                "spill_bytes": host_bytes, "rows": rows,
                "ring_devices": len(ring_devs),
                "payload_rings": payload_rings,
                "payload_ring_bytes": payload_bytes,
                "ring_cap_rows": ring_cap}


_BUF_UIDS = itertools.count()


def aggregate_stats_registry(reg: Optional[Dict[Any, Dict[str, Any]]]
                             ) -> Dict[str, Any]:
    """Fold the per-buffer stats registry into one shape summary:
    additive fields sum across buffers, ``partitions`` reports the
    per-side setting and ``ring_devices`` the widest buffer."""
    entries = list((reg or {}).values())
    if not entries:
        return {}
    out = {"partitions": max(e.get("partitions", 0) for e in entries),
           "buffers": len(entries)}
    for k in ("hot_partitions", "spill_bytes", "rows", "payload_rings",
              "payload_ring_bytes", "ring_cap_rows"):
        out[k] = int(sum(e.get(k, 0) for e in entries))
    out["ring_devices"] = int(max(e.get("ring_devices", 0)
                                  for e in entries))
    return out


def make_join_buffer(device: DeviceLike = None,
                     force_partitioned: bool = False,
                     mesh: Sequence[Any] = ()) -> BatchBuffer:
    """The join side buffer for the configured state layout on
    ``device``: the partitioned layout, or under ``ARROYO_JOIN_STATE=
    legacy`` a flat host buffer whose joins re-sort both sides
    (``ops/join.join_pairs``, on the operator's device).
    ``force_partitioned`` is for the multi-way join, whose probes need
    the sorted runs."""
    if force_partitioned or partitioned_join_enabled():
        return PartitionedJoinBuffer(device=device, mesh=mesh)
    return BatchBuffer()
