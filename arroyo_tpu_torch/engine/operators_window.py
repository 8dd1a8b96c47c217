"""Windowed keyed-state operators on the device (port of
``BinAggOperator`` and ``WindowArgmaxOperator`` from
``arroyo_tpu.engine.operators_window``).

* :class:`BinAggOperator` — sliding/tumbling two-phase window aggregate
  over :class:`~arroyo_tpu_torch.ops.keyed_bins.KeyedBinState`; panes are
  emitted on watermark advance by one device pass over all pending panes.
  With ``top_n`` (a fused sliding TopN) each emission keeps only the
  top rows per window through ``ops/topk.py``;
* :class:`FactorPaneOperator` and :class:`DerivedWindowOperator` — the
  two halves of a factor-window rewrite (graph/factor_windows.py): one
  shared pane ring, drained downstream at every checkpoint barrier, and
  per-query windows that roll its fired panes up on the same kernels;
* :class:`TumblingTopNOperator` — the per-window TopN stage (the global
  merge after a fused one, with the materialized ROW_NUMBER());
* :class:`WindowArgmaxOperator` — the fused per-window argmax stage that
  consumes the aggregate's (pre-filtered) panes and settles the global
  answer, or in raw mode (q7) filters raw rows against each window's
  running and final extremum;
* :class:`WindowJoinOperator` — the windowed stream-stream equi-join over
  partition-adaptive join state (``state/join_state.py``), whose hot
  partitions live on the device;
* :class:`JoinWithExpirationOperator` — the unwindowed stream-stream
  equi-join with TTL state: every arriving batch probes the opposite
  side's state (the device rings of its hot partitions);
* :class:`MultiWayJoinOperator` — the N-ary INNER join on one key that
  the planner makes of a cascade of joins, windowed or with TTL state;
* :class:`SemiJoinOperator` — ``x IN (SELECT ...)``: a left row emits
  once, when its key has been seen on the right;
* :class:`WindowOperator` — the buffered tumbling/sliding/instant window:
  rows wait in a batch buffer until their window's end, then are
  aggregated per key by ``ops/segment.py`` (or emitted flat); SQL takes
  it for COUNT(DISTINCT), a UDAF or a string MIN/MAX;
* :class:`SessionWindowOperator` — session windows over interval-run
  state (``state/session_state.py``), aggregated per fired session by
  ``ops/segment.py``;
* :class:`NonWindowAggOperator` — the updating GROUP BY without a window:
  running per-key aggregates emitting CREATE/UPDATE rows, or, with
  ``flush_key``, a per-window re-aggregation that emits each window's
  final row once, when the watermark passes it.

With the latency observatory armed, the operators that hold rows until a
fire (bin aggregates, buffered, session and windowed-join windows) carry
the newest ingest stamp of the batches since their last fire onto the
fired batch (``_lat_track`` / ``_lat_consume``, charging the wait to the
``watermark_hold`` stage); a bin aggregate's pending stamp rides its
checkpoint as ``__lat_stamp``, the JAX package's key, so the checkpoint
restores in either package.  Fires are the ``window.fire``,
``window.session_fire`` and ``window.flush_ready`` trace spans."""

from __future__ import annotations

import asyncio
import time as _time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.logical import (
    AggKind,
    AggSpec,
    ColumnExpr,
    InstantWindow,
    JoinType,
    LogicalOperator,
    OpKind,
    SessionWindow,
    SlidingWindow,
    TumblingWindow,
)
from ..obs import latency as _latency
from ..obs import perf, tracing
from ..ops.expr import CompiledExpr, eval_record_expr
from ..ops.keyed_bins import KeyedBinState, filter_canonical_snapshot
from ..ops.segment import segment_aggregate
from ..ops.topk import segment_top_k
from ..state.join_state import PartitionedJoinBuffer
from ..state.session_state import SessionRunState, _count_merge
from ..state.tables import DeviceTable, TableDescriptor, TableType
from ..types import (MAX_TIMESTAMP, UPDATE_OP_COLUMN, Batch, Message,
                     UpdateOp, Watermark, hash_columns)
from .build import register_builder
from .context import Context
from .operator import Operator

MAX_SESSION_SIZE_MICROS = 24 * 3600 * 1_000_000  # the longest session
# rows from which a TopN ranks on the device; below it a host lexsort is
# cheaper than the device call
TOP_N_DEVICE_ROWS = 512


def _lat_track(pending: Optional[Tuple[int, float]], batch: Batch
               ) -> Optional[Tuple[int, float]]:
    """Latency-observatory pane inheritance, input side: fold one
    incoming batch's ingest stamp into the operator's pending
    ``(max_stamp, arrival_monotonic)``.  A fired pane inherits the MAX
    contributing stamp (the newest sampled record still waiting)."""
    if batch.lat_stamp is None:
        return pending
    stamp = (batch.lat_stamp if pending is None
             else max(pending[0], batch.lat_stamp))
    return (stamp, _time.monotonic())


def _lat_consume(pending: Optional[Tuple[int, float]]) -> Optional[int]:
    """Latency-observatory pane inheritance, fire side: the stamp to
    attach to the fired batch; charges the ``watermark_hold``
    critical-path stage with how long the sample waited in pane state."""
    if pending is None:
        return None
    lat = _latency.active()
    stamp, arrival = pending
    if lat is not None:
        lat.note_stage("watermark_hold",
                       max(_time.monotonic() - arrival, 0.0))
    return stamp


class _SlotKeyValues:
    """Host-side slot -> key-column-values store for bin-state operators."""

    def __init__(self) -> None:
        self.cols: Dict[str, np.ndarray] = {}
        self.size = 0

    def ensure(self, batch: Batch, slots: np.ndarray, prev_next: int,
               new_next: int) -> None:
        if new_next <= self.size and self.cols:
            return
        cap = max(new_next, 64)
        for c in list(self.cols):
            old = self.cols[c]
            if len(old) < cap:
                grown = np.empty(cap * 2, dtype=old.dtype)
                grown[:len(old)] = old
                self.cols[c] = grown
        for c in batch.key_cols:
            if c in batch.columns and c not in self.cols:
                self.cols[c] = np.empty(cap * 2, dtype=batch.columns[c].dtype)
        new_mask = slots >= prev_next
        if new_mask.any():
            idx = new_mask.nonzero()[0]
            for c in batch.key_cols:
                if c in batch.columns:
                    self.cols[c][slots[idx]] = batch.columns[c][idx]
        self.size = max(self.size, new_next)

    def gather(self, slot_idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {c: v[slot_idx] for c, v in self.cols.items()}

    def snapshot(self) -> Dict[str, np.ndarray]:
        return {f"kv_{c}": v[:self.size] for c, v in self.cols.items()} | {
            "kv_size": np.array([self.size])}

    def restore(self, arrays: Dict[str, np.ndarray]) -> None:
        self.size = int(arrays["kv_size"][0])
        for k, v in arrays.items():
            if k.startswith("kv_") and k != "kv_size":
                self.cols[k[3:]] = v.copy()


class BinAggOperator(Operator):
    """Two-phase binned window aggregate over device state."""

    def __init__(self, name: str, width_micros: int, slide_micros: int,
                 aggs: Tuple[AggSpec, ...],
                 projection: Optional[ColumnExpr] = None,
                 argmax_local: Optional[Tuple[str, str]] = None,
                 top_n: Optional[Tuple[Tuple[str, ...], str, int]] = None,
                 device: DeviceLike = None):
        super().__init__(name)
        self.width = width_micros
        self.slide = slide_micros
        self.aggs = aggs
        self.state = KeyedBinState(aggs, slide_micros, width_micros,
                                   device=device)
        # (partition_cols, sort_column, max_elements) of a fused TopN
        self.top_n = top_n
        if argmax_local is not None:
            # emission pre-filters to local per-pane argmax candidates
            self.state.set_argmax_local(*argmax_local)
        self.keyvals = _SlotKeyValues()
        self.projection = (CompiledExpr(projection.name, projection.fn,
                                        resolve_device(device))
                           if projection else None)
        self._key_cols: Tuple[str, ...] = ()
        # latency-observatory pane inheritance: (max contributing ingest
        # stamp, monotonic arrival) pending until the next pane fire
        self._lat_pending: Optional[Tuple[int, float]] = None
        self._ledger_updates = 0  # throttles the pane_state_registry note

    def _offload_transfers(self) -> bool:
        """Run device update/emit in an executor thread when the state
        lives on an accelerator, so host<->device copies and the fire's
        sync do not hold the event loop; on the CPU the thread hop is
        pure overhead."""
        return self.state.device.type != "cpu"

    async def on_start(self, ctx: Context) -> None:
        def snap():
            out = self.state.snapshot() | self.keyvals.snapshot()
            if self._lat_pending is not None:
                # a sampled record held in pane state at the barrier is
                # still measured after a restore (the JAX package's key)
                out["__lat_stamp"] = np.array([self._lat_pending[0]],
                                              np.int64)
            return out

        def restore(arrays, _kr=ctx.task_info.key_range):
            st = arrays.pop("__lat_stamp", None)
            if st is not None:
                self._lat_pending = (int(st[0]), _time.monotonic())
            # rescale re-partitioning: keep only the keys this subtask owns
            arrays = filter_canonical_snapshot(arrays, _kr)
            self.state.restore(arrays)
            self.keyvals.restore(arrays)

        ctx.state.register_device(
            TableDescriptor("a", TableType.DEVICE, "bin aggregates",
                            retention_micros=self.width),
            DeviceTable(snap, restore))

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        if batch.key_hash is None:
            raise ValueError(f"{self.name} requires keyed input")
        self._lat_pending = _lat_track(self._lat_pending, batch)
        self._key_cols = batch.key_cols
        prev = self.state.next_slot
        slots = self.state._lookup_or_insert(batch.key_hash)
        self.keyvals.ensure(batch, slots, prev, self.state.next_slot)
        # safe to offload: this operator's messages are processed serially
        if self._offload_transfers():
            await perf.run_offloaded(
                asyncio.get_running_loop(), self.state.update,
                batch.key_hash, batch.timestamp, batch.columns)
        else:
            self.state.update(batch.key_hash, batch.timestamp, batch.columns)
        self._ledger_updates += 1
        if self._ledger_updates % 16 == 1:
            self._note_device_bytes()

    def _note_device_bytes(self) -> None:
        """The device-memory ledger's note (obs/latency.py
        ``device_state_tables``): one entry an operator instance, read off
        the plane handles (no transfer)."""
        reg = perf.get_note("pane_state_registry")
        if not isinstance(reg, dict):
            reg = {}
            perf.note("pane_state_registry", reg)
        reg[self.name] = self.state.device_bytes()

    async def on_close(self, ctx: Context) -> None:
        self._note_device_bytes()  # the ledger holds the final planes

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        final = watermark >= int(MAX_TIMESTAMP) - 1
        # flight-recorder tap: pane firing is where windowed pipelines
        # spend their watermark-driven time
        with tracing.span("window.fire", "window",
                          tid=tracing.ctx_tid(ctx),
                          args={"watermark": int(watermark)}):
            if self._offload_transfers():
                fired = await perf.run_offloaded(
                    asyncio.get_running_loop(),
                    lambda: self.state.fire_panes(watermark, final=final))
            else:
                fired = self.state.fire_panes(watermark, final=final)
            if fired is not None:
                await self._emit(fired, ctx)
        await ctx.broadcast(Message.wm(Watermark.event_time(watermark)))

    async def _emit(self, fired, ctx: Context) -> None:
        keys, out_cols, window_end, _counts = fired
        slot_idx = self.state.slot_of_sorted[
            np.searchsorted(self.state.key_sorted, keys)]
        cols: Dict[str, np.ndarray] = {}
        cols.update(self.keyvals.gather(slot_idx))
        cols["window_start"] = window_end - self.width
        cols["window_end"] = window_end
        cols.update(out_cols)
        ts = window_end - 1  # rows stamp at window end - 1
        key_cols = self._key_cols or tuple(self.keyvals.cols)
        out = Batch(ts, cols, keys.astype(np.uint64), key_cols,
                    lat_stamp=_lat_consume(self._lat_pending))
        self._lat_pending = None
        if self.top_n is not None:
            out = _apply_top_n(out, *self.top_n, device=self.state.device)
        if self.projection is not None:
            out = eval_record_expr(self.projection, out)
        await ctx.collect(out)


class FactorPaneOperator(BinAggOperator):
    """The shared half of a factor-window rewrite
    (graph/factor_windows.py): a width == slide == pane bin aggregate of
    the member queries' partial aggregates, once a pane.  Watermark fires
    emit completed panes as any tumbling aggregate does; at a checkpoint
    barrier the pending panes DRAIN downstream as deltas and reset on the
    device before the snapshot (``KeyedBinState.drain_deltas``), so this
    operator's table never holds un-shipped mass and a factored
    checkpoint restores into an unfactored plan."""

    def __init__(self, name: str, pane_micros: int,
                 aggs: Tuple[AggSpec, ...], device: DeviceLike = None):
        super().__init__(name, pane_micros, pane_micros, aggs,
                         device=device)

    async def pre_checkpoint(self, barrier, ctx: Context) -> None:
        if self._offload_transfers():
            fired = await perf.run_offloaded(asyncio.get_running_loop(),
                                             self.state.drain_deltas)
        else:
            fired = self.state.drain_deltas()
        if fired is not None:
            perf.count("factor_drains")
            perf.count("factor_drain_rows", len(fired[0]))
            await self._emit(fired, ctx)


class DerivedWindowOperator(BinAggOperator):
    """The per-query half of a factor-window rewrite: a bin aggregate with
    the member's own (width, slide, aggs, projection) whose ring runs in
    merge-input mode: its updates are fired factor panes (one row a (key,
    pane), ``__f_*`` partial columns), not events.  Channel layout, table
    name and snapshot format are the unfactored member's, so checkpoints
    interchange between factored and unfactored plans."""

    def __init__(self, name: str, width_micros: int, slide_micros: int,
                 pane_micros: int, aggs: Tuple[AggSpec, ...],
                 projection: Optional[ColumnExpr] = None,
                 device: DeviceLike = None):
        from ..graph.factor_windows import ROWS_COLUMN, derived_channel_cols

        if slide_micros % pane_micros:
            raise ValueError("the factor pane must divide the derived slide")
        super().__init__(name, width_micros, slide_micros, aggs, projection,
                         device=device)
        self.state.set_merge_inputs(derived_channel_cols(aggs), ROWS_COLUMN)


def _topn_partition(batch: Batch, partition_cols: Tuple[str, ...]
                    ) -> np.ndarray:
    """The TopN partition of each row: a hash of the partition columns and
    the window end (TopN ranks within a window, never across windows),
    or the window end alone."""
    if partition_cols:
        cols = [batch.columns[c] for c in partition_cols]
        if "window_end" in batch.columns:
            cols.append(batch.columns["window_end"])
        return hash_columns(cols)
    return batch.columns.get("window_end", np.zeros(len(batch), np.int64))


def _host_ranks(part: np.ndarray, sort_val: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(order, 0-based rank of each row of ``order`` in its partition)
    of a stable lexsort by (partition, -value)."""
    order = np.lexsort((-np.asarray(sort_val, dtype=np.float64), part))
    part_sorted = np.asarray(part)[order]
    is_start = np.ones(len(order), dtype=bool)
    is_start[1:] = part_sorted[1:] != part_sorted[:-1]
    seg_start = is_start.nonzero()[0]
    seg_id = np.cumsum(is_start) - 1
    return order, np.arange(len(order)) - seg_start[seg_id]


def _apply_top_n(batch: Batch, partition_cols: Tuple[str, ...],
                 sort_column: str, max_elements: Optional[int],
                 rank_column: Optional[str] = None,
                 device: DeviceLike = None) -> Batch:
    """Keep the top ``max_elements`` rows by ``sort_column`` (descending)
    per partition: one ``segment_top_k`` call on ``device`` from
    ``TOP_N_DEVICE_ROWS`` rows, a host lexsort below.

    ``max_elements=None`` ranks without pruning; ``rank_column`` adds the
    1-based rank in the partition (a materialized ROW_NUMBER()), computed
    on the host over the surviving rows."""
    if len(batch) == 0:
        return batch
    sort_val = batch.columns[sort_column]
    part = _topn_partition(batch, partition_cols)
    if max_elements is not None:
        if len(batch) >= TOP_N_DEVICE_ROWS:
            keep = segment_top_k(part, sort_val, max_elements, device)
        else:
            order, rank = _host_ranks(part, sort_val)
            keep = order[rank < max_elements]
            keep.sort()
        batch = batch.select(keep)
        if rank_column is None:
            return batch
        part = np.asarray(part)[keep]
        sort_val = batch.columns[sort_column]
    if rank_column is None:
        return batch
    order, rank = _host_ranks(part, sort_val)
    ranks = np.empty(len(order), dtype=np.int64)
    ranks[order] = rank + 1
    cols = dict(batch.columns)
    cols[rank_column] = ranks
    return Batch(batch.timestamp, cols, batch.key_hash, batch.key_cols)


class TumblingTopNOperator(Operator):
    """Per-window TopN: rows buffer until their window's end passes the
    watermark, then the top ``max_elements`` per partition are emitted
    (with their rank in ``rank_column``, when set)."""

    def __init__(self, name: str, width_micros: int,
                 max_elements: Optional[int], sort_column: str,
                 partition_cols: Tuple[str, ...],
                 projection: Optional[ColumnExpr] = None,
                 rank_column: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(name)
        self.width = width_micros
        self.max_elements = max_elements
        self.sort_column = sort_column
        self.partition_cols = partition_cols
        self.rank_column = rank_column
        self.device = resolve_device(device)
        self.projection = (CompiledExpr(projection.name, projection.fn,
                                        self.device)
                           if projection else None)

    def tables(self) -> List[TableDescriptor]:
        return [TableDescriptor("t", TableType.BATCH_BUFFER, "topn buffer",
                                retention_micros=self.width)]

    async def on_start(self, ctx: Context) -> None:
        self.buffer = ctx.state.get_batch_buffer("t")

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        self.buffer.append(batch)
        ends = np.unique((batch.timestamp // self.width + 1) * self.width)
        for e in ends.tolist():
            ctx.timers.schedule(int(e), ("tn", int(e)))

    async def handle_timer(self, time: int, key: Any, payload: Any,
                           ctx: Context) -> None:
        end = key[1]
        start = end - self.width
        rows = self.buffer.query_range(start, end)
        if rows is not None and len(rows):
            out_cols = dict(rows.columns)
            # rows that carry window columns (a global TopN over windowed
            # aggregates) keep them: this stage's buckets are not the window
            if "window_start" not in out_cols:
                out_cols["window_start"] = np.full(len(rows), start,
                                                   np.int64)
            if "window_end" not in out_cols:
                out_cols["window_end"] = np.full(len(rows), end, np.int64)
            out = Batch(np.full(len(rows), end - 1, np.int64), out_cols,
                        rows.key_hash, rows.key_cols)
            out = _apply_top_n(out, self.partition_cols, self.sort_column,
                               self.max_elements, self.rank_column,
                               self.device)
            if self.projection is not None:
                out = eval_record_expr(self.projection, out)
            await ctx.collect(out)
        self.buffer.evict_before(end)


class WindowArgmaxOperator(Operator):
    """Fused ``A JOIN (SELECT max(x), window FROM A GROUP BY window)``:
    rows arrive keyed by window, buffer per window until the watermark
    passes, then emit exactly the rows achieving the window's max/min of
    ``value_col`` (ties included) plus the pruned side's synthesized
    columns.  Sound at any upstream parallelism: every global argmax row
    is also a local argmax row upstream.

    Raw mode (q7): rows are raw stream rows.  Rows strictly dominated by
    their window's running extremum drop before buffering, and a late
    row matches its released window's final extremum (table ``f``, kept
    for the late TTL, at least one window span) and emits at once."""

    def __init__(self, name: str, value_col: str, minmax: str,
                 synth_cols: Tuple[Tuple[str, str], ...], width_micros: int,
                 raw: bool = False, late_ttl_micros: int = 0):
        super().__init__(name)
        self.value_col = value_col
        self.minmax = minmax
        self.synth_cols = synth_cols
        self.width = max(int(width_micros), 1)
        self.raw = raw
        self.late_ttl = (max(int(late_ttl_micros), self.width)
                         if raw else max(int(late_ttl_micros), 0))
        # raw mode: each live window's running extremum (sign-adjusted),
        # memory only: after a restore the first batch of a window is
        # admitted unfiltered, which changes no emitted row
        self._running: Dict[int, float] = {}
        self._released_wm: Optional[int] = None

    def tables(self) -> List[TableDescriptor]:
        tables = [TableDescriptor("b", TableType.BATCH_BUFFER,
                                  "per-window candidate rows",
                                  retention_micros=self.width)]
        if self.raw:
            tables.append(TableDescriptor(
                "f", TableType.TIME_KEY_MAP, "released-window final extrema",
                retention_micros=self.late_ttl))
        return tables

    async def on_start(self, ctx: Context) -> None:
        self.buf = ctx.state.get_batch_buffer("b")
        self.final = ctx.state.get_time_key_map("f") if self.raw else None
        self._lat_pending: Optional[Tuple[int, float]] = None
        if ctx.last_watermark is not None:
            # windows at or below the checkpoint watermark fired before
            # the restore; a late replayed row matches ``f`` instead
            self._released_wm = ctx.last_watermark

    def ctx_watermark(self, ctx: Context) -> Optional[int]:
        """Release threshold: the current input watermark, floored by the
        last window end a timer released."""
        wm = ctx.last_watermark
        if self._released_wm is not None:
            wm = (self._released_wm if wm is None
                  else max(wm, self._released_wm))
        return wm

    async def _admit(self, batch: Batch, ctx: Context) -> Optional[Batch]:
        """Raw-mode admission; returns the rows to buffer.  NaN values
        drop; rows of windows at or below the watermark are late and emit
        now iff they equal the window's final extremum (a late row of a
        window that never fired matches nothing); live rows strictly
        dominated by the running extremum drop, ties stay."""
        ends = np.asarray(batch.columns["window_end"], dtype=np.int64)
        vals = np.asarray(batch.columns[self.value_col])
        keep = (~np.isnan(vals) if vals.dtype.kind == "f"
                else np.ones(len(vals), dtype=bool))
        released = self.ctx_watermark(ctx)
        if released is not None:
            late = keep & (ends <= released)
            if late.any():
                keep &= ~late
                hit = np.zeros(len(ends), dtype=bool)
                for e in np.unique(ends[late]).tolist():
                    best = self.final.get(e, "x")
                    if best is not None:
                        hit |= late & (ends == e) & (vals == best)
                perf.count("window_argmax_late_rows", int(late.sum()))
                if hit.any():
                    perf.count("window_argmax_late_hits", int(hit.sum()))
                    await self._emit(batch.select(np.nonzero(hit)[0]), ctx)
        sign = 1.0 if self.minmax == "max" else -1.0
        for e in np.unique(ends[keep]).tolist():
            m = keep & (ends == e)
            best = self._running.get(e)
            if best is not None:
                m_new = m & (sign * vals >= best)
                keep &= ~m | m_new
                m = m_new
            if m.any():
                local = (sign * vals[m]).max()
                self._running[e] = (local if best is None
                                    else max(best, local))
        if keep.all():
            return batch
        if not keep.any():
            return None
        return batch.select(np.nonzero(keep)[0])

    async def _emit(self, rows: Batch, ctx: Context,
                    lat_stamp: Optional[int] = None) -> None:
        cols = dict(rows.columns)
        for out_name, src in self.synth_cols:
            cols[out_name] = cols[src]
        await ctx.collect(Batch(rows.timestamp, cols, rows.key_hash,
                                rows.key_cols, lat_stamp=lat_stamp))

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        # a window fire, so the fired rows inherit the pane stamp rule
        # (the JAX package's WindowArgmaxOperator drops stamps here:
        # ROADMAP C14)
        self._lat_pending = _lat_track(self._lat_pending, batch)
        if self.raw:
            batch = await self._admit(batch, ctx)
            if batch is None:
                return
        self.buf.append(batch)
        # one timer per distinct window end; rows stamp timestamp =
        # window_end - 1
        for e in np.unique(np.asarray(batch.columns["window_end"],
                                      dtype=np.int64)).tolist():
            ctx.timers.schedule(int(e), ("am", int(e)))

    async def handle_timer(self, time: int, key: Any, payload: Any,
                           ctx: Context) -> None:
        end = key[1]
        rows = self.buf.query_range(end - 1, end)  # ts == end - 1
        self.buf.evict_before(end)
        self._running.pop(end, None)
        self._released_wm = (end if self._released_wm is None
                             else max(self._released_wm, end))
        if rows is None or not len(rows):
            return
        vals = np.asarray(rows.columns[self.value_col])
        # SQL NULLs (NaN) never equal the extremum
        valid = (~np.isnan(vals) if vals.dtype.kind == "f"
                 else np.ones(len(vals), dtype=bool))
        if not valid.any():
            return
        vv = vals[valid]
        best = vv.max() if self.minmax == "max" else vv.min()
        if self.final is not None:
            self.final.insert(end, "x", best)
            if self.late_ttl:
                self.final.evict_before(end - self.late_ttl)
        stamp = _lat_consume(self._lat_pending)
        self._lat_pending = None
        await self._emit(rows.select(np.nonzero(valid & (vals == best))[0]),
                         ctx, stamp)


# -- window join ----------------------------------------------------------------------


def _window_params(typ) -> Tuple[int, int]:
    """(width, slide) micros for uniform window types."""
    if isinstance(typ, TumblingWindow):
        return typ.width_micros, typ.width_micros
    if isinstance(typ, SlidingWindow):
        return typ.width_micros, typ.slide_micros
    if isinstance(typ, InstantWindow):
        return 1, 1
    raise TypeError(f"not a uniform window: {typ}")


def _null_column(n: int, like: Optional[np.ndarray] = None,
                 kind: str = "") -> np.ndarray:
    """A NULL-filled column: None for object/string columns, NaN (f64)
    for everything else — the engine's null conventions."""
    stringy = (kind == "s" if like is None
               else (like.dtype == object or like.dtype.kind in "US"))
    if stringy:
        return np.full(n, None, dtype=object)
    return np.full(n, np.nan, dtype=np.float64)


def _join_name_maps(l_names, r_names
                    ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Column-name mapping for a join output: left names win, colliding
    right names get the ``r_`` prefix."""
    lmap = {c: c for c in l_names}
    rmap: Dict[str, str] = {}
    taken = set(lmap.values())
    for c in r_names:
        name = c
        if name in taken:
            name = "r_" + name
        rmap[c] = name
        taken.add(name)
    return lmap, rmap


def _internal_join_col(name: str) -> bool:
    """Planner-internal join key columns: ``__jk<i>`` + ``__jknonce``."""
    return name.startswith("__jk")


def _drop_null_keyed(batch: Batch) -> Optional[Batch]:
    """Strip rows whose ``__jknonce`` is nonzero — SQL-NULL join keys
    hashed to a unique nonce can never match any row.  Returns None when
    nothing survives."""
    nonce = batch.columns.get("__jknonce")
    if nonce is None:
        return batch
    keep = np.asarray(nonce) == 0
    if keep.all():
        return batch
    if not keep.any():
        return None
    return batch.select(keep)


def _stable_join_part(left_cols: Dict[str, np.ndarray],
                      right_cols: Dict[str, np.ndarray], n: int,
                      key_names: Sequence[str]) -> Dict[str, np.ndarray]:
    """One joined-output column layout per join, whichever side a row
    came from: the right role never carries internal join-key columns;
    the left role always does (filled with same-dtype zeros when the
    left role is itself a pad), keys first and ``__jknonce`` last."""
    witness = {c: v for c, v in right_cols.items()
               if _internal_join_col(c)}
    right_cols = {c: v for c, v in right_cols.items()
                  if not _internal_join_col(c)}

    def _key_fill(c: str) -> np.ndarray:
        w = witness.get(c)
        if w is not None:
            return np.zeros(n, dtype=w.dtype)
        return _null_column(n)

    ordered: Dict[str, Optional[np.ndarray]] = {}
    for c in key_names:
        if c != "__jknonce":
            ordered[c] = left_cols.get(c)
    for c, v in left_cols.items():
        if c not in ordered and c != "__jknonce":
            ordered[c] = v
    if "__jknonce" in key_names:
        ordered["__jknonce"] = left_cols.get("__jknonce")
    cols = {c: (v if v is not None else _key_fill(c))
            for c, v in ordered.items()}
    lmap, rmap = _join_name_maps(list(cols), list(right_cols))
    out = {lmap[c]: v for c, v in cols.items()}
    for c, v in right_cols.items():
        out[rmap[c]] = v
    return out


class _SideTemplate:
    """Column template for null-padding one side of an outer join: the
    dtypes of batches seen on that side, else the planner's (name, kind)
    schema."""

    def __init__(self, spec_cols: Tuple[Tuple[str, str], ...]):
        self.spec_cols = tuple(spec_cols)
        self.seen: Optional[Dict[str, np.dtype]] = None

    def observe(self, batch: Batch) -> None:
        self.seen = {c: v.dtype for c, v in batch.columns.items()}

    def null_cols(self, n: int) -> Dict[str, np.ndarray]:
        if self.seen is not None:
            return {c: _null_column(n, like=np.empty(0, dtype=dt))
                    for c, dt in self.seen.items()}
        return {c: _null_column(n, kind=k) for c, k in self.spec_cols}


def _empty_like_side(tmpl: _SideTemplate, other: Batch) -> Batch:
    """A 0-row batch shaped like one join side (for windows where that
    side saw no data)."""
    cols = {c: v[:0] for c, v in tmpl.null_cols(0).items()}
    return Batch(np.zeros(0, dtype=np.int64), cols,
                 np.zeros(0, dtype=np.uint64), other.key_cols)


def _concat_col(parts: List[np.ndarray]) -> np.ndarray:
    """Concatenate column fragments, promoting to object when any
    fragment is (None-padded rows mix with typed rows); int64 fragments
    mixed with NaN pads promote to float64, the engine's nullable-int
    convention."""
    if any(p.dtype == object for p in parts):
        out = np.empty(sum(len(p) for p in parts), dtype=object)
        at = 0
        for p in parts:
            out[at:at + len(p)] = p
            at += len(p)
        return out
    return np.concatenate(parts)


def _assemble_join_output(l_rows: Batch, r_rows: Batch,
                          l_un: Optional[Batch], r_un: Optional[Batch],
                          end: int, how: JoinType, key_cols,
                          tmpl: Tuple[_SideTemplate, _SideTemplate]
                          ) -> Batch:
    """One join-output batch from aligned matched rows plus each side's
    unmatched rows; every part shares one column layout."""
    key_names = tuple(key_cols)
    parts: List[Tuple[Dict[str, np.ndarray], np.ndarray]] = []  # (cols, kh)
    parts.append((_stable_join_part(
        dict(l_rows.columns), dict(r_rows.columns), len(l_rows),
        key_names), l_rows.key_hash))
    if how in (JoinType.LEFT, JoinType.FULL) and l_un is not None \
            and len(l_un):
        parts.append((_stable_join_part(
            dict(l_un.columns), tmpl[1].null_cols(len(l_un)), len(l_un),
            key_names), l_un.key_hash))
    if how in (JoinType.RIGHT, JoinType.FULL) and r_un is not None \
            and len(r_un):
        parts.append((_stable_join_part(
            tmpl[0].null_cols(len(r_un)), dict(r_un.columns), len(r_un),
            key_names), r_un.key_hash))
    if len(parts) == 1:
        cols, kh = parts[0]
        return Batch(np.full(len(kh), end - 1, dtype=np.int64), cols, kh,
                     key_names)
    names = list(parts[0][0])
    out_cols = {c: _concat_col([p[0][c] for p in parts]) for c in names}
    kh = np.concatenate([p[1] for p in parts])
    return Batch(np.full(len(kh), end - 1, dtype=np.int64), out_cols, kh,
                 key_names)


def join_batches(l: Batch, r: Batch, end: int, how: JoinType,
                 tmpl: Tuple[_SideTemplate, _SideTemplate],
                 device: torch.device) -> Batch:
    """The legacy layout's fire: re-sort both sides' key hashes and pair
    them (``ops/join.join_pairs``, on ``device``), gather the rows on the
    host, null-pad the unmatched rows."""
    from ..ops.join import join_pairs
    from ..state.join_state import _count_gather

    lo, ro, lidx, ridx, counts = join_pairs(l.key_hash, r.key_hash, device)
    l_rows = l.select(lo[lidx])
    r_rows = r.select(ro[ridx])
    l_un = (l.select(lo[counts == 0])
            if how in (JoinType.LEFT, JoinType.FULL) else None)
    r_un = None
    if how in (JoinType.RIGHT, JoinType.FULL):
        r_matched = np.zeros(len(r.key_hash), dtype=bool)
        if len(ridx):
            r_matched[ro[ridx]] = True
        r_un = r.select(~r_matched)
    _count_gather(0, len(l_rows) + len(r_rows)
                  + (len(l_un) if l_un is not None else 0)
                  + (len(r_un) if r_un is not None else 0))
    return _assemble_join_output(l_rows, r_rows, l_un, r_un, end, how,
                                 l.key_cols, tmpl)


class WindowJoinOperator(Operator):
    """Windowed stream-stream hash join: both sides buffered, joined per
    fired window.  On the partitioned layout a fire mask-compresses each
    partition's sorted run to the window (no sort), merge-probes the two
    sides on the host mirror and gathers the matched rows — from the
    device rings of hot partitions.  Outer kinds null-pad the unmatched
    side per fired window (append-only: each window fires once).  On the
    legacy layout a fire re-sorts both sides and pairs them on the
    operator's device (``ops/join.join_pairs``)."""

    def __init__(self, name: str, typ, join_type: JoinType = JoinType.INNER,
                 left_cols: Tuple[Tuple[str, str], ...] = (),
                 right_cols: Tuple[Tuple[str, str], ...] = (),
                 device: DeviceLike = None):
        super().__init__(name)
        self.device = resolve_device(device)
        self.typ = typ
        self.join_type = join_type
        self.width, self.slide = _window_params(typ)
        self._tmpl = (_SideTemplate(left_cols), _SideTemplate(right_cols))

    async def on_start(self, ctx: Context) -> None:
        self.left = ctx.state.get_join_buffer("l", "left buffer", self.width)
        self.right = ctx.state.get_join_buffer("r", "right buffer",
                                               self.width)
        self._partitioned = isinstance(self.left, PartitionedJoinBuffer)
        self._lat_pending: Optional[Tuple[int, float]] = None

    def _drop_never_emitting(self, batch: Batch,
                             side: int) -> Optional[Batch]:
        """Null-keyed rows stay only when this side's unmatched rows
        null-pad at fire; otherwise they can never emit."""
        padded = self.join_type in (
            (JoinType.LEFT, JoinType.FULL) if side == 0
            else (JoinType.RIGHT, JoinType.FULL))
        return batch if padded else _drop_null_keyed(batch)

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        if batch.key_hash is None:
            raise ValueError(f"{self.name} requires keyed inputs")
        self._lat_pending = _lat_track(self._lat_pending, batch)
        self._tmpl[side].observe(batch)
        buffered = self._drop_never_emitting(batch, side)
        if buffered is not None and len(buffered):
            (self.left if side == 0 else self.right).append(buffered)
        first_end = (batch.timestamp // self.slide + 1) * self.slide
        if isinstance(self.typ, SlidingWindow):
            ends = np.unique(np.concatenate([
                first_end + i * self.slide
                for i in range(self.width // self.slide)]))
        else:
            ends = np.unique(first_end - self.slide + self.width)
        for e in ends.tolist():
            ctx.timers.schedule(int(e), ("wj", int(e)))

    async def handle_timer(self, time: int, key: Any, payload: Any,
                           ctx: Context) -> None:
        end = key[1]
        start = end - self.width
        out = (self._fire_partitioned(start, end) if self._partitioned
               else self._fire_legacy(start, end))
        if out is not None and len(out):
            out.lat_stamp = _lat_consume(self._lat_pending)
            self._lat_pending = None
            await ctx.collect(out)
        evict_to = end - self.width + self.slide
        self.left.evict_before(evict_to)
        self.right.evict_before(evict_to)

    def _fires(self, have_l: bool, have_r: bool) -> bool:
        how = self.join_type
        return ((have_l and have_r)
                or (have_l and how in (JoinType.LEFT, JoinType.FULL))
                or (have_r and how in (JoinType.RIGHT, JoinType.FULL)))

    def _fire_partitioned(self, start: int, end: int) -> Optional[Batch]:
        how = self.join_type
        lg, rg, lu, ru = self.left.range_join(self.right, start, end)
        if not self._fires(bool(len(lg) or len(lu)),
                           bool(len(rg) or len(ru))):
            return None
        l_rows = self.left.gather(lg)
        r_rows = self.right.gather(rg)
        if not len(l_rows.columns):
            l_rows = _empty_like_side(self._tmpl[0], r_rows)
        if not len(r_rows.columns):
            r_rows = _empty_like_side(self._tmpl[1], l_rows)
        key_cols = (self.left.key_cols or self.right.key_cols
                    or l_rows.key_cols)
        # unmatched rows only materialize on the side that pads them
        l_un = (self.left.gather(lu)
                if how in (JoinType.LEFT, JoinType.FULL) else None)
        r_un = (self.right.gather(ru)
                if how in (JoinType.RIGHT, JoinType.FULL) else None)
        return _assemble_join_output(l_rows, r_rows, l_un, r_un, end, how,
                                     key_cols, self._tmpl)

    def _fire_legacy(self, start: int, end: int) -> Optional[Batch]:
        l = self.left.query_range(start, end)
        r = self.right.query_range(start, end)
        have_l = l is not None and len(l) > 0
        have_r = r is not None and len(r) > 0
        if not self._fires(have_l, have_r):
            return None
        if not have_l:
            l = _empty_like_side(self._tmpl[0], r)
        if not have_r:
            r = _empty_like_side(self._tmpl[1], l)
        return join_batches(l, r, end, self.join_type, self._tmpl,
                            self.device)


class JoinWithExpirationOperator(Operator):
    """Unwindowed stream-stream join with TTL state.  Inner joins emit
    append rows; outer joins emit updating (``__op``) rows: an arriving
    row with no opposite match emits a null-padded CREATE, and when the
    FIRST opposite-side row for that key arrives later, the padded rows
    are retracted (DELETE) and replaced by joined CREATEs.  Each arriving
    batch probes the opposite side's state (``probe_batch``: the device
    rings of hot partitions; on the legacy layout a re-sort of the batch
    and the whole opposite side, paired on the operator's device by
    ``ops/join.join_pairs``), then joins its own side's state; rows
    expire once the watermark passes their time plus their side's
    TTL."""

    def __init__(self, name: str, left_ttl: int, right_ttl: int,
                 join_type: JoinType,
                 left_cols: Tuple[Tuple[str, str], ...] = (),
                 right_cols: Tuple[Tuple[str, str], ...] = (),
                 device: DeviceLike = None):
        super().__init__(name)
        self.device = resolve_device(device)
        self.left_ttl = left_ttl
        self.right_ttl = right_ttl
        self.join_type = join_type
        self._tmpl = (_SideTemplate(left_cols), _SideTemplate(right_cols))

    async def on_start(self, ctx: Context) -> None:
        self.left = ctx.state.get_join_buffer("l", "left state",
                                              self.left_ttl)
        self.right = ctx.state.get_join_buffer("r", "right state",
                                               self.right_ttl)
        self._partitioned = isinstance(self.left, PartitionedJoinBuffer)

    async def on_close(self, ctx: Context) -> None:
        if self._partitioned:
            # the device-memory ledger holds the final rings
            self.left.note_stats()
            self.right.note_stats()

    def _orient(self, mine_rows: Batch, opp_cols: Dict[str, np.ndarray],
                side: int, end: int, op: Optional[int]) -> Batch:
        """An output batch of MY side's rows beside already-named
        opposite-side columns, in left-right orientation; every emission
        (matched, padded, retraction, either arrival side) goes through
        ``_stable_join_part``, so the edge keeps one column layout."""
        n = len(mine_rows)
        key_names = tuple(mine_rows.key_cols)
        if side == 0:
            cols = _stable_join_part(dict(mine_rows.columns),
                                     dict(opp_cols), n, key_names)
        else:
            cols = _stable_join_part(dict(opp_cols),
                                     dict(mine_rows.columns), n, key_names)
        if op is not None:
            cols[UPDATE_OP_COLUMN] = np.full(n, op, np.int8)
        return Batch(np.full(n, end - 1, dtype=np.int64), cols,
                     mine_rows.key_hash, mine_rows.key_cols)

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        if batch.key_hash is None:
            raise ValueError(f"{self.name} requires keyed inputs")
        if not len(batch):
            return
        how = self.join_type
        self._tmpl[side].observe(batch)
        mine, other = ((self.left, self.right) if side == 0
                       else (self.right, self.left))
        my_tmpl, opp_tmpl = self._tmpl[side], self._tmpl[1 - side]
        # is MY side / the OPPOSITE side null-padded when unmatched?
        my_outer = how in ((JoinType.LEFT, JoinType.FULL) if side == 0
                           else (JoinType.RIGHT, JoinType.FULL))
        opp_outer = how in ((JoinType.RIGHT, JoinType.FULL) if side == 0
                            else (JoinType.LEFT, JoinType.FULL))
        op_create = UpdateOp.CREATE.value if how != JoinType.INNER else None
        # O(P): resident-but-dead rows are fine here (the probe drops them)
        have_opp = (any(part.n for part in other.parts)
                    if self._partitioned else len(other) > 0)
        end = int(batch.timestamp.max()) + 1

        # 1. retract padded opposite rows: keys NEW to my state that match
        #    opposite rows emitted earlier as (null, row).  "New" is judged
        #    from the current state, so after TTL eviction a re-arriving
        #    key can retract a pad that was already retracted — the
        #    reference's behaviour for expired state, kept for parity.
        if opp_outer and have_opp:
            batch_keys = np.unique(batch.key_hash)
            new_keys = batch_keys[~mine.contains_keys(batch_keys)]
            if len(new_keys):
                if self._partitioned:
                    padded = other.rows_with_keys(new_keys)
                else:
                    from ..state.join_state import _count_gather

                    opp_all = other.all()
                    padded = opp_all.select(np.isin(opp_all.key_hash,
                                                    new_keys))
                    _count_gather(0, len(padded))
                if len(padded):
                    pad = my_tmpl.null_cols(len(padded))
                    await ctx.collect(self._orient(
                        padded, pad, 1 - side, end, UpdateOp.DELETE.value))

        # 2. joined CREATEs for matched pairs: the partitioned layout
        #    probes the opposite state's sorted runs (only the batch gets
        #    sorted); the legacy layout re-sorts both sides
        if have_opp:
            if self._partitioned:
                bsel, opp_rows, counts = other.probe_batch(batch)
                if len(bsel):
                    await ctx.collect(self._orient(
                        batch.select(bsel), dict(opp_rows.columns), side,
                        end, op_create))
                unmatched = counts == 0
            else:
                from ..ops.join import join_pairs
                from ..state.join_state import _count_gather

                opp = other.all()
                lo, ro, lidx, ridx, counts = join_pairs(
                    batch.key_hash, opp.key_hash, self.device)
                if len(lidx):
                    opp_rows = opp.select(ro[ridx])
                    _count_gather(0, len(opp_rows))
                    await ctx.collect(self._orient(
                        batch.select(lo[lidx]), dict(opp_rows.columns),
                        side, end, op_create))
                unmatched = np.zeros(len(batch), dtype=bool)
                unmatched[lo[counts == 0]] = True  # back to batch order
        else:
            unmatched = np.ones(len(batch), dtype=bool)

        # 3. null-padded CREATEs for my unmatched rows
        if my_outer and unmatched.any():
            un = batch.select(unmatched)
            await ctx.collect(self._orient(un, opp_tmpl.null_cols(len(un)),
                                           side, end, op_create))

        # 4. buffer, except null-keyed rows: their pad (if any) went out
        #    above, and no opposite row can ever match or retract it
        batch = _drop_null_keyed(batch)
        if batch is not None and len(batch):
            mine.append(batch)

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        self.left.evict_before(watermark - self.left_ttl)
        self.right.evict_before(watermark - self.right_ttl)
        await ctx.broadcast(Message.wm(Watermark.event_time(watermark)))


class MultiWayJoinOperator(Operator):
    """N-ary INNER equi-join over sides keyed by one key (the planner's
    rewrite of a cascade of joins; ``MultiWayJoinSpec``).  Per fire
    (windowed mode) or per arriving batch (TTL mode) the per-key cross
    product across ALL sides expands directly from the sides' sorted runs
    — no pairwise intermediate is materialized, re-keyed or re-buffered.
    The sides are always partitioned join buffers on the operator's
    device: a TTL-mode probe of a hot partition runs ``join_probe`` and
    ``join_expand`` on its ring (``probe_positions``)."""

    def __init__(self, name: str, typ, ttl_micros: int, n_sides: int,
                 device: DeviceLike = None):
        super().__init__(name)
        self.device = resolve_device(device)
        self.typ = typ
        self.ttl = ttl_micros
        self.n_sides = n_sides
        if typ is not None:
            self.width, self.slide = _window_params(typ)
        else:
            self.width = self.slide = 0

    async def on_start(self, ctx: Context) -> None:
        # always partitioned: the N-ary probe needs sorted runs (the
        # checkpoint form is the same BATCH_BUFFER batch either way)
        retention = self.width if self.typ is not None else self.ttl
        self.bufs = [ctx.state.get_join_buffer(f"j{i}", f"join side {i}",
                                               retention,
                                               force_partitioned=True)
                     for i in range(self.n_sides)]

    @staticmethod
    def _expand(counts: List[np.ndarray]
                ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Cross-product expansion: for groups g with per-side match
        counts ``counts[i][g]``, (the group of each output row, each
        side's offset within the group's matches on that side)."""
        from ..ops.join import expand_counts

        m = counts[0].astype(np.int64).copy()
        for c in counts[1:]:
            m *= c
        gid, within = expand_counts(m)
        offs: List[np.ndarray] = [np.zeros(0, np.int64)] * len(counts)
        stride = np.ones(len(m), dtype=np.int64)
        for i in range(len(counts) - 1, -1, -1):
            ci = np.maximum(counts[i].astype(np.int64), 1)
            offs[i] = (within // stride[gid]) % ci[gid]
            stride = stride * ci
        return gid, offs

    @staticmethod
    def _emit_sides(side_rows: List[Batch], end: int) -> Batch:
        """The joined output left to right: side 0 plays the left role
        (it carries the join-key columns), every later side folds in
        through the pairwise join's layout normalization."""
        key_names = tuple(side_rows[0].key_cols)
        cols = dict(side_rows[0].columns)
        n = len(side_rows[0])
        for rows in side_rows[1:]:
            cols = _stable_join_part(cols, dict(rows.columns), n, key_names)
        return Batch(np.full(n, end - 1, dtype=np.int64), cols,
                     side_rows[0].key_hash, key_names)

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        if batch.key_hash is None:
            raise ValueError(f"{self.name} requires keyed inputs")
        # inner only: a null-keyed row can never match, so it is never
        # buffered
        batch = _drop_null_keyed(batch) if len(batch) else None
        if batch is None or not len(batch):
            return
        if self.typ is None:
            await self._probe_ttl(batch, side, ctx)
            self.bufs[side].append(batch)
            return
        self.bufs[side].append(batch)
        first_end = (batch.timestamp // self.slide + 1) * self.slide
        if isinstance(self.typ, SlidingWindow):
            ends = np.unique(np.concatenate([
                first_end + i * self.slide
                for i in range(self.width // self.slide)]))
        else:
            ends = np.unique(first_end - self.slide + self.width)
        for e in ends.tolist():
            ctx.timers.schedule(int(e), ("mw", int(e)))

    async def handle_timer(self, time: int, key: Any, payload: Any,
                           ctx: Context) -> None:
        end = key[1]
        start = end - self.width
        out_parts: List[Batch] = []
        for p in range(self.bufs[0].P):
            views = [b.parts[p].range_view(start, end) for b in self.bufs]
            if any(len(k) == 0 for k, _pos in views):
                continue
            # keys present on EVERY side (each view is key-sorted)
            uk = np.unique(views[0][0])
            for k, _pos in views[1:]:
                idx = np.searchsorted(k, uk)
                ok = idx < len(k)
                ok[ok] = k[idx[ok]] == uk[ok]
                uk = uk[ok]
                if not len(uk):
                    break
            if not len(uk):
                continue
            starts: List[np.ndarray] = []
            cnts: List[np.ndarray] = []
            for k, _pos in views:
                lo = np.searchsorted(k, uk, side="left")
                starts.append(lo)
                cnts.append(np.searchsorted(k, uk, side="right") - lo)
            gid, offs = self._expand(cnts)
            if not len(gid):
                continue
            side_rows = [self.bufs[i].gather(
                p * (1 << 48) + pos[starts[i][gid] + offs[i]])
                for i, (_k, pos) in enumerate(views)]
            out_parts.append(self._emit_sides(side_rows, end))
        if out_parts:
            out = (out_parts[0] if len(out_parts) == 1
                   else Batch.concat(out_parts))
            if len(out):
                await ctx.collect(out)
        evict_to = end - self.width + self.slide
        for b in self.bufs:
            b.evict_before(evict_to)

    async def _probe_ttl(self, batch: Batch, side: int,
                         ctx: Context) -> None:
        n = len(batch)
        kh = batch.key_hash
        sorter = np.argsort(kh, kind="stable")
        counts: List[np.ndarray] = []
        groups: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
        for i, buf in enumerate(self.bufs):
            if i == side:
                counts.append(np.ones(n, dtype=np.int64))
                groups.append(None)
                continue
            qidx, gpos = buf.probe_positions(kh[sorter])
            order = np.argsort(qidx, kind="stable")
            qidx, gpos = qidx[order], gpos[order]
            c = np.bincount(qidx, minlength=n)
            counts.append(c)
            groups.append((np.cumsum(c) - c, gpos))
        gid, offs = self._expand(counts)
        if not len(gid):
            return
        end = int(batch.timestamp.max()) + 1
        side_rows = []
        for i, buf in enumerate(self.bufs):
            if i == side:
                side_rows.append(batch.select(sorter[gid]))
            else:
                starts, gpos = groups[i]
                side_rows.append(buf.gather(gpos[starts[gid] + offs[i]]))
        out = self._emit_sides(side_rows, end)
        if len(out):
            await ctx.collect(out)

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        if self.typ is None:
            for b in self.bufs:
                b.evict_before(watermark - self.ttl)
        await ctx.broadcast(Message.wm(Watermark.event_time(watermark)))


class SemiJoinOperator(Operator):
    """The streaming semi join behind ``x IN (SELECT ...)``: a left row
    emits EXACTLY ONCE when a matching right key exists (now or later,
    within the TTLs), never once a right-side match.  Left rows without a
    match wait in the BATCH_BUFFER ``l``; the first sighting of a right
    key releases the waiting left rows of that key.  Right keys live in
    the KEYED table ``r`` with the time of their latest sighting (it
    never moves backward), expiring after the right TTL."""

    def __init__(self, name: str, left_ttl: int, right_ttl: int):
        super().__init__(name)
        self.left_ttl = left_ttl
        self.right_ttl = right_ttl

    def tables(self) -> List[TableDescriptor]:
        return [TableDescriptor("l", TableType.BATCH_BUFFER, "left pending",
                                retention_micros=self.left_ttl),
                TableDescriptor("r", TableType.KEYED, "right keys seen",
                                retention_micros=self.right_ttl)]

    async def on_start(self, ctx: Context) -> None:
        self.left = ctx.state.get_batch_buffer("l")
        self.rkeys = ctx.state.get_keyed_state("r")

    def _right_has(self, kh: np.ndarray) -> np.ndarray:
        uniq = np.unique(kh)
        known = np.array([self.rkeys.get(int(k)) is not None
                          for k in uniq], dtype=bool)
        return known[np.searchsorted(uniq, kh)]

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        if batch.key_hash is None:
            raise ValueError(f"{self.name} requires keyed inputs")
        if side == 0:  # left: emit the matches now, buffer the rest
            mask = self._right_has(batch.key_hash)
            if mask.any():
                await ctx.collect(batch.select(mask))
            if not mask.all():
                self.left.append(batch.select(~mask))
            return
        # right: refresh every key's time (a key seen continuously must
        # not expire off its first sighting; a late sighting must not
        # move it backward); first sightings release waiting left rows
        uniq, first = np.unique(batch.key_hash, return_index=True)
        fresh = np.array([self.rkeys.get(int(k)) is None for k in uniq],
                         dtype=bool)
        for k, i in zip(uniq.tolist(), first.tolist()):
            prev_t = self.rkeys.get_time(int(k))
            t = int(batch.timestamp[i])
            self.rkeys.insert(t if prev_t is None else max(t, prev_t),
                              int(k), True)
        if not fresh.any():
            return
        new_keys = uniq[fresh]
        pending = self.left.all()
        if pending is not None and len(pending):
            m = np.isin(pending.key_hash, new_keys)
            if m.any():
                await ctx.collect(pending.select(m))
                self.left.remove_keys(new_keys)

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        self.left.evict_before(watermark - self.left_ttl)
        for t, k, _v in self.rkeys.snapshot():
            if t < watermark - self.right_ttl:
                self.rkeys.remove(k)
        await ctx.broadcast(Message.wm(Watermark.event_time(watermark)))


# -- buffered windows -----------------------------------------------------------------


def _first_occurrence_cols(batch: Batch, uniq_keys: np.ndarray
                           ) -> Dict[str, np.ndarray]:
    """Key-column values for each unique key (first occurrence wins),
    aligned with the sorted ``uniq_keys``."""
    if not batch.key_cols:
        return {}
    order = np.argsort(batch.key_hash, kind="stable")
    _, first = np.unique(batch.key_hash[order], return_index=True)
    rows = order[first]
    return {c: batch.columns[c][rows] for c in batch.key_cols
            if c in batch.columns}


class WindowOperator(Operator):
    """A keyed tumbling, sliding or instant window over buffered rows
    (BATCH_BUFFER table ``w``): one timer a distinct window end; at the
    end, the window's rows are reduced per key by ``segment_aggregate``
    on the operator's device (the ``segment_agg`` kernel on the card),
    or emitted flat with the window's bounds."""

    def __init__(self, name: str, typ, aggs: Tuple[AggSpec, ...],
                 flatten: bool, projection=None, device: DeviceLike = None):
        super().__init__(name)
        self.device = resolve_device(device)
        self.typ = typ
        self.width, self.slide = _window_params(typ)
        self.aggs = aggs
        self.flatten = flatten or not aggs
        self.projection = (CompiledExpr(projection.name, projection.fn,
                                        self.device)
                           if projection else None)

    def tables(self) -> List[TableDescriptor]:
        return [TableDescriptor("w", TableType.BATCH_BUFFER, "window buffer",
                                retention_micros=self.width)]

    async def on_start(self, ctx: Context) -> None:
        self.buffer = ctx.state.get_batch_buffer("w")
        self._lat_pending: Optional[Tuple[int, float]] = None

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        assert batch.key_hash is not None
        self._lat_pending = _lat_track(self._lat_pending, batch)
        self.buffer.append(batch)
        # rows at ts belong to the windows ending at the slide-aligned
        # points in (ts, ts + width]
        first_end = (batch.timestamp // self.slide + 1) * self.slide
        if isinstance(self.typ, SlidingWindow):
            ends = np.unique(np.concatenate([
                first_end + i * self.slide
                for i in range(self.width // self.slide)]))
        else:
            ends = np.unique(first_end - self.slide + self.width)
        for e in ends.tolist():
            ctx.timers.schedule(int(e), ("w", int(e)))

    async def handle_timer(self, time: int, key: Any, payload: Any,
                           ctx: Context) -> None:
        end = key[1]
        start = end - self.width
        rows = self.buffer.query_range(start, end)
        if rows is not None and len(rows):
            if self.flatten:
                out_cols = dict(rows.columns)
                out_cols["window_start"] = np.full(len(rows), start, np.int64)
                out_cols["window_end"] = np.full(len(rows), end, np.int64)
                out = Batch(np.full(len(rows), end - 1, np.int64), out_cols,
                            rows.key_hash, rows.key_cols)
            else:
                uniq, agg_cols, _, _cnt, _vc = segment_aggregate(
                    rows.key_hash, rows.timestamp, rows.columns, self.aggs,
                    self.device)
                cols = _first_occurrence_cols(rows, uniq)
                cols["window_start"] = np.full(len(uniq), start, np.int64)
                cols["window_end"] = np.full(len(uniq), end, np.int64)
                cols.update(agg_cols)
                out = Batch(np.full(len(uniq), end - 1, np.int64), cols,
                            uniq.astype(np.uint64), rows.key_cols)
            out.lat_stamp = _lat_consume(self._lat_pending)
            self._lat_pending = None
            if self.projection is not None:
                out = eval_record_expr(self.projection, out)
            await ctx.collect(out)
        # rows no later window needs
        self.buffer.evict_before(end - self.width + self.slide)


# -- session windows ------------------------------------------------------------------


class SessionWindowOperator(Operator):
    """Session windows with gap merging.  Sessions live in the state's
    interval runs (state/session_state.py: one ``session_union`` dispatch
    per batch on the device) or, under ARROYO_SESSION_STATE=legacy, in
    per-key lists; buffered rows are aggregated per fired session by
    ``segment_aggregate`` (the ``segment_agg`` kernel on the device)."""

    def __init__(self, name: str, gap_micros: int, aggs: Tuple[AggSpec, ...],
                 flatten: bool, projection=None, device: DeviceLike = None):
        super().__init__(name)
        self.device = resolve_device(device)
        self.gap = gap_micros
        self.aggs = aggs
        self.flatten = flatten or not aggs
        self.projection = (CompiledExpr(projection.name, projection.fn,
                                        self.device)
                           if projection else None)
        self._pending_fires: List[Tuple[int, int, int]] = []
        self._min_end: Optional[int] = None  # no-fire fast-path bound

    def tables(self) -> List[TableDescriptor]:
        return [
            TableDescriptor("s", TableType.BATCH_BUFFER, "session data"),
            TableDescriptor("v", TableType.KEYED, "session windows per key"),
        ]

    async def on_start(self, ctx: Context) -> None:
        self.buffer = ctx.state.get_batch_buffer("s")
        # partition-adaptive sorted interval runs unless
        # ARROYO_SESSION_STATE=legacy; both layouts speak the KeyedState
        # interface, so the per-key clamp path below runs unchanged
        self.windows = ctx.state.get_session_state("v")
        self._device_state = isinstance(self.windows, SessionRunState)
        self._lat_pending: Optional[Tuple[int, float]] = None

    def _merge_key(self, kh: int, times: np.ndarray, ctx: Context) -> None:
        """handle_event extend/merge/create (windows.rs:232-302)."""
        sessions: List[Tuple[int, int]] = list(self.windows.get(kh) or [])
        for t in np.sort(times).tolist():
            placed = False
            for i, (s, e) in enumerate(sessions):
                if s - self.gap <= t < e:
                    ns, ne = min(s, t), max(e, t + self.gap)
                    if ne - ns > MAX_SESSION_SIZE_MICROS:
                        ne = ns + MAX_SESSION_SIZE_MICROS
                    sessions[i] = (ns, ne)
                    placed = True
                    break
            if not placed:
                sessions.append((t, t + self.gap))
            # merge overlapping sessions
            sessions.sort()
            merged: List[Tuple[int, int]] = []
            for s, e in sessions:
                if merged and s <= merged[-1][1]:
                    ps, pe = merged[-1]
                    merged[-1] = (ps, max(pe, e))
                else:
                    merged.append((s, e))
            sessions = merged
        self.windows.insert(int(times.max()), kh, sessions)
        if sessions:
            me = min(e for _, e in sessions)
            if self._min_end is not None and me < self._min_end:
                self._min_end = me

    async def process_batch(self, batch: Batch, ctx: Context, side: int = 0) -> None:
        if batch.key_hash is None:
            raise ValueError(f"{self.name} requires keyed input")
        self._lat_pending = _lat_track(self._lat_pending, batch)
        self.buffer.append(batch)
        # collapse events -> candidate session intervals for the WHOLE
        # batch in three vector ops (events within gap of their
        # predecessor merge, so a burst becomes ONE interval): the
        # per-key python work then scales with interval count, not event
        # count (windows.rs:232-302 semantics)
        order = np.lexsort((batch.timestamp, batch.key_hash))
        kh = batch.key_hash[order]
        ts = batch.timestamp[order]
        n = len(kh)
        newkey = np.empty(n, dtype=bool)
        newkey[0] = True
        newkey[1:] = kh[1:] != kh[:-1]
        brk = newkey.copy()
        brk[1:] |= (ts[1:] - ts[:-1]) > self.gap
        ist = ts[brk]                      # interval starts
        ien = ts[np.append(brk[1:], True)] + self.gap  # last of group + gap
        ikh = kh[brk]
        kb = newkey[brk].nonzero()[0]      # key boundaries among intervals
        kb = np.append(kb, len(ikh))
        span_ok = (ien - ist) <= MAX_SESSION_SIZE_MICROS
        key_starts = np.append(newkey.nonzero()[0], n)
        if self._device_state:
            await self._merge_batch_device(kh, ts, ikh, ist, ien, kb,
                                           span_ok, key_starts, ctx)
            return
        _count_merge(0, n)  # legacy layout: every event merges on host
        for i in range(len(kb) - 1):
            k = int(ikh[kb[i]])
            lo, hi = kb[i], kb[i + 1]
            if not span_ok[lo:hi].all() or not self._merge_key_intervals(
                    k, ist[lo:hi].tolist(), ien[lo:hi].tolist(),
                    int(ts[key_starts[i + 1] - 1]), ctx):
                # a burst longer than MAX_SESSION_SIZE, or a merge that
                # would clamp-truncate past an incoming interval's end
                # (events beyond the clamp must START a new session, and
                # only the per-event path knows their positions): rare —
                # the incremental-clamp-splitting path is authoritative
                self._merge_key(k, ts[key_starts[i]:key_starts[i + 1]],
                                ctx)

    async def _merge_batch_device(self, kh, ts, ikh, ist, ien, kb,
                                  span_ok, key_starts, ctx: Context) -> None:
        """Device-state merge: ONE vectorized interval-union dispatch
        covers every in-bounds key; keys the clamp touches (overlong
        bursts, or merged spans crossing MAX_SESSION_SIZE) re-run the
        authoritative per-key path against the same state object — the
        device/host row split is counted."""
        nkeys = len(kb) - 1
        # per-interval key ordinal + per-key last event time (the KEYED
        # snapshot time column, matching the legacy insert(max_t, ...))
        key_maxt = ts[key_starts[1:] - 1]
        counts = np.diff(kb)
        itm = np.repeat(key_maxt, counts)
        # keys with an overlong burst go straight to the per-event path:
        # only it knows the event positions past the clamp
        key_ord = np.repeat(np.arange(nkeys), counts)
        bad = np.unique(key_ord[~span_ok])
        good_iv = ~np.isin(key_ord, bad)
        flagged = self.windows.merge_intervals(
            ikh[good_iv], ist[good_iv], ien[good_iv], itm[good_iv])
        if len(bad) or len(flagged):
            keys_arr = ikh[kb[:-1]]  # sorted ascending (lexsort by key)
            fb = set(bad.tolist())
            if len(flagged):
                fb.update(np.searchsorted(keys_arr, flagged).tolist())
            host_events = 0
            for i in sorted(fb):
                lo, hi = key_starts[i], key_starts[i + 1]
                host_events += int(hi - lo)
                self._merge_key(int(keys_arr[i]), ts[lo:hi], ctx)
            _count_merge(0, host_events)
        # exact no-fire bound straight off the runs (cheap: P partition
        # minima), replacing the legacy conservative tracking
        self._min_end = self.windows.min_end()

    def _merge_key_intervals(self, kh: int, ists: List[int],
                             iens: List[int], max_t: int,
                             ctx: Context) -> bool:
        """Union sorted candidate intervals into the key's sorted session
        list — linear two-pointer sweep with the same touching-merges and
        incremental max-size clamp as the per-event path.  Returns False
        WITHOUT touching state when a clamp would truncate below a
        contributing interval's end (events past the clamp would be
        silently swallowed; the caller re-runs the per-event path)."""
        old: List[Tuple[int, int]] = list(self.windows.get(kh) or [])
        merged: List[Tuple[int, int]] = []
        i = j = 0
        no, ni = len(old), len(ists)
        while i < no or j < ni:
            if i < no and (j >= ni or old[i][0] <= ists[j]):
                s, e = old[i]
                i += 1
            else:
                s, e = ists[j], iens[j]
                j += 1
            if merged and s <= merged[-1][1]:
                ps, pe = merged[-1]
                ne = max(pe, e)
                if ne - ps > MAX_SESSION_SIZE_MICROS:
                    if ps + MAX_SESSION_SIZE_MICROS < e:
                        return False  # clamp would swallow interval tail
                    ne = ps + MAX_SESSION_SIZE_MICROS
                merged[-1] = (ps, ne)
            else:
                if e - s > MAX_SESSION_SIZE_MICROS:
                    return False  # guarded by span_ok; belt-and-braces
                merged.append((s, e))
        self.windows.insert(max_t, kh, merged if merged != old else old)
        if merged:
            # keep the no-fire fast-path bound conservative: a fresh
            # short session may end before the cached minimum
            me = min(e for _, e in merged)
            if self._min_end is not None and me < self._min_end:
                self._min_end = me
        return True

    def _collect_expired(self, watermark: int, ctx: Context) -> None:
        """Move every session with end <= watermark into the pending-fire
        list.  Event-time timers only ever fire on watermark advance, so
        scanning the (bounded, active) per-key session map at each
        watermark is equivalent to a per-session timer heap — without
        the heap churn of cancel/reschedule on every batch that extends
        a session.  A min-end bound skips the scan entirely while nothing
        can fire (many dormant keys, slowly advancing watermark)."""
        if self._min_end is not None and watermark < self._min_end:
            return
        if self._device_state:
            # mask-compress every closed session out of the runs in one
            # vector pass per partition — no key iteration
            fk, fs, fe, removed = self.windows.expire(watermark)
            self._pending_fires.extend(
                zip((int(k) for k in fk.tolist()), fs.tolist(),
                    fe.tolist()))
            for kh in removed:
                ctx.state.note_delete("v", kh)
            self._min_end = self.windows.min_end()
            return
        expired_keys = []
        min_end = None
        for kh, sessions in self.windows.items():
            fire = [(s, e) for (s, e) in sessions if e <= watermark]
            if not fire:
                for (_s, e) in sessions:
                    if min_end is None or e < min_end:
                        min_end = e
                continue
            remain = [(s, e) for (s, e) in sessions if e > watermark]
            if remain:
                self.windows.insert(watermark, kh, remain)
                for (_s, e) in remain:
                    if min_end is None or e < min_end:
                        min_end = e
            else:
                expired_keys.append(kh)
            self._pending_fires.extend((int(kh), s, e) for (s, e) in fire)
        for kh in expired_keys:
            self.windows.remove(kh)
            ctx.state.note_delete("v", kh)
        self._min_end = min_end

    async def _flush_fires(self, ctx: Context) -> None:
        fires = self._pending_fires
        if not fires:
            return
        self._pending_fires = []
        rows = self.buffer.query_range(min(s for _, s, _ in fires),
                                       max(e for _, _, e in fires))
        if rows is None or not len(rows):
            return
        # assign every buffered row to its fired session in ONE combined
        # sweep: sessions (as start events) and rows merge-sort by
        # (key, time, starts-first); a running count of starts gives each
        # row the global index of the latest session start at-or-before
        # it — valid iff that session shares the row's key and the row
        # precedes its end.  No per-key python, no buffer argsort.
        m = len(fires)
        fk = np.array([k for k, _, _ in fires], dtype=np.uint64)
        fs = np.array([s for _, s, _ in fires], dtype=np.int64)
        fe = np.array([e for _, _, e in fires], dtype=np.int64)
        fo = np.lexsort((fs, fk))
        fk, fs, fe = fk[fo], fs[fo], fe[fo]
        n = len(rows)
        all_kh = np.concatenate([fk, rows.key_hash])
        all_t = np.concatenate([fs, rows.timestamp])
        prio = np.concatenate([np.zeros(m, np.int8), np.ones(n, np.int8)])
        o = np.lexsort((prio, all_t, all_kh))
        started = np.cumsum(o < m)
        pos = np.empty(m + n, dtype=np.int64)
        pos[o] = np.arange(m + n)
        si = started[pos[m:]] - 1  # per row: global session ordinal
        sic = np.clip(si, 0, m - 1)
        ok = ((si >= 0) & (fk[sic] == rows.key_hash)
              & (rows.timestamp < fe[sic]))
        if not ok.any():
            return
        sel = ok.nonzero()[0]
        segs = sic[sel].astype(np.uint64)
        sub = rows.select(sel)
        seg_kh_a, seg_s_a, seg_e_a = fk, fs, fe

        if self.flatten:
            si = segs.astype(np.int64)
            cols = dict(sub.columns)
            cols["window_start"] = seg_s_a[si]
            cols["window_end"] = seg_e_a[si]
            out = Batch(seg_e_a[si] - 1, cols, sub.key_hash, sub.key_cols)
        else:
            uniq, agg_cols, _, _cnt, _vc = segment_aggregate(
                segs, sub.timestamp, sub.columns, self.aggs, self.device)
            ui = uniq.astype(np.int64)
            # key columns: first row of each emitted segment
            cols: Dict[str, np.ndarray] = {}
            if sub.key_cols:
                so = np.argsort(segs, kind="stable")
                seg_sorted = segs[so]
                _, first = np.unique(seg_sorted, return_index=True)
                first_rows = so[first]  # aligned with sorted uniq
                cols = {c: sub.columns[c][first_rows] for c in sub.key_cols
                        if c in sub.columns}
            cols["window_start"] = seg_s_a[ui]
            cols["window_end"] = seg_e_a[ui]
            cols.update(agg_cols)
            out = Batch(seg_e_a[ui] - 1, cols, seg_kh_a[ui], sub.key_cols)
        out.lat_stamp = _lat_consume(self._lat_pending)
        self._lat_pending = None
        if self.projection is not None:
            out = eval_record_expr(self.projection, out)
        await ctx.collect(out)

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        with tracing.span("window.session_fire", "window",
                          tid=tracing.ctx_tid(ctx),
                          args={"watermark": int(watermark)}):
            self._collect_expired(watermark, ctx)
            await self._flush_fires(ctx)
        # evict data older than every live session start
        if self._device_state:
            ls = self.windows.min_live_start()
        else:
            live_starts = [s for _, sessions in self.windows.items()
                           for (s, _) in sessions]
            ls = min(live_starts) if live_starts else None
        self.buffer.evict_before(
            ls if ls is not None else watermark - MAX_SESSION_SIZE_MICROS)
        await ctx.broadcast(Message.wm(Watermark.event_time(watermark)))


# -- the non-windowed (updating) aggregate ---------------------------------------------


def _is_null(v) -> bool:
    """SQL NULL as ``segment_aggregate`` gives it: None or a float NaN."""
    return v is None or (isinstance(v, (float, np.floating)) and np.isnan(v))


class NonWindowAggOperator(Operator):
    """Running per-key aggregates over a keyed stream with a TTL (KEYED
    table ``u``): each batch is reduced per key by ``segment_aggregate``
    on the operator's device (the ``segment_agg`` kernel on the card),
    merged into the keys' running records and emitted as CREATE/UPDATE
    rows (``__op``).  AVG is kept mergeable as ``<out>__sum`` and
    ``<out>__cnt``.

    With ``flush_key`` (GROUP BY the window of a windowed input, q5's
    per-window maximum) refinements consolidate in state, with the key
    columns (``__kc::<col>``), and each key emits its final row once,
    when the watermark reaches the ``flush_key`` column: upstream panes
    always precede the watermark that releases them, so the output is
    append-only.  A record re-created for a window at or below the
    highest released watermark is a late refinement and is dropped, also
    after a restore (the guard re-arms from the checkpoint's
    watermark)."""

    def __init__(self, name: str, expiration_micros: int,
                 aggs: Tuple[AggSpec, ...], projection=None,
                 flush_key: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(name)
        self.device = resolve_device(device)
        self.expiration = expiration_micros
        self.aggs = aggs
        self.flush_key = flush_key
        self._released_wm: Optional[int] = None
        self.projection = (CompiledExpr(projection.name, projection.fn,
                                        self.device)
                           if projection else None)

    def tables(self) -> List[TableDescriptor]:
        return [TableDescriptor("u", TableType.KEYED, "running aggregates",
                                retention_micros=self.expiration)]

    async def on_start(self, ctx: Context) -> None:
        self.table = ctx.state.get_keyed_state("u")
        # every window at or below the checkpoint's watermark was released
        # before the checkpoint (the flush runs ahead of the watermark's
        # broadcast, so ahead of the barrier)
        if ctx.last_watermark is not None:
            self._released_wm = ctx.last_watermark

    def _merge(self, a: AggSpec, new, nv: int, prev, merged: Dict) -> None:
        """Merge one key's batch result ``new`` (``nv`` non-null rows)
        into its running record ``prev`` (None for a new key)."""
        out = a.output
        new_null = _is_null(new)
        if a.kind == AggKind.AVG:
            new_sum = 0.0 if new_null else float(new) * nv
            merged[f"{out}__sum"] = (
                (prev[f"{out}__sum"] if prev else 0.0) + new_sum)
            merged[f"{out}__cnt"] = (prev[f"{out}__cnt"] if prev else 0) + nv
            cnt = merged[f"{out}__cnt"]
            merged[out] = (merged[f"{out}__sum"] / cnt if cnt
                           else float("nan"))
            return
        if prev is None:
            merged[out] = new
            return
        old = prev[out]
        if new_null:
            merged[out] = old
        elif _is_null(old):
            merged[out] = new
        elif a.kind in (AggKind.SUM, AggKind.COUNT):
            merged[out] = old + new
        elif a.kind == AggKind.MAX:
            merged[out] = max(old, new)
        elif a.kind == AggKind.MIN:
            merged[out] = min(old, new)

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        assert batch.key_hash is not None
        uniq, agg_cols, max_ts, _rows, valid_counts = segment_aggregate(
            batch.key_hash, batch.timestamp, batch.columns, self.aggs,
            self.device)
        key_cols = _first_occurrence_cols(batch, uniq)
        ops = np.zeros(len(uniq), dtype=np.int8)
        out_cols: Dict[str, List] = {a.output: [] for a in self.aggs}
        for i, k in enumerate(uniq.tolist()):
            prev = self.table.get(k)
            merged: Dict[str, Any] = {}
            for a in self.aggs:
                nv = (int(valid_counts[a.output][i])
                      if a.kind == AggKind.AVG else 0)
                self._merge(a, agg_cols[a.output][i], nv, prev, merged)
                out_cols[a.output].append(merged[a.output])
            ops[i] = (UpdateOp.CREATE.value if prev is None
                      else UpdateOp.UPDATE.value)
            if self.flush_key is not None:
                # the key columns stay in state, so a restored operator
                # can still emit the window's row
                for c, arr in key_cols.items():
                    merged[f"__kc::{c}"] = arr[i]
            self.table.insert(int(max_ts[i]), k, merged)
        if self.flush_key is not None:
            return  # emitted when the watermark passes the window
        cols = dict(key_cols)
        for a in self.aggs:
            arr = np.asarray(out_cols[a.output])
            if a.kind == AggKind.COUNT:
                arr = arr.astype(np.int64)
            cols[a.output] = arr
        cols[UPDATE_OP_COLUMN] = ops
        out = Batch(max_ts, cols, uniq.astype(np.uint64), batch.key_cols)
        if self.projection is not None:
            out = eval_record_expr(self.projection, out)
        await ctx.collect(out)

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        if self.flush_key is not None:
            perf.count("nonwindow_flushes")
            with tracing.span("window.flush_ready", "window",
                              tid=tracing.ctx_tid(ctx),
                              args={"watermark": int(watermark)}):
                await self._flush_ready(watermark, ctx)
        await ctx.broadcast(Message.wm(Watermark.event_time(watermark)))

    async def _flush_ready(self, watermark: int, ctx: Context) -> None:
        fk = f"__kc::{self.flush_key}"
        ready = []
        for t, k, rec in list(self.table.snapshot()):
            bound = rec.get(fk)
            # an integer comparison: window ends are epoch micros above
            # 2^53, where a float could round down and release a window
            # before its last pane arrives
            if bound is None or int(bound) <= watermark:
                if (bound is not None and self._released_wm is not None
                        and int(bound) <= self._released_wm):
                    # a late re-creation of a released window: its final
                    # row already went downstream
                    self.table.remove(k)
                    continue
                ready.append((t, k, rec))
        self._released_wm = (watermark if self._released_wm is None
                             else max(self._released_wm, watermark))
        if not ready:
            return
        perf.count("nonwindow_flush_rows", len(ready))
        ts = np.array([t for t, _, _ in ready], dtype=np.int64)
        kh = np.array([k for _, k, _ in ready], dtype=np.uint64)
        kc_names = [n[len("__kc::"):] for n in ready[0][2]
                    if n.startswith("__kc::")]
        cols: Dict[str, np.ndarray] = {}
        for c in kc_names:
            cols[c] = np.asarray([rec[f"__kc::{c}"] for _, _, rec in ready])
        for a in self.aggs:
            arr = np.asarray([rec[a.output] for _, _, rec in ready])
            if a.kind == AggKind.COUNT:
                arr = arr.astype(np.int64)
            cols[a.output] = arr
        for _, k, _ in ready:
            self.table.remove(k)
        out = Batch(ts, cols, kh, tuple(kc_names))
        if self.projection is not None:
            out = eval_record_expr(self.projection, out)
        await ctx.collect(out)


# -- builder registration -----------------------------------------------------------


@register_builder(OpKind.SLIDING_WINDOW_AGGREGATOR)
def _build_sliding(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    return BinAggOperator(op.name, s.width_micros, s.slide_micros, s.aggs,
                          s.projection, argmax_local=s.argmax_local,
                          device=device)


@register_builder(OpKind.TUMBLING_WINDOW_AGGREGATOR)
def _build_tumbling(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    return BinAggOperator(op.name, s.width_micros, s.width_micros, s.aggs,
                          s.projection, argmax_local=s.argmax_local,
                          device=device)


@register_builder(OpKind.WINDOW_FACTOR)
def _build_window_factor(op: LogicalOperator, device: DeviceLike
                         ) -> Operator:
    s = op.spec
    return FactorPaneOperator(op.name, s.pane_micros, s.aggs, device=device)


@register_builder(OpKind.DERIVED_WINDOW)
def _build_derived_window(op: LogicalOperator, device: DeviceLike
                          ) -> Operator:
    s = op.spec
    return DerivedWindowOperator(op.name, s.width_micros, s.slide_micros,
                                 s.pane_micros, s.aggs, s.projection,
                                 device=device)


@register_builder(OpKind.SLIDING_AGGREGATING_TOP_N)
def _build_sliding_topn(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    return BinAggOperator(op.name, s.width_micros, s.slide_micros, s.aggs,
                          s.projection,
                          top_n=(s.partition_cols, s.sort_column,
                                 s.max_elements), device=device)


@register_builder(OpKind.TUMBLING_TOP_N)
def _build_topn(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    return TumblingTopNOperator(op.name, s.width_micros, s.max_elements,
                                s.sort_column, s.partition_cols, s.projection,
                                s.rank_column, device)


@register_builder(OpKind.WINDOW)
def _build_window(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    if isinstance(s.typ, SessionWindow):
        return SessionWindowOperator(op.name, s.typ.gap_micros, s.aggs,
                                     s.flatten, s.projection, device)
    return WindowOperator(op.name, s.typ, s.aggs, s.flatten, s.projection,
                          device)


@register_builder(OpKind.WINDOW_ARGMAX)
def _build_window_argmax(op: LogicalOperator, device: DeviceLike
                         ) -> Operator:
    s = op.spec
    return WindowArgmaxOperator(op.name, s.value_col, s.minmax, s.synth_cols,
                                s.width_micros, s.raw, s.late_ttl_micros)


@register_builder(OpKind.WINDOW_JOIN)
def _build_window_join(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    return WindowJoinOperator(op.name, s.typ, s.join_type, s.left_cols,
                              s.right_cols, device)


@register_builder(OpKind.JOIN_WITH_EXPIRATION)
def _build_join_exp(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    if s.join_type == JoinType.SEMI:
        return SemiJoinOperator(op.name, s.left_expiration_micros,
                                s.right_expiration_micros)
    return JoinWithExpirationOperator(op.name, s.left_expiration_micros,
                                      s.right_expiration_micros, s.join_type,
                                      s.left_cols, s.right_cols, device)


@register_builder(OpKind.MULTI_WAY_JOIN)
def _build_multi_way_join(op: LogicalOperator, device: DeviceLike
                          ) -> Operator:
    s = op.spec
    return MultiWayJoinOperator(op.name, s.typ, s.ttl_micros,
                                len(s.side_cols), device)


@register_builder(OpKind.NON_WINDOW_AGGREGATOR)
def _build_nonwindow(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    return NonWindowAggOperator(op.name, s.expiration_micros, s.aggs,
                                s.projection, s.flush_key, device)
