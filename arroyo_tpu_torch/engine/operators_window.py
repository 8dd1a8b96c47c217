"""Windowed keyed-state operators on the device (port of
``BinAggOperator`` and ``WindowArgmaxOperator`` from
``arroyo_tpu.engine.operators_window``).

* :class:`BinAggOperator` — sliding/tumbling two-phase window aggregate
  over :class:`~arroyo_tpu_torch.ops.keyed_bins.KeyedBinState`; panes are
  emitted on watermark advance by one device pass over all pending panes.
* :class:`WindowArgmaxOperator` — the fused per-window argmax stage that
  consumes the aggregate's (pre-filtered) panes and settles the global
  answer."""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from ..graph.logical import AggSpec, ColumnExpr, LogicalOperator, OpKind
from ..ops.expr import CompiledExpr, eval_record_expr
from ..ops.keyed_bins import KeyedBinState, filter_canonical_snapshot
from ..state.tables import DeviceTable, TableDescriptor, TableType
from ..types import MAX_TIMESTAMP, Batch, Message, Watermark
from .build import register_builder
from .context import Context
from .operator import Operator


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
                 device: DeviceLike = None):
        super().__init__(name)
        self.width = width_micros
        self.slide = slide_micros
        self.aggs = aggs
        self.state = KeyedBinState(aggs, slide_micros, width_micros,
                                   device=device)
        if argmax_local is not None:
            # emission pre-filters to local per-pane argmax candidates
            self.state.set_argmax_local(*argmax_local)
        self.keyvals = _SlotKeyValues()
        self.projection = (CompiledExpr(projection.name, projection.fn)
                           if projection else None)
        self._key_cols: Tuple[str, ...] = ()

    def _offload_transfers(self) -> bool:
        """Run device update/emit in an executor thread when the state
        lives on an accelerator, so host<->device copies and the fire's
        sync do not hold the event loop; on the CPU the thread hop is
        pure overhead."""
        return self.state.device.type != "cpu"

    async def on_start(self, ctx: Context) -> None:
        def snap():
            return self.state.snapshot() | self.keyvals.snapshot()

        def restore(arrays, _kr=ctx.task_info.key_range):
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
        self._key_cols = batch.key_cols
        prev = self.state.next_slot
        slots = self.state._lookup_or_insert(batch.key_hash)
        self.keyvals.ensure(batch, slots, prev, self.state.next_slot)
        # safe to offload: this operator's messages are processed serially
        if self._offload_transfers():
            await asyncio.get_running_loop().run_in_executor(
                None, self.state.update, batch.key_hash, batch.timestamp,
                batch.columns)
        else:
            self.state.update(batch.key_hash, batch.timestamp, batch.columns)

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        final = watermark >= int(MAX_TIMESTAMP) - 1
        if self._offload_transfers():
            fired = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.state.fire_panes(watermark, final=final))
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
        out = Batch(ts, cols, keys.astype(np.uint64), key_cols)
        if self.projection is not None:
            out = eval_record_expr(self.projection, out)
        await ctx.collect(out)


class WindowArgmaxOperator(Operator):
    """Fused ``A JOIN (SELECT max(x), window FROM A GROUP BY window)``:
    rows arrive keyed by window, buffer per window until the watermark
    passes, then emit exactly the rows achieving the window's max/min of
    ``value_col`` (ties included) plus the pruned side's synthesized
    columns.  Sound at any upstream parallelism: every global argmax row
    is also a local argmax row upstream."""

    def __init__(self, name: str, value_col: str, minmax: str,
                 synth_cols: Tuple[Tuple[str, str], ...], width_micros: int):
        super().__init__(name)
        self.value_col = value_col
        self.minmax = minmax
        self.synth_cols = synth_cols
        self.width = max(int(width_micros), 1)
        self._released_wm: Optional[int] = None

    def tables(self) -> List[TableDescriptor]:
        return [TableDescriptor("b", TableType.BATCH_BUFFER,
                                "per-window candidate rows",
                                retention_micros=self.width)]

    async def on_start(self, ctx: Context) -> None:
        self.buf = ctx.state.get_batch_buffer("b")
        if ctx.last_watermark is not None:
            # windows at or below the checkpoint watermark fired before
            # the restore
            self._released_wm = ctx.last_watermark

    async def _emit(self, rows: Batch, ctx: Context) -> None:
        cols = dict(rows.columns)
        for out_name, src in self.synth_cols:
            cols[out_name] = cols[src]
        await ctx.collect(Batch(rows.timestamp, cols, rows.key_hash,
                                rows.key_cols))

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        self.buf.append(batch)
        # one timer per distinct window end; aggregate rows stamp
        # timestamp = window_end - 1
        for e in np.unique(np.asarray(batch.columns["window_end"],
                                      dtype=np.int64)).tolist():
            ctx.timers.schedule(int(e), ("am", int(e)))

    async def handle_timer(self, time: int, key: Any, payload: Any,
                           ctx: Context) -> None:
        end = key[1]
        rows = self.buf.query_range(end - 1, end)  # ts == end - 1
        self.buf.evict_before(end)
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
        await self._emit(rows.select(np.nonzero(valid & (vals == best))[0]),
                         ctx)


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


@register_builder(OpKind.WINDOW_ARGMAX)
def _build_window_argmax(op: LogicalOperator, device: DeviceLike
                         ) -> Operator:
    s = op.spec
    return WindowArgmaxOperator(op.name, s.value_col, s.minmax, s.synth_cols,
                                s.width_micros)
