"""Element-wise and per-key running operators and the periodic watermark
generator (port of ``arroyo_tpu.engine.operators_basic``): map, filter
and option-map, UDF, flat-map and flatten, union, key_by and the global
key, the running count and the running MAX/MIN/SUM."""

from __future__ import annotations

import asyncio
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..graph.logical import (AggKind, AggSpec, ColumnExpr, ExprReturnType,
                             PeriodicWatermarkSpec)
from ..obs import tracing
from ..ops.expr import CompiledExpr, eval_host_expr, eval_predicate, eval_record_expr
from ..state.tables import TableDescriptor, TableType
from ..types import MAX_TIMESTAMP, Batch, Message, Watermark, now_micros
from .context import Context
from .operator import Operator


class ExpressionOperator(Operator):
    """Map / Filter / OptionMap over a batch via a column expression; a
    SQL-compiled expression runs on the expression device (ops/expr.py),
    a Stream-API function on the host."""

    def __init__(self, name: str, expr: ColumnExpr, device: torch.device):
        super().__init__(name)
        self.compiled = CompiledExpr(expr.name, expr.fn, device)
        self.return_type = expr.return_type

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        if self.return_type == ExprReturnType.PREDICATE:
            mask = eval_predicate(self.compiled, batch)
            if mask.any():
                await ctx.collect(batch.select(mask))
        elif self.return_type == ExprReturnType.RECORD:
            await ctx.collect(eval_record_expr(self.compiled, batch))
        else:  # OPTIONAL_RECORD: the record's '__valid' column selects rows
            out = eval_record_expr(self.compiled, batch)
            if "__valid" in out.columns:
                mask = out.columns.pop("__valid").astype(bool)
                out = out.select(mask)
            await ctx.collect(out)


class UdfOperator(Operator):
    """Python function over the raw batch."""

    def __init__(self, name: str, expr: ColumnExpr):
        super().__init__(name)
        self.fn = expr.fn

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        await ctx.collect(eval_host_expr(self.fn, batch))


class UnionOperator(Operator):
    """UNION ALL: batches from every input pass through unchanged; the
    runner's watermark holder takes the minimum over the inputs."""

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        await ctx.collect(batch)


class FlattenOperator(Operator):
    """Expands the list-valued column ``list_col`` into one row a list
    element (the row's other columns repeated)."""

    def __init__(self, name: str, list_col: str = "__flatten"):
        super().__init__(name)
        self.list_col = list_col

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        col = batch.columns.get(self.list_col)
        if col is None:
            await ctx.collect(batch)
            return
        lengths = np.fromiter((len(x) for x in col), dtype=np.int64,
                              count=len(col))
        idx = np.repeat(np.arange(len(col)), lengths)
        flat = (np.concatenate([np.asarray(x) for x in col if len(x)])
                if lengths.sum() else np.zeros(0))
        out = batch.select(idx)
        out.columns[self.list_col] = flat
        await ctx.collect(out)


class FlatMapOperator(Operator):
    """A host record function producing a list column, then flattened."""

    def __init__(self, name: str, expr: ColumnExpr,
                 list_col: str = "__flatten"):
        super().__init__(name)
        self.fn = expr.fn
        self.flatten = FlattenOperator(name + "_flatten", list_col)

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        await self.flatten.process_batch(eval_host_expr(self.fn, batch),
                                         ctx, side)


class KeyByOperator(Operator):
    """Re-key the stream: computes the composite key hash for routing."""

    def __init__(self, name: str, key_cols: tuple):
        super().__init__(name)
        self.key_cols = key_cols

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        await ctx.collect(batch.with_key(list(self.key_cols)))


class GlobalKeyOperator(Operator):
    """Routes every row to one key (hash 0, key column ``__global``): a
    windowed aggregate without GROUP BY keys."""

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        kh = np.zeros(len(batch), dtype=np.uint64)
        await ctx.collect(Batch(batch.timestamp, dict(batch.columns), kh,
                                ("__global",)))


class WatermarkOperator(Operator):
    """Periodic watermark generator: watermark = max(event_time) -
    max_lateness, emitted after each batch; Idle when no data arrives for
    idle_time; upstream final watermarks pass through."""

    def __init__(self, name: str, spec: PeriodicWatermarkSpec):
        super().__init__(name)
        self.spec = spec
        self.max_ts: Optional[int] = None
        self.last_emitted: Optional[int] = None
        self.last_data_wall: float = _time.monotonic()
        self._last_trace_wall: float = 0.0
        self._idle_task: Optional[asyncio.Task] = None
        self._expr_fn = spec.expression.fn if spec.expression else None

    async def on_start(self, ctx: Context) -> None:
        if self.spec.idle_time_micros:
            self._idle_task = asyncio.ensure_future(self._idle_loop(ctx))

    async def _idle_loop(self, ctx: Context) -> None:
        idle_s = self.spec.idle_time_micros / 1e6
        while True:
            await asyncio.sleep(1.0)
            if _time.monotonic() - self.last_data_wall > idle_s:
                await ctx.broadcast(Message.wm(Watermark.idle()))

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        self.last_data_wall = _time.monotonic()
        if self._expr_fn is not None:
            out = eval_host_expr(self._expr_fn, batch)
            ts_max = int(np.max(out.timestamp)) if len(out) else None
        else:
            ts_max = int(np.max(batch.timestamp)) if len(batch) else None
        if ts_max is not None:
            self.max_ts = (ts_max if self.max_ts is None
                           else max(self.max_ts, ts_max))
        await ctx.collect(batch)
        if self.max_ts is not None:
            wm = self.max_ts - self.spec.max_lateness_micros
            if self.last_emitted is None or wm > self.last_emitted:
                self.last_emitted = wm
                # flight-recorder tap: the assigner's watermark is the
                # origin every downstream lag follows; at most 10/s an
                # operator, so the bounded span ring keeps its rarer spans
                wall = _time.monotonic()
                if wall - self._last_trace_wall >= 0.1:
                    self._last_trace_wall = wall
                    tracing.instant(
                        "watermark.emit", "watermark",
                        tid=tracing.ctx_tid(ctx),
                        args={"watermark": int(wm),
                              "lag_s": round((now_micros() - wm) / 1e6, 4)})
                await ctx.broadcast(Message.wm(Watermark.event_time(wm)))

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        # upstream watermarks (incl. the source's final MAX) pass through
        if watermark >= int(MAX_TIMESTAMP) - self.spec.max_lateness_micros:
            await ctx.broadcast(
                Message.wm(Watermark.event_time(int(MAX_TIMESTAMP))))

    async def on_close(self, ctx: Context) -> None:
        if self._idle_task:
            self._idle_task.cancel()


class CountOperator(Operator):
    """A running count a key over a keyed stream: each batch emits one
    row a key it holds, with the key's new count (KEYED table ``c``)."""

    def __init__(self, name: str):
        super().__init__(name)
        self.counts: Dict[int, int] = {}

    def tables(self) -> List[TableDescriptor]:
        return [TableDescriptor("c", TableType.KEYED, "counts")]

    async def on_start(self, ctx: Context) -> None:
        t = ctx.state.get_keyed_state("c")
        self.counts = {k: v for k, v in t.items()}

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        if batch.key_hash is None:
            return
        t = ctx.state.get_keyed_state("c")
        keys, cnt = np.unique(batch.key_hash, return_counts=True)
        out_counts = np.zeros(len(keys), dtype=np.int64)
        ts = int(np.max(batch.timestamp))
        for i, (k, c) in enumerate(zip(keys.tolist(), cnt.tolist())):
            nc = self.counts.get(k, 0) + c
            self.counts[k] = nc
            out_counts[i] = nc
            t.insert(ts, k, nc)
        await ctx.collect(Batch(np.full(len(keys), ts, dtype=np.int64),
                                {"count": out_counts},
                                keys.astype(np.uint64), batch.key_cols))


class AggregateOperator(Operator):
    """A running MAX, MIN or SUM a key in f64: each batch emits one row a
    key it holds, with the key's new value (KEYED table ``a``)."""

    _REDUCE = {AggKind.SUM: np.add, AggKind.MAX: np.maximum,
               AggKind.MIN: np.minimum}
    _MERGE = {AggKind.SUM: lambda a, b: a + b, AggKind.MAX: max,
              AggKind.MIN: min}

    def __init__(self, name: str, agg: AggSpec):
        super().__init__(name)
        if agg.kind not in self._REDUCE:
            raise ValueError(agg.kind)
        self.agg = agg
        self.values: Dict[int, float] = {}

    def tables(self) -> List[TableDescriptor]:
        return [TableDescriptor("a", TableType.KEYED, "aggregates")]

    async def on_start(self, ctx: Context) -> None:
        t = ctx.state.get_keyed_state("a")
        self.values = {k: v for k, v in t.items()}

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        if batch.key_hash is None or self.agg.column not in batch.columns:
            return
        t = ctx.state.get_keyed_state("a")
        vals = batch.columns[self.agg.column].astype(np.float64)
        order = np.argsort(batch.key_hash, kind="stable")
        keys, starts = np.unique(batch.key_hash[order], return_index=True)
        ts = int(np.max(batch.timestamp))
        per = self._REDUCE[self.agg.kind].reduceat(vals[order], starts)
        merge = self._MERGE[self.agg.kind]
        out_vals = np.zeros(len(keys))
        for i, (k, x) in enumerate(zip(keys.tolist(), per.tolist())):
            cur = self.values.get(k)
            nv = x if cur is None else merge(cur, x)
            self.values[k] = nv
            out_vals[i] = nv
            t.insert(ts, k, nv)
        await ctx.collect(Batch(np.full(len(keys), ts, dtype=np.int64),
                                {self.agg.output: out_vals},
                                keys.astype(np.uint64), batch.key_cols))
