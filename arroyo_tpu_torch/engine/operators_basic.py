"""Element-wise operators and the periodic watermark generator (port of
the q5-path subset of ``arroyo_tpu.engine.operators_basic``)."""

from __future__ import annotations

import asyncio
import time as _time
from typing import Optional

import numpy as np
import torch

from ..graph.logical import ColumnExpr, ExprReturnType, PeriodicWatermarkSpec
from ..ops.expr import CompiledExpr, eval_host_expr, eval_predicate, eval_record_expr
from ..types import MAX_TIMESTAMP, Batch, Message, Watermark
from .context import Context
from .operator import Operator


class ExpressionOperator(Operator):
    """Map / Filter over a batch via a column expression; a SQL-compiled
    expression runs on the expression device (ops/expr.py), a Stream-API
    function on the host."""

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
        else:
            await ctx.collect(eval_record_expr(self.compiled, batch))


class UdfOperator(Operator):
    """Python function over the raw batch."""

    def __init__(self, name: str, expr: ColumnExpr):
        super().__init__(name)
        self.fn = expr.fn

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        await ctx.collect(eval_host_expr(self.fn, batch))


class KeyByOperator(Operator):
    """Re-key the stream: computes the composite key hash for routing."""

    def __init__(self, name: str, key_cols: tuple):
        super().__init__(name)
        self.key_cols = key_cols

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        await ctx.collect(batch.with_key(list(self.key_cols)))


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
                await ctx.broadcast(Message.wm(Watermark.event_time(wm)))

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        # upstream watermarks (incl. the source's final MAX) pass through
        if watermark >= int(MAX_TIMESTAMP) - self.spec.max_lateness_micros:
            await ctx.broadcast(
                Message.wm(Watermark.event_time(int(MAX_TIMESTAMP))))

    async def on_close(self, ctx: Context) -> None:
        if self._idle_task:
            self._idle_task.cancel()
