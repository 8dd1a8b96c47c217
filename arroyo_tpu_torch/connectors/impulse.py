"""Impulse source: a rate-limited counter generator (port of
``arroyo_tpu.connectors.impulse``) — the standard benchmark and test
source.  Emits batches of ``{counter: u64, subtask_index: u64}`` and keeps
``(next counter, event-time base)`` per subtask in global table ``i``, so a
restore resumes exactly once: a batch is emitted downstream before its
counter is recorded and before the source looks at its control queue,
where checkpoint barriers arrive."""

from __future__ import annotations

import asyncio
import time as _time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import config
from ..engine.context import Context
from ..engine.operator import SourceFinishType, SourceOperator
from ..obs import profiler
from ..obs.latency import maybe_stamp
from ..state.tables import TableDescriptor, global_table
from ..types import Batch, StopMode, now_micros
from .registry import ConnectorMeta, register_connector


@dataclass
class ImpulseConfig:
    event_rate: float = 1_000_000.0  # events/s across the source
    event_time_interval_micros: Optional[int] = None  # synthetic time step
    message_count: Optional[int] = None  # total events; None = unbounded
    batch_size: Optional[int] = None
    # pin the event-time origin (deterministic windows for tests and
    # benchmarks); None: the wall clock at start
    base_time_micros: Optional[int] = None

    def __post_init__(self) -> None:
        self.event_rate = float(self.event_rate)
        for name in ("event_time_interval_micros", "message_count",
                     "batch_size", "base_time_micros"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, int(v))
        if self.message_count is not None and self.message_count < 0:
            raise ValueError("message_count must be >= 0")
        if self.batch_size is not None and self.batch_size <= 0:
            raise ValueError("batch_size must be > 0")


class ImpulseSource(SourceOperator):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("impulse")
        self.cfg = ImpulseConfig(**cfg)
        self.counter = 0

    def tables(self) -> List[TableDescriptor]:
        return [global_table("i", "impulse source state")]

    async def run(self, ctx: Context) -> SourceFinishType:
        state = ctx.state.get_global_keyed_state("i")
        idx = ctx.task_info.task_index
        saved = state.get(idx)
        saved_base = None
        if saved is not None:
            self.counter, saved_base = saved

        par = ctx.task_info.parallelism
        rate = self.cfg.event_rate / par
        total = None
        if self.cfg.message_count is not None:
            total = (self.cfg.message_count // par
                     + (1 if idx < self.cfg.message_count % par else 0))
        batch_size = self.cfg.batch_size or config().target_batch_size
        interval = self.cfg.event_time_interval_micros
        # the event-time base survives restarts, so restored events land
        # in the same windows as the checkpointed state
        base = (saved_base if saved_base is not None
                else (self.cfg.base_time_micros
                      if self.cfg.base_time_micros is not None
                      else now_micros()))
        t0_wall = _time.monotonic()
        emitted = 0
        prof = profiler.active()
        op_id = ctx.task_info.operator_id
        while total is None or self.counter < total:
            frame = (prof.begin(op_id, "source_decode")
                     if prof is not None else None)
            n = batch_size if total is None else min(batch_size,
                                                     total - self.counter)
            counters = np.arange(self.counter, self.counter + n,
                                 dtype=np.uint64)
            if interval:
                ts = base + counters.astype(np.int64) * interval
            else:
                ts = np.full(n, now_micros(), dtype=np.int64)
            batch = Batch(ts, {
                "counter": counters,
                "subtask_index": np.full(n, idx, dtype=np.uint64)})
            if frame is not None:
                prof.end(frame)
            maybe_stamp(op_id, batch)
            await ctx.collect(batch)
            self.counter += n
            state.insert(idx, (self.counter, base))
            cm = await ctx._runner.poll_source_control()
            if cm is not None and cm.kind == "stop":
                return (SourceFinishType.GRACEFUL
                        if cm.stop_mode != StopMode.IMMEDIATE
                        else SourceFinishType.IMMEDIATE)
            emitted += n
            ahead = (emitted / rate - (_time.monotonic() - t0_wall)
                     if rate > 0 else 0.0)
            await asyncio.sleep(max(ahead, 0.0))
        return SourceFinishType.FINAL


register_connector(ConnectorMeta(
    name="impulse",
    description="rate-limited counter source",
    source_factory=ImpulseSource,
    config_model=ImpulseConfig,
))
