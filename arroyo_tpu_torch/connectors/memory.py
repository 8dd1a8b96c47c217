"""In-memory batch source and sink (port of
``arroyo_tpu.connectors.memory``): the source replays a preloaded list of
batches, the sink appends every batch to a process-wide named list."""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List

from ..engine.context import Context
from ..engine.operator import Operator, SourceFinishType, SourceOperator
from ..obs.latency import maybe_stamp
from ..types import Batch
from .registry import ConnectorMeta, register_connector

_SINKS: Dict[str, List[Batch]] = {}


def sink_output(name: str) -> List[Batch]:
    return _SINKS.setdefault(name, [])


def clear_sink(name: str) -> None:
    _SINKS.pop(name, None)


class MemorySource(SourceOperator):
    """Emits a preloaded list of batches, then finishes."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("memory_source")
        self.batches: List[Batch] = cfg.get("batches", [])

    async def run(self, ctx: Context) -> SourceFinishType:
        if ctx.task_info.task_index != 0:
            return SourceFinishType.FINAL  # single-reader source
        for b in self.batches:
            maybe_stamp(ctx.task_info.operator_id, b)
            await ctx.collect(b)
            cm = await ctx._runner.poll_source_control()
            if cm is not None and cm.kind == "stop":
                return SourceFinishType.GRACEFUL
            await asyncio.sleep(0)
        return SourceFinishType.FINAL


class MemorySink(Operator):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("memory_sink")
        self.sink_name = cfg.get("name", "default")

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        sink_output(self.sink_name).append(batch)


register_connector(ConnectorMeta(
    name="memory",
    description="in-memory batches source/sink",
    source_factory=MemorySource,
    sink_factory=MemorySink,
))
