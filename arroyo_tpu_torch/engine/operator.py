"""Physical operator base classes (port of ``arroyo_tpu.engine.operator``).
Operator hooks are overridable methods; one generic
:class:`~arroyo_tpu_torch.engine.task.TaskRunner` drives them."""

from __future__ import annotations

from enum import Enum
from typing import Any, List

from ..state.tables import TableDescriptor
from ..types import Batch, CheckpointBarrier
from .context import Context


class SourceFinishType(Enum):
    FINAL = "final"  # emit final watermark + EndOfData
    GRACEFUL = "graceful"  # stop requested; checkpoint state is current
    IMMEDIATE = "immediate"


class Operator:
    """Base for single-input (and generic) operators."""

    def __init__(self, name: str):
        self.name = name

    def tables(self) -> List[TableDescriptor]:
        return []

    async def open(self, ctx: Context) -> None:
        """Task startup: register state tables, restore persisted timers
        (reserved table '['), then ``on_start``."""
        for desc in self.tables():
            ctx.state.register(desc)
        saved_timers = ctx.state.get_global_keyed_state("[", "timers").get(
            "timers")
        if saved_timers:
            ctx.timers.restore(saved_timers)
        await self.on_start(ctx)

    async def checkpoint_state(self, barrier: CheckpointBarrier,
                               ctx: Context) -> List[Any]:
        """Snapshot this operator's state at a barrier, after its
        ``pre_checkpoint``; returns the checkpoint metadata to report."""
        await self.pre_checkpoint(barrier, ctx)
        ctx.state.get_global_keyed_state("[").insert(
            "timers", ctx.timers.snapshot())
        return [ctx.state.checkpoint(barrier.epoch, ctx.last_watermark)]

    async def pre_checkpoint(self, barrier: CheckpointBarrier,
                             ctx: Context) -> None:
        """Move state that lives outside the registered tables into them,
        or downstream, right before the snapshot; rows collected here
        reach the outputs before the barrier does."""

    async def on_start(self, ctx: Context) -> None:
        pass

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        raise NotImplementedError

    async def handle_timer(self, time: int, key: Any, payload: Any,
                           ctx: Context) -> None:
        pass

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        """Called when the combined input watermark advances (after timers
        fire).  Default: forward it downstream."""
        from ..types import Message, Watermark

        await ctx.broadcast(Message.wm(Watermark.event_time(watermark)))

    async def on_close(self, ctx: Context) -> None:
        """Called when all inputs have finished, before EndOfData."""


class SourceOperator(Operator):
    """Base for sources: drives its own loop instead of reacting to inputs."""

    async def run(self, ctx: Context) -> SourceFinishType:
        raise NotImplementedError

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        raise RuntimeError("sources have no inputs")
