"""Physical operator base classes (port of ``arroyo_tpu.engine.operator``).
Operator hooks are overridable methods; one generic
:class:`~arroyo_tpu_torch.engine.task.TaskRunner` drives them."""

from __future__ import annotations

from enum import Enum
from typing import Any, List, Optional

from ..obs import tracing
from ..state.tables import TableDescriptor
from ..types import Batch, CheckpointBarrier
from .context import Context


class SourceFinishType(Enum):
    FINAL = "final"  # emit final watermark + EndOfData
    GRACEFUL = "graceful"  # stop requested; checkpoint state is current
    IMMEDIATE = "immediate"


class Operator:
    """Base for single-input (and generic) operators."""

    # True when the operator records its own per-batch lag/latency
    # metrics and `proc` phases (ChainedOperator, per member); the
    # TaskRunner then skips its task-level observation
    own_batch_metrics = False

    # the runtime sanitizer (analysis/sanitizer.py) the TaskRunner
    # installs; None unless ARROYO_SANITIZE armed it
    sanitizer: Optional[Any] = None

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
        tid = ctx.task_info.task_id
        with tracing.span("checkpoint.pre", "checkpoint", tid=tid,
                          args={"epoch": barrier.epoch}):
            await self.pre_checkpoint(barrier, ctx)
        ctx.state.get_global_keyed_state("[").insert(
            "timers", ctx.timers.snapshot())
        with tracing.span("checkpoint.sync", "checkpoint", tid=tid,
                          args={"epoch": barrier.epoch}):
            metadata = ctx.state.checkpoint(barrier.epoch,
                                            ctx.last_watermark)
        if ctx.metrics is not None:
            ctx.metrics.checkpoint_duration.observe(max(
                (metadata.finish_time - metadata.start_time) / 1e6, 0.0))
            ctx.metrics.checkpoint_bytes.observe(metadata.bytes)
        return [metadata]

    async def pre_checkpoint(self, barrier: CheckpointBarrier,
                             ctx: Context) -> None:
        """Move state that lives outside the registered tables into them,
        or downstream, right before the snapshot; rows collected here
        reach the outputs before the barrier does."""

    async def on_start(self, ctx: Context) -> None:
        pass

    async def handle_commit(self, epoch: int, ctx: Context) -> None:
        """Second phase of the two-phase commit of ``epoch`` (sinks)."""

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
