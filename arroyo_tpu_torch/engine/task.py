"""TaskRunner — the generic per-subtask event loop (port of
``arroyo_tpu.engine.task``): fair input fan-in, input coalescing,
barrier alignment, control messages, checkpoints and watermark-driven
timers.  It drives one operator or a chain (engine/chained.py): the
chain head's context aligns inputs and fires the head's timers, later
members' timers fire as the watermark passes down the chain, and
barriers, stop and end of data leave from the tail's context.

A barrier arriving on one input parks that input's pump until barriers
have arrived on all inputs; then state snapshots and the barrier is
rebroadcast downstream.  Record batches pass through a
:class:`~arroyo_tpu_torch.engine.coalesce.BatchCoalescer` (unless
``ARROYO_COALESCE=0``), which is flushed before any watermark, barrier
or end of stream is handled and when its linger expires.

The engine services hook in here as in the JAX package, each a local
that is None unless armed at engine build: the sanitizer checks every
record's edge schema and barrier crossing, every watermark's
monotonicity, the coalescer's flush before each control message and
one completion per (member, subtask) and epoch; the phase profiler
charges input waits (``queue_wait``, ``coalesce_wait``), ``proc``,
``watermark`` and ``checkpoint``; the latency observatory parks each
input batch's ingest stamp in a ContextVar for ``Context.collect`` and
turns stamps reaching a terminal task into sink observations.  The
task metrics (records, lags, batch latency, queue wait) and the
``task.run`` and ``barrier.align`` trace spans are always on."""

from __future__ import annotations

import asyncio
import logging
import time as _time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..config import config
from ..obs import latency as _latency
from ..obs import perf, profiler, tracing
from ..types import (
    MAX_TIMESTAMP,
    CheckpointBarrier,
    ControlMessage,
    ControlResp,
    Message,
    MessageKind,
    StopMode,
    TaskInfo,
    Watermark,
    now_micros,
)
from .coalesce import BatchCoalescer, coalescing_enabled
from .context import Context
from .operator import Operator, SourceFinishType, SourceOperator

logger = logging.getLogger(__name__)


class _Pump:
    """Forwards one input channel into the merged queue; parks on barriers."""

    def __init__(self, idx: int, side: int, queue: asyncio.Queue,
                 merged: asyncio.Queue):
        self.idx = idx
        self.side = side
        self.queue = queue
        self.merged = merged
        self.resume = asyncio.Event()
        self.task: Optional[asyncio.Task] = None

    async def run(self) -> None:
        while True:
            msg: Message = await self.queue.get()
            await self.merged.put((self.idx, self.side, msg))
            if msg.kind == MessageKind.BARRIER:
                self.resume.clear()
                await self.resume.wait()
            if msg.is_end:
                return


class TaskRunner:
    def __init__(self, task_info: TaskInfo, operator: Operator, ctx: Context,
                 inputs: List[Tuple[int, asyncio.Queue]],
                 control_rx: asyncio.Queue,
                 control_tx: Optional[asyncio.Queue] = None,
                 sanitizer: Optional[Any] = None):
        self.task_info = task_info
        self.operator = operator
        # the runtime sanitizer: None unless ARROYO_SANITIZE armed it
        self.sanitizer = sanitizer
        operator.sanitizer = sanitizer
        self.ctx = ctx
        # a chain's downstream broadcasts leave from its tail member
        self.out_ctx: Context = getattr(operator, "tail_ctx", None) or ctx
        self.inputs = inputs
        self.control_rx = control_rx
        self.control_tx = control_tx
        self.merged: asyncio.Queue = asyncio.Queue(
            maxsize=len(inputs) * 4 + 16)
        self.pumps: List[_Pump] = []
        self.finished = asyncio.Event()
        self.failed: Optional[BaseException] = None
        # phase profiler: None unless armed at engine build
        self._prof = profiler.active()
        # latency observatory: None unless armed.  A terminal task (no
        # outgoing edges) turns sampled stamps into sink observations; a
        # chain observes at its tail member instead (engine/chained.py)
        self._lat = _latency.active()
        self._lat_terminal = (self._lat is not None
                              and not self.out_ctx.collector.edge_groups
                              and not operator.own_batch_metrics)
        self._align_start: Dict[int, float] = {}  # epoch -> trace us

    async def start(self) -> None:
        # kernel-time attribution: every timed_device launch inside this
        # coroutine's context accrues to this subtask's counter
        token = perf.set_active_task(
            perf.KernelAccumulator(self.task_info, self.ctx.metrics))
        run_start = tracing.now_us()
        try:
            await self._run()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # report task failure to the controller
            self.failed = e
            logger.error("task %s failed: %s\n%s", self.task_info.task_id, e,
                         traceback.format_exc())
            await self.ctx.report(ControlResp(
                kind="task_failed", operator_id=self.task_info.operator_id,
                task_index=self.task_info.task_index,
                error=f"{type(e).__name__}: {e}"))
            # drain downstream so a local run can't wait forever on inputs
            # that will never end
            await self.out_ctx.broadcast(Message.end_of_data())
        finally:
            tracing.record_span(
                "task.run", "task", run_start,
                tracing.now_us() - run_start, tid=self.task_info.task_id,
                args={"failed": self.failed is not None})
            perf.reset_active_task(token)
            self.finished.set()

    async def _run(self) -> None:
        await self.operator.open(self.ctx)
        await self.ctx.report(ControlResp(
            kind="task_started", operator_id=self.task_info.operator_id,
            task_index=self.task_info.task_index))
        if isinstance(self.operator, SourceOperator):
            await self._run_source()
        else:
            await self._run_processor()
        await self.ctx.report(ControlResp(
            kind="task_finished", operator_id=self.task_info.operator_id,
            task_index=self.task_info.task_index))

    # -- source -------------------------------------------------------------------

    async def _run_source(self) -> None:
        finish = await self.operator.run(self.ctx)
        if finish == SourceFinishType.FINAL:
            # the final watermark flushes all windows downstream
            await self.ctx.broadcast(
                Message.wm(Watermark.event_time(int(MAX_TIMESTAMP))))
            await self.ctx.broadcast(Message.end_of_data())
        elif finish == SourceFinishType.GRACEFUL:
            await self.ctx.broadcast(Message.stop())

    async def poll_source_control(self) -> Optional[ControlMessage]:
        """Non-blocking control poll used by sources between batches;
        checkpoint barriers are handled inline (they enter the graph at
        sources).  Returns stop messages to the source loop."""
        try:
            cm: ControlMessage = self.control_rx.get_nowait()
        except asyncio.QueueEmpty:
            return None
        if cm.kind == "checkpoint":
            await self.run_checkpoint(cm.barrier)
            if cm.barrier.then_stop:
                return ControlMessage.stop(StopMode.IMMEDIATE)
        return cm

    # -- processor ----------------------------------------------------------------

    async def _run_processor(self) -> None:
        for i, (side, q) in enumerate(self.inputs):
            pump = _Pump(i, side, q, self.merged)
            pump.task = asyncio.ensure_future(pump.run())
            self.pumps.append(pump)

        ended = 0
        stop_mode: Optional[StopMode] = None
        then_stop = False
        pending_barriers: Dict[int, CheckpointBarrier] = {}
        get_merged: Optional[asyncio.Future] = None
        get_control: Optional[asyncio.Future] = None
        metrics = self.ctx.metrics
        coal = self._make_coalescer()
        san = self.sanitizer
        tid = self.task_info.task_id
        prof = self._prof
        op_id = self.task_info.operator_id

        async def flush() -> None:
            for cside, cbatch in coal.flush_all():
                await self._process_record(cbatch, cside)

        try:
            while ended < len(self.inputs):
                if get_merged is None or get_merged.done():
                    get_merged = asyncio.ensure_future(self.merged.get())
                if get_control is None or get_control.done():
                    get_control = asyncio.ensure_future(self.control_rx.get())
                timeout = None
                if coal is not None and coal.pending:
                    # bounded linger: wake to flush even with no input
                    timeout = max(coal.deadline - _time.monotonic(), 0.0)
                wait_t0 = _time.perf_counter()
                done, _ = await asyncio.wait(
                    [get_merged, get_control],
                    return_when=asyncio.FIRST_COMPLETED, timeout=timeout)
                if metrics is not None or prof is not None:
                    # time this loop sat waiting for input
                    waited = _time.perf_counter() - wait_t0
                    if metrics is not None:
                        metrics.queue_wait.observe(waited)
                    if prof is not None:
                        # a wait bounded by the coalescer's linger is
                        # latency the coalescer added, not starvation
                        prof.add(op_id, "coalesce_wait" if timeout
                                 is not None else "queue_wait",
                                 waited, wait=True)
                if (coal is not None and coal.pending
                        and _time.monotonic() >= coal.deadline):
                    await flush()
                if not done:
                    continue
                if get_control in done:
                    cm = get_control.result()
                    if (cm.kind == "stop"
                            and cm.stop_mode == StopMode.IMMEDIATE):
                        return
                if get_merged not in done:
                    continue
                idx, side, msg = get_merged.result()

                if msg.kind == MessageKind.RECORD:
                    if san is not None:
                        san.on_record((tid, idx), msg.batch)
                        san.on_record_during_alignment(tid, idx,
                                                       self.ctx.counter)
                    if metrics is not None:
                        metrics.messages_recv.inc(len(msg.batch))
                    if coal is None:
                        await self._process_record(msg.batch, side)
                    else:
                        for cside, cbatch in coal.add(side, msg.batch):
                            await self._process_record(cbatch, cside)
                    continue
                # records buffered before a watermark, barrier or end of
                # stream go first: a window must not fire without them,
                # and a snapshot must hold them
                if coal is not None and coal.pending:
                    await flush()
                if msg.kind == MessageKind.WATERMARK:
                    if san is not None:
                        san.before_control(tid, "watermark", coal)
                        san.on_watermark((tid, idx), msg.watermark)
                    advanced = self.ctx.observe_watermark(idx, msg.watermark)
                    if advanced is not None:
                        await self._advance_watermark(advanced)
                    elif (msg.watermark.is_idle
                          and self.ctx.watermarks.all_idle()):
                        await self.out_ctx.broadcast(
                            Message.wm(Watermark.idle()))
                elif msg.kind == MessageKind.BARRIER:
                    b = msg.barrier
                    if san is not None:
                        san.before_control(tid, "barrier", coal)
                        san.on_barrier(tid, idx, b.epoch)
                    pending_barriers[b.epoch] = b
                    self._align_start.setdefault(b.epoch, tracing.now_us())
                    if self.ctx.counter.observe(idx, b.epoch):
                        del pending_barriers[b.epoch]
                        await self.run_checkpoint(b)
                        for p in self.pumps:
                            p.resume.set()
                        if b.then_stop:
                            then_stop = True
                            break
                elif msg.is_end:
                    if san is not None:
                        san.before_control(tid, "end", coal)
                    ended += 1
                    if msg.kind == MessageKind.STOP:
                        stop_mode = StopMode.GRACEFUL
                    # a finished input can't deliver barriers: re-check
                    # alignment for epochs already in flight
                    for epoch in self.ctx.counter.mark_closed(idx):
                        b = pending_barriers.pop(epoch, None)
                        if b is not None:
                            await self.run_checkpoint(b)
                            for p in self.pumps:
                                p.resume.set()
                            if b.then_stop:
                                then_stop = True
                    if then_stop:
                        break
        finally:
            for f in (get_merged, get_control):
                if f is not None and not f.done():
                    f.cancel()
            for p in self.pumps:
                if p.task is not None:
                    p.task.cancel()
            # unblock upstreams possibly parked on a full queue
            for _, q in self.inputs:
                while not q.empty():
                    q.get_nowait()

        await self.operator.on_close(self.ctx)
        if then_stop or stop_mode is not None:
            await self.out_ctx.broadcast(Message.stop())
        else:
            await self.out_ctx.broadcast(Message.end_of_data())

    def _make_coalescer(self) -> Optional[BatchCoalescer]:
        """The input coalescer; None under ``ARROYO_COALESCE=0``."""
        if not coalescing_enabled():
            return None
        cfg = config()
        hist = (self.ctx.metrics.coalesce_batches
                if self.ctx.metrics is not None else None)
        return BatchCoalescer(cfg.coalesce_target or cfg.target_batch_size,
                              cfg.coalesce_linger_micros / 1e6, hist,
                              prof=self._prof,
                              prof_op=self.task_info.operator_id)

    async def _process_record(self, batch, side: int) -> None:
        """Run one (possibly coalesced) record batch through the operator,
        with the latency observatory's stamp parked for the duration."""
        lat = self._lat
        if lat is not None:
            if self._lat_terminal and batch.lat_stamp is not None:
                # sink boundary: a sampled stamp becomes one
                # emit-minus-ingest observation
                lat.observe_sink(self.task_info, batch.lat_stamp)
            # Context.collect re-attaches it to operator-built batches
            _latency.set_current(batch.lat_stamp)
        try:
            await self._process_record_inner(batch, side)
        finally:
            if lat is not None:
                _latency.set_current(None)

    async def _process_record_inner(self, batch, side: int) -> None:
        metrics = self.ctx.metrics
        if metrics is None or self.operator.own_batch_metrics:
            # a ChainedOperator opens its own per-member `proc` phases
            await self.operator.process_batch(batch, self.ctx, side)
            return
        prof = self._prof
        if len(batch):
            # event-time lag: wall clock against the freshest event (the
            # unset and final-flush sentinels excluded)
            ts = int(np.max(batch.timestamp))
            if 0 < ts < int(MAX_TIMESTAMP) - 1:
                metrics.event_time_lag.observe(
                    max((now_micros() - ts) / 1e6, 0.0))
        frame = (prof.begin(self.task_info.operator_id, "proc")
                 if prof is not None else None)
        t0 = _time.perf_counter()
        try:
            await self.operator.process_batch(batch, self.ctx, side)
        finally:
            if frame is not None:
                prof.end(frame)
        metrics.batch_latency.observe(_time.perf_counter() - t0)

    async def _advance_watermark(self, wm: int) -> None:
        if (self.ctx.metrics is not None
                and 0 < wm < int(MAX_TIMESTAMP) - 1):
            # watermark lag: wall clock against the newly advanced input
            # watermark
            self.ctx.metrics.watermark_lag.observe(
                max((now_micros() - wm) / 1e6, 0.0))
        # expired event-time timers fire first
        prof = self._prof
        frame = (prof.begin(self.task_info.operator_id, "watermark")
                 if prof is not None else None)
        try:
            for time, key, payload in self.ctx.timers.fire(wm):
                await self.operator.handle_timer(time, key, payload,
                                                 self.ctx)
            await self.operator.handle_watermark(wm, self.ctx)
        finally:
            if frame is not None:
                prof.end(frame)

    # -- checkpoint -----------------------------------------------------------------

    async def run_checkpoint(self, barrier: CheckpointBarrier) -> None:
        align_start = self._align_start.pop(barrier.epoch, None)
        if align_start is not None:
            align_us = tracing.now_us() - align_start
            tracing.record_span("barrier.align", "checkpoint", align_start,
                                align_us, tid=self.task_info.task_id,
                                args={"epoch": barrier.epoch})
            if self._lat is not None:
                # records queued behind this alignment waited this long
                self._lat.note_stage("barrier_align", align_us / 1e6)
        prof = self._prof
        frame = (prof.begin(self.task_info.operator_id, "checkpoint")
                 if prof is not None else None)
        try:
            metadatas = await self.operator.checkpoint_state(barrier,
                                                             self.ctx)
        finally:
            if frame is not None:
                prof.end(frame)
        if self.sanitizer is not None:
            # one completion per distinct (member, subtask) and epoch
            for md in metadatas:
                self.sanitizer.on_checkpoint_completed(
                    md.operator_id, md.subtask_index, md.epoch)
        for metadata in metadatas:
            await self.ctx.report(ControlResp(
                kind="checkpoint_completed",
                operator_id=metadata.operator_id,
                task_index=metadata.subtask_index,
                subtask_metadata=metadata))
        await self.out_ctx.broadcast(Message.barrier_msg(barrier))
