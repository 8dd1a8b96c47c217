"""ChainedOperator — the members of one chain (graph/chaining.py)
executed by one TaskRunner (port of ``arroyo_tpu.engine.chained``).

A batch flows member to member by a synchronous await: no queue between
members, one watermark and barrier alignment per chain.  Identity
survives fusion: each member keeps its own ``Context``, ``StateStore``,
timers and ``TaskMetrics`` (records, lag and batch latency stay
attributed to members), its own kernel accumulator around its
processing and its own ``proc`` and ``watermark`` profiler phases, and
``checkpoint_state`` snapshots every member in chain order (each after
its own ``pre_checkpoint``) with one metadata entry each, so the
checkpoint epochs count the same (member, subtask) completions as
unchained, and a checkpoint taken chained restores unchained and the
reverse.  With the sanitizer armed, interior chain edges keep the
per-edge schema and watermark checks of real queues; with the latency
observatory armed, a chain that ends the dataflow observes sampled
stamps where they reach its tail member, so a window fire inside the
chain is measured at its emission.

The ingest spine: a run of elementwise members (predicates, record and
option maps, udfs, key_bys), one member long or more, executes as one
host step (:class:`_SpineStep`), as the JAX package's does: SQL
expressions there evaluate on the host (``eval_*(..., host=True)``),
never on the expression device.  The JAX package also composes runs of record
expressions into one jitted function (``_compose_exprs``,
``ARROYO_CHAIN_FUSE_EXPR``) where its spine is off; the port's spine is
always on in a chain, so that composition has no counterpart."""

from __future__ import annotations

import time as _time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..graph.logical import ExprReturnType
from ..obs import latency as _latency
from ..obs import perf, profiler
from ..ops.expr import eval_host_expr, eval_predicate, eval_record_expr
from ..types import (
    MAX_TIMESTAMP,
    Batch,
    CheckpointBarrier,
    Message,
    MessageKind,
    TaskInfo,
    Watermark,
    now_micros,
)
from .context import Context
from .operator import Operator
from .operators_basic import ExpressionOperator, KeyByOperator, UdfOperator


class _ChainLink:
    """The collector of a non-tail member: ``collect`` feeds the next
    member, ``broadcast`` takes a watermark through the next member's
    watermark handling."""

    metrics = None  # Collector-duck attribute (Context reads it)

    def __init__(self, chain: "ChainedOperator", nxt: int):
        self.chain = chain
        self.nxt = nxt

    async def collect(self, batch: Batch) -> None:
        if len(batch) == 0:
            return  # as Collector.collect: empty batches never cross
        m = self.chain.ctxs[self.nxt - 1].metrics
        if m is not None:
            m.messages_sent.inc(len(batch))
        await self.chain._feed(self.nxt, batch)

    async def broadcast(self, msg: Message) -> None:
        await self.chain._control(self.nxt, msg)


def _spineable(op: Operator) -> bool:
    """Members with no state, timers or broadcasts."""
    return isinstance(op, (ExpressionOperator, UdfOperator, KeyByOperator))


def _observe_lag(m: Any, batch: Batch) -> None:
    """Event-time lag of ``batch`` at a member: wall clock against its
    freshest event (the unset and final-flush sentinels excluded)."""
    if len(batch):
        ts = int(np.max(batch.timestamp))
        if 0 < ts < int(MAX_TIMESTAMP) - 1:
            m.event_time_lag.observe(max((now_micros() - ts) / 1e6, 0.0))


class _SpineStep(Operator):
    """A run of elementwise members as one host step, member for member
    the rows, columns and key hashes the unfused members give.  It counts
    each member's records itself (``own_member_counts``): predicates
    change the row count member to member."""

    own_member_counts = True

    def __init__(self, chain: "ChainedOperator", idxs: List[int]):
        members = [chain.members[i] for i in idxs]
        super().__init__("spine(" + "+".join(m.name for m in members) + ")")
        self.chain = chain
        self.idxs = idxs  # the members' indices in the chain
        self.plan: List[Tuple[str, Operator]] = []
        for op in members:
            if isinstance(op, KeyByOperator):
                kind = "key"
            elif isinstance(op, UdfOperator):
                kind = "udf"
            elif op.return_type == ExprReturnType.PREDICATE:
                kind = "pred"
            elif op.return_type == ExprReturnType.RECORD:
                kind = "record"
            else:
                kind = "opt"  # OPTIONAL_RECORD: record + __valid select
            self.plan.append((kind, op))

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        b = batch
        last = self.idxs[-1]
        for mi, (kind, op) in zip(self.idxs, self.plan):
            m = self.chain.ctxs[mi].metrics
            if m is not None:
                if mi != 0:  # the head member's recv is the runner's
                    m.messages_recv.inc(len(b))
                _observe_lag(m, b)
            if kind == "pred":
                mask = eval_predicate(op.compiled, b, host=True)
                if not mask.any():
                    return
                b = b.select(mask)
            elif kind == "record":
                b = eval_record_expr(op.compiled, b, host=True)
            elif kind == "opt":
                b = eval_record_expr(op.compiled, b, host=True)
                if "__valid" in b.columns:
                    b = b.select(b.columns.pop("__valid").astype(bool))
            elif kind == "udf":
                b = eval_host_expr(op.fn, b)
            else:
                b = b.with_key(list(op.key_cols))
            if mi != last and m is not None:
                # the last member's sent is counted by its collector
                m.messages_sent.inc(len(b))
            if len(b) == 0:
                return
        await ctx.collect(b)


class ChainedOperator(Operator):
    """Executes the chain's members in order inside one task.
    ``bind(ctxs)`` takes one Context per member before the runner starts;
    ``ctxs[0]`` is the runner's context (input alignment, head timers)
    and ``tail_ctx`` holds the real output Collector."""

    own_batch_metrics = True  # per-member lag, latency and `proc` here

    def __init__(self, infos: List[TaskInfo], members: List[Operator]):
        super().__init__("chain(" + "->".join(op.name for op in members)
                         + ")")
        assert len(infos) == len(members) >= 2
        self.infos = infos
        self.members = members
        self.ctxs: List[Context] = []
        self.tail_ctx: Optional[Context] = None
        self._accs: List[perf.KernelAccumulator] = []
        # execution steps by first member: (operator, context index)
        self._step_by_start: Dict[int, Tuple[Operator, int]] = {}
        self._lat_stack: List[float] = []  # child-inclusive seconds
        # latency observatory: when the chain ends the dataflow, the feed
        # into the tail member's step is the sink boundary
        self._lat: Optional[Any] = None
        self._lat_tail_start: Optional[int] = None

    def make_link(self, member_index: int) -> _ChainLink:
        """The collector of member ``member_index``: the next member."""
        return _ChainLink(self, member_index + 1)

    def bind(self, ctxs: List[Context]) -> None:
        assert len(ctxs) == len(self.members)
        self.ctxs = list(ctxs)
        self.tail_ctx = ctxs[-1]
        self._accs = [perf.KernelAccumulator(ti, c.metrics)
                      for ti, c in zip(self.infos, ctxs)]
        i = 0
        while i < len(self.members):
            j = i
            if _spineable(self.members[i]):
                while (j + 1 < len(self.members)
                       and _spineable(self.members[j + 1])):
                    j += 1
            step = (_SpineStep(self, list(range(i, j + 1)))
                    if _spineable(self.members[i]) else self.members[i])
            # a step runs against its LAST member's context, whose
            # collector feeds the member after the step
            self._step_by_start[i] = (step, j)
            i = j + 1
        self._lat = _latency.active()
        if (self._lat is not None
                and not self.tail_ctx.collector.edge_groups):
            self._lat_tail_start = max(self._step_by_start)

    # -- lifecycle ----------------------------------------------------------------

    async def open(self, ctx: Context) -> None:
        for member, mctx in zip(self.members, self.ctxs):
            await member.open(mctx)

    async def on_close(self, ctx: Context) -> None:
        for member, mctx in zip(self.members, self.ctxs):
            await member.on_close(mctx)

    async def checkpoint_state(self, barrier: CheckpointBarrier,
                               ctx: Context) -> List[Any]:
        # each member's checkpoint_state runs its pre_checkpoint first, so
        # rows a member drains reach the later members before they snapshot
        metas: List[Any] = []
        for member, mctx in zip(self.members, self.ctxs):
            metas.extend(await member.checkpoint_state(barrier, mctx))
        return metas

    async def handle_commit(self, epoch: int, ctx: Context) -> None:
        for member, mctx in zip(self.members, self.ctxs):
            await member.handle_commit(epoch, mctx)

    # -- dataflow -----------------------------------------------------------------

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        await self._feed(0, batch, side)

    async def _feed(self, start: int, batch: Batch, side: int = 0) -> None:
        step, ctx_idx = self._step_by_start[start]
        if (self._lat_tail_start is not None
                and start == self._lat_tail_start
                and batch.lat_stamp is not None):
            # sink boundary of a terminal chain: one emit-minus-ingest
            # observation per sampled batch reaching the tail member
            self._lat.observe_sink(self.infos[-1], batch.lat_stamp)
        if self.sanitizer is not None and start > 0:
            # interior chain edges keep the per-edge schema stability of
            # real queues (the runner checks the head edge)
            self.sanitizer.on_record(
                (self.infos[start].task_id, "chain"), batch)
        if not getattr(step, "own_member_counts", False):
            m = self.ctxs[start].metrics
            if m is not None:
                if start != 0:  # the head member's recv is the runner's
                    m.messages_recv.inc(len(batch))
                _observe_lag(m, batch)
        # exclusive latency: inclusive minus the time spent in the later
        # members this call recursed into (collect is synchronous)
        self._lat_stack.append(0.0)
        token = perf.set_active_task(self._accs[start])
        prof = profiler.active()
        frame = (prof.begin(self.infos[start].operator_id, "proc")
                 if prof is not None else None)
        t0 = _time.perf_counter()
        try:
            await step.process_batch(batch, self.ctxs[ctx_idx],
                                     side if start == 0 else 0)
        finally:
            if frame is not None:
                # nested member frames subtract themselves, so each
                # member's `proc` is exclusive like its latency
                prof.end(frame)
            perf.reset_active_task(token)
            inclusive = _time.perf_counter() - t0
            child = self._lat_stack.pop()
            if self._lat_stack:
                self._lat_stack[-1] += inclusive
            m0 = self.ctxs[start].metrics
            if m0 is not None:
                m0.batch_latency.observe(max(inclusive - child, 0.0))

    # -- watermarks and timers ------------------------------------------------------

    async def handle_timer(self, time: int, key: Any, payload: Any,
                           ctx: Context) -> None:
        # the runner fires the head member's timers (ctx is ctxs[0])
        await self.members[0].handle_timer(time, key, payload, self.ctxs[0])

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        # the head's broadcast rides its link into the next member, and so
        # on, until the tail broadcasts downstream
        await self.members[0].handle_watermark(watermark, self.ctxs[0])

    async def _control(self, i: int, msg: Message) -> None:
        if msg.kind == MessageKind.WATERMARK:
            await self._member_watermark(i, msg.watermark)
        else:  # members broadcast only watermarks mid-stream
            await self.tail_ctx.broadcast(msg)

    async def _member_watermark(self, i: int, wm: Watermark) -> None:
        """Member ``i``'s slice of the runner's watermark handling:
        observe, fire its timers, then its handle_watermark (whose
        broadcast continues down the chain)."""
        mctx = self.ctxs[i]
        if self.sanitizer is not None:
            self.sanitizer.on_watermark((self.infos[i].task_id, "chain"), wm)
        advanced = mctx.observe_watermark(0, wm)
        if advanced is not None:
            if (mctx.metrics is not None
                    and 0 < advanced < int(MAX_TIMESTAMP) - 1):
                mctx.metrics.watermark_lag.observe(
                    max((now_micros() - advanced) / 1e6, 0.0))
            prof = profiler.active()
            frame = (prof.begin(self.infos[i].operator_id, "watermark")
                     if prof is not None else None)
            try:
                for t, key, payload in mctx.timers.fire(advanced):
                    await self.members[i].handle_timer(t, key, payload,
                                                       mctx)
                await self.members[i].handle_watermark(advanced, mctx)
            finally:
                if frame is not None:
                    prof.end(frame)
        elif wm.is_idle and mctx.watermarks.all_idle():
            await mctx.broadcast(Message.wm(Watermark.idle()))
