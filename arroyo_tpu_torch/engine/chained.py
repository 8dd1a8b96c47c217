"""ChainedOperator — the members of one chain (graph/chaining.py)
executed by one TaskRunner (port of ``arroyo_tpu.engine.chained``).

A batch flows member to member by a synchronous await: no queue between
members, one watermark and barrier alignment per chain.  Identity
survives fusion: each member keeps its own ``Context``, ``StateStore``
and timers, and ``checkpoint_state`` snapshots every member in chain
order with one metadata entry each, so the checkpoint epochs count the
same (member, subtask) completions as unchained, and a checkpoint taken
chained restores unchained and the reverse.

The ingest spine: a run of elementwise members (predicates, record and
option maps, udfs, key_bys), one member long or more, executes as one
host step (:class:`_SpineStep`), as the JAX package's does: SQL
expressions there evaluate on the host (``eval_*(..., host=True)``),
never on the expression device.  The JAX package also composes runs of record
expressions into one jitted function (``_compose_exprs``,
``ARROYO_CHAIN_FUSE_EXPR``) where its spine is off; the port's spine is
always on in a chain, so that composition has no counterpart."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..graph.logical import ExprReturnType
from ..ops.expr import eval_host_expr, eval_predicate, eval_record_expr
from ..types import Batch, CheckpointBarrier, Message, MessageKind, Watermark
from .context import Context
from .operator import Operator
from .operators_basic import ExpressionOperator, KeyByOperator, UdfOperator


class _ChainLink:
    """The collector of a non-tail member: ``collect`` feeds the next
    member, ``broadcast`` takes a watermark through the next member's
    watermark handling."""

    def __init__(self, chain: "ChainedOperator", nxt: int):
        self.chain = chain
        self.nxt = nxt

    async def collect(self, batch: Batch) -> None:
        if len(batch) == 0:
            return  # as Collector.collect: empty batches never cross
        await self.chain._feed(self.nxt, batch)

    async def broadcast(self, msg: Message) -> None:
        await self.chain._control(self.nxt, msg)


def _spineable(op: Operator) -> bool:
    """Members with no state, timers or broadcasts."""
    return isinstance(op, (ExpressionOperator, UdfOperator, KeyByOperator))


class _SpineStep(Operator):
    """A run of elementwise members as one host step, member for member
    the rows, columns and key hashes the unfused members give."""

    def __init__(self, members: List[Operator]):
        super().__init__("spine(" + "+".join(m.name for m in members) + ")")
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
        for kind, op in self.plan:
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
            if len(b) == 0:
                return
        await ctx.collect(b)


class ChainedOperator(Operator):
    """Executes the chain's members in order inside one task.
    ``bind(ctxs)`` takes one Context per member before the runner starts;
    ``ctxs[0]`` is the runner's context (input alignment, head timers)
    and ``tail_ctx`` holds the real output Collector."""

    def __init__(self, members: List[Operator]):
        super().__init__("chain(" + "->".join(op.name for op in members)
                         + ")")
        assert len(members) >= 2
        self.members = members
        self.ctxs: List[Context] = []
        self.tail_ctx: Optional[Context] = None
        # execution steps by first member: (operator, context index)
        self._step_by_start: Dict[int, Tuple[Operator, int]] = {}

    def make_link(self, member_index: int) -> _ChainLink:
        """The collector of member ``member_index``: the next member."""
        return _ChainLink(self, member_index + 1)

    def bind(self, ctxs: List[Context]) -> None:
        assert len(ctxs) == len(self.members)
        self.ctxs = list(ctxs)
        self.tail_ctx = ctxs[-1]
        i = 0
        while i < len(self.members):
            j = i
            if _spineable(self.members[i]):
                while (j + 1 < len(self.members)
                       and _spineable(self.members[j + 1])):
                    j += 1
            step = (_SpineStep(self.members[i:j + 1])
                    if _spineable(self.members[i]) else self.members[i])
            # a step runs against its LAST member's context, whose
            # collector feeds the member after the step
            self._step_by_start[i] = (step, j)
            i = j + 1

    # -- lifecycle ----------------------------------------------------------------

    async def open(self, ctx: Context) -> None:
        for member, mctx in zip(self.members, self.ctxs):
            await member.open(mctx)

    async def on_close(self, ctx: Context) -> None:
        for member, mctx in zip(self.members, self.ctxs):
            await member.on_close(mctx)

    async def checkpoint_state(self, barrier: CheckpointBarrier,
                               ctx: Context) -> List[Any]:
        metas: List[Any] = []
        for member, mctx in zip(self.members, self.ctxs):
            metas.extend(await member.checkpoint_state(barrier, mctx))
        return metas

    # -- dataflow -----------------------------------------------------------------

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        await self._feed(0, batch, side)

    async def _feed(self, start: int, batch: Batch, side: int = 0) -> None:
        step, ctx_idx = self._step_by_start[start]
        await step.process_batch(batch, self.ctxs[ctx_idx],
                                 side if start == 0 else 0)

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
        advanced = mctx.observe_watermark(0, wm)
        if advanced is not None:
            for t, key, payload in mctx.timers.fire(advanced):
                await self.members[i].handle_timer(t, key, payload, mctx)
            await self.members[i].handle_watermark(advanced, mctx)
        elif wm.is_idle and mctx.watermarks.all_idle():
            await mctx.broadcast(Message.wm(Watermark.idle()))
