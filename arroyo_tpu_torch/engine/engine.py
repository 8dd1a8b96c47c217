"""Engine: physical graph construction and execution (port of
``arroyo_tpu.engine.engine``).

Expands the logical graph by parallelism into subtasks, fuses maximal
linear runs of operators into chains (graph/chaining.py; one runner and
no queue between members, engine/chained.py; ``ARROYO_CHAIN=0`` builds one
runner per operator), wires forward (1:1) and shuffle (all-to-all)
channels between runners as bounded asyncio queues, runs one asyncio task
per runner and exposes control handles (:class:`RunningEngine`).
:class:`LocalRunner` runs a bounded pipeline to completion in-process.

Before anything is built, the program goes through the factor-window
rewrite (graph/factor_windows.py; SQL plans arrive rewritten and the pass
is idempotent) and the plan validator (analysis/plan_validator.py), as in
the JAX package.

Left out of the port for now, none of which changes the rows a pipeline
emits: the runtime sanitizer, the phase profiler, the latency
observatory, metrics gauges and multi-worker network edges."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..config import config
from ..device import DeviceLike, resolve_device
from ..graph.chaining import plan_chains, validate_chain_plan
from ..graph.factor_windows import apply_factor_windows
from ..graph.logical import EdgeType, Program
from ..state.backend import BackingStore, InMemoryBackend
from ..state.store import StateStore
from ..types import (
    CheckpointBarrier,
    ControlMessage,
    ControlResp,
    TaskInfo,
    now_micros,
)
from .build import build_operator, validate_before_build
from .chained import ChainedOperator
from .context import Collector, Context, OutQueue
from .operator import Operator, SourceOperator
from .task import TaskRunner


@dataclass
class SubtaskHandle:
    task_info: TaskInfo
    runner: TaskRunner
    control_tx: asyncio.Queue  # ControlMessage -> task
    is_source: bool
    # the logical operators this runner executes, head first
    member_ids: List[str] = field(default_factory=list)
    task: Optional[asyncio.Task] = None


@dataclass
class Engine:
    program: Program
    job_id: str = "local-job"
    backend: BackingStore = field(default_factory=InMemoryBackend)
    restore_epoch: Optional[int] = None
    device: DeviceLike = None

    def __post_init__(self) -> None:
        # factor-window sharing for Stream-API programs, before validation
        # so the validator sees the factored shape
        self.factor_decisions = apply_factor_windows(self.program)
        errors = self.program.validate()
        if errors:
            raise ValueError("; ".join(errors))
        validate_before_build(self.program)
        self.device = resolve_device(self.device)
        self.control_resp: asyncio.Queue = asyncio.Queue()
        # runners by (head operator id, subtask index)
        self.subtasks: Dict[Tuple[str, int], SubtaskHandle] = {}
        # every operator, chained or not, with its context, by
        # (operator id, subtask index)
        self.members: Dict[Tuple[str, int], Tuple[Operator, Context]] = {}
        self.resps: List[ControlResp] = []

    def start(self) -> "RunningEngine":
        """Build the physical graph and spawn all subtask loops: one
        runner per chain head (graph/chaining.py) and per unchained
        operator, at each subtask index."""
        prog = self.program
        plan = plan_chains(prog)
        validate_chain_plan(prog, plan)
        interior = {m for grp in plan.groups for m in grp[1:]}
        queues: Dict[Tuple[str, int, str, int], asyncio.Queue] = {}
        qsize = config().queue_size

        def queue_for(quad: Tuple[str, int, str, int]) -> asyncio.Queue:
            if quad not in queues:
                queues[quad] = asyncio.Queue(maxsize=qsize)
            return queues[quad]

        for op_id in prog.topo_order():
            if op_id not in interior:
                for idx in range(prog.node(op_id).parallelism):
                    self._build_subtask(plan.members_of.get(op_id, [op_id]),
                                        idx, queue_for)

        for handle in self.subtasks.values():
            handle.task = asyncio.ensure_future(handle.runner.start())
        return RunningEngine(self)

    def _build_subtask(self, ms: List[str], idx: int, queue_for) -> None:
        """One runner for the member run ``ms`` (a chain, or a single
        operator) at subtask index ``idx``: inputs into the head, outputs
        from the tail."""
        prog = self.program
        head, tail = ms[0], ms[-1]
        par = prog.node(head).parallelism
        edge_groups: List[List[OutQueue]] = []
        for _, dst, edge in prog.graph.out_edges(tail):
            dst_par = prog.node(dst).parallelism
            if edge.typ == EdgeType.FORWARD:
                # equal parallelism: 1:1; mismatched: fan-in (src i ->
                # dst i % dst_par) or fan-out (src i -> every dst j with
                # j % par == i, round-robined)
                if dst_par > par:
                    group = [OutQueue(queue_for((tail, idx, dst, j)))
                             for j in range(dst_par) if j % par == idx]
                else:
                    group = [OutQueue(queue_for(
                        (tail, idx, dst, idx % dst_par)))]
            else:
                group = [OutQueue(queue_for((tail, idx, dst, j)))
                         for j in range(dst_par)]
            edge_groups.append(group)
        # (side, queue) per upstream subtask: shuffle-join edges feed
        # their side of a two-input operator
        inputs: List[Tuple[int, asyncio.Queue]] = []
        for src, _, edge in prog.graph.in_edges(head):
            src_par = prog.node(src).parallelism
            side = edge.typ.join_side or 0
            if edge.typ == EdgeType.FORWARD and par > src_par:
                inputs.append((side, queue_for((src, idx % src_par, head,
                                                idx))))
            else:
                for j in range(src_par):
                    if edge.typ != EdgeType.FORWARD or j % par == idx:
                        inputs.append((side, queue_for((src, j, head,
                                                        idx))))
        infos = [TaskInfo(self.job_id, m, prog.node(m).operator.name, idx,
                          par) for m in ms]
        ops = [build_operator(prog.node(m).operator, self.device)
               for m in ms]
        collector = Collector(edge_groups)
        ctxs: List[Context] = []
        operator = ops[0] if len(ms) == 1 else ChainedOperator(ops)
        for i, info in enumerate(infos):
            store = StateStore(info, self.backend, self.restore_epoch,
                               self.device)
            coll = (collector if i == len(ms) - 1
                    else operator.make_link(i))
            ctxs.append(Context(info, coll,
                                n_inputs=len(inputs) if i == 0 else 1,
                                state_store=store,
                                control_tx=self.control_resp,
                                restore_watermark=store.restore_watermark()))
            self.members[(ms[i], idx)] = (ops[i], ctxs[i])
        if len(ms) > 1:
            operator.bind(ctxs)
        control_rx: asyncio.Queue = asyncio.Queue()
        runner = TaskRunner(infos[0], operator, ctxs[0], inputs, control_rx,
                            self.control_resp)
        ctxs[0]._runner = runner  # sources poll control through it
        self.subtasks[(head, idx)] = SubtaskHandle(
            infos[0], runner, control_rx,
            isinstance(operator, SourceOperator), list(ms))


class RunningEngine:
    """Control handles over a started engine."""

    def __init__(self, engine: Engine):
        self.engine = engine

    def source_controls(self) -> List[asyncio.Queue]:
        return [h.control_tx for h in self.engine.subtasks.values()
                if h.is_source]

    async def checkpoint(self, epoch: int, min_epoch: int = 0,
                         then_stop: bool = False) -> None:
        """Inject a barrier at all sources."""
        barrier = CheckpointBarrier(epoch, min_epoch, now_micros(), then_stop)
        for q in self.source_controls():
            await q.put(ControlMessage.checkpoint(barrier))

    async def wait_for_checkpoint(self, epoch: int,
                                  timeout: float = 30.0) -> bool:
        """Block until every subtask reported ``epoch`` complete; False on
        timeout or when every subtask has exited first."""
        loop = asyncio.get_running_loop()
        # one completion per (member, subtask): a chained runner reports
        # each member
        expected = set(self.engine.members)
        deadline = loop.time() + timeout
        done = {(r.operator_id, r.task_index) for r in self.engine.resps
                if r.kind == "checkpoint_completed"
                and r.subtask_metadata.epoch == epoch}
        while not expected <= done:
            remain = deadline - loop.time()
            if remain <= 0:
                return False
            try:
                resp = await asyncio.wait_for(
                    self.engine.control_resp.get(), timeout=min(remain, 0.25))
            except asyncio.TimeoutError:
                if self.engine.control_resp.empty() and all(
                        h.task is None or h.task.done()
                        for h in self.engine.subtasks.values()):
                    return False
                continue
            self.engine.resps.append(resp)
            if (resp.kind == "checkpoint_completed"
                    and resp.subtask_metadata.epoch == epoch):
                done.add((resp.operator_id, resp.task_index))
        return True

    async def commit(self, epoch: int) -> None:
        """Second phase of checkpoint ``epoch``: a no-op, because none of
        the port's sinks is two-phase (the JAX package's commit only
        reaches two-phase committer sinks)."""

    async def join(self) -> List[ControlResp]:
        """Wait for all subtasks to finish; return the control responses,
        raising if any task failed."""
        tasks = [h.task for h in self.engine.subtasks.values() if h.task]
        await asyncio.gather(*tasks, return_exceptions=True)
        resps = self.engine.resps
        while not self.engine.control_resp.empty():
            resps.append(self.engine.control_resp.get_nowait())
        failures = [r for r in resps if r.kind == "task_failed"]
        if failures:
            raise RuntimeError(
                f"{len(failures)} task(s) failed: "
                + "; ".join(f"{f.operator_id}-{f.task_index}: {f.error}"
                            for f in failures[:5]))
        return resps


class LocalRunner:
    """Run a bounded pipeline to completion in-process, on the CUDA
    device unless ``device="cpu"``."""

    def __init__(self, program: Program, job_id: str = "local-job",
                 device: DeviceLike = None,
                 backend: Optional[BackingStore] = None,
                 restore_epoch: Optional[int] = None):
        self.engine = Engine(program, job_id,
                             backend if backend is not None
                             else InMemoryBackend(),
                             restore_epoch, device)

    async def run_async(self, checkpoint_interval_secs: Optional[float] = None
                        ) -> List[ControlResp]:
        """Run to completion; with ``checkpoint_interval_secs`` a ticker
        checkpoints every that many seconds (epochs 1, 2, ... after the
        restored one) and commits each epoch once every subtask sealed
        it."""
        running = self.engine.start()
        epoch = [self.engine.restore_epoch or 0]
        ticker: Optional[asyncio.Task] = None
        if checkpoint_interval_secs:
            async def tick():
                while True:
                    await asyncio.sleep(checkpoint_interval_secs)
                    epoch[0] += 1
                    e = epoch[0]
                    await running.checkpoint(e)
                    if await running.wait_for_checkpoint(e):
                        await running.commit(e)

            ticker = asyncio.ensure_future(tick())
        try:
            return await running.join()
        finally:
            if ticker:
                ticker.cancel()

    def run(self, checkpoint_interval_secs: Optional[float] = None
            ) -> List[ControlResp]:
        return asyncio.run(self.run_async(checkpoint_interval_secs))
