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

The engine services, armed in ``start`` in the JAX package's order before
any subtask is built, each a None-or-instance local at its hook sites
(disarmed, one ``is not None`` test):

* the runtime sanitizer (analysis/sanitizer.py): ``ARROYO_SANITIZE=1``
  (tests/conftest.py sets it for every test); a violation raises
  ``SanitizerError`` in the task that found it, and the run fails;
* the phase profiler (obs/profiler.py): ``ARROYO_PROFILE=1`` or
  ``profiler.arm(job_id)`` before the run; read
  ``profiler.active().snapshot()`` after it.  Its watchdog's sampler
  thread is stopped and joined when ``LocalRunner.run`` returns;
* the latency observatory (obs/latency.py):
  ``ARROYO_LATENCY_SAMPLE_N=32`` (then ``config.reset_config()``) or
  ``latency.arm(job_id, 32)``; read ``sink_quantiles()``,
  ``critical_path()`` and ``snapshot()`` after the run.

Always on, as in the JAX package: the task metrics (obs/metrics.py, the
reference's names; ``metrics.render_metrics()`` is the Prometheus text),
the chain-size and factor-window gauges, and the span ring
(obs/tracing.py, ``tracing.chrome_trace()``).  On the card the same
variables arm them (``env ARROYO_SANITIZE=1 ARROYO_PROFILE=1
ARROYO_LATENCY_SAMPLE_N=32 python3 ...``); they add no kernel launch, no
device allocation and no sync but ``ARROYO_TIMING=1``'s.  Multi-worker
network edges are not ported."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.sanitizer import maybe_sanitizer
from ..config import config
from ..device import DeviceLike, resolve_device
from ..graph.chaining import plan_chains, validate_chain_plan
from ..graph.factor_windows import apply_factor_windows
from ..graph.logical import EdgeType, OpKind, Program
from ..obs import latency as _latency
from ..obs import profiler as _profiler
from ..obs.metrics import (
    CHAIN_MEMBERS,
    TaskMetrics,
    factor_derived_windows_gauge,
    factor_shared_panes_gauge,
    gauge_for_task,
    mesh_carried_gauge,
)
from ..state.backend import BackingStore, InMemoryBackend, ParquetBackend
from ..state.store import StateStore
from ..types import (
    CheckpointBarrier,
    ControlMessage,
    ControlResp,
    StopMode,
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
        self.sanitizer: Optional[Any] = None  # set by start()

    @staticmethod
    def for_local(program: Program, job_id: str = "local-job",
                  checkpoint_url: Optional[str] = None,
                  restore_epoch: Optional[int] = None,
                  device: DeviceLike = None) -> "Engine":
        """An engine checkpointing into ``checkpoint_url`` through the
        Parquet backend (``file://``, a plain path or ``memory://``; the
        JAX package reads and writes the same files), else in memory."""
        backend: BackingStore = (ParquetBackend.for_url(checkpoint_url)
                                 if checkpoint_url else InMemoryBackend())
        return Engine(program, job_id, backend, restore_epoch, device)

    def start(self) -> "RunningEngine":
        """Build the physical graph and spawn all subtask loops: one
        runner per chain head (graph/chaining.py) and per unchained
        operator, at each subtask index."""
        # the services arm before any subtask is built, so collectors,
        # coalescers and contexts capture them: one sanitizer a run, the
        # process-wide profiler and latency observatory when asked for
        self.sanitizer = maybe_sanitizer(self.job_id)
        prof = _profiler.ensure_armed(self.job_id)
        _latency.ensure_armed(self.job_id)
        prog = self.program
        plan = plan_chains(prog)
        validate_chain_plan(prog, plan)
        # set unconditionally: the gauges are process-wide per job_id, so
        # a re-plan must drop them back to 0.  One device carries no
        # shuffle edge on a mesh
        mesh_carried_gauge(self.job_id).set(0)
        kinds = [n.operator.kind for n in prog.nodes()]
        factor_shared_panes_gauge(self.job_id).set(
            kinds.count(OpKind.WINDOW_FACTOR))
        factor_derived_windows_gauge(self.job_id).set(
            kinds.count(OpKind.DERIVED_WINDOW))
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
        if prof is not None:
            # event-loop stall watchdog: one ticker a loop, its sampler
            # thread started lazily (LocalRunner stops it at the end)
            prof.watchdog.ensure_ticker()
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
        metrics = [TaskMetrics(info) for info in infos]
        ops = [build_operator(prog.node(m).operator, self.device)
               for m in ms]
        collector = Collector(edge_groups, metrics[-1], op_id=tail)
        ctxs: List[Context] = []
        operator = ops[0] if len(ms) == 1 else ChainedOperator(infos, ops)
        for i, info in enumerate(infos):
            store = StateStore(info, self.backend, self.restore_epoch,
                               self.device)
            store.sanitizer = self.sanitizer
            coll = (collector if i == len(ms) - 1
                    else operator.make_link(i))
            ctxs.append(Context(info, coll,
                                n_inputs=len(inputs) if i == 0 else 1,
                                state_store=store,
                                control_tx=self.control_resp,
                                restore_watermark=store.restore_watermark(),
                                metrics=metrics[i]))
            self.members[(ms[i], idx)] = (ops[i], ctxs[i])
        if len(ms) > 1:
            operator.bind(ctxs)
        gauge_for_task(infos[0], CHAIN_MEMBERS,
                       "operators fused into this task").set(len(ms))
        control_rx: asyncio.Queue = asyncio.Queue()
        runner = TaskRunner(infos[0], operator, ctxs[0], inputs, control_rx,
                            self.control_resp, sanitizer=self.sanitizer)
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

    def sink_controls(self) -> List[asyncio.Queue]:
        """The control queues of the sinks' subtasks (sinks never
        chain, so each is the head of its runner)."""
        sink_ids = {n.operator_id for n in self.engine.program.sinks()}
        return [h.control_tx for (op_id, _), h in self.engine.subtasks.items()
                if op_id in sink_ids]

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
        """Second phase of the sealed checkpoint ``epoch``: a commit
        message to every sink subtask; two-phase sinks finalize their
        pre-commits of ``epoch`` and earlier."""
        for q in self.sink_controls():
            await q.put(ControlMessage.commit(epoch))

    async def stop(self, mode: StopMode = StopMode.GRACEFUL) -> None:
        """Stop the run: IMMEDIATE reaches every subtask at once, any
        other mode the sources, which end the stream."""
        if mode == StopMode.IMMEDIATE:
            for h in self.engine.subtasks.values():
                await h.control_tx.put(ControlMessage.stop(mode))
        else:
            for q in self.source_controls():
                await q.put(ControlMessage.stop(mode))

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
    device unless ``device="cpu"``; epochs go to the Parquet directory
    ``checkpoint_url``, or stay in memory."""

    def __init__(self, program: Program, job_id: str = "local-job",
                 device: DeviceLike = None,
                 restore_epoch: Optional[int] = None,
                 checkpoint_url: Optional[str] = None):
        self.engine = Engine.for_local(program, job_id, checkpoint_url,
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
            prof = _profiler.active()
            if prof is not None:
                # no thread the services start outlives the run (the
                # profiler stays armed, its buckets kept)
                prof.watchdog.stop()

    def run(self, checkpoint_interval_secs: Optional[float] = None
            ) -> List[ControlResp]:
        return asyncio.run(self.run_async(checkpoint_interval_secs))
