"""Engine: physical graph construction and execution (port of
``arroyo_tpu.engine.engine``).

Expands the logical graph by parallelism into subtasks, wires forward
(1:1) and shuffle (all-to-all) channels as bounded asyncio queues, runs
one asyncio task per subtask and exposes control handles
(:class:`RunningEngine`).  :class:`LocalRunner` runs a bounded pipeline
to completion in-process.

Left out of the port for now, none of which changes the rows a pipeline
emits: factor-window rewriting, the plan validator, the runtime
sanitizer, the phase profiler, the latency observatory, operator chaining
(the JAX package documents ``ARROYO_CHAIN=0`` as bit-for-bit), metrics
gauges and multi-worker network edges."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..config import config
from ..device import DeviceLike, resolve_device
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
from .build import build_operator
from .context import Collector, Context, OutQueue
from .operator import SourceOperator
from .task import TaskRunner


@dataclass
class SubtaskHandle:
    task_info: TaskInfo
    runner: TaskRunner
    control_tx: asyncio.Queue  # ControlMessage -> task
    is_source: bool
    task: Optional[asyncio.Task] = None


@dataclass
class Engine:
    program: Program
    job_id: str = "local-job"
    backend: BackingStore = field(default_factory=InMemoryBackend)
    restore_epoch: Optional[int] = None
    device: DeviceLike = None

    def __post_init__(self) -> None:
        errors = self.program.validate()
        if errors:
            raise ValueError("; ".join(errors))
        self.device = resolve_device(self.device)
        self.control_resp: asyncio.Queue = asyncio.Queue()
        self.subtasks: Dict[Tuple[str, int], SubtaskHandle] = {}
        self.resps: List[ControlResp] = []

    def start(self) -> "RunningEngine":
        """Build the physical graph and spawn all subtask loops."""
        prog = self.program
        queues: Dict[Tuple[str, int, str, int], asyncio.Queue] = {}
        qsize = config().queue_size

        def queue_for(quad: Tuple[str, int, str, int]) -> asyncio.Queue:
            if quad not in queues:
                queues[quad] = asyncio.Queue(maxsize=qsize)
            return queues[quad]

        for op_id in prog.topo_order():
            node = prog.node(op_id)
            par = node.parallelism
            for idx in range(par):
                edge_groups: List[List[OutQueue]] = []
                for _, dst, edge in prog.graph.out_edges(op_id):
                    dst_par = prog.node(dst).parallelism
                    if edge.typ == EdgeType.FORWARD:
                        # equal parallelism: 1:1; mismatched: fan-in
                        # (src i -> dst i % dst_par) or fan-out (src i ->
                        # every dst j with j % par == i, round-robined)
                        if dst_par > par:
                            group = [OutQueue(queue_for((op_id, idx, dst, j)))
                                     for j in range(dst_par)
                                     if j % par == idx]
                        else:
                            group = [OutQueue(queue_for(
                                (op_id, idx, dst, idx % dst_par)))]
                    else:
                        group = [OutQueue(queue_for((op_id, idx, dst, j)))
                                 for j in range(dst_par)]
                    edge_groups.append(group)
                # (side, queue) per upstream subtask: shuffle-join edges
                # feed their side of a two-input operator
                inputs: List[Tuple[int, asyncio.Queue]] = []
                for src, _, edge in prog.graph.in_edges(op_id):
                    src_par = prog.node(src).parallelism
                    side = edge.typ.join_side or 0
                    if edge.typ == EdgeType.FORWARD and par > src_par:
                        inputs.append((side, queue_for(
                            (src, idx % src_par, op_id, idx))))
                    else:
                        for j in range(src_par):
                            if (edge.typ != EdgeType.FORWARD
                                    or j % par == idx):
                                inputs.append((side, queue_for(
                                    (src, j, op_id, idx))))
                info = TaskInfo(self.job_id, op_id, node.operator.name, idx,
                                par)
                store = StateStore(info, self.backend, self.restore_epoch,
                                   self.device)
                operator = build_operator(node.operator, self.device)
                ctx = Context(info, Collector(edge_groups),
                              n_inputs=len(inputs), state_store=store,
                              control_tx=self.control_resp,
                              restore_watermark=store.restore_watermark())
                control_rx: asyncio.Queue = asyncio.Queue()
                runner = TaskRunner(info, operator, ctx, inputs, control_rx,
                                    self.control_resp)
                ctx._runner = runner
                self.subtasks[(op_id, idx)] = SubtaskHandle(
                    info, runner, control_rx,
                    isinstance(operator, SourceOperator))

        for handle in self.subtasks.values():
            handle.task = asyncio.ensure_future(handle.runner.start())
        return RunningEngine(self)


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
        expected = set(self.engine.subtasks)
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

    def run(self) -> List[ControlResp]:
        async def main():
            return await self.engine.start().join()

        return asyncio.run(main())
