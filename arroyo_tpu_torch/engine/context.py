"""Task execution context: queues, watermark tracking, barrier alignment,
collection/partitioning and timers (port of ``arroyo_tpu.engine.context``).

The collector partitions whole columnar batches by vectorized key-range
routing on the host or, when a shuffle edge's destinations are
co-located and ``parallel/shuffle.device_shuffle_enabled`` says so (a
key mesh of at least that many shards), by one device exchange over the
runner's mesh (``DeviceShuffle``), whose rows per destination are the
host route's.  The choice is made once an edge and holds for its life;
with the runtime sanitizer armed, every keyed multi-destination batch
reports it (``on_sharding``), so a flip fails the run.

The collector counts records sent and backpressure into the task's
metrics and, with the phase profiler armed, charges its partition and
route work to ``shuffle_prep`` and its enqueue awaits to the
``send_wait`` wait phase; with the latency observatory armed, the
context re-attaches the current input's ingest stamp to batches an
operator built (``collect``) and notes the age of each watermark it
advances to (``observe_watermark``)."""

from __future__ import annotations

import asyncio
import heapq
import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import config
from ..obs import latency as _latency
from ..obs import profiler
from ..types import Batch, ControlResp, Message, TaskInfo, Watermark


class WatermarkHolder:
    """The current watermark is the min across all inputs, Idle inputs
    excluded; None until every input has reported."""

    def __init__(self, n_inputs: int):
        self.watermarks: List[Optional[Watermark]] = [None] * n_inputs

    def set(self, idx: int, wm: Watermark) -> Optional[int]:
        self.watermarks[idx] = wm
        return self.value()

    def value(self) -> Optional[int]:
        mins: List[int] = []
        for w in self.watermarks:
            if w is None:
                return None  # an input has never reported: undefined
            if not w.is_idle:
                mins.append(w.time)
        return min(mins) if mins else None

    def all_idle(self) -> bool:
        return all(w is not None and w.is_idle for w in self.watermarks)


class CheckpointCounter:
    """Barrier alignment across inputs; inputs that ended are excluded so
    a finished source doesn't deadlock checkpoints."""

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self.seen: Dict[int, set] = {}
        self.closed: set = set()

    def _aligned(self, epoch: int) -> bool:
        return len(self.seen.get(epoch, set()) | self.closed) >= self.n_inputs

    def observe(self, idx: int, epoch: int) -> bool:
        """Record a barrier from input ``idx``; True when all aligned."""
        self.seen.setdefault(epoch, set()).add(idx)
        if self._aligned(epoch):
            del self.seen[epoch]
            return True
        return False

    def mark_closed(self, idx: int) -> List[int]:
        """Input ended: returns epochs that are now complete, in order."""
        self.closed.add(idx)
        ready = sorted(e for e in self.seen if self._aligned(e))
        for e in ready:
            del self.seen[e]
        return ready


@dataclass(order=True)
class _Timer:
    time: int
    key: Any = field(compare=False)
    payload: Any = field(compare=False)


class TimerHeap:
    """Host-side event-time timer service, snapshot into checkpoints."""

    def __init__(self) -> None:
        self._heap: List[_Timer] = []
        self._set: Dict[Any, int] = {}

    def schedule(self, time: int, key: Any, payload: Any = None) -> None:
        prev = self._set.get(key)
        if prev is not None and prev <= time:
            return  # keep earliest
        self._set[key] = time
        heapq.heappush(self._heap, _Timer(int(time), key, payload))

    def fire(self, watermark: int) -> List[Tuple[int, Any, Any]]:
        """Pop all timers with time <= watermark, in time order."""
        fired = []
        while self._heap and self._heap[0].time <= watermark:
            t = heapq.heappop(self._heap)
            if self._set.get(t.key) == t.time:
                del self._set[t.key]
                fired.append((t.time, t.key, t.payload))
        return fired

    def snapshot(self) -> List[Tuple[int, Any, Any]]:
        return [(t.time, t.key, t.payload) for t in self._heap
                if self._set.get(t.key) == t.time]

    def restore(self, entries: Sequence[Tuple[int, Any, Any]]) -> None:
        for time, key, payload in entries:
            self.schedule(time, key, payload)


class OutQueue:
    """One outgoing edge endpoint to a specific downstream subtask."""

    def __init__(self, queue: Optional[asyncio.Queue] = None):
        self.queue = (queue if queue is not None
                      else asyncio.Queue(maxsize=config().queue_size))

    async def send(self, msg: Message) -> None:
        await self.queue.put(msg)


class Collector:
    """Hash-partitioned fan-out of output batches.  ``edge_groups`` holds
    one group per downstream operator: a single queue for forward edges,
    one queue per downstream subtask for shuffle edges."""

    def __init__(self, edge_groups: List[List[OutQueue]],
                 metrics: Optional[Any] = None, op_id: str = "",
                 sanitizer: Optional[Any] = None, subtask: int = 0,
                 mesh: Sequence[Any] = ()):
        self.edge_groups = edge_groups
        self.metrics = metrics
        self.op_id = op_id
        # the sanitizer's per-edge sharding stability (None unless armed);
        # the edge key carries the producing subtask
        self.sanitizer = sanitizer
        self.subtask = subtask
        # the runner's key mesh: the devices a device shuffle exchanges
        # over
        self.mesh = list(mesh)
        # phase profiler: None unless armed at engine build
        self.prof = profiler.active()
        self._rr = [0] * len(edge_groups)  # round-robin cursor per group
        self._local_qs = [q.queue for g in edge_groups for q in g]
        # decided at a group's first keyed batch: a DeviceShuffle, or None
        # for the host route for the edge's life
        self._dev_shuffle: Dict[int, Optional[Any]] = {}

    def _device_shuffle_for(self, gi: int, n: int) -> Optional[Any]:
        if gi in self._dev_shuffle:
            return self._dev_shuffle[gi]
        from ..parallel import shuffle as _shuffle

        ds = (_shuffle.DeviceShuffle(n, self.mesh, op_id=self.op_id)
              if self.mesh and _shuffle.device_shuffle_enabled(n, self.mesh)
              else None)
        self._dev_shuffle[gi] = ds
        return ds

    def _update_queue_gauges(self) -> None:
        # backpressure visibility: capacity and remaining slots across
        # this subtask's outbound queues
        qs = self._local_qs
        if qs:
            self.metrics.tx_queue_size.set(sum(q.maxsize for q in qs))
            self.metrics.tx_queue_rem.set(
                sum(max(q.maxsize - q.qsize(), 0) for q in qs))

    async def collect(self, batch: Batch) -> None:
        if len(batch) == 0:
            return
        blocked = 0.0
        send = None
        prof = self.prof
        if self.metrics is not None or prof is not None:
            if self.metrics is not None:
                self.metrics.messages_sent.inc(len(batch))
                self._update_queue_gauges()

            async def send(q, msg):
                # time only the enqueue await: a full downstream queue
                # parks here, so the wait is backpressure; with the
                # profiler armed it is a `send_wait` wait child, so the
                # enclosing work phases stay exclusive
                nonlocal blocked
                frame = (prof.begin(self.op_id, "send_wait", wait=True)
                         if prof is not None else None)
                t0 = _time.perf_counter()
                try:
                    await q.send(msg)
                finally:
                    if frame is not None:
                        prof.end(frame)
                blocked += _time.perf_counter() - t0

        pframe = (prof.begin(self.op_id, "shuffle_prep")
                  if prof is not None else None)
        try:
            for gi, group in enumerate(self.edge_groups):
                n = len(group)
                if n == 1:
                    q, m = group[0], Message.record(batch)
                    await (send(q, m) if send else q.send(m))
                elif batch.key_hash is None:
                    # unkeyed fan-out: round-robin whole batches
                    q, m = group[self._rr[gi] % n], Message.record(batch)
                    await (send(q, m) if send else q.send(m))
                    self._rr[gi] += 1
                else:
                    ds = self._device_shuffle_for(gi, n)
                    parts = ds.route(batch) if ds is not None else None
                    if self.sanitizer is not None:
                        self.sanitizer.on_sharding(
                            (self.op_id, self.subtask, gi),
                            f"keys@{n}" if parts is not None
                            else f"host@{n}")
                    if parts is not None:
                        # the device exchange ran; destinations get their
                        # rows in the host route's order
                        for i, sub in parts:
                            q, m = group[i], Message.record(sub)
                            await (send(q, m) if send else q.send(m))
                        continue
                    from ..native import partition_route
                    from ..obs import perf as _perf
                    from ..parallel.shuffle import HOST_ROUTES

                    _perf.count(HOST_ROUTES)
                    _, order, bounds = partition_route(batch.key_hash, n)
                    for i in range(n):
                        lo, hi = bounds[i], bounds[i + 1]
                        if hi > lo:
                            q = group[i]
                            m = Message.record(batch.select(order[lo:hi]))
                            await (send(q, m) if send else q.send(m))
        finally:
            if pframe is not None:
                prof.end(pframe)
        if blocked > 1e-5 and self.metrics is not None:
            self.metrics.backpressure_time.inc(blocked)

    async def broadcast(self, msg: Message) -> None:
        """Watermarks/barriers/stop go to every downstream subtask.  With
        the profiler armed each enqueue is a ``send_wait`` wait child, as
        in ``collect``, so a park on a full queue is not charged to the
        caller's work phase (the JAX package charges it there)."""
        prof = self.prof
        for group in self.edge_groups:
            for q in group:
                if prof is None:
                    await q.send(msg)
                    continue
                frame = prof.begin(self.op_id, "send_wait", wait=True)
                try:
                    await q.send(msg)
                finally:
                    prof.end(frame)


class Context:
    """Per-subtask execution context handed to operators."""

    def __init__(self, task_info: TaskInfo, collector: Collector,
                 n_inputs: int, state_store: Any = None,
                 control_tx: Optional[asyncio.Queue] = None,
                 restore_watermark: Optional[int] = None,
                 metrics: Optional[Any] = None):
        self.task_info = task_info
        self.collector = collector
        self.metrics = (metrics if metrics is not None
                        else getattr(collector, "metrics", None))
        self.watermarks = WatermarkHolder(max(n_inputs, 1))
        self.counter = CheckpointCounter(max(n_inputs, 1))
        self.timers = TimerHeap()
        self.state = state_store
        self.control_tx = control_tx
        self.last_watermark: Optional[int] = restore_watermark
        self.n_inputs = n_inputs
        self._runner: Any = None  # sources poll control through it
        # latency observatory: None unless armed at engine build
        self.lat = _latency.active()

    async def collect(self, batch: Batch) -> None:
        if self.lat is not None and batch.lat_stamp is None:
            # re-attach the current input batch's stamp to batches an
            # operator built (maps, chain tails, join matches); window
            # fires carry their own inherited stamp and skip this
            batch.lat_stamp = _latency.current()
        await self.collector.collect(batch)

    async def broadcast(self, msg: Message) -> None:
        await self.collector.broadcast(msg)

    async def report(self, resp: ControlResp) -> None:
        if self.control_tx is not None:
            await self.control_tx.put(resp)

    def observe_watermark(self, input_idx: int, wm: Watermark
                          ) -> Optional[int]:
        """Returns the new combined watermark iff it advanced."""
        combined = self.watermarks.set(input_idx, wm)
        if combined is None:
            return None
        if self.last_watermark is None or combined > self.last_watermark:
            self.last_watermark = combined
            if self.lat is not None:
                # watermark lineage: the age of the watermark this
                # operator just advanced to
                self.lat.note_edge_watermark(self.task_info.operator_id,
                                             combined)
            return combined
        return None
