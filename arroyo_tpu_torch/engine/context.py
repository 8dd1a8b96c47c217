"""Task execution context: queues, watermark tracking, barrier alignment,
collection/partitioning and timers (port of ``arroyo_tpu.engine.context``).

The collector partitions whole columnar batches by vectorized key-range
routing on the host.  The JAX package can carry a co-located shuffle as
one on-device all_to_all; with one device per operator the route is the
identity, and that path is not ported."""

from __future__ import annotations

import asyncio
import heapq
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import config
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

    def __init__(self, edge_groups: List[List[OutQueue]]):
        self.edge_groups = edge_groups
        self._rr = [0] * len(edge_groups)  # round-robin cursor per group

    async def collect(self, batch: Batch) -> None:
        if len(batch) == 0:
            return
        for gi, group in enumerate(self.edge_groups):
            n = len(group)
            if n == 1:
                await group[0].send(Message.record(batch))
            elif batch.key_hash is None:
                # unkeyed fan-out: round-robin whole batches
                await group[self._rr[gi] % n].send(Message.record(batch))
                self._rr[gi] += 1
            else:
                from ..native import partition_route

                _, order, bounds = partition_route(batch.key_hash, n)
                for i in range(n):
                    lo, hi = bounds[i], bounds[i + 1]
                    if hi > lo:
                        await group[i].send(
                            Message.record(batch.select(order[lo:hi])))

    async def broadcast(self, msg: Message) -> None:
        """Watermarks/barriers/stop go to every downstream subtask."""
        for group in self.edge_groups:
            for q in group:
                await q.send(msg)


class Context:
    """Per-subtask execution context handed to operators."""

    def __init__(self, task_info: TaskInfo, collector: Collector,
                 n_inputs: int, state_store: Any = None,
                 control_tx: Optional[asyncio.Queue] = None,
                 restore_watermark: Optional[int] = None):
        self.task_info = task_info
        self.collector = collector
        self.watermarks = WatermarkHolder(max(n_inputs, 1))
        self.counter = CheckpointCounter(max(n_inputs, 1))
        self.timers = TimerHeap()
        self.state = state_store
        self.control_tx = control_tx
        self.last_watermark: Optional[int] = restore_watermark
        self.n_inputs = n_inputs
        self._runner: Any = None  # sources poll control through it

    async def collect(self, batch: Batch) -> None:
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
            return combined
        return None
