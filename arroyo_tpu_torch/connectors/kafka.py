"""Kafka source and transactional sink over the in-process broker (port
of ``arroyo_tpu.connectors.kafka``).

The source owns the topic partitions ``p % parallelism == task_index``,
keeps each partition's last-read offset in global table ``s`` and resumes
after a restore from the offset after it — exactly once, because a
fetch is decoded and emitted downstream before its offset is recorded
and before the source looks at its control queue, where checkpoint
barriers arrive.  A ``read_committed`` source sees only the records of
committed transactions.

The sink is a two-phase committer (connectors/two_phase.py): its rows go
into an open transaction, a checkpoint barrier seals that transaction as
the epoch's pre-commit (the next rows open a new one, so each open
transaction has its own producer id), and the commit phase commits it.
Payloads are the rows through ``make_format`` (json, debezium_json, raw,
avro).

``bootstrap_servers='memory://<name>'`` selects the process-global
:class:`InMemoryKafkaBroker` of that name.  It is this package's own
registry, separate from the JAX package's.  Any other bootstrap raises:
the JAX package's aiokafka adapter for real brokers is not ported."""

from __future__ import annotations

import asyncio
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..config import config
from ..engine.context import Context
from ..engine.operator import SourceFinishType, SourceOperator
from ..formats import make_format
from ..obs import profiler
from ..obs.latency import maybe_stamp
from ..state.tables import TableDescriptor, global_table
from ..types import StopMode
from .registry import ConnectorMeta, register_connector
from .two_phase import TwoPhaseCommitterSink


@dataclass
class KafkaConfig:
    bootstrap_servers: str
    topic: str
    group_id: Optional[str] = None
    format: str = "json"
    offset: str = "earliest"  # 'earliest' | 'latest' when no stored state
    read_mode: str = "read_committed"  # | 'read_uncommitted'
    batch_size: Optional[int] = None
    format_options: Dict[str, Any] = field(default_factory=dict)
    client_configs: Dict[str, str] = field(default_factory=dict)
    max_messages: Optional[int] = None  # bounded runs

    def __post_init__(self) -> None:
        if self.offset not in ("earliest", "latest"):
            raise ValueError(f"offset must be earliest|latest, not "
                             f"{self.offset!r}")
        if self.read_mode not in ("read_committed", "read_uncommitted"):
            raise ValueError(f"read_mode must be read_committed|"
                             f"read_uncommitted, not {self.read_mode!r}")
        for name in ("batch_size", "max_messages"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, int(v))


# -- in-memory broker ---------------------------------------------------------------


@dataclass
class _KRecord:
    partition: int
    offset: int
    key: Optional[bytes]
    value: bytes


@dataclass
class _Partition:
    log: List[Tuple[Optional[bytes], bytes]] = field(default_factory=list)
    # records below this offset belong to committed transactions
    committed_watermark: int = 0


class InMemoryKafkaBroker:
    """A tiny transactional log: partitions, append, fetch-from-offset,
    and transaction begin/commit/abort with a last-stable offset."""

    _instances: Dict[str, "InMemoryKafkaBroker"] = {}

    def __init__(self) -> None:
        self.topics: Dict[str, List[_Partition]] = {}
        self._txns: Dict[str, List[Tuple[str, int, Optional[bytes],
                                         bytes]]] = {}

    @classmethod
    def get(cls, name: str) -> "InMemoryKafkaBroker":
        return cls._instances.setdefault(name, cls())

    @classmethod
    def reset(cls, name: str) -> None:
        cls._instances.pop(name, None)

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        self.topics.setdefault(topic,
                               [_Partition() for _ in range(partitions)])

    def partitions(self, topic: str) -> int:
        self.create_topic(topic)
        return len(self.topics[topic])

    def latest_offset(self, topic: str, partition: int) -> int:
        self.create_topic(topic)
        return len(self.topics[topic][partition].log)

    # -- produce ------------------------------------------------------------

    def produce(self, topic: str, value: bytes, key: Optional[bytes] = None,
                partition: Optional[int] = None) -> int:
        self.create_topic(topic)
        parts = self.topics[topic]
        p = (partition if partition is not None
             else (hash(key) if key else len(parts[0].log)) % len(parts))
        parts[p].log.append((key, value))
        parts[p].committed_watermark = len(parts[p].log)
        return len(parts[p].log) - 1

    def begin_txn(self, txn_id: str) -> None:
        self._txns[txn_id] = []

    def produce_txn(self, txn_id: str, topic: str, value: bytes,
                    key: Optional[bytes] = None,
                    partition: Optional[int] = None) -> None:
        self.create_topic(topic)
        p = (partition if partition is not None
             else 0 if key is None else hash(key) % self.partitions(topic))
        self._txns[txn_id].append((topic, p, key, value))

    def commit_txn(self, txn_id: str) -> None:
        for topic, p, key, value in self._txns.pop(txn_id, []):
            part = self.topics[topic][p]
            part.log.append((key, value))
            part.committed_watermark = len(part.log)

    def abort_txn(self, txn_id: str) -> None:
        self._txns.pop(txn_id, None)

    # -- fetch ----------------------------------------------------------------

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int, read_committed: bool = True
              ) -> List[_KRecord]:
        self.create_topic(topic)
        part = self.topics[topic][partition]
        hi = part.committed_watermark if read_committed else len(part.log)
        return [_KRecord(partition, off, *part.log[off])
                for off in range(max(offset, 0),
                                 min(hi, offset + max_records))]

    def fetch_values(self, topic: str, partition: int, offset: int,
                     max_records: int, read_committed: bool = True
                     ) -> Tuple[List[bytes], int]:
        """Bulk fetch: (payload values, last offset) without per-record
        envelope objects — the source's hot loop."""
        self.create_topic(topic)
        part = self.topics[topic][partition]
        hi = part.committed_watermark if read_committed else len(part.log)
        a, b = max(offset, 0), min(hi, offset + max_records)
        if b <= a:
            return [], offset - 1
        return [v for _, v in part.log[a:b]], b - 1


def make_broker(bootstrap_servers: str, client_configs: Dict[str, str]
                ) -> InMemoryKafkaBroker:
    """memory://<name> -> the in-process broker of that name."""
    if bootstrap_servers.startswith("memory://"):
        return InMemoryKafkaBroker.get(bootstrap_servers[len("memory://"):])
    raise NotImplementedError(
        f"kafka bootstrap {bootstrap_servers!r}: the port reads and writes "
        "only the in-process broker (memory://<name>)")


# -- source -------------------------------------------------------------------------


class KafkaSource(SourceOperator):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("kafka_source")
        self.cfg = KafkaConfig(**cfg)
        self.fmt = make_format(self.cfg.format, **self.cfg.format_options)

    def tables(self) -> List[TableDescriptor]:
        # table 's': partition -> last-read offset
        return [global_table("s", "kafka partition offsets")]

    async def run(self, ctx: Context) -> SourceFinishType:
        broker = make_broker(self.cfg.bootstrap_servers,
                             self.cfg.client_configs)
        state = ctx.state.get_global_keyed_state("s")
        read_committed = self.cfg.read_mode == "read_committed"
        topic = self.cfg.topic
        me, n = ctx.task_info.task_index, ctx.task_info.parallelism
        my_parts = [p for p in range(broker.partitions(topic))
                    if p % n == me]
        if not my_parts:
            return SourceFinishType.FINAL
        offsets: Dict[int, int] = {}
        for p in my_parts:
            stored = state.get(p)
            if stored is not None:
                offsets[p] = stored + 1
            elif self.cfg.offset == "latest":
                offsets[p] = broker.latest_offset(topic, p)
            else:
                offsets[p] = 0

        batch_size = self.cfg.batch_size or config().target_batch_size
        total = 0
        idle_spins = 0
        prof = profiler.active()
        op_id = ctx.task_info.operator_id
        while True:
            got = 0
            for p in my_parts:
                vals, last = broker.fetch_values(topic, p, offsets[p],
                                                 batch_size, read_committed)
                if vals:
                    got += len(vals)
                    total += len(vals)
                    # decode is the `source_decode` phase, and the decoded
                    # batch is stamped, as the JAX package's source
                    # batcher does (arroyo_tpu/engine/coalesce.py)
                    frame = (prof.begin(op_id, "source_decode")
                             if prof is not None else None)
                    batch = self.fmt.batch(vals)
                    if frame is not None:
                        prof.end(frame)
                    maybe_stamp(op_id, batch)
                    await ctx.collect(batch)
                    offsets[p] = last + 1
                    state.insert(p, last)
            cm = await ctx._runner.poll_source_control()
            if cm is not None and cm.kind == "stop":
                return (SourceFinishType.GRACEFUL
                        if cm.stop_mode != StopMode.IMMEDIATE
                        else SourceFinishType.IMMEDIATE)
            if self.cfg.max_messages is not None and \
                    total >= self.cfg.max_messages:
                return SourceFinishType.FINAL
            if got == 0:
                idle_spins += 1
                if self.cfg.max_messages is not None and idle_spins > 50:
                    return SourceFinishType.FINAL  # bounded run drained
                await asyncio.sleep(0.01)
            else:
                idle_spins = 0
                await asyncio.sleep(0)


# -- sink (transactional, exactly once) ---------------------------------------------


class KafkaSink(TwoPhaseCommitterSink):
    _txn_counter = itertools.count()

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("kafka_sink")
        self.cfg = KafkaConfig(**cfg)
        self.fmt = make_format(self.cfg.format, **self.cfg.format_options)
        self._txn_id: Optional[str] = None
        self._subtask = 0
        self._b: Optional[InMemoryKafkaBroker] = None

    def _broker(self) -> InMemoryKafkaBroker:
        if self._b is None:
            self._b = make_broker(self.cfg.bootstrap_servers,
                                  self.cfg.client_configs)
        return self._b

    async def committer_init(self, recovery_state, ctx: Context) -> None:
        self._subtask = ctx.task_info.task_index

    def _ensure_txn(self) -> str:
        if self._txn_id is None:
            self._txn_id = (f"arroyo-{self.cfg.topic}-{self._subtask}-"
                            f"{next(self._txn_counter)}")
            self._broker().begin_txn(self._txn_id)
        return self._txn_id

    async def insert_batch(self, batch, ctx: Context) -> None:
        txn = self._ensure_txn()
        broker = self._broker()
        for payload in self.fmt.serialize_batch(batch):
            broker.produce_txn(txn, self.cfg.topic, payload)

    async def committer_checkpoint(self, epoch: int, stopping: bool,
                                   ctx: Context):
        # the open transaction is the epoch's pre-commit; the next insert
        # opens a new one, committed in phase two
        txn, self._txn_id = self._txn_id, None
        return None, ({txn: {"txn_id": txn}} if txn is not None else {})

    async def committer_commit(self, epoch: int, pre_commits,
                               ctx: Context) -> None:
        broker = self._broker()
        for pc in pre_commits.values():
            broker.commit_txn(pc["txn_id"])

    async def on_close(self, ctx: Context) -> None:
        # the stream ended without a barrier after these rows: commit the
        # open transaction, as no commit phase will come for it
        if self._txn_id is not None:
            self._broker().commit_txn(self._txn_id)
            self._txn_id = None


register_connector(ConnectorMeta(
    name="kafka",
    description="kafka source (offset state) / transactional exactly-once "
                "sink over the in-process broker",
    source_factory=KafkaSource,
    sink_factory=KafkaSink,
    config_model=KafkaConfig,
))
