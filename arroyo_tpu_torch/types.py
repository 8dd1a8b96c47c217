"""Core data model: batches, messages, watermarks, barriers, task metadata
and key hashing (copied from ``arroyo_tpu.types``; hashes and key-range
routing are bit-identical, which the port tests check).

The unit of dataflow is a columnar :class:`Batch` of host numpy arrays;
event time is int64 microseconds.  Key hashes stay uint64 numpy arrays on
the host (device kernels see dense slot ids, never hashes)."""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

U64_MAX = np.uint64(0xFFFF_FFFF_FFFF_FFFF)

# "final" watermark on close (the reference's u64::MAX final watermark)
MAX_TIMESTAMP = np.int64(2**63 - 1)


def now_micros() -> int:
    """Current wall-clock time in microseconds (event-time domain)."""
    return _time.time_ns() // 1_000


# -- key-range partitioning ---------------------------------------------------


def server_for_hash(x: int, n: int) -> int:
    """Map a u64 key hash to one of ``n`` contiguous key ranges:
    ``min(n - 1, x / (u64::MAX / n))``."""
    range_size = int(U64_MAX) // n
    return min(n - 1, int(x) // range_size)


def server_for_hash_array(x: np.ndarray, n: int) -> np.ndarray:
    """Vectorized :func:`server_for_hash` over a uint64 array."""
    range_size = np.uint64(int(U64_MAX) // n)
    idx = (x.astype(np.uint64) // range_size).astype(np.int64)
    return np.minimum(idx, n - 1)


def range_for_server(i: int, n: int) -> Tuple[int, int]:
    """Inclusive [start, end] u64 key range owned by shard ``i`` of ``n``."""
    range_size = int(U64_MAX) // n
    start = range_size * i
    end = int(U64_MAX) if i + 1 == n else start + range_size - 1
    return (start, end)


# -- hashing: stable vectorized 64-bit key hashing ---------------------------

_SPLITMIX_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _py_hash_u64(x: np.ndarray) -> np.ndarray:
    """numpy splitmix64: the version the host library must equal bit for
    bit."""
    with np.errstate(over="ignore"):
        z = np.asarray(x).astype(np.uint64) + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * _SPLITMIX_C1
        z = (z ^ (z >> np.uint64(27))) * _SPLITMIX_C2
        return z ^ (z >> np.uint64(31))


def hash_u64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over an integer array -> uint64 hashes,
    through the host library when it is loaded."""
    from . import native

    return native.hash_u64(x)


def hash_any_column(col: np.ndarray) -> np.ndarray:
    """Hash an arbitrary column (ints, floats, strings/objects) to uint64."""
    if np.issubdtype(col.dtype, np.integer):
        return hash_u64(col)
    if np.issubdtype(col.dtype, np.floating):
        return hash_u64(col.astype(np.float64).view(np.uint64))
    import pandas as pd  # strings/objects only

    return pd.util.hash_array(np.asarray(col, dtype=object), categorize=False)


def hash_columns(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Combine multiple column hashes into one composite uint64 key hash."""
    if not cols:
        raise ValueError("need at least one key column")
    from . import native

    acc = hash_any_column(cols[0])
    for c in cols[1:]:
        acc = native.hash_combine(acc, hash_any_column(c))
    return acc


# -- Batch: the columnar record envelope --------------------------------------


@dataclass
class Batch:
    """A columnar batch of records flowing along one dataflow edge.

    ``timestamp`` is int64 event-time micros (one per row); ``key_hash`` is
    the uint64 hash of the key columns (present iff the edge is keyed)."""

    timestamp: np.ndarray  # int64[n] micros
    columns: Dict[str, np.ndarray]
    key_hash: Optional[np.ndarray] = None  # uint64[n]
    key_cols: Tuple[str, ...] = ()
    # Latency-observatory ingest stamp (obs/latency.py): wall-clock micros
    # of the oldest sampled record this batch carries, or None.  A side
    # annotation, never a column, so the coalescer's and the sanitizer's
    # layout signatures (columns, key_cols, key_hash) never see it.
    lat_stamp: Optional[int] = None

    def __post_init__(self) -> None:
        self.timestamp = np.asarray(self.timestamp, dtype=np.int64)

    def __len__(self) -> int:
        return int(self.timestamp.shape[0])

    def with_key(self, key_cols: Sequence[str]) -> "Batch":
        """Return a batch keyed by ``key_cols`` (computes key_hash)."""
        kh = hash_columns([self.columns[c] for c in key_cols])
        return Batch(self.timestamp, dict(self.columns), kh, tuple(key_cols),
                     lat_stamp=self.lat_stamp)

    def select(self, mask_or_idx: np.ndarray) -> "Batch":
        """Row subset by boolean mask or integer index array."""
        cols = {k: v[mask_or_idx] for k, v in self.columns.items()}
        kh = self.key_hash[mask_or_idx] if self.key_hash is not None else None
        return Batch(self.timestamp[mask_or_idx], cols, kh, self.key_cols,
                     lat_stamp=self.lat_stamp)

    @staticmethod
    def concat(batches: Sequence["Batch"]) -> "Batch":
        if not batches:
            raise ValueError("concat of no batches")
        if len(batches) == 1:
            return batches[0]
        ts = np.concatenate([b.timestamp for b in batches])
        names = batches[0].columns.keys()
        cols = {n: np.concatenate([b.columns[n] for b in batches])
                for n in names}
        kh = None
        if batches[0].key_hash is not None:
            kh = np.concatenate([b.key_hash for b in batches])
        # the oldest sampled ingest wins: coalescer linger is charged to
        # latency
        stamps = [b.lat_stamp for b in batches if b.lat_stamp is not None]
        return Batch(ts, cols, kh, batches[0].key_cols,
                     lat_stamp=min(stamps) if stamps else None)

    # Arrow interop (checkpoints); pyarrow is imported only here
    def arrow_arrays(self) -> Dict[str, Any]:
        """Column name -> pyarrow array, with the JAX package's numpy ->
        arrow rules (checkpoints of either package read alike)."""
        import pyarrow as pa

        arrays = {"__timestamp": pa.array(self.timestamp, type=pa.int64())}
        for k, v in self.columns.items():
            arrays[k] = pa.array(v.tolist() if v.dtype == object else v)
        return arrays

    def to_arrow(self):
        import pyarrow as pa

        return pa.table(self.arrow_arrays())

    @staticmethod
    def from_arrow(table) -> "Batch":
        cols = {}
        ts = None
        for name in table.column_names:
            arr = table.column(name).combine_chunks().to_numpy(
                zero_copy_only=False)
            if name == "__timestamp":
                ts = arr.astype(np.int64)
            else:
                cols[name] = arr
        if ts is None:
            raise ValueError("arrow table missing __timestamp")
        return Batch(ts, cols)


# -- updating streams: the retraction data model ------------------------------


class UpdateOp(Enum):
    """Row-level operation for updating streams (Debezium c/u/d model)."""

    CREATE = 0
    UPDATE = 1
    DELETE = 2


UPDATE_OP_COLUMN = "__op"  # int8 column carrying UpdateOp on updating edges


# -- watermarks, barriers, control messages -----------------------------------


class WatermarkKind(Enum):
    EVENT_TIME = "event_time"
    IDLE = "idle"


@dataclass(frozen=True)
class Watermark:
    kind: WatermarkKind
    time: int = 0  # micros; meaningful iff kind == EVENT_TIME

    @staticmethod
    def event_time(t: int) -> "Watermark":
        return Watermark(WatermarkKind.EVENT_TIME, int(t))

    @staticmethod
    def idle() -> "Watermark":
        return Watermark(WatermarkKind.IDLE)

    @property
    def is_idle(self) -> bool:
        return self.kind == WatermarkKind.IDLE


@dataclass(frozen=True)
class CheckpointBarrier:
    epoch: int
    min_epoch: int
    timestamp: int  # micros
    then_stop: bool = False


class MessageKind(Enum):
    RECORD = "record"
    WATERMARK = "watermark"
    BARRIER = "barrier"
    STOP = "stop"
    END_OF_DATA = "end_of_data"


@dataclass
class Message:
    kind: MessageKind
    batch: Optional[Batch] = None
    watermark: Optional[Watermark] = None
    barrier: Optional[CheckpointBarrier] = None

    @staticmethod
    def record(batch: Batch) -> "Message":
        return Message(MessageKind.RECORD, batch=batch)

    @staticmethod
    def wm(w: Watermark) -> "Message":
        return Message(MessageKind.WATERMARK, watermark=w)

    @staticmethod
    def barrier_msg(b: CheckpointBarrier) -> "Message":
        return Message(MessageKind.BARRIER, barrier=b)

    @staticmethod
    def stop() -> "Message":
        return Message(MessageKind.STOP)

    @staticmethod
    def end_of_data() -> "Message":
        return Message(MessageKind.END_OF_DATA)

    @property
    def is_end(self) -> bool:
        return self.kind in (MessageKind.STOP, MessageKind.END_OF_DATA)


# -- task metadata --------------------------------------------------------------


@dataclass
class TaskInfo:
    """Identity + key range of one parallel subtask of one operator."""

    job_id: str
    operator_id: str
    operator_name: str
    task_index: int
    parallelism: int

    @property
    def key_range(self) -> Tuple[int, int]:
        return range_for_server(self.task_index, self.parallelism)

    @property
    def task_id(self) -> str:
        return f"{self.operator_id}-{self.task_index}"


# -- control plane messages -----------------------------------------------------


class StopMode(Enum):
    GRACEFUL = "graceful"  # propagate Stop through the dataflow
    IMMEDIATE = "immediate"  # stop now


@dataclass
class ControlMessage:
    kind: str  # 'checkpoint' | 'stop' | 'commit'
    barrier: Optional[CheckpointBarrier] = None
    stop_mode: Optional[StopMode] = None
    epoch: Optional[int] = None

    @staticmethod
    def checkpoint(barrier: CheckpointBarrier) -> "ControlMessage":
        return ControlMessage("checkpoint", barrier=barrier)

    @staticmethod
    def stop(mode: StopMode = StopMode.GRACEFUL) -> "ControlMessage":
        return ControlMessage("stop", stop_mode=mode)

    @staticmethod
    def commit(epoch: int) -> "ControlMessage":
        return ControlMessage("commit", epoch=epoch)


@dataclass
class SubtaskCheckpointMetadata:
    epoch: int
    operator_id: str
    subtask_index: int
    start_time: int
    finish_time: int
    bytes: int
    watermark: Optional[int] = None
    tables: Dict[str, "TableCheckpointMetadata"] = field(default_factory=dict)
    # a COMMIT_WRITES table's entries: table -> {key: value}
    committing_data: Optional[Dict[str, Any]] = None


@dataclass
class TableCheckpointMetadata:
    """One table's files of a subtask's checkpoint and its key-hash span."""

    table: str
    files: Tuple[str, ...] = ()
    min_key_hash: int = 0
    max_key_hash: int = int(U64_MAX)


@dataclass
class ControlResp:
    """Task -> controller responses."""

    kind: str  # 'checkpoint_completed'|'task_started'|'task_finished'|'task_failed'
    operator_id: str = ""
    task_index: int = 0
    subtask_metadata: Optional[SubtaskCheckpointMetadata] = None
    error: Optional[str] = None
