"""State tables — the port of ``arroyo_tpu.state.tables`` for the tables
the port's operators use: :class:`GlobalKeyedState` (source offsets and
timers), :class:`KeyedState` (per-key values with update times: session
windows), :class:`TimeKeyMap` (time -> key -> value: the released
window extrema of a raw-mode window argmax), :class:`BatchBuffer`
(buffered window rows) and :class:`DeviceTable` (device-resident operator
state that checkpoints through snapshot()/restore() of numpy arrays).
``KeyTimeMultiMap`` arrives with the operators that use it."""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..types import Batch


class TableType(Enum):
    GLOBAL = "global"
    TIME_KEY_MAP = "time_key_map"
    KEYED = "keyed"
    BATCH_BUFFER = "batch_buffer"
    DEVICE = "device"


@dataclass
class TableDescriptor:
    name: str
    table_type: TableType
    description: str = ""
    retention_micros: int = 0


def global_table(name: str, description: str = "") -> TableDescriptor:
    return TableDescriptor(name, TableType.GLOBAL, description)


class GlobalKeyedState:
    """kv state visible across all subtasks (source offsets, timers).  Entries
    carry a strictly monotonic per-key insert version and restore is
    newest-version-wins, so a stale copy re-persisted by a peer can never
    win over the owner's entry."""

    def __init__(self) -> None:
        self._data: Dict[Any, Any] = {}
        self._version: Dict[Any, int] = {}

    def insert(self, key: Any, value: Any) -> None:
        from ..types import now_micros

        v = now_micros()
        prev = self._version.get(key, -1)
        self._version[key] = v if v > prev else prev + 1
        self._data[key] = value

    def get(self, key: Any) -> Any:
        return self._data.get(key)

    def snapshot(self) -> List[Tuple[int, Any, Any]]:
        return [(self._version.get(k, 0), k, v)
                for k, v in self._data.items()]

    def restore(self, entries: Iterable[Tuple[int, Any, Any]]) -> None:
        for t, k, v in entries:
            if int(t) >= self._version.get(k, -1):
                self._version[k] = int(t)
                self._data[k] = v

    def __len__(self) -> int:
        return len(self._data)


class TimeKeyMap:
    """time -> key -> value, evicted by time.  Snapshots are the same
    ``[(time, key, value)]`` entries as the JAX package's ``TimeKeyMap``,
    so the table restores across packages in both directions."""

    def __init__(self) -> None:
        self._data: Dict[int, Dict[Any, Any]] = {}

    def insert(self, time: int, key: Any, value: Any) -> None:
        self._data.setdefault(int(time), {})[key] = value

    def get(self, time: int, key: Any) -> Any:
        return self._data.get(int(time), {}).get(key)

    def get_all_for_time(self, time: int) -> Dict[Any, Any]:
        return self._data.get(int(time), {})

    def all_times(self) -> List[int]:
        return sorted(self._data)

    def evict_before(self, time: int) -> None:
        for t in [t for t in self._data if t < time]:
            del self._data[t]

    def snapshot(self) -> List[Tuple[int, Any, Any]]:
        return [(t, k, v) for t, kv in self._data.items()
                for k, v in kv.items()]

    def restore(self, entries: Iterable[Tuple[int, Any, Any]]) -> None:
        for t, k, v in entries:
            self._data.setdefault(int(t), {})[k] = v

    def __len__(self) -> int:
        return sum(len(kv) for kv in self._data.values())


class KeyedState:
    """kv with timestamp; every snapshot is a full one, so a removed
    key is simply absent from the next epoch.

    Interchange contract: ``snapshot()`` / ``restore()`` speak
    ``[(time, key, value)]`` entry lists — the canonical KEYED table
    form the backend persists and filters by key range on rescale.
    Alternate layouts serving the same table (the session-run state in
    state/session_state.py) round-trip this exact form, so epochs
    written under one layout restore under the other."""

    def __init__(self) -> None:
        self._data: Dict[Any, Tuple[int, Any]] = {}

    def insert(self, time: int, key: Any, value: Any) -> None:
        self._data[key] = (int(time), value)

    def get(self, key: Any) -> Any:
        entry = self._data.get(key)
        return entry[1] if entry is not None else None

    def get_time(self, key: Any) -> Optional[int]:
        entry = self._data.get(key)
        return entry[0] if entry is not None else None

    def remove(self, key: Any) -> None:
        self._data.pop(key, None)

    def items(self) -> List[Tuple[Any, Any]]:
        return [(k, v) for k, (_, v) in self._data.items()]

    def snapshot(self) -> List[Tuple[int, Any, Any]]:
        return [(t, k, v) for k, (t, v) in self._data.items()]

    def restore(self, entries: Iterable[Tuple[int, Any, Any]]) -> None:
        for t, k, v in entries:
            self._data[k] = (int(t), v)

    def __len__(self) -> int:
        return len(self._data)

    def n_keys(self) -> int:
        return len(self._data)


class BatchBuffer:
    """Columnar buffered rows for window and join operators: batches are
    appended O(1) and consolidated lazily; range query and eviction are
    vectorized over the merged batch."""

    def __init__(self) -> None:
        self._pending: List[Batch] = []
        self._merged: Optional[Batch] = None

    def append(self, batch: Batch) -> None:
        if len(batch):
            self._pending.append(batch)

    def _consolidate(self) -> Optional[Batch]:
        if self._pending:
            parts = ([self._merged] if self._merged is not None else []) \
                + self._pending
            self._merged = Batch.concat(parts)
            self._pending.clear()
        return self._merged

    def query_range(self, start: int, end: int) -> Optional[Batch]:
        """Rows with start <= timestamp < end."""
        m = self._consolidate()
        if m is None or len(m) == 0:
            return None
        mask = (m.timestamp >= start) & (m.timestamp < end)
        if not mask.any():
            return None
        return m.select(mask)

    def evict_before(self, time: int) -> None:
        m = self._consolidate()
        if m is None:
            return
        mask = m.timestamp >= time
        if not mask.all():
            self._merged = m.select(mask)

    def all(self) -> Optional[Batch]:
        return self._consolidate()

    def contains_keys(self, key_hashes: np.ndarray) -> np.ndarray:
        """Per element: does a buffered row carry this key hash?"""
        m = self._consolidate()
        if m is None or m.key_hash is None:
            return np.zeros(len(key_hashes), dtype=bool)
        return np.isin(key_hashes, m.key_hash)

    def remove_keys(self, key_hashes: np.ndarray) -> None:
        """Drop buffered rows whose key hash is in ``key_hashes`` (the
        semi join's matched and emitted left rows leave its buffer)."""
        m = self._consolidate()
        if m is None or len(m) == 0 or m.key_hash is None:
            return
        keep = ~np.isin(m.key_hash, key_hashes)
        if not keep.all():
            self._merged = m.select(keep)

    def __len__(self) -> int:
        m = self._consolidate()
        return len(m) if m is not None else 0

    def snapshot_batch(self) -> Optional[Batch]:
        return self._consolidate()

    def restore_batch(self, batch: Optional[Batch]) -> None:
        self._merged = batch
        self._pending.clear()


class DeviceTable:
    """Operator-owned device-resident state that participates in
    checkpoints through snapshot() -> dict[str, ndarray] and restore(dict);
    the snapshot copies device planes to the host at the barrier."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, np.ndarray]],
                 restore_fn: Callable[[Dict[str, np.ndarray]], None]):
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn

    def snapshot(self) -> Dict[str, np.ndarray]:
        return self.snapshot_fn()

    def restore(self, arrays: Dict[str, np.ndarray]) -> None:
        self.restore_fn(arrays)


TABLE_CLASSES = {
    TableType.GLOBAL: GlobalKeyedState,
    TableType.TIME_KEY_MAP: TimeKeyMap,
    TableType.KEYED: KeyedState,
    TableType.BATCH_BUFFER: BatchBuffer,
}
