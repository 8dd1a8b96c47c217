"""StateStore — the typed state facade operators use (port of
``arroyo_tpu.state.store``).  Tables are registered by descriptor; the
store snapshots every table at a barrier and restores them from the
backing store, filtered by the task's key range.  Join-side buffers and session
interval runs live on the store's device, the runner's.

At each checkpoint the store refreshes the per-table key-count gauges
(``arroyo_worker_table_size_keys``) and, with the runtime sanitizer
armed, checks that no table changed size between the snapshot and its
persistence (``mutation-during-checkpoint``).  The snapshot of a table
written with ``WriteBehavior.COMMIT_WRITES`` (a two-phase sink's
pre-commits) rides the checkpoint metadata as ``committing_data``, for
the controller that drives the commit phase."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..device import DeviceLike
from ..obs.metrics import table_size_gauge
from ..types import SubtaskCheckpointMetadata, TaskInfo
from .backend import BackingStore, ParquetBackend, TableSnapshot
from .tables import (
    TABLE_CLASSES,
    BatchBuffer,
    DeviceTable,
    GlobalKeyedState,
    KeyedState,
    TableDescriptor,
    TableType,
    TimeKeyMap,
    WriteBehavior,
)


class StateStore:
    def __init__(self, task_info: TaskInfo, backend: BackingStore,
                 restore_epoch: Optional[int] = None,
                 device: DeviceLike = None):
        self.task_info = task_info
        self.backend = backend
        self.restore_epoch = restore_epoch
        self.device = device
        self.descriptors: Dict[str, TableDescriptor] = {}
        self.tables: Dict[str, Any] = {}
        # the runtime sanitizer the engine installs; None unless armed
        self.sanitizer: Optional[Any] = None
        # key tombstones of KEYED tables for the next checkpoint
        self._pending_deletes: Dict[str, List[Any]] = {}

    @staticmethod
    def from_checkpoint_url(task_info: TaskInfo, url: str,
                            restore_epoch: Optional[int] = None,
                            device: DeviceLike = None) -> "StateStore":
        """A store over a Parquet checkpoint directory (``file://``, a
        plain path or ``memory://``)."""
        return StateStore(task_info, ParquetBackend.for_url(url),
                          restore_epoch, device)

    # -- registration -----------------------------------------------------------

    def register(self, descriptor: TableDescriptor,
                 table: Any = None) -> Any:
        """The table of ``descriptor`` (made from its type unless given),
        restored when this store restores an epoch."""
        name = descriptor.name
        if name in self.tables:
            return self.tables[name]
        if descriptor.table_type == TableType.DEVICE:
            raise ValueError("register device tables via register_device()")
        self.descriptors[name] = descriptor
        if table is None:
            table = TABLE_CLASSES[descriptor.table_type]()
        self.tables[name] = table
        snap = self._restored_snapshot(name)
        if snap is not None:
            if isinstance(table, BatchBuffer):
                if snap.batch is not None:
                    table.restore_batch(snap.batch)
            elif snap.entries:
                table.restore(snap.entries)
        return table

    def register_device(self, descriptor: TableDescriptor,
                        device_table: DeviceTable) -> None:
        """Register device-resident state, restoring it when this store
        restores an epoch."""
        self.descriptors[descriptor.name] = descriptor
        self.tables[descriptor.name] = device_table
        snap = self._restored_snapshot(descriptor.name)
        if snap is not None and snap.arrays:
            device_table.restore(snap.arrays)

    def get_global_keyed_state(self, name: str, desc: str = ""
                               ) -> GlobalKeyedState:
        return self.register(TableDescriptor(name, TableType.GLOBAL, desc))

    def get_time_key_map(self, name: str, desc: str = "",
                         retention_micros: int = 0) -> TimeKeyMap:
        return self.register(TableDescriptor(name, TableType.TIME_KEY_MAP,
                                             desc, retention_micros))

    def get_keyed_state(self, name: str, desc: str = "") -> KeyedState:
        return self.register(TableDescriptor(name, TableType.KEYED, desc))

    def get_session_state(self, name: str, desc: str = "") -> KeyedState:
        """Session-window state: partition-adaptive sorted interval runs
        on the store's device (state/session_state.py) unless
        ARROYO_SESSION_STATE=legacy.  Both layouts checkpoint as the
        same KEYED ``[(time, key, sessions)]`` entries, so epochs restore
        across layouts and the key-range entry filter applies."""
        from .session_state import SessionRunState, session_state_enabled

        if not session_state_enabled():
            return self.get_keyed_state(name, desc)
        existing = self.tables.get(name)
        if existing is not None:
            if type(existing) is KeyedState:
                # Operator.open() registered (and possibly restored into)
                # the dict layout before on_start chose: upgrade in
                # place, carrying the restored entries
                table = SessionRunState(device=self.device)
                table.restore(existing.snapshot())
                self.tables[name] = table
                return table
            return existing
        return self.register(TableDescriptor(name, TableType.KEYED, desc),
                             SessionRunState(device=self.device))

    def get_batch_buffer(self, name: str, desc: str = "",
                         retention_micros: int = 0) -> BatchBuffer:
        return self.register(TableDescriptor(name, TableType.BATCH_BUFFER,
                                             desc, retention_micros))

    def get_join_buffer(self, name: str, desc: str = "",
                        retention_micros: int = 0,
                        force_partitioned: bool = False) -> BatchBuffer:
        """Join-side buffer on the store's device: partition-adaptive
        sorted-run state (state/join_state.py) unless
        ARROYO_JOIN_STATE=legacy (``force_partitioned``: always, for the
        multi-way join's probes).  Both layouts checkpoint as the same
        BATCH_BUFFER table form, so epochs restore across layouts."""
        from .join_state import make_join_buffer

        return self.register(
            TableDescriptor(name, TableType.BATCH_BUFFER, desc,
                            retention_micros),
            make_join_buffer(self.device, force_partitioned))

    def note_delete(self, table: str, key: Any) -> None:
        """Record a key tombstone for the next checkpoint (the
        reference's DataOperation::DeleteKey)."""
        self._pending_deletes.setdefault(table, []).append(key)

    # -- restore ------------------------------------------------------------------

    def _restored_snapshot(self, name: str) -> Optional[TableSnapshot]:
        if self.restore_epoch is None:
            return None
        snaps = self.backend.restore_subtask(self.task_info, self.restore_epoch,
                                             [self.descriptors[name]])
        return snaps.get(name)

    def restore_watermark(self) -> Optional[int]:
        if self.restore_epoch is None:
            return None
        return self.backend.restore_watermark(self.task_info,
                                              self.restore_epoch)

    def _update_size_gauges(self, snaps: Dict[str, TableSnapshot]) -> None:
        """Per-table key-count gauges, refreshed at each barrier — the
        reference's arroyo_worker_table_size_keys with (operator_id,
        task_id, table_char) labels (arroyo-state/src/metrics.rs)."""
        for name, table in self.tables.items():
            if isinstance(table, DeviceTable):
                # key count from the canonical snapshot just taken
                # (meta[0] = occupied key slots)
                meta = (snaps[name].arrays or {}).get("meta")
                size = int(meta[0]) if meta is not None else None
            elif hasattr(table, "n_keys"):  # KEY count, not entries
                size = table.n_keys()
            elif hasattr(table, "__len__"):
                size = len(table)
            else:
                size = None
            if size is not None:
                table_size_gauge(self.task_info, name).set(size)

    # -- checkpoint ----------------------------------------------------------------

    def checkpoint(self, epoch: int,
                   watermark: Optional[int]) -> SubtaskCheckpointMetadata:
        """Snapshot every registered table and persist it; device tables
        copy their planes to the host here, at the barrier."""
        snaps: Dict[str, TableSnapshot] = {}
        for name, table in self.tables.items():
            desc = self.descriptors[name]
            if isinstance(table, DeviceTable):
                snaps[name] = TableSnapshot(desc, arrays=table.snapshot())
            elif isinstance(table, BatchBuffer):
                snaps[name] = TableSnapshot(desc, batch=table.snapshot_batch())
            else:
                snaps[name] = TableSnapshot(
                    desc, entries=table.snapshot(),
                    deletes=self._pending_deletes.get(name))
        self._pending_deletes.clear()
        self._update_size_gauges(snaps)
        san = self.sanitizer
        fp = (san.checkpoint_begin(self.task_info.task_id, self.tables)
              if san is not None else None)
        meta = self.backend.write_subtask_checkpoint(
            self.task_info, epoch, snaps, watermark)
        if san is not None:
            # the persisted epoch must hold exactly the snapshot above: a
            # table mutated while persisting is a torn epoch
            san.checkpoint_end(self.task_info.task_id, self.tables, fp)
        committing = {
            name: {k: v for _ts, k, v in (snap.entries or [])}
            for name, snap in snaps.items()
            if (self.descriptors[name].write_behavior
                == WriteBehavior.COMMIT_WRITES and snap.entries)
        }
        if committing:
            meta.committing_data = committing
        return meta
