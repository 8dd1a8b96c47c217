"""Checkpoint backing stores — the ``BackingStore`` interface of
``arroyo_tpu.state.backend`` and its in-memory implementation.  The
Parquet backend (durable checkpoints) is not ported yet."""

from __future__ import annotations

import copy
import pickle
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..types import Batch, SubtaskCheckpointMetadata, TaskInfo
from .tables import TableDescriptor, TableType


def key_hash_of(key: Any) -> int:
    """u64 hash for range partitioning of checkpointed keys: integer keys
    are already key-space hashes, others get a stable hash of their
    pickled bytes."""
    if isinstance(key, (int, np.integer)):
        return int(np.uint64(int(key) & 0xFFFF_FFFF_FFFF_FFFF))
    data = pickle.dumps(key, protocol=4)
    h = (zlib.crc32(data) << 32) | zlib.crc32(data[::-1])
    return h & 0xFFFF_FFFF_FFFF_FFFF


@dataclass
class TableSnapshot:
    """One table's data at a barrier: exactly one of the three forms."""

    descriptor: TableDescriptor
    entries: Optional[List[Tuple[int, Any, Any]]] = None  # (time, key, value)
    batch: Optional[Batch] = None  # BatchBuffer contents
    arrays: Optional[Dict[str, np.ndarray]] = None  # DeviceTable contents


class BackingStore:
    """Storage interface for checkpoints."""

    def write_subtask_checkpoint(
        self, task: TaskInfo, epoch: int, tables: Dict[str, TableSnapshot],
        watermark: Optional[int],
    ) -> SubtaskCheckpointMetadata:
        raise NotImplementedError

    def restore_subtask(
        self, task: TaskInfo, epoch: int,
        tables: Sequence[TableDescriptor],
    ) -> Dict[str, TableSnapshot]:
        """Restore the given tables; non-GLOBAL tables are filtered to the
        restoring task's key range, GLOBAL tables are merged across all
        subtasks unfiltered."""
        raise NotImplementedError

    def restore_watermark(self, task: TaskInfo, epoch: int) -> Optional[int]:
        raise NotImplementedError


class InMemoryBackend(BackingStore):
    """Keeps snapshots in a process-global dict (shared by every
    instance, as in the JAX package, so a restore may use a new one)."""

    _store: Dict[Tuple[str, int, str, int],
                 Tuple[Dict[str, TableSnapshot], Optional[int]]] = {}

    def write_subtask_checkpoint(self, task, epoch, tables, watermark):
        self._store[(task.job_id, epoch, task.operator_id, task.task_index)] = (
            copy.deepcopy(tables), watermark)
        return SubtaskCheckpointMetadata(
            epoch=epoch, operator_id=task.operator_id,
            subtask_index=task.task_index,
            start_time=0, finish_time=0, bytes=0, watermark=watermark)

    def restore_subtask(self, task, epoch, table_descs):
        lo, hi = task.key_range
        out: Dict[str, TableSnapshot] = {}
        for (job, ep, op, _idx), (tables, _wm) in sorted(
                self._store.items(), key=lambda kv: kv[0]):
            if job != task.job_id or ep != epoch or op != task.operator_id:
                continue
            for desc in table_descs:
                name = desc.name
                if name not in tables:
                    continue
                snap = copy.deepcopy(tables[name])
                range_filter = snap.descriptor.table_type != TableType.GLOBAL
                if range_filter and snap.entries:
                    snap.entries = [
                        (t, k, v) for (t, k, v) in snap.entries
                        if lo <= key_hash_of(k) <= hi]
                if (range_filter and snap.batch is not None
                        and snap.batch.key_hash is not None):
                    mask = ((snap.batch.key_hash >= np.uint64(lo))
                            & (snap.batch.key_hash <= np.uint64(hi)))
                    snap.batch = snap.batch.select(mask)
                if name not in out:
                    out[name] = snap
                    continue
                acc = out[name]
                if snap.entries:
                    acc.entries = (acc.entries or []) + snap.entries
                if snap.batch is not None:
                    acc.batch = (snap.batch if acc.batch is None
                                 else Batch.concat([acc.batch, snap.batch]))
                if snap.arrays:
                    from ..ops.keyed_bins import merge_canonical_snapshots

                    acc.arrays = merge_canonical_snapshots(
                        acc.arrays or {}, snap.arrays)
        return out

    def restore_watermark(self, task, epoch):
        entry = self._store.get((task.job_id, epoch, task.operator_id,
                                 task.task_index))
        return entry[1] if entry else None
