"""Checkpoint backing stores: the ``BackingStore`` interface of
``arroyo_tpu.state.backend``, its in-memory implementation and the
Parquet backend, whose files either package restores.

The Parquet layout is the JAX package's (and so the reference's): files
at ``{job}/checkpoints/checkpoint-{epoch:07}/operator-{id}/
table-{name}-{subtask:03}.parquet`` with the columns ``{key_hash: uint64,
timestamp: int64, key: binary, value: binary, operation: int8}``,
zstd-compressed; restore reads every subtask's files of an operator and
filters them by the restoring task's key range.

Keys and values are pickled.  A value the JAX package wrote may name a
class of ``arroyo_tpu``: the port reads with an unpickler that maps
``arroyo_tpu.<mod>`` to ``arroyo_tpu_torch.<mod>`` and refuses any name
it cannot map (and any of ``jax``), so a restore never imports either.
The port writes no value that names one of its own classes, so the JAX
package reads its files without importing the port.

pyarrow is imported only inside the functions that read or write
Parquet or Arrow; where it is missing, ``ParquetBackend`` raises an
ImportError naming it at first use."""

from __future__ import annotations

import copy
import importlib
import io
import json
import pickle
import time as _time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..types import (Batch, SubtaskCheckpointMetadata,
                     TableCheckpointMetadata, TaskInfo, server_for_hash_array)
from ..utils.storage import StorageProvider
from .tables import TableDescriptor, TableType

# DataOperation log semantics of the reference
OP_INSERT = 0
OP_DELETE_KEY = 1


def _record_table_checkpoint(task: TaskInfo, table: str, seconds: float,
                             nbytes: int) -> None:
    """Per-table checkpoint cost: gauges and a span (best effort:
    persistence never fails on a metrics problem)."""
    try:
        from ..obs import tracing
        from ..obs.metrics import checkpoint_table_gauge

        checkpoint_table_gauge(task, table, "seconds").set(seconds)
        checkpoint_table_gauge(task, table, "bytes").set(nbytes)
        end = tracing.now_us()
        tracing.record_span(
            "checkpoint.table", "checkpoint", end - seconds * 1e6,
            seconds * 1e6, tid=task.task_id,
            args={"table": table, "bytes": nbytes})
    except Exception:
        pass


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
    deletes: Optional[List[Any]] = None  # tombstoned keys


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

    def cleanup_before(self, job_id: str, min_epoch: int) -> None:
        """Drop the job's epochs below ``min_epoch``."""
        raise NotImplementedError


# -- pickles across packages ----------------------------------------------------


class _CrossPackageUnpickler(pickle.Unpickler):
    """Reads a value either package pickled: ``arroyo_tpu.<mod>.<name>``
    resolves to ``arroyo_tpu_torch.<mod>.<name>``; a name the port lacks,
    or one of ``jax``, is refused rather than imported."""

    def find_class(self, module: str, name: str) -> Any:
        top = module.split(".", 1)[0]
        if top in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"checkpoint value names {module}.{name}: the port never "
                "imports jax")
        if top == "arroyo_tpu":
            mapped = "arroyo_tpu_torch" + module[len("arroyo_tpu"):]
            try:
                return getattr(importlib.import_module(mapped), name)
            except (ImportError, AttributeError):
                raise pickle.UnpicklingError(
                    f"checkpoint value names {module}.{name}, which has no "
                    f"counterpart {mapped}.{name} in the port") from None
        return super().find_class(module, name)


def _loads(data: bytes) -> Any:
    return _CrossPackageUnpickler(io.BytesIO(data)).load()


def _dumps(obj: Any) -> bytes:
    """Pickle a key or value for a checkpoint the JAX package must read
    too: one that names a class of the port is refused."""
    data = pickle.dumps(obj, protocol=4)
    if b"arroyo_tpu_torch" in data:
        raise TypeError(f"checkpoint value {obj!r:.200} names a class of "
                        "arroyo_tpu_torch, which the JAX package cannot read")
    return data


def _save_array(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    a = np.asarray(arr)
    np.save(buf, a, allow_pickle=a.dtype.hasobject)
    data = buf.getvalue()
    if a.dtype.hasobject and b"arroyo_tpu_torch" in data:
        raise TypeError("checkpoint array names a class of arroyo_tpu_torch")
    return data


def _load_array(data: bytes) -> np.ndarray:
    """``np.load`` of one ``.npy`` payload; an object array is unpickled
    through :class:`_CrossPackageUnpickler`."""
    buf = io.BytesIO(data)
    fmt = np.lib.format
    version = fmt.read_magic(buf)
    _shape, _fortran, dtype = (fmt.read_array_header_1_0(buf)
                               if version == (1, 0)
                               else fmt.read_array_header_2_0(buf))
    if not dtype.hasobject:
        buf.seek(0)
        return np.load(buf, allow_pickle=False)
    # an object array is its header then a pickle of the array
    return _CrossPackageUnpickler(buf).load()


# -- rows -------------------------------------------------------------------------


def _serialize_rows(
    snapshot: TableSnapshot,
) -> Tuple[np.ndarray, np.ndarray, List[bytes], List[bytes], np.ndarray]:
    """Flatten a TableSnapshot into the reference's five checkpoint
    columns: entries and tombstones a row each, a batch buffer one
    ``__batch__`` row (Arrow IPC), a device table one ``__array__<name>``
    row a plane (``.npy``)."""
    key_hashes: List[int] = []
    timestamps: List[int] = []
    keys: List[bytes] = []
    values: List[bytes] = []
    ops: List[int] = []

    if snapshot.entries is not None:
        for t, k, v in snapshot.entries:
            key_hashes.append(key_hash_of(k))
            timestamps.append(int(t))
            keys.append(_dumps(k))
            values.append(_dumps(v))
            ops.append(OP_INSERT)
    if snapshot.deletes:
        # a tombstone whose key was re-inserted before this checkpoint is
        # superseded by the live entry; writing both into one epoch file
        # would make order-blind readers (compaction) drop the live row
        live_keys = set(keys)
        for k in snapshot.deletes:
            kb = _dumps(k)
            if kb in live_keys:
                continue
            key_hashes.append(key_hash_of(k))
            timestamps.append(0)
            keys.append(kb)
            values.append(b"")
            ops.append(OP_DELETE_KEY)
    if snapshot.batch is not None and len(snapshot.batch):
        buf = io.BytesIO()
        _write_arrow_ipc(snapshot.batch, buf)
        key_hashes.append(0)
        timestamps.append(int(snapshot.batch.timestamp.min()))
        keys.append(b"__batch__")
        values.append(buf.getvalue())
        ops.append(OP_INSERT)
    if snapshot.arrays is not None:
        for name, arr in snapshot.arrays.items():
            key_hashes.append(0)
            timestamps.append(0)
            keys.append(b"__array__" + name.encode())
            values.append(_save_array(arr))
            ops.append(OP_INSERT)

    return (
        np.asarray(key_hashes, dtype=np.uint64),
        np.asarray(timestamps, dtype=np.int64),
        keys,
        values,
        np.asarray(ops, dtype=np.int8),
    )


def _write_arrow_ipc(batch: Batch, buf: io.BytesIO) -> None:
    import pyarrow as pa

    table = batch.to_arrow()
    # the key columns ride the schema so restore rebuilds key_hash
    meta = {b"key_cols": ",".join(batch.key_cols).encode()}
    table = table.replace_schema_metadata(meta)
    with pa.ipc.new_stream(buf, table.schema) as w:
        w.write_table(table)


def _read_arrow_ipc(data: bytes) -> Batch:
    import pyarrow as pa

    with pa.ipc.open_stream(io.BytesIO(data)) as r:
        table = r.read_all()
    batch = Batch.from_arrow(table)
    meta = table.schema.metadata or {}
    key_cols = meta.get(b"key_cols", b"").decode()
    if key_cols:
        batch = batch.with_key(key_cols.split(","))
    return batch


def _deserialize_rows(
    key_hashes: np.ndarray, timestamps: np.ndarray, keys: List[bytes],
    values: List[bytes], ops: np.ndarray, descriptor: TableDescriptor,
    key_range: Tuple[int, int],
) -> TableSnapshot:
    entries: List[Tuple[int, Any, Any]] = []
    batch: Optional[Batch] = None
    arrays: Dict[str, np.ndarray] = {}
    range_filter = descriptor.table_type != TableType.GLOBAL

    for kh, t, k, v, op in zip(key_hashes, timestamps, keys, values, ops):
        if k == b"__batch__":
            b = _read_arrow_ipc(v)
            if range_filter and b.key_hash is not None:
                lo, hi = key_range
                mask = ((b.key_hash >= np.uint64(lo))
                        & (b.key_hash <= np.uint64(hi)))
                b = b.select(mask)
            batch = b if batch is None else Batch.concat([batch, b])
            continue
        if k.startswith(b"__array__"):
            arrays[k[len(b"__array__"):].decode()] = _load_array(v)
            continue
        if range_filter and not (key_range[0] <= int(kh) <= key_range[1]):
            continue
        if op == OP_DELETE_KEY:
            entries = [(et, ek, ev) for (et, ek, ev) in entries
                       if pickle.dumps(ek, protocol=4) != k]
        else:
            entries.append((int(t), _loads(k), _loads(v)))

    return TableSnapshot(
        descriptor,
        entries=entries or None,
        batch=batch,
        arrays=arrays or None,
    )


def _merge_into(acc: TableSnapshot, snap: TableSnapshot) -> None:
    """Fold one subtask's snapshot of a table into the restored one."""
    if snap.entries:
        acc.entries = (acc.entries or []) + snap.entries
    if snap.batch is not None:
        acc.batch = (snap.batch if acc.batch is None
                     else Batch.concat([acc.batch, snap.batch]))
    if snap.arrays:
        from ..ops.keyed_bins import merge_canonical_snapshots

        acc.arrays = merge_canonical_snapshots(acc.arrays or {}, snap.arrays)


# -- Parquet ------------------------------------------------------------------------


def _parquet():
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("ParquetBackend needs pyarrow, which is not "
                          "installed; use InMemoryBackend") from e
    return pa, pq


def _safe(table: str) -> str:
    return table if table.isalnum() else f"t{ord(table[0]):02x}"


class ParquetBackend(BackingStore):
    """Parquet checkpoint persistence, file for file the JAX package's."""

    def __init__(self, storage: StorageProvider):
        self.storage = storage

    @staticmethod
    def for_url(url: str) -> "ParquetBackend":
        return ParquetBackend(StorageProvider.for_url(url))

    # -- paths --------------------------------------------------------------------

    @staticmethod
    def checkpoint_dir(job_id: str, epoch: int) -> str:
        return f"{job_id}/checkpoints/checkpoint-{epoch:07d}"

    @classmethod
    def operator_dir(cls, job_id: str, epoch: int, operator_id: str) -> str:
        return f"{cls.checkpoint_dir(job_id, epoch)}/operator-{operator_id}"

    @classmethod
    def table_file(cls, job_id: str, epoch: int, operator_id: str, table: str,
                   subtask: int) -> str:
        return (f"{cls.operator_dir(job_id, epoch, operator_id)}/"
                f"table-{_safe(table)}-{subtask:03d}.parquet")

    @classmethod
    def metadata_file(cls, job_id: str, epoch: int, operator_id: str,
                      subtask: int) -> str:
        return (f"{cls.operator_dir(job_id, epoch, operator_id)}/"
                f"metadata-{subtask:03d}.json")

    @classmethod
    def compacted_file(cls, job_id: str, epoch: int, operator_id: str,
                       safe_table: str, partition: int) -> str:
        return (f"{cls.operator_dir(job_id, epoch, operator_id)}/"
                f"compacted-{safe_table}-p{partition:03d}.parquet")

    @classmethod
    def compaction_marker(cls, job_id: str, epoch: int,
                          operator_id: str) -> str:
        return f"{cls.operator_dir(job_id, epoch, operator_id)}/compaction.json"

    # -- write --------------------------------------------------------------------

    @staticmethod
    def _table_bytes(pa, pq, kh, ts, keys, values, ops) -> bytes:
        table = pa.table({
            "key_hash": pa.array(kh, type=pa.uint64()),
            "timestamp": pa.array(ts, type=pa.int64()),
            "key": pa.array(keys, type=pa.binary()),
            "value": pa.array(values, type=pa.binary()),
            "operation": pa.array(ops, type=pa.int8()),
        })
        buf = io.BytesIO()
        pq.write_table(table, buf, compression="zstd")
        return buf.getvalue()

    def write_subtask_checkpoint(
        self, task: TaskInfo, epoch: int, tables: Dict[str, TableSnapshot],
        watermark: Optional[int],
    ) -> SubtaskCheckpointMetadata:
        pa, pq = _parquet()
        meta = SubtaskCheckpointMetadata(
            epoch=epoch, operator_id=task.operator_id,
            subtask_index=task.task_index,
            start_time=_time.time_ns() // 1_000, finish_time=0, bytes=0,
            watermark=watermark)
        for name, snap in tables.items():
            t_table = _time.perf_counter()
            kh, ts, keys, values, ops = _serialize_rows(snap)
            if len(kh) == 0:
                continue
            data = self._table_bytes(pa, pq, kh, ts, keys, values, ops)
            path = self.table_file(task.job_id, epoch, task.operator_id, name,
                                   task.task_index)
            self.storage.put(path, data)
            meta.bytes += len(data)
            meta.tables[name] = TableCheckpointMetadata(
                table=name, files=(path,), min_key_hash=int(kh.min()),
                max_key_hash=int(kh.max()))
            _record_table_checkpoint(
                task, name, _time.perf_counter() - t_table, len(data))
        meta.finish_time = _time.time_ns() // 1_000
        self.storage.put(
            self.metadata_file(task.job_id, epoch, task.operator_id,
                               task.task_index),
            json.dumps({
                "epoch": epoch, "operator_id": task.operator_id,
                "subtask_index": task.task_index,
                "watermark": watermark, "bytes": meta.bytes,
                "tables": {n: list(t.files) for n, t in meta.tables.items()},
            }).encode())
        return meta

    # -- compaction ---------------------------------------------------------------

    def compact_operator(self, job_id: str, operator_id: str, epoch: int,
                         n_partitions: int = 1) -> Dict[str, List[str]]:
        """Merge an operator's per-subtask files of an epoch into
        ``n_partitions`` key-range files a table, applying delete
        tombstones.  Returns ``{"to_load": [new files], "to_drop":
        [replaced files]}``; a marker written after the new files makes
        restore read them, and the replaced files are deleted after it."""
        pa, pq = _parquet()
        op_dir = self.operator_dir(job_id, epoch, operator_id)
        marker_path = self.compaction_marker(job_id, epoch, operator_id)
        if self.storage.exists(marker_path):
            # compacted already: finish deleting what the marker replaced
            # (a crash may have left it) and rebuild nothing
            marker = json.loads(self.storage.get(marker_path))
            dropped = []
            for info in marker["tables"].values():
                for f in info.get("replaced", []):
                    if self.storage.exists(f):
                        self.storage.delete_if_present(f)
                        dropped.append(f)
            return {"to_load": [f for info in marker["tables"].values()
                                for f in info["files"]],
                    "to_drop": dropped}
        by_table: Dict[str, List[str]] = {}
        for f in self.storage.list(op_dir):
            base = f.rsplit("/", 1)[-1]
            if base.startswith("table-") and base.endswith(".parquet"):
                safe = base[len("table-"):].rsplit("-", 1)[0]
                by_table.setdefault(safe, []).append(f)

        to_load: List[str] = []
        to_drop: List[str] = []
        marker: Dict[str, Any] = {"tables": {}, "n_partitions": n_partitions}
        for safe, files in sorted(by_table.items()):
            parts = [pq.read_table(io.BytesIO(self.storage.get(f)))
                     for f in sorted(files)]
            kh = np.concatenate([t.column("key_hash").to_numpy()
                                 for t in parts])
            ts = np.concatenate([t.column("timestamp").to_numpy()
                                 for t in parts])
            ops = np.concatenate([t.column("operation").to_numpy()
                                  for t in parts])
            keys = [k for t in parts for k in t.column("key").to_pylist()]
            values = [v for t in parts for v in t.column("value").to_pylist()]
            # a tombstone removes every insert of its key in the epoch and
            # is itself dropped from the compacted generation
            deleted = {k for k, op in zip(keys, ops) if op == OP_DELETE_KEY}
            live = np.array([i for i in range(len(keys))
                             if ops[i] != OP_DELETE_KEY
                             and keys[i] not in deleted], dtype=np.int64)
            part_of = server_for_hash_array(kh, n_partitions)
            new_files = []
            for p in range(n_partitions):
                idx = live[part_of[live] == p] if len(live) else live
                if not len(idx):
                    continue
                data = self._table_bytes(
                    pa, pq, kh[idx], ts[idx], [keys[i] for i in idx],
                    [values[i] for i in idx], ops[idx])
                path = self.compacted_file(job_id, epoch, operator_id, safe, p)
                self.storage.put(path, data)
                new_files.append(path)
            marker["tables"][safe] = {"files": new_files, "replaced": files}
            to_load.extend(new_files)
            to_drop.extend(files)
        # the marker commits the swap: restore prefers the compacted files
        # from here on, so the replaced ones may go
        self.storage.put(marker_path, json.dumps(marker).encode())
        for f in to_drop:
            self.storage.delete_if_present(f)
        return {"to_load": to_load, "to_drop": to_drop}

    # -- restore ------------------------------------------------------------------

    def restore_subtask(
        self, task: TaskInfo, epoch: int,
        tables: Sequence[TableDescriptor],
    ) -> Dict[str, TableSnapshot]:
        _pa, pq = _parquet()
        out: Dict[str, TableSnapshot] = {}
        op_dir = self.operator_dir(task.job_id, epoch, task.operator_id)
        # every subtask's files of the operator, filtered by this task's
        # key range: what lets a restore change parallelism
        files = self.storage.list(op_dir)
        compacted: Dict[str, List[str]] = {}
        marker_path = self.compaction_marker(task.job_id, epoch,
                                             task.operator_id)
        if self.storage.exists(marker_path):
            marker = json.loads(self.storage.get(marker_path))
            compacted = {safe: info["files"]
                         for safe, info in marker["tables"].items()}
        for desc in tables:
            safe = _safe(desc.name)
            if safe in compacted:
                table_files = list(compacted[safe])
            else:
                prefix = f"table-{safe}-"
                table_files = [f for f in files
                               if f.rsplit("/", 1)[-1].startswith(prefix)
                               and f.endswith(".parquet")]
            merged: Optional[TableSnapshot] = None
            for f in table_files:
                if not self.storage.exists(f):
                    # a file the marker names must exist: restoring without
                    # it would lose its key range silently
                    raise FileNotFoundError(
                        f"checkpoint file listed in compaction marker is "
                        f"missing: {f}")
                table = pq.read_table(io.BytesIO(self.storage.get(f)))
                snap = _deserialize_rows(
                    table.column("key_hash").to_numpy(),
                    table.column("timestamp").to_numpy(),
                    table.column("key").to_pylist(),
                    table.column("value").to_pylist(),
                    table.column("operation").to_numpy(),
                    desc, task.key_range)
                if merged is None:
                    merged = snap
                else:
                    _merge_into(merged, snap)
            if merged is not None:
                out[desc.name] = merged
        return out

    def restore_watermark(self, task: TaskInfo, epoch: int) -> Optional[int]:
        path = self.metadata_file(task.job_id, epoch, task.operator_id,
                                  task.task_index)
        if not self.storage.exists(path):
            return None
        return json.loads(self.storage.get(path)).get("watermark")

    def cleanup_before(self, job_id: str, min_epoch: int) -> None:
        """Delete the job's checkpoint directories of epochs below
        ``min_epoch``."""
        prefix = f"{job_id}/checkpoints/"
        seen = set()
        for f in self.storage.list(prefix):
            part = f[len(prefix):].split("/", 1)[0]
            if part.startswith("checkpoint-"):
                seen.add(part)
        for part in seen:
            try:
                ep = int(part.split("-")[1])
            except (IndexError, ValueError):
                continue
            if ep < min_epoch:
                self.storage.delete_prefix(prefix + part)


# -- in memory ---------------------------------------------------------------------


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
                else:
                    _merge_into(out[name], snap)
        return out

    def restore_watermark(self, task, epoch):
        entry = self._store.get((task.job_id, epoch, task.operator_id,
                                 task.task_index))
        return entry[1] if entry else None

    def cleanup_before(self, job_id, min_epoch):
        for k in [k for k in self._store
                  if k[0] == job_id and k[1] < min_epoch]:
            del self._store[k]
