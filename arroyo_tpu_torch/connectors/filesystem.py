"""FileSystem sink: JSON or Parquet part files with an exactly-once
commit (port of ``arroyo_tpu.connectors.filesystem``).

Rows are buffered and flushed as part files.  At each checkpoint barrier
the open parts are *staged* (written under ``.staging/``) and recorded as
pre-commit data; the commit phase promotes each staged part to its final
name.  A crash between a checkpoint and its commit re-commits on restore;
parts staged after the last sealed checkpoint are dropped at restore, and
their rows are produced again.  Parts are named
``part-{subtask:04d}-{seq:06d}.{ext}`` under the configured directory
(``file://``, a bare path or ``memory://``; ``gs://`` / ``s3://`` through
fsspec where it is installed).

JSON parts are the JAX package's bytes for the same rows.  Parquet parts
go through pyarrow, imported at the first part written: like the Parquet
checkpoint backend they are for machines that have it, and elsewhere the
first part raises an ImportError naming pyarrow."""

from __future__ import annotations

import io
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..engine.context import Context
from ..formats import _py, batch_to_rows
from ..types import Batch
from ..utils.storage import StorageProvider
from .registry import ConnectorMeta, register_connector
from .two_phase import TwoPhaseCommitterSink

FORMATS = ("json", "parquet")


@dataclass
class FileSystemConfig:
    path: str  # directory URL
    format: str = "json"  # newline-delimited json | parquet
    rows_per_file: int = 1_000_000  # a part rolls past this many rows

    def __post_init__(self) -> None:
        # a typo fails when the sink is built, never as a silent json
        if self.format not in FORMATS:
            raise ValueError(f"filesystem format must be one of {FORMATS}, "
                             f"not {self.format!r}")
        self.rows_per_file = int(self.rows_per_file)


def _parquet():
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("the filesystem sink's parquet format needs "
                          "pyarrow, which is not installed; use "
                          "format = 'json'") from e
    return pa, pq


class FileSystemSink(TwoPhaseCommitterSink):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("filesystem_sink")
        self.cfg = FileSystemConfig(**cfg)
        self.storage = StorageProvider.for_url(self.cfg.path)
        self._rows: List[Dict[str, Any]] = []
        self._staged_parts: List[str] = []
        self._seq = 0
        self._subtask = 0

    # -- committer hooks ---------------------------------------------------------

    async def committer_init(self, recovery_state: Optional[Any],
                             ctx: Context) -> None:
        self._subtask = ctx.task_info.task_index
        if recovery_state:
            self._seq = int(recovery_state.get("next_seq", 0))

    async def committer_post_restore(self, ctx: Context) -> None:
        # the restored pre-commits are promoted by now, so what is still
        # staged for this subtask was never pre-committed
        for key in self.storage.list(".staging/"):
            if f"part-{self._subtask:04d}-" in key:
                self.storage.delete_if_present(key)

    async def insert_batch(self, batch: Batch, ctx: Context) -> None:
        self._rows.extend(batch_to_rows(batch))
        while len(self._rows) >= self.cfg.rows_per_file:
            chunk, self._rows = (self._rows[:self.cfg.rows_per_file],
                                 self._rows[self.cfg.rows_per_file:])
            self._stage(chunk)

    def _part_name(self) -> str:
        ext = "parquet" if self.cfg.format == "parquet" else "json"
        name = f"part-{self._subtask:04d}-{self._seq:06d}.{ext}"
        self._seq += 1
        return name

    def _encode(self, rows: List[Dict[str, Any]]) -> bytes:
        if self.cfg.format == "parquet":
            pa, pq = _parquet()
            cleaned = [{k: _py(v) for k, v in r.items()} for r in rows]
            buf = io.BytesIO()
            pq.write_table(pa.Table.from_pylist(cleaned), buf,
                           compression="zstd")
            return buf.getvalue()
        return b"".join(
            json.dumps(r, default=_py).encode() + b"\n" for r in rows)

    def _stage(self, rows: List[Dict[str, Any]]) -> None:
        if not rows:
            return
        name = self._part_name()
        self.storage.put(f".staging/{name}", self._encode(rows))
        self._staged_parts.append(name)

    async def committer_checkpoint(
            self, epoch: int, stopping: bool,
            ctx: Context) -> Tuple[Any, Dict[str, Any]]:
        self._stage(self._rows)
        self._rows = []
        staged, self._staged_parts = self._staged_parts, []
        pre_commits = {name: {"staged": f".staging/{name}", "final": name}
                       for name in staged}
        return {"next_seq": self._seq}, pre_commits

    def _promote(self, staged: str, final: str) -> None:
        # idempotent: a part promoted before a crash mid-commit is skipped
        if self.storage.exists(staged):
            self.storage.put(final, self.storage.get(staged))
            self.storage.delete_if_present(staged)

    async def committer_commit(self, epoch: int, pre_commits: Dict[str, Any],
                               ctx: Context) -> None:
        for _, pc in sorted(pre_commits.items()):
            self._promote(pc["staged"], pc["final"])

    async def on_close(self, ctx: Context) -> None:
        # the stream ended without a barrier after these rows: write them
        # straight to a final part, as no commit will come for them
        if self._rows:
            self.storage.put(self._part_name(), self._encode(self._rows))
            self._rows = []
        for name in self._staged_parts:
            self._promote(f".staging/{name}", name)
        self._staged_parts = []


register_connector(ConnectorMeta(
    name="filesystem",
    description="parquet/json part-file sink with exactly-once two-phase "
                "commit",
    sink_factory=FileSystemSink,
    config_model=FileSystemConfig,
))
