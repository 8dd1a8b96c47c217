"""single_file source and sink (port of
``arroyo_tpu.connectors.single_file``): the source reads a JSON-lines
file a batch of lines at a time, with an exactly-once resume through the
lines read (global table ``f``); the sink appends JSON lines to a file,
with the byte offset of each checkpoint in table ``o``, truncating back
to it on restore.

Decode goes through ``formats.JsonFormat`` (digit strings stay strings,
missing fields stay None); ``ARROYO_FAST_DECODE=0`` keeps the connector's
historical per-line pivot, which turns an object column of digit strings
with a missing value into float64 (the divergence both packages pin).
Encode is ``formats.encode_json_lines`` with the NaN literal, or the
per-row ``json.dumps`` under ``ARROYO_FAST_DECODE=0``; the bytes are the
same."""

from __future__ import annotations

import asyncio
import json
import os
from dataclasses import InitVar, dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import config
from ..engine.context import Context
from ..engine.operator import Operator, SourceFinishType, SourceOperator
from ..formats import JsonFormat, encode_json_lines, fast_decode_enabled
from ..obs import latency as _latency
from ..obs import profiler
from ..state.tables import TableDescriptor, global_table
from ..types import Batch, StopMode, now_micros
from .registry import ConnectorMeta, register_connector


@dataclass
class SingleFileConfig:
    path: str
    timestamp_field: Optional[str] = None  # else the ingestion time
    # a SQL table's serde option, accepted and dropped as the JAX
    # package's config model drops it: lines are JSON
    format: InitVar[str] = "json"


def _rows_to_batch(rows: List[Dict[str, Any]], ts_field: Optional[str]) -> Batch:
    """The connector's historical pivot (``ARROYO_FAST_DECODE=0``)."""
    cols: Dict[str, List[Any]] = {}
    for r in rows:
        for k in r:
            cols.setdefault(k, [])
    for r in rows:
        for k in cols:
            cols[k].append(r.get(k))
    np_cols = {}
    for k, vs in cols.items():
        arr = np.array(vs)
        if arr.dtype == object:
            try:
                arr = arr.astype(np.int64)
            except (ValueError, TypeError):
                try:
                    arr = arr.astype(np.float64)
                except (ValueError, TypeError):
                    arr = np.array(vs, dtype=object)
        np_cols[k] = arr
    if ts_field and ts_field in np_cols:
        ts = np_cols[ts_field].astype(np.int64)
    else:
        ts = np.full(len(rows), now_micros(), dtype=np.int64)
    return Batch(ts, np_cols)


class SingleFileSource(SourceOperator):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("single_file_source")
        self.cfg = SingleFileConfig(**cfg)
        # one format instance a stream: it keeps the bulk path's state
        self.fmt = JsonFormat()

    def tables(self) -> List[TableDescriptor]:
        return [global_table("f", "single file source state")]

    async def run(self, ctx: Context) -> SourceFinishType:
        if ctx.task_info.task_index != 0:
            return SourceFinishType.FINAL  # a single-reader source
        state = ctx.state.get_global_keyed_state("f")
        start_line = state.get("lines_read") or 0
        batch_size = config().target_batch_size

        def _read_lines() -> List[bytes]:
            with open(self.cfg.path, "rb") as f:
                return f.readlines()

        # read off the event loop: a large file must not stall the others
        lines = await asyncio.get_event_loop().run_in_executor(
            None, _read_lines)
        prof = profiler.active()
        op_id = ctx.task_info.operator_id
        i = start_line
        while i < len(lines):
            frame = (prof.begin(op_id, "source_decode")
                     if prof is not None else None)
            chunk = lines[i:i + batch_size]
            payloads = [line for line in chunk if line.strip()]
            if not payloads:
                batch = None
            elif fast_decode_enabled():
                batch = self.fmt.batch(payloads, self.cfg.timestamp_field)
            else:
                rows = [json.loads(line) for line in payloads]
                batch = _rows_to_batch(rows, self.cfg.timestamp_field)
            if frame is not None:
                prof.end(frame)
            if batch is not None:
                _latency.maybe_stamp(op_id, batch)
                await ctx.collect(batch)
            i += len(chunk)
            state.insert("lines_read", i)
            cm = await ctx._runner.poll_source_control()
            if cm is not None and cm.kind == "stop":
                return (SourceFinishType.GRACEFUL
                        if cm.stop_mode != StopMode.IMMEDIATE
                        else SourceFinishType.IMMEDIATE)
            await asyncio.sleep(0)
        return SourceFinishType.FINAL


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


class SingleFileSink(Operator):
    """One JSON object a row.  Exactly once across restarts: the file's
    byte offset is checkpointed (table ``o``), and a restore truncates
    the file back to it before appending, so rows written after the last
    sealed epoch are dropped and produced again."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("single_file_sink")
        self.cfg = SingleFileConfig(**cfg)
        self._file = None

    def tables(self) -> List[TableDescriptor]:
        return [global_table("o", "committed file offset")]

    async def on_start(self, ctx: Context) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.cfg.path)),
                    exist_ok=True)
        # line-buffered: an IMMEDIATE stop never runs on_close, and a
        # block-buffered file flushing its residue at finalization, at
        # its offset from before the truncate, would punch a hole into
        # the file the restored run appends to
        if ctx.state.restore_epoch is not None:
            offset = ctx.state.get_global_keyed_state("o").get("offset") or 0
            with open(self.cfg.path, "ab"):
                pass  # make sure it exists
            with open(self.cfg.path, "r+b") as f:
                f.truncate(offset)
            self._file = open(self.cfg.path, "a", buffering=1)
        else:
            self._file = open(self.cfg.path, "w", buffering=1)

    async def pre_checkpoint(self, barrier, ctx: Context) -> None:
        self._file.flush()
        ctx.state.get_global_keyed_state("o").insert(
            "offset", self._file.tell())

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        prof = profiler.active()
        frame = (prof.begin(ctx.task_info.operator_id, "emit_encode")
                 if prof is not None else None)
        # one write a batch either way, so line buffering flushes once
        lines = (encode_json_lines(batch, nan_literal="NaN")
                 if fast_decode_enabled() else None)
        if lines is not None:
            out = "\n".join(lines) + "\n" if lines else ""
        else:
            names = list(batch.columns)
            cols = [batch.columns[n] for n in names]
            out = "".join(
                json.dumps({n: c[i] for n, c in zip(names, cols)},
                           default=_json_default) + "\n"
                for i in range(len(batch)))
        self._file.write(out)
        if frame is not None:
            prof.end(frame)

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        self._file.flush()
        await super().handle_watermark(watermark, ctx)

    async def on_close(self, ctx: Context) -> None:
        self._file.flush()
        self._file.close()


register_connector(ConnectorMeta(
    name="single_file",
    description="JSON-lines file source/sink for tests and golden files",
    source_factory=SingleFileSource,
    sink_factory=SingleFileSink,
    config_model=SingleFileConfig,
))
