"""Preview sink (port of ``arroyo_tpu.connectors.preview``): streams each
batch to the controller's ``SendSinkData``, which fans it out to the
console's output subscribers, and a last empty message with ``done``
when the stream ends.

The wire is the JAX package's: a gRPC unary call to
``/arroyo_tpu.rpc.ControllerGrpc/SendSinkData`` carrying a protobuf
``SinkDataReq`` (encoded here, four scalar fields) whose ``batch`` is
the Arrow IPC stream of the batch with its key metadata.  grpc and
pyarrow are imported when the sink starts, so the sink runs where the
controller runs; elsewhere it raises an ImportError naming them.  A
failed send is logged and dropped, as in the JAX package."""

from __future__ import annotations

import io
import logging
from typing import Any, Dict, Optional

from ..config import config
from ..engine.context import Context
from ..engine.operator import Operator
from ..types import Batch
from .registry import ConnectorMeta, register_connector

logger = logging.getLogger(__name__)

SEND_SINK_DATA = "/arroyo_tpu.rpc.ControllerGrpc/SendSinkData"


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def sink_data_req(job_id: str, operator_id: str, batch: bytes,
                  done: bool) -> bytes:
    """A ``SinkDataReq`` in the protobuf wire format: fields 1-3
    length-delimited, 4 a varint, default values left out (proto3)."""
    out = bytearray()
    for number, value in ((1, job_id.encode()), (2, operator_id.encode()),
                          (3, batch)):
        if value:
            out += _varint(number << 3 | 2) + _varint(len(value)) + value
    if done:
        out += _varint(4 << 3) + b"\x01"
    return bytes(out)


def encode_batch(batch: Batch) -> bytes:
    """The Arrow IPC stream (schema and one record batch) of ``batch``,
    with ``key_cols`` and, where keyed, ``__key_hash`` as the JAX
    package's data plane writes it."""
    import pyarrow as pa

    arrays = batch.arrow_arrays()
    meta = {b"key_cols": ",".join(batch.key_cols).encode()}
    if batch.key_hash is not None:
        meta[b"has_key_hash"] = b"1"
        arrays["__key_hash"] = pa.array(batch.key_hash, type=pa.uint64())
    rb = pa.record_batch(list(arrays.values()), names=list(arrays.keys()))
    rb = rb.replace_schema_metadata(meta)
    buf = io.BytesIO()
    with pa.ipc.new_stream(buf, rb.schema) as w:
        w.write_batch(rb)
    return buf.getvalue()


class PreviewSink(Operator):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("preview_sink")
        self.controller_addr = cfg.get("controller_addr") or \
            config().controller_addr.replace("http://", "")
        self._channel: Optional[Any] = None
        self._send: Optional[Any] = None

    def _connect(self) -> Any:
        """The ``SendSinkData`` call: an async callable taking the
        request's bytes (and a ``timeout``)."""
        try:
            import grpc
            import pyarrow  # noqa: F401  (encode_batch)
        except ImportError as e:
            raise ImportError("the preview sink needs grpcio and pyarrow, "
                              "as the controller does") from e
        self._channel = grpc.aio.insecure_channel(self.controller_addr)
        return self._channel.unary_unary(
            SEND_SINK_DATA, request_serializer=lambda b: b,
            response_deserializer=lambda b: b)

    async def on_start(self, ctx: Context) -> None:
        self._send = self._connect()

    async def _call(self, payload: bytes, done: bool,
                    ctx: Context) -> None:
        await self._send(sink_data_req(
            ctx.task_info.job_id, ctx.task_info.operator_id, payload, done),
            timeout=10.0)

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        try:
            await self._call(encode_batch(batch), False, ctx)
        except Exception as e:
            logger.warning("preview sink send failed: %s", e)

    async def on_close(self, ctx: Context) -> None:
        try:
            await self._call(b"", True, ctx)
            if self._channel is not None:
                await self._channel.close()
        except Exception:
            pass


register_connector(ConnectorMeta(
    name="preview",
    description="stream results to the controller (console output pane)",
    sink_factory=PreviewSink,
))
