"""Wire formats: bytes <-> rows <-> columnar Batch (port of
``arroyo_tpu.formats``).

A source hands a list of raw payloads to ``Format.batch`` and gets one
columnar :class:`~arroyo_tpu_torch.types.Batch` back; a sink hands a
Batch to ``Format.serialize_batch`` and gets one payload a row.

* JSON (``JsonFormat``): decode takes the JAX package's route for a
  machine without pyarrow, one bulk ``json.loads`` of the whole batch
  feeding the legacy row pivot (:func:`rows_to_columns`), and the
  row-at-a-time path when the bulk parse fails, for the envelope modes
  and under ``ARROYO_FAST_DECODE=0``.  Options: the confluent
  schema-registry 5-byte header strip, ``unstructured`` (the payload
  text in one ``value`` column), the ``include_schema`` envelope and
  Debezium envelopes (an ``__op`` retraction column).  Encode renders a
  batch column by column (:func:`encode_json_lines`), byte for byte the
  JAX package's lines.
* raw strings (``RawStringFormat``): one UTF-8 ``value`` a payload.
* Avro (``AvroFormat``): the single-record binary encoding against a
  record schema of ``["null", T]`` unions, optionally Confluent-framed,
  in pure Python with ``struct`` as in the JAX package.

The JAX package's pyarrow NDJSON reader is not ported (the card machine
has no pyarrow)."""

from __future__ import annotations

import functools
import json
import math
import os
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import colmath
from .types import Batch, now_micros


def fast_decode_enabled() -> bool:
    """``ARROYO_FAST_DECODE=0`` disables the vectorized decode and encode
    paths, so the formats reproduce the row-at-a-time path.  Read per
    call."""
    return os.environ.get("ARROYO_FAST_DECODE", "1") not in ("0", "off",
                                                             "false")


# Debezium operation codes -> the retraction column's ops
_DEBEZIUM_OPS = {"c": "append", "r": "append", "u": "update", "d": "retract"}

# the reserved column carrying a retraction stream's op
OP_COLUMN = "__op"


def rows_to_columns(rows: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Pivot a list of JSON-ish dict rows into typed numpy columns.

    Columns with missing fields become float64 with NaN (all-numeric) or
    object columns keeping the Nones; fully-present columns coerce to
    bool/int64/float64 and otherwise stay ``object`` (string) columns."""
    names: Dict[str, None] = {}
    for r in rows:
        for k in r:
            names.setdefault(k)
    cols: Dict[str, np.ndarray] = {}
    for k in names:
        vs = [r.get(k) for r in rows]
        # dispatch on the JSON types, never by attempted coercion: a
        # column of digit strings ("01234") must stay a string column
        present = [v for v in vs if v is not None]
        has_none = len(present) < len(vs)
        if not present:
            arr = np.array(vs, dtype=object)  # untyped: keep the Nones
        elif all(isinstance(v, bool) for v in present):
            arr = (np.array(vs, dtype=object) if has_none
                   else np.array(vs, dtype=bool))
        elif all(isinstance(v, int) and not isinstance(v, bool)
                 for v in present):
            if has_none:
                arr = np.array([np.nan if v is None else v for v in vs],
                               dtype=np.float64)
            else:
                try:
                    arr = np.array(vs, dtype=np.int64)
                except OverflowError:
                    arr = np.array(vs, dtype=object)
        elif all(isinstance(v, (int, float)) and not isinstance(v, bool)
                 for v in present):
            arr = np.array([np.nan if v is None else v for v in vs],
                           dtype=np.float64)
        else:
            arr = np.array(vs, dtype=object)
        cols[k] = arr
    return cols


def batch_from_rows(rows: Sequence[Dict[str, Any]],
                    timestamp_field: Optional[str] = None) -> Batch:
    """Build a Batch from dict rows; event time from ``timestamp_field``
    (int64 micros) or ingestion time."""
    cols = rows_to_columns(rows)
    if timestamp_field and timestamp_field in cols:
        ts = cols[timestamp_field].astype(np.int64)
    else:
        ts = np.full(len(rows), now_micros(), dtype=np.int64)
    return Batch(ts, cols)


def coerce_object_col(v: np.ndarray):
    """Lift an object-dtype nullable column into (typed values, validity):
    Nones become the validity mask and the rest gets its natural dtype
    (None fills: False / NaN).  Columns whose non-null values are not
    scalars (strings, lists) return unchanged with mask None."""
    for x in v[:64]:
        if x is not None:
            if isinstance(x, str):
                return v, None
            break
    mask = np.fromiter((x is not None for x in v), bool, len(v))
    present = [x for x in v if x is not None]
    if not present:
        return np.zeros(len(v), dtype=np.float32), mask
    if all(isinstance(x, bool) for x in present):
        vals = np.fromiter((x if x is not None else False for x in v),
                           bool, len(v))
        return vals, (None if mask.all() else mask)
    if all(isinstance(x, (int, float)) and not isinstance(x, bool)
           for x in present):
        vals = np.array([np.nan if x is None else float(x) for x in v],
                        dtype=np.float64)
        return vals, (None if mask.all() else mask)
    return v, None


def nan_validity(v: Any, m: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Combine an explicit validity mask with the engine's implicit NULL
    encodings: NaN rows in float columns (numpy arrays or tensors) and
    None rows in object columns.  Returns the combined mask, or None when
    every row is valid."""
    if isinstance(v, np.ndarray) and v.dtype == object:
        nn = np.array([x is not None and x == x for x in v], dtype=bool)
        return nn if m is None else colmath.and_(m, nn)
    if isinstance(v, np.ndarray) and v.dtype.kind == "f":
        nn = ~np.isnan(v)
        return nn if m is None else colmath.and_(m, nn)
    if isinstance(v, torch.Tensor) and v.is_floating_point():
        nn = ~torch.isnan(v)
        return nn if m is None else colmath.and_(m, nn)
    return m


def coerce_float(arr: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Numeric view of a column for aggregation inputs: None (in object
    columns from nullable JSON) becomes NaN instead of raising."""
    if arr.dtype == object:
        return np.array([np.nan if v is None else float(v) for v in arr],
                        dtype=dtype)
    return arr.astype(dtype)


def batch_to_rows(batch: Batch) -> List[Dict[str, Any]]:
    names = list(batch.columns)
    cols = [batch.columns[n] for n in names]
    return [{n: _py(c[i]) for n, c in zip(names, cols)}
            for i in range(len(batch))]


def _py(v: Any) -> Any:
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        f = float(v)
        return None if f != f else f
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return v


# -- vectorized JSON egress --------------------------------------------------------


def _float_cell(v: float, nan_literal: str) -> str:
    # json.dumps renders floats with float.__repr__ and these non-finite
    # literals; NaN is the caller's: JsonFormat nulls it (as _py does),
    # the single_file sink keeps the NaN literal
    if v != v:
        return nan_literal
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    return repr(v)


def _json_cells(col: np.ndarray, nan_literal: str) -> Optional[List[str]]:
    """One JSON-encoded text cell a row for a whole column, dispatched by
    dtype.  ``None``: the column holds something the encoders do not
    express (nested lists, dicts, other objects), and the caller takes
    the row-at-a-time path."""
    kind = col.dtype.kind
    if kind in "iu":
        return col.astype(str).tolist()
    if kind == "f":
        return [_float_cell(v, nan_literal) for v in col.tolist()]
    if kind == "b":
        return np.where(col, "true", "false").tolist()
    if col.dtype == object or kind == "U":
        out: List[str] = []
        dumps = json.dumps
        for v in col.tolist():
            if v is None:
                out.append("null")
            elif type(v) is str:
                out.append(dumps(v))
            elif isinstance(v, (bool, np.bool_)):
                out.append("true" if v else "false")
            elif isinstance(v, (int, np.integer)):
                out.append(str(int(v)))
            elif isinstance(v, np.floating):
                # before the float branch: np.float64 subclasses float,
                # and the row path (_py) nulls its NaN
                out.append(_float_cell(float(v), nan_literal))
            elif isinstance(v, float):
                # a Python float NaN in an object column passes _py
                # untouched, so json.dumps writes the literal
                out.append(_float_cell(v, "NaN"))
            elif isinstance(v, np.str_):
                out.append(dumps(str(v)))
            elif isinstance(v, bytes):
                out.append(dumps(v.decode("utf-8", "replace")))
            else:
                return None
        return out
    return None  # datetimes and the like: no vectorized encoder


@functools.lru_cache(maxsize=256)
def _row_template(names: tuple) -> str:
    """The row layout fixed by the column names: object framing, quoted
    keys and json.dumps' separators, built once a schema."""
    return "{" + ", ".join(
        json.dumps(n).replace("%", "%%") + ": %s" for n in names) + "}"


def encode_json_lines(batch: Batch,
                      nan_literal: str = "null") -> Optional[List[str]]:
    """A whole Batch as JSON-object text lines: one encoded-cell pass a
    column, one template substitution a row.  ``None`` when a column is
    not expressible; the caller then takes its per-row ``json.dumps``
    path, whose output this otherwise matches byte for byte."""
    names = tuple(batch.columns)
    if not names:
        return ["{}"] * len(batch)
    cells: List[List[str]] = []
    for n in names:
        c = _json_cells(batch.columns[n], nan_literal)
        if c is None:
            return None
        cells.append(c)
    template = _row_template(names)
    return [template % t for t in zip(*cells)]


class Format:
    """bytes[] <-> rows <-> Batch.  Stateless apart from fast-path
    bookkeeping, and reusable."""

    name = "abstract"

    def deserialize(self, payloads: Sequence[bytes]) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def serialize(self, rows: Sequence[Dict[str, Any]]) -> List[bytes]:
        raise NotImplementedError

    def batch(self, payloads: Sequence[bytes],
              timestamp_field: Optional[str] = None) -> Batch:
        return batch_from_rows(self.deserialize(payloads), timestamp_field)

    def serialize_batch(self, batch: Batch) -> List[bytes]:
        return self.serialize(batch_to_rows(batch))


@dataclass
class JsonFormat(Format):
    """One JSON object per payload.

    - ``confluent_schema_registry``: strip the 5-byte magic + schema-id
      header the confluent serializers prepend;
    - ``unstructured``: the whole payload text in one ``value`` column;
    - ``include_schema``: on serialize, wrap rows in a
      ``{"schema": ..., "payload": ...}`` envelope (and unwrap it on
      decode);
    - ``debezium``: payloads are Debezium envelopes, unwrapped into rows
      carrying an ``__op`` retraction column."""

    name: str = "json"
    confluent_schema_registry: bool = False
    unstructured: bool = False
    include_schema: bool = False
    debezium: bool = False

    def _strip(self, p: bytes) -> bytes:
        if self.confluent_schema_registry and len(p) >= 5 and p[0] == 0:
            return p[5:]
        return p

    def batch(self, payloads: Sequence[bytes],
              timestamp_field: Optional[str] = None) -> Batch:
        """One bulk parse of the whole batch feeding the legacy pivot;
        the envelope modes and ``ARROYO_FAST_DECODE=0`` take the row
        path."""
        if (self.debezium or self.unstructured or self.include_schema
                or not fast_decode_enabled()):
            return batch_from_rows(self.deserialize(payloads),
                                   timestamp_field)
        return self._batch_bulk(payloads, timestamp_field)

    def _join_payloads(self, payloads: Sequence[bytes], sep: bytes):
        """Frame a batch of payloads as ONE buffer for a single parser
        invocation.  Returns ``(buf, count)``; ``(None, 0)`` when nothing
        remains."""
        if not self.confluent_schema_registry and isinstance(
                payloads, list) and payloads and \
                isinstance(payloads[0], bytes):
            try:
                return sep.join(payloads), len(payloads)
            except TypeError:
                pass  # mixed payload types: general path below
        raw = [self._strip(p if isinstance(p, bytes) else str(p).encode())
               for p in payloads if p is not None]
        if not raw:
            return None, 0
        return sep.join(raw), len(raw)

    def _batch_bulk(self, payloads: Sequence[bytes],
                    timestamp_field: Optional[str]) -> Batch:
        """ONE ``json.loads`` of the whole batch (payloads joined into a
        JSON array) in place of one per payload; the pivot is
        :func:`rows_to_columns`, so null/bool/digit-string semantics are
        the row path's.  After 3 consecutive failures the stream stays
        on the row path."""
        if getattr(self, "_bulk_fails", 0) < 3:
            try:
                buf, _ = self._join_payloads(payloads, b",")
                objs = json.loads(b"[" + buf + b"]") if buf is not None \
                    else []
                self._bulk_fails = 0
                return batch_from_rows(self._normalize_objs(objs),
                                       timestamp_field)
            except Exception:
                # a payload the array join mis-frames: the row path is
                # authoritative — it surfaces the real error or succeeds
                self._bulk_fails = getattr(self, "_bulk_fails", 0) + 1
        return batch_from_rows(self.deserialize(payloads), timestamp_field)

    def _normalize_objs(self, objs: List[Any]) -> List[Dict[str, Any]]:
        """Arrays flatten to their dict elements, scalars wrap in a
        ``value`` column."""
        rows: List[Dict[str, Any]] = []
        for obj in objs:
            if isinstance(obj, dict):
                rows.append(obj)
            elif isinstance(obj, list):
                rows.extend(o for o in obj if isinstance(o, dict))
            else:
                rows.append({"value": obj})
        return rows

    def deserialize(self, payloads: Sequence[bytes]) -> List[Dict[str, Any]]:
        rows: List[Dict[str, Any]] = []
        for p in payloads:
            if p is None:
                continue
            raw = self._strip(p if isinstance(p, bytes) else str(p).encode())
            if self.unstructured:
                rows.append({"value": raw.decode("utf-8", "replace")})
                continue
            obj = json.loads(raw)
            if self.debezium:
                rows.extend(self._unwrap_debezium(obj))
            elif isinstance(obj, dict) and self.include_schema and \
                    "payload" in obj and "schema" in obj:
                rows.append(obj["payload"])
            elif isinstance(obj, list):
                rows.extend(o for o in obj if isinstance(o, dict))
            elif isinstance(obj, dict):
                rows.append(obj)
            else:
                rows.append({"value": obj})
        return rows

    def _unwrap_debezium(self, obj: Dict[str, Any]) -> List[Dict[str, Any]]:
        env = obj.get("payload", obj)
        op = _DEBEZIUM_OPS.get(env.get("op", "c"), "append")
        out: List[Dict[str, Any]] = []
        if op == "update":
            # an update is a retract of ``before`` and an append of
            # ``after``
            if env.get("before") is not None:
                out.append({**env["before"], OP_COLUMN: "retract"})
            if env.get("after") is not None:
                out.append({**env["after"], OP_COLUMN: "append"})
        elif op == "retract":
            if env.get("before") is not None:
                out.append({**env["before"], OP_COLUMN: "retract"})
        elif env.get("after") is not None:
            out.append({**env["after"], OP_COLUMN: "append"})
        return out

    def serialize(self, rows: Sequence[Dict[str, Any]]) -> List[bytes]:
        out = []
        for r in rows:
            if self.debezium:
                # a new body dict: the caller's row keeps its __op
                op = r.get(OP_COLUMN, "append")
                body = {k: v for k, v in r.items() if k != OP_COLUMN}
                env = {"before": body if op == "retract" else None,
                       "after": None if op == "retract" else body,
                       "op": "d" if op == "retract" else "c"}
                out.append(json.dumps(env, default=_py).encode())
            elif self.include_schema:
                env = {"schema": json_schema_for_rows([r]), "payload": r}
                out.append(json.dumps(env, default=_py).encode())
            else:
                out.append(json.dumps(r, default=_py).encode())
        return out

    def serialize_batch(self, batch: Batch) -> List[bytes]:
        """One encoded-cell pass a column and a row template
        (:func:`encode_json_lines`); the envelope modes,
        ``ARROYO_FAST_DECODE=0`` and columns the cell encoders cannot
        express take the row path, whose bytes are the same."""
        if (self.debezium or self.include_schema
                or not fast_decode_enabled()):
            return self.serialize(batch_to_rows(batch))
        lines = encode_json_lines(batch)
        if lines is None:
            return self.serialize(batch_to_rows(batch))
        return [line.encode() for line in lines]


@dataclass
class RawStringFormat(Format):
    """One UTF-8 string a payload, in and out of one ``value`` column."""

    name: str = "raw_string"

    def deserialize(self, payloads: Sequence[bytes]) -> List[Dict[str, Any]]:
        return [{"value": (p if isinstance(p, str)
                           else p.decode("utf-8", "replace"))}
                for p in payloads if p is not None]

    def serialize(self, rows: Sequence[Dict[str, Any]]) -> List[bytes]:
        out = []
        for r in rows:
            v = r.get("value")
            if v is None and len(r) == 1:
                v = next(iter(r.values()))
            elif v is None:
                v = json.dumps(r, default=_py)
            out.append(str(v).encode())
        return out


def json_schema_for_rows(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """A JSON-schema descriptor inferred from sample rows; a field whose
    rows disagree on a non-null type widens to string."""
    props: Dict[str, Dict[str, Any]] = {}
    for r in rows:
        for k, v in r.items():
            t = _json_type(v)
            if k not in props:
                props[k] = {"type": t}
            elif props[k]["type"] != t and v is not None:
                props[k]["type"] = "string"
    return {"type": "object", "properties": props}


def _json_type(v: Any) -> str:
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, np.integer)):
        return "integer"
    if isinstance(v, (float, np.floating)):
        return "number"
    if v is None:
        return "null"
    if isinstance(v, (list, np.ndarray)):
        return "array"
    if isinstance(v, dict):
        return "object"
    return "string"


def make_format(name: str, **opts: Any) -> Format:
    """The format of a connector config's ``format`` field: ``json``,
    ``debezium_json``, ``raw`` / ``raw_string`` or ``avro``."""
    if name in ("json", "debezium_json"):
        return JsonFormat(debezium=(name == "debezium_json"), **opts)
    if name in ("raw", "raw_string"):
        return RawStringFormat()
    if name == "avro":
        return AvroFormat(**opts)
    raise ValueError(f"unknown format: {name!r}")


def columns_from_json_schema(schema: Dict[str, Any]) -> List[Dict[str, str]]:
    """A JSON schema as a column list (nested objects flatten to dotted
    names).  Raises on a non-object root and on unsupported types."""
    t0 = schema.get("type")
    if isinstance(t0, list):  # a nullable object root
        t0 = next((x for x in t0 if x != "null"), None)
    if t0 != "object":
        raise ValueError("schema root must be an object")
    kind_of = {"integer": "bigint", "number": "double", "string": "text",
               "boolean": "boolean"}
    cols = []
    for name, spec in (schema.get("properties") or {}).items():
        t = spec.get("type")
        if isinstance(t, list):  # a nullable union like ["integer", "null"]
            t = next((x for x in t if x != "null"), None)
        if t == "object":
            for sub in columns_from_json_schema(spec):
                cols.append({"name": f"{name}.{sub['name']}",
                             "type": sub["type"]})
            continue
        if t not in kind_of:
            raise ValueError(f"unsupported type {t!r} for field {name!r}")
        fmt = spec.get("format", "")
        cols.append({"name": name,
                     "type": "timestamp" if "date-time" in fmt
                     else kind_of[t]})
    if not cols:
        raise ValueError("schema has no supported properties")
    return cols


# -- Avro (binary encoding, pure Python) -------------------------------------------


def _zigzag_encode(n: int) -> bytes:
    """An Avro long: zigzag, then a little-endian base-128 varint."""
    z = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_decode(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    acc = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1), pos


def avro_schema_for_rows(rows: Sequence[Dict[str, Any]],
                         name: str = "Record") -> Dict[str, Any]:
    """An Avro record schema inferred from sample rows: a nullable union
    a field, a field whose rows disagree widening to string."""
    fields: Dict[str, str] = {}
    for r in rows:
        for k, v in r.items():
            if isinstance(v, bool):
                t = "boolean"
            elif isinstance(v, (int, np.integer)):
                t = "long"
            elif isinstance(v, (float, np.floating)):
                t = "double"
            elif v is None:
                continue
            else:
                t = "string"
            prev = fields.get(k)
            fields[k] = t if prev in (None, t) else "string"
    return {"type": "record", "name": name,
            "fields": [{"name": k, "type": ["null", t]}
                       for k, t in fields.items()]}


class AvroFormat(Format):
    """Avro binary serde against a record schema: the single-record
    encoding, optionally with the Confluent wire framing (magic 0 and a
    4-byte schema id).  Every field is a ``["null", T]`` union with T in
    boolean, int, long, float, double, string, bytes, or a logical type
    over one of them; other shapes are rejected.  With
    ``schema_registry_url`` the writer schema is registered on encode and
    resolved by the header's id on decode."""

    def __init__(self, schema: Optional[Dict[str, Any]] = None,
                 confluent_schema_registry: bool = False,
                 schema_id: int = 0,
                 schema_registry_url: Optional[str] = None,
                 subject: Optional[str] = None, **_ignored):
        if isinstance(schema, str):
            schema = json.loads(schema)
        self.schema = schema
        self.confluent = confluent_schema_registry or bool(
            schema_registry_url)
        self.schema_id = schema_id
        self.registry_url = schema_registry_url
        self.subject = subject
        # schema text -> registered id (an inferred schema can change
        # from batch to batch)
        self._registered: Dict[str, int] = {}
        self._fts_by_id: Dict[int, List[Tuple[str, str]]] = {}

    def _registry(self):
        from .connectors.schema_registry import registry_client

        return registry_client(self.registry_url)

    SUPPORTED = {"boolean", "int", "long", "float", "double", "string",
                 "bytes"}

    def _field_types(self, schema=None) -> List[Tuple[str, str]]:
        schema = schema or self.schema
        if schema is None:
            raise ValueError("avro format needs a schema")
        out = []
        for f in schema["fields"]:
            t = f["type"]
            # the wire layout here is exactly a ["null", T] union (null
            # the branch 0): any other shape would be mis-framed
            if not (isinstance(t, list) and len(t) == 2 and t[0] == "null"):
                raise ValueError(
                    f"avro field {f['name']!r}: only [\"null\", T] unions "
                    f"are supported (got {t!r})")
            t = t[1]
            if isinstance(t, dict):
                # a logical type's wire encoding is its underlying type's
                t = t.get("type", "string")
            if t not in self.SUPPORTED:
                raise ValueError(
                    f"avro field {f['name']!r}: unsupported type {t!r}")
            out.append((f["name"], t))
        return out

    def _encode_value(self, t: str, v: Any) -> bytes:
        if t == "boolean":
            return b"\x01" if v else b"\x00"
        if t in ("long", "int"):
            return _zigzag_encode(int(v))
        if t == "double":
            return struct.pack("<d", float(v))
        if t == "float":
            return struct.pack("<f", float(v))
        if t == "bytes":
            raw = bytes(v)
            return _zigzag_encode(len(raw)) + raw
        raw = str(v).encode()
        return _zigzag_encode(len(raw)) + raw

    def serialize(self, rows: Sequence[Dict[str, Any]]) -> List[bytes]:
        # no configured schema: one inferred a call
        schema = self.schema or avro_schema_for_rows(rows)
        fts = self._field_types(schema)
        sid = self.schema_id
        if self.registry_url:
            text = json.dumps(schema, sort_keys=True)
            if text not in self._registered:
                self._registered[text] = self._registry().register(
                    self.subject or f"{schema.get('name', 'record')}-value",
                    schema)
            sid = self._registered[text]
        header = (b"\x00" + sid.to_bytes(4, "big")
                  if self.confluent else b"")
        out = []
        for r in rows:
            buf = bytearray(header)
            for name, t in fts:
                v = r.get(name)
                if v is None:
                    buf += _zigzag_encode(0)  # union branch 0: null
                else:
                    buf += _zigzag_encode(1)
                    buf += self._encode_value(t, v)
            out.append(bytes(buf))
        return out

    def _decode_value(self, t: str, buf: bytes, pos: int) -> Tuple[Any, int]:
        if t == "boolean":
            return buf[pos] != 0, pos + 1
        if t in ("long", "int"):
            return _zigzag_decode(buf, pos)
        if t == "double":
            return struct.unpack_from("<d", buf, pos)[0], pos + 8
        if t == "float":
            return struct.unpack_from("<f", buf, pos)[0], pos + 4
        n, pos = _zigzag_decode(buf, pos)
        raw = buf[pos:pos + n]
        return (raw if t == "bytes" else raw.decode()), pos + n

    def deserialize(self, payloads: Sequence[bytes]) -> List[Dict[str, Any]]:
        own_fts = self._field_types() if self.schema is not None else None
        rows = []
        for p in payloads:
            # the framing guard: strip the header only where it is there
            pos = 5 if (self.confluent and len(p) >= 5 and p[0] == 0) else 0
            if pos and self.registry_url:
                # the writer schema by the header's id, a payload at a
                # time, so a framed payload's schema never decodes an
                # unframed neighbour
                sid = int.from_bytes(p[1:5], "big")
                fts = self._fts_by_id.get(sid)
                if fts is None:
                    fts = self._field_types(self._registry().get_schema(sid))
                    self._fts_by_id[sid] = fts
            else:
                fts = own_fts
            if fts is None:
                raise ValueError(
                    "avro format needs a schema (or a schema_registry_url "
                    "with confluent framing)")
            row: Dict[str, Any] = {}
            for name, t in fts:
                branch, pos = _zigzag_decode(p, pos)
                if branch == 0:
                    row[name] = None
                else:
                    row[name], pos = self._decode_value(t, p, pos)
            rows.append(row)
        return rows
