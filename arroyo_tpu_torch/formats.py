"""Wire formats: bytes -> rows -> columnar Batch (the decode subset of
``arroyo_tpu.formats`` that the Kafka source needs).

A connector hands a list of raw payloads to ``Format.batch`` and gets one
columnar :class:`~arroyo_tpu_torch.types.Batch` back.  JSON takes the
JAX package's route for a machine without pyarrow: one bulk
``json.loads`` of the whole batch feeding the legacy row pivot
(:func:`rows_to_columns`), and the row-at-a-time path when the bulk parse
fails or ``ARROYO_FAST_DECODE=0``.  The arrow reader, Avro, raw strings
and the encoders are not ported yet."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .types import Batch, now_micros


def fast_decode_enabled() -> bool:
    """``ARROYO_FAST_DECODE=0`` disables the vectorized decode path, so
    the formats reproduce the row-at-a-time path.  Read per call."""
    return os.environ.get("ARROYO_FAST_DECODE", "1") not in ("0", "off",
                                                             "false")


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
    encodings: NaN rows in float columns and None rows in object
    columns.  Returns the combined mask, or None when every row is
    valid."""
    if isinstance(v, np.ndarray) and v.dtype == object:
        nn = np.array([x is not None and x == x for x in v], dtype=bool)
        return nn if m is None else (m & nn)
    if isinstance(v, np.ndarray) and v.dtype.kind == "f":
        nn = ~np.isnan(v)
        return nn if m is None else (m & nn)
    return m


def coerce_float(arr: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Numeric view of a column for aggregation inputs: None (in object
    columns from nullable JSON) becomes NaN instead of raising."""
    if arr.dtype == object:
        return np.array([np.nan if v is None else float(v) for v in arr],
                        dtype=dtype)
    return arr.astype(dtype)


class Format:
    """bytes[] -> rows -> Batch.  Stateless apart from fast-path
    bookkeeping, and reusable."""

    name = "abstract"

    def deserialize(self, payloads: Sequence[bytes]) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def batch(self, payloads: Sequence[bytes],
              timestamp_field: Optional[str] = None) -> Batch:
        return batch_from_rows(self.deserialize(payloads), timestamp_field)


@dataclass
class JsonFormat(Format):
    """One JSON object per payload.  ``confluent_schema_registry`` strips
    the 5-byte magic + schema-id header the confluent serializers
    prepend."""

    name: str = "json"
    confluent_schema_registry: bool = False

    def _strip(self, p: bytes) -> bytes:
        if self.confluent_schema_registry and len(p) >= 5 and p[0] == 0:
            return p[5:]
        return p

    def batch(self, payloads: Sequence[bytes],
              timestamp_field: Optional[str] = None) -> Batch:
        """One bulk parse of the whole batch feeding the legacy pivot;
        ``ARROYO_FAST_DECODE=0`` takes the row path."""
        if not fast_decode_enabled():
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
            obj = json.loads(
                self._strip(p if isinstance(p, bytes) else str(p).encode()))
            if isinstance(obj, list):
                rows.extend(o for o in obj if isinstance(o, dict))
            elif isinstance(obj, dict):
                rows.append(obj)
            else:
                rows.append({"value": obj})
        return rows


def make_format(name: str, **opts: Any) -> Format:
    if name == "json":
        return JsonFormat(**opts)
    raise NotImplementedError(
        f"format {name!r} is not ported yet (the port decodes json)")
