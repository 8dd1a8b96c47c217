"""Columnar expression execution — the port of ``arroyo_tpu.ops.expr``.

Stream-API expressions are functions over a dict of host numpy columns
(plus ``__timestamp``).  The JAX package jit-compiles them or, on its
ingest spine, runs them eagerly on the host (``CompiledExpr.eval_host``);
the port always does the latter: the batch is host-resident on both sides
of an element-wise expression, so a device round trip would only add
copies.  Device-side SQL expressions arrive with the SQL planner.

The join-key maps at the end carry the semantics of the planner's
``_null_key_nonce_fn`` and ``_normalize_key`` (arroyo_tpu/sql/planner.py);
NULLs are what ``formats.nan_validity`` says they are."""

from __future__ import annotations

import secrets
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np

from ..formats import nan_validity
from ..types import Batch


class CompiledExpr:
    """A ColumnExpr evaluated over a batch's columns.  ``fn(cols)`` may
    return a dict of columns (record exprs) or a bool array (predicates)."""

    def __init__(self, name: str, fn: Callable[[Dict[str, Any]], Any]):
        self.name = name
        self.fn = fn

    def __call__(self, batch: Batch) -> Tuple[Any, int]:
        cols = {"__timestamp": batch.timestamp, **batch.columns}
        return self.fn(cols), len(batch)


def eval_record_expr(expr: CompiledExpr, batch: Batch) -> Batch:
    """Record expression: fn(cols) -> dict of output columns."""
    out, n = expr(batch)
    if not isinstance(out, dict):
        raise TypeError(f"record expr {expr.name} must return a dict")
    cols: Dict[str, np.ndarray] = {}
    ts = batch.timestamp
    for k, v in out.items():
        if k == "__timestamp":
            ts = np.asarray(v)[:n]
            continue
        arr = np.asarray(v)
        cols[k] = arr[:n] if arr.ndim >= 1 and arr.shape[0] >= n else arr
    return Batch(ts, cols, batch.key_hash, batch.key_cols)


def eval_predicate(expr: CompiledExpr, batch: Batch) -> np.ndarray:
    out, n = expr(batch)
    mask = np.asarray(out)
    if mask.dtype != np.bool_:
        raise TypeError(f"predicate {expr.name} must return bool")
    if mask.ndim == 0:
        # constant predicate: broadcast to the batch
        return np.full(n, bool(mask))
    return mask[:n]


def eval_host_expr(fn: Callable[[Dict[str, np.ndarray]], Any], batch: Batch
                   ) -> Batch:
    """Host-side record expression over raw numpy columns (the UDF path)."""
    out = fn({"__timestamp": batch.timestamp, **batch.columns})
    if not isinstance(out, dict):
        raise TypeError("udf must return a dict of columns")
    ts = np.asarray(out.pop("__timestamp", batch.timestamp))
    return Batch(ts, {k: np.asarray(v) for k, v in out.items()},
                 batch.key_hash, batch.key_cols)


# -- join keys (the planner's join-key maps) -------------------------------------


def normalize_join_key(v: Any) -> np.ndarray:
    """A join key column as the JAX planner casts it: float32, unless it
    holds objects (strings).  Integer ids are exact only below 2^24."""
    arr = np.asarray(v)
    return arr if arr.dtype == object else arr.astype(np.float32)


# per-process nonce space for null join keys: a random 30-bit salt in the
# high bits plus a monotone row counter
_jk_nonce_next = [(secrets.randbits(30) << 33) | (1 << 62)]


def join_key_fn(base_fn: Callable[[Dict[str, Any]], Dict[str, Any]],
                jk_cols: Sequence[str]
                ) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """Wrap a join-key map so every row gets an i64 ``__jknonce``: 0 for
    rows whose keys are all valid, a process-unique value for rows with a
    NULL key (SQL NULL keys never equal anything, each other included)."""

    def fn(cols: Dict[str, Any]) -> Dict[str, Any]:
        out = base_fn(cols)
        n = len(np.asarray(cols["__timestamp"]))
        nullmask = np.zeros(n, dtype=bool)
        for c in jk_cols:
            v = np.asarray(out[c])
            out[c] = v
            ok = nan_validity(v, None)
            if ok is not None:
                nullmask |= ~ok
        nonce = np.zeros(n, dtype=np.int64)
        if nullmask.any():
            idx = nullmask.nonzero()[0]
            base = _jk_nonce_next[0]
            _jk_nonce_next[0] = base + len(idx)
            nonce[idx] = base + np.arange(len(idx), dtype=np.int64)
        out["__jknonce"] = nonce
        return out

    return fn
