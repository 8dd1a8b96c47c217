"""Columnar expression execution — the port of ``arroyo_tpu.ops.expr``.

Stream-API expressions are functions over a dict of host numpy columns
(plus ``__timestamp``).  The JAX package jit-compiles them or, on its
ingest spine, runs them eagerly on the host (``CompiledExpr.eval_host``);
the port always does the latter: the batch is host-resident on both sides
of an element-wise expression, so a device round trip would only add
copies.  Device-side SQL expressions arrive with the SQL planner."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np

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
