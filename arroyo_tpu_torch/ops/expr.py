"""Columnar expression execution — the port of ``arroyo_tpu.ops.expr``.

Two kinds of function reach a ``CompiledExpr``.  Stream-API functions
(the hand-built programs) take a dict of host numpy columns (plus
``__timestamp``) and run on the host, as they always have.  Functions the
SQL planner compiles (``fn.sql_expr``) follow the JAX class's contract:

* ``_split_cols``: numeric columns the expression reads (``used_cols``)
  enter the function; a nullable object column enters as values plus
  ``__mask_<col>``; string and object columns pass through on the host;
* ``eval_host``: eager on the host, for the chain's ingest spine, with the
  numeric columns as numpy arrays, as the JAX package's host path has
  them (its ``jnp`` sites are torch CPU ops here);
* ``__call__``: eager on the expression device — the runner's device,
  or the CPU under ``ARROYO_EXPR_DEVICE=cpu``, which the JAX package also
  reads.  Inputs go up through ``device.to_device`` and results come
  back through ``device.to_host``.  The JAX package jits this function
  (``_get_jitted``) and pads rows to power-of-two buckets to bound XLA's
  recompiles; eager torch needs neither.

``eval_record_expr`` and ``eval_predicate`` return host numpy either way.
An expression that fails on the card raises; nothing retries it on the
CPU.

The join-key maps at the end carry the semantics of the JAX planner's
``_null_key_nonce_fn`` and ``_normalize_key``: the port's planner and the
hand-built q8 use them; NULLs are what ``formats.nan_validity`` says
they are."""

from __future__ import annotations

import os
import secrets
import time
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..formats import coerce_object_col, nan_validity
from ..obs import perf
from ..types import Batch
from . import colmath


def expr_device(device: torch.device) -> torch.device:
    """Where SQL expressions run: the runner's (resolved) device, unless
    ``ARROYO_EXPR_DEVICE=cpu`` pins them to the host."""
    if os.environ.get("ARROYO_EXPR_DEVICE", "").lower() == "cpu":
        return torch.device("cpu")
    return device


def _is_device_dtype(dt: np.dtype) -> bool:
    return dt != np.dtype(object) and (
        np.issubdtype(dt, np.number) or np.issubdtype(dt, np.bool_))


def _looks_stringy(v: np.ndarray) -> bool:
    """First non-None value (of a prefix) is a str: the column stays on
    the host path rather than coerce to a device dtype."""
    for x in v[:64]:
        if x is not None:
            return isinstance(x, str)
    return False


def _to_host(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return _device.to_host(v) if v.device.type == "cuda" else v.numpy()
    return v


class CompiledExpr:
    """A ColumnExpr over a batch's columns.  ``fn(cols)`` may return a
    dict of columns (record exprs) or a bool array (predicates)."""

    def __init__(self, name: str, fn: Callable[[Dict[str, Any]], Any],
                 device: torch.device):
        self.name = name
        self.fn = fn
        self.sql = bool(getattr(fn, "sql_expr", False))
        # columns the fn reads (the planner attaches them from the AST;
        # None = unknown, every column enters)
        self.used_cols = getattr(fn, "used_cols", None)
        self.device = expr_device(device)

    def _split_cols(self, batch: Batch
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """(numeric env, host passthrough cols) for this expression over
        one batch: the one definition of which columns enter the fn and
        which bypass it, shared by both paths."""
        num_cols: Dict[str, np.ndarray] = {"__timestamp": batch.timestamp}
        host_cols: Dict[str, np.ndarray] = {}
        used = self.used_cols
        for k, v in batch.columns.items():
            if used is not None and k not in used:
                # untouched by the expression: string-like object columns
                # stay visible for host passthrough; nullable numeric
                # object columns would be dropped by the projection
                if v.dtype == object and _looks_stringy(v):
                    host_cols[k] = v
                continue
            if v.dtype == object:
                vals, mask = coerce_object_col(v)
                if vals.dtype != object:
                    num_cols[k] = vals
                    if mask is not None:
                        num_cols["__mask_" + k] = mask
                    continue
                host_cols[k] = v
            elif _is_device_dtype(v.dtype):
                num_cols[k] = v
            else:
                host_cols[k] = v
        return num_cols, host_cols

    def eval_host(self, batch: Batch) -> Tuple[Any, int, Dict[str, Any]]:
        """Evaluate on the host: numpy columns in, no device dispatch
        (the chain's ingest spine).  Returns ``(out, n, host_cols)``."""
        n = len(batch)
        if not self.sql:
            return self.fn({"__timestamp": batch.timestamp,
                            **batch.columns}), n, {}
        num_cols, host_cols = self._split_cols(batch)
        return self.fn(dict(num_cols)), n, host_cols

    def __call__(self, batch: Batch) -> Tuple[Any, int, Dict[str, Any]]:
        """Evaluate on the expression device; the results come back to
        the host before this returns."""
        if not self.sql:
            return self.eval_host(batch)
        n = len(batch)
        num_cols, host_cols = self._split_cols(batch)
        dev = self.device
        cuda = dev.type == "cuda"
        timing = cuda and perf.timing_enabled()
        if timing:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter_ns()
        env = {}
        nbytes = 0
        for k, v in num_cols.items():
            v = np.ascontiguousarray(v)
            nbytes += v.nbytes
            env[k] = (_device.to_device(v, dev) if cuda
                      else colmath.from_numpy(v))
        out = self.fn(env)
        if isinstance(out, dict):
            out = {k: _to_host(v) for k, v in out.items()}
            nbytes += sum(np.asarray(v).nbytes for v in out.values())
        else:
            out = _to_host(out)
            nbytes += np.asarray(out).nbytes
        if cuda:
            perf.count("expr_device_calls")
            perf.count("expr_device_bytes", nbytes)
            perf.count("expr_device_rows", n)
        if timing:
            torch.cuda.synchronize(dev)
            perf.count("expr_device_ns", time.perf_counter_ns() - t0)
        return out, n, host_cols


def eval_record_expr(expr: CompiledExpr, batch: Batch,
                     host: bool = False) -> Batch:
    """Record expression: fn(cols) -> dict of output columns.
    ``host=True`` evaluates on the host (the ingest spine); the output
    layout is the same either way."""
    out, n, host_cols = expr.eval_host(batch) if host else expr(batch)
    if not isinstance(out, dict):
        raise TypeError(f"record expr {expr.name} must return a dict")
    cols: Dict[str, np.ndarray] = {}
    ts = batch.timestamp
    for k, v in out.items():
        if k == "__timestamp":
            ts = np.asarray(_to_host(v))[:n]
            continue
        arr = np.asarray(_to_host(v))
        cols[k] = arr[:n] if arr.ndim >= 1 and arr.shape[0] >= n else arr
    # host (string) columns referenced in output pass through by name
    for k, v in host_cols.items():
        if k not in cols:
            cols[k] = v
    return Batch(ts, cols, batch.key_hash, batch.key_cols)


def eval_predicate(expr: CompiledExpr, batch: Batch,
                   host: bool = False) -> np.ndarray:
    out, n, _ = expr.eval_host(batch) if host else expr(batch)
    mask = np.asarray(_to_host(out))
    if mask.dtype != np.bool_:
        raise TypeError(f"predicate {expr.name} must return bool")
    if mask.ndim == 0:
        # constant predicate: broadcast to the batch
        return np.full(n, bool(mask))
    return mask[:n]


def eval_host_expr(fn: Callable[[Dict[str, np.ndarray]], Any], batch: Batch
                   ) -> Batch:
    """Host-side record expression over raw numpy columns (the UDF path;
    a SQL function's torch results are CPU tensors, read as numpy)."""
    out = fn({"__timestamp": batch.timestamp, **batch.columns})
    if not isinstance(out, dict):
        raise TypeError("udf must return a dict of columns")
    ts = np.asarray(_to_host(out.pop("__timestamp", batch.timestamp)))
    return Batch(ts, {k: np.asarray(_to_host(v)) for k, v in out.items()},
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
            v = np.asarray(_to_host(out[c]))
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
