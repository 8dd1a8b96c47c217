"""UDAF partial decomposition (a copy of ``arroyo_tpu.ops.udaf``, host
numpy): compile numeric user aggregates into the channel model of the
segment kernel.

A registered UDAF is an opaque ``fn(values) -> scalar`` the engine can
only call per segment on the host.  Most numeric UDAFs people register
are one of a small algebra over mergeable partials (sum / non-null count
/ min / max / sum-of-squares).  This module **probes** a UDAF against
that algebra with deterministic numeric test vectors: when ``fn`` agrees
with a candidate formula on every probe, it compiles to a
:class:`UdafPlan` — channel kinds for the segment kernel plus a
vectorized ``combine`` over the per-segment partials — and the
per-segment host loop never runs.  The verdict is sticky per function
object (probed once per process), and object or string columns always
take the counted host fallback (the channels are f64).

A UDAF that matches no candidate (``np.median`` has its own exact
vectorized path in ops/segment.py; percentiles are order statistics, not
mergeable partials) stays on the host loop and is counted there
(``udaf_host_rows``).

``ARROYO_UDAF_CHANNELS=off`` disables compilation (every UDAF on the
host loop).
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

# channel vocabulary: "nnz" is the per-segment non-null count (always
# present — it masks all-null segments to NaN, the SQL NULL contract);
# "sumsq" rides the kernels as a sum channel over squared inputs
CHANNEL_KINDS = ("sum", "nnz", "min", "max", "sumsq")


def udaf_channels_enabled() -> bool:
    return os.environ.get("ARROYO_UDAF_CHANNELS", "on").lower() not in (
        "off", "0", "false", "no")


@dataclass(frozen=True)
class UdafPlan:
    """A UDAF compiled onto mergeable partial channels.

    ``name`` identifies the algebra member (the planner's AST rewrite
    keys off it); ``channels`` are the partial kinds the segment/bin
    kernels must produce; ``combine`` folds the per-segment partial
    arrays into the output column (all-null masking is the caller's
    job, uniformly ``nnz == 0 -> NaN``)."""

    name: str
    channels: Tuple[str, ...]
    combine: Callable[[Dict[str, np.ndarray]], np.ndarray]


def _c_sum(d):
    return d["sum"]


def _c_count(d):
    return d["nnz"]


def _c_mean(d):
    with np.errstate(all="ignore"):
        return d["sum"] / d["nnz"]


def _c_min(d):
    return d["min"]


def _c_max(d):
    return d["max"]


def _c_ptp(d):
    return d["max"] - d["min"]


def _var_pop(d):
    with np.errstate(all="ignore"):
        n = d["nnz"]
        # E[x^2] - E[x]^2 in the single-pass mergeable form; tiny
        # negative residue from cancellation clips to zero
        return np.maximum((d["sumsq"] - d["sum"] * d["sum"] / n) / n, 0.0)


def _var_samp(d):
    with np.errstate(all="ignore"):
        n = d["nnz"]
        return np.maximum(
            (d["sumsq"] - d["sum"] * d["sum"] / n) / (n - 1), 0.0)


def _std_pop(d):
    return np.sqrt(_var_pop(d))


def _std_samp(d):
    return np.sqrt(_var_samp(d))


# (name, channels, reference implementation, combine) — probe order;
# first behavioral match wins.  References are the ground truth the
# probes compare fn against; combines are what production then runs.
_CANDIDATES: Tuple[Tuple[str, Tuple[str, ...], Callable, Callable], ...] = (
    ("count", ("nnz",), lambda p: float(len(p)), _c_count),
    ("sum", ("sum", "nnz"), np.sum, _c_sum),
    ("mean", ("sum", "nnz"), np.mean, _c_mean),
    ("min", ("min", "nnz"), np.min, _c_min),
    ("max", ("max", "nnz"), np.max, _c_max),
    ("ptp", ("min", "max", "nnz"), lambda p: np.max(p) - np.min(p), _c_ptp),
    ("var_pop", ("sum", "sumsq", "nnz"), lambda p: np.var(p), _var_pop),
    ("var_samp", ("sum", "sumsq", "nnz"),
     lambda p: np.var(p, ddof=1), _var_samp),
    ("std_pop", ("sum", "sumsq", "nnz"), lambda p: np.std(p), _std_pop),
    ("std_samp", ("sum", "sumsq", "nnz"),
     lambda p: np.std(p, ddof=1), _std_samp),
)

# Probe vectors (dyadic rationals — exact in binary, so algebraically
# equal formulas agree to the last ulp).  The multiset [3.5, -1.25, 7,
# 0.5, 2, 2] separates median (= 2) from mean (= 2.2916..); [2.5] and
# [1..5] separate sum/count/mean; the constant vector catches aggregates
# that ignore their input.
_PROBES = (
    np.array([2.5]),
    np.array([1.0, 2.0, 3.0, 4.0, 5.0]),
    np.array([3.5, -1.25, 7.0, 0.5, 2.0, 2.0]),
    np.array([4.0, 4.0, 4.0, 4.0]),
    np.array([0.8125, -3.75, 12.5, 0.0, 5.25, -0.5, 2.125]),
)

_RTOL = 1e-9
_ATOL = 1e-12

# sticky verdict per function OBJECT: probed once per process, then the
# segment path branches on a dict hit (the fallback is sticky too — a
# fn that failed probing never re-probes)
_verdicts: Dict[Callable, Optional[UdafPlan]] = {}


def _scalar(x) -> Optional[float]:
    try:
        arr = np.asarray(x, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    if arr.shape not in ((), (1,)):
        return None
    return float(arr.reshape(()))


def _matches(fn: Callable, ref: Callable) -> bool:
    for p in _PROBES:
        try:
            with warnings.catch_warnings(), np.errstate(all="ignore"):
                warnings.simplefilter("ignore")
                got = _scalar(fn(p.copy()))
                want = _scalar(ref(p))
        except Exception:
            return False
        if got is None or want is None:
            return False
        if np.isnan(want) and np.isnan(got):
            continue
        if not np.isclose(got, want, rtol=_RTOL, atol=_ATOL):
            return False
    return True


def udaf_plan(fn: Callable) -> Optional[UdafPlan]:
    """The channel plan for ``fn``, or None (host loop).  Probes at most
    once per function object; ``None`` verdicts are sticky.  The knob is
    read on every call, so it can flip mid-process."""
    if not udaf_channels_enabled():
        return None
    if fn in _verdicts:
        return _verdicts[fn]
    plan: Optional[UdafPlan] = None
    for name, channels, ref, combine in _CANDIDATES:
        if _matches(fn, ref):
            plan = UdafPlan(name, channels, combine)
            break
    _verdicts[fn] = plan
    return plan


def channel_rows(kind: str, raw: np.ndarray, ok: np.ndarray
                 ) -> Tuple[str, np.ndarray]:
    """Per-row kernel input for one plan channel: (kernel kind, rows).
    Nulls feed each kind its identity, so the partials are exact over
    the non-null subset — the same rows the host loop would see."""
    from .segment import NEG_INF, POS_INF

    if kind == "nnz":
        return "sum", ok.astype(np.float64)
    if kind == "sum":
        return "sum", np.where(ok, raw, 0.0)
    if kind == "sumsq":
        return "sum", np.where(ok, raw * raw, 0.0)
    if kind == "min":
        return "min", np.where(ok, raw, POS_INF)
    return "max", np.where(ok, raw, NEG_INF)
