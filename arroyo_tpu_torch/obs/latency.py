"""Record-level end-to-end latency observatory (port of
``arroyo_tpu.obs.latency``).

The flight recorder and the phase profiler measure *where host time
goes*; this module measures *how long a record takes* from source
ingestion to sink emission, in three coupled parts:

**1. Latency sampling.**  Sources stamp a deterministic 1-in-N sample
of records with their ingest wall-clock.  The stamp is a *side-channel
batch annotation* (``Batch.lat_stamp``, types.py) rather than a hidden
``__lat_ingest`` column: the coalescer signature and the sanitizer's
per-edge schema check read only ``columns``/``key_cols``/``key_hash``,
so arming sampling never flips a schema signature.  The stamp
survives:

- operator chaining: the task loop parks the input batch's stamp in a
  per-asyncio-task :data:`ContextVar` (:func:`set_current`) and
  ``Context.collect`` re-attaches it to operator-built batches, so a
  chain tail's emission inherits the head input's stamp without
  per-member plumbing;
- coalescing: ``Batch.concat`` keeps the **oldest** stamp (linger is
  charged to latency, never hidden);
- shuffles: ``Batch.select`` carries it through host partition routes
  and the device shuffle hands it to every destination's sub-batch (the
  JAX package's network data plane, which also carries it, is not
  ported);
- window fires: a fired pane inherits the **max** stamp of the sampled
  batches that contributed since the last fire (the freshest sampled
  record still waiting in the pane bounds the watermark hold from
  below), persisted across checkpoint/restore with the pane state;
- joins: an emitted match set inherits the probing batch's stamp via
  the same ContextVar re-attach.

Sinks compute emit-minus-ingest into per-sink
``arroyo_sink_e2e_latency_seconds`` histograms plus rolling p50/p99
gauges.

**2. Watermark lineage.**  ``Context.observe_watermark`` notes the age
of every watermark each operator consumes (per-edge watermark-age
tracking), and :meth:`LatencyObservatory.critical_path` decomposes
where a sampled record's time went — source linger → queue wait →
barrier align → watermark hold → fire → emit — by folding the phase
profiler's work/wait buckets (when armed) with the observatory's own
barrier-align and watermark-hold accumulators.  ``summary_ride_alongs``
folds it into ``metrics.job_operator_summary``.

**3. SLO engine** (its pure half).  A declarative :class:`Slo`
(``p99_ms`` / ``staleness_ms``, built from explicit arguments: the port
reads no SLO from the environment until the controller that ticks it
comes with ROADMAP A.11) is judged against measured
quantiles by :class:`SloEvaluator`: every evaluation appends a
violating/ok sample, the burn rate is the violating fraction of the
trailing ``burn_window_secs`` (:func:`burn_rate` is the pure math),
violations land in an event ring and the
``arroyo_slo_{violations_total,burn_rate}`` metrics.  The controller
loop that ticks it, the REST latency route and the admin ``/latency``
page wait for the control plane (ROADMAP A.11).

Off-path discipline (same as the profiler and the sanitizer): every hook site
tests ``latency.active() is not None`` — disarmed, the whole
observatory is a single ``None`` check and records nothing.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..types import now_micros

__all__ = [
    "LatencyObservatory",
    "Slo",
    "SloEvaluator",
    "burn_rate",
    "sampling_enabled",
    "active",
    "arm",
    "disarm",
    "ensure_armed",
    "set_current",
    "current",
    "device_state_tables",
    "summary_ride_alongs",
    "CRITICAL_PATH_STAGES",
]

# The per-fire critical-path decomposition stages, in record order.
CRITICAL_PATH_STAGES = ("source_linger", "queue_wait", "barrier_align",
                        "watermark_hold", "fire", "emit", "compute")

# How the profiler's phase/wait buckets fold into the stages (the
# observatory's own accumulators cover barrier_align and
# watermark_hold, which the profiler has no phase for).
_STAGE_FOLD = {
    "source_linger": (("source_decode", False), ("coalesce_merge", False),
                      ("coalesce_wait", True)),
    "queue_wait": (("queue_wait", True), ("send_wait", True),
                   ("net_flush", True)),
    "fire": (("watermark", False),),
    "emit": (("emit_encode", False), ("frame_encode", False)),
    "compute": (("proc", False), ("dispatch", False),
                ("device_execute", False), ("shuffle_prep", False),
                ("frame_decode", False), ("gather", False)),
}


def sampling_enabled() -> bool:
    """``ARROYO_LATENCY_SAMPLE_N > 0`` arms the observatory at engine
    build (read per build, not at import, so tests/bench toggle per
    run)."""
    from ..config import config

    return config().latency_sample_n > 0


_ACTIVE: Optional["LatencyObservatory"] = None


def active() -> Optional["LatencyObservatory"]:
    """The armed observatory, or ``None`` — the hook sites' single
    cheap test."""
    return _ACTIVE


def arm(job_id: str = "", sample_n: Optional[int] = None
        ) -> "LatencyObservatory":
    """Arm the process-wide observatory (idempotent: an already-armed
    observatory is returned unchanged, keeping its rolling windows)."""
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = LatencyObservatory(job_id, sample_n)
    return _ACTIVE


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


def ensure_armed(job_id: str = "") -> Optional["LatencyObservatory"]:
    """Engine-build hook: arm iff the config asks for sampling (or an
    explicit :func:`arm` already did)."""
    if _ACTIVE is not None:
        return _ACTIVE
    if sampling_enabled():
        return arm(job_id)
    return None


# -- current-input stamp (chain / operator-rebuild survival) -----------------

# Each TaskRunner processes one input batch at a time within its own
# asyncio task, so a ContextVar scopes "the stamp of the batch being
# processed right now" correctly even when tasks interleave on the
# loop.  The task loop sets it around process_batch; Context.collect
# re-attaches it to operator-built batches that lost the annotation.
_CUR: ContextVar[Optional[int]] = ContextVar("arroyo_lat_current",
                                             default=None)


def set_current(stamp: Optional[int]) -> None:
    _CUR.set(stamp)


def current() -> Optional[int]:
    return _CUR.get()


def maybe_stamp(src_key: str, batch) -> None:
    """Source-boundary stamping for connectors that emit ``Batch``
    objects directly (bypassing ``SourceBatcher``): stamps the batch
    carrying the next 1-in-N sampled record with its ingest wall-clock.
    Never overwrites a stamp the caller set (tests / replays)."""
    lat = _ACTIVE
    if (lat is None or batch is None or len(batch) == 0
            or batch.lat_stamp is not None):
        return
    stamp = lat.source_stamp(src_key, len(batch))
    if stamp is not None:
        batch.lat_stamp = stamp


# -- the observatory ---------------------------------------------------------


class LatencyObservatory:
    """Process-wide record-latency accounting (one job per worker
    process; the embedded multi-job scheduler shares one, documented
    like the profiler)."""

    def __init__(self, job_id: str = "", sample_n: Optional[int] = None):
        from ..config import config

        self.job_id = job_id
        n = sample_n if sample_n is not None else config().latency_sample_n
        self.sample_n = max(int(n), 1)
        self._lock = threading.Lock()
        # deterministic 1-in-N sampling: per-source-subtask row counters
        self._seen: Dict[str, int] = {}
        self._stamps: Dict[str, int] = {}
        # per-sink rolling latency windows (seconds)
        self._sinks: Dict[str, Deque[float]] = {}
        self._sink_counts: Dict[str, int] = {}
        self._sink_last: Dict[str, float] = {}
        # per-consumer watermark ages: op_id -> (age_secs, wm_micros)
        self._wm_age: Dict[str, Tuple[float, int]] = {}
        # own critical-path accumulators (stages the profiler lacks)
        self._stages: Dict[str, float] = {}
        self._stage_counts: Dict[str, int] = {}

    # -- sampling (source side) --------------------------------------------

    def source_stamp(self, src_key: str, n_rows: int) -> Optional[int]:
        """Deterministic 1-in-N sampling: returns the ingest wall-clock
        (micros) iff this batch contains the next sampled record — i.e.
        the source's cumulative row count crosses a multiple of N —
        else ``None``.  Counting rows (not batches) keeps the sampled
        rate independent of batch size."""
        if n_rows <= 0:
            return None
        n = self.sample_n
        with self._lock:
            prev = self._seen.get(src_key, 0)
            cur = prev + int(n_rows)
            self._seen[src_key] = cur
            if prev // n == cur // n:
                return None
            self._stamps[src_key] = self._stamps.get(src_key, 0) + 1
        return now_micros()

    # -- sink side ----------------------------------------------------------

    def observe_sink(self, task_info, stamp_micros: int,
                     emit_micros: Optional[int] = None) -> float:
        """Record one emit-minus-ingest sample at a sink: feeds the
        per-sink histogram and refreshes the rolling p50/p99 gauges.
        Returns the latency in seconds."""
        from . import metrics as _m

        emit = now_micros() if emit_micros is None else emit_micros
        secs = max(int(emit) - int(stamp_micros), 0) / 1e6
        op = task_info.operator_id
        _m.sink_latency_histogram(task_info).observe(secs)
        with self._lock:
            dq = self._sinks.get(op)
            if dq is None:
                dq = self._sinks[op] = deque(maxlen=2048)
            dq.append(secs)
            self._sink_counts[op] = self._sink_counts.get(op, 0) + 1
            self._sink_last[op] = secs
            p50, p99 = _quantiles(dq)
        _m.sink_latency_quantile_gauge(task_info, "p50").set(p50)
        _m.sink_latency_quantile_gauge(task_info, "p99").set(p99)
        return secs

    # -- watermark lineage --------------------------------------------------

    def note_edge_watermark(self, op_id: str, wm_micros: int) -> None:
        """Per-edge watermark-age tracking: how stale the watermark an
        operator just consumed was at consumption time.  A sink whose
        age keeps growing is downstream of the held stage."""
        age = max(now_micros() - int(wm_micros), 0) / 1e6
        with self._lock:
            self._wm_age[op_id] = (age, int(wm_micros))

    def note_stage(self, stage: str, secs: float) -> None:
        """Accumulate an observatory-owned critical-path stage (the
        profiler has no phase for barrier alignment or watermark
        hold)."""
        with self._lock:
            self._stages[stage] = self._stages.get(stage, 0.0) + secs
            self._stage_counts[stage] = self._stage_counts.get(stage, 0) + 1

    def critical_path(self) -> Dict[str, Any]:
        """Per-fire critical-path decomposition: fold the profiler's
        phase/wait totals (when armed) with the observatory's own
        barrier-align / watermark-hold accumulators into the record's
        journey stages, and name the dominant one."""
        stages = {s: 0.0 for s in CRITICAL_PATH_STAGES}
        with self._lock:
            for stage, secs in self._stages.items():
                if stage in stages:
                    stages[stage] += secs
        from . import profiler as _profiler

        prof = _profiler.active()
        if prof is not None:
            work: Dict[str, float] = {}
            waits: Dict[str, float] = {}
            for (_op, ph), secs in prof.work_snapshot().items():
                work[ph] = work.get(ph, 0.0) + secs
            for (_op, ph), secs in prof.wait_snapshot().items():
                waits[ph] = waits.get(ph, 0.0) + secs
            for stage, parts in _STAGE_FOLD.items():
                for phase, is_wait in parts:
                    stages[stage] += (waits if is_wait else work).get(
                        phase, 0.0)
        total = sum(stages.values())
        dominant = max(stages, key=stages.get) if total > 0 else ""
        return {
            "stages": {k: round(v, 6) for k, v in stages.items()},
            "total_secs": round(total, 6),
            "dominant": dominant,
            "dominant_share": round(stages[dominant] / total, 4)
            if total > 0 else 0.0,
        }

    # -- reads --------------------------------------------------------------

    def sink_quantiles(self) -> Dict[str, Dict[str, float]]:
        """Per-sink rolling-window stats: p50/p99/last (ms) + count."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for op, dq in self._sinks.items():
                p50, p99 = _quantiles(dq)
                out[op] = {
                    "p50_ms": round(p50 * 1e3, 3),
                    "p99_ms": round(p99 * 1e3, 3),
                    "last_ms": round(self._sink_last.get(op, 0.0) * 1e3, 3),
                    "count": float(self._sink_counts.get(op, 0)),
                }
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Full structured snapshot (the JAX admin ``/latency`` body)."""
        with self._lock:
            seen = dict(self._seen)
            stamps = dict(self._stamps)
            wm = {op: {"age_ms": round(age * 1e3, 3), "watermark": t}
                  for op, (age, t) in self._wm_age.items()}
        return {
            "job_id": self.job_id,
            "sample_n": self.sample_n,
            "records_seen": sum(seen.values()),
            "records_sampled": sum(stamps.values()),
            "sources": {k: {"seen": seen[k], "sampled": stamps.get(k, 0)}
                        for k in sorted(seen)},
            "sinks": self.sink_quantiles(),
            "watermarks": wm,
            "critical_path": self.critical_path(),
            "device_state_bytes": device_state_tables(),
        }


def _quantiles(samples: Sequence[float]) -> Tuple[float, float]:
    xs = sorted(samples)
    if not xs:
        return 0.0, 0.0
    return (xs[len(xs) // 2], xs[min(int(len(xs) * 0.99), len(xs) - 1)])


# -- SLO engine --------------------------------------------------------------


@dataclass
class Slo:
    """Per-pipeline declarative latency SLO.  A dimension set to 0 is
    unset; :meth:`configured` is False when both are."""

    p99_ms: float = 0.0
    staleness_ms: float = 0.0
    burn_window_secs: float = 60.0

    def configured(self) -> bool:
        return self.p99_ms > 0 or self.staleness_ms > 0

    def to_json(self) -> Dict[str, float]:
        return {"p99_ms": self.p99_ms, "staleness_ms": self.staleness_ms,
                "burn_window_secs": self.burn_window_secs}


def burn_rate(samples: Sequence[Tuple[float, bool]], now: float,
              window_secs: float) -> float:
    """The pure burn math: the violating fraction of SLO evaluations in
    the trailing window — 0.0 is a healthy pipeline, 1.0 burns the
    whole error budget every tick.  Samples outside the window are
    ignored; an empty window reads 0.0 (no evidence is not a
    violation)."""
    recent = [bool(v) for t, v in samples if now - t <= window_secs]
    if not recent:
        return 0.0
    return sum(recent) / len(recent)


class SloEvaluator:
    """SLO burn-rate evaluation for one job: a bounded sample ring, a
    bounded violation-event ring, and counters — ``to_json`` is the
    verdict."""

    def __init__(self, job_id: str, slo: Slo):
        self.job_id = job_id
        self.slo = slo
        self._samples: Deque[Tuple[float, bool]] = deque(maxlen=4096)
        self._events: Deque[Dict[str, Any]] = deque(maxlen=256)
        self.violations_total = 0
        self.evaluations_total = 0
        self._last: Dict[str, Any] = {}

    def evaluate(self, p99_ms: Optional[float],
                 staleness_ms: Optional[float],
                 now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation tick: judge the measured quantiles against
        the SLO, update the burn rate, and record a violation event +
        metrics when a dimension is out of budget.  ``None`` measured
        values (no samples yet) never violate."""
        now = time.time() if now is None else now
        s = self.slo
        violated: Dict[str, Dict[str, float]] = {}
        if s.p99_ms > 0 and p99_ms is not None and p99_ms > s.p99_ms:
            violated["p99"] = {"measured_ms": round(p99_ms, 3),
                               "target_ms": s.p99_ms}
        if (s.staleness_ms > 0 and staleness_ms is not None
                and staleness_ms > s.staleness_ms):
            violated["staleness"] = {"measured_ms": round(staleness_ms, 3),
                                     "target_ms": s.staleness_ms}
        violating = bool(violated)
        self.evaluations_total += 1
        self._samples.append((now, violating))
        rate = burn_rate(self._samples, now, s.burn_window_secs)
        from . import metrics as _m

        _m.slo_burn_rate_gauge(self.job_id).set(rate)
        if violating:
            self.violations_total += 1
            _m.slo_violations_counter(self.job_id).inc()
            self._events.append({"t": round(now, 3), "dims": violated,
                                 "burn_rate": round(rate, 4)})
        self._last = {
            "configured": s.configured(),
            "violating": violating,
            "burn_rate": round(rate, 4),
            "violated_dims": violated,
            "p99_ms": round(p99_ms, 3) if p99_ms is not None else None,
            "staleness_ms": round(staleness_ms, 3)
            if staleness_ms is not None else None,
            "t": round(now, 3),
        }
        return self._last

    @property
    def current_burn_rate(self) -> float:
        return float(self._last.get("burn_rate", 0.0))

    def to_json(self, limit: int = 16) -> Dict[str, Any]:
        return {
            "slo": self.slo.to_json(),
            "configured": self.slo.configured(),
            "last": dict(self._last),
            "violations_total": self.violations_total,
            "evaluations_total": self.evaluations_total,
            "recent_violations": list(self._events)[-limit:],
        }


# -- device-memory ledger ---------------------------------------------------


def device_state_tables() -> Dict[str, int]:
    """Sweep the port's state registries into one table -> bytes map:
    the join buffers' rings (``join_state_registry``: payload rings, the
    keys-only rings' key planes, and the cold partitions' host bytes) and
    the window pane planes (``pane_state_registry``, noted by
    ``BinAggOperator``) and the device shuffle's staged column stacks
    of its last batch (``shuffle_stack_bytes``)."""
    from . import perf

    out: Dict[str, int] = {}
    from ..state.join_state import aggregate_stats_registry

    reg = perf.get_note("join_state_registry")
    js = aggregate_stats_registry(reg)
    if js:
        out["join_payload_rings"] = int(js.get("payload_ring_bytes", 0))
        out["join_ring_keys"] = int(sum(e.get("ring_key_bytes", 0)
                                        for e in reg.values()))
        out["join_spill_host"] = int(js.get("spill_bytes", 0))
    panes = perf.get_note("pane_state_registry")
    if isinstance(panes, dict) and panes:
        out["panes"] = int(sum(int(v) for v in panes.values()))
    stacks = perf.get_note("shuffle_stack_bytes")
    if stacks:
        out["shuffle_stacks"] = int(stacks)
    return out


# -- heartbeat ride-alongs ---------------------------------------------------


def summary_ride_alongs(job_id: str) -> Dict[str, Dict[str, float]]:
    """Latency keys a worker folds into ``job_operator_summary`` (the
    same mechanism as the profiler's ``phase_seconds.*``): per-sink
    ``e2e_latency.*`` quantiles, per-operator ``wm_age_ms``, and
    worker-level ``critical_path.*`` / ``device_bytes.*`` under the
    ``__worker__`` pseudo-operator.  Refreshes the
    ``arroyo_device_state_bytes`` gauges as a side effect so the local
    /metrics scrape agrees with what heartbeats ship."""
    lat = active()
    out: Dict[str, Dict[str, float]] = {}
    if lat is None or (lat.job_id and lat.job_id != job_id):
        return out
    for op, q in lat.sink_quantiles().items():
        out[op] = {
            "e2e_latency.p50_ms": q["p50_ms"],
            "e2e_latency.p99_ms": q["p99_ms"],
            "e2e_latency.last_ms": q["last_ms"],
            "e2e_latency.count": q["count"],
        }
    with lat._lock:
        ages = {op: age for op, (age, _t) in lat._wm_age.items()}
    for op, age in ages.items():
        out.setdefault(op, {})["wm_age_ms"] = round(age * 1e3, 3)
    w = out.setdefault("__worker__", {})
    cp = lat.critical_path()
    for stage, secs in cp["stages"].items():
        w[f"critical_path.{stage}"] = secs
    from . import metrics as _m

    for table, nbytes in device_state_tables().items():
        w[f"device_bytes.{table}"] = float(nbytes)
        _m.device_state_bytes_gauge(job_id, table).set(nbytes)
    w["latency_sample_n"] = float(lat.sample_n)
    return out
