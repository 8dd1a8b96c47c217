"""Per-task metrics with the reference's metric names (port of
``arroyo_tpu.obs.metrics``).

Names match the reference's arroyo-types/src/lib.rs:734-739 exactly
(arroyo_worker_messages_recv, …) and labels match TaskInfo::
metric_label_map (lib.rs:579-585: operator_id, subtask_idx,
operator_name), so dashboards and rate() queries read both packages.

The JAX package keeps its instruments in a ``prometheus_client``
registry.  The port carries a small registry of its own instead — labeled
counters, gauges and histograms and the Prometheus text exposition
(format 0.0.4, with the ``_total`` and ``_created`` series
``prometheus_client`` writes) — so it needs no package beyond the
standard library.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

MESSAGES_RECV = "arroyo_worker_messages_recv"
MESSAGES_SENT = "arroyo_worker_messages_sent"
BYTES_RECV = "arroyo_worker_bytes_recv"
BYTES_SENT = "arroyo_worker_bytes_sent"
TX_QUEUE_SIZE = "arroyo_worker_tx_queue_size"
TX_QUEUE_REM = "arroyo_worker_tx_queue_rem"

# flight-recorder instruments
EVENT_TIME_LAG = "arroyo_worker_event_time_lag_seconds"
WATERMARK_LAG = "arroyo_worker_watermark_lag_seconds"
BATCH_LATENCY = "arroyo_worker_batch_processing_seconds"
QUEUE_WAIT = "arroyo_worker_queue_wait_seconds"
BACKPRESSURE_TIME = "arroyo_worker_backpressure_seconds_total"
KERNEL_TIME = "arroyo_worker_kernel_seconds_total"
CHECKPOINT_DURATION = "arroyo_worker_checkpoint_duration_seconds"
CHECKPOINT_BYTES = "arroyo_worker_checkpoint_bytes"
FRAME_BYTES = "arroyo_worker_frame_bytes"
FLUSH_LATENCY = "arroyo_worker_flush_seconds"
# chaining/coalescing: fused-task size per head operator, and the number
# of record batches merged per coalesced flush at a task's input
CHAIN_MEMBERS = "arroyo_chain_members"
COALESCE_BATCHES = "arroyo_worker_coalesce_batches"
# event-loop scheduling lag (obs/profiler.py watchdog)
EVENT_LOOP_LAG = "arroyo_worker_event_loop_lag_seconds"
EVENT_LOOP_STALLS = "arroyo_worker_event_loop_stalls_total"

LABELS = ("job_id", "operator_id", "subtask_idx", "operator_name")

# lag can span ms (steady state) to minutes (recovery backlog)
LAG_BUCKETS = (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
               30.0, 60.0, 300.0, 1800.0)
# per-batch host/device latencies: 100us up to multi-second stalls
LATENCY_BUCKETS = (0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                   0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0)
BYTES_BUCKETS = (1e3, 1e4, 1e5, 1e6, 4e6, 1.6e7, 6.4e7, 2.56e8)
# prometheus_client's Histogram.DEFAULT_BUCKETS
DEFAULT_BUCKETS = (.005, .01, .025, .05, .075, .1, .25, .5, .75, 1.0, 2.5,
                   5.0, 7.5, 10.0, float("inf"))

_BUCKETS = {
    EVENT_TIME_LAG: LAG_BUCKETS,
    WATERMARK_LAG: LAG_BUCKETS,
    BATCH_LATENCY: LATENCY_BUCKETS,
    QUEUE_WAIT: LATENCY_BUCKETS,
    CHECKPOINT_DURATION: LAG_BUCKETS,
    CHECKPOINT_BYTES: BYTES_BUCKETS,
    FRAME_BYTES: BYTES_BUCKETS,
    FLUSH_LATENCY: LATENCY_BUCKETS,
    # batches-per-flush is a small count: 1 = passthrough (no merge)
    COALESCE_BATCHES: (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0,
                       32.0, 64.0),
}


# -- the registry ------------------------------------------------------------


def _go_float(d: float) -> str:
    """A float as the Prometheus exposition writes it (``+Inf``, ``1.0``,
    ``1.6e+07``): prometheus_client's ``floatToGoString``."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


class Sample(NamedTuple):
    name: str
    labels: Dict[str, str]
    value: float


class _CounterChild:
    __slots__ = ("_lock", "value", "created")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0
        self.created = time.time()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by "
                             "non-negative amounts")
        with self._lock:
            self.value += amount


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount


class _HistogramChild:
    __slots__ = ("_lock", "bounds", "counts", "sum", "created")

    def __init__(self, bounds: Tuple[float, ...]):
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0.0] * len(bounds)  # per bucket, not cumulative
        self.sum = 0.0
        self.created = time.time()

    def observe(self, amount: float) -> None:
        amount = float(amount)
        with self._lock:
            self.sum += amount
            for i, b in enumerate(self.bounds):
                if amount <= b:
                    self.counts[i] += 1.0
                    break


class _Family:
    """One labeled metric: its children by label values, in creation
    order."""

    def __init__(self, name: str, help_: str, labelnames: Tuple[str, ...],
                 typ: str, buckets: Optional[Tuple[float, ...]] = None):
        self.typ = typ
        # a counter's family name drops _total; its sample adds it back
        self.name = (name[:-len("_total")]
                     if typ == "counter" and name.endswith("_total")
                     else name)
        self.help = help_
        self.labelnames = tuple(labelnames)
        if buckets is not None:
            bounds = tuple(sorted(float(b) for b in buckets))
            if bounds[-1] != math.inf:
                bounds += (math.inf,)
            self.bounds = bounds
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}

    def labels(self, **labels: Any) -> Any:
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(labels)} are not "
                             f"{list(self.labelnames)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = (_CounterChild() if self.typ == "counter"
                             else _GaugeChild() if self.typ == "gauge"
                             else _HistogramChild(self.bounds))
                    self._children[key] = child
        return child

    def samples(self) -> Iterator[Sample]:
        with self._lock:
            children = list(self._children.items())
        for key, child in children:
            labels = dict(zip(self.labelnames, key))
            if self.typ == "counter":
                yield Sample(self.name + "_total", labels, child.value)
                yield Sample(self.name + "_created", labels, child.created)
            elif self.typ == "gauge":
                yield Sample(self.name, labels, child.value)
            else:
                with child._lock:
                    counts, total = list(child.counts), child.sum
                acc = 0.0
                for b, c in zip(child.bounds, counts):
                    acc += c
                    yield Sample(self.name + "_bucket",
                                 {**labels, "le": _go_float(b)}, acc)
                yield Sample(self.name + "_count", labels, acc)
                yield Sample(self.name + "_sum", labels, total)
                yield Sample(self.name + "_created", labels, child.created)

    def exposition(self) -> str:
        """The family's lines, ``_created`` series as their own gauge
        family after it, as prometheus_client writes format 0.0.4."""
        main_name = self.name + "_total" if self.typ == "counter" \
            else self.name
        main: List[str] = [f"# HELP {main_name} {self.help}",
                           f"# TYPE {main_name} {self.typ}"]
        created: List[str] = []
        for s in self.samples():
            label = ",".join(f'{k}="{_escape(v)}"'
                             for k, v in s.labels.items())
            line = f"{s.name}{{{label}}} {_go_float(s.value)}" if label \
                else f"{s.name} {_go_float(s.value)}"
            (created if s.name.endswith("_created")
             and self.typ != "gauge" else main).append(line)
        out = "\n".join(main) + "\n"
        if self.typ != "gauge" and created:
            cname = self.name + "_created"
            out += (f"# HELP {cname} {self.help}\n# TYPE {cname} gauge\n"
                    + "\n".join(created) + "\n")
        return out


class Registry:
    """The process's metric families, in registration order."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: List[_Family] = []

    def register(self, family: _Family) -> _Family:
        with self._lock:
            self._families.append(family)
        return family

    def collect(self) -> List[_Family]:
        with self._lock:
            return list(self._families)


def Counter(name: str, help_: str, labelnames: Tuple[str, ...],
            registry: Optional[Registry] = None) -> _Family:
    return (registry or REGISTRY).register(
        _Family(name, help_, labelnames, "counter"))


def Gauge(name: str, help_: str, labelnames: Tuple[str, ...],
          registry: Optional[Registry] = None) -> _Family:
    return (registry or REGISTRY).register(
        _Family(name, help_, labelnames, "gauge"))


def Histogram(name: str, help_: str, labelnames: Tuple[str, ...],
              buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
              registry: Optional[Registry] = None) -> _Family:
    return (registry or REGISTRY).register(
        _Family(name, help_, labelnames, "histogram", buckets))


# one registry per process (worker)
REGISTRY = Registry()
_lock = threading.Lock()
# every family a factory below made, by metric name
_families: Dict[str, _Family] = {}


def _family(name: str, help_: str, labelnames: Tuple[str, ...],
            typ: str) -> _Family:
    with _lock:
        fam = _families.get(name)
        if fam is None:
            fam = _families[name] = REGISTRY.register(_Family(
                name, help_, labelnames, typ,
                _BUCKETS.get(name, DEFAULT_BUCKETS)
                if typ == "histogram" else None))
        return fam


def _task_labels(task_info) -> Dict[str, str]:
    return dict(job_id=task_info.job_id, operator_id=task_info.operator_id,
                subtask_idx=str(task_info.task_index),
                operator_name=getattr(task_info, "operator_name",
                                      task_info.operator_id))


def counter_for_task(task_info, name: str, help_: str = "") -> Any:
    """counter_for_task (arroyo-metrics/src/lib.rs:9-21)."""
    return _family(name, help_ or name, LABELS, "counter").labels(
        **_task_labels(task_info))


def gauge_for_task(task_info, name: str, help_: str = "") -> Any:
    """gauge_for_task (arroyo-metrics/src/lib.rs:23-35)."""
    return _family(name, help_ or name, LABELS, "gauge").labels(
        **_task_labels(task_info))


def histogram_for_task(task_info, name: str, help_: str = "") -> Any:
    """Labeled histogram child for one subtask (same label scheme as the
    counters, so rate()/histogram_quantile() queries join on labels)."""
    return _family(name, help_ or name, LABELS, "histogram").labels(
        **_task_labels(task_info))


class TaskMetrics:
    """Per-task instruments every subtask maintains: the reference's six
    flat counters/gauges (arroyo-worker/src/metrics.rs) plus the flight
    recorder's lag/latency/backpressure histograms."""

    def __init__(self, task_info):
        self.messages_recv = counter_for_task(
            task_info, MESSAGES_RECV, "records received by this subtask")
        self.messages_sent = counter_for_task(
            task_info, MESSAGES_SENT, "records sent by this subtask")
        self.bytes_recv = counter_for_task(
            task_info, BYTES_RECV, "serialized bytes received")
        self.bytes_sent = counter_for_task(
            task_info, BYTES_SENT, "serialized bytes sent")
        self.tx_queue_size = gauge_for_task(
            task_info, TX_QUEUE_SIZE, "outbound queue capacity")
        self.tx_queue_rem = gauge_for_task(
            task_info, TX_QUEUE_REM, "outbound queue remaining slots")
        self.event_time_lag = histogram_for_task(
            task_info, EVENT_TIME_LAG,
            "processing-time minus max event time per received batch")
        self.watermark_lag = histogram_for_task(
            task_info, WATERMARK_LAG,
            "processing-time minus the operator's input watermark")
        self.batch_latency = histogram_for_task(
            task_info, BATCH_LATENCY,
            "wall time spent in process_batch per batch")
        self.queue_wait = histogram_for_task(
            task_info, QUEUE_WAIT,
            "time the task loop waited for input per message")
        self.backpressure_time = counter_for_task(
            task_info, BACKPRESSURE_TIME,
            "cumulative seconds blocked sending to full downstream queues")
        self.kernel_time = counter_for_task(
            task_info, KERNEL_TIME,
            "cumulative seconds in device-kernel dispatch for this subtask")
        self.checkpoint_duration = histogram_for_task(
            task_info, CHECKPOINT_DURATION,
            "subtask checkpoint duration (sync phase)")
        self.checkpoint_bytes = histogram_for_task(
            task_info, CHECKPOINT_BYTES,
            "bytes written per subtask checkpoint")
        self.coalesce_batches = histogram_for_task(
            task_info, COALESCE_BATCHES,
            "record batches merged per coalesced flush at this task's "
            "input (1 = passed through unmerged)")


def render_metrics(registry: Optional[Registry] = None) -> bytes:
    """The Prometheus text exposition of ``registry`` (default: the
    process's)."""
    return "".join(f.exposition()
                   for f in (registry or REGISTRY).collect()).encode()


def snapshot(name_prefix: str = "arroyo_worker_") -> Dict[str, float]:
    """In-process scrape: {metric{label=...}: value} for API proxying."""
    out: Dict[str, float] = {}
    for fam in REGISTRY.collect():
        if not fam.name.startswith(name_prefix.rstrip("_")):
            continue
        for s in fam.samples():
            if s.name.endswith("_created"):
                continue
            labels = ",".join(f"{k}={v}" for k, v in sorted(
                s.labels.items()))
            out[f"{s.name}{{{labels}}}"] = s.value
    return out


TABLE_SIZE = "arroyo_worker_table_size_keys"
# the reference's labels plus job_id: without it, same-named operators of
# different jobs sharing a process registry would clobber each other
TABLE_LABELS = ("job_id", "operator_id", "task_id", "table_char")


def _table_labels(task_info, table_char: str) -> Dict[str, str]:
    return dict(job_id=task_info.job_id, operator_id=task_info.operator_id,
                task_id=str(task_info.task_index), table_char=table_char)


def table_size_gauge(task_info, table_char: str) -> Any:
    """Per-table key-count gauge (arroyo-state/src/metrics.rs
    TABLE_SIZE_GAUGE: name + labels match the reference exactly)."""
    return _family(TABLE_SIZE, "Number of keys in the table", TABLE_LABELS,
                   "gauge").labels(**_table_labels(task_info, table_char))


# -- event-loop watchdog instruments (obs/profiler.py) -----------------------


def event_loop_lag_gauge(job_id: str, quantile: str) -> Any:
    """Scheduling-lag gauge child (quantile is 'p50' or 'p99') — how
    late the loop wakes a sleeping coroutine, sampled continuously by
    the profiler's watchdog ticker."""
    return _family(EVENT_LOOP_LAG,
                   "event-loop scheduling lag (watchdog ticker wake delay)",
                   ("job_id", "quantile"), "gauge").labels(
        job_id=job_id or "", quantile=quantile)


def event_loop_stalls_counter(job_id: str) -> Any:
    """Stall episodes past the watchdog threshold."""
    return _family(EVENT_LOOP_STALLS,
                   "event-loop stalls past the watchdog threshold",
                   ("job_id",), "counter").labels(job_id=job_id or "")


# -- process-level counters --------------------------------------------------

# the JAX package's resharding and on-device shuffle counters measure
# device meshes (ROADMAP A.10); no one-device path has them


def _plain_counter(name: str, help_: str, job_id: str = "") -> Any:
    return _family(name, help_, ("job_id",), "counter").labels(
        job_id=job_id)


JOIN_DEVICE_GATHER = "arroyo_worker_join_device_gather_rows"
JOIN_HOST_GATHER = "arroyo_worker_join_host_gather_rows"


def join_gather_counter(path: str, job_id: str = "") -> Any:
    """Join payload rows materialized per gather path: ``device`` =
    through resident payload rings, ``host`` = a host fancy-index."""
    name = JOIN_DEVICE_GATHER if path == "device" else JOIN_HOST_GATHER
    return _plain_counter(
        name, f"join payload rows materialized via the {path} gather",
        job_id)


SESSION_DEVICE_MERGE = "arroyo_worker_session_device_merge_rows"
SESSION_HOST_MERGE = "arroyo_worker_session_host_merge_rows"


def session_merge_counter(path: str, job_id: str = "") -> Any:
    """Session-interval rows merged per path: ``device`` = the
    all-keys union, ``host`` = the per-key merge."""
    name = SESSION_DEVICE_MERGE if path == "device" else SESSION_HOST_MERGE
    return _plain_counter(
        name, f"session interval rows merged via the {path} path",
        job_id)


FACTOR_SHARED_PANES = "arroyo_factor_shared_panes"
FACTOR_DERIVED_WINDOWS = "arroyo_factor_derived_windows"
MESH_CARRIED_SHUFFLES = "arroyo_mesh_carried_shuffles"


def factor_shared_panes_gauge(job_id: str) -> Any:
    """Shared factor-pane operators in the running plan (0 when nothing
    factored or ARROYO_FACTOR_WINDOWS=0)."""
    return _family(FACTOR_SHARED_PANES,
                   "shared factor-pane operators in the running plan",
                   ("job_id",), "gauge").labels(job_id=job_id)


def factor_derived_windows_gauge(job_id: str) -> Any:
    """Derived-window consumers over shared factor panes (0 when nothing
    factored)."""
    return _family(FACTOR_DERIVED_WINDOWS,
                   "derived-window consumers over shared factor panes",
                   ("job_id",), "gauge").labels(job_id=job_id)


def mesh_carried_gauge(job_id: str) -> Any:
    """Chain-interior SHUFFLE edges a device mesh carries: always 0 on
    one device."""
    return _family(MESH_CARRIED_SHUFFLES,
                   "chain-interior shuffle edges carried by the device mesh",
                   ("job_id",), "gauge").labels(job_id=job_id)


# -- two-phase commit instruments (connectors/two_phase.py) ------------------

SINK_COMMITS = "arroyo_worker_sink_commits_total"
SINK_PRECOMMITS_COMMITTED = "arroyo_worker_sink_precommits_committed_total"
SINK_COMMIT_SECONDS = "arroyo_worker_sink_commit_seconds_total"


def sink_commit_counters(task_info) -> Tuple[Any, Any, Any]:
    """A two-phase sink subtask's (epochs committed, pre-commits finalized,
    seconds in the commit phase): a pre-commit is one staged part of the
    filesystem sink, one transaction of the Kafka sink."""
    return (
        counter_for_task(task_info, SINK_COMMITS,
                         "pre-committed epochs this sink finalized"),
        counter_for_task(task_info, SINK_PRECOMMITS_COMMITTED,
                         "pre-commits (staged parts, transactions) "
                         "this sink finalized"),
        counter_for_task(task_info, SINK_COMMIT_SECONDS,
                         "cumulative seconds in the sink's commit phase"))


# -- latency-observatory instruments (obs/latency.py) ------------------------

SINK_E2E_LATENCY = "arroyo_sink_e2e_latency_seconds"
SINK_E2E_QUANTILE = "arroyo_sink_e2e_latency_quantile_seconds"
DEVICE_STATE_BYTES = "arroyo_device_state_bytes"
SLO_VIOLATIONS = "arroyo_slo_violations_total"
SLO_BURN_RATE = "arroyo_slo_burn_rate"

# e2e latency spans sub-ms (hot chained path) to tens of seconds (a
# held watermark on a wide window) — the lag buckets fit
_BUCKETS[SINK_E2E_LATENCY] = LAG_BUCKETS


def sink_latency_histogram(task_info) -> Any:
    """Per-sink end-to-end (emit-minus-ingest) latency of sampled
    records."""
    return histogram_for_task(
        task_info, SINK_E2E_LATENCY,
        "sampled record end-to-end latency (sink emit minus source "
        "ingest wall-clock)")


def sink_latency_quantile_gauge(task_info, quantile: str) -> Any:
    """Rolling-window p50/p99 gauges the observatory refreshes per
    sampled observation."""
    return _family(SINK_E2E_QUANTILE,
                   "rolling-window end-to-end latency quantile per sink",
                   ("job_id", "operator_id", "operator_name", "quantile"),
                   "gauge").labels(
        job_id=task_info.job_id, operator_id=task_info.operator_id,
        operator_name=getattr(task_info, "operator_name",
                              task_info.operator_id),
        quantile=quantile)


def device_state_bytes_gauge(job_id: str, table: str) -> Any:
    """Per-job device-resident state bytes by table."""
    return _family(DEVICE_STATE_BYTES, "device-resident state bytes by table",
                   ("job_id", "table"), "gauge").labels(
        job_id=job_id or "", table=table)


def slo_violations_counter(job_id: str) -> Any:
    """SLO evaluations that found a dimension out of budget."""
    return _family(SLO_VIOLATIONS, "latency-SLO violation evaluations",
                   ("job_id",), "counter").labels(job_id=job_id or "")


def slo_burn_rate_gauge(job_id: str) -> Any:
    """Violating fraction of SLO evaluations over the trailing burn
    window."""
    return _family(SLO_BURN_RATE, "SLO burn rate over the trailing window",
                   ("job_id",), "gauge").labels(job_id=job_id or "")


# -- autoscaler instruments --------------------------------------------------

AUTOSCALER_DECISIONS = "arroyo_autoscaler_decisions_total"
AUTOSCALER_VETOES = "arroyo_autoscaler_vetoes_total"
AUTOSCALER_ACTUATIONS = "arroyo_autoscaler_actuations_total"
AUTOSCALER_PARALLELISM = "arroyo_autoscaler_target_parallelism"

_AUTOSCALER_LABELS = {
    AUTOSCALER_DECISIONS: ("job_id", "action"),
    AUTOSCALER_VETOES: ("job_id", "reason"),
    AUTOSCALER_ACTUATIONS: ("job_id", "direction"),
}
_AUTOSCALER_HELP = {
    AUTOSCALER_DECISIONS: "autoscaler policy evaluations by action",
    AUTOSCALER_VETOES: "autoscaler recommendations blocked, by reason",
    AUTOSCALER_ACTUATIONS: "autoscaler-driven rescales that completed",
}


def autoscaler_counter(name: str, job_id: str, value: str) -> Any:
    """Labeled child of one autoscaler counter family (name must be one
    of the AUTOSCALER_* counter constants)."""
    labels = _AUTOSCALER_LABELS[name]
    return _family(name, _AUTOSCALER_HELP[name], labels, "counter").labels(
        **{labels[0]: job_id, labels[1]: value})


def autoscaler_parallelism_gauge(job_id: str, operator_id: str) -> Any:
    """The parallelism the autoscaler last targeted per operator."""
    return _family(AUTOSCALER_PARALLELISM,
                   "operator parallelism last targeted by the autoscaler",
                   ("job_id", "operator_id"), "gauge").labels(
        job_id=job_id, operator_id=operator_id)


CHECKPOINT_TABLE_SECONDS = "arroyo_worker_checkpoint_table_seconds"
CHECKPOINT_TABLE_BYTES = "arroyo_worker_checkpoint_table_bytes"


def checkpoint_table_gauge(task_info, table_char: str, which: str) -> Any:
    """Per-table checkpoint cost gauges: ``which`` is 'seconds' or
    'bytes'."""
    name = (CHECKPOINT_TABLE_SECONDS if which == "seconds"
            else CHECKPOINT_TABLE_BYTES)
    return _family(name, f"last checkpoint {which} for the table",
                   TABLE_LABELS, "gauge").labels(
        **_table_labels(task_info, table_char))


# -- heartbeat-sized rollups -------------------------------------------------

_SUMMARY_SKIP_SUFFIXES = ("_bucket", "_created")
_PER_SUBTASK_FAMS = ("event_time_lag_seconds", "watermark_lag_seconds",
                     "batch_processing_seconds", "queue_wait_seconds",
                     "tx_queue_size", "tx_queue_rem")


def job_operator_summary(job_id: str) -> Dict[str, Dict[str, float]]:
    """Compact per-operator rollup of this process's registry for one
    job, with the profiler's ``phase_seconds.<phase>`` /
    ``wait_seconds.<phase>`` and the latency observatory's keys riding
    along when they are armed; worker-level families land under the
    pseudo-operator ``__worker__``."""
    out: Dict[str, Dict[str, float]] = {}
    prefix = "arroyo_worker_"
    for fam in REGISTRY.collect():
        if not fam.name.startswith(prefix.rstrip("_")):
            continue
        for s in fam.samples():
            if s.name.endswith(_SUMMARY_SKIP_SUFFIXES):
                continue
            if s.labels.get("job_id") != job_id:
                continue
            op = s.labels.get("operator_id", "") or "__worker__"
            key = s.name[len(prefix):] if s.name.startswith(prefix) else s.name
            q = s.labels.get("quantile")
            if q:
                key = f"{key}_{q}"
            g = out.setdefault(op, {})
            g[key] = g.get(key, 0.0) + s.value
            sub = s.labels.get("subtask_idx")
            if sub is not None and key.startswith(_PER_SUBTASK_FAMS):
                sk = f"{key}@{sub}"
                g[sk] = g.get(sk, 0.0) + s.value
    from . import profiler as _profiler

    prof = _profiler.active()
    if prof is not None and (not prof.job_id or prof.job_id == job_id):
        for (op, phase), secs in prof.work_snapshot().items():
            out.setdefault(op, {})[f"phase_seconds.{phase}"] = round(secs, 6)
        for (op, phase), secs in prof.wait_snapshot().items():
            out.setdefault(op, {})[f"wait_seconds.{phase}"] = round(secs, 6)
    from . import latency as _latency

    for op, keys in _latency.summary_ride_alongs(job_id).items():
        out.setdefault(op, {}).update(keys)
    return out
