"""Metrics, span tracing and structured logging (obs/metrics.py,
obs/tracing.py, obs/logging_setup.py) against the JAX package's: the same
q5 program gives the same metric names, label sets and per-subtask record
counters in both registries (the port's exposition parsed by
``prometheus_client``'s parser, which the port itself never imports), the
same span names, and the same logfmt JSON lines field by field."""

import json
import logging
import sys

import pytest
from prometheus_client.parser import text_string_to_metric_families

import bench
from arroyo_tpu.config import reset_config as jax_reset_config
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.obs import logging_setup as jax_logging
from arroyo_tpu.obs import metrics as jax_metrics
from arroyo_tpu.obs import tracing as jax_tracing
from arroyo_tpu.sql import plan_sql as jax_plan_sql
from arroyo_tpu_torch.config import reset_config
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.obs import logging_setup, metrics, tracing
from arroyo_tpu_torch.sql import plan_sql

JOB = "obs-q5"
RECORDS = ("arroyo_worker_messages_recv_total",
           "arroyo_worker_messages_sent_total")


def q5_sql(n=200_000, b=16_384):
    return bench.Q5.format(n=n, b=b).replace(
        f"batch_size = '{b}'", f"batch_size = '{b}', base_time_micros = '0'")


@pytest.fixture(scope="module")
def runs():
    """One q5 run in each package (one device's state on the JAX side,
    no coalescing linger), traced from an empty span ring: (JAX
    exposition, port exposition, JAX span names, port span names)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("COALESCE_LINGER_MICROS", "0")
    mp.setenv("ARROYO_MESH", "off")
    reset_config(), jax_reset_config()
    try:
        jax_tracing.reset()
        JaxLocalRunner(jax_plan_sql(q5_sql()), job_id=JOB).run()
        jax_spans = {s[0] for s in jax_tracing.spans()}
        tracing.reset()
        clear_sink("results")
        LocalRunner(plan_sql(q5_sql()), job_id=JOB, device="cpu").run()
        assert sink_output("results")
        spans = {s[0] for s in tracing.spans()}
    finally:
        mp.undo()
        reset_config(), jax_reset_config()
    return (jax_metrics.render_metrics().decode(),
            metrics.render_metrics().decode(), jax_spans, spans)


def _samples(text):
    """{(sample name, sorted labels): value} of this job's samples."""
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.labels.get("job_id") == JOB:
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def test_metric_names_and_labels_match_jax(runs):
    jax_text, text, _, _ = runs
    want, got = _samples(jax_text), _samples(text)
    assert got and set(got) == set(want)
    names = {n for n, _ in got}
    assert {"arroyo_worker_batch_processing_seconds_bucket",
            "arroyo_worker_kernel_seconds_total", "arroyo_chain_members",
            "arroyo_factor_shared_panes"} <= names
    for (name, labels), _v in got.items():
        keys = {k for k, _ in labels}
        if name.startswith("arroyo_worker_messages"):
            assert keys == {"job_id", "operator_id", "subtask_idx",
                            "operator_name"}


def test_record_counters_match_jax(runs):
    jax_text, text, _, _ = runs
    want, got = _samples(jax_text), _samples(text)
    recs = {k: v for k, v in got.items() if k[0] in RECORDS}
    assert recs and max(recs.values()) > 0
    assert recs == {k: v for k, v in want.items() if k[0] in RECORDS}


def test_exposition_round_trips_through_the_reference_parser():
    """Escaped label values, a counter named ``*_total``, histogram
    buckets and an empty family parse back as prometheus_client writes
    them."""
    reg = metrics.Registry()
    c = metrics.Counter("x_bytes_total", "a counter", ("job_id", "v"),
                        registry=reg)
    c.labels(job_id="j", v='a"b\\c\nd').inc(3)
    h = metrics.Histogram("x_seconds", "h", ("job_id",),
                          buckets=(0.5, 1.6e7), registry=reg)
    h.labels(job_id="j").observe(0.25)
    h.labels(job_id="j").observe(2.0)
    metrics.Gauge("x_empty", "no children", ("job_id",), registry=reg)
    fams = {f.name: f for f in text_string_to_metric_families(
        metrics.render_metrics(reg).decode())}
    (total,) = fams["x_bytes"].samples
    assert total.name == "x_bytes_total" and total.value == 3.0
    assert total.labels["v"] == 'a"b\\c\nd'
    # the _created series is its own gauge family, as prometheus_client
    # writes it
    assert fams["x_bytes_created"].type == "gauge"
    hs = {(s.name, s.labels.get("le")): s.value
          for s in fams["x_seconds"].samples}
    assert hs[("x_seconds_bucket", "0.5")] == 1.0
    assert hs[("x_seconds_bucket", "1.6e+07")] == 2.0
    assert hs[("x_seconds_bucket", "+Inf")] == 2.0
    assert hs[("x_seconds_count", None)] == 2.0
    assert hs[("x_seconds_sum", None)] == 2.25
    assert fams["x_empty"].samples == []
    with pytest.raises(ValueError):
        c.labels(job_id="j", v="x").inc(-1)


def test_snapshot_and_summary_read_the_registry(runs):
    snap = metrics.snapshot()
    assert any(k.startswith("arroyo_worker_messages_recv_total{")
               and f"job_id={JOB}" in k for k in snap)
    summary = metrics.job_operator_summary(JOB)
    assert all(v.get("messages_sent_total", 0) >= 0
               for v in summary.values())
    assert sum(v.get("messages_recv_total", 0)
               for v in summary.values()) > 0


def test_span_names_match_jax(runs):
    _, _, jax_spans, spans = runs
    assert spans == jax_spans
    assert {"task.run", "window.fire", "watermark.emit"} <= spans
    trace = tracing.chrome_trace()
    assert any(e["ph"] == "X" and e["name"] == "task.run"
               for e in trace["traceEvents"])
    assert any(e["ph"] == "M" for e in trace["traceEvents"])


def _record(exc=False):
    rec = logging.LogRecord("arroyo.worker", logging.WARNING, __file__, 1,
                            "barrier %s aligned", (7,), None)
    rec.created, rec.msecs = 1_700_000_000.25, 250.0
    rec.job_id, rec.operator_id, rec.subtask_idx = JOB, "op-3", 1
    if exc:
        try:
            raise ValueError("boom")
        except ValueError:
            rec.exc_info = sys.exc_info()
    return rec


@pytest.mark.parametrize("exc", [False, True])
def test_logfmt_lines_match_jax(exc):
    got = json.loads(logging_setup.LogfmtJsonFormatter().format(_record(exc)))
    want = json.loads(jax_logging.LogfmtJsonFormatter().format(_record(exc)))
    assert list(got) == list(want)
    for k in got:
        assert got[k] == want[k], k
    assert ("exception" in got) == exc


def test_init_logging_installs_the_json_handler(monkeypatch):
    monkeypatch.setenv("LOG_JSON", "true")
    root = logging.getLogger()
    handlers, level, hook = list(root.handlers), root.level, sys.excepthook
    try:
        logging_setup.init_logging("worker", "debug")
        (h,) = root.handlers
        assert isinstance(h.formatter, logging_setup.LogfmtJsonFormatter)
        assert root.level == logging.DEBUG
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in handlers:
            root.addHandler(h)
        root.setLevel(level)
        sys.excepthook = hook
