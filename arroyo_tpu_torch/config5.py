"""config5: session-window aggregation with a median UDAF over the Kafka
source (bench.py's ``CONFIG5_SQL``) as a Stream-API program.

The JAX package plans config5 from SQL; until the port has its SQL
planner, ``config5_program`` builds by hand the node sequence that
``arroyo_tpu.sql.plan_sql(CONFIG5_SQL)`` produces with ``median``
registered as a UDAF:

  kafka source (memory://<broker>, topic sess, json)
  -> ev_virtual (event_time = from_unixtime(ts) = ts // 1000)
  -> ev_event_time (the row timestamp := event_time)
  -> watermark (1 s lateness) -> agg input (k, __ain0 = v) -> key_by(k)
  -> session(1 s) window: median(__ain0) -> __agg0, COUNT(*) -> __agg1
  -> agg projection (k, med, cnt, window_start, window_end) -> sink

Every operator keeps the planner's name and emits the planner's columns,
so the rows are comparable one for one."""

from __future__ import annotations

import json

import numpy as np

from .connectors.kafka import InMemoryKafkaBroker
from .graph.logical import AggKind, AggSpec, Program, SessionWindow, Stream

GAP_MICROS = 1_000_000  # session(INTERVAL '1' SECOND)
LATENESS_MICROS = 1_000_000
TOPIC = "sess"
KEYS_PER_BLOCK, BURST = 64, 100  # bench.py's producer


def config5_events(n: int, t0_micros: int, spacing_micros: int):
    """(k, v, ts) of bench.py's producer: 64 keys active per block of
    6,400 events, each key bursting 100 times, then retiring — so 1 s gap
    sessions close continuously as event time advances.  ``ts`` is in
    the nanoseconds that ``from_unixtime`` takes."""
    i = np.arange(n, dtype=np.int64)
    keys = (i % KEYS_PER_BLOCK) + (i // (KEYS_PER_BLOCK * BURST)) \
        * KEYS_PER_BLOCK
    ts = (t0_micros + i * spacing_micros) * 1000
    vals = (i % 997).astype(np.float64) / 7.0
    return keys, vals, ts


def config5_produce(broker: str, n: int, t0_micros: int,
                    spacing_micros: int) -> None:
    """Refill the in-process topic ``sess`` of ``broker`` with ``n``
    JSON events, the payloads bench.py's ``_config5_produce`` writes."""
    InMemoryKafkaBroker.reset(broker)
    b = InMemoryKafkaBroker.get(broker)
    b.create_topic(TOPIC, partitions=1)
    keys, vals, ts = config5_events(n, t0_micros, spacing_micros)
    for k, v, t in zip(keys.tolist(), vals.tolist(), ts.tolist()):
        b.produce(TOPIC, json.dumps({"k": k, "v": v, "ts": t}).encode(),
                  partition=0)


def _ev_virtual(c):
    # the generated column: CAST(from_unixtime(ts) AS TIMESTAMP), ns -> us
    return {"event_time": np.asarray(c["ts"]) // 1000, "k": c["k"],
            "v": c["v"], "ts": c["ts"]}


def _set_ts(c):
    out = dict(c)
    out["__timestamp"] = np.asarray(c["event_time"], dtype=np.int64)
    return out


def config5_program(num_events: int, batch_size: int, sink: str = "results",
                    broker: str = "bench5") -> Program:
    """config5 over the first ``num_events`` events of ``broker``'s
    topic, read in batches of ``batch_size``, writing (k, med, cnt,
    window_start, window_end) rows to the memory sink named ``sink``."""
    src = Stream.source("kafka", {
        "bootstrap_servers": f"memory://{broker}", "topic": TOPIC,
        "format": "json", "batch_size": batch_size,
        "max_messages": num_events}, name="ev_source")
    return (src.udf(_ev_virtual, name="ev_virtual")
            .udf(_set_ts, name="ev_event_time")
            .watermark(max_lateness_micros=LATENESS_MICROS,
                       name="ev_watermark")
            .map(lambda c: {"k": c["k"], "__ain0": c["v"]},
                 name="agg_input_1")
            .key_by("k")
            .window(SessionWindow(GAP_MICROS),
                    [AggSpec(AggKind.UDAF, "__ain0", "__agg0", fn=np.median),
                     AggSpec(AggKind.COUNT, None, "__agg1")])
            .map(lambda c: {"k": c["k"], "med": c["__agg0"],
                            "cnt": c["__agg1"],
                            "window_start": c["window_start"],
                            "window_end": c["window_end"]},
                 name="agg_project_2")
            .sink("memory", {"name": sink}))
