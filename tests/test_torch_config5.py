"""config5 (session windows + median UDAF over the Kafka source, 1 s
checkpoints) through the port against the JAX package: bench.py's
``CONFIG5_SQL`` planned and run by the JAX engine, ``config5_program`` by
the port's engine on the CPU, each from its own package's in-process
broker filled with the same payloads.  Plus the port's checkpoint ->
stop -> restore run, its JSON decode and its Kafka source alone."""

import asyncio
import json

import numpy as np
import pytest

import bench
from arroyo_tpu.connectors.kafka import InMemoryKafkaBroker as JaxBroker
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.formats import JsonFormat as JaxJsonFormat
from arroyo_tpu.formats import batch_from_rows as jax_batch_from_rows
from arroyo_tpu.sql import SchemaProvider, plan_sql
from arroyo_tpu.sql.functions import unregister_udfs
from arroyo_tpu_torch.config5 import (config5_events, config5_produce,
                                      config5_program)
from arroyo_tpu_torch.connectors.kafka import InMemoryKafkaBroker, KafkaConfig
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
from arroyo_tpu_torch.formats import JsonFormat
from arroyo_tpu_torch.graph.logical import Stream
from arroyo_tpu_torch.obs import perf
from arroyo_tpu_torch.state.backend import InMemoryBackend

N, BATCH = 200_000, 4_096
COLS = ("k", "med", "cnt", "window_start", "window_end")


def _rows(batches):
    """Sorted (timestamp, k, med, cnt, window_start, window_end) rows."""
    rows = []
    for b in batches:
        cols = [b.columns[c].tolist() for c in COLS]
        rows.extend(zip(b.timestamp.tolist(), *cols))
    return sorted(rows)


def _jax_rows(n, spacing):
    unregister_udfs()  # median is registered process-wide
    try:
        p = SchemaProvider()
        p.register_udaf("median", np.median)
        prog = plan_sql(bench.CONFIG5_SQL.format(b=BATCH, n=n), p)
    finally:
        unregister_udfs()
    bench._config5_produce("bench5", n, 0, spacing)
    jax_clear_sink("results")
    JaxLocalRunner(prog).run(checkpoint_interval_secs=1.0)
    outs = jax_sink_output("results")
    assert outs and list(outs[0].columns) == list(COLS)
    return _rows(outs)


def _port_rows(n, spacing, sink, broker):
    config5_produce(broker, n, 0, spacing)
    clear_sink(sink)
    LocalRunner(config5_program(n, BATCH, sink, broker=broker),
                device="cpu").run(checkpoint_interval_secs=1.0)
    outs = sink_output(sink)
    assert outs and list(outs[0].columns) == list(COLS)
    for b in outs:  # the JAX engine's column types
        assert [b.columns[c].dtype for c in COLS] == [
            np.int64, np.float64, np.int64, np.int64, np.int64]
    return _rows(outs)


@pytest.mark.parametrize("spacing", [10, 100])
def test_config5_port_matches_jax_sql_plan(spacing):
    """200k events at bench.py's 10 us spacing (2 s of event time: every
    session fires at the final flush) and at 100 us (20 s: sessions fire
    mid-stream): exactly the JAX engine's rows, 2,048 sessions."""
    want = _jax_rows(N, spacing)
    perf.reset()
    got = _port_rows(N, spacing, f"c5-port-{spacing}", f"c5-{spacing}")
    assert len(want) == 2048 and got == want
    assert perf.counter("session_merge_dispatches") > 0
    assert perf.counter("session_host_merge_rows") == 0


def test_config5_port_rows_equal_a_numpy_control():
    """One session per key (each key lives in one burst block): start =
    first event, end = last event + 1 s, the count and the median."""
    n, spacing = 40_000, 10
    got = _port_rows(n, spacing, "c5-ctl", "c5-ctl")
    i = np.arange(n)
    keys = (i % 64) + (i // 6400) * 64
    t = i * spacing
    v = (i % 997) / 7.0
    want = []
    for k in np.unique(keys):
        sel = keys == k
        end = int(t[sel].max()) + 1_000_000
        want.append((end - 1, int(k), float(np.median(v[sel])),
                     int(sel.sum()), int(t[sel].min()), end))
    assert got == sorted(want)


def test_config5_checkpoint_stop_restore_is_exactly_once():
    """A run checkpointed mid-stream into InMemoryBackend, stopped, and
    restored from that epoch emits exactly the rows of an uninterrupted
    run: no Kafka offset is lost or read twice.  100 us spacing, so
    sessions fire before and after the barrier."""
    spacing = 100
    reference = _port_rows(N, spacing, "c5-ref", "c5-ref")
    config5_produce("c5-rt", N, 0, spacing)
    clear_sink("c5-rt")
    program = config5_program(N, BATCH, "c5-rt", broker="c5-rt")
    src_id = next(n.operator_id for n in program.nodes()
                  if "source" in n.operator_id)

    async def phase1():
        engine = Engine(program, "c5-rt", InMemoryBackend(), device="cpu")
        running = engine.start()
        store = engine.subtasks[(src_id, 0)].runner.ctx.state

        def offset():  # the source's last-read offset, table 's'
            table = store.tables.get("s")
            return -1 if table is None else (table.get(0) or -1)

        while offset() < N // 2:
            await asyncio.sleep(0)
        await running.checkpoint(1, then_stop=True)
        assert await running.wait_for_checkpoint(1, timeout=60)
        await running.join()
        return offset()

    stopped_at = asyncio.run(phase1())
    emitted_before = len(_rows(sink_output("c5-rt")))
    assert N // 2 <= stopped_at < N - 1
    assert 0 < emitted_before < len(reference)
    # the epoch holds the live session runs as KEYED entries, one
    # session per key; the keys that fired before the barrier are gone
    window = next(tables["v"] for (job, ep, op, _i), (tables, _wm)
                  in InMemoryBackend._store.items()
                  if job == "c5-rt" and ep == 1 and "window" in op)
    assert window.entries and all(len(v) == 1 for _t, _k, v in window.entries)
    assert len(window.entries) + emitted_before <= len(reference)

    async def phase2():
        engine = Engine(program, "c5-rt", InMemoryBackend(),
                        restore_epoch=1, device="cpu")
        await engine.start().join()

    asyncio.run(phase2())
    assert _rows(sink_output("c5-rt")) == reference


def test_json_bulk_decode_matches_jax_row_path():
    """The port's bulk JSON decode gives the JAX package's row path
    column for column: ints, floats, nulls, bools and digit strings."""
    payloads = [b'{"k": 1, "v": 0.5, "s": "007", "b": true}',
                b'{"k": 2, "v": null, "s": "x", "b": false}',
                b'{"k": 3, "s": null}', b'[{"k": 4, "v": 2}]', b'17']
    got = JsonFormat().batch(payloads)
    ref = jax_batch_from_rows(JaxJsonFormat().deserialize(payloads))
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) == 5
    for c in ref.columns:
        assert got.columns[c].dtype == ref.columns[c].dtype, c
        assert got.columns[c].tolist() == ref.columns[c].tolist() or (
            ref.columns[c].dtype.kind == "f" and np.array_equal(
                got.columns[c], ref.columns[c], equal_nan=True)), c


def test_json_decode_matches_jax_batch_route_on_config5_payloads():
    """On config5's payloads the port's bulk decode gives the columns and
    dtypes of the JAX package's own ``JsonFormat.batch`` (its pyarrow
    route where pyarrow is installed, the bulk route elsewhere)."""
    keys, vals, ts = config5_events(3000, 0, 10)
    payloads = [json.dumps({"k": k, "v": v, "ts": t}).encode()
                for k, v, t in zip(keys.tolist(), vals.tolist(),
                                   ts.tolist())]
    got = JsonFormat().batch(payloads)
    ref = JaxJsonFormat().batch(payloads)
    assert list(got.columns) == list(ref.columns) == ["k", "v", "ts"]
    for c in ref.columns:
        assert got.columns[c].dtype == ref.columns[c].dtype, c
        np.testing.assert_array_equal(got.columns[c], ref.columns[c])


def test_kafka_source_reads_each_offset_once_and_validates_config(
        monkeypatch):
    """The source reads the topic in batches of batch_size, stops at
    max_messages, and a bad config raises at build time.  The sink's
    batches are the source's with input coalescing off; with it on (the
    default) they may merge, and carry the same rows in order."""
    InMemoryKafkaBroker.reset("kt")
    b = InMemoryKafkaBroker.get("kt")
    for i in range(1000):
        b.produce("t", f'{{"i": {i}}}'.encode(), partition=0)
    jb = JaxBroker.get("kt")
    assert jb is not b  # the two packages keep separate brokers
    for coalesce in ("0", "1"):
        monkeypatch.setenv("ARROYO_COALESCE", coalesce)
        clear_sink("kt-out")
        prog = (Stream.source("kafka", {"bootstrap_servers": "memory://kt",
                                        "topic": "t", "batch_size": 300,
                                        "max_messages": 1000})
                .sink("memory", {"name": "kt-out"}))
        LocalRunner(prog, device="cpu").run()
        outs = sink_output("kt-out")
        if coalesce == "0":
            assert [len(o) for o in outs] == [300, 300, 300, 100]
        assert np.concatenate([o.columns["i"] for o in outs]).tolist() == \
            list(range(1000))
    with pytest.raises(ValueError, match="offset"):
        KafkaConfig(bootstrap_servers="memory://kt", topic="t",
                    offset="middle")
    with pytest.raises(TypeError):
        Stream.source("kafka", {"topic": "t"})
    with pytest.raises(RuntimeError, match="memory://"):
        LocalRunner(Stream.source("kafka", {
            "bootstrap_servers": "localhost:9092", "topic": "t",
            "max_messages": 1}).sink("memory", {"name": "kt-x"}),
            device="cpu").run()
