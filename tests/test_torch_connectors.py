"""The port's exactly-once sinks and file connectors against arroyo_tpu's,
on the CPU: the same seeded batches through both packages' pipelines.

* the two-phase commit (connectors/two_phase.py): nothing is visible
  before its commit, a commit finalizes its epoch and the ones before it
  and no later one, each sealed epoch's ``committing_data`` is the JAX
  package's, the sink's commit counters count what it committed,
  ``RunningEngine.commit`` reaches every two-phase sink, a
  ``then_stop`` checkpoint commits before its sink closes;
* the filesystem sink: JSON and Parquet part files byte for byte the JAX
  package's, staged under ``.staging/`` and promoted at the commit;
* the transactional Kafka sink under ``read_committed`` (the port's own
  in-process broker, the JAX package's its own);
* single_file: the source's resume through the lines read, the sink's
  truncate on restore, the fast decode path's pinned semantics;
* the preview sink's ``SendSinkData`` requests;
* SQL sink DDL (filesystem, single_file, preview, kafka) planned as the
  JAX planner plans it;
* config5 (20,000 events) into the filesystem sink, cut after its third
  epoch sealed and before that epoch's commit, restored: every row once,
  the JAX package's rows; a ``cuda`` twin on the card."""

import asyncio
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from arroyo_tpu import Stream as JaxStream
from arroyo_tpu.connectors.kafka import InMemoryKafkaBroker as JaxBroker
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import Engine as JaxEngine
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.formats import batch_to_rows as jax_batch_to_rows
from arroyo_tpu.sql import plan_sql as jax_plan_sql
from arroyo_tpu.sql.functions import register_udaf as jax_register_udaf
from arroyo_tpu.sql.functions import unregister_udfs as jax_unregister_udfs
from arroyo_tpu.state.backend import InMemoryBackend as JaxInMemoryBackend
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu.types import StopMode as JaxStopMode
from arroyo_tpu_torch.config5 import config5_events, config5_sql
from arroyo_tpu_torch.connectors.kafka import InMemoryKafkaBroker
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.drills import cut_before_commit, hold_sources
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
from arroyo_tpu_torch.graph.logical import OpKind, Stream
from arroyo_tpu_torch.obs.metrics import job_operator_summary
from arroyo_tpu_torch.sql import plan_sql, register_udaf, unregister_udfs
from arroyo_tpu_torch.state.backend import InMemoryBackend
from arroyo_tpu_torch.types import Batch, StopMode

JAX = SimpleNamespace(
    name="jax", Stream=JaxStream, Batch=JaxBatch, Broker=JaxBroker,
    StopMode=JaxStopMode, plan_sql=jax_plan_sql,
    sink_output=jax_sink_output, clear_sink=jax_clear_sink,
    engine=lambda prog, job, restore=None: JaxEngine(
        prog, job, backend=JaxInMemoryBackend(), restore_epoch=restore),
    runner=lambda prog: JaxLocalRunner(prog))
PORT = SimpleNamespace(
    name="port", Stream=Stream, Batch=Batch, Broker=InMemoryKafkaBroker,
    StopMode=StopMode, plan_sql=plan_sql,
    sink_output=sink_output, clear_sink=clear_sink,
    engine=lambda prog, job, restore=None: Engine(
        prog, job, InMemoryBackend(), restore, "cpu"),
    runner=lambda prog: LocalRunner(prog, device="cpu"))
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _one_device(monkeypatch):
    # the JAX side on one device's state (conftest's 8 CPU devices would
    # give it the mesh state)
    monkeypatch.setenv("ARROYO_MESH", "off")


def _batches(pkg, n_batches=6, rows=50, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(rng.integers(0, 1_000_000, rows)).astype(np.int64) \
            + b * 1_000_000
        v = rng.normal(size=rows)
        v[rng.random(rows) < 0.1] = np.nan
        out.append(pkg.Batch(ts, {
            "k": rng.integers(0, 1_000, rows).astype(np.int64), "v": v,
            "s": np.array([f"s{x}é" for x in rng.integers(0, 99, rows)],
                          dtype=object),
            "ok": rng.random(rows) < 0.5}))
    return out


def _files(root):
    """relative path -> bytes of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            full = os.path.join(dirpath, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


def _listing(root):
    """(final parts, staged parts) under ``root``."""
    names = sorted(_files(root)) if os.path.isdir(root) else []
    return ([n for n in names if not n.startswith(".staging")],
            [n for n in names if n.startswith(".staging")])


def _json_rows(root):
    rows = []
    for name, data in sorted(_files(root).items()):
        if not name.startswith(".staging"):
            rows += [json.loads(line) for line in data.splitlines()]
    return rows


async def _until(cond, timeout=10.0):
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not cond():
        assert loop.time() < end, "timed out"
        await asyncio.sleep(0.005)


def _fs_program(pkg, root, fmt="json", rows_per_file=1_000_000,
                parallelism=None, batches=None):
    src = pkg.Stream.source("memory", {"batches": batches or _batches(pkg)})
    return src.sink("filesystem", {"path": f"file://{root}", "format": fmt,
                                   "rows_per_file": rows_per_file},
                    parallelism=parallelism)


# -- the filesystem sink ---------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["json", "parquet"])
def test_filesystem_parts_byte_equal_to_jax(fmt, tmp_path):
    """A run without checkpoints: parts rolled at ``rows_per_file`` and
    the remainder at close, name for name and byte for byte."""
    got = {}
    for pkg in BOTH:
        root = tmp_path / pkg.name
        pkg.runner(_fs_program(pkg, root, fmt, rows_per_file=70)).run()
        got[pkg.name] = _files(root)
    assert got["port"] == got["jax"]
    assert sorted(got["port"]) == [f"part-0000-{i:06d}.{fmt}"
                                   for i in range(5)]
    if fmt == "json":
        want = [json.loads(json.dumps(r)) for b in _batches(JAX)
                for r in jax_batch_to_rows(b)]
        assert _json_rows(tmp_path / "port") == want


def _epochs_in_turn(pkg, root, job="fs"):
    """Epochs 1 and 2 sealed, commit 1, commit 2, epoch 3 sealed and
    committed, the end: the (final, staged) listing after each step, and
    the ``committing_data`` of each sealed epoch's checkpoint metadata."""
    steps, committing = [], []

    async def run():
        engine = pkg.engine(_fs_program(pkg, root), f"{job}-{pkg.name}")
        running = engine.start()
        held = hold_sources(engine, (2, 4, 6))

        async def seal(epoch):
            await held[epoch - 1].wait()
            await running.checkpoint(epoch)
            assert await running.wait_for_checkpoint(epoch)
            steps.append(_listing(root))
            committing.append(sorted(
                (r.task_index, r.subtask_metadata.committing_data)
                for r in engine.resps if r.kind == "checkpoint_completed"
                and r.subtask_metadata.epoch == epoch
                and r.subtask_metadata.committing_data))

        async def commit(epoch):
            await running.commit(epoch)
            part = f"part-0000-{epoch - 1:06d}.json"
            await _until(lambda: part in _listing(root)[0])
            steps.append(_listing(root))

        await seal(1)
        await seal(2)
        await commit(1)
        await commit(2)
        await seal(3)
        await commit(3)
        await running.join()
        steps.append(_listing(root))

    asyncio.run(run())
    return steps, committing


def test_two_phase_visibility_and_epoch_isolation(tmp_path):
    """Nothing is visible before its commit; commit 1 promotes epoch 1's
    part and leaves epoch 2's staged; in both packages alike."""
    got = {pkg.name: _epochs_in_turn(pkg, str(tmp_path / pkg.name))[0]
           for pkg in BOTH}
    assert got["port"] == got["jax"]
    p = [f"part-0000-{i:06d}.json" for i in range(3)]
    s = [f".staging/{n}" for n in p]
    assert got["port"] == [([], s[:1]), ([], s[:2]), (p[:1], s[1:2]),
                           (p[:2], []), (p[:2], s[2:]), (p, []), (p, [])]
    assert _json_rows(tmp_path / "port") == _json_rows(tmp_path / "jax")


def test_committing_data_and_commit_counters(tmp_path):
    """Each sealed epoch's metadata carries the sink's pre-commit table
    (``WriteBehavior.COMMIT_WRITES``) as the JAX package's does: every
    epoch not yet committed, by epoch.  The port's commit counters count
    the three epochs and their three parts."""
    got = {pkg.name: _epochs_in_turn(pkg, str(tmp_path / pkg.name),
                                     "meta")[1] for pkg in BOTH}
    assert got["port"] == got["jax"]
    pc = {e: {f"part-0000-{e - 1:06d}.json": {
        "staged": f".staging/part-0000-{e - 1:06d}.json",
        "final": f"part-0000-{e - 1:06d}.json"}} for e in (1, 2, 3)}
    assert got["port"] == [[(0, {"p": {1: pc[1]}})],
                           [(0, {"p": {1: pc[1], 2: pc[2]}})],
                           [(0, {"p": {3: pc[3]}})]]
    (sink,) = [v for v in job_operator_summary("meta-port").values()
               if "sink_commits_total" in v]
    assert sink["sink_commits_total"] == 3
    assert sink["sink_precommits_committed_total"] == 3
    assert sink["sink_commit_seconds_total"] > 0


def test_then_stop_commits_before_close(tmp_path):
    """A ``then_stop`` barrier seals the sink's last parts; the sink
    waits for their commit before it closes, then the run ends."""
    got = {}
    for pkg in BOTH:
        root = str(tmp_path / pkg.name)

        async def run(pkg=pkg, root=root):
            engine = pkg.engine(_fs_program(pkg, root), f"ts-{pkg.name}")
            running = engine.start()
            (held,) = hold_sources(engine, (3,))
            await held.wait()
            await running.checkpoint(1, then_stop=True)
            assert await running.wait_for_checkpoint(1)
            await asyncio.sleep(0.05)
            before = _listing(root)
            sinks = [h.task for (op, _), h in engine.subtasks.items()
                     if not h.is_source]
            assert not any(t.done() for t in sinks)
            await running.commit(1)
            await running.join()
            return before, _listing(root)

        got[pkg.name] = asyncio.run(run())
    assert got["port"] == got["jax"] == (
        ([], [".staging/part-0000-000000.json"]),
        (["part-0000-000000.json"], []))


def test_commit_reaches_every_two_phase_sink(tmp_path):
    """Two filesystem sink subtasks and a Kafka sink behind one source:
    one ``RunningEngine.commit`` finalizes all three."""
    for pkg in BOTH:
        root = str(tmp_path / pkg.name)
        pkg.Broker.reset("commit-all")

        async def run(pkg=pkg, root=root):
            src = pkg.Stream.source("memory", {"batches": _batches(pkg)})
            src.sink("filesystem", {"path": f"file://{root}"},
                     parallelism=2)
            src.sink("kafka", {"bootstrap_servers": "memory://commit-all",
                               "topic": "out"})
            engine = pkg.engine(src.program, f"all-{pkg.name}")
            running = engine.start()
            held = hold_sources(engine, (4, 6))
            broker = pkg.Broker.get("commit-all")
            parts = ["part-0000-000000.json", "part-0001-000000.json"]
            for epoch in (1, 2):
                await held[epoch - 1].wait()
                await running.checkpoint(epoch)
                assert await running.wait_for_checkpoint(epoch)
                if epoch == 1:
                    assert _listing(root)[0] == []
                    assert broker.fetch("out", 0, 0, 10_000) == []
                await running.commit(epoch)
                await _until(lambda: set(parts) <= set(_listing(root)[0]))
                await _until(lambda e=epoch: len(broker.fetch(
                    "out", 0, 0, 10_000)) == {1: 200, 2: 300}[e])
                if epoch == 1:
                    assert _listing(root) == (parts, [])
                parts = [p.replace("00000.", "00001.") for p in parts]
            await running.join()
            assert _listing(root)[1] == []

        asyncio.run(run())
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


# -- the transactional Kafka sink ------------------------------------------------------


@pytest.mark.parametrize("fmt", ["json", "avro", "debezium_json", "raw"])
def test_kafka_sink_is_transactional_under_read_committed(fmt):
    """Rows of an epoch reach ``read_committed`` readers at its commit
    and not before; the payloads are the JAX package's bytes, and a
    ``read_committed`` Kafka source reads back every row once."""
    schema = {"type": "record", "name": "r", "fields": [
        {"name": n, "type": ["null", t]} for n, t in
        (("k", "long"), ("v", "double"), ("s", "string"), ("ok",
                                                           "boolean"))]}
    opts = {"schema": schema} if fmt == "avro" else {}
    got = {}
    for pkg in BOTH:
        pkg.Broker.reset("txn")
        seen = []

        async def run(pkg=pkg, seen=seen):
            batches = _batches(pkg)
            if fmt == "raw":
                batches = [pkg.Batch(b.timestamp, {"value": b.columns["s"]})
                           for b in batches]
            src = pkg.Stream.source("memory", {"batches": batches})
            src.sink("kafka", {"bootstrap_servers": "memory://txn",
                               "topic": "out", "format": fmt,
                               "format_options": opts})
            engine = pkg.engine(src.program, f"txn-{pkg.name}")
            running = engine.start()
            held = hold_sources(engine, (2, 4, 6))
            broker = pkg.Broker.get("txn")
            for epoch, ev in enumerate(held, 1):
                await ev.wait()
                await running.checkpoint(epoch)
                assert await running.wait_for_checkpoint(epoch)
                seen.append((len(broker.fetch("out", 0, 0, 10_000, True)),
                             len(broker.fetch("out", 0, 0, 10_000, False)),
                             sum(len(t) for t in broker._txns.values())))
                await running.commit(epoch)
                await _until(lambda e=epoch: len(broker.fetch(
                    "out", 0, 0, 10_000)) == 100 * e)
            await running.join()
            vals, _ = broker.fetch_values("out", 0, 0, 10_000)
            return vals

        got[pkg.name] = (asyncio.run(run()), seen)
    assert got["port"] == got["jax"]
    vals, seen = got["port"]
    # the in-process broker keeps an open transaction's records out of
    # the log: neither isolation level reads them before the commit
    assert seen == [(0, 0, 100), (100, 100, 100), (200, 200, 100)]
    assert len(vals) == 300
    # a read_committed Kafka source reads the topic back
    clear_sink("txn-back")
    LocalRunner(Stream.source("kafka", {
        "bootstrap_servers": "memory://txn", "topic": "out", "format": fmt,
        "format_options": opts, "max_messages": 300}).sink(
        "memory", {"name": "txn-back"}), device="cpu").run()
    assert sum(len(b) for b in sink_output("txn-back")) == 300


# -- single_file ----------------------------------------------------------------------


def _jsonl(path, n=500, seed=9):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            row = {"i": i, "ts": i * 1_000, "v": float(rng.normal()),
                   "s": f"x{rng.integers(0, 50)}"}
            if i % 7 == 0:
                row["code"] = f"{rng.integers(0, 999):03d}"
            f.write(json.dumps(row) + "\n")


def _sorted_rows(batches, cols):
    return sorted(tuple(b.columns[c][j].item() if hasattr(
        b.columns[c][j], "item") else b.columns[c][j] for c in cols)
        for b in batches for j in range(len(b)))


@pytest.mark.parametrize("fast", ["1", "0"])
def test_single_file_source_resumes_exactly_once(fast, tmp_path,
                                                 monkeypatch):
    """Stop after a checkpoint mid-file, restore: each line once, the
    rows and dtypes the JAX package's."""
    monkeypatch.setenv("ARROYO_FAST_DECODE", fast)
    monkeypatch.setenv("BATCH_SIZE", "64")
    from arroyo_tpu.config import reset_config as jax_reset_config
    from arroyo_tpu_torch.config import reset_config
    reset_config(), jax_reset_config()
    path = str(tmp_path / "in.jsonl")
    _jsonl(path)
    got = {}
    try:
        for pkg in BOTH:
            sink = f"sf-{pkg.name}"
            pkg.clear_sink(sink)

            def program(pkg=pkg, sink=sink):
                return pkg.Stream.source("single_file", {
                    "path": path, "timestamp_field": "ts"}).sink(
                    "memory", {"name": sink})

            async def run(pkg=pkg, program=program):
                engine = pkg.engine(program(), f"sf-{pkg.name}")
                running = engine.start()
                (held,) = hold_sources(engine, (3,))
                await held.wait()
                await running.checkpoint(1, then_stop=True)
                assert await running.wait_for_checkpoint(1)
                await running.join()
                first = sum(len(b) for b in pkg.sink_output(sink))
                await pkg.engine(program(), f"sf-{pkg.name}", 1).start(
                    ).join()
                return first

            first = asyncio.run(run())
            batches = pkg.sink_output(sink)
            got[pkg.name] = (first, _sorted_rows(batches, ("i", "ts", "v",
                                                           "s")),
                             sorted({str(b.columns["code"].dtype)
                                     for b in batches
                                     if "code" in b.columns}))
    finally:
        monkeypatch.undo()
        reset_config(), jax_reset_config()
    assert got["port"] == got["jax"]
    first, rows, _ = got["port"]
    assert first == 192 and [r[0] for r in rows] == list(range(500))


def test_single_file_sink_truncates_on_restore(tmp_path):
    """Lines written after the last sealed epoch are cut at the restore
    and written again: the file equals a straight run's, byte for byte,
    and the JAX package's."""
    got = {}
    for pkg in BOTH:
        straight = str(tmp_path / f"{pkg.name}-straight.jsonl")
        cut = str(tmp_path / f"{pkg.name}-cut.jsonl")

        def program(path, pkg=pkg):
            return pkg.Stream.source("memory", {
                "batches": _batches(pkg)}).sink("single_file",
                                                {"path": path})

        pkg.runner(program(straight)).run()

        async def run(pkg=pkg, cut=cut, program=program):
            engine = pkg.engine(program(cut), f"sfs-{pkg.name}")
            running = engine.start()
            held = hold_sources(engine, (2, 5))
            await held[0].wait()
            await running.checkpoint(1)
            assert await running.wait_for_checkpoint(1)
            await held[1].wait()
            await asyncio.sleep(0.05)
            await running.stop(pkg.StopMode.IMMEDIATE)
            await running.join()
            mid = os.path.getsize(cut)
            # the memory source replays from the start: drop the epoch's
            # first two batches as a positioned source would
            prog = pkg.Stream.source("memory", {
                "batches": _batches(pkg)[2:]}).sink("single_file",
                                                    {"path": cut})
            await pkg.engine(prog, f"sfs-{pkg.name}", 1).start().join()
            return mid

        mid = asyncio.run(run())
        with open(straight, "rb") as f1, open(cut, "rb") as f2:
            got[pkg.name] = (f1.read(), f2.read(), mid)
    assert got["port"][:2] == got["jax"][:2]
    s, c, mid = got["port"]
    assert c == s and mid > len(b"".join(s.splitlines(True)[:100]))


def test_single_file_fast_path_pins_formats_semantics(monkeypatch):
    """tests/test_formats.py::
    test_single_file_fast_path_pins_formats_semantics in the port: the
    fast path keeps digit strings as strings and a missing field as None;
    the connector's historical pivot turns them into float64."""
    from arroyo_tpu.connectors.single_file import \
        _rows_to_batch as jax_rows_to_batch
    from arroyo_tpu.formats import JsonFormat as JaxJsonFormat
    from arroyo_tpu_torch.connectors.single_file import _rows_to_batch
    from arroyo_tpu_torch.formats import JsonFormat

    rows = [{"id": 0, "ts": 1}, {"id": 1, "code": "105", "ts": 2}]
    payloads = [json.dumps(r).encode() for r in rows]
    legacy = _rows_to_batch([json.loads(p) for p in payloads], "ts")
    want = jax_rows_to_batch([json.loads(p) for p in payloads], "ts")
    assert legacy.columns["code"].dtype == want.columns["code"].dtype \
        == np.float64
    assert np.isnan(legacy.columns["code"][0])
    assert legacy.columns["code"][1] == 105.0
    monkeypatch.setenv("ARROYO_FAST_DECODE", "1")
    fast = JsonFormat().batch(payloads, "ts")
    jfast = JaxJsonFormat()
    jfast._arrow_ok = False
    jfast = jfast.batch(payloads, "ts")
    assert fast.columns["code"].dtype == jfast.columns["code"].dtype == object
    assert fast.columns["code"].tolist() == [None, "105"]
    assert fast.timestamp.tolist() == jfast.timestamp.tolist() == [1, 2]


# -- the preview sink -----------------------------------------------------------------


def test_preview_sink_sends_what_jax_sends(monkeypatch):
    """The ``SendSinkData`` requests, captured in place of the gRPC
    call: the port's protobuf bytes equal the JAX package's encoding of
    its request dicts, and the Arrow batches decode to the same rows."""
    from arroyo_tpu.connectors import preview as jax_preview
    from arroyo_tpu.network.data_plane import _decode_batch
    from arroyo_tpu.rpc.gen import rpc_pb2
    from arroyo_tpu.rpc.transport import dict_to_proto
    from arroyo_tpu_torch.connectors.preview import PreviewSink

    jax_sent, port_sent = [], []

    class FakeClient:
        def __init__(self, addr, service):
            assert (addr, service) == ("ctl:1", "ControllerGrpc")

        async def call(self, method, req):
            assert method == "SendSinkData"
            jax_sent.append(dict_to_proto(rpc_pb2.SinkDataReq(),
                                          req).SerializeToString())

        async def close(self):
            pass

    async def send(payload, timeout):
        port_sent.append(payload)

    monkeypatch.setenv("ARROYO_COALESCE", "0")  # a request a batch
    monkeypatch.setattr(jax_preview, "RpcClient", FakeClient)
    monkeypatch.setattr(PreviewSink, "_connect", lambda self: send)
    for pkg in BOTH:
        prog = pkg.Stream.source("memory", {"batches": _batches(pkg)}).sink(
            "preview", {"controller_addr": "ctl:1"})
        pkg.runner(prog).run()
    assert len(port_sent) == len(jax_sent) == 7
    for got, want in zip(port_sent, jax_sent):
        g, w = rpc_pb2.SinkDataReq(), rpc_pb2.SinkDataReq()
        g.ParseFromString(got)
        w.ParseFromString(want)
        assert (g.job_id, g.operator_id, g.done) == (w.job_id, w.operator_id,
                                                     w.done)
        assert bool(g.batch) == bool(w.batch)
        if w.batch:
            gb, wb = _decode_batch(g.batch), _decode_batch(w.batch)
            assert gb.timestamp.tolist() == wb.timestamp.tolist()
            assert {n: [str(x) for x in c.tolist()]
                    for n, c in gb.columns.items()} == \
                {n: [str(x) for x in c.tolist()]
                 for n, c in wb.columns.items()}
    assert port_sent[-1] == jax_sent[-1]


# -- SQL sink DDL ---------------------------------------------------------------------

SINK_DDL = {
    "filesystem": "CREATE TABLE out WITH (connector = 'filesystem', "
                  "path = 'file:///tmp/x', format = 'parquet', "
                  "rows_per_file = '100', type = 'sink');",
    "single_file": "CREATE TABLE out WITH (connector = 'single_file', "
                   "path = '/tmp/x.jsonl', type = 'sink');",
    "preview": "CREATE TABLE out WITH (connector = 'preview', "
               "type = 'sink');",
    "kafka_json": "CREATE TABLE out WITH (connector = 'kafka', "
                  "bootstrap_servers = 'memory://o', topic = 't', "
                  "type = 'sink', format = 'json');",
    "kafka_debezium": "CREATE TABLE out WITH (connector = 'kafka', "
                      "bootstrap_servers = 'memory://o', topic = 't', "
                      "type = 'sink', format = 'debezium_json');",
    "kafka_avro": "CREATE TABLE out (k BIGINT, med DOUBLE, cnt BIGINT, "
                  "window_start TIMESTAMP, window_end TIMESTAMP) WITH ("
                  "connector = 'kafka', bootstrap_servers = 'memory://o', "
                  "topic = 't', type = 'sink', format = 'avro');",
    "kafka_raw": "CREATE TABLE out WITH (connector = 'kafka', "
                 "bootstrap_servers = 'memory://o', topic = 't', "
                 "type = 'sink', format = 'raw_string');",
}


@pytest.fixture
def median():
    unregister_udfs()
    jax_unregister_udfs()
    register_udaf("median", np.median)
    jax_register_udaf("median", np.median)
    yield
    unregister_udfs()
    jax_unregister_udfs()


def _connectors(prog):
    return [(prog.node(n).operator.name, prog.node(n).operator.kind.value,
             prog.node(n).operator.spec.connector,
             prog.node(n).operator.spec.config) for n in prog.topo_order()
            if prog.node(n).operator.kind.value in ("connector_source",
                                                    "connector_sink")]


@pytest.mark.parametrize("name", sorted(SINK_DDL))
def test_sink_ddl_plans_as_jax(name, median):
    """config5 with each sink table: the port's plan equals the JAX
    planner's node for node, the connectors' configs included, and the
    sink declares the JAX sink's tables."""
    from arroyo_tpu.engine.build import build_operator as jax_build
    from arroyo_tpu_torch.engine.build import build_operator
    from test_torch_sql_plan import _signature

    for fmt in ("json", "avro"):
        sql = config5_sql(1_000, 4_096, "ddl", fmt, SINK_DDL[name])
        jax_prog, prog = jax_plan_sql(sql), plan_sql(sql)
        assert _signature(prog) == _signature(jax_prog)
        assert _connectors(prog) == _connectors(jax_prog)
    (sink,) = [n for n in prog.topo_order()
               if prog.node(n).operator.kind == OpKind.CONNECTOR_SINK]
    got = build_operator(prog.node(sink).operator, "cpu")
    want = jax_build(jax_prog.node(sink).operator)
    assert type(got).__name__ == type(want).__name__
    assert [(t.name, t.table_type.name, t.write_behavior.name)
            for t in got.tables()] == \
        [(t.name, t.table_type.name, t.write_behavior.name)
         for t in want.tables()]


# -- config5 into the filesystem sink, cut and restored ---------------------------------

C5_EVENTS, C5_BATCH, C5_SPACING = 20_000, 1_024, 1_000


def _produce(pkg, broker):
    pkg.Broker.reset(broker)
    b = pkg.Broker.get(broker)
    b.create_topic("sess", partitions=1)
    keys, vals, ts = config5_events(C5_EVENTS, 0, C5_SPACING)
    for k, v, t in zip(keys.tolist(), vals.tolist(), ts.tolist()):
        b.produce("sess", json.dumps({"k": k, "v": v, "ts": t}).encode(),
                  partition=0)


def _c5_rows(root):
    return sorted(tuple(r[c] for c in ("k", "med", "cnt", "window_start",
                                       "window_end"))
                  for r in _json_rows(root))


def _c5_sql(pkg, root):
    sink = (f"CREATE TABLE out WITH (connector = 'filesystem', "
            f"path = 'file://{root}', format = 'json', type = 'sink');")
    return config5_sql(C5_EVENTS, C5_BATCH, f"c5-{pkg.name}", "json", sink)


def test_config5_filesystem_cut_and_restore_matches_jax(tmp_path):
    """Epochs 1 and 2 sealed and committed, epoch 3 sealed, an IMMEDIATE
    stop before its commit (its part staged, never promoted); a fresh
    engine restored from epoch 3 promotes it and runs to the end: the
    rows of a straight run, each once, and the JAX package's."""
    unregister_udfs()
    jax_unregister_udfs()
    register_udaf("median", np.median)
    jax_register_udaf("median", np.median)
    try:
        rows, cuts = {}, {}
        for pkg in BOTH:
            _produce(pkg, f"c5-{pkg.name}")
            root = str(tmp_path / pkg.name)
            sql = _c5_sql(pkg, root)
            epoch = asyncio.run(cut_before_commit(
                lambda: pkg.engine(pkg.plan_sql(sql), "c5-cut"),
                (4, 8, 12, 13), pkg.StopMode.IMMEDIATE))
            cuts[pkg.name] = _listing(root)
            async def restore(pkg=pkg, sql=sql, epoch=epoch):
                await pkg.engine(pkg.plan_sql(sql), "c5-cut",
                                 epoch).start().join()

            asyncio.run(restore())
            rows[pkg.name] = _c5_rows(root)
            assert _listing(root)[1] == []
        straight = str(tmp_path / "straight")
        LocalRunner(plan_sql(_c5_sql(PORT, straight)), device="cpu").run(
            checkpoint_interval_secs=1.0)
    finally:
        unregister_udfs()
        jax_unregister_udfs()
    assert rows["port"] == rows["jax"] == _c5_rows(straight)
    assert len(set(rows["port"])) == len(rows["port"]) == 256
    assert cuts["port"] == cuts["jax"]
    assert cuts["port"][1] and len(cuts["port"][0]) < len(_listing(
        str(tmp_path / "port"))[0])
