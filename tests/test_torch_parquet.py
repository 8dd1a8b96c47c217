"""Parquet checkpoints that restore across the packages, on the CPU.

* Engine-level restores through one ``file://`` Parquet directory, at
  parallelism 1, both ways: one package runs a pipeline, checkpoints
  epoch 1 with ``then_stop`` while its sources are held mid-stream, the
  other restores epoch 1 and runs to the end; the two phases' sink rows
  together are an uninterrupted run's (exactly once).  For bench.py's
  q5 (nexmark ``s``, the keyed bin ring), config5 (Kafka offsets in
  ``s``, session runs and their tombstones in ``v``, the UDAF buffer)
  and join-stress 8a (impulse ``i``, both join buffers).
* ``compact_operator`` then restore, ``cleanup_before`` on both backends,
  ``restore_watermark``, and tombstones in the Parquet rows.
* A restore, in a fresh interpreter, of an epoch the JAX package wrote:
  ``jax`` and ``arroyo_tpu`` stay out of ``sys.modules``."""

import asyncio
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("pyarrow")

import bench  # noqa: E402
from arroyo_tpu.config import reset_config as jax_reset_config  # noqa: E402
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink  # noqa: E402
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output  # noqa: E402
from arroyo_tpu.engine.engine import Engine as JaxEngine  # noqa: E402
from arroyo_tpu.graph.logical import JoinType as JaxJoinType  # noqa: E402
from arroyo_tpu.graph.logical import Stream as JaxStream  # noqa: E402
from arroyo_tpu.sql import SchemaProvider as JaxSchemaProvider  # noqa: E402
from arroyo_tpu.sql import plan_sql as jax_plan_sql  # noqa: E402
from arroyo_tpu.sql.functions import unregister_udfs as jax_unregister  # noqa: E402
from arroyo_tpu.state.backend import ParquetBackend as JaxParquet  # noqa: E402
from arroyo_tpu_torch import queries, sql  # noqa: E402
from arroyo_tpu_torch.config import reset_config  # noqa: E402
from arroyo_tpu_torch.config5 import config5_produce  # noqa: E402
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output  # noqa: E402
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner  # noqa: E402
from arroyo_tpu_torch.graph.logical import JoinType  # noqa: E402
from arroyo_tpu_torch.join_stress import (BASE_TIME_MICROS, LEFT_COLS,  # noqa: E402
                                          RIGHT_COLS, join_stress_program,
                                          zipf_map)
from arroyo_tpu_torch.state.backend import (OP_DELETE_KEY,  # noqa: E402
                                            InMemoryBackend, ParquetBackend,
                                            TableSnapshot, _serialize_rows)
from arroyo_tpu_torch.state.store import StateStore  # noqa: E402
from arroyo_tpu_torch.state.tables import TableDescriptor, TableType  # noqa: E402
from arroyo_tpu_torch.types import Batch, TaskInfo  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_device(monkeypatch):
    """The JAX side on one device's state, as the port (conftest's 8 CPU
    devices would pick its mesh state); sources close together so a
    held source stops mid-stream."""
    monkeypatch.setenv("ARROYO_MESH", "off")
    monkeypatch.setenv("QUEUE_SIZE", "4")
    reset_config(), jax_reset_config()
    yield
    monkeypatch.undo()
    reset_config(), jax_reset_config()


# -- the three pipelines, planned alike in both packages ----------------------


Q5_N, Q5_B = 120_000, 8_192
C5_N, C5_B, C5_SPACING = 60_000, 2_048, 100
JS_N, JS_B = 20_000, 1_024
JS_TTL = 3_600_000_000


def _q5_sql():
    """bench.py's q5 at 50,000 events/s, so panes fire on both sides of
    the barrier, with the event-time origin pinned."""
    return queries.Q5.format(n=Q5_N, b=Q5_B).replace(
        "event_rate = '1000000'", "event_rate = '50000'").replace(
        f"batch_size = '{Q5_B}'",
        f"batch_size = '{Q5_B}', base_time_micros = '0'")


def _c5_sql():
    return queries.CONFIG5_SQL.format(b=C5_B, n=C5_N).replace(
        "memory://bench5", "memory://pq5")


def _plan_c5(jax):
    if jax:
        jax_unregister()
        try:
            p = JaxSchemaProvider()
            p.register_udaf("median", np.median)
            return jax_plan_sql(_c5_sql(), p)
        finally:
            jax_unregister()
    sql.unregister_udfs()
    try:
        sql.register_udaf("median", np.median)
        return sql.plan_sql(_c5_sql())
    finally:
        sql.unregister_udfs()


def _jax_js(sink):
    cfg = {"event_rate": 1e9, "message_count": JS_N,
           "event_time_interval_micros": 1000,
           "base_time_micros": BASE_TIME_MICROS, "batch_size": JS_B}
    left = (JaxStream.source("impulse", cfg)
            .watermark(max_lateness_micros=0)
            .udf(zipf_map(0), name="zl").key_by("k"))
    right = (JaxStream.source("impulse", cfg, program=left.program)
             .watermark(max_lateness_micros=0)
             .udf(zipf_map(1), name="zr").key_by("k"))
    return left.join_with_expiration(
        right, JS_TTL, JS_TTL, JaxJoinType.INNER, LEFT_COLS, RIGHT_COLS,
        name="stress_join").sink("memory", {"name": sink})


def _rows(batches, cols):
    """Multiset of sink rows: the timestamp and ``cols`` (a join pair's
    timestamp follows which side arrived first, so 8a's rows leave it
    out, as tests/test_torch_join_expiration.py does)."""
    out = Counter()
    for b in batches:
        data = [b.columns[c].tolist() if c != "ts" else b.timestamp.tolist()
                for c in cols]
        out.update(zip(*data))
    return out


# name -> (program(jax, sink), sink row columns, the sink's own name or
#          None, source polls before the hold)
def _q5_program(jax, sink):
    return (jax_plan_sql if jax else sql.plan_sql)(_q5_sql())


def _c5_program(jax, sink):
    return _plan_c5(jax)


def _js_program(jax, sink):
    return (_jax_js(sink) if jax else
            join_stress_program(JS_N, JoinType.INNER, JS_TTL, sink, JS_B))


CELLS = {
    "q5": (_q5_program, ("ts", "auction", "num"), "results", 7),
    "config5": (_c5_program, ("ts", "k", "med", "cnt", "window_start",
                              "window_end"), "results", 12),
    "8a": (_js_program, ("k", "v0", "v1"), None, 10),
}


def _produce(cell):
    if cell == "config5":
        bench._config5_produce("pq5", C5_N, 0, C5_SPACING)
        config5_produce("pq5", C5_N, 0, C5_SPACING)


_REFERENCE = {}


def _reference(cell):
    """The port's uninterrupted run's rows (equal to the JAX package's:
    tests/test_torch_sql_exec.py, _config5.py, _join_expiration.py)."""
    if cell not in _REFERENCE:
        make, cols, sink_name, _ = CELLS[cell]
        _produce(cell)
        sink = sink_name or f"pq-{cell}-ref"
        clear_sink(sink)
        LocalRunner(make(False, sink), device="cpu").run()
        _REFERENCE[cell] = _rows(sink_output(sink), cols)
        clear_sink(sink)
    return _REFERENCE[cell]


def _hold_sources(engine, hold_after):
    """Hold every source after its ``hold_after``-th poll until its
    barrier is queued; returns an event a source, set at the hold."""
    held = []
    for h in engine.subtasks.values():
        if not h.is_source:
            continue
        source, ev, polls = h.runner, asyncio.Event(), [0]
        held.append(ev)

        async def hold_then_poll(_s=source, _poll=source.poll_source_control,
                                 _ev=ev, _n=polls):
            _n[0] += 1
            if _n[0] == hold_after:
                _ev.set()
                while _s.control_rx.empty():
                    await asyncio.sleep(0.001)
            return await _poll()

        source.poll_source_control = hold_then_poll
    return held


def _engine(jax, program, job, url, restore_epoch=None):
    if jax:
        return JaxEngine.for_local(program, job, checkpoint_url=url,
                                   restore_epoch=restore_epoch)
    return Engine.for_local(program, job, checkpoint_url=url,
                            restore_epoch=restore_epoch, device="cpu")


def _run_phases(cell, writer_jax, url, job):
    """Phase one in one package up to a checkpoint-then-stop at epoch 1,
    phase two in the other from epoch 1; returns both phases' rows."""
    make, cols, sink_name, hold_after = CELLS[cell]
    sink = sink_name or f"pq-{cell}"
    rows = []
    for phase, jax in enumerate((writer_jax, not writer_jax)):
        _produce(cell)
        (jax_clear_sink if jax else clear_sink)(sink)
        program = make(jax, sink)

        async def run():
            if phase == 0:
                engine = _engine(jax, program, job, url)
                running = engine.start()
                for ev in _hold_sources(engine, hold_after):
                    await ev.wait()
                await running.checkpoint(1, then_stop=True)
                assert await running.wait_for_checkpoint(1, timeout=60)
                await running.join()
            else:
                await _engine(jax, program, job, url, 1).start().join()

        asyncio.run(run())
        rows.append(_rows((jax_sink_output if jax else sink_output)(sink),
                          cols))
        (jax_clear_sink if jax else clear_sink)(sink)
    return rows


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_engine_restores_across_packages(cell, writer, tmp_path):
    """One package checkpoints (epoch 1, then stop) into a Parquet
    directory, the other restores it and runs to the end: every row of
    an uninterrupted run comes out exactly once."""
    reference = _reference(cell)
    assert reference
    before, after = _run_phases(cell, writer == "jax",
                                f"file://{tmp_path}/ckpt", f"pq-{cell}")
    assert sum(before.values()) < sum(reference.values())
    assert before + after == reference
    ckpt = tmp_path / "ckpt" / f"pq-{cell}" / "checkpoints" / \
        "checkpoint-0000001"
    files = [p.name for p in ckpt.rglob("*.parquet")]
    # the source tables crossed: nexmark and Kafka `s`, impulse `i`
    want = {"q5": "table-s-000.parquet", "config5": "table-s-000.parquet",
            "8a": "table-i-000.parquet"}[cell]
    assert want in files, files
    if cell == "config5":
        assert "table-v-000.parquet" in files


# -- the backend alone -------------------------------------------------------------


def _task(job, op="op", idx=0, n=1):
    return TaskInfo(job, op, op, idx, n)


def _tables():
    keyed = TableDescriptor("v", TableType.KEYED)
    glob = TableDescriptor("s", TableType.GLOBAL)
    buf = TableDescriptor("b", TableType.BATCH_BUFFER)
    dev = TableDescriptor("d", TableType.DEVICE)
    batch = Batch(np.arange(6, dtype=np.int64),
                  {"k": np.arange(6) % 3, "x": np.linspace(0, 1, 6)}
                  ).with_key(["k"])
    return {
        "v": TableSnapshot(keyed, entries=[(5, 11, [(1, 2)]),
                                           (7, 2**63 + 5, [(3, 9)])],
                           deletes=[12, 11]),
        "s": TableSnapshot(glob, entries=[(0, 0, (3, 10**15))]),
        "b": TableSnapshot(buf, batch=batch),
        "d": TableSnapshot(dev, arrays={"meta": np.arange(4),
                                        "obj": np.array([None, (1, 2)],
                                                        dtype=object)}),
    }, [keyed, glob, buf, dev]


def test_tombstones_and_round_trip(tmp_path):
    """A tombstone of a key that is live in the same epoch is dropped;
    the other is written as a DeleteKey row.  Every table form restores
    as written, in the port and in the JAX package."""
    tables, descs = _tables()
    kh, ts, keys, values, ops = _serialize_rows(tables["v"])
    assert list(ops).count(OP_DELETE_KEY) == 1  # 12 only: 11 is live
    url = f"file://{tmp_path}"
    ParquetBackend.for_url(url).write_subtask_checkpoint(
        _task("tomb"), 3, tables, watermark=1234)
    for backend in (ParquetBackend.for_url(url), JaxParquet.for_url(url)):
        task = _task("tomb")
        got = backend.restore_subtask(task, 3, descs)
        assert got["v"].entries == [(5, 11, [(1, 2)]),
                                    (7, 2**63 + 5, [(3, 9)])]
        assert got["s"].entries == [(0, 0, (3, 10**15))]
        b = got["b"].batch
        np.testing.assert_array_equal(b.timestamp, np.arange(6))
        np.testing.assert_array_equal(b.key_hash, tables["b"].batch.key_hash)
        np.testing.assert_array_equal(got["d"].arrays["meta"], np.arange(4))
        assert list(got["d"].arrays["obj"]) == [None, (1, 2)]
        assert backend.restore_watermark(task, 3) == 1234
        assert backend.restore_watermark(_task("tomb", idx=1, n=2), 3) is None
    store = StateStore.from_checkpoint_url(_task("tomb"), url, 3, "cpu")
    assert store.restore_watermark() == 1234
    assert store.get_keyed_state("v").get(11) == [(1, 2)]


def test_restore_filters_by_key_range(tmp_path):
    """Two restoring subtasks split the KEYED and batch rows by key
    range and both get every GLOBAL row."""
    tables, descs = _tables()
    backend = ParquetBackend.for_url(str(tmp_path))
    backend.write_subtask_checkpoint(_task("kr"), 1, tables, None)
    halves = [backend.restore_subtask(_task("kr", idx=i, n=2), 1, descs)
              for i in range(2)]
    keys = sorted(k for h in halves for _t, k, _v in (h["v"].entries or []))
    assert keys == [11, 2**63 + 5]
    assert all(h["s"].entries == [(0, 0, (3, 10**15))] for h in halves)
    assert sum(len(h["b"].batch) for h in halves if "b" in h) == 6


def test_compact_operator_then_restore(tmp_path):
    """Compaction merges two subtasks' files into key-range partitions,
    applies the tombstones, writes its marker and drops the replaced
    files; restore reads the compacted generation and a second call only
    finishes the cleanup."""
    url = f"file://{tmp_path}"
    backend = ParquetBackend.for_url(url)
    keyed = TableDescriptor("v", TableType.KEYED)
    backend.write_subtask_checkpoint(
        _task("cmp", idx=0, n=2), 2,
        {"v": TableSnapshot(keyed, entries=[(1, 5, "a"), (2, 2**63, "b")])},
        None)
    backend.write_subtask_checkpoint(
        _task("cmp", idx=1, n=2), 2,
        {"v": TableSnapshot(keyed, entries=[(3, 2**62, "c")],
                            deletes=[5])}, None)
    out = backend.compact_operator("cmp", "op", 2, n_partitions=2)
    assert len(out["to_drop"]) == 2 and len(out["to_load"]) == 2
    assert all(not backend.storage.exists(f) for f in out["to_drop"])
    assert backend.storage.exists(
        ParquetBackend.compaction_marker("cmp", 2, "op"))
    for reader in (backend, JaxParquet.for_url(url)):
        got = reader.restore_subtask(_task("cmp"), 2, [keyed])
        assert sorted(got["v"].entries) == [(2, 2**63, "b"), (3, 2**62, "c")]
    again = backend.compact_operator("cmp", "op", 2, n_partitions=2)
    assert again == {"to_load": out["to_load"], "to_drop": []}


def test_cleanup_before_on_both_backends(tmp_path):
    tables, descs = _tables()
    backend = ParquetBackend.for_url(str(tmp_path))
    mem = InMemoryBackend()
    for epoch in (1, 2, 3):
        backend.write_subtask_checkpoint(_task("cl"), epoch, tables, epoch)
        mem.write_subtask_checkpoint(_task("cl"), epoch, tables, epoch)
        mem.write_subtask_checkpoint(_task("other"), epoch, tables, epoch)
    for b in (backend, mem):
        b.cleanup_before("cl", 3)
        assert b.restore_subtask(_task("cl"), 2, descs) == {}
        assert b.restore_watermark(_task("cl"), 1) is None
        assert b.restore_watermark(_task("cl"), 3) == 3
        assert b.restore_subtask(_task("cl"), 3, descs)["v"].entries
    assert mem.restore_watermark(_task("other"), 1) == 1
    dirs = sorted(p.name for p in (tmp_path / "cl" / "checkpoints").iterdir())
    assert dirs == ["checkpoint-0000003"]


def test_values_naming_the_port_are_refused(tmp_path):
    """A value pickled by the port that names one of its classes is
    refused at write; a JAX-written value naming an ``arroyo_tpu`` class
    reads as the port's class of the same name."""
    from arroyo_tpu.types import Watermark as JaxWatermark
    from arroyo_tpu_torch.types import Watermark

    keyed = TableDescriptor("v", TableType.KEYED)
    with pytest.raises(TypeError, match="arroyo_tpu_torch"):
        _serialize_rows(TableSnapshot(keyed, entries=[
            (0, 1, Watermark.event_time(5))]))
    from arroyo_tpu.state.backend import TableSnapshot as JaxSnapshot
    from arroyo_tpu.state.tables import TableDescriptor as JaxDescriptor
    from arroyo_tpu.state.tables import TableType as JaxTableType
    from arroyo_tpu.types import TaskInfo as JaxTaskInfo

    jdesc = JaxDescriptor("v", JaxTableType.KEYED)
    JaxParquet.for_url(str(tmp_path)).write_subtask_checkpoint(
        JaxTaskInfo("jw", "op", "op", 0, 1), 1,
        {"v": JaxSnapshot(jdesc, entries=[(0, 1,
                                            JaxWatermark.event_time(5))])},
        None)
    got = ParquetBackend.for_url(str(tmp_path)).restore_subtask(
        _task("jw"), 1, [keyed])
    assert got["v"].entries == [(0, 1, Watermark.event_time(5))]


def test_restore_of_a_jax_epoch_imports_no_jax(tmp_path):
    """q5's epoch as the JAX package wrote it restores in a fresh
    interpreter that imports only the port and runs to the end: the two
    runs' rows are an uninterrupted run's, and neither ``jax`` nor
    ``arroyo_tpu`` is imported."""
    url = f"file://{tmp_path}/ckpt"
    program = jax_plan_sql(_q5_sql())

    async def phase1():
        engine = JaxEngine.for_local(program, "pq-fresh", checkpoint_url=url)
        running = engine.start()
        for ev in _hold_sources(engine, CELLS["q5"][3]):
            await ev.wait()
        await running.checkpoint(1, then_stop=True)
        assert await running.wait_for_checkpoint(1, timeout=60)
        await running.join()

    jax_clear_sink("results")
    asyncio.run(phase1())
    before = _rows(jax_sink_output("results"), CELLS["q5"][1])
    jax_clear_sink("results")
    code = (
        "import asyncio, sys\n"
        "from arroyo_tpu_torch import sql\n"
        "from arroyo_tpu_torch.connectors.memory import sink_output\n"
        "from arroyo_tpu_torch.engine.engine import Engine\n"
        f"prog = sql.plan_sql({_q5_sql()!r})\n"
        "engine = Engine.for_local(prog, 'pq-fresh', checkpoint_url="
        "sys.argv[1], restore_epoch=1, device='cpu')\n"
        "async def main():\n"
        "    await engine.start().join()\n"
        "asyncio.run(main())\n"
        "rows = [(int(b.timestamp[i]), int(b.columns['auction'][i]),\n"
        "         int(b.columns['num'][i]))\n"
        "        for b in sink_output('results') for i in range(len(b))]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'arroyo_tpu'))\n"
        "print(repr(rows))\n"
        "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, url], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    import ast

    rows_line, bad_line = proc.stdout.strip().splitlines()[-2:]
    assert ast.literal_eval(bad_line) == []
    after = Counter(ast.literal_eval(rows_line))
    assert after and before + after == _reference("q5")


# -- a sealed epoch's pre-commits across the packages -----------------------------------


def _lines_file(path, n=600):
    rng = np.random.default_rng(13)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f'{{"i": {i}, "ts": {i * 1_000}, '
                    f'"v": {float(rng.normal())!r}}}\n')


def _fs_pipeline(jax, src, out):
    from arroyo_tpu_torch.graph.logical import Stream

    return (JaxStream if jax else Stream).source("single_file", {
        "path": src, "timestamp_field": "ts"}).sink(
        "filesystem", {"path": f"file://{out}", "format": "json"})


def _parts(out):
    final, staged = [], []
    for dirpath, _, names in os.walk(out):
        for n in sorted(names):
            (staged if ".staging" in dirpath else final).append(n)
    return sorted(final), sorted(staged)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sealed_precommits_restore_across_packages(writer, tmp_path,
                                                   monkeypatch):
    """One package's filesystem sink seals epoch 1 (its part staged, the
    pre-commit in table ``p`` of a Parquet checkpoint) and the run is cut
    by an IMMEDIATE stop before the commit; the other package restores
    epoch 1, promotes that part once and writes the rest: every line of
    the input once."""
    from arroyo_tpu.types import StopMode as JaxStopMode
    from arroyo_tpu_torch.engine.drills import cut_before_commit
    from arroyo_tpu_torch.types import StopMode

    monkeypatch.setenv("BATCH_SIZE", "64")
    reset_config(), jax_reset_config()
    src, out = str(tmp_path / "in.jsonl"), str(tmp_path / "out")
    _lines_file(src)
    url, job = f"file://{tmp_path}/ckpt", f"pc-{writer}"
    jax_first = writer == "jax"
    epoch = asyncio.run(cut_before_commit(
        lambda: _engine(jax_first, _fs_pipeline(jax_first, src, out), job,
                        url),
        (3, 4), JaxStopMode.IMMEDIATE if jax_first else StopMode.IMMEDIATE))
    assert epoch == 1
    assert _parts(out) == ([], ["part-0000-000000.json"])

    async def restore():
        await _engine(not jax_first, _fs_pipeline(not jax_first, src, out),
                      job, url, restore_epoch=1).start().join()

    asyncio.run(restore())
    final, staged = _parts(out)
    assert staged == [] and final == ["part-0000-000000.json",
                                      "part-0000-000001.json"]
    lines = []
    for name in final:
        with open(os.path.join(out, name)) as f:
            lines += [json.loads(line)["i"] for line in f]
    assert sorted(lines) == list(range(600))
    with open(os.path.join(out, final[0])) as f:
        assert len(f.readlines()) == 3 * 64
