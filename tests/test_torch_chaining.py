"""Operator chaining and input coalescing in the port against arroyo_tpu,
on the CPU:

* ``plan_chains`` gives the same member groups, by operator name, on each
  port program (q1, q5, q7, q8, config5, join-stress, hot items) as the
  JAX ``plan_chains`` on the JAX plan of the same query, with
  parallelism-1 shuffles chained and not;
* ``ARROYO_CHAIN=0`` builds one runner per operator; chained, one per
  chain; every program emits the same rows either way;
* a chained checkpoint reports one completion per member and restores
  unchained, and the reverse, with exactly-once rows;
* the ``BatchCoalescer`` against the JAX one on the same batch sequences
  (target and pass-through, a layout change flushes in order, sides never
  mix), and end to end: a linger bound honoured, and windows equal with
  coalescing on and off and to the JAX engine's."""

import asyncio
import time

import numpy as np
import pytest

import bench
from arroyo_tpu import Stream as JaxStream
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.graph.logical import AggKind as JaxAggKind
from arroyo_tpu.graph.logical import AggSpec as JaxAggSpec
from arroyo_tpu.engine.coalesce import BatchCoalescer as JaxCoalescer
from arroyo_tpu.graph.chaining import plan_chains as jax_plan_chains
from arroyo_tpu.graph.logical import JoinType as JaxJoinType
from arroyo_tpu.sql import SchemaProvider, plan_sql
from arroyo_tpu.sql.functions import unregister_udfs
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch.config import reset_config
from arroyo_tpu_torch.config5 import config5_produce, config5_program
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.coalesce import BatchCoalescer
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
from arroyo_tpu_torch.graph.chaining import (ChainPlan, plan_chains,
                                             validate_chain_plan)
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec, JoinType, Stream
from arroyo_tpu_torch.hot_items import hot_items_program, hot_items_sql
from arroyo_tpu_torch.join_stress import (BASE_TIME_MICROS, LEFT_COLS,
                                          PLANNER_TTL_MICROS, RIGHT_COLS,
                                          join_stress_program, zipf_map)
from arroyo_tpu_torch.q1 import q1_program
from arroyo_tpu_torch.q5 import q5_program
from arroyo_tpu_torch.q7 import q7_program
from arroyo_tpu_torch.q8 import q8_program
from arroyo_tpu_torch.state.backend import InMemoryBackend
from arroyo_tpu_torch.types import Batch

SEC = 1_000_000
PROGRAMS = ["q1", "q5", "q7", "q8", "config5", "join_stress", "hot_items"]


def _jax_join_stress(n, batch):
    cfg = {"event_rate": 1e9, "message_count": n,
           "event_time_interval_micros": 1000,
           "base_time_micros": BASE_TIME_MICROS, "batch_size": batch}
    left = (JaxStream.source("impulse", cfg)
            .watermark(max_lateness_micros=0)
            .udf(zipf_map(0), name="zl").key_by("k"))
    right = (JaxStream.source("impulse", cfg, program=left.program)
             .watermark(max_lateness_micros=0)
             .udf(zipf_map(1), name="zr").key_by("k"))
    return left.join_with_expiration(
        right, PLANNER_TTL_MICROS, PLANNER_TTL_MICROS,
        JaxJoinType.INNER, LEFT_COLS, RIGHT_COLS,
        name="stress_join").sink("memory", {"name": "unused"})


def _jax_plan(name):
    n, b = 1_000, 128
    if name in ("q1", "q5", "q7", "q8"):
        return plan_sql(getattr(bench, name.upper()).format(n=n, b=b))
    if name == "config5":
        unregister_udfs()  # median is registered process-wide
        try:
            provider = SchemaProvider()
            provider.register_udaf("median", np.median)
            return plan_sql(bench.CONFIG5_SQL.format(b=4_096, n=n), provider)
        finally:
            unregister_udfs()
    if name == "join_stress":
        return _jax_join_stress(n, b)
    return plan_sql(hot_items_sql(n, b))


def _port_program(name, n, sink, b=16_384, rate=1_000_000.0):
    nexmark = {"q1": q1_program, "q5": q5_program, "q7": q7_program,
               "q8": q8_program}
    if name in nexmark:
        return nexmark[name](n, b, sink, event_rate=rate, base_time_micros=0)
    if name == "config5":
        return config5_program(n, 4_096, sink, broker=sink)
    if name == "join_stress":
        return join_stress_program(n, JoinType.INNER, PLANNER_TTL_MICROS,
                                   sink, 2_048)
    return hot_items_program(n, b, sink=sink, event_rate=rate,
                             base_time_micros=0)


def _groups(program, plan):
    return sorted(tuple(program.node(m).operator.name for m in grp)
                  for grp in plan.groups)


@pytest.mark.parametrize("shuffle1", ["1", "0"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_chain_groups_match_jax(monkeypatch, name, shuffle1):
    monkeypatch.setenv("ARROYO_CHAIN_SHUFFLE1", shuffle1)
    jax_prog = _jax_plan(name)
    port_prog = _port_program(name, 1_000, "unused", b=128)
    plan = plan_chains(port_prog)
    validate_chain_plan(port_prog, plan)
    assert plan.groups
    assert _groups(port_prog, plan) == _groups(jax_prog,
                                               jax_plan_chains(jax_prog))
    for grp in plan.groups:
        for m in grp:
            assert plan.head_of[m] == grp[0]
        assert plan.members_of[grp[0]] == grp
        assert plan.group_for(grp[-1]) == grp
    if shuffle1 == "0":
        assert not plan.shuffle_edges


def test_chaining_off_gives_an_empty_plan(monkeypatch):
    monkeypatch.setenv("ARROYO_CHAIN", "0")
    plan = plan_chains(q5_program(1_000, 128, "unused"))
    assert not plan.groups and not plan.head_of and not plan.members_of


def test_validate_chain_plan_rejects_bad_chains():
    program = q1_program(1_000, 128, "unused")
    ids = program.topo_order()  # source, watermark, where, project, sink
    for bad in ([ids[1]], [ids[0], ids[1]], [ids[1], ids[3]],
                [ids[3], ids[4]]):
        plan = ChainPlan(groups=[bad])
        with pytest.raises(ValueError, match="invalid chain plan"):
            validate_chain_plan(program, plan)


def _rows(batches):
    rows = []
    for b in batches:
        names = sorted(b.columns)
        cols = [b.columns[n].tolist() for n in names]
        rows.extend(zip(b.timestamp.tolist(), *cols))
    return sorted(rows)


def _run(name, chain, monkeypatch):
    """(sorted rows, engine, program) of one small run of ``name``."""
    monkeypatch.setenv("ARROYO_CHAIN", chain)
    sink = f"chain-{name}-{chain}"
    n = {"config5": 100_000, "join_stress": 20_000}.get(name, 200_000)
    if name == "config5":
        config5_produce(sink, n, 0, 100)
    clear_sink(sink)
    program = _port_program(name, n, sink, rate=50_000.0)
    runner = LocalRunner(program, device="cpu")
    runner.run()
    if name == "join_stress":
        # a pair's time is its later side's, and the sides interleave as
        # the host schedules them: compare the pairs (as
        # tests/test_torch_join_expiration.py does)
        rows = sorted((int(k), int(v0), int(v1)) for b in sink_output(sink)
                      for k, v0, v1 in zip(b.columns["k"], b.columns["v0"],
                                           b.columns["v1"]))
    else:
        rows = _rows(sink_output(sink))
    clear_sink(sink)
    return rows, runner.engine, program


@pytest.mark.parametrize("name", PROGRAMS)
def test_rows_equal_chained_and_unchained(monkeypatch, name):
    """Each program's sorted rows are identical with chaining on (the
    default) and under ``ARROYO_CHAIN=0``, which builds one runner per
    operator."""
    on, on_engine, program = _run(name, "1", monkeypatch)
    off, off_engine, _ = _run(name, "0", monkeypatch)
    assert on and on == off
    assert len(off_engine.subtasks) == len(program.nodes())
    assert all(h.member_ids == [op] for (op, _), h
               in off_engine.subtasks.items())
    assert len(on_engine.subtasks) < len(off_engine.subtasks)
    assert set(on_engine.members) == set(off_engine.members)
    assert sorted(m for h in on_engine.subtasks.values()
                  for m in h.member_ids) == sorted(
        op for op, _ in off_engine.members)


@pytest.mark.parametrize("first, second", [("1", "0"), ("0", "1")])
def test_checkpoint_restores_across_chaining(monkeypatch, first, second):
    """q5 checkpointed mid-stream with chaining ``first``, stopped, and
    restored with chaining ``second`` emits exactly the rows of an
    uninterrupted run; the checkpoint reports one completion per
    (operator, subtask), however many runners there were.  The source is
    held after its 15th batch until the barrier is queued (as in
    tests/test_torch_engine.py)."""
    batch, hold_after = 8_192, 15

    def prog(sink):
        return q5_program(200_000, batch, sink, event_rate=50_000.0,
                          base_time_micros=0)

    clear_sink("cx-ref")
    LocalRunner(prog("cx-ref"), device="cpu").run()
    reference = _rows(sink_output("cx-ref"))
    assert reference

    sink = f"cx-{first}{second}"
    clear_sink(sink)
    program = prog(sink)
    job = f"cx-{first}{second}"

    async def phase1():
        engine = Engine(program, job, InMemoryBackend(), device="cpu")
        running = engine.start()
        source = next(h.runner for h in engine.subtasks.values()
                      if h.is_source)
        poll = source.poll_source_control
        held, batches = asyncio.Event(), [0]

        async def hold_then_poll():
            batches[0] += 1
            if batches[0] == hold_after:
                held.set()
                while source.control_rx.empty():
                    await asyncio.sleep(0.001)
            return await poll()

        source.poll_source_control = hold_then_poll
        await held.wait()
        await running.checkpoint(1, then_stop=True)
        assert await running.wait_for_checkpoint(1, timeout=60)
        resps = await running.join()
        return engine, resps

    monkeypatch.setenv("ARROYO_CHAIN", first)
    engine, resps = asyncio.run(phase1())
    completed = [(r.operator_id, r.task_index) for r in resps
                 if r.kind == "checkpoint_completed"
                 and r.subtask_metadata.epoch == 1]
    assert sorted(completed) == sorted((n.operator_id, 0)
                                       for n in program.nodes())
    assert len(engine.subtasks) == (3 if first == "1"
                                    else len(program.nodes()))
    emitted_before = len(_rows(sink_output(sink)))
    assert 0 < emitted_before < len(reference)

    async def phase2():
        await Engine(program, job, InMemoryBackend(), restore_epoch=1,
                     device="cpu").start().join()

    monkeypatch.setenv("ARROYO_CHAIN", second)
    asyncio.run(phase2())
    assert _rows(sink_output(sink)) == reference


# -- the coalescer ------------------------------------------------------------------


def _pair(vals, ts0=1_000, col="v"):
    """The same batch in both packages."""
    v = np.asarray(vals, dtype=np.int64)
    ts = np.arange(ts0, ts0 + len(v), dtype=np.int64)
    return Batch(ts, {col: v}), JaxBatch(ts, {col: v.copy()})


def _same(port_out, jax_out):
    assert len(port_out) == len(jax_out)
    for (ps, pb), (js, jb) in zip(port_out, jax_out):
        assert ps == js and list(pb.columns) == list(jb.columns)
        np.testing.assert_array_equal(pb.timestamp, jb.timestamp)
        for c in pb.columns:
            np.testing.assert_array_equal(pb.columns[c], jb.columns[c])


def _feed(seq, target=10):
    """Run ``[(side, values, column)]`` through both coalescers; returns
    each call's outputs and both coalescers."""
    port, jax = BatchCoalescer(target, 60.0), JaxCoalescer(target, 60.0)
    outs = []
    for side, vals, col in seq:
        pb, jb = _pair(vals, col=col)
        outs.append((port.add(side, pb), jax.add(side, jb)))
        assert port.pending == jax.pending
        assert (port.deadline is None) == (jax.deadline is None)
    return outs, port, jax


def test_coalescer_target_and_passthrough():
    outs, port, jax = _feed([(0, [], "v"), (0, [1, 2, 3], "v"),
                             (0, [4, 5, 6, 7, 8, 9, 10], "v"),
                             (1, list(range(20)), "v")])
    for p, j in outs:
        _same(p, j)
    assert [len(p) for p, _ in outs] == [0, 0, 1, 1]
    assert outs[2][0][0][1].columns["v"].tolist() == list(range(1, 11))
    assert not port.pending and port.deadline is None


def test_coalescer_layout_change_flushes_in_order():
    outs, port, jax = _feed([(0, [1, 2], "v"), (0, [9], "w"),
                             (0, [3], "w")])
    for p, j in outs:
        _same(p, j)
    assert outs[1][0][0][1].columns["v"].tolist() == [1, 2]
    flushed = port.flush_all()
    _same(flushed, jax.flush_all())
    assert flushed[0][1].columns["w"].tolist() == [9, 3]


def test_coalescer_sides_never_mix():
    _outs, port, jax = _feed([(0, [1], "v"), (1, [2], "v"), (0, [3], "v")])
    flushed = port.flush_all()
    _same(flushed, jax.flush_all())
    assert [(s, b.columns["v"].tolist()) for s, b in flushed] == [
        (0, [1, 3]), (1, [2])]
    assert not port.pending and port.deadline is None


def test_coalescer_linger_bound_honoured(monkeypatch):
    """A trickle far below the target still flows: each fragment waits at
    most the linger before its chain processes it."""
    monkeypatch.setenv("COALESCE_LINGER_MICROS", "5000")
    reset_config()
    try:
        clear_sink("linger")
        program = (Stream.source("impulse", {"event_rate": 2_000.0,
                                             "message_count": 400,
                                             "batch_size": 16})
                   .map(lambda c: {"counter": c["counter"]}, name="ident")
                   .sink("memory", {"name": "linger"}))
        t0 = time.perf_counter()
        LocalRunner(program, device="cpu").run()
        assert time.perf_counter() - t0 < 10.0
        out = Batch.concat(sink_output("linger"))
        assert sorted(out.columns["counter"].tolist()) == list(range(400))
    finally:
        monkeypatch.undo()
        reset_config()


def test_coalescing_keeps_records_before_watermarks(monkeypatch):
    """A tumbling aggregate over many 64-row batches: the same windows
    with coalescing on and off (a buffered batch never passes a
    watermark), and the JAX engine's, coalesced, on the same batches."""
    rng = np.random.default_rng(7)
    n = 5_000
    ts = np.sort(rng.integers(0, 3 * SEC, n)).astype(np.int64)
    src = Batch(ts, {"k": rng.integers(0, 16, n).astype(np.int64),
                     "v": rng.integers(0, 100, n).astype(np.int64)})
    batches = [src.select(np.arange(i, min(i + 64, n)))
               for i in range(0, n, 64)]

    def run_once(coalesce):
        monkeypatch.setenv("ARROYO_COALESCE", coalesce)
        clear_sink("wmord")
        program = (Stream.source("memory", {"batches": batches})
                   .watermark(max_lateness_micros=0)
                   .key_by("k")
                   .tumbling_aggregate(SEC // 2, [
                       AggSpec(AggKind.COUNT, None, "cnt"),
                       AggSpec(AggKind.SUM, "v", "s")])
                   .sink("memory", {"name": "wmord"}))
        LocalRunner(program, device="cpu").run()
        return _rows(sink_output("wmord"))

    off = run_once("0")
    assert off and run_once("1") == off
    jax_batches = [JaxBatch(b.timestamp, dict(b.columns)) for b in batches]
    jax_clear_sink("wmord")
    JaxLocalRunner(JaxStream.source("memory", {"batches": jax_batches})
                   .watermark(max_lateness_micros=0)
                   .key_by("k")
                   .tumbling_aggregate(SEC // 2, [
                       JaxAggSpec(JaxAggKind.COUNT, None, "cnt"),
                       JaxAggSpec(JaxAggKind.SUM, "v", "s")])
                   .sink("memory", {"name": "wmord"})).run()
    assert _rows(jax_sink_output("wmord")) == off
