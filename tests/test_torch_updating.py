"""The port's updating operators against arroyo_tpu's, on the CPU: the
non-windowed aggregate (``NonWindowAggOperator``: CREATE/UPDATE rows,
the mergeable AVG, NULLs, and the ``flush_key`` form that releases each
window's final row once), the running count and aggregate
(``CountOperator``, ``AggregateOperator``), the option-map and the
updating stream's expression and key.

* through both engines over the same batches (made with a numpy seed):
  sorted sink rows equal value for value and dtype for dtype, updating
  rows as their net rows where input coalescing may merge batches;
* operator against operator on hand-built batches and watermarks;
* the KEYED tables ``u``, ``c`` and ``a`` written by one package restore
  into the other's operator mid-stream, which then emits what that
  package emits run straight through;
* q5 as the reference plans it (``ARROYO_ARGMAX=0``: the per-window
  maximum is a ``flush_key`` aggregate) checkpointed mid-stream in the
  port's engine, stopped and restored, emits exactly the rows of an
  uninterrupted run."""

import asyncio
import math
from collections import Counter

import numpy as np
import pytest

from arroyo_tpu import Stream as JaxStream
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.engine.operators_basic import (
    AggregateOperator as JaxAggregate)
from arroyo_tpu.engine.operators_basic import CountOperator as JaxCount
from arroyo_tpu.engine.operators_window import (
    NonWindowAggOperator as JaxNonWindow)
from arroyo_tpu.graph.logical import AggKind as JaxAggKind
from arroyo_tpu.graph.logical import AggSpec as JaxAggSpec
from arroyo_tpu.sql import SchemaProvider as JaxProvider
from arroyo_tpu.sql.planner import Planner as JaxPlanner
from arroyo_tpu.state.tables import KeyedState as JaxKeyedState
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch import queries
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
from arroyo_tpu_torch.engine.operators_basic import (AggregateOperator,
                                                     CountOperator)
from arroyo_tpu_torch.engine.operators_window import NonWindowAggOperator
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec, OpKind, Stream
from arroyo_tpu_torch.obs import perf
from arroyo_tpu_torch.sql import Planner, SchemaProvider, plan_sql
from arroyo_tpu_torch.state.backend import InMemoryBackend
from arroyo_tpu_torch.state.tables import KeyedState
from arroyo_tpu_torch.types import Batch, hash_columns

SEC = 1_000_000
DAY = 86_400 * SEC


def _cell(v):
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return v


def _rows(batches, net=False):
    """(sorted rows, {column: dtypes}); rows are (timestamp, values in
    column-name order); with ``net`` the __op retractions apply and the
    timestamps and __op drop out."""
    rows, dtypes = Counter(), {}
    for b in batches:
        names = sorted(c for c in b.columns if not (net and c == "__op"))
        for n in names:
            dtypes.setdefault(n, set()).add(str(b.columns[n].dtype))
        cols = [[_cell(v) for v in b.columns[n].tolist()] for n in names]
        ops = (b.columns["__op"].tolist() if net and "__op" in b.columns
               else [0] * len(b))
        ts = [None] * len(b) if net else b.timestamp.tolist()
        for row, op in zip(zip(ts, *cols), ops):
            rows[row] += -1 if int(op) == 2 else 1
    return sorted((r for r, c in rows.items() for _ in range(c)),
                  key=repr), dtypes


def _events(seed, n=600, n_keys=7, span=6 * SEC, nulls=False):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, span, n)).astype(np.int64)
    v = rng.integers(1, 100, n).astype(np.float64 if nulls else np.int64)
    if nulls:
        v[rng.random(n) < 0.2] = np.nan
        v[np.arange(n) % n_keys == 3] = np.nan  # one key all NULL
    return ts, {"k": rng.integers(0, n_keys, n).astype(np.int64), "v": v}


def _split(ts, cols, parts):
    """(timestamp, columns) cut into ``parts`` consecutive batches."""
    cuts = np.linspace(0, len(ts), parts + 1).astype(int)
    return [(ts[a:b], {c: v[a:b] for c, v in cols.items()})
            for a, b in zip(cuts, cuts[1:])]


def _both(pieces, build, sink="upd"):
    """``build`` over a memory source of ``pieces`` with a watermark, in
    both packages; (JAX batches, port batches)."""
    out = []
    for stream, batch, run, clear, output in (
            (JaxStream, JaxBatch, lambda p: JaxLocalRunner(p).run(),
             jax_clear_sink, jax_sink_output),
            (Stream, Batch, lambda p: LocalRunner(p, device="cpu").run(),
             clear_sink, sink_output)):
        clear(sink)
        batches = [batch(t.copy(), {c: v.copy() for c, v in cols.items()})
                   for t, cols in pieces]
        src = stream.source("memory", {"batches": batches}).watermark(
            max_lateness_micros=0)
        run(build(src, sink))
        out.append(output(sink))
    return out


def _aggs(spec_cls, kind_cls, kinds):
    return tuple(spec_cls(getattr(kind_cls, k), None if k == "COUNT"
                          else "v", f"{k.lower()}_v") for k in kinds)


KINDS = ("COUNT", "SUM", "MIN", "MAX", "AVG")


@pytest.mark.parametrize("nulls", [False, True])
def test_non_window_aggregate_rows_match_jax(nulls, monkeypatch):
    """Every batch's CREATE/UPDATE rows, one batch a source batch
    (``ARROYO_COALESCE=0``), over 7 keys and five aggregates; with
    NULLs, one key is NULL throughout (AVG NaN, COUNT 0)."""
    monkeypatch.setenv("ARROYO_COALESCE", "0")
    pieces = _split(*_events(3, nulls=nulls), 5)

    def build(src, sink):
        jax = isinstance(src, JaxStream)
        aggs = (_aggs(JaxAggSpec, JaxAggKind, KINDS) if jax
                else _aggs(AggSpec, AggKind, KINDS))
        return (src.key_by("k").non_window_aggregate(DAY, aggs)
                .sink("memory", {"name": sink}))

    want, got = _both(pieces, build)
    assert sum(len(b) for b in want) > 7
    assert _rows(got) == _rows(want)


def test_non_window_aggregate_create_then_update(monkeypatch):
    """tests/test_windows.py::test_non_window_aggregate in the port."""
    monkeypatch.setenv("ARROYO_COALESCE", "0")
    pieces = [(np.array([100, 200], np.int64),
               {"k": np.array([1, 1], np.int64),
                "v": np.array([10, 20], np.int64)}),
              (np.array([300], np.int64),
               {"k": np.array([1], np.int64), "v": np.array([5], np.int64)})]

    def build(src, sink):
        spec = (JaxAggSpec(JaxAggKind.SUM, "v", "total")
                if isinstance(src, JaxStream)
                else AggSpec(AggKind.SUM, "v", "total"))
        return (src.key_by("k").non_window_aggregate(60 * SEC, [spec])
                .sink("memory", {"name": sink}))

    want, got = _both(pieces, build)
    out = Batch.concat(got)
    assert out.columns["total"].tolist() == [30.0, 35.0]
    assert out.columns["__op"].tolist() == [0, 1]
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("kind", ["count", "SUM", "MAX", "MIN"])
def test_running_count_and_aggregate_match_jax(kind, monkeypatch):
    """``Stream.count()`` and ``Stream.aggregate(...)``: one row a key a
    batch, with the key's running value."""
    monkeypatch.setenv("ARROYO_COALESCE", "0")
    pieces = _split(*_events(11), 4)

    def build(src, sink):
        keyed = src.key_by("k")
        if kind == "count":
            tail = keyed.count()
        else:
            jax = isinstance(src, JaxStream)
            spec = (JaxAggSpec(getattr(JaxAggKind, kind), "v", "r") if jax
                    else AggSpec(getattr(AggKind, kind), "v", "r"))
            tail = keyed.aggregate(spec)
        return tail.sink("memory", {"name": sink})

    want, got = _both(pieces, build)
    assert len(want) == 4 and _rows(got) == _rows(want)


def test_option_map_and_updating_stream_match_jax(monkeypatch):
    """``option_map`` (its ``__valid`` column selects rows) chained and
    unchained, and ``updating`` + ``updating_key`` over the updating
    aggregate's output."""
    monkeypatch.setenv("ARROYO_COALESCE", "0")  # one refinement a batch
    pieces = _split(*_events(5), 3)

    def build(src, sink):
        return (src.option_map(lambda c: {"k": c["k"], "v": c["v"] * 2,
                                          "__valid": c["v"] % 3 != 0},
                               name="opt")
                .key_by("k")
                .non_window_aggregate(DAY, (
                    (JaxAggSpec(JaxAggKind.SUM, "v", "s"),)
                    if isinstance(src, JaxStream)
                    else (AggSpec(AggKind.SUM, "v", "s"),)))
                .updating(lambda c: {"k": c["k"], "s": c["s"],
                                     "__op": c["__op"],
                                     "__valid": c["s"] > 150},
                          name="upd")
                .updating_key("k")
                .sink("memory", {"name": sink}))

    for chain in ("1", "0"):
        monkeypatch.setenv("ARROYO_CHAIN", chain)
        want, got = _both(pieces, build)
        assert _rows(want, net=True)[0]
        assert _rows(got, net=True) == _rows(want, net=True)


# -- operator against operator ------------------------------------------------------


class _State:
    def __init__(self, keyed_cls):
        self.keyed_cls = keyed_cls
        self.tables = {}

    def get_keyed_state(self, name, *_args, **_kw):
        return self.tables.setdefault(name, self.keyed_cls())


class _Ctx:
    def __init__(self, port, last_watermark=None):
        self.state = _State(KeyedState if port else JaxKeyedState)
        self.last_watermark = last_watermark
        self.out = []

    async def collect(self, batch):
        self.out.append(batch)

    async def broadcast(self, msg):
        pass


def _keyed(port, ts, cols, key_cols):
    cls = Batch if port else JaxBatch
    return cls(np.asarray(ts, np.int64), dict(cols),
               hash_columns([cols[c] for c in key_cols]), tuple(key_cols))


def _window_steps():
    """Per-window count rows as q5's unfused plan feeds its maximum:
    (batch columns or a watermark), ends above 2^53 as epoch micros."""
    base = 1_700_000_000_000_000
    rng = np.random.default_rng(17)
    steps = []
    for w in range(6):
        end = base + (w + 1) * 2 * SEC
        for _ in range(2):  # two panes of one window, in two batches
            n = 5
            steps.append({"window_end": np.full(n, end, np.int64),
                          "window_start": np.full(n, end - 10 * SEC,
                                                  np.int64),
                          "num": rng.integers(1, 9, n).astype(np.int64)})
        steps.append(end if w != 2 else end + 3 * SEC)
    # a late pane of an already released window
    steps.insert(-1, {"window_end": np.array([base + 2 * SEC], np.int64),
                      "window_start": np.array([base - 8 * SEC], np.int64),
                      "num": np.array([99], np.int64)})
    return steps


def _flush_op(port):
    spec, kind = (AggSpec, AggKind) if port else (JaxAggSpec, JaxAggKind)
    aggs = (spec(kind.MAX, "num", "maxn"), spec(kind.COUNT, None, "c"))
    if port:
        return NonWindowAggOperator("max_per_window", DAY, aggs,
                                    flush_key="window_end", device="cpu")
    return JaxNonWindow("max_per_window", DAY, aggs, flush_key="window_end")


async def _drive(op, ctx, steps, port):
    for step in steps:
        if isinstance(step, dict):
            await op.process_batch(_keyed(
                port, step["window_end"] - 1, step,
                ("window_end", "window_start")), ctx)
        else:
            await op.handle_watermark(step, ctx)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.timestamp.tolist() == w.timestamp.tolist()
        assert g.key_hash.tolist() == w.key_hash.tolist()
        assert g.key_cols == w.key_cols and sorted(g.columns) == sorted(
            w.columns)
        for c in w.columns:
            assert g.columns[c].dtype == w.columns[c].dtype, c
            assert g.columns[c].tolist() == w.columns[c].tolist(), c


def test_flush_key_aggregate_matches_jax_operator():
    """Each window's final row once, at the watermark that passes it,
    key columns from state; the late pane of a released window drops."""

    async def run(port):
        op, ctx = _flush_op(port), _Ctx(port)
        await op.on_start(ctx)
        await _drive(op, ctx, _window_steps(), port)
        return ctx.out

    want, got = asyncio.run(run(False)), asyncio.run(run(True))
    # window 3's panes arrive after a watermark past its end: dropped
    assert len(want) == 5
    _same_batches(got, want)


def test_group_by_window_flush_is_idempotent():
    """tests/test_windows.py::test_group_by_window_flush_is_idempotent in
    the port: a late re-creation of a released window emits nothing,
    also in an operator restored at the release's watermark."""
    wend = 10_000_000

    def b(nums):
        return Batch(np.full(len(nums), wend - 1, np.int64),
                     {"window_end": np.full(len(nums), wend, np.int64),
                      "num": np.asarray(nums, np.int64)},
                     np.ones(len(nums), np.uint64), ("window_end",))

    async def drive():
        op, ctx = _flush_op(True), _Ctx(True)
        await op.on_start(ctx)
        await op.process_batch(b([5, 7]), ctx)
        await op.handle_watermark(wend, ctx)
        assert len(ctx.out) == 1 and int(ctx.out[0].columns["maxn"][0]) == 7
        await op.process_batch(b([7]), ctx)
        await op.handle_watermark(wend + 2_000_000, ctx)
        assert len(ctx.out) == 1, "late re-creation must not re-emit"
        op2, ctx2 = _flush_op(True), _Ctx(True, last_watermark=wend)
        await op2.on_start(ctx2)
        await op2.process_batch(b([7]), ctx2)
        await op2.handle_watermark(wend + 2_000_000, ctx2)
        assert not ctx2.out, "restored guard must drop late windows"

    asyncio.run(drive())


# -- tables across packages -----------------------------------------------------------


def _ops(port):
    if port:
        return {"u": lambda: NonWindowAggOperator(
                    "agg", DAY, _aggs(AggSpec, AggKind, KINDS),
                    device="cpu"),
                "c": lambda: CountOperator("count"),
                "a": lambda: AggregateOperator(
                    "agg", AggSpec(AggKind.MAX, "v", "r"))}
    return {"u": lambda: JaxNonWindow(
                "agg", DAY, _aggs(JaxAggSpec, JaxAggKind, KINDS)),
            "c": lambda: JaxCount("count"),
            "a": lambda: JaxAggregate("agg",
                                      JaxAggSpec(JaxAggKind.MAX, "v", "r"))}


@pytest.mark.parametrize("table", ["u", "c", "a", "u_flush"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_keyed_tables_restore_across_packages(table, direction):
    """One package runs the first half; its table's ``[(time, key,
    value)]`` entries restore into the other package's operator (with
    the checkpoint's watermark), which runs the rest and emits what it
    emits run straight through."""
    src_port = direction == "port_to_jax"
    if table == "u_flush":
        steps, name = _window_steps(), "u"
        half = 7

        def make(port):
            return _flush_op(port)

        async def feed(op, ctx, part, port):
            await _drive(op, ctx, part, port)
    else:
        ts, cols = _events(23, nulls=table == "u")
        steps, name, half = _split(ts, cols, 6), table, 3

        def make(port):
            return _ops(port)[table]()

        async def feed(op, ctx, part, port):
            for t, c in part:
                await op.process_batch(_keyed(port, t, c, ("k",)), ctx)

    wm = next((s for s in reversed(steps[:half]) if not isinstance(
        s, (dict, tuple))), None)

    async def first():
        op, ctx = make(src_port), _Ctx(src_port)
        await op.on_start(ctx)
        await feed(op, ctx, steps[:half], src_port)
        return ctx

    ctx = asyncio.run(first())
    entries = ctx.state.tables[name].snapshot()
    assert entries

    async def rest():
        op, dctx = make(not src_port), _Ctx(not src_port, last_watermark=wm)
        dctx.state.get_keyed_state(name).restore(entries)
        await op.on_start(dctx)
        await feed(op, dctx, steps[half:], not src_port)
        return dctx

    got = asyncio.run(rest())

    async def straight():
        op, sctx = make(not src_port), _Ctx(not src_port)
        await op.on_start(sctx)
        await feed(op, sctx, steps, not src_port)
        return sctx

    want = asyncio.run(straight())
    _same_batches(got.out, want.out[len(ctx.out):])
    assert sorted(got.state.tables[name].snapshot(), key=repr) == sorted(
        want.state.tables[name].snapshot(), key=repr)


# -- SQL ------------------------------------------------------------------------------


def _providers(tables):
    jp, pp = JaxProvider(), SchemaProvider()
    for name, (kinds, batches) in tables.items():
        jp.add_memory_table(name, kinds, [JaxBatch(
            t.copy(), {k: v.copy() for k, v in c.items()})
            for t, c in batches])
        pp.add_memory_table(name, kinds, [Batch(
            t.copy(), {k: v.copy() for k, v in c.items()})
            for t, c in batches])
    return jp, pp


def _sql_both(tables, sql):
    """``sql`` over ``tables`` planned and run by both packages: (JAX sink
    batches, port sink batches)."""
    jp, pp = _providers(tables)
    jax_clear_sink("results")
    JaxLocalRunner(JaxPlanner(jp).plan(sql)).run()
    clear_sink("results")
    LocalRunner(Planner(pp).plan(sql), device="cpu").run()
    return jax_sink_output("results"), sink_output("results")


def _final(batches, key):
    """The last row each value of ``key`` emitted (columns by name, __op
    dropped): the running aggregate's final value, whichever batches the
    input coalescer merged on the way."""
    last = {}
    for b in batches:
        names = sorted(c for c in b.columns if c != "__op")
        for row in zip(*(b.columns[n].tolist() for n in names)):
            row = tuple(_cell(v) for v in row)
            last[row[names.index(key)]] = row
    return sorted(last.values(), key=repr)


def _events_table(nulls=False):
    ts, cols = _events(29, n=200, n_keys=5, span=4 * SEC, nulls=nulls)
    return {"events": ({"k": "i", "v": "f" if nulls else "i"},
                       _split(ts, cols, 3))}


def _string_table():
    """tests/test_sql.py::test_string_min_max_non_windowed's table, and a
    second key."""
    return {"t": ({"k": "i", "s": "s"}, [
        (np.array([0], np.int64), {"k": np.array([1], np.int64),
                                   "s": np.array([None], dtype=object)}),
        (np.array([1000, 1500], np.int64),
         {"k": np.array([1, 2], np.int64),
          "s": np.array(["b", "x"], dtype=object)}),
        (np.array([2000, 2500], np.int64),
         {"k": np.array([1, 2], np.int64),
          "s": np.array(["a", None], dtype=object)})])}


# (test, tables, SQL, the output's key column)
SQL_SHAPES = [
    ("updating_aggregate_filter", _events_table,
     "SELECT k2 FROM (SELECT count(*) as c, k as k2 FROM events GROUP BY 2)"
     " WHERE c > 30", "k2"),
    ("non_windowed_group_by", _events_table,
     "SELECT k, count(*) AS c, sum(v) AS s, min(v) AS lo, max(v) AS hi, "
     "avg(v) AS a FROM events GROUP BY k", "k"),
    ("non_windowed_group_by_nulls", lambda: _events_table(True),
     "SELECT k, count(v) AS c, sum(v) AS s, avg(v) AS a, max(v) AS hi "
     "FROM events GROUP BY k", "k"),
    ("string_min_max_non_windowed", _string_table,
     "SELECT k, min(s) AS lo, max(s) AS hi FROM t GROUP BY k", "k"),
    ("non_windowed_having", _events_table,
     "SELECT k, sum(v) AS s FROM events GROUP BY k HAVING sum(v) > 900",
     "k"),
]


@pytest.mark.parametrize("name,tables,sql,key", SQL_SHAPES,
                         ids=[s[0] for s in SQL_SHAPES])
def test_updating_sql_rows_match_jax(name, tables, sql, key, monkeypatch):
    """Each key's final row and the column dtypes; with one batch a source
    batch (``ARROYO_COALESCE=0``), every CREATE/UPDATE row.  (Coalesced,
    how many refinements a key emits, and so the dtypes of the first
    ones, follows which batches merge, which follows their arrival times
    (ROADMAP C6): the coalesced runs take a linger far longer than the
    run, so every batch below the target merges until a watermark or the
    end of stream flushes it, in both packages.)"""
    from arroyo_tpu.config import reset_config as jax_reset_config
    from arroyo_tpu_torch.config import reset_config

    with monkeypatch.context() as m:
        m.setenv("COALESCE_LINGER_MICROS", "10000000")
        reset_config(), jax_reset_config()
        want, got = _sql_both(tables(), sql)
    reset_config(), jax_reset_config()
    assert _final(want, key) and _final(got, key) == _final(want, key)
    assert _rows(got)[1] == _rows(want)[1]
    monkeypatch.setenv("ARROYO_COALESCE", "0")
    want, got = _sql_both(tables(), sql)
    assert _rows(got) == _rows(want)


def test_string_min_max_non_windowed_final_refinement():
    """The last refinement of key 1 carries 'a' (an all-NULL first
    segment merges as nothing)."""
    _, pp = _providers(_string_table())
    clear_sink("results")
    LocalRunner(Planner(pp).plan(
        "SELECT k, min(s) AS lo FROM t GROUP BY k"), device="cpu").run()
    vals = [(int(b.columns["k"][i]), b.columns["lo"][i])
            for b in sink_output("results") for i in range(len(b))]
    assert [v for k, v in vals if k == 1][-1] == "a"


# -- q5 as the reference plans it: checkpoint, stop, restore -------------------------


def _q5_unfused(n, batch, sink):
    text = queries.Q5.format(n=n, b=batch).replace(
        f"batch_size = '{batch}'",
        f"batch_size = '{batch}', base_time_micros = '0'").replace(
        "event_rate = '1000000'", "event_rate = '20000'")
    prog = plan_sql(text)
    for node in prog.nodes():
        if node.operator.kind == OpKind.CONNECTOR_SINK:
            node.operator.spec.config["name"] = sink
    return prog


def test_q5_unfused_checkpoint_stop_restore_is_exactly_once(monkeypatch):
    """200,000 events at 20,000 events/s (10 s of event time, five 2 s
    slides of the HOP) under ``ARROYO_ARGMAX=0``: the run checkpointed
    after the source's 12th batch of 8,192, stopped and restored emits
    exactly the rows of an uninterrupted run; the ``flush_key``
    aggregate released windows before the barrier and after it."""
    from arroyo_tpu_torch.config import reset_config

    monkeypatch.setenv("ARROYO_ARGMAX", "0")
    monkeypatch.setenv("COALESCE_LINGER_MICROS", "0")
    reset_config()
    try:
        n, batch, hold_after = 200_000, 8_192, 12
        clear_sink("q5u-ref")
        perf.reset()
        LocalRunner(_q5_unfused(n, batch, "q5u-ref"), device="cpu").run()
        reference = _rows(sink_output("q5u-ref"))[0]
        assert len({r[0] for r in reference}) >= 4
        assert perf.counter("nonwindow_flushes") > 0

        clear_sink("q5u-rt")
        program = _q5_unfused(n, batch, "q5u-rt")
        agg_id = next(nd.operator_id for nd in program.nodes()
                      if nd.operator.kind == OpKind.NON_WINDOW_AGGREGATOR)

        async def phase1():
            engine = Engine(program, "q5u-rt", InMemoryBackend(), device="cpu")
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
            await running.join()
            return engine.members[(agg_id, 0)][0]._released_wm

        released = asyncio.run(phase1())
        before = _rows(sink_output("q5u-rt"))[0]
        assert released is not None and 0 < len(before) < len(reference)

        async def phase2():
            engine = Engine(program, "q5u-rt", InMemoryBackend(),
                            restore_epoch=1, device="cpu")
            await engine.start().join()

        asyncio.run(phase2())
        assert _rows(sink_output("q5u-rt"))[0] == reference
    finally:
        monkeypatch.undo()
        reset_config()  # the linger read again from the restored environment
