"""The port's buffered tumbling/sliding window (``WindowOperator``) and
the global key against arroyo_tpu's, on the CPU:

* ``Stream.window`` over tumbling, sliding and instant windows, with
  aggregates (COUNT, SUM, MIN, MAX, AVG with NULLs, COUNT(DISTINCT)) and
  flat (tests/test_windows.py's generic window tests): sorted sink rows
  equal value for value and dtype for dtype;
* the SQL that plans onto it: COUNT(DISTINCT) over TUMBLE and HOP (NULLs
  not counted), string MIN/MAX per window, a keyless window (the global
  key), a UDAF under ``ARROYO_UDAF_COMPILE=off``;
* q7's highest-bid shape fused (``WindowArgmaxOperator``) and as the
  reference plans it (``ARROYO_ARGMAX=0``: a TTL join of the bids with a
  keyless tumbling maximum), late rows included (tests/test_sql.py's raw
  argmax oracle tests): the same rows in both packages and both plans;
* the BATCH_BUFFER table ``w`` and its timers written by one package
  restore into the other's operator mid-stream.

SUM and AVG are f64 sums over the same rows in the same order on both
sides, so they compare exactly; a UDAF is the same numpy function over
the same rows (exact too)."""

import asyncio
import math
from collections import Counter

import numpy as np
import pytest

from arroyo_tpu import Stream as JaxStream
from arroyo_tpu.config import reset_config as jax_reset_config
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.context import TimerHeap as JaxTimerHeap
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.engine.operators_window import WindowOperator as JaxWindow
from arroyo_tpu.graph.logical import AggKind as JaxAggKind
from arroyo_tpu.graph.logical import AggSpec as JaxAggSpec
from arroyo_tpu.graph.logical import InstantWindow as JaxInstant
from arroyo_tpu.graph.logical import SlidingWindow as JaxSliding
from arroyo_tpu.graph.logical import TumblingWindow as JaxTumbling
from arroyo_tpu.sql import SchemaProvider as JaxProvider
from arroyo_tpu.sql.functions import unregister_udfs as jax_unregister_udfs
from arroyo_tpu.sql.planner import Planner as JaxPlanner
from arroyo_tpu.state.tables import BatchBuffer as JaxBatchBuffer
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch.config import reset_config
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.context import TimerHeap
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.engine.operators_window import WindowOperator
from arroyo_tpu_torch.graph.logical import (AggKind, AggSpec, InstantWindow,
                                            OpKind, SlidingWindow, Stream,
                                            TumblingWindow)
from arroyo_tpu_torch.sql import Planner, SchemaProvider, unregister_udfs
from arroyo_tpu_torch.state.tables import BatchBuffer
from arroyo_tpu_torch.types import Batch, hash_columns

SEC = 1_000_000


def _cell(v):
    return "NaN" if isinstance(v, float) and math.isnan(v) else v


def _rows(batches):
    """(sorted (timestamp, values by column name) rows, column dtypes)."""
    rows, dtypes = [], {}
    for b in batches:
        names = sorted(b.columns)
        for n in names:
            dtypes.setdefault(n, set()).add(str(b.columns[n].dtype))
        cols = [[_cell(v) for v in b.columns[n].tolist()] for n in names]
        rows.extend(zip(b.timestamp.tolist(), *cols))
    return sorted(rows, key=repr), dtypes


def _events(seed=42, n=2000, n_keys=20, span=4 * SEC, nulls=False):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, span, n)).astype(np.int64)
    v = rng.integers(1, 100, n).astype(np.float64 if nulls else np.int64)
    if nulls:
        v[rng.random(n) < 0.15] = np.nan
    return ts, {"k": rng.integers(0, n_keys, n).astype(np.int64), "v": v}


def _pieces(ts, cols, parts=4):
    cuts = np.linspace(0, len(ts), parts + 1).astype(int)
    return [(ts[a:b], {c: v[a:b] for c, v in cols.items()})
            for a, b in zip(cuts, cuts[1:])]


def _stream_both(pieces, build, sink="bw"):
    out = []
    for port in (False, True):
        stream, cls = (Stream, Batch) if port else (JaxStream, JaxBatch)
        clear, output = ((clear_sink, sink_output) if port
                         else (jax_clear_sink, jax_sink_output))
        clear(sink)
        src = stream.source("memory", {"batches": [
            cls(t.copy(), {c: v.copy() for c, v in cols.items()})
            for t, cols in pieces]}).watermark(max_lateness_micros=0)
        prog = build(src, port).sink("memory", {"name": sink})
        if port:
            LocalRunner(prog, device="cpu").run()
        else:
            JaxLocalRunner(prog).run()
        out.append(_rows(output(sink)))
    return out


def _typ(name, port):
    tumbling, sliding, instant = ((TumblingWindow, SlidingWindow,
                                   InstantWindow) if port
                                  else (JaxTumbling, JaxSliding, JaxInstant))
    return {"tumbling": lambda: tumbling(SEC),
            "sliding": lambda: sliding(2 * SEC, 500_000),
            "instant": lambda: instant()}[name]()


AGGS = (("COUNT", None, "cnt"), ("SUM", "v", "total"), ("MIN", "v", "lo"),
        ("MAX", "v", "hi"), ("AVG", "v", "avg_v"),
        ("COUNT_DISTINCT", "v", "dv"))


def _specs(port, aggs=AGGS):
    spec, kind = (AggSpec, AggKind) if port else (JaxAggSpec, JaxAggKind)
    return [spec(getattr(kind, k), c, o) for k, c, o in aggs]


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("typ", ["tumbling", "sliding", "instant"])
def test_window_aggregate_rows_match_jax(typ, nulls):
    """tests/test_windows.py::test_generic_window_aggregate, over three
    window types and every buffered aggregate."""
    n = 300 if typ == "instant" else 2000
    ts, cols = _events(n=n, nulls=nulls)
    if typ == "instant":
        ts = ts // 50_000 * 50_000  # shared instants
    want, got = _stream_both(_pieces(ts, cols), lambda s, port: s.key_by(
        "k").window(_typ(typ, port), _specs(port)))
    assert want[0] and got == want
    if typ == "tumbling" and not nulls:
        assert sum(r[2] for r in got[0]) == n  # (ts, avg_v, cnt, ...)


@pytest.mark.parametrize("typ", ["tumbling", "sliding"])
def test_window_flatten_rows_match_jax(typ):
    """tests/test_windows.py::test_generic_window_flatten: every row once
    a window it falls in, with the window's bounds."""
    ts, cols = _events(n=500, span=2 * SEC)
    want, got = _stream_both(_pieces(ts, cols), lambda s, port: s.key_by(
        "k").window(_typ(typ, port), flatten=True))
    assert got == want
    assert len(got[0]) == 500 * (4 if typ == "sliding" else 1)


def test_keyless_window_through_the_global_key_matches_jax():
    """``global_key`` then a window: every row under one key."""
    ts, cols = _events()
    want, got = _stream_both(_pieces(ts, cols), lambda s, port: s.global_key(
    ).window(_typ("tumbling", port), _specs(port, AGGS[:2])))
    assert len(want[0]) == 4 and got == want


# -- SQL ---------------------------------------------------------------------------


def _providers(tables, udafs=()):
    jp, pp = JaxProvider(), SchemaProvider()
    for name, (kinds, batches) in tables.items():
        jp.add_memory_table(name, kinds, [JaxBatch(
            t.copy(), {k: v.copy() for k, v in c.items()})
            for t, c in batches])
        pp.add_memory_table(name, kinds, [Batch(
            t.copy(), {k: v.copy() for k, v in c.items()})
            for t, c in batches])
    for name, fn in udafs:
        jp.register_udaf(name, fn)
        pp.register_udaf(name, fn)
    return jp, pp


def _sql_both(tables, sql, udafs=()):
    unregister_udfs()
    jax_unregister_udfs()
    try:
        jp, pp = _providers(tables, udafs)
        jprog, prog = JaxPlanner(jp).plan(sql), Planner(pp).plan(sql)
    finally:
        unregister_udfs()
        jax_unregister_udfs()
    jax_clear_sink("results")
    JaxLocalRunner(jprog).run()
    clear_sink("results")
    LocalRunner(prog, device="cpu").run()
    kinds = [prog.node(n).operator.kind for n in prog.topo_order()]
    return (_rows(jax_sink_output("results")),
            _rows(sink_output("results")), kinds)


def _distinct_table():
    """tests/test_sql.py::test_exec_count_distinct's table."""
    ts = np.arange(6, dtype=np.int64) * 100
    return {"t": ({"k": "i", "x": "i"}, [(ts, {
        "k": np.array([1, 1, 1, 2, 2, 2], np.int64),
        "x": np.array([5, 5, 6, 7, 8, 9], np.int64)})])}


def _null_distinct_table():
    """tests/test_sql.py::test_count_distinct_excludes_nulls's table."""
    ts = np.arange(6, dtype=np.int64) * 1000
    return {"t": ({"k": "i", "v": "f"}, [(ts, {
        "k": np.zeros(6, np.int64),
        "v": np.array([1.0, 2.0, np.nan, 2.0, np.nan, 3.0])})])}


def _events_table(nulls=False):
    ts, cols = _events(seed=29, n=400, n_keys=6, nulls=nulls)
    cols["s"] = np.array([None if i % 11 == 0 else f"s{i % 17:02d}"
                          for i in range(len(ts))], dtype=object)
    return {"events": ({"k": "i", "v": "f" if nulls else "i", "s": "s"},
                       _pieces(ts, cols, 3))}


SQL_SHAPES = [
    ("count_distinct", _distinct_table,
     "SELECT k, count(distinct x) as dx FROM t "
     "GROUP BY k, tumble(interval '1 second')", {(1, 2), (2, 3)}),
    ("count_distinct_excludes_nulls", _null_distinct_table, """
    SELECT k, TUMBLE(INTERVAL '1' SECOND) AS window,
           count(DISTINCT v) AS d, count(v) AS c, count(*) AS s
    FROM t GROUP BY 1, 2""", None),
    ("count_distinct_hop", _events_table, """
    SELECT k, HOP(INTERVAL '1' SECOND, INTERVAL '2' SECOND) AS window,
           count(DISTINCT v) AS d, sum(v) AS s FROM events GROUP BY 1, 2""",
     None),
    ("count_distinct_keyless_nulls", lambda: _events_table(True), """
    SELECT TUMBLE(INTERVAL '1' SECOND) AS window, count(DISTINCT v) AS d,
           avg(v) AS a, count(*) AS n FROM events GROUP BY 1""", None),
    ("string_min_max_windowed", _events_table, """
    SELECT k, TUMBLE(INTERVAL '2' SECOND) AS window, min(s) AS lo,
           max(s) AS hi, count(s) AS c FROM events GROUP BY 1, 2""", None),
]


@pytest.mark.parametrize("name,tables,sql,expect", SQL_SHAPES,
                         ids=[s[0] for s in SQL_SHAPES])
def test_buffered_window_sql_rows_match_jax(name, tables, sql, expect):
    want, got, kinds = _sql_both(tables(), sql)
    assert OpKind.WINDOW in kinds
    assert want[0] and got == want
    if expect is not None:
        # (k, dx): the rows' columns by name are dx, k, window bounds
        assert {(r[2], r[1]) for r in got[0]} == expect
    if name == "count_distinct_excludes_nulls":
        (row,) = got[0]
        assert (row[1], row[2], row[4]) == (4, 3, 6)  # c, d, k, s


def test_udaf_compile_off_plans_the_buffered_window(monkeypatch):
    """tests/test_udf.py::test_planner_udaf_compile_knob_forces_generic:
    ``ARROYO_UDAF_COMPILE=off`` keeps ``my_var`` (np.var) on the buffered
    window in both packages, with equal rows; on, both plan it onto the
    binned aggregate."""
    sql = ("CREATE TABLE out WITH (connector='memory', name='results');"
           "INSERT INTO out SELECT k, my_var(v) as vv FROM events "
           "GROUP BY k, tumble(interval '1 second')")
    monkeypatch.setenv("ARROYO_UDAF_COMPILE", "off")
    want, got, kinds = _sql_both(_events_table(), sql, [("my_var", np.var)])
    assert OpKind.WINDOW in kinds and want[0] and got == want
    monkeypatch.delenv("ARROYO_UDAF_COMPILE")
    _, _, kinds_on = _sql_both(_events_table(), sql, [("my_var", np.var)])
    assert OpKind.WINDOW not in kinds_on


# -- q7's shape, fused and as the reference plans it ----------------------------------


def _raw_bids():
    """tests/test_sql.py::test_raw_argmax_fusion_memory_table_oracle's
    table: 4,000 bids over 25 s, prices 1-59 (many ties)."""
    rng = np.random.default_rng(11)
    n = 4000
    ts = np.sort(rng.integers(0, 25 * SEC, n)).astype(np.int64)
    return {"rawbids": ({"auction": "i", "price": "i", "datetime": "t"},
                        [(ts, {"auction": rng.integers(0, 40, n),
                               "price": rng.integers(1, 60, n),
                               "datetime": ts.copy()})], "datetime")}


def _late_bids():
    """tests/test_sql.py::test_raw_argmax_late_rows_match_final_extremum's
    table: late rows tying and missing a released maximum."""
    b1 = (np.array([1 * SEC, 12 * SEC], np.int64),
          {"a": np.array([1, 2], np.int64), "v": np.array([9.0, 3.0]),
           "et": np.array([1 * SEC, 12 * SEC], np.int64)})
    b2 = (np.array([5 * SEC, 6 * SEC, 13 * SEC], np.int64),
          {"a": np.array([3, 5, 4], np.int64), "v": np.array([9.0, 8.0, 3.0]),
           "et": np.array([5 * SEC, 6 * SEC, 13 * SEC], np.int64)})
    return {"lb": ({"a": "i", "v": "f", "et": "t"}, [b1, b2], "et")}


RAW_Q7 = {
    "rawbids": (_raw_bids, """
    SELECT B.auction as auction, B.price as price
    FROM rawbids B
    JOIN (
      SELECT max(price) AS mx, TUMBLE(INTERVAL '10' SECOND) as window
      FROM rawbids GROUP BY 2
    ) AS M
    ON B.price = M.mx
    WHERE B.datetime >= M.window_start AND B.datetime < M.window_end"""),
    "late_rows": (_late_bids, """
    SELECT B.a AS a, B.v AS v
    FROM lb B
    JOIN (
      SELECT max(v) AS mx, TUMBLE(INTERVAL '10' SECOND) AS window
      FROM lb GROUP BY 2
    ) AS M
    ON B.v = M.mx
    WHERE B.et >= M.window_start AND B.et < M.window_end"""),
}


def _et_providers(tables):
    jp, pp = JaxProvider(), SchemaProvider()
    for name, (kinds, batches, et) in tables.items():
        for prov, cls in ((jp, JaxBatch), (pp, Batch)):
            prov.add_memory_table(name, kinds, [cls(
                t.copy(), {k: v.copy() for k, v in c.items()})
                for t, c in batches], event_time_field=et)
    return jp, pp


@pytest.fixture
def pin_late_rows(request):
    """``COALESCE_LINGER_MICROS=0`` in both packages for the ``late_rows``
    case only; every other case runs at the default linger."""
    if request.getfixturevalue("name") != "late_rows":
        yield
        return
    mp = pytest.MonkeyPatch()
    mp.setenv("COALESCE_LINGER_MICROS", "0")
    reset_config(), jax_reset_config()
    yield
    mp.undo()
    reset_config(), jax_reset_config()


@pytest.mark.parametrize("name", sorted(RAW_Q7))
def test_q7_shape_fused_and_unfused_match_jax(name, monkeypatch,
                                              pin_late_rows):
    """The fused plan's rows (ARROYO_ARGMAX on) equal the unfused plan's
    (a TTL join with the keyless tumbling maximum) in the port, and each
    equals the JAX package's.

    A joined row is stamped with the probing batch's latest time, so the
    unfused plan's stamp of a late row follows which join input reaches
    the join first: the tumbling maximum or the late rows (ROADMAP C6,
    in both packages).  So ``late_rows`` runs with no coalescing linger:
    no wall-clock deadline decides its interleaving, and both packages
    run the same one.  ``rawbids`` is steady at the default linger."""
    tables, sql = RAW_Q7[name]
    out = {}
    for fused in ("1", "0"):
        monkeypatch.setenv("ARROYO_ARGMAX", fused)
        jp, pp = _et_providers(tables())
        prog = Planner(pp).plan(sql)
        kinds = {prog.node(n).operator.kind for n in prog.topo_order()}
        assert (OpKind.WINDOW_ARGMAX in kinds) == (fused == "1")
        assert (OpKind.GLOBAL_KEY in kinds) == (fused == "0")
        jax_clear_sink("results")
        JaxLocalRunner(JaxPlanner(jp).plan(sql)).run()
        clear_sink("results")
        LocalRunner(prog, device="cpu").run()
        got = _rows(sink_output("results"))
        assert got == _rows(jax_sink_output("results"))
        out[fused] = sorted(r[1:] for r in got[0])
    assert out["1"] == out["0"] and out["0"]
    if name == "late_rows":
        assert (3, 9.0) in out["0"] and (5, 8.0) not in out["0"]


# -- the w table across packages ------------------------------------------------------


class _State:
    def __init__(self, buffer_cls):
        self.buffer_cls = buffer_cls
        self.tables = {}

    def get_batch_buffer(self, name, *_args, **_kw):
        return self.tables.setdefault(name, self.buffer_cls())


class _Ctx:
    def __init__(self, port):
        self.state = _State(BatchBuffer if port else JaxBatchBuffer)
        self.timers = TimerHeap() if port else JaxTimerHeap()
        self.out = []

    async def collect(self, batch):
        self.out.append(batch)


def _window_op(port):
    if port:
        return WindowOperator("w", SlidingWindow(2 * SEC, SEC),
                              tuple(_specs(True)), False, device="cpu")
    return JaxWindow("w", JaxSliding(2 * SEC, SEC), tuple(_specs(False)),
                     False)


async def _drive(op, ctx, steps, port):
    cls = Batch if port else JaxBatch
    for step in steps:
        if isinstance(step, tuple):
            ts, cols = step
            await op.process_batch(cls(ts, dict(cols), hash_columns(
                [cols["k"]]), ("k",)), ctx)
        else:
            for t, key, payload in ctx.timers.fire(step):
                await op.handle_timer(t, key, payload, ctx)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_window_buffer_restores_across_packages(direction):
    """The ``w`` buffer's batch and the operator's timers written by one
    package restore into the other's operator, which then emits what it
    emits run straight through."""
    ts, cols = _events(seed=5, n=800, span=6 * SEC, nulls=True)
    steps = []
    for (t, c), wm in zip(_pieces(ts, cols, 6), range(1, 7)):
        steps += [(t, c), wm * SEC]
    half = 6
    src_port = direction == "port_to_jax"

    async def run(port, part, ctx=None):
        ctx = ctx or _Ctx(port)
        op = _window_op(port)
        await op.on_start(ctx)
        await _drive(op, ctx, part, port)
        return ctx

    first = asyncio.run(run(src_port, steps[:half]))
    snap = first.state.tables["w"].snapshot_batch()
    timers = first.timers.snapshot()
    assert len(snap) and timers
    dst = _Ctx(not src_port)
    cls = JaxBatch if src_port else Batch
    dst.state.get_batch_buffer("w").restore_batch(cls(
        snap.timestamp, dict(snap.columns), snap.key_hash, snap.key_cols))
    dst.timers.restore(timers)
    got = asyncio.run(run(not src_port, steps[half:], dst))
    want = asyncio.run(run(not src_port, steps))
    assert _rows(got.out) == _rows(want.out[len(first.out):])
    assert Counter(len(b) for b in got.out) == Counter(
        len(b) for b in want.out[len(first.out):])


def test_global_key_chains_as_a_member_not_a_spine_step():
    """In a chain the global key is a member of its own (its batches keep
    their rows and get key hash 0), never folded into the host spine's
    elementwise step."""
    from arroyo_tpu_torch.engine.chained import ChainedOperator, _SpineStep
    from arroyo_tpu_torch.engine.operators_basic import GlobalKeyOperator

    ts, cols = _events(n=200)
    prog = (Stream.source("memory", {"batches": [Batch(ts, cols)]})
            .watermark(max_lateness_micros=0)
            .map(lambda c: {"v": c["v"]}, name="m").global_key()
            .window(TumblingWindow(SEC), _specs(True, AGGS[:1]))
            .sink("memory", {"name": "gk"}))
    clear_sink("gk")
    runner = LocalRunner(prog, device="cpu")
    runner.run()
    chains = [h.runner.operator for h in runner.engine.subtasks.values()
              if isinstance(h.runner.operator, ChainedOperator)]
    (chain,) = [c for c in chains if any(
        isinstance(m, GlobalKeyOperator) for m in c.members)]
    steps = [step for step, _ in chain._step_by_start.values()]
    assert any(isinstance(st, GlobalKeyOperator) for st in steps)
    assert not any(isinstance(st, _SpineStep) and any(
        op is m for _k, op in st.plan for m in chain.members
        if isinstance(m, GlobalKeyOperator)) for st in steps)
    assert sum(int(x) for b in sink_output("gk")
               for x in b.columns["cnt"].tolist()) == 200
