"""SQL queries planned by the port and run by its engine against the same
SQL planned and run by arroyo_tpu, on the CPU: the sorted sink rows are
equal, value for value and column dtype for column dtype (NaN and None
NULLs in the same cells; updating outputs compared as their net rows).

* bench.py's Q1, Q5, Q7 and Q8 and the hot-items SQL at 200,000 events,
  and CONFIG5_SQL (with ``median`` as a UDAF) at 100,000;
* the shapes of tests/test_sql.py whose plans use only ported operators,
  over the same in-memory tables: projection and filter, tumbling GROUP
  BY, CASE inside COUNT, AVG/MIN/MAX, the string function library,
  inner, right, full and windowed left joins, nullable bool predicates,
  the ROW_NUMBER TopN, calendar date functions, q7's highest bid,
  absolute int64 micros, division and modulo by zero, NULL join keys,
  scalar function edges, string NULLs, and EXTRACT with constant
  predicates, the keyless windowed aggregates (the global key), q7's
  highest bid over a table without an event-time field (the join and
  its keyless maximum), the updating GROUP BY without a window, UNION
  ALL and COUNT(DISTINCT), the semi join (``IN (SELECT ...)``) and a
  three-way join on one key (the multi-way join);
* bench.py's Q5 and Q7 under ``ARROYO_ARGMAX=0``, as the reference plans
  them (q5 a self-join of its HOP count with the per-window maximum, q7
  a join of the bids with a keyless tumbling maximum): the JAX
  package's rows and the port's fused rows;
* the JAX tests' factor-window pair (two HOP aggregates of one table on
  one shared pane ring): the JAX package's rows and the port's
  unfactored rows."""

import datetime as dtm
import math
from collections import Counter

import numpy as np
import pytest

import bench
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.sql import SchemaProvider as JaxProvider
from arroyo_tpu.sql import plan_sql as jax_plan_sql
from arroyo_tpu.sql.functions import register_udaf as jax_register_udaf
from arroyo_tpu.sql.functions import unregister_udfs as jax_unregister_udfs
from arroyo_tpu.sql.planner import Planner as JaxPlanner
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch import queries
from arroyo_tpu_torch.config5 import config5_produce
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.hot_items import hot_items_sql
from arroyo_tpu_torch.sql import (Planner, SchemaProvider,
                                  plan_sql, register_udaf, unregister_udfs)
from arroyo_tpu_torch.types import Batch

SEC = 1_000_000


def _cell(v):
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, (list, tuple)):
        return tuple(_cell(x) for x in v)
    return v


def _rows(batches, net=False):
    """(sorted rows, {column: dtypes seen}); rows are (timestamp, values
    in column-name order); with ``net`` the __op retractions apply."""
    rows, dtypes = Counter(), {}
    for b in batches:
        names = sorted(c for c in b.columns if not (net and c == "__op"))
        for n in names:
            dtypes.setdefault(n, set()).add(str(b.columns[n].dtype))
        cols = [[_cell(v) for v in b.columns[n].tolist()] for n in names]
        ops = (b.columns["__op"].tolist() if net and "__op" in b.columns
               else [0] * len(b))
        ts = b.timestamp.tolist() if not net else [None] * len(b)
        for row, op in zip(zip(ts, *cols), ops):
            rows[row] += -1 if int(op) == 2 else 1
    out = sorted((r for r, c in rows.items() for _ in range(c)), key=repr)
    assert all(c >= 0 for c in rows.values())
    return out, dtypes


def _run_jax(prog, net=False, sink="results"):
    jax_clear_sink(sink)
    JaxLocalRunner(prog).run()
    return _rows(jax_sink_output(sink), net)


def _run_port(prog, net=False, sink="results"):
    clear_sink(sink)
    LocalRunner(prog, device="cpu").run()
    return _rows(sink_output(sink), net)


def _both(tables, sql, net=False):
    """Plan and run ``sql`` over in-memory ``tables`` ({name: (kinds,
    timestamps, columns)}) in both packages; return both row sets."""
    jp, pp = _providers(tables)
    return (_run_jax(JaxPlanner(jp).plan(sql), net),
            _run_port(Planner(pp).plan(sql), net))


def _providers(tables):
    """Both packages' schema providers over in-memory ``tables`` ({name:
    (kinds, timestamps, columns[, event-time field])})."""
    jp, pp = JaxProvider(), SchemaProvider()
    for name, (kinds, ts, cols, *et) in tables.items():
        et = et[0] if et else None
        jp.add_memory_table(name, kinds, [JaxBatch(
            ts.copy(), {k: v.copy() for k, v in cols.items()})],
            event_time_field=et)
        pp.add_memory_table(name, kinds, [Batch(
            ts.copy(), {k: v.copy() for k, v in cols.items()})],
            event_time_field=et)
    return jp, pp


@pytest.fixture
def jax_like_port(monkeypatch):
    """The JAX package on one device (no mesh state), its host library
    on its default, as the port's."""
    monkeypatch.setenv("ARROYO_MESH", "off")


def _pinned(sql, n, b):
    return sql.format(n=n, b=b).replace(
        f"batch_size = '{b}'", f"batch_size = '{b}', base_time_micros = '0'")


@pytest.mark.parametrize("query", ["q1", "q5", "q7", "q8", "hot_items",
                                   "q5_unfused", "q7_unfused", "q16",
                                   "q1_union"])
def test_nexmark_query_rows_match_jax(query, jax_like_port, monkeypatch):
    """200,000 events in batches of 16,384, event time from 0; q5 and q7
    also as the reference plans them (``ARROYO_ARGMAX=0``), whose rows
    equal the fused plans' too; q16's channel statistics (the buffered
    window) and q1 as a UNION ALL of two price ranges."""
    n, b = 200_000, 16_384
    base = query.replace("_unfused", "")
    texts = dict(queries.QUERIES, q16=queries.Q16, q1_union=queries.Q1_UNION)
    sql = (_pinned(hot_items_sql(n, b), n, b) if query == "hot_items"
           else _pinned(texts[base], n, b))
    fused = _run_port(plan_sql(sql)) if base != query else None
    if fused is not None:
        monkeypatch.setenv("ARROYO_ARGMAX", "0")
    want = _run_jax(jax_plan_sql(sql))
    got = _run_port(plan_sql(sql))
    assert want[0] and got == want
    if fused is not None:
        assert got == fused


@pytest.mark.parametrize("query", ["q1", "q5", "q7", "q8", "hot_items"])
def test_chained_sql_expressions_stay_on_the_host(query, monkeypatch):
    """Chained, the ingest spine evaluates every SQL expression on the
    host (``eval_host``), as the JAX package's spine does; one runner per
    operator sends them through ``CompiledExpr.__call__``, the
    expression device's path."""
    from arroyo_tpu_torch.ops import expr as port_expr

    calls = Counter()
    call = port_expr.CompiledExpr.__call__

    def counted(self, batch):
        calls[self.sql] += 1
        return call(self, batch)

    monkeypatch.setattr(port_expr.CompiledExpr, "__call__", counted)
    n, b = 50_000, 8_192
    sql = (_pinned(hot_items_sql(n, b), n, b) if query == "hot_items"
           else _pinned(queries.QUERIES[query], n, b))
    chained = _run_port(plan_sql(sql))
    assert chained[0] and calls[True] == 0
    monkeypatch.setenv("ARROYO_CHAIN", "0")
    monkeypatch.setenv("ARROYO_COALESCE", "0")
    assert _run_port(plan_sql(sql)) == chained and calls[True] > 0


def test_config5_rows_match_jax():
    """100,000 events of bench.py's producer through the JSON Kafka
    source, 1 s session windows, ``median`` as a UDAF in both packages."""
    n = 100_000
    sql = queries.CONFIG5_SQL.format(n=n, b=4_096)
    unregister_udfs()
    jax_unregister_udfs()
    try:
        register_udaf("median", np.median)
        jax_register_udaf("median", np.median)
        jprog, prog = jax_plan_sql(sql), plan_sql(sql)
    finally:
        unregister_udfs()
        jax_unregister_udfs()
    bench._config5_produce("bench5", n, 0, 10)
    want = _run_jax(jprog)
    config5_produce("bench5", n, 0, 10)
    got = _run_port(prog)
    assert len(want[0]) == 1024 and got == want


def _events():
    rng = np.random.default_rng(7)
    n = 200
    ts = np.sort(rng.integers(0, 4 * SEC, n)).astype(np.int64)
    return {"events": ({"k": "i", "v": "i", "name": "s"}, ts, {
        "k": rng.integers(0, 5, n).astype(np.int64),
        "v": rng.integers(1, 50, n).astype(np.int64),
        "name": np.array([f"name{i % 3}" for i in range(n)], dtype=object),
    })}


def _join_tables(r_ids=(1, 2), r_vals=(111, 222)):
    return {
        "l": ({"id": "i", "lv": "i"}, np.array([100, 200, 300], np.int64),
              {"id": np.array([1, 2, 3], np.int64),
               "lv": np.array([10, 20, 30], np.int64)}),
        "r": ({"id": "i", "rv": "i"}, np.array([150, 250], np.int64),
              {"id": np.array(r_ids, np.int64),
               "rv": np.array(r_vals, np.int64)}),
    }


def _strings():
    return {"s": ({"t": "s", "j": "s"}, np.arange(3, dtype=np.int64) * 100, {
        "t": np.array(["hello world", "Abc", "x"], dtype=object),
        "j": np.array(['{"a": {"b": 5}}', '{"a": {"b": "str"}}', 'nope'],
                      dtype=object)})}


def _calendar():
    days = [dtm.datetime(2023, 1, 1), dtm.datetime(2023, 3, 31),
            dtm.datetime(2024, 2, 29), dtm.datetime(2024, 12, 31),
            dtm.datetime(2021, 7, 4, 13, 45, 59)]
    micros = np.array([int(d.replace(tzinfo=dtm.timezone.utc).timestamp()
                           * 1e6) for d in days], dtype=np.int64)
    return {"t": ({"ts_col": "t"}, np.arange(5, dtype=np.int64),
                  {"ts_col": micros})}


def _bids(n=4000):
    rng = np.random.default_rng(23)
    ts = np.sort(rng.integers(0, 6 * SEC, n)).astype(np.int64)
    return {"bids": ({"auction": "i"}, ts,
                     {"auction": rng.integers(0, 30, n).astype(np.int64)})}


def _q7_bids(event_time=False):
    rng = np.random.default_rng(4)
    n = 8000
    ts = np.sort(np.random.default_rng(9).integers(
        0, 25 * SEC, n)).astype(np.int64)
    return {"bids": ({"auction": "i", "price": "i", "bidder": "i",
                      "datetime": "t"}, ts,
                     {"auction": rng.integers(0, 50, n),
                      "price": rng.integers(1, 1000, n),
                      "bidder": rng.integers(0, 100, n),
                      "datetime": ts.copy()},
                     "datetime" if event_time else None)}


def _null_keys():
    ts = np.array([0, 1000, 2000], dtype=np.int64)
    return {"l": ({"a": "f", "x": "i"}, ts,
                  {"a": np.array([1.0, np.nan, 3.0]),
                   "x": np.array([10, 11, 12], np.int64)}),
            "r": ({"a": "f", "y": "i"}, ts,
                  {"a": np.array([np.nan, 3.0, 4.0]),
                   "y": np.array([20, 21, 22], np.int64)})}


def _windowed_pair():
    return {"a": ({"u": "i"}, np.array([1 * SEC, 2 * SEC], np.int64),
                  {"u": np.array([1, 2], np.int64)}),
            "b": ({"s": "i"}, np.array([1 * SEC + 1000], np.int64),
                  {"s": np.array([1], np.int64)})}


def _flags():
    n = 9
    return {"flags": ({"flag": "b", "v": "i"},
                      np.arange(n, dtype=np.int64) * SEC,
                      {"flag": np.array([True, False, None, True, None, False,
                                         True, True, None], dtype=object),
                       "v": np.arange(n, dtype=np.int64)})}


def _big_ids():
    big = np.array([1_700_000_000_000_000 + i for i in (1, 2, 3)], np.int64)
    return {"s": ({"id": "i", "dt": "t"}, big,
                  {"id": np.array([2**40 + 7, 2**33, 5], np.int64),
                   "dt": big.copy()})}


def _divisions():
    return {"t": ({"a": "i", "b": "i"}, np.arange(6, dtype=np.int64) * 1000,
                  {"a": np.array([10, 10, -7, -7, 10, 7], np.int64),
                   "b": np.array([4, 0, 2, -2, -2, 2], np.int64)})}


def _string_nulls():
    return {"t": ({"v": "f", "s": "s"}, np.arange(3, dtype=np.int64) * 1000,
                  {"v": np.array([1.5, np.nan, -2.5]),
                   "s": np.array(["abc", None, "xbc"], dtype=object)})}


def _extract_table():
    base = 1_700_000_000_000_000
    return {"t": ({"k": "i"}, np.array([base, base + 2_500_000], np.int64),
                  {"k": np.array([1, 2], np.int64)})}


# (test_sql.py test, tables, SQL, net rows): one case per statement
SHAPES = [
    ("projection_filter", _events,
     "SELECT k, v * 2 as v2 FROM events WHERE v > 25", False),
    ("tumbling_group_by", _events,
     "SELECT k, count(*) as cnt, sum(v) as total FROM events "
     "GROUP BY k, tumble(interval '1 second')", False),
    ("case_count_keyed", _events,
     "SELECT k, count(case when v > 25 then 1 else null end) as big, "
     "count(*) as total FROM events "
     "GROUP BY k, tumble(interval '2 second')", False),
    ("avg_min_max", _events,
     "SELECT k, avg(v) as a, min(v) as lo, max(v) as hi FROM events "
     "GROUP BY k, tumble(interval '4 second')", False),
    ("string_function_parity", _strings,
     "SELECT initcap(t) as ic, left(t, 3) as l3, right(t, 2) as r2, "
     "lpad(t, 5, '*') as lp, strpos(t, 'l') as sp, ascii(t) as asc, "
     "octet_length(t) as ol, bit_length(t) as bl, "
     "translate(t, 'lo', 'LO') as tr, sha512(t) as h FROM s", False),
    ("string_function_parity_json", _strings,
     "SELECT extract_json_string(j, '$.a.b') as v, "
     "get_json_objects(j, '$.a') as o, right(t, 0) as r0 FROM s", False),
    ("join", lambda: _join_tables((2, 3), (200, 300)),
     "SELECT l.id as id, l.lv as lv, r.rv as rv FROM l "
     "JOIN r ON l.id = r.id", False),
    ("right_join", lambda: _join_tables((2, 4), (222, 444)),
     "SELECT l.id as lid, r.id as rid, lv, rv FROM l "
     "RIGHT JOIN r ON l.id = r.id", True),
    ("full_join", lambda: _join_tables((2, 4), (222, 444)),
     "SELECT l.id as lid, r.id as rid, lv, rv FROM l "
     "FULL JOIN r ON l.id = r.id", True),
    ("windowed_left_join_pads_appended", _windowed_pair, """
      SELECT P.u as u, P.np as np, A.na as na
      FROM (SELECT u, TUMBLE(INTERVAL '1' SECOND) as window, count(*) as np
            FROM a GROUP BY 1, 2) AS P
      LEFT JOIN (SELECT s, TUMBLE(INTERVAL '1' SECOND) as window,
                        count(*) as na
                 FROM b GROUP BY 1, 2) AS A
      ON P.u = A.s and P.window = A.window""", False),
    ("nullable_bool_predicate", _flags,
     "SELECT v FROM flags WHERE flag = TRUE", False),
    ("nullable_bool_projection", _flags,
     "SELECT v, flag, NOT flag AS nf, flag AND v > 3 AS fv FROM flags",
     False),
    ("row_number_topn_canonical_q5", _bids, """
        CREATE TABLE out WITH (connector='memory', name='results');
        INSERT INTO out
        SELECT auction, num, window FROM (
          SELECT B1.auction, count(*) AS num,
                 HOP(INTERVAL '2' SECOND, INTERVAL '4' SECOND) as window,
                 ROW_NUMBER() OVER (PARTITION BY window
                                    ORDER BY num DESC) as rn
          FROM bids B1 GROUP BY 1, 3
        ) WHERE rn <= 3""", False),
    ("calendar_datetime_functions", _calendar,
     "SELECT date_trunc('month', ts_col) as tm, "
     "date_trunc('quarter', ts_col) as tq, "
     "date_trunc('year', ts_col) as ty, "
     "extract('year', ts_col) as y, extract('month', ts_col) as mo, "
     "extract('day', ts_col) as d, extract('doy', ts_col) as doy, "
     "extract('quarter', ts_col) as q, extract('week', ts_col) as w "
     "FROM t", False),
    ("canonical_q7_highest_bid_event_time", lambda: _q7_bids(True), """
    SELECT B.auction as auction, B.price as price, B.bidder as bidder
    FROM bids B
    JOIN (
      SELECT max(price) AS maxprice, TUMBLE(INTERVAL '10' SECOND) as window
      FROM bids GROUP BY 2
    ) AS M
    ON B.price = M.maxprice
    WHERE B.datetime >= M.window_start AND B.datetime < M.window_end""",
     False),
    ("absolute_micros_int64_exact", _big_ids,
     "SELECT id, dt, id + 1 as id1 FROM s", False),
    ("division_modulo_semantics", _divisions,
     "SELECT a / b AS q, a % b AS r FROM t", False),
    ("null_join_keys_inner", _null_keys,
     "SELECT l.x AS x, r.y AS y FROM l JOIN r ON l.a = r.a", False),
    ("null_join_keys_left", _null_keys,
     "SELECT l.x AS x, r.y AS y FROM l LEFT JOIN r ON l.a = r.a", True),
    ("null_join_keys_right", _null_keys,
     "SELECT l.x AS x, r.y AS y FROM l RIGHT JOIN r ON l.a = r.a", True),
    ("null_join_keys_full", _null_keys,
     "SELECT l.x AS x, r.y AS y FROM l FULL JOIN r ON l.a = r.a", True),
    ("scalar_fn_null_and_edge_semantics", _events, """
      SELECT factorial(21) as fo, factorial(3) as f3,
             to_hex(-1) as h1, to_hex(-255) as h255,
             concat_ws(name, 'L', 'R') as cw,
             concat_ws(nullif('x', 'x'), 'L', 'R') as cwn
      FROM events WHERE k >= 0""", False),
    ("string_nulls_eq", _string_nulls, "SELECT v FROM t WHERE s = s", False),
    ("string_nulls_like", _string_nulls,
     "SELECT s LIKE 'a%' AS a FROM t", False),
    ("string_nulls_upper", _string_nulls, "SELECT upper(s) AS u FROM t",
     False),
    ("string_nulls_is_null", _string_nulls,
     "SELECT s FROM t WHERE s IS NULL", False),
    ("string_nulls_cast", _string_nulls,
     "SELECT CAST(v AS BIGINT) AS a FROM t", False),
    ("extract_from_window_end_keyed", _extract_table, """
    SELECT extract(minute FROM window_end) AS m, count(*) AS c
    FROM t GROUP BY k, TUMBLE(INTERVAL '1' MINUTE)""", False),
    ("constant_predicate_true", _extract_table,
     "SELECT k FROM t WHERE date_trunc('minute', now()) > "
     "now() - INTERVAL '1' HOUR", False),
    ("constant_predicate_false", _extract_table,
     "SELECT k FROM t WHERE now() < now() - INTERVAL '1' HOUR", False),
    # keyless windowed aggregates: the global key
    ("case_count", _events,
     "SELECT count(case when v > 25 then 1 else null end) as big, "
     "count(*) as total FROM events GROUP BY tumble(interval '2 second')",
     False),
    ("extract_from_form", _extract_table, """
    SELECT extract(minute FROM window_end) AS m, count(*) AS c
    FROM t GROUP BY TUMBLE(INTERVAL '1' MINUTE)""", False),
    # without an event-time field the raw argmax fusion cannot prove the
    # window bounds: the plan keeps the TTL join and its max side's
    # keyless tumbling aggregate
    ("canonical_q7_highest_bid", _q7_bids, """
    SELECT B.auction as auction, B.price as price, B.bidder as bidder
    FROM bids B
    JOIN (
      SELECT max(price) AS maxprice, TUMBLE(INTERVAL '10' SECOND) as window
      FROM bids GROUP BY 2
    ) AS M
    ON B.price = M.maxprice
    WHERE B.datetime >= M.window_start AND B.datetime < M.window_end""",
     False),
    # the semi join and the multi-way join
    ("in_subquery", _events,
     "SELECT k, v FROM events WHERE k IN (SELECT k FROM events "
     "WHERE v > 40)", False),
    ("three_way_join", _events, """
    SELECT X.k AS k, X.v AS a, Y.v AS b, Z.v AS c
    FROM events X JOIN events Y ON X.k = Y.k
    JOIN events Z ON X.k = Z.k""", False),
]


EMPTY = {"constant_predicate_false"}  # the shape emits no row


@pytest.mark.parametrize("name,tables,sql,net", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_sql_shape_rows_match_jax(name, tables, sql, net):
    want, got = _both(tables(), sql, net)
    assert bool(want[0]) != (name in EMPTY), name
    if net:
        # outer joins interleave their sides by arrival: which batches
        # carry a padded (float) column differs, the net rows do not
        assert got[0] == want[0]
    else:
        assert got == want


# the JAX package's factor-window pair (tests/test_sql.py): two HOP
# aggregates of one table, which the factor-window rewrite shares
FACTOR_WINDOW_PAIR = """
    CREATE TABLE s1 (k BIGINT, window_end BIGINT, n BIGINT) WITH (
      connector = 'memory', name = 'fw1', type = 'sink');
    CREATE TABLE s2 (k BIGINT, window_end BIGINT, t BIGINT) WITH (
      connector = 'memory', name = 'fw2', type = 'sink');
    INSERT INTO s1 SELECT k, HOP(INTERVAL '1' SECOND, INTERVAL '4' SECOND)
      as window, count(*) AS n FROM events GROUP BY 1, 2;
    INSERT INTO s2 SELECT k, HOP(INTERVAL '1' SECOND, INTERVAL '2' SECOND)
      as window, sum(v) AS t FROM events GROUP BY 1, 2"""


def test_factor_window_pair_rows_match_jax(jax_like_port, monkeypatch):
    """The pair plans onto one shared pane ring in both packages; the
    port's rows equal the JAX package's and the port's unfactored plan's
    (``ARROYO_FACTOR_WINDOWS=0``)."""
    def rows(output):
        return [_rows(output(s)) for s in ("fw1", "fw2")]

    jp, pp = _providers(_events())
    jprog, prog = JaxPlanner(jp).plan(FACTOR_WINDOW_PAIR), Planner(pp).plan(
        FACTOR_WINDOW_PAIR)
    assert [n.operator.kind.value for n in prog.nodes()].count(
        "window_factor") == 1
    for s in ("fw1", "fw2"):
        jax_clear_sink(s)
        clear_sink(s)
    JaxLocalRunner(jprog).run()
    LocalRunner(prog, device="cpu").run()
    want, got = rows(jax_sink_output), rows(sink_output)
    assert all(w[0] for w in want) and got == want
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "0")
    for s in ("fw1", "fw2"):
        clear_sink(s)
    LocalRunner(Planner(_providers(_events())[1]).plan(FACTOR_WINDOW_PAIR),
                device="cpu").run()
    assert rows(sink_output) == got
