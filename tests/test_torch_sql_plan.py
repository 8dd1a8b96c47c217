"""The port's SQL planner against arroyo_tpu's, on the CPU.

* bench.py's Q1, Q5, Q7, Q8 and CONFIG5_SQL and the hot-items SQL plan
  into the JAX package's node sequence: operator ids, names, kinds, key
  columns, parallelism, edges, window/aggregate/argmax/TopN/join specs
  (``argmax_local`` included), the source's pushed-down ``projection``
  and the expressions' return types, structural ``sql`` tokens and
  output schemas;
* each hand-built program (``q1.py``, ``q5.py``, ``q7.py``, ``q8.py``,
  ``config5.py``, ``hot_items.py``) is the port's own plan of the same
  text, node for node (its ids are its own, so they are not compared);
* the shapes that needed the operators ported last (UNION ALL, a GROUP
  BY without a window, a keyless windowed aggregate, COUNT(DISTINCT) and
  string MIN/MAX on the buffered window, a UDAF under
  ``ARROYO_UDAF_COMPILE=off``, q5 and q7 under ``ARROYO_ARGMAX=0``,
  ``IN (SELECT ...)``, a three-way join on one key and two correlated
  HOP aggregates, which the factor-window rewrite shares) plan into the
  JAX package's nodes, and their operators declare the JAX operators'
  state tables;
* a shape that needs an operator the port has not ported raises
  ``SqlPlanError`` at plan time, naming its ROADMAP item;
* SQL-planned jobs carry the JAX plan's operator ids and its operators'
  state tables, so the table-level cross-package restores apply to
  them: q5's aggregate state written by the JAX package restores into
  the port's SQL-planned operator."""

import dataclasses
import enum

import networkx as nx
import numpy as np
import pytest

from arroyo_tpu.sql import plan_sql as jax_plan_sql
from arroyo_tpu.sql.functions import register_udaf as jax_register_udaf
from arroyo_tpu.sql.functions import unregister_udfs as jax_unregister_udfs
from arroyo_tpu_torch import queries
from arroyo_tpu_torch.config5 import config5_program
from arroyo_tpu_torch.graph.logical import OpKind
from arroyo_tpu_torch.hot_items import hot_items_program, hot_items_sql
from arroyo_tpu_torch.q1 import q1_program
from arroyo_tpu_torch.q5 import q5_program
from arroyo_tpu_torch.q7 import q7_program
from arroyo_tpu_torch.q8 import q8_program
from arroyo_tpu_torch.sql import (Planner, SchemaProvider, SqlPlanError,
                                  plan_sql, register_udaf, unregister_udfs)

N, B = 200_000, 16_384


def _pinned(sql, n=N, b=B):
    return sql.format(n=n, b=b).replace(
        f"batch_size = '{b}'", f"batch_size = '{b}', base_time_micros = '0'")


@pytest.fixture
def median():
    """``median`` as a UDAF in both packages (process-wide registries)."""
    unregister_udfs()
    jax_unregister_udfs()
    register_udaf("median", np.median)
    jax_register_udaf("median", np.median)
    yield
    unregister_udfs()
    jax_unregister_udfs()


CORPUS = {
    "q1": lambda: _pinned(queries.Q1),
    "q5": lambda: _pinned(queries.Q5),
    "q7": lambda: _pinned(queries.Q7),
    "q8": lambda: _pinned(queries.Q8),
    "hot_items": lambda: _pinned(hot_items_sql(N, B)),
    "config5": lambda: queries.CONFIG5_SQL.format(n=N, b=4_096),
}


def _dump(x):
    """A spec as comparable data: dataclasses by class name and fields,
    expressions by name, return type, sql token and output schema."""
    if type(x).__name__ == "ColumnExpr":
        return ("ColumnExpr", x.name, x.return_type.value, x.sql,
                x.output_schema)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, _dump(getattr(x, f.name)))
            for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return tuple(_dump(v) for v in x)
    return x


def _spec(op):
    s = op.spec
    if s is None:
        return None
    if type(s).__name__ == "ConnectorOpSpec":
        return (s.connector, s.config.get("projection"), s.config.get("name"))
    return _dump(s)


def _signature(prog, ids=True):
    """The program's nodes in topological order with their edges; node
    ids replaced by positions when ``ids`` is False."""
    order = prog.topo_order()
    pos = {nid: i for i, nid in enumerate(order)}
    name = (lambda nid: nid) if ids else (lambda nid: pos[nid])  # noqa: E731
    out = []
    for nid in order:
        node = prog.node(nid)
        op = node.operator
        if isinstance(prog.graph, nx.DiGraph):  # the JAX package's
            edges = [(s, d["edge"]) for s, _, d in
                     prog.graph.in_edges(nid, data=True)]
        else:
            edges = [(s, e) for s, _, e in prog.graph.in_edges(nid)]
        ins = sorted((name(s), e.typ.value, e.key_schema) for s, e in edges)
        expr = op.expr
        out.append((
            name(nid), op.name, op.kind.value, tuple(op.key_cols),
            node.parallelism, node.max_parallelism, _spec(op), ins,
            None if expr is None else (expr.return_type.value, expr.sql,
                                       expr.output_schema)))
    return out


@pytest.mark.parametrize("query", sorted(CORPUS))
def test_plan_matches_jax(query, median):
    sql = CORPUS[query]()
    want = _signature(jax_plan_sql(sql))
    got = _signature(plan_sql(sql))
    assert got == want


def test_q5_plan_has_the_rewrites():
    """q5's argmax fusion, its local-candidate emission and the pruned
    max side, and the pushed-down source projection, as the JAX plan."""
    prog = plan_sql(_pinned(queries.Q5))
    kinds = [prog.node(n).operator.kind for n in prog.topo_order()]
    assert kinds.count(OpKind.SLIDING_WINDOW_AGGREGATOR) == 1
    assert OpKind.NON_WINDOW_AGGREGATOR not in kinds
    agg = next(prog.node(n) for n in prog.topo_order()
               if prog.node(n).operator.kind
               == OpKind.SLIDING_WINDOW_AGGREGATOR)
    assert agg.operator.spec.argmax_local == ("__agg0", "max")
    src = prog.node(prog.topo_order()[0]).operator.spec
    assert src.config["projection"] == ["bid_auction", "bid_datetime",
                                        "event_type"]
    assert any(n.operator_id == "17_window_argmax" for n in prog.nodes())


HAND_BUILT = {
    "q1": lambda: q1_program(N, B, "results", base_time_micros=0),
    "q5": lambda: q5_program(N, B, "results", base_time_micros=0),
    "q7": lambda: q7_program(N, B, "results", base_time_micros=0),
    "q8": lambda: q8_program(N, B, "results", base_time_micros=0),
    "hot_items": lambda: hot_items_program(N, B, sink="results",
                                           base_time_micros=0),
    "config5": lambda: config5_program(N, 4_096, "results"),
}


def _hand_signature(prog):
    """Expression nodes of a hand-built program carry no sql token or
    output schema: compare their return types only."""
    return [row[:8] + ((row[8][0],) if row[8] else None,)
            for row in _signature(prog, ids=False)]


@pytest.mark.parametrize("query", sorted(HAND_BUILT))
def test_hand_built_program_is_the_ports_plan(query, median):
    """Names, kinds, keys, parallelism, specs and edges of the
    hand-built program equal the port's plan of its SQL; the source
    configs are equal too, field for field."""
    planned = plan_sql(CORPUS[query]())
    hand = HAND_BUILT[query]()
    assert _hand_signature(hand) == _hand_signature(planned)
    src = [planned.node(planned.topo_order()[0]).operator.spec.config,
           hand.node(hand.topo_order()[0]).operator.spec.config]
    assert src[0] == src[1]


FACTOR_PAIR = """
CREATE TABLE nexmark WITH (
  connector = 'nexmark', event_rate = '1000000', num_events = '1000',
  rate_limited = 'false', batch_size = '2048',
  base_time_micros = '1700000000000000'
);
CREATE TABLE s1 (auction BIGINT, window_end BIGINT, num BIGINT) WITH (
  connector = 'memory', name = 'fw1', type = 'sink');
CREATE TABLE s2 (auction BIGINT, window_end BIGINT, tot BIGINT) WITH (
  connector = 'memory', name = 'fw2', type = 'sink');
INSERT INTO s1
SELECT bid.auction as auction,
       HOP(INTERVAL '2' SECOND, INTERVAL '10' SECOND) as window,
       count(*) AS num
FROM nexmark WHERE bid is not null GROUP BY 1, 2;
INSERT INTO s2
SELECT bid.auction as auction,
       HOP(INTERVAL '2' SECOND, INTERVAL '4' SECOND) as window,
       sum(bid.price) AS tot
FROM nexmark WHERE bid is not null GROUP BY 1, 2;
"""

BIDS = """
CREATE TABLE nexmark WITH (connector = 'nexmark', num_events = '1000');
WITH b AS (SELECT bid.auction AS auction, bid.price AS price,
                  bid.bidder AS bidder FROM nexmark WHERE bid is not null)
"""

UNPORTED = [
    ("connector", """
CREATE TABLE t (a BIGINT) WITH (connector = 'single_file',
  path = '/dev/null', type = 'source');
SELECT a FROM t""", "connector 'single_file'", "A.8"),
]


@pytest.mark.parametrize("name,sql,what,item", UNPORTED,
                         ids=[u[0] for u in UNPORTED])
def test_unported_shape_raises_at_plan_time(name, sql, what, item):
    """Each shape plans in the JAX package (its own tests run them) and
    raises ``SqlPlanError`` naming the operator and the ROADMAP item in
    the port, before any task runs."""
    with pytest.raises(SqlPlanError) as e:
        plan_sql(sql)
    assert what in str(e.value) and f"ROADMAP {item}" in str(e.value)


# shapes that plan into operators ported after the SQL front end: (SQL,
# environment)
PLANNED = {
    "union_all": (BIDS + """
SELECT auction FROM b UNION ALL SELECT bidder AS auction FROM b""", {}),
    "non_windowed_group_by": (BIDS + """
SELECT auction, count(*) AS c FROM b GROUP BY 1""", {}),
    "self_union_windowed": (BIDS + """
, u AS (SELECT auction FROM b UNION ALL SELECT auction FROM b)
SELECT auction, TUMBLE(INTERVAL '1' SECOND) AS window, count(*) AS n
FROM u GROUP BY 1, 2""", {}),
    "keyless_window": (BIDS + """
SELECT TUMBLE(INTERVAL '1' SECOND) AS window, max(price) AS mx
FROM b GROUP BY 1""", {}),
    "count_distinct_hop": (BIDS + """
SELECT auction, HOP(INTERVAL '1' SECOND, INTERVAL '2' SECOND) AS window,
       count(DISTINCT bidder) AS d FROM b GROUP BY 1, 2""", {}),
    "updating_avg_filter": (BIDS + """
SELECT a FROM (SELECT avg(price) AS p, auction AS a FROM b GROUP BY 2)
WHERE p > 10""", {}),
    "q5_unfused": (_pinned(queries.Q5), {"ARROYO_ARGMAX": "0"}),
    "q7_unfused": (_pinned(queries.Q7), {"ARROYO_ARGMAX": "0"}),
    "three_way_join": (BIDS + """
SELECT X.auction AS a1, Y.price AS p2, Z.bidder AS b3
FROM b X JOIN b Y ON X.auction = Y.auction
JOIN b Z ON X.auction = Z.auction""", {}),
    "in_subquery": (BIDS + """
SELECT auction FROM b
WHERE auction IN (SELECT auction.id FROM nexmark
                  WHERE auction is not null)""", {}),
    # correlated windows: the factor-window rewrite (a shared pane ring,
    # a derived window a query)
    "factor_window_pair": (FACTOR_PAIR, {}),
}


@pytest.mark.parametrize("name", sorted(PLANNED))
def test_newly_ported_shape_plans_as_jax(name, monkeypatch):
    """Node kinds, ids, names, keys, specs and edges equal the JAX plan's,
    and every operator declares the JAX operator's tables."""
    from arroyo_tpu.engine.build import build_operator as jax_build
    from arroyo_tpu_torch.engine.build import build_operator

    sql, env = PLANNED[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jax_prog, prog = jax_plan_sql(sql), plan_sql(sql)
    assert _signature(prog) == _signature(jax_prog)
    kinds = {prog.node(n).operator.kind for n in prog.topo_order()}
    for nid in prog.topo_order():
        if prog.node(nid).operator.kind in (OpKind.WINDOW_JOIN,
                                            OpKind.JOIN_WITH_EXPIRATION,
                                            OpKind.MULTI_WAY_JOIN):
            continue  # the port's joins open their buffers at start
        got = _tables(build_operator(prog.node(nid).operator, "cpu"))
        assert got == _tables(jax_build(jax_prog.node(nid).operator)), nid
    expect = {"union_all": OpKind.UNION, "self_union_windowed": OpKind.UNION,
              "non_windowed_group_by": OpKind.NON_WINDOW_AGGREGATOR,
              "updating_avg_filter": OpKind.NON_WINDOW_AGGREGATOR,
              "keyless_window": OpKind.GLOBAL_KEY,
              "count_distinct_hop": OpKind.WINDOW,
              "q5_unfused": OpKind.NON_WINDOW_AGGREGATOR,
              "q7_unfused": OpKind.GLOBAL_KEY,
              "three_way_join": OpKind.MULTI_WAY_JOIN,
              "in_subquery": OpKind.JOIN_WITH_EXPIRATION,
              "factor_window_pair": OpKind.WINDOW_FACTOR}[name]
    assert expect in kinds and OpKind.WINDOW_ARGMAX not in kinds


def test_factor_windows_off_plans_the_pair(monkeypatch):
    """``ARROYO_FACTOR_WINDOWS=0`` turns the rewrite off in both
    packages, and the port then plans the pair as the JAX package does."""
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "0")
    assert _signature(plan_sql(FACTOR_PAIR)) == _signature(
        jax_plan_sql(FACTOR_PAIR))


def test_explain_rows_match_jax():
    """EXPLAIN plans the inner query and emits one row per operator."""
    from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
    from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
    from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
    from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
    from arroyo_tpu_torch.engine.engine import LocalRunner

    sql = "EXPLAIN " + _pinned(queries.Q5).split(";", 1)[1]
    sql = _pinned(queries.SRC) + sql
    jax_clear_sink("results")
    JaxLocalRunner(jax_plan_sql(sql)).run()
    clear_sink("results")
    LocalRunner(plan_sql(sql), device="cpu").run()
    want = jax_sink_output("results")[0].columns
    got = sink_output("results")[0].columns
    assert sorted(want) == sorted(got)
    for k in want:
        assert list(want[k]) == list(got[k]), k


def _tables(op):
    return [(t.name, t.table_type.name) for t in op.tables()]


@pytest.mark.parametrize("query", sorted(CORPUS))
def test_sql_planned_operators_have_the_jax_tables(query, median):
    """Every operator of the port's plan has the JAX plan's operator id
    and declares the JAX operator's state tables (names and types), so a
    checkpoint's table keys agree across the packages for SQL-planned
    jobs as for the hand-built ones."""
    from arroyo_tpu.engine.build import build_operator as jax_build
    from arroyo_tpu_torch.engine.build import build_operator

    sql = CORPUS[query]()
    jax_prog, prog = jax_plan_sql(sql), plan_sql(sql)
    assert prog.topo_order() == jax_prog.topo_order()
    for nid in prog.topo_order():
        got = _tables(build_operator(prog.node(nid).operator, "cpu"))
        want = _tables(jax_build(jax_prog.node(nid).operator))
        if prog.node(nid).operator.kind == OpKind.WINDOW_JOIN:
            # the port's window join opens its join buffers "l" and "r"
            # when it starts instead of declaring them
            assert not got and [n for n, _ in want] == ["l", "r"]
            continue
        assert got == want, (nid, got, want)


def test_sql_planned_q5_state_restores_across_packages(monkeypatch):
    """The JAX KeyedBinState snapshot of q5's aggregate restores into the
    port's SQL-planned q5 aggregate operator, and its snapshot comes
    back equal."""
    import arroyo_tpu.native as jax_native
    from arroyo_tpu.graph.logical import AggKind as JaxAggKind
    from arroyo_tpu.graph.logical import AggSpec as JaxAggSpec
    from arroyo_tpu.ops.keyed_bins import KeyedBinState as JaxState
    from arroyo_tpu_torch.engine.build import build_operator

    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "HAVE_NATIVE", False)
    prog = plan_sql(_pinned(queries.Q5))
    agg_id = next(n for n in prog.topo_order()
                  if prog.node(n).operator.kind
                  == OpKind.SLIDING_WINDOW_AGGREGATOR)
    op = build_operator(prog.node(agg_id).operator, "cpu")
    jstate = JaxState((JaxAggSpec(JaxAggKind.COUNT, None, "__agg0"),),
                      2_000_000, 10_000_000, capacity=64)
    jstate.set_argmax_local("__agg0", "max")
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 40, 500).astype(np.uint64) * np.uint64(7919)
    ts = np.sort(rng.integers(0, 9_000_000, 500)).astype(np.int64)
    jstate.update(keys, ts, {})
    snap = jstate.snapshot()
    op.state.restore(snap)
    back = op.state.snapshot()
    assert sorted(back) == sorted(snap)
    for k in snap:
        assert np.array_equal(np.asarray(back[k]), np.asarray(snap[k])), k


def test_planner_reuses_provider_tables():
    """A ``SchemaProvider`` keeps CREATE TABLE definitions across plans,
    and ``Planner`` numbers nodes as the JAX planner does."""
    p = SchemaProvider()
    prog = Planner(p).plan(_pinned(queries.Q1))
    assert "nexmark" in p.tables
    assert [n.operator_id for n in prog.nodes()] == [
        "0_connector_source", "1_watermark", "2_expression", "3_udf",
        "4_connector_sink"]
