"""UNION ALL in the port against arroyo_tpu, on the CPU: the shapes of
tests/test_sql.py's union tests, planned by both packages' SQL planners
and run by both engines over the same in-memory tables (made with a
numpy seed) — sorted sink rows equal value for value and dtype for
dtype; the self-union through ``Stream.union`` duplicates every row;
a union heads its own chain and its watermark is the minimum over its
inputs; the mismatches the JAX planner rejects raise the same errors."""

import math

import numpy as np
import pytest

from arroyo_tpu import Stream as JaxStream
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.sql import SchemaProvider as JaxProvider
from arroyo_tpu.sql.planner import Planner as JaxPlanner
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.graph.chaining import plan_chains
from arroyo_tpu_torch.graph.logical import EdgeType, OpKind, Stream
from arroyo_tpu_torch.sql import Planner, SchemaProvider
from arroyo_tpu_torch.types import Batch, Watermark

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


def _events():
    """tests/test_sql.py's ``events`` table: 200 rows over 4 s."""
    rng = np.random.default_rng(7)
    n = 200
    ts = np.sort(rng.integers(0, 4 * SEC, n)).astype(np.int64)
    cols = {"k": rng.integers(0, 5, n).astype(np.int64),
            "v": rng.integers(1, 50, n).astype(np.int64),
            "name": np.array([f"name{i % 3}" for i in range(n)],
                             dtype=object)}
    return {"k": "i", "v": "i", "name": "s"}, [(ts[:120], cols, 0, 120),
                                               (ts[120:], cols, 120, n)]


def _providers():
    jp, pp = JaxProvider(), SchemaProvider()
    kinds, parts = _events()
    for prov, cls in ((jp, JaxBatch), (pp, Batch)):
        prov.add_memory_table("events", kinds, [cls(
            ts.copy(), {c: v[a:b].copy() for c, v in cols.items()})
            for ts, cols, a, b in parts])
    return jp, pp


def _sql_both(sql):
    jp, pp = _providers()
    jax_clear_sink("results")
    JaxLocalRunner(JaxPlanner(jp).plan(sql)).run()
    clear_sink("results")
    LocalRunner(Planner(pp).plan(sql), device="cpu").run()
    return _rows(jax_sink_output("results")), _rows(sink_output("results"))


SHAPES = {
    "two_branches": """
      SELECT k, v FROM events WHERE k < 2
      UNION ALL
      SELECT k, v FROM events WHERE k >= 2""",
    "three_branches": """
      SELECT k FROM events WHERE k = 0
      UNION ALL SELECT k FROM events WHERE k = 0
      UNION ALL SELECT k FROM events WHERE k = 0""",
    "windowed_aggregate_downstream": """
      WITH both_halves as (
        SELECT k, v FROM events WHERE v < 25
        UNION ALL
        SELECT k, v FROM events WHERE v >= 25
      )
      SELECT k, TUMBLE(INTERVAL '2' SECOND) as window, count(*) as cnt
      FROM both_halves GROUP BY 1, 2""",
    "cte_in_both_branches": """
      WITH x AS (SELECT k, v FROM events)
      SELECT k, v FROM x WHERE k < 2
      UNION ALL
      SELECT k, v FROM x WHERE k >= 2""",
    "updating_branches": """
      SELECT k, count(*) AS c FROM events WHERE v < 25 GROUP BY k
      UNION ALL
      SELECT k, count(*) AS c FROM events WHERE v >= 25 GROUP BY k""",
    "keyless_window_over_union": """
      WITH u AS (SELECT v FROM events WHERE k = 1
                 UNION ALL SELECT v FROM events WHERE k = 3)
      SELECT TUMBLE(INTERVAL '1' SECOND) AS window, sum(v) AS s,
             count(DISTINCT v) AS d
      FROM u GROUP BY 1""",
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_union_sql_rows_match_jax(name, monkeypatch):
    # one batch a source batch: the updating branches' refinements then
    # do not depend on which batches the input coalescer merges
    monkeypatch.setenv("ARROYO_COALESCE", "0")
    want, got = _sql_both(SHAPES[name])
    assert want[0] and got == want


def test_union_is_the_whole_table():
    """Partition + union = the whole table, duplicates kept; three equal
    branches give three times the rows."""
    _, pp = _providers()

    def run(sql):
        clear_sink("results")
        LocalRunner(Planner(pp).plan(sql), device="cpu").run()
        return sorted(r[1:] for r in _rows(sink_output("results"))[0])

    assert run(SHAPES["two_branches"]) == run("SELECT k, v FROM events")
    base = run("SELECT k FROM events WHERE k = 0")
    assert run(SHAPES["three_branches"]) == sorted(base * 3)


def test_self_union_duplicates_every_row():
    """``s.union(s)``: one side goes through a pass-through node, so the
    graph keeps both edges, in both packages."""
    out = []
    for stream, cls, run, clear, output in (
            (JaxStream, JaxBatch, lambda p: JaxLocalRunner(p).run(),
             jax_clear_sink, jax_sink_output),
            (Stream, Batch, lambda p: LocalRunner(p, device="cpu").run(),
             clear_sink, sink_output)):
        clear("su")
        src = cls(np.arange(5, dtype=np.int64),
                  {"v": np.arange(5, dtype=np.int64)})
        s = (stream.source("memory", {"batches": [src]})
             .map(lambda c: {"v": c["v"]}, name="id"))
        prog = s.union(s).sink("memory", {"name": "su"})
        names = sorted(prog.node(n).operator.name
                       for n in prog.topo_order())
        run(prog)
        out.append((names, sorted(r for b in output("su")
                                  for r in b.columns["v"].tolist())))
    assert out[1] == out[0]
    assert out[1][1] == sorted(list(range(5)) * 2)
    assert "union_dup" in out[1][0]


def test_union_heads_its_chain_and_takes_the_minimum_watermark():
    """Two SHUFFLE in-edges: no chain reaches into the union, whose
    runner reads both on input side 0 (two inputs), and its combined
    watermark is the smaller of its inputs'."""
    late = Batch(np.array([0, 5 * SEC], np.int64),
                 {"v": np.array([1, 2], np.int64)})
    early = Batch(np.array([9 * SEC], np.int64),
                  {"v": np.array([3], np.int64)})
    a = Stream.source("memory", {"batches": [late]}, name="a").watermark(
        name="wa")
    b = Stream.source("memory", {"batches": [early]}, program=a.program,
                      name="b").watermark(name="wb")
    prog = (a.union(b).map(lambda c: {"v": c["v"]}, name="m")
            .sink("memory", {"name": "uw"}))
    union = next(n for n in prog.nodes() if n.operator.kind == OpKind.UNION)
    ins = prog.graph.in_edges(union.operator_id)
    assert [e.typ for _, _, e in ins] == [EdgeType.SHUFFLE] * 2
    chains = plan_chains(prog)
    assert union.operator_id not in chains.head_of or chains.head_of[
        union.operator_id] == union.operator_id
    clear_sink("uw")
    runner = LocalRunner(prog, device="cpu")
    runner.run()
    ctx = runner.engine.members[(union.operator_id, 0)][1]
    assert ctx.n_inputs == 2
    ctx.watermarks, ctx.last_watermark = type(ctx.watermarks)(2), None
    assert ctx.observe_watermark(0, Watermark.event_time(5 * SEC)) is None
    assert ctx.observe_watermark(1, Watermark.event_time(9 * SEC)) == 5 * SEC
    assert ctx.observe_watermark(0, Watermark.event_time(12 * SEC)) == 9 * SEC
    assert sorted(r for bb in sink_output("uw")
                  for r in bb.columns["v"].tolist()) == [1, 2, 3]


REJECTED = [
    ("mismatched_columns",
     "SELECT k FROM events UNION ALL SELECT v, k FROM events", "columns"),
    ("plain_union", "SELECT k FROM events UNION SELECT k FROM events", "."),
    ("trailing_order_by", """SELECT k FROM events UNION ALL
                   SELECT k FROM events ORDER BY k LIMIT 3""",
     "outer SELECT"),
    ("different_types", """SELECT k, name FROM events UNION ALL
                   SELECT k, v as name FROM events""", "columns and"),
    ("leading_order_by", """SELECT k FROM events ORDER BY k LIMIT 3
                   UNION ALL SELECT k FROM events""", "subquery"),
    ("updating_and_append_only", """
      SELECT k, count(*) AS c FROM events GROUP BY k
      UNION ALL SELECT k, v AS c FROM events""", "both"),
]


@pytest.mark.parametrize("name,sql,match", REJECTED,
                         ids=[r[0] for r in REJECTED])
def test_union_mismatches_are_rejected_as_in_jax(name, sql, match):
    jp, pp = _providers()
    with pytest.raises(Exception, match=match) as want:
        JaxPlanner(jp).plan(sql)
    with pytest.raises(Exception, match=match) as got:
        Planner(pp).plan(sql)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
