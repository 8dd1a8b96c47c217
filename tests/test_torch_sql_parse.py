"""The port's SQL lexer and parser against arroyo_tpu's, on the CPU.

* ``arroyo_tpu_torch.sql.parse_sql`` gives the JAX package's AST — the
  same node classes with the same fields, compared as a structural dump —
  for every SQL text in bench.py, the port's ``HOT_ITEMS_SQL``, and every
  SQL string literal of tests/test_sql.py (the shapes the execution tests
  run), and raises the same error where the JAX parser raises;
* ``arroyo_tpu_torch.queries`` holds bench.py's query texts character for
  character (bench.py is read with ``ast``, so nothing in it runs)."""

import ast
import dataclasses
import enum
import os

import pytest

from arroyo_tpu.sql.parser import parse_sql as jax_parse
from arroyo_tpu_torch import queries
from arroyo_tpu_torch.hot_items import HOT_ITEMS_SQL, hot_items_sql
from arroyo_tpu_torch.sql.parser import parse_sql

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_NAMES = ("SRC", "Q1", "Q5", "Q7", "Q8", "CONFIG5_SQL", "LAT_SQL")


def _bench_strings():
    """bench.py's module-level SQL constants, evaluated from the syntax
    tree (string literals, names of earlier ones, ``+``)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    env = {}

    def ev(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name) and node.id in env:
            return env[node.id]
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left, right = ev(node.left), ev(node.right)
            return None if left is None or right is None else left + right
        return None

    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            v = ev(node.value)
            if v is not None:
                env[node.targets[0].id] = v
    return env


BENCH = _bench_strings()


def _test_sql_strings():
    """Every string literal of tests/test_sql.py that holds a statement."""
    tree = ast.parse(open(os.path.join(REPO, "tests", "test_sql.py")).read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            t = node.value.strip().upper()
            if t.startswith(("SELECT", "WITH", "CREATE", "INSERT",
                             "EXPLAIN")):
                out.append(node.value)
    return sorted(set(out))


def _fill(sql):
    return sql.replace("{n}", "1000").replace("{b}", "100").replace(
        "{rate}", "5000").replace("{base}", "0").replace("{k}", "10")


SQL = ([(f"bench.{n}", _fill(BENCH[n])) for n in BENCH_NAMES]
       + [("hot_items", hot_items_sql(1000, 100))]
       + [(f"test_sql[{i}]", s) for i, s in enumerate(_test_sql_strings())])


def _dump(x):
    """Class names and fields, recursively (enums by class and value)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, _dump(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_dump(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple(sorted((k, _dump(v)) for k, v in x.items())))
    return x


def test_bench_texts_found():
    assert set(BENCH_NAMES) <= set(BENCH)
    assert len(SQL) > 40


@pytest.mark.parametrize("name,sql", SQL, ids=[n for n, _ in SQL])
def test_parse_matches_jax(name, sql):
    try:
        want = jax_parse(sql)
    except Exception as e:  # the JAX parser refuses: so must the port's
        with pytest.raises(Exception) as got:
            parse_sql(sql)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        return
    got = parse_sql(sql)
    assert _dump(got) == _dump(want)
    assert [type(s).__name__ for s in got] == [type(s).__name__
                                              for s in want]


@pytest.mark.parametrize("name", ["SRC", "Q1", "Q5", "Q7", "Q8",
                                  "CONFIG5_SQL"])
def test_queries_equal_bench_texts(name):
    assert getattr(queries, name) == BENCH[name]
    assert queries.QUERIES[name.lower()] == BENCH[name] if name in (
        "Q1", "Q5", "Q7", "Q8") else True


def test_hot_items_text_is_the_queries_one():
    assert queries.HOT_ITEMS_SQL is HOT_ITEMS_SQL
