"""SQL expressions in the port against arroyo_tpu, on the CPU.

Every ``DEVICE_FUNCTIONS`` entry and every operator (arithmetic,
comparison, CASE, CAST, IS NULL, LIKE, BETWEEN, IN, division and modulo
by zero, ``||``) is compiled by both packages' ``compile_scalar`` over the
same seeded columns — int64, float64 with NaN, nullable object ints and
bools, strings and micros timestamps — and projected through each
package's planner wrapper, on each path the planner would run it:

* an expression the compiler keeps on the host (strings, timestamps,
  host functions) through ``eval_host_expr``, the UDF path;
* any other expression through ``eval_record_expr`` twice: ``host=True``
  (the chain's ingest spine) and the device path, which is the JAX
  package's jitted ``__call__`` and the port's eager torch ``__call__``
  (the CPU here; tests/test_torch_cuda.py runs the card's).

Values, dtypes and NULLs (None cells, NaN) must be equal bit for bit,
except transcendental functions, held to ``rtol=1e-12`` with equal NaN
positions, and a division by a float literal on the JAX package's jitted
path, where XLA multiplies by the literal's reciprocal (``i / 2.5`` is
``i * 0.4`` there, one ulp off a true division in some rows): that one
is held to ``rtol=1e-15`` on that path and bit for bit on the others."""

import math

import numpy as np
import pytest
import torch

from arroyo_tpu.ops.expr import CompiledExpr as JaxExpr
from arroyo_tpu.ops.expr import eval_host_expr as jax_eval_host_expr
from arroyo_tpu.ops.expr import eval_record_expr as jax_eval_record_expr
from arroyo_tpu.ops.expr import eval_predicate as jax_eval_predicate
from arroyo_tpu.sql.compiler import Schema as JaxSchema
from arroyo_tpu.sql.compiler import compile_scalar as jax_compile
from arroyo_tpu.sql.functions import DEVICE_FUNCTIONS as JAX_DEVICE_FUNCTIONS
from arroyo_tpu.sql.parser import parse_sql as jax_parse
from arroyo_tpu.sql.planner import _wrap_predicate as jax_wrap_predicate
from arroyo_tpu.sql.planner import _wrap_record as jax_wrap_record
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch.ops.expr import (CompiledExpr, eval_host_expr,
                                       eval_predicate, eval_record_expr)
from arroyo_tpu_torch.sql.compiler import Schema, compile_scalar
from arroyo_tpu_torch.sql.functions import DEVICE_FUNCTIONS
from arroyo_tpu_torch.sql.parser import parse_sql
from arroyo_tpu_torch.sql.planner import _wrap_predicate, _wrap_record
from arroyo_tpu_torch.types import Batch

CPU = torch.device("cpu")
N = 64
KINDS = {"i": "i", "j": "i", "k": "i", "f": "f", "g": "f", "oi": "i",
         "ob": "b", "s": "s", "ts": "t", "tm": "i"}


def _columns():
    rng = np.random.default_rng(1234)
    i = rng.integers(-50, 50, N).astype(np.int64)
    j = rng.integers(-4, 5, N).astype(np.int64)  # zeros: NULL divisors
    k = rng.integers(0, 25, N).astype(np.int64)
    f = rng.normal(0, 10, N)
    f[rng.random(N) < 0.15] = np.nan
    f[3], f[4] = -0.0, 0.0
    g = rng.uniform(-0.99, 0.99, N)
    oi = np.array([None if r < 0.2 else int(x) for r, x in
                   zip(rng.random(N), rng.integers(-9, 9, N))], dtype=object)
    ob = np.array([None if r < 0.25 else bool(x) for r, x in
                   zip(rng.random(N), rng.integers(0, 2, N))], dtype=object)
    words = ["abc", "Abd", "xbc", "a_c", "hello world", ""]
    s = np.array([None if r < 0.1 else words[x] for r, x in
                  zip(rng.random(N), rng.integers(0, len(words), N))],
                 dtype=object)
    ts = (1_700_000_000_000_000
          + rng.integers(0, 400 * 86_400_000_000, N)).astype(np.int64)
    tm = rng.integers(0, 10 * 86_400_000_000, N).astype(np.int64)
    return {"i": i, "j": j, "k": k, "f": f, "g": g, "oi": oi, "ob": ob,
            "s": s, "ts": ts, "tm": tm}


COLS = _columns()
TS = np.arange(N, dtype=np.int64) * 1000

# (expression, transcendental): the operators first, then every
# DEVICE_FUNCTIONS entry (the test below checks that none is missing)
EXPRS = [
    ("i + j", False), ("i - 3", False), ("i * j", False), ("i * 0.908", False),
    ("f + i", False), ("f * 2", False), ("-i", False), ("-f", False),
    ("i / j", False), ("i % j", False), ("i / 0", False), ("i % 0", False),
    ("-7 / 2", False), ("f / j", False), ("f % j", False), ("f % 0.0", False),
    ("i / 2.5", "div"), ("k / 3", False), ("100 / f", False),
    ("2.5 / (k + 1)", False), ("oi / j", False), ("oi % 3", False),
    ("oi + 1", False), ("oi * f", False),
    ("i = j", False), ("i <> j", False), ("i < j", False), ("i <= 0", False),
    ("f > 1.5", False), ("f >= i", False), ("oi = 3", False),
    ("i > 0 AND f > 0", False), ("i > 0 OR ob", False), ("NOT (i > 0)", False),
    ("ob", False), ("ob = TRUE", False), ("NOT ob", False),
    ("i BETWEEN -10 AND 10", False), ("f NOT BETWEEN -1 AND 1", False),
    ("i IN (1, 2, 3, -4)", False), ("oi NOT IN (1, 2)", False),
    ("CASE WHEN i > 0 THEN 1 WHEN i < -20 THEN 2 ELSE 3 END", False),
    ("CASE WHEN f > 0 THEN f END", False),
    ("CASE WHEN i > 0 THEN i ELSE f END", False),
    ("CASE j WHEN 0 THEN 10 WHEN 1 THEN 11 END", False),
    ("CASE WHEN oi > 0 THEN oi ELSE 0 END", False),
    ("CAST(f AS BIGINT)", False), ("CAST(i AS DOUBLE)", False),
    ("CAST(oi AS BIGINT)", False), ("CAST(i AS BOOLEAN)", False),
    ("CAST(i AS VARCHAR)", False), ("CAST(NULL AS BIGINT)", False),
    ("CAST(ts AS TIMESTAMP)", False), ("CAST(i AS TIMESTAMP)", False),
    ("f IS NULL", False), ("oi IS NOT NULL", False), ("ob IS NULL", False),
    ("s IS NULL", False), ("i IS NULL", False),
    ("s LIKE 'a%'", False), ("s LIKE '_bc'", False), ("s = 'abc'", False),
    ("s || '!'", False), ("upper(s)", False), ("length(s) + i", False),
    ("1 + 2", False), ("2.5 * 2", False), ("NULL", False),
    ("ts - 1000", False), ("ts / 1000000", False),
    # DEVICE_FUNCTIONS
    ("abs(i)", False), ("abs(f)", False), ("ceil(f)", False),
    ("floor(f)", False), ("round(f)", False), ("trunc(f)", False),
    ("ceil(i)", False), ("round(i)", False), ("signum(f)", False),
    ("signum(i)", False),
    ("sqrt(abs(f))", True), ("sqrt(k)", True), ("exp(g)", True),
    ("ln(abs(f))", True), ("log10(k)", True), ("log2(abs(f))", True),
    ("sin(f)", True), ("cos(i)", True), ("tan(g)", True), ("asin(g)", True),
    ("acos(g)", True), ("atan(f)", True), ("power(i, 2)", False),
    ("pow(f, 2)", True), ("power(k, 0.5)", True), ("sinh(g)", True),
    ("cosh(g)", True), ("tanh(f)", True), ("asinh(f)", True),
    ("acosh(k + 1)", True), ("atanh(g)", True), ("cbrt(f)", True),
    ("cbrt(i)", True), ("degrees(f)", True), ("radians(i)", True),
    ("cot(g)", True), ("atan2(f, i)", True), ("log(k)", True),
    ("log(2, k + 1)", True), ("pi()", False), ("pi() * f", True),
    ("factorial(k)", False), ("gcd(i, j)", False), ("lcm(i, k)", False),
    ("nullif(i, 3)", False), ("nullif(f, 0.0)", False),
    ("coalesce(oi, i)", False), ("coalesce(f, 0.0)", False),
    ("coalesce(oi, f, 7)", False),
    ("date_trunc('hour', tm)", False), ("date_trunc('day', tm)", False),
    ("date_trunc('month', ts)", False), ("date_trunc('week', ts)", False),
    ("extract(second FROM tm)", False), ("extract(minute FROM tm)", False),
    ("extract(hour FROM tm)", False), ("extract(epoch FROM tm)", False),
    ("extract(dow FROM tm)", False), ("extract(year FROM ts)", False),
    ("extract(week FROM ts)", False), ("extract(doy FROM ts)", False),
    ("from_unixtime(tm)", False), ("to_timestamp(tm)", False),
    ("unix_timestamp(tm)", False), ("to_timestamp_seconds(k)", False),
    ("to_timestamp_millis(i)", False), ("to_timestamp_micros(tm)", False),
    ("date_bin(INTERVAL '1' HOUR, tm)", False),
    ("date_bin(INTERVAL '15' MINUTE, tm, 60000000)", False),
]

# the compiler's special-cased names for date_trunc/extract
_COMPILER_NAMES = {"__date_trunc": "date_trunc(", "__extract": "extract("}


def _expr(pkg_parse, text):
    return pkg_parse(f"SELECT {text} AS x FROM t")[0].items[0].expr


def _batches():
    jb = JaxBatch(TS, {k: v.copy() for k, v in COLS.items()})
    pb = Batch(TS, {k: v.copy() for k, v in COLS.items()})
    return jb, pb


def _assert_cols_equal(want, got, rtol):
    assert sorted(want) == sorted(got)
    for name in want:
        a, b = np.asarray(want[name]), np.asarray(got[name])
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype == object:
            for x, y in zip(a.tolist(), b.tolist()):
                if isinstance(x, float) and math.isnan(x):
                    assert isinstance(y, float) and math.isnan(y)
                else:
                    assert x == y and type(x) is type(y), (name, x, y)
        elif a.dtype.kind == "f" and rtol:
            assert np.array_equal(np.isnan(a), np.isnan(b)), name
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0,
                                       equal_nan=True)
        elif a.dtype.kind == "f":
            # bit equality (signed zeros included) with NaN in the same
            # rows; a NaN's payload bits are not compared
            nan = np.isnan(a)
            assert np.array_equal(nan, np.isnan(b)), (name, a, b)
            bits = lambda x: np.ascontiguousarray(  # noqa: E731
                np.where(nan, 0, x), dtype=a.dtype).view(np.uint8)
            assert np.array_equal(bits(a), bits(b)), (name, a, b)
        else:
            assert np.array_equal(a, b), (name, a, b)


def test_expression_corpus_covers_every_device_function():
    assert set(DEVICE_FUNCTIONS) == set(JAX_DEVICE_FUNCTIONS)
    texts = " ".join(e for e, _ in EXPRS)
    for name in DEVICE_FUNCTIONS:
        assert _COMPILER_NAMES.get(name, f"{name}(") in texts, name


@pytest.mark.parametrize("text,trans", EXPRS, ids=[e for e, _ in EXPRS])
def test_expression_matches_jax(text, trans):
    jc = jax_compile(_expr(jax_parse, text), JaxSchema(columns=dict(KINDS)))
    pc = compile_scalar(_expr(parse_sql, text), Schema(columns=dict(KINDS)))
    assert pc.needs_host == jc.needs_host
    assert pc.used_cols == jc.used_cols
    jfn = jax_wrap_record([("x", jc)], ["s"])
    pfn = _wrap_record([("x", pc)], ["s"])
    assert pfn.used_cols == jfn.used_cols
    jb, pb = _batches()
    if jc.needs_host:
        want = jax_eval_host_expr(jfn, jb)
        got = eval_host_expr(pfn, pb)
        _assert_cols_equal(want.columns, got.columns,
                           1e-12 if trans is True else 0)
        assert np.array_equal(want.timestamp, got.timestamp)
        return
    for host in (True, False):
        want = jax_eval_record_expr(JaxExpr("x", jfn), jb, host=host)
        got = eval_record_expr(CompiledExpr("x", pfn, CPU), pb, host=host)
        tol = (trans is True or (trans == "div" and not host)) and (
            1e-12 if trans is True else 1e-15)
        _assert_cols_equal(want.columns, got.columns, tol)
        assert np.array_equal(want.timestamp, got.timestamp)


PREDICATES = ["i > 0", "f > 1.5", "oi = 3", "ob", "NOT ob", "i / j > 1",
              "i % j = 0", "f IS NULL", "oi IS NOT NULL",
              "i IN (1, 2, 3) OR f < 0", "1 = 1", "1 > 2",
              "CASE WHEN i > 0 THEN ob ELSE FALSE END"]


@pytest.mark.parametrize("text", PREDICATES)
def test_predicate_matches_jax(text):
    """Predicates on both paths give the JAX package's row mask,
    constant predicates broadcast to the batch."""
    jc = jax_compile(_expr(jax_parse, text), JaxSchema(columns=dict(KINDS)))
    pc = compile_scalar(_expr(parse_sql, text), Schema(columns=dict(KINDS)))
    assert not jc.needs_host
    jb, pb = _batches()
    for host in (True, False):
        want = jax_eval_predicate(JaxExpr("p", jax_wrap_predicate(jc)), jb,
                                  host=host)
        got = eval_predicate(CompiledExpr("p", _wrap_predicate(pc), CPU), pb,
                             host=host)
        assert got.dtype == np.bool_ and np.array_equal(want, got), text


def test_split_cols_and_passthrough_match_jax():
    """``_split_cols`` sends the same columns into the function (a
    nullable object column as values plus ``__mask_``) and passes the
    same string columns through."""
    jc = jax_compile(_expr(jax_parse, "oi + i"),
                     JaxSchema(columns=dict(KINDS)))
    pc = compile_scalar(_expr(parse_sql, "oi + i"),
                        Schema(columns=dict(KINDS)))
    jb, pb = _batches()
    jn, jh = JaxExpr("x", jax_wrap_record([("x", jc)], []))._split_cols(jb)
    pn, ph = CompiledExpr("x", _wrap_record([("x", pc)], []),
                          CPU)._split_cols(pb)
    assert sorted(jn) == sorted(pn) and sorted(jh) == sorted(ph)
    for k in jn:
        assert np.array_equal(np.asarray(jn[k]), pn[k],
                              equal_nan=pn[k].dtype.kind == "f"), k


def test_division_and_modulo_by_zero_are_null_not_errors():
    """Integer ``/`` truncates toward zero and ``%`` takes the dividend's
    sign; a zero divisor is NULL on both paths (torch raises on an
    integer division by zero on the CPU, so the divisor is masked
    first)."""
    pc = compile_scalar(_expr(parse_sql, "i / j"), Schema(columns=dict(KINDS)))
    pm = compile_scalar(_expr(parse_sql, "i % j"), Schema(columns=dict(KINDS)))
    fn = _wrap_record([("q", pc), ("r", pm)], [])
    _, pb = _batches()
    i, j = COLS["i"], COLS["j"]
    for host in (True, False):
        out = eval_record_expr(CompiledExpr("x", fn, CPU), pb,
                               host=host).columns
        for n in range(N):
            if j[n] == 0:
                assert np.isnan(out["q"][n]) and np.isnan(out["r"][n])
            else:
                q = abs(int(i[n])) // abs(int(j[n]))
                q = q if (i[n] < 0) == (j[n] < 0) else -q
                assert out["q"][n] == q and out["r"][n] == i[n] - q * j[n]


# -- CAST(<string> AS TIMESTAMP) -----------------------------------------------------

# string columns as a CAST to TIMESTAMP meets them: pandas' to_datetime
# infers one format from the first non-null value, and cells that do not
# fit it are NULL; where no format fits the first value, each cell is
# read on its own
TIMESTAMP_CORPUS = {
    "slash_then_iso": ["2020/01/02", "2020-01-02T03:04:05"],
    "iso_then_slash": ["2020-01-02T03:04:05", "2020/01/02", "2020-01-02"],
    "date_then_datetimes": ["2020-01-02", "2020-01-02 03:04:05",
                            "2020-01-02T03:04:05", "2021-12-31"],
    "space_datetimes": ["2020-01-02 03:04:05", "2020-01-02T03:04:05",
                        "2020-12-31 23:59:60", "2020-02-29 00:00:00"],
    "minutes": ["2020-01-02T03:04", "2020-01-02T03:04:05", "2020-1-2T3:4"],
    "fractions": ["2020-01-02T03:04:05.123456", "2020-01-02T03:04:05",
                  "2020-01-02T03:04:05.1", "2020-01-02T03:04:05.123456789",
                  "2020-01-02T03:04:05.1234567890"],
    "sub_micro_negative": ["1969-12-31T23:59:59.9999995",
                           "1969-12-31T23:59:59.0000001"],
    "zulu_and_offsets": ["2020-01-02T03:04:05Z", "2020-01-02T03:04:05+01:00",
                         "2020-01-02T03:04:05-0530", "2020-01-02T03:04:05+05",
                         "2020-01-02T03:04:05"],
    "offset_first": ["2020-01-02T03:04:05+05:30", "2020-01-02T03:04:05Z",
                     "2020-01-02 03:04:05+05:30"],
    "fraction_and_offset": ["2020-01-02T03:04:05.250Z",
                            "2020-01-02T03:04:05Z"],
    "nulls_first": [None, "NaT", "", "2020-01-02", "x", None, "nan"],
    "garbage_first": ["nope", "2020-01-02", "2020/01/02 03:04"],
    "invalid_date_first": ["2020-02-30", "2020-02-29", "2020-13-01"],
    "leap_second_first": ["2020-12-31 23:59:60", "2020-12-31 23:59:59"],
    "slash_leap_seconds": ["2020/01/02 03:04:05", "2020/12/31 23:59:60",
                           "2020/12/31 23:59:61"],
    "year_month": ["2020-01", "2020-01-02", "2021-12"],
    "single_digit_fields": ["2020-1-2", "2020-01-02", "2020/1/2"],
    "all_null": [None, None],
    "old_years": ["1600-01-01", "2300-06-30T12:00:00", "0999-05-05"],
    "low_year_first": ["0999-05-05T01:02:03", "2020-01-02T03:04:05"],
    # the forms below are read differently (listed in TIMESTAMP_DIFFER)
    "month_name": ["Jan 2 2020", "2020-01-02", "Feb 3 2021"],
    "month_name_later": [None, "2020-01-02", "Jan 2 2020"],
    "comma_fraction": ["2020-01-02T03:04:05,5", "2020-01-02T03:04:05"],
    "space_before_offset": ["2020-01-02T03:04:05 +05:00"],
    "low_year_beside_nanoseconds": ["0001-01-01",
                                    "2020-01-02T03:04:05.123456789"],
}
# forms where the port and pd.to_datetime still differ, by name:
# - month_name: pandas infers '%b %d %Y' from 'Jan 2 2020' (the port
#   knows no month names: the column reads each cell on its own, so the
#   ISO cell is a value there and NULL in pandas);
# - comma_fraction, space_before_offset: the first value fits no format
#   the port knows, so pandas reads every cell with dateutil, which also
#   takes a decimal comma and a space before the offset (the port: NULL);
# - low_year_beside_nanoseconds: a first value below year 1000 infers no
#   format in either; pandas then gives the column one unit, and year 1
#   does not fit nanoseconds (NULL there, a value in the port).
# month_name_later agrees: its first value infers '%Y-%m-%d' in both.
TIMESTAMP_DIFFER = {"month_name", "comma_fraction", "space_before_offset",
                    "low_year_beside_nanoseconds"}


def _pandas_micros(cells):
    """pd.to_datetime(cells, errors="coerce", utc=True) as (epoch micros,
    validity); pandas picks the result's unit, the micros are floored."""
    import warnings

    import pandas as pd

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = pd.to_datetime(list(cells), errors="coerce", utc=True)
    ok = ~np.asarray(r.isna())
    raw = np.asarray(r.asi8)
    scale = {"s": 10**6, "ms": 10**3, "us": 1}.get(r.unit)
    vals = raw * scale if scale else raw // 10**3
    return np.where(ok, vals, 0), ok


@pytest.mark.parametrize("name", sorted(TIMESTAMP_CORPUS))
def test_string_to_timestamp_matches_pandas(name):
    """The port's CAST(<string> AS TIMESTAMP) parse against
    ``pd.to_datetime(list, errors="coerce", utc=True)`` called directly
    (the JAX package's cast calls it, and on pandas 3 reads its result in
    the wrong unit): the same NULLs and, elsewhere, the same micros,
    except the named forms of TIMESTAMP_DIFFER, which must still
    differ."""
    from arroyo_tpu_torch.sql.compiler import _parse_timestamps

    cells = TIMESTAMP_CORPUS[name]
    vals, ok = _parse_timestamps(np.array(cells, dtype=object))
    want_vals, want_ok = _pandas_micros(cells)
    same = (np.array_equal(ok, want_ok)
            and np.array_equal(vals[ok], want_vals[want_ok]))
    assert same != (name in TIMESTAMP_DIFFER), (
        name, list(zip(ok, vals)), list(zip(want_ok, want_vals)))


def test_cast_string_to_timestamp_in_sql():
    """The cast through the port's planner: one format from the first
    value, a cell that does not fit it NULL."""
    from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
    from arroyo_tpu_torch.engine.engine import LocalRunner
    from arroyo_tpu_torch.sql import Planner, SchemaProvider

    cells = ["2020/01/02", "2020-01-02T03:04:05", None, "2021/03/04"]
    p = SchemaProvider()
    p.add_memory_table("t", {"s": "s"}, [Batch(
        np.arange(4, dtype=np.int64), {"s": np.array(cells, dtype=object)})])
    clear_sink("results")
    LocalRunner(Planner(p).plan(
        "SELECT CAST(s AS TIMESTAMP) AS t FROM t WHERE "
        "CAST(s AS TIMESTAMP) IS NOT NULL"), device="cpu").run()
    got = [int(x) for b in sink_output("results")
           for x in b.columns["t"].tolist()]
    want_vals, want_ok = _pandas_micros(cells)
    assert got == want_vals[want_ok].tolist() and len(got) == 2
