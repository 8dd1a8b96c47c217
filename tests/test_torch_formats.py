"""The port's wire formats (``arroyo_tpu_torch.formats``) against
arroyo_tpu's, on the CPU: the same payloads or rows, made from a seed,
through both packages' formats give equal rows and equal bytes.

* JSON: the option matrix (the confluent 5-byte header strip,
  ``unstructured``, the ``include_schema`` envelope, Debezium envelopes),
  the bulk decode path against the JAX package's bulk path (its pyarrow
  reader is not ported), the schema helpers;
* the encoders: ``encode_json_lines`` and ``serialize_batch`` byte for
  byte, tricky columns included (tests/test_formats.py's egress inputs);
* raw strings, Avro (roundtrip, logical types, the framing guard, the
  rejected schema shapes, schema inference), and the schema-registry
  client against a loopback fake registry (tests/test_kafka_integration.py's);
* ``make_format`` for every name the JAX package knows."""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import arroyo_tpu.formats as jf
import arroyo_tpu_torch.formats as pf
from arroyo_tpu.connectors import schema_registry as jreg
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch.connectors import schema_registry as preg
from arroyo_tpu_torch.types import Batch
from test_kafka_integration import _FakeRegistry


@pytest.fixture
def fake_registry():
    r = _FakeRegistry()
    yield r
    r.close()


def _cols(batch):
    """(timestamp list, column name -> (dtype, values)) with NaN as a
    string, so two batches compare with ==."""
    def cell(v):
        return "NaN" if isinstance(v, float) and v != v else v
    return (batch.timestamp.tolist(),
            {n: (str(c.dtype), [cell(v) for v in c.tolist()])
             for n, c in batch.columns.items()})


def _batches(ts, cols):
    return (JaxBatch(ts.copy(), {k: v.copy() for k, v in cols.items()}),
            Batch(ts.copy(), {k: v.copy() for k, v in cols.items()}))


# -- JSON decode ----------------------------------------------------------------------

ROWS = {
    "nullable_bools": [{"f": True, "i": 1}, {"f": None, "i": 2},
                       {"f": False, "i": 3}],
    "digit_strings": [{"s": "01234", "n": 5}, {"s": "99", "n": 6}],
    "missing_numeric": [{"a": 1, "b": 2.5}, {"b": 3.5}, {"a": 4}],
    "all_null_column": [{"x": None, "k": 1}, {"x": None, "k": 2}],
    "unicode_strings": [{"s": "café ☃", "k": 1},
                        {"s": "line\nbreak \"q\"", "k": 2}],
    "int_float_mix": [{"v": 1, "k": 1}, {"v": 2.5, "k": 2}],
    "timestamps": [{"ts": 100 + i, "v": i} for i in range(4)],
}


def _debezium_payloads():
    env = [({"before": None, "after": {"id": 1, "v": "a"}, "op": "c"}, True),
           ({"before": {"id": 1, "v": "a"}, "after": {"id": 1, "v": "b"},
             "op": "u"}, True),
           ({"before": {"id": 1, "v": "b"}, "after": None, "op": "d"}, True),
           ({"before": None, "after": {"id": 2, "v": "c"}, "op": "r"},
            False),
           ({"before": {"id": 9, "v": "z"}, "after": None, "op": "u"}, False)]
    return [json.dumps({"payload": e} if wrapped else e).encode()
            for e, wrapped in env]


def _payload_cases():
    cases = {}
    for name, rows in ROWS.items():
        payloads = [json.dumps(r).encode() for r in rows]
        cases[f"plain-{name}"] = ({}, payloads)
        cases[f"confluent-{name}"] = (
            {"confluent_schema_registry": True},
            [b"\x00\x00\x00\x00\x07" + p for p in payloads])
        cases[f"unstructured-{name}"] = ({"unstructured": True}, payloads)
        cases[f"schema-{name}"] = (
            {"include_schema": True},
            jf.JsonFormat(include_schema=True).serialize(rows))
    cases["debezium"] = ({"debezium": True}, _debezium_payloads())
    cases["confluent-unframed"] = (
        {"confluent_schema_registry": True},
        [json.dumps({"v": 42}).encode()])
    cases["arrays-and-scalars"] = ({}, [
        json.dumps([{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]).encode(),
        b"1", b'"two"', b"3.5"])
    return cases


PAYLOADS = _payload_cases()


@pytest.mark.parametrize("fast", ["1", "0"])
@pytest.mark.parametrize("case", sorted(PAYLOADS))
def test_json_decode_matches_jax(case, fast, monkeypatch):
    """Rows (``deserialize``) and the columnar batch equal the JAX
    package's for every JSON option; the fast batch equals the JAX
    package's bulk path (its route without pyarrow)."""
    opts, payloads = PAYLOADS[case]
    monkeypatch.setenv("ARROYO_FAST_DECODE", fast)
    jax_fmt, fmt = jf.JsonFormat(**opts), pf.JsonFormat(**opts)
    assert fmt.deserialize(payloads) == jax_fmt.deserialize(payloads)
    ts_field = "ts" if case.endswith("timestamps") else None
    if fast == "1" and not (opts.get("debezium") or opts.get("unstructured")
                            or opts.get("include_schema")):
        want = jax_fmt._batch_bulk(payloads, ts_field)
    else:
        want = jax_fmt.batch(payloads, ts_field)
    got = fmt.batch(payloads, ts_field)
    if ts_field not in got.columns:  # ingestion times differ
        got.timestamp, want.timestamp = got.timestamp[:0], want.timestamp[:0]
    assert _cols(got) == _cols(want)
    assert pf.batch_to_rows(got) == jf.batch_to_rows(want)


def test_debezium_unwrap_ops_match_jax():
    rows = pf.make_format("debezium_json").deserialize(_debezium_payloads())
    assert rows == jf.make_format("debezium_json").deserialize(
        _debezium_payloads())
    assert [r["__op"] for r in rows] == ["append", "retract", "append",
                                         "retract", "append", "retract"]


SER_ROWS = [{"id": 1, "v": "a", "__op": "append"},
            {"id": 2, "v": None, "__op": "retract"},
            {"id": 3, "x": 1.5, "y": [1, 2]},
            {"n": np.int64(7), "f": np.float64("nan"), "b": np.bool_(True)}]


@pytest.mark.parametrize("opts", [{}, {"include_schema": True},
                                  {"debezium": True}],
                         ids=["plain", "include_schema", "debezium"])
def test_json_serialize_bytes_match_jax(opts):
    """The same bytes; the Debezium envelope leaves the caller's rows as
    they were (tests/test_connectors.py::
    test_debezium_serialize_does_not_mutate_input)."""
    rows = [dict(r) for r in SER_ROWS]
    got = pf.JsonFormat(**opts).serialize(rows)
    assert got == jf.JsonFormat(**opts).serialize([dict(r)
                                                   for r in SER_ROWS])
    assert rows == SER_ROWS and pf.JsonFormat(**opts).serialize(rows) == got
    back = pf.JsonFormat(**opts).deserialize(got)
    assert back == jf.JsonFormat(**opts).deserialize(got)


def test_json_schema_helpers_match_jax():
    samples = [[{"a": 1, "b": "s", "c": 1.5, "d": True}],
               [{"a": 1}, {"a": "x"}, {"a": None, "z": [1]}, {"o": {"p": 1}}],
               [{"n": np.int32(3), "f": np.float32(1.0), "e": None}]]
    for rows in samples:
        assert pf.json_schema_for_rows(rows) == jf.json_schema_for_rows(rows)
    schemas = [
        {"type": "object", "properties": {
            "a": {"type": "integer"}, "b": {"type": ["string", "null"]},
            "t": {"type": "string", "format": "date-time"},
            "n": {"type": "object", "properties": {"x": {"type": "number"},
                                                   "y": {"type": "boolean"}}}}},
        {"type": ["null", "object"], "properties": {"a": {"type": "number"}}},
    ]
    for s in schemas:
        assert pf.columns_from_json_schema(s) == jf.columns_from_json_schema(s)
    for bad in ({"type": "array"}, {"type": "object", "properties": {}},
                {"type": "object", "properties": {"a": {"type": "array"}}}):
        with pytest.raises(ValueError) as want:
            jf.columns_from_json_schema(bad)
        with pytest.raises(ValueError) as got:
            pf.columns_from_json_schema(bad)
        assert str(got.value) == str(want.value)


# -- JSON encode ----------------------------------------------------------------------


def _tricky():
    """tests/test_formats.py::test_egress_parity_tricky_columns' batch."""
    f = np.array([1.5, np.nan, np.inf, -np.inf], dtype=np.float64)
    return np.arange(4, dtype=np.int64), {
        "i": np.array([1, -2, 3, 40], dtype=np.int64),
        "f": f,
        "b": np.array([True, False, True, False]),
        "nb": np.array([True, None, False, None], dtype=object),
        "s": np.array(["01234", 'q"uote', "café", "x\ny"], dtype=object)}


def _seeded(seed=7, n=64):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n) * 10.0 ** rng.integers(-5, 12, n)
    f[rng.random(n) < 0.1] = np.nan
    obj = np.array([None if x < 0.2 else (float("nan") if x < 0.3 else
                    (np.float64(x) if x < 0.5 else f"s{x:.3f}"))
                    for x in rng.random(n)], dtype=object)
    return np.arange(n, dtype=np.int64), {
        "p%ct": rng.integers(-2**62, 2**62, n),
        "u": rng.integers(0, 2**31, n).astype(np.uint32),
        "f": f, "f32": f.astype(np.float32),
        "b": rng.random(n) < 0.5, "obj": obj,
        "uni": np.array([f"ü{i}" for i in range(n)]),
        "by": np.array([b"x\xffy"] * n, dtype=object),
        "ints": np.array([np.int16(i) if i % 2 else i for i in range(n)],
                         dtype=object)}


BATCHES = {"tricky": _tricky, "seeded": _seeded,
           "empty_columns": lambda: (np.arange(3, dtype=np.int64), {}),
           "nested": lambda: (np.arange(2, dtype=np.int64), {
               "k": np.array([1, 2]),
               "nest": np.array([{"a": 1}, {"b": 2}], dtype=object)})}


@pytest.mark.parametrize("nan_literal", ["null", "NaN"])
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_encode_json_lines_bytes_match_jax(name, nan_literal):
    jb, pb = _batches(*BATCHES[name]())
    got = pf.encode_json_lines(pb, nan_literal=nan_literal)
    assert got == jf.encode_json_lines(jb, nan_literal=nan_literal)
    assert (got is None) == (name == "nested")


@pytest.mark.parametrize("fast", ["1", "0"])
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_serialize_batch_bytes_match_jax(name, fast, monkeypatch):
    """serialize_batch, fast or row path, gives the JAX package's bytes
    (tests/test_formats.py::test_egress_parity_tricky_columns)."""
    monkeypatch.setenv("ARROYO_FAST_DECODE", fast)
    jb, pb = _batches(*BATCHES[name]())
    for opts in ({}, {"debezium": True}, {"include_schema": True}):
        got = pf.JsonFormat(**opts).serialize_batch(pb)
        assert got == jf.JsonFormat(**opts).serialize_batch(jb)
    assert pf.batch_to_rows(pb) == jf.batch_to_rows(jb)


# -- raw strings ----------------------------------------------------------------------


def test_raw_string_matches_jax():
    payloads = [b"hello", "txt", b"caf\xc3\xa9", b"\xff bad", None]
    rows = [{"value": "bye"}, {"only": 3}, {"a": 1, "b": np.int64(2)},
            {"value": None, "x": 1.5}]
    for name in ("raw", "raw_string"):
        got, want = pf.make_format(name), jf.make_format(name)
        assert got.deserialize(payloads) == want.deserialize(payloads)
        assert got.serialize(rows) == want.serialize(rows)
    jb, pb = _batches(np.arange(2, dtype=np.int64),
                      {"value": np.array(["a", "b"], dtype=object)})
    assert pf.RawStringFormat().serialize_batch(pb) == \
        jf.RawStringFormat().serialize_batch(jb)


# -- Avro -----------------------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(st.integers(min_value=-2**63, max_value=2**63 - 1))
def test_zigzag_varints_match_jax(n):
    enc = pf._zigzag_encode(n)
    assert enc == jf._zigzag_encode(n)
    assert pf._zigzag_decode(b"\x07" + enc, 1) == (n, 1 + len(enc))


def _avro_rows(seed=3, n=40):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        r = {"i": int(rng.integers(-2**40, 2**40)), "s": f"s{i}é" * (i % 3),
             "f": float(rng.normal()), "b": bool(rng.random() < 0.5),
             "n": None if i % 4 else int(i)}
        if i % 5 == 0:
            r["s"] = None
        rows.append(r)
    return rows


def test_avro_roundtrip_bytes_match_jax():
    rows = _avro_rows()
    schema = pf.avro_schema_for_rows(rows)
    assert schema == jf.avro_schema_for_rows(rows)
    assert pf.avro_schema_for_rows(rows, "X") == jf.avro_schema_for_rows(
        rows, "X")
    got = pf.AvroFormat(schema=schema).serialize(rows)
    assert got == jf.AvroFormat(schema=schema).serialize(rows)
    assert pf.AvroFormat(schema=json.dumps(schema)).deserialize(got) == rows
    framed = pf.AvroFormat(schema=schema, confluent_schema_registry=True,
                           schema_id=42).serialize(rows)
    assert framed == jf.AvroFormat(schema=schema,
                                   confluent_schema_registry=True,
                                   schema_id=42).serialize(rows)
    assert framed[0][:5] == b"\x00\x00\x00\x00\x2a"
    jb = jf.AvroFormat(schema=schema).batch(got, "i")
    pb = pf.AvroFormat(schema=schema).batch(got, "i")
    assert _cols(pb) == _cols(jb)
    # no configured schema: inferred a call, the instance left as it was
    f = pf.AvroFormat()
    assert f.serialize(rows) == jf.AvroFormat().serialize(rows)
    assert f.schema is None


def test_avro_logical_types_and_framing_guard_match_jax():
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "u", "type": ["null", {"type": "string",
                                        "logicalType": "uuid"}]},
        {"name": "ts", "type": ["null", {"type": "long",
                                         "logicalType": "timestamp-micros"}]},
        {"name": "d", "type": ["null", {"type": "bytes",
                                        "logicalType": "decimal",
                                        "precision": 4, "scale": 2}]},
        {"name": "x", "type": ["null", "float"]},
        {"name": "y", "type": ["null", "int"]}]}
    rows = [{"u": "ab-cd", "ts": 123456, "d": b"\x01\x02", "x": 0.5,
             "y": -3},
            {"u": None, "ts": -1, "d": None, "x": None, "y": 2**31 - 1}]
    plain = pf.AvroFormat(schema=schema).serialize(rows)
    assert plain == jf.AvroFormat(schema=schema).serialize(rows)
    assert pf.AvroFormat(schema=schema).deserialize(plain) == rows
    fc, jfc = (pf.AvroFormat(schema=schema, confluent_schema_registry=True),
               jf.AvroFormat(schema=schema, confluent_schema_registry=True))
    framed = fc.serialize(rows)
    # a confluent decoder strips the header only where it is there
    mixed = [framed[0], plain[0], framed[1]]
    assert plain[0][0] != 0
    assert fc.deserialize(mixed) == jfc.deserialize(mixed) == \
        [rows[0], rows[0], rows[1]]


BAD_SCHEMAS = {
    "plain": ({"name": "i", "type": "long"}, {"i": 5}),
    "flipped": ({"name": "i", "type": ["long", "null"]}, {"i": 5}),
    "three_way": ({"name": "i", "type": ["null", "long", "string"]},
                  {"i": 5}),
    "map": ({"name": "m", "type": ["null", {"type": "map",
                                            "values": "long"}]}, {"m": {}}),
    "record": ({"name": "m", "type": ["null", "record"]}, {"m": 1}),
}


@pytest.mark.parametrize("name", sorted(BAD_SCHEMAS))
def test_avro_rejects_the_shapes_jax_rejects(name):
    field, row = BAD_SCHEMAS[name]
    schema = {"type": "record", "name": "r", "fields": [field]}
    for call in (lambda m: m.AvroFormat(schema=schema).serialize([row]),
                 lambda m: m.AvroFormat(schema=schema).deserialize(
                     [b"\x02\x0a"])):
        with pytest.raises(ValueError) as want:
            call(jf)
        with pytest.raises(ValueError) as got:
            call(pf)
        assert str(got.value) == str(want.value)


def test_avro_without_schema_or_registry_rejected():
    for m in (jf, pf):
        with pytest.raises(ValueError, match="schema"):
            m.AvroFormat(confluent_schema_registry=True).deserialize(
                [b"\x00\x00\x00\x00\x01\x02"])


# -- the schema registry ----------------------------------------------------------------


def test_registry_client_matches_jax(fake_registry):
    """Register and fetch against the loopback fake in both packages:
    the same ids, the same schemas, the same errors."""
    schema = {"type": "record", "name": "ev", "fields": [
        {"name": "k", "type": ["null", "long"]}]}
    jc, pc = (jreg.SchemaRegistryClient(fake_registry.url),
              preg.SchemaRegistryClient(fake_registry.url))
    sid = pc.register("ev-value", schema)
    assert jc.register("ev-value", schema) == sid
    assert pc.register("ev-value", json.dumps(schema)) == sid
    assert pc.register("other-value", schema, "JSON") != sid
    assert pc.get_schema(sid) == jc.get_schema(sid) == schema
    assert preg.registry_client(fake_registry.url) is \
        preg.registry_client(fake_registry.url)
    with pytest.raises(preg.SchemaRegistryError, match="404"):
        pc.get_schema(99)
    with pytest.raises(preg.SchemaRegistryError, match="failed"):
        preg.SchemaRegistryClient("http://127.0.0.1:1").get_schema(1)


def test_avro_through_the_registry_matches_jax(fake_registry):
    """tests/test_kafka_integration.py::
    test_avro_confluent_roundtrip_via_registry in both packages: a writer
    registers its schema (the id rides the header); a reader with only
    the registry URL resolves each payload's writer schema, across a
    schema change."""
    v1 = {"type": "record", "name": "ev", "fields": [
        {"name": "k", "type": ["null", "long"]}]}
    v2 = {"type": "record", "name": "ev", "fields": [
        {"name": "k", "type": ["null", "long"]},
        {"name": "v", "type": ["null", "double"]}]}
    payloads = []
    for schema, rows in ((v1, [{"k": 1}, {"k": 2}]), (v2, [{"k": 3,
                                                           "v": 1.5}])):
        got = pf.AvroFormat(schema=schema,
                            schema_registry_url=fake_registry.url,
                            subject="ev-value").serialize(rows)
        assert got == jf.AvroFormat(schema=schema,
                                    schema_registry_url=fake_registry.url,
                                    subject="ev-value").serialize(rows)
        payloads += got
    assert all(p[0] == 0 for p in payloads)
    reader = pf.AvroFormat(schema_registry_url=fake_registry.url)
    assert reader.deserialize(payloads) == [{"k": 1}, {"k": 2},
                                            {"k": 3, "v": 1.5}]
    assert reader.deserialize(payloads) == jf.AvroFormat(
        schema_registry_url=fake_registry.url).deserialize(payloads)


# -- make_format ----------------------------------------------------------------------

FORMATS = [("json", {}), ("json", {"confluent_schema_registry": True,
                                   "unstructured": True}),
           ("json", {"include_schema": True}), ("debezium_json", {}),
           ("raw", {}), ("raw_string", {}),
           ("avro", {"schema": {"type": "record", "name": "r", "fields": [
               {"name": "a", "type": ["null", "long"]}]},
               "schema_id": 3, "confluent_schema_registry": True})]


@pytest.mark.parametrize("i", range(len(FORMATS)))
def test_make_format_builds_what_jax_builds(i):
    name, opts = FORMATS[i]
    got, want = pf.make_format(name, **opts), jf.make_format(name, **opts)
    assert type(got).__name__ == type(want).__name__
    fields = ("confluent_schema_registry", "unstructured", "include_schema",
              "debezium", "schema", "confluent", "schema_id")
    assert {f: getattr(got, f, None) for f in fields} == \
        {f: getattr(want, f, None) for f in fields}
    rows = [{"a": 1, "value": "v"}]
    assert got.serialize(rows) == want.serialize(rows)
    for m in (jf, pf):
        with pytest.raises(ValueError, match="unknown format"):
            m.make_format("protobuf")
