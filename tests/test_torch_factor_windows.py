"""Factor windows in the port (graph/factor_windows.py, the factor and
derived-window operators, ``KeyedBinState``'s merge-input mode and
barrier drain, the plan validator) against arroyo_tpu, on the CPU.

* plans: bench.py's correlated-windows SQL at K = 2 and 8 and the JAX
  tests' pair plan into the JAX package's nodes, ids, specs, edges and
  factor decisions; the Stream-API cases (direct shape, single member,
  non-decomposable aggregate, mismatched keys, pathological gcd, the
  knob off, a pane ratio at and just over the cap of 64) decide and
  rewrite as there; common-subplan elimination merges as there;
* state: a factor ring (fires and barrier drains) feeding derived rings
  in merge-input mode, NaN partials included, bit-equal to the JAX
  states: fire rows, planes and snapshots;
* rows: the port's factored rows equal the JAX package's factored rows
  and the port's unfactored rows, COUNT(*), COUNT(c), SUM, AVG, MIN and
  MAX over a column with NULLs;
* checkpoints: factored -> unfactored -> factored through
  ``RunningEngine.checkpoint(epoch, then_stop=True)`` emits exactly the
  rows of an uninterrupted run; the derived ring's table restores across
  the packages both ways;
* the validator: ``validate_program``'s diagnostics equal the JAX
  package's on every SQL program of test_torch_sql_plan.py and on
  mutated plans."""

import asyncio
import math
from collections import Counter

import numpy as np
import pytest

from arroyo_tpu import Stream as JaxStream
from arroyo_tpu.analysis.plan_validator import (
    validate_program as jax_validate)
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.engine.operators_window import (
    DerivedWindowOperator as JaxDerived)
from arroyo_tpu.graph import factor_windows as jfw
from arroyo_tpu.graph.logical import AggKind as JAggKind
from arroyo_tpu.graph.logical import AggSpec as JAggSpec
from arroyo_tpu.graph.logical import EdgeType as JEdgeType
from arroyo_tpu.ops.keyed_bins import KeyedBinState as JaxState
from arroyo_tpu.sql import SchemaProvider as JaxProvider
from arroyo_tpu.sql import plan_sql as jax_plan_sql
from arroyo_tpu.sql.planner import Planner as JaxPlanner
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch import Stream, queries
from arroyo_tpu_torch.analysis.plan_validator import (
    PlanValidationError, check_program, validate_program)
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
from arroyo_tpu_torch.engine.operators_window import DerivedWindowOperator
from arroyo_tpu_torch.graph import factor_windows as pfw
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec, EdgeType, OpKind
from arroyo_tpu_torch.obs import perf
from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState as PortState
from arroyo_tpu_torch.sql import Planner, SchemaProvider, plan_sql
from arroyo_tpu_torch.state.backend import InMemoryBackend
from arroyo_tpu_torch.types import Batch, hash_columns
from test_torch_sql_plan import (CORPUS, FACTOR_PAIR, HAND_BUILT, PLANNED,
                                 _signature)

SEC = 1_000_000
WIDTHS = [10, 4, 20, 6, 16, 8, 30, 14]  # bench.py's correlated widths


@pytest.fixture
def jax_like_port(monkeypatch):
    """The JAX package on one device (no mesh state), its host library
    on its default, as the port's."""
    monkeypatch.setenv("ARROYO_MESH", "off")


def correlated_sql(k, n, rate=1_000_000, batch=8_192):
    """bench.py's ``run_correlated_windows`` SQL for ``k`` hop windows
    (2 s slide), event time pinned to 0."""
    parts = [queries.SRC.format(n=n, b=batch).replace(
        "event_rate = '1000000'", f"event_rate = '{rate}'").replace(
        f"batch_size = '{batch}'",
        f"batch_size = '{batch}', base_time_micros = '0'")]
    for i in range(k):
        parts.append(
            f"CREATE TABLE cw{i} (auction BIGINT, window_end BIGINT, num "
            f"BIGINT, tot BIGINT) WITH (connector = 'memory', name = "
            f"'cw{i}', type = 'sink');")
        parts.append(
            f"INSERT INTO cw{i}\nSELECT bid.auction as auction,\n"
            f"  HOP(INTERVAL '2' SECOND, INTERVAL '{WIDTHS[i]}' SECOND) "
            f"as window,\n  count(*) AS num, sum(bid.price) AS tot\n"
            f"FROM nexmark WHERE bid is not null GROUP BY 1, 2;")
    return "\n".join(parts)


def _decisions(prog):
    return [d.to_json() for d in getattr(prog, "factor_decisions", [])]


# -- plans ---------------------------------------------------------------------


@pytest.mark.parametrize("case", ["k2", "k8", "pair"])
def test_factored_plan_matches_jax(case, monkeypatch):
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "auto")
    sql = FACTOR_PAIR if case == "pair" else correlated_sql(
        int(case[1:]), 1000)
    jprog, prog = jax_plan_sql(sql), plan_sql(sql)
    assert _signature(prog) == _signature(jprog)
    assert _decisions(prog) == _decisions(jprog)
    kinds = Counter(n.operator.kind for n in prog.nodes())
    k = 2 if case == "pair" else int(case[1:])
    assert kinds[OpKind.WINDOW_FACTOR] == 1
    assert kinds[OpKind.DERIVED_WINDOW] == k
    assert kinds[OpKind.SLIDING_WINDOW_AGGREGATOR] == 0
    assert kinds[OpKind.KEY_BY] == 1  # one shared keying chain
    (d,) = [d for d in prog.factor_decisions if d.shared]
    assert d.pane_micros == 2 * SEC and d.inputs["k"] == k
    # the Engine's re-application is a no-op that keeps the decision
    before = _signature(prog)
    assert [x.to_json() for x in pfw.apply_factor_windows(prog)
            if x.shared] == [d.to_json()]
    assert _signature(prog) == before
    check_program(prog)


def _udaf_sum(v):
    return float(v.sum())


def _stream_pair(pkg, case):
    """Two Stream-API window aggregates off one source in the package
    ``pkg`` ('port' or 'jax'), shaped by ``case``."""
    S, kind, spec = ((Stream, AggKind, AggSpec) if pkg == "port"
                     else (JaxStream, JAggKind, JAggSpec))
    wa, sa, wb, sb = 10 * SEC, 2 * SEC, 4 * SEC, 2 * SEC
    if case == "pathological_gcd":
        wa = sa = 2 * SEC + 2
    if case in ("max_ratio_refuses", "max_ratio_shares"):
        # pane = gcd = 1 ms; min(slides) / pane = 65 (over the cap of
        # 64) or 64 (at it)
        over = case == "max_ratio_refuses"
        wa = sa = (65 if over else 64) * 1_000
        wb = sb = (66 if over else 65) * 1_000
    aggs_b = [spec(kind.SUM, "counter", "s")]
    if case == "non_decomposable":
        aggs_b = [spec(kind.UDAF, "counter", "u", fn=_udaf_sum)]
    src = S.source("impulse", {"message_count": 100}).watermark(name="wm")
    keyed = src.key_by("counter")
    keyed.sliding_aggregate(wa, sa, [spec(kind.COUNT, None, "c")],
                            name="agg_a").sink("blackhole", {})
    if case == "single_member":
        return keyed.program
    second = src.key_by("subtask_index") if case == "mismatched_keys" \
        else keyed
    second.sliding_aggregate(wb, sb, aggs_b, name="agg_b").sink(
        "blackhole", {})
    return keyed.program


STREAM_CASES = {
    # case -> (environment, expected shared decisions)
    "direct": ({}, [True]),
    "single_member": ({}, []),
    "non_decomposable": ({}, []),
    "mismatched_keys": ({}, []),
    "pathological_gcd": ({}, [False]),
    "knob_off": ({"ARROYO_FACTOR_WINDOWS": "0"}, []),
    "max_ratio_refuses": ({}, [False]),
    "max_ratio_shares": ({}, [True]),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_api_decisions_match_jax(case, monkeypatch):
    env, shared = STREAM_CASES[case]
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "auto")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    shape = "direct" if case == "knob_off" else case
    jprog, prog = _stream_pair("jax", shape), _stream_pair("port", shape)
    assert _decisions(prog) == [] and [
        d.to_json() for d in pfw.plan_factor_windows(prog)] == [
        d.to_json() for d in jfw.plan_factor_windows(jprog)]
    got = pfw.apply_factor_windows(prog)
    want = jfw.apply_factor_windows(jprog)
    assert [d.to_json() for d in got] == [d.to_json() for d in want]
    assert [d.shared for d in got] == shared
    assert _signature(prog) == _signature(jprog)
    factored = OpKind.WINDOW_FACTOR in {n.operator.kind
                                        for n in prog.nodes()}
    assert factored == (shared == [True])
    if case in ("pathological_gcd", "max_ratio_refuses"):
        assert got[0].reason == "pane_ratio_exceeded"
        assert got[0].pane_micros == (2 if case == "pathological_gcd"
                                      else 1_000)
    if factored:
        check_program(prog)


def test_engine_applies_the_rewrite_to_stream_programs(monkeypatch):
    """``Engine`` rewrites a Stream-API program before it builds it and
    keeps the decisions; the program then validates."""
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "auto")
    prog = _stream_pair("port", "direct")
    engine = Engine(prog, device="cpu")
    assert [d.shared for d in engine.factor_decisions] == [True]
    assert OpKind.WINDOW_FACTOR in {n.operator.kind for n in prog.nodes()}


@pytest.mark.parametrize("query", ["q5", "q8"])
def test_cse_matches_jax(query, monkeypatch):
    """Common-subplan elimination merges q5's duplicated HOP aggregate
    (planned as the reference plans it, ``ARROYO_ARGMAX=0``) and q8's two
    scans into the JAX package's nodes, and a second pass finds nothing
    more to merge."""
    monkeypatch.setenv("ARROYO_ARGMAX", "0")
    prog = plan_sql(CORPUS[query]())
    assert _signature(prog) == _signature(jax_plan_sql(CORPUS[query]()))
    assert prog.eliminate_common_subplans() == 0


# -- state: the factor ring, its drain and the derived rings ------------------

PANE = 1_000
# members: (width, slide, aggs); aggs (kind, column, output)
MEMBERS = [
    (4_000, 2_000, [("count", None, "n"), ("count", "x", "cx"),
                    ("sum", "x", "sx"), ("avg", "x", "ax"),
                    ("min", "x", "lo"), ("max", "x", "hi")]),
    (2_000, 1_000, [("sum", "x", "sx"), ("count", None, "n")]),
]


def _specs(pkg, aggs):
    spec, kind = (AggSpec, AggKind) if pkg == "port" else (JAggSpec,
                                                           JAggKind)
    return tuple(spec(kind(k), c, o) for k, c, o in aggs)


def _factor_states():
    """(jax, port) factor rings and, per member, (jax, port) derived
    rings in merge-input mode."""
    out = []
    for pkg, fw, State in (("jax", jfw, JaxState), ("port", pfw, PortState)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        member_aggs = [_specs(pkg, a) for _, _, a in MEMBERS]
        factor = State(fw.factor_aggs_for(member_aggs), PANE, PANE,
                       capacity=8, **kw)
        derived = []
        for (w, s, _), aggs in zip(MEMBERS, member_aggs):
            st = State(aggs, s, w, capacity=8, **kw)
            st.set_merge_inputs(fw.derived_channel_cols(aggs),
                                fw.ROWS_COLUMN)
            derived.append(st)
        out.append((factor, derived))
    return out


def _raw_stream(seed=3, n_batches=16):
    """Raw (keys, ts, x) batches: out-of-order time, NULL (NaN) values,
    a key whose every value is NULL (its panes carry NaN partials)."""
    rng = np.random.default_rng(seed)
    now, out = 5_000, []
    for _ in range(n_batches):
        n = int(rng.integers(40, 120))
        k = rng.integers(0, 12, n)
        ts = now + rng.integers(-1_200, 600, n)
        x = rng.normal(10, 5, n)
        x[rng.random(n) < 0.2] = np.nan
        x[k == 0] = np.nan
        keys = k.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        out.append((keys, ts.astype(np.int64), x, now - 1_500))
        now += int(rng.integers(300, 900))
    return out


def _same_fire(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for x, y in zip(a[:1] + a[2:], b[:1] + b[2:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a[1].keys() == b[1].keys()
    for c in a[1]:
        np.testing.assert_array_equal(np.asarray(a[1][c]),
                                      np.asarray(b[1][c]), err_msg=c)


def _same_state(j, p):
    js, ps = j.snapshot(), p.snapshot()
    assert js.keys() == ps.keys()
    for name in js:
        np.testing.assert_array_equal(np.asarray(js[name]),
                                      np.asarray(ps[name]), err_msg=name)
    np.testing.assert_array_equal(np.asarray(j.values), p.values.numpy())
    np.testing.assert_array_equal(np.asarray(j.counts), p.counts.numpy())


def _to_derived(fired, derived):
    """Feed a factor fire or drain into the derived rings."""
    if fired is None:
        return
    keys, cols, window_end, _ = fired
    for st in derived:
        st.update(keys, window_end - 1, cols)


def test_merge_mode_and_drain_match_jax(jax_like_port):
    """Fires, barrier drains (every third batch) and derived fires are
    bit-equal to the JAX states', and so are planes and snapshots; a
    drain leaves ``last_fired_pane``, ``min_bin`` and the fire density
    where they were, and the drained cells at their identities."""
    (jf, jd), (pf, pd) = _factor_states()
    drained_rows = 0
    for i, (keys, ts, x, wm) in enumerate(_raw_stream()):
        for f in (jf, pf):
            f.update(keys, ts, {"x": x})
        fires = [f.fire_panes(wm) for f in (jf, pf)]
        _same_fire(*fires)
        _to_derived(fires[0], jd)
        _to_derived(fires[1], pd)
        if i % 3 == 2:
            before = (pf.last_fired_pane, pf.min_bin, pf._fire_density)
            drains = [f.drain_deltas() for f in (jf, pf)]
            _same_fire(*drains)
            assert (pf.last_fired_pane, pf.min_bin,
                    pf._fire_density) == before
            if drains[1] is not None:
                drained_rows += len(drains[1][0])
                # the drained span holds no mass until new rows land
                assert pf.drain_deltas() is None
            _to_derived(drains[0], jd)
            _to_derived(drains[1], pd)
            _same_state(jf, pf)
        for j, p in zip(jd, pd):
            _same_fire(j.fire_panes(wm), p.fire_panes(wm))
    assert drained_rows > 0
    # NaN partials reached the derived rings (key 0's panes are all NULL)
    finals = [f.fire_panes(0, final=True) for f in (jf, pf)]
    _same_fire(*finals)
    assert np.isnan(finals[1][1]["__f_sum_x"]).any()
    _to_derived(finals[0], jd)
    _to_derived(finals[1], pd)
    for j, p in zip(jd, pd):
        _same_state(j, p)
        _same_fire(j.fire_panes(0, final=True), p.fire_panes(0, final=True))
        _same_state(j, p)
    _same_state(jf, pf)


def test_merge_mode_counts_rows_not_pane_arrivals():
    """Two pane rows of one (key, bin) sum their row masses: COUNT(*) is
    rows, and the mass counts toward the i64 promotion."""
    (_, _), (_, (st, _)) = _factor_states()
    kh = np.array([7, 7, 7], np.uint64)
    ts = np.array([999, 1_999, 2_999], np.int64)  # bins 0, 0 and 1
    st.update(kh, ts, {"__f_rows": np.array([3, 4, 5]),
                       "__f_cnt_x": np.array([3, 0, 5.0]),
                       "__f_sum_x": np.array([1.5, np.nan, 2.0]),
                       "__f_min_x": np.array([0.5, np.nan, -1.0]),
                       "__f_max_x": np.array([1.0, np.nan, 2.0])})
    assert st.total_rows == 12
    keys, cols, end, cnt = st.fire_panes(0, final=True)
    # panes ending at bins 0, 1 and 2 of a 2-bin window
    assert cnt.tolist() == [7, 12, 5] and cols["n"].tolist() == [7, 12, 5]
    assert cols["cx"].tolist() == [3, 8, 5]
    assert cols["lo"].tolist() == [0.5, -1.0, -1.0]
    with pytest.raises(ValueError):
        st.set_merge_inputs({}, "__f_rows")


def test_update_counts_pane_update_rows():
    """``pane_update_rows`` counts rows entering every ring, raw or
    merged."""
    perf.reset()
    (_, _), (pf, pd) = _factor_states()
    keys, ts, x, _ = _raw_stream(n_batches=1)[0]
    pf.update(keys, ts, {"x": x})
    assert perf.counter("pane_update_rows") == len(keys)
    fired = pf.fire_panes(0, final=True)
    _to_derived(fired, pd)
    assert perf.counter("pane_update_rows") == len(keys) + 2 * len(fired[0])


# -- rows ------------------------------------------------------------------------

ROWS_SQL = """
CREATE TABLE s1 (k BIGINT, window_end BIGINT, n BIGINT, cx BIGINT,
  sx DOUBLE, ax DOUBLE, lo DOUBLE, hi DOUBLE) WITH (connector = 'memory',
  name = 'fr1', type = 'sink');
CREATE TABLE s2 (k BIGINT, window_end BIGINT, sx DOUBLE, n BIGINT) WITH (
  connector = 'memory', name = 'fr2', type = 'sink');
CREATE TABLE s3 (k BIGINT, window_end BIGINT, lo DOUBLE, ax DOUBLE) WITH (
  connector = 'memory', name = 'fr3', type = 'sink');
INSERT INTO s1 SELECT k, HOP(INTERVAL '1' SECOND, INTERVAL '4' SECOND)
  as window, count(*) AS n, count(x) AS cx, sum(x) AS sx, avg(x) AS ax,
  min(x) AS lo, max(x) AS hi FROM ev GROUP BY 1, 2;
INSERT INTO s2 SELECT k, HOP(INTERVAL '2' SECOND, INTERVAL '6' SECOND)
  as window, sum(x) AS sx, count(*) AS n FROM ev GROUP BY 1, 2;
INSERT INTO s3 SELECT k, TUMBLE(INTERVAL '2' SECOND) as window,
  min(x) AS lo, avg(x) AS ax FROM ev GROUP BY 1, 2;
"""
SINKS = ("fr1", "fr2", "fr3")


def _ev_batches(pkg):
    """Eight batches over 12 s of event time: keys 0-5, ``x`` with NULLs
    (NaN) and key 5 always NULL."""
    rng = np.random.default_rng(11)
    cls = Batch if pkg == "port" else JaxBatch
    out = []
    for i in range(8):
        n = 60
        ts = np.sort(rng.integers(i * 1_500_000, (i + 1) * 1_500_000, n))
        k = rng.integers(0, 6, n).astype(np.int64)
        x = rng.normal(20, 8, n)
        x[(rng.random(n) < 0.25) | (k == 5)] = np.nan
        out.append(cls(ts.astype(np.int64), {"k": k, "x": x}))
    return out


def _planners():
    jp, pp = JaxProvider(), SchemaProvider()
    kinds = {"k": "i", "x": "f"}
    jp.add_memory_table("ev", kinds, _ev_batches("jax"))
    pp.add_memory_table("ev", kinds, _ev_batches("port"))
    return JaxPlanner(jp), Planner(pp)


def _sink_rows(output):
    """Per sink: rows sorted by (key, window end), floats as floats."""
    out = {}
    for s in SINKS:
        rows = []
        for b in output(s):
            names = sorted(b.columns)
            for i in range(len(b)):
                rows.append(tuple([int(b.timestamp[i])] + [
                    b.columns[c][i].item() for c in names]))
        out[s] = sorted(rows, key=lambda r: (r[0], repr(r)))
    return out


def _close(a, b):
    assert a.keys() == b.keys()
    for s in a:
        assert len(a[s]) == len(b[s]) and a[s], s
        for ra, rb in zip(a[s], b[s]):
            for va, vb in zip(ra, rb):
                if isinstance(va, float) or isinstance(vb, float):
                    assert (math.isnan(va) and math.isnan(vb)) or math.isclose(
                        va, vb, rel_tol=1e-12), (s, ra, rb)
                else:
                    assert va == vb, (s, ra, rb)


def test_factored_rows_match_jax_and_unfactored(jax_like_port, monkeypatch):
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "auto")
    jplanner, planner = _planners()
    jprog, prog = jplanner.plan(ROWS_SQL), planner.plan(ROWS_SQL)
    assert _signature(prog) == _signature(jprog)
    assert sum(n.operator.kind == OpKind.DERIVED_WINDOW
               for n in prog.nodes()) == 3
    for s in SINKS:
        jax_clear_sink(s)
        clear_sink(s)
    JaxLocalRunner(jprog).run()
    LocalRunner(prog, device="cpu").run()
    want, got = _sink_rows(jax_sink_output), _sink_rows(sink_output)
    _close(got, want)
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "0")
    for s in SINKS:
        clear_sink(s)
    LocalRunner(_planners()[1].plan(ROWS_SQL), device="cpu").run()
    _close(_sink_rows(sink_output), got)


# -- checkpoints -----------------------------------------------------------------


def _ckpt_sql():
    return correlated_sql(2, 100_000, rate=10_000, batch=2_048)


async def _phase(factor, backend, restore, epoch, hold_after, monkeypatch):
    """One run of the two-window plan (factored under ``auto``): restored
    from ``restore``, checkpointed at ``epoch`` and stopped after the
    source's ``hold_after``-th batch, or run to its end."""
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", factor)
    prog = plan_sql(_ckpt_sql())
    assert (OpKind.WINDOW_FACTOR in {n.operator.kind for n in prog.nodes()}
            ) == (factor == "auto")
    engine = Engine(prog, "factor-rt", backend, restore_epoch=restore,
                    device="cpu")
    running = engine.start()
    if epoch is None:
        await running.join()
        return
    source = next(h.runner for h in engine.subtasks.values() if h.is_source)
    poll = source.poll_source_control
    held = asyncio.Event()
    batches = [0]

    async def hold_then_poll():
        batches[0] += 1
        if batches[0] == hold_after:
            held.set()
            while source.control_rx.empty():
                await asyncio.sleep(0.001)
        return await poll()

    source.poll_source_control = hold_then_poll
    await asyncio.wait_for(held.wait(), 60)
    await running.checkpoint(epoch, then_stop=True)
    assert await running.wait_for_checkpoint(epoch, timeout=60)
    await running.join()


def _cw_rows():
    return [sorted((int(b.timestamp[i]), int(b.columns["auction"][i]),
                    int(b.columns["num"][i]), int(b.columns["tot"][i]))
                   for b in sink_output(f"cw{j}") for i in range(len(b)))
            for j in range(2)]


def test_checkpoint_interchange_is_exactly_once(monkeypatch):
    """factored -> unfactored -> factored, each stopped at a barrier and
    the next restored from it: the rows equal an uninterrupted factored
    run's, and the factor drained pending panes at the first barrier."""
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "auto")
    for j in range(2):
        clear_sink(f"cw{j}")
    LocalRunner(plan_sql(_ckpt_sql()), device="cpu").run()
    reference = _cw_rows()
    assert all(reference)
    for j in range(2):
        clear_sink(f"cw{j}")
    backend = InMemoryBackend()
    perf.reset()
    asyncio.run(_phase("auto", backend, None, 1, 20, monkeypatch))
    assert perf.counter("factor_drains") >= 1
    assert perf.counter("factor_drain_rows") > 0
    first = sum(map(len, _cw_rows()))
    assert 0 < first < sum(map(len, reference))
    asyncio.run(_phase("0", backend, 1, 2, 15, monkeypatch))
    asyncio.run(_phase("auto", backend, 2, None, None, monkeypatch))
    assert _cw_rows() == reference


class _Ctx:
    """The slice of a task context a bin aggregate operator touches."""

    class _Info:
        key_range = (0, 2**64 - 1)
        parallelism = 1
        task_id = "t"

    class _State:
        def __init__(self):
            self.tables = {}

        def register_device(self, desc, table):
            self.tables[desc.name] = table

    def __init__(self):
        self.task_info = self._Info()
        self.state = self._State()
        self.out = []

    async def collect(self, batch):
        self.out.append(batch)

    async def broadcast(self, msg):
        pass


def _pane_steps():
    """Fired-factor-pane batches (one row a (key, pane), ``__f_*``
    partials, NaN where a pane had no non-null value) and watermarks."""
    rng = np.random.default_rng(23)
    steps = []
    for p in range(12):
        end = (p + 1) * SEC
        k = np.unique(rng.integers(0, 6, 5)).astype(np.int64)
        n = len(k)
        rows = rng.integers(1, 9, n)
        cnt = np.minimum(rows, rng.integers(0, 9, n))
        s = np.where(cnt > 0, rng.normal(30, 9, n), np.nan)
        steps.append({"k": k, "window_start": np.full(n, end - SEC),
                      "window_end": np.full(n, end),
                      "__f_rows": rows.astype(np.int64),
                      "__f_cnt_x": cnt.astype(np.int64), "__f_sum_x": s,
                      "__f_min_x": s - 1.0})
        if p % 2:
            steps.append(end)
    return steps


def _derived_op(pkg):
    aggs = _specs(pkg, [("count", None, "n"), ("sum", "x", "sx"),
                        ("min", "x", "lo"), ("avg", "x", "ax")])
    if pkg == "port":
        return DerivedWindowOperator("cw", 4 * SEC, 2 * SEC, SEC, aggs,
                                     device="cpu")
    return JaxDerived("cw", 4 * SEC, 2 * SEC, SEC, aggs)


async def _drive(op, ctx, steps, pkg):
    cls = Batch if pkg == "port" else JaxBatch
    for st in steps:
        if isinstance(st, dict):
            await op.process_batch(cls(
                (st["window_end"] - 1).astype(np.int64), dict(st),
                hash_columns([st["k"]]), ("k",)), ctx)
        else:
            await op.handle_watermark(st, ctx)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_derived_table_restores_across_packages(direction, jax_like_port):
    """One package's derived window runs the first half; its table ``a``
    restores into the other package's operator, which runs the rest and
    emits what that package emits run straight through."""
    first_pkg = "jax" if direction == "jax_to_port" else "port"
    then_pkg = "port" if first_pkg == "jax" else "jax"
    steps = _pane_steps()
    half = len(steps) // 2

    async def run(pkg, part, arrays=None):
        op, ctx = _derived_op(pkg), _Ctx()
        await op.on_start(ctx)
        if arrays is not None:
            ctx.state.tables["a"].restore(dict(arrays))
        await _drive(op, ctx, part, pkg)
        return ctx

    ctx = asyncio.run(run(first_pkg, steps[:half]))
    snap = ctx.state.tables["a"].snapshot()
    got = asyncio.run(run(then_pkg, steps[half:], snap))
    want = asyncio.run(run(then_pkg, steps))
    emitted = want.out[len(ctx.out):]
    assert len(got.out) == len(emitted) > 0
    for g, w in zip(got.out, emitted):
        assert g.timestamp.tolist() == w.timestamp.tolist()
        assert sorted(g.columns) == sorted(w.columns)
        for c in w.columns:
            np.testing.assert_array_equal(np.asarray(g.columns[c]),
                                          np.asarray(w.columns[c]), c)


# -- the plan validator ----------------------------------------------------------


def _diags(diags):
    return [d.to_json() for d in diags]


@pytest.mark.parametrize("query", sorted(CORPUS) + sorted(PLANNED)
                         + ["correlated_k8"])
def test_validator_matches_jax_on_sql_plans(query, monkeypatch, median):
    if query in PLANNED:  # factor_window_pair among them
        sql, env = PLANNED[query]
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    elif query == "correlated_k8":
        sql = correlated_sql(8, 1000)
    else:
        sql = CORPUS[query]()
    jprog, prog = jax_plan_sql(sql), plan_sql(sql)
    got = validate_program(prog)
    assert _diags(got) == _diags(jax_validate(jprog))
    assert not [d for d in got if d.severity == "error"]


@pytest.fixture
def median():
    from arroyo_tpu.sql.functions import register_udaf as jax_register
    from arroyo_tpu.sql.functions import unregister_udfs as jax_unregister
    from arroyo_tpu_torch.sql import register_udaf, unregister_udfs

    unregister_udfs()
    jax_unregister()
    register_udaf("median", np.median)
    jax_register("median", np.median)
    yield
    unregister_udfs()
    jax_unregister()


def _mutate(prog, how, pkg):
    """Break a factored pair plan the way ``how`` names."""
    g = prog.graph
    ids = (list(g.node_ids()) if pkg == "port" else list(g.nodes))
    kinds = {i: prog.node(i).operator.kind for i in ids}
    derived = [i for i in ids if kinds[i] == OpKind.DERIVED_WINDOW
               or kinds[i].value == "derived_window"]
    factor = next(i for i in ids if kinds[i].value == "window_factor")
    if how == "dropped_edge":
        g.remove_edge(factor, derived[0])
    elif how == "forward_into_keyed_state":
        (src, _, *rest), = (g.in_edges(factor) if pkg == "port"
                            else g.in_edges(factor, data=True))
        g.remove_edge(src, factor)
        prog.add_edge(src, factor, (EdgeType if pkg == "port"
                                    else JEdgeType).FORWARD, "auction")
    elif how == "no_watermark":
        # the watermark node removed, its input wired to its outputs
        wm = next(i for i in ids if kinds[i].value == "watermark")
        if pkg == "port":
            (src, _, _e), = g.in_edges(wm)
            outs = [(d, e) for _, d, e in g.out_edges(wm)]
        else:
            src = next(iter(g.predecessors(wm)))
            outs = [(d, x["edge"]) for _, d, x in g.out_edges(wm, data=True)]
        g.remove_node(wm)
        for d, e in outs:
            prog.add_edge(src, d, e.typ, e.key_schema)
    elif how == "bad_window_spec":
        prog.node(derived[0]).operator.spec.slide_micros = 0
        prog.node(factor).operator.spec.pane_micros = -1
    return prog


@pytest.mark.parametrize("how", ["dropped_edge", "forward_into_keyed_state",
                                 "no_watermark", "bad_window_spec"])
def test_validator_matches_jax_on_mutated_plans(how, monkeypatch):
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "auto")
    jprog = _mutate(jax_plan_sql(FACTOR_PAIR), how, "jax")
    prog = _mutate(plan_sql(FACTOR_PAIR), how, "port")
    got = validate_program(prog)
    assert _diags(got) == _diags(jax_validate(jprog))
    assert [d for d in got if d.severity == "error"]
    with pytest.raises(PlanValidationError):
        check_program(prog)


@pytest.mark.parametrize("how,error,match", [
    # the program's own structural check meets these two first
    ("dropped_edge", ValueError, "watermark-assigning operator upstream"),
    ("no_watermark", ValueError, "watermark-assigning operator upstream"),
    # the plan validator's gate, before any operator is built
    ("forward_into_keyed_state", PlanValidationError, "keyed-not-shuffled"),
    ("bad_window_spec", PlanValidationError, "window-spec")])
def test_engine_rejects_an_invalid_plan(how, error, match, monkeypatch):
    """The Engine refuses every mutated plan; no setting skips the gate."""
    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "auto")
    prog = _mutate(plan_sql(FACTOR_PAIR), how, "port")
    with pytest.raises(error, match=match):
        Engine(prog, device="cpu")


@pytest.mark.parametrize("query", sorted(HAND_BUILT))
def test_hand_built_programs_keep_their_nodes(query, median):
    """No hand-built program has a correlated group (q5's aggregate
    carries ``argmax_local``): the Engine's pass leaves each as built."""
    prog = HAND_BUILT[query]()
    before = _signature(prog)
    assert not [d for d in pfw.apply_factor_windows(prog) if d.shared]
    assert _signature(prog) == before
    check_program(prog)
