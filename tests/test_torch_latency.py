"""The latency observatory (obs/latency.py) against the JAX package's:
deterministic 1-in-N sampling samples the same records in both for the
same source batches; ingest stamps survive chaining, ``ARROYO_CHAIN=0``,
coalescing (the oldest wins), a window fire (the newest wins) and joins
with the stamps the JAX package gives; burn rates and SLO verdicts agree
on random sample series; and a q5 aggregate's checkpoint taken armed,
its pending stamp under ``__lat_stamp``, restores across the packages in
both directions."""

import asyncio
import time
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import arroyo_tpu as jax_pkg
import arroyo_tpu.config as jax_config
from arroyo_tpu.connectors import memory as jax_memory
from arroyo_tpu.engine.build import build_operator as jax_build
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.obs import latency as jax_latency
from arroyo_tpu.sql import plan_sql as jax_plan_sql
from arroyo_tpu.types import TaskInfo as JaxTaskInfo
from arroyo_tpu.types import hash_columns as jax_hash

import arroyo_tpu_torch as port_pkg
from arroyo_tpu_torch import config as port_config
from arroyo_tpu_torch import queries
from arroyo_tpu_torch.connectors import memory as port_memory
from arroyo_tpu_torch.engine.build import build_operator
from arroyo_tpu_torch.engine.coalesce import _signature
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.graph.logical import OpKind
from arroyo_tpu_torch.obs import latency
from arroyo_tpu_torch.sql import plan_sql
from arroyo_tpu_torch.types import Batch, TaskInfo, hash_columns

SEC = 1_000_000

PKGS = {
    "jax": SimpleNamespace(
        pkg=jax_pkg, latency=jax_latency, memory=jax_memory,
        reset_config=jax_config.reset_config,
        run=lambda prog: JaxLocalRunner(prog, job_id="lat-job").run()),
    "torch": SimpleNamespace(
        pkg=port_pkg, latency=latency, memory=port_memory,
        reset_config=port_config.reset_config,
        run=lambda prog: LocalRunner(prog, job_id="lat-job",
                                     device="cpu").run()),
}


@pytest.fixture(autouse=True)
def _observatories(monkeypatch):
    """Both observatories disarmed around every test, the config re-read
    after the environment is restored; one device's state on the JAX
    side and no coalescing linger, so merges do not follow arrival
    times."""
    monkeypatch.setenv("ARROYO_MESH", "off")
    monkeypatch.setenv("COALESCE_LINGER_MICROS", "0")
    for p in PKGS.values():
        p.latency.disarm()
        p.reset_config()
    yield
    monkeypatch.undo()
    for p in PKGS.values():
        p.latency.disarm()
        p.reset_config()


def _arm(n, monkeypatch):
    """Arm both observatories the way a run does: env -> config ->
    ``ensure_armed`` at engine build."""
    monkeypatch.setenv("ARROYO_LATENCY_SAMPLE_N", str(n))
    for p in PKGS.values():
        p.reset_config()
        assert p.latency.ensure_armed("lat-job").sample_n == n


def _batches(p, sizes, seed=3, stamps=None):
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for i, n in enumerate(sizes):
        ts = t + np.sort(rng.integers(0, SEC // 4, n)).astype(np.int64)
        t += SEC // 4
        b = p.pkg.Batch(ts, {"k": rng.integers(0, 6, n).astype(np.int64),
                             "v": rng.integers(1, 100, n).astype(np.int64)})
        if stamps is not None:
            b.lat_stamp = stamps[i]
        out.append(b)
    return out


def _run(p, batches, build, sink="lat-out"):
    p.memory.clear_sink(sink)
    prog = build(p.pkg.Stream.source("memory", {"batches": batches})
                 .watermark(max_lateness_micros=0), p)
    p.run(prog)
    return p.memory.sink_output(sink)


def _maps(s, p):
    return (s.map(lambda c: {"k": c["k"], "v2": c["v"] * 2}, name="m1")
            .map(lambda c: {"k": c["k"], "v2": c["v2"]}, name="m2")
            .sink("memory", {"name": "lat-out"}))


def _tumble(s, p):
    return (s.key_by("k")
            .tumbling_aggregate(SEC, [p.pkg.AggSpec(p.pkg.AggKind.SUM, "v",
                                                    "s")])
            .sink("memory", {"name": "lat-out"}))


def test_source_sampling_matches_jax(monkeypatch):
    """The same source batches (sizes around and across the sampling
    period) sample the same records in both packages, and the sink
    observes the same number of stamped batches."""
    _arm(7, monkeypatch)
    sizes = [1, 3, 7, 13, 2, 30, 5, 6, 1, 1, 20]
    snaps = {}
    for name, p in PKGS.items():
        outs = _run(p, _batches(p, sizes), _maps)
        assert sum(len(b) for b in outs) == sum(sizes)
        lat = p.latency.active()
        snaps[name] = (lat.snapshot()["sources"],
                       lat.snapshot()["records_sampled"],
                       [q["count"] for q in lat.sink_quantiles().values()])
    assert snaps["torch"] == snaps["jax"]
    assert snaps["torch"][1] > 0 and snaps["torch"][2][0] > 0
    obs, jobs = (latency.LatencyObservatory("j", 10),
                 jax_latency.LatencyObservatory("j", 10))
    for n in (4, 4, 35, 0, 9, 1, 10):
        assert ((obs.source_stamp("s", n) is None)
                == (jobs.source_stamp("s", n) is None))


def test_stamp_is_a_side_annotation():
    """Not a column: transforms carry it, ``concat`` keeps the oldest, the
    coalescer's layout signature never sees it, and ``maybe_stamp`` never
    overwrites a stamp."""
    keys = np.arange(16, dtype=np.int64) % 5
    b = Batch(np.arange(16, dtype=np.int64), {"k": keys},
              hash_columns([keys]), ("k",), lat_stamp=500)
    assert b.select(np.arange(4)).lat_stamp == 500
    assert b.with_key(["k"]).lat_stamp == 500
    assert "lat_stamp" not in b.columns and _signature(b) == _signature(
        Batch(b.timestamp, b.columns, b.key_hash, b.key_cols))
    one = lambda t, s=None: Batch(np.array([t], np.int64),  # noqa: E731
                                  {"k": np.array([t], np.int64)},
                                  lat_stamp=s)
    assert Batch.concat([one(1, 900), one(2), one(3, 200)]).lat_stamp == 200
    assert Batch.concat([one(1), one(2)]).lat_stamp is None
    latency.arm("lat-job", 1)
    stamped = one(1, 12345)
    latency.maybe_stamp("src", stamped)
    assert stamped.lat_stamp == 12345
    fresh = one(1)
    latency.maybe_stamp("src", fresh)
    assert fresh.lat_stamp is not None


def _fired_stamps(outs):
    return sorted({b.lat_stamp for b in outs if b.lat_stamp is not None})


@pytest.mark.parametrize("case", ["chain", "unchained", "coalesced",
                                  "window_fire"])
def test_stamps_survive_as_in_jax(case, monkeypatch):
    """Preset stamps (``maybe_stamp`` keeps them) through each shape give
    the sink the stamps the JAX package gives it: maps chained and
    unchained pass each batch's own; coalesced batches keep the oldest;
    a window fire carries the newest stamp of its inputs since the last
    fire."""
    _arm(1_000_000, monkeypatch)  # armed; only the preset stamps sample
    stamps = [300, 100, 200, 50]
    build = _maps
    if case == "unchained":
        monkeypatch.setenv("ARROYO_CHAIN", "0")
    elif case == "coalesced":
        # one long linger: every batch merges before the end of stream
        monkeypatch.setenv("COALESCE_LINGER_MICROS", "10000000")
    elif case == "window_fire":
        monkeypatch.setenv("ARROYO_COALESCE", "0")
        build = _tumble
    got = {}
    for name, p in PKGS.items():
        p.reset_config()
        outs = _run(p, _batches(p, [40] * 4, stamps=stamps), build)
        got[name] = (_fired_stamps(outs),
                     sum(q["count"] for q in
                         p.latency.active().sink_quantiles().values()))
    assert got["torch"] == got["jax"] and got["torch"][0]
    if case == "coalesced":
        assert got["torch"][0] == [50]
    elif case == "window_fire":
        assert got["torch"][0] == [300]  # all four in the first window
    else:
        assert got["torch"][0] == sorted(stamps)


def test_join_emissions_inherit_stamps(monkeypatch):
    """A window join's fire takes the newest stamp of both sides; a join
    with expiration's matches take the probing batch's (re-attached from
    the task's current stamp) — in both packages."""
    _arm(1_000_000, monkeypatch)
    t = lambda s: int(s * SEC)  # noqa: E731
    got = {}
    for name, p in PKGS.items():
        side = lambda vals, col, st: p.pkg.Batch(  # noqa: E731
            np.array([t(0.1), t(0.2)], np.int64),
            {"pid": np.array([1, 2], np.int64),
             col: np.array(vals, np.int64)}, lat_stamp=st)
        res = []
        for how in ("window", "ttl"):
            p.memory.clear_sink("lat-join")
            left = (p.pkg.Stream.source("memory", {"batches": [
                side([10, 20], "lv", 111)]})
                .watermark(max_lateness_micros=0).key_by("pid"))
            right = (p.pkg.Stream.source(
                "memory", {"batches": [side([100, 200], "rv", 222)]},
                program=left.program)
                .watermark(max_lateness_micros=0).key_by("pid"))
            joined = (left.window_join(right, p.pkg.TumblingWindow(SEC))
                      if how == "window" else
                      left.join_with_expiration(right, SEC, SEC))
            p.run(joined.sink("memory", {"name": "lat-join"}))
            res.append(_fired_stamps(p.memory.sink_output("lat-join")))
        got[name] = res
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [222] and got["torch"][1]


_SERIES = st.lists(st.tuples(st.floats(0, 200, allow_nan=False),
                             st.booleans()), max_size=40)


@settings(max_examples=60, deadline=None)
@given(samples=_SERIES, now=st.floats(0, 250, allow_nan=False),
       window=st.floats(0.5, 120, allow_nan=False))
def test_burn_rate_matches_jax(samples, now, window):
    assert (latency.burn_rate(samples, now, window)
            == jax_latency.burn_rate(samples, now, window))


_MEASURE = st.one_of(st.none(), st.floats(0, 500, allow_nan=False))


@settings(max_examples=40, deadline=None)
@given(slo=st.tuples(st.sampled_from([0.0, 50.0, 200.0]),
                     st.sampled_from([0.0, 100.0]),
                     st.floats(1, 60, allow_nan=False)),
       ticks=st.lists(st.tuples(_MEASURE, _MEASURE,
                                st.floats(0, 5, allow_nan=False)),
                      max_size=25))
def test_slo_verdicts_match_jax(slo, ticks):
    """Equal verdicts, burn rates and violation ledgers tick for tick."""
    ev = latency.SloEvaluator("slo-job", latency.Slo(*slo))
    jev = jax_latency.SloEvaluator("slo-job", jax_latency.Slo(*slo))
    now = 1_000.0
    for p99, stale, dt in ticks:
        now += dt
        assert ev.evaluate(p99, stale, now) == jev.evaluate(p99, stale, now)
    assert ev.to_json() == jev.to_json()


def _q5_agg(build, prog):
    agg = next(n for n in prog.topo_order()
               if prog.node(n).operator.kind.value
               == OpKind.SLIDING_WINDOW_AGGREGATOR.value)
    return build(prog.node(agg).operator)


class _Store:
    def __init__(self):
        self.tables = {}

    def register_device(self, desc, table):
        self.tables[desc.name] = table


def _start(op, info):
    ctx = SimpleNamespace(task_info=info, state=_Store())
    asyncio.run(op.on_start(ctx))
    return ctx


def test_armed_q5_checkpoint_restores_across_packages():
    """q5's aggregate, fed stamped batches in each package, snapshots its
    pending stamp under ``__lat_stamp``; each snapshot restores into the
    other package's operator with that stamp pending and snapshots back
    equal."""
    sql = queries.Q5.format(n=1_000, b=500)
    rng = np.random.default_rng(11)
    auctions = rng.integers(0, 40, 300).astype(np.int64)
    ts = np.sort(rng.integers(0, 9 * SEC, 300)).astype(np.int64)
    ops = {"jax": _q5_agg(jax_build, jax_plan_sql(sql)),
           "torch": _q5_agg(lambda o: build_operator(o, "cpu"),
                            plan_sql(sql))}
    infos = {"jax": JaxTaskInfo("lat-job", "agg", "agg", 0, 1),
             "torch": TaskInfo("lat-job", "agg", "agg", 0, 1)}
    hashes = {"jax": jax_hash, "torch": hash_columns}
    snaps = {}
    for name, op in ops.items():
        ctx = _start(op, infos[name])
        cls = PKGS[name].pkg.Batch
        for half, stamp in ((slice(0, 150), 777), (slice(150, 300), 555)):
            b = cls(ts[half], {"auction": auctions[half]},
                    hashes[name]([auctions[half]]), ("auction",),
                    lat_stamp=stamp)
            asyncio.run(op.process_batch(b, ctx))
        snaps[name] = ctx.state.tables["a"].snapshot()
        assert int(snaps[name]["__lat_stamp"][0]) == 777  # newest wins
    assert sorted(snaps["jax"]) == sorted(snaps["torch"])
    for src, dst in (("jax", "torch"), ("torch", "jax")):
        op = (_q5_agg(jax_build, jax_plan_sql(sql)) if dst == "jax" else
              _q5_agg(lambda o: build_operator(o, "cpu"), plan_sql(sql)))
        ctx = _start(op, infos[dst])
        ctx.state.tables["a"].restore(dict(snaps[src]))
        assert op._lat_pending[0] == 777
        back = ctx.state.tables["a"].snapshot()
        assert sorted(back) == sorted(snaps[src])
        for k in back:
            np.testing.assert_array_equal(np.asarray(back[k]),
                                          np.asarray(snaps[src][k]),
                                          err_msg=f"{src}->{dst} {k}")


def test_q5_sink_latency_and_critical_path(monkeypatch):
    """Armed at 1 in 32, the port's q5 measures its sink (the argmax
    stage's fire carries the pane stamp: ROADMAP C14), decomposes the
    critical path with the JAX package's keys, and the ledger counts the
    pane planes."""
    _arm(32, monkeypatch)
    port_memory.clear_sink("results")
    t0 = time.perf_counter()
    LocalRunner(plan_sql(queries.Q5.format(n=200_000, b=16_384)),
                job_id="lat-job", device="cpu").run()
    wall = time.perf_counter() - t0
    lat = latency.active()
    (q,) = lat.sink_quantiles().values()
    assert q["count"] >= 1 and 0 < q["p99_ms"] <= wall * 1e3
    cp = lat.critical_path()
    assert set(cp) == {"stages", "total_secs", "dominant", "dominant_share"}
    assert tuple(cp["stages"]) == jax_latency.CRITICAL_PATH_STAGES
    assert cp["stages"]["watermark_hold"] > 0
    assert latency.device_state_tables()["panes"] > 0
    rides = latency.summary_ride_alongs("lat-job")
    assert rides["__worker__"]["latency_sample_n"] == 32.0
    assert latency.summary_ride_alongs("other-job") == {}


def test_off_path_records_nothing():
    assert latency.active() is None
    port_memory.clear_sink("lat-off")
    prog = (port_pkg.Stream.source("impulse", {"event_rate": 0.0,
                                               "message_count": 300,
                                               "batch_size": 64})
            .sink("memory", {"name": "lat-off"}))
    LocalRunner(prog, job_id="lat-off", device="cpu").run()
    assert latency.active() is None
    assert all(b.lat_stamp is None for b in port_memory.sink_output(
        "lat-off"))
    assert latency.summary_ride_alongs("lat-off") == {}
