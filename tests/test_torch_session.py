"""The port's session-window slice against the JAX package, on the CPU:
the interval union (``union_sorted_intervals``), the segment aggregate
(``segment_aggregate``: median, COUNT(*), SUM/MIN/MAX/AVG, COUNT(col) over
NULLs, channel-compiled and host-loop UDAFs, COUNT DISTINCT), the
partition-adaptive ``SessionRunState`` (merge, expire, clamp flags,
stats, checkpoint interchange in both directions) and the session
pipeline end to end under both state layouts.  ``ARROYO_SESSION_DEVICE=on``
sends the JAX side through its union kernel; the port always runs the
``session_union`` wrapper (its plain version for CPU tensors)."""

import numpy as np
import pytest
import torch

from arroyo_tpu import Batch as JaxBatch
from arroyo_tpu import SessionWindow as JaxSessionWindow
from arroyo_tpu import Stream as JaxStream
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.graph.logical import AggKind as JaxAggKind
from arroyo_tpu.graph.logical import AggSpec as JaxAggSpec
from arroyo_tpu.ops.segment import segment_aggregate as jax_segment_aggregate
from arroyo_tpu.ops.session import union_sorted_intervals as jax_union
from arroyo_tpu.state.session_state import SessionRunState as JaxRunState
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec, SessionWindow, Stream
from arroyo_tpu_torch.kernels.session_union import session_union
from arroyo_tpu_torch.obs import perf
from arroyo_tpu_torch.ops.segment import segment_aggregate
from arroyo_tpu_torch.ops.session import union_sorted_intervals
from arroyo_tpu_torch.state.session_state import SessionRunState
from arroyo_tpu_torch.types import Batch

MS, SEC = 1_000, 1_000_000


def _intervals(rng, n, n_keys):
    """Interval rows sorted by (key, start), touching ones included."""
    keys = rng.integers(0, 2**64, n_keys, dtype=np.uint64)
    kh = rng.choice(keys, n)
    st = rng.integers(0, 50 * SEC, n)
    en = st + rng.integers(1, 3 * SEC, n)
    t = rng.random(n) < 0.2
    st[1:][t[1:]] = en[:-1][t[1:]]
    o = np.lexsort((st, kh))
    return kh[o], st[o], en[o]


@pytest.mark.parametrize("n,n_keys", [(1, 1), (2, 1), (700, 1), (900, 60)])
def test_union_sorted_intervals_matches_jax(n, n_keys):
    """Merged keys, bounds, row->session ordinals and session heads
    through the session_union plain version: equal to the JAX host path
    and its jitted kernel."""
    rng = np.random.default_rng(n * 31 + n_keys)
    kh, st, en = _intervals(rng, n, n_keys)
    want = jax_union(kh.copy(), st.copy(), en.copy(), device=False)
    want_dev = jax_union(kh.copy(), st.copy(), en.copy(), device=True)
    got = union_sorted_intervals(kh.copy(), st.copy(), en.copy(),
                                 device=torch.device("cpu"))
    for g, w, wd in zip(got, want, want_dev):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, wd)


P90 = lambda v: float(np.percentile(v, 90))  # noqa: E731 - host loop
AGG_SETS = {
    # every aggregate route
    "all": [("count", None, "n", None), ("sum", "v", "total", None),
            ("min", "v", "lo", None), ("max", "v", "hi", None),
            ("avg", "v", "mean", None), ("count", "w", "nw", None),
            ("udaf", "v", "med", np.median), ("udaf", "w", "var", np.var),
            ("udaf", "v", "p90", P90),
            ("count_distinct", "c", "nd", None)],
    # config5's: the kernel reduces a COUNT(*) channel with no value rows
    "config5": [("udaf", "v", "med", np.median), ("count", None, "n", None)],
    # value channels only, no COUNT(*)
    "columns": [("sum", "w", "total", None), ("min", "w", "lo", None),
                ("max", "v", "hi", None), ("avg", "w", "mean", None),
                ("count", "v", "nv", None)],
    # no channel at all: the kernel writes the rows per key only
    "median": [("udaf", "w", "med", np.median)],
}


def _agg_pairs(specs):
    """(port AggSpec, JAX AggSpec) pairs for ``specs``."""
    return ([AggSpec(AggKind(k), c, o, fn) for k, c, o, fn in specs],
            [JaxAggSpec(JaxAggKind(k), c, o, fn) for k, c, o, fn in specs])


@pytest.mark.parametrize("agg_set", sorted(AGG_SETS))
def test_segment_aggregate_matches_jax(agg_set):
    """Aggregate routes over keys with NULLs in the inputs, the reduce
    through segment_agg's plain version in one dispatch: the JAX
    package's values, exact for counts, min, max, the median and the
    host-loop UDAF, rtol 1e-12 for sums."""
    rng = np.random.default_rng(5)
    n = 3000
    kh = rng.integers(0, 2**64, 97, dtype=np.uint64)[rng.integers(0, 97, n)]
    ts = rng.integers(0, 10 * SEC, n)
    v = rng.integers(-50, 50, n).astype(np.float64)
    v[rng.random(n) < 0.05] = np.nan
    w = rng.normal(size=n)
    w[:400] = np.nan  # some segments are all-null in w
    cols = {"v": v, "w": w, "c": rng.integers(0, 6, n)}
    aggs, jaggs = _agg_pairs(AGG_SETS[agg_set])
    before = perf.counter("kernel_dispatches")
    got = segment_aggregate(kh, ts, cols, tuple(aggs), "cpu")
    assert perf.counter("kernel_dispatches") == before + 1
    want = jax_segment_aggregate(kh, ts, cols, tuple(jaggs))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert got[1].keys() == want[1].keys()
    for name in want[1]:
        g, wv = np.asarray(got[1][name]), np.asarray(want[1][name])
        assert g.dtype == wv.dtype, name
        np.testing.assert_allclose(g, wv, rtol=1e-12, equal_nan=True,
                                   err_msg=name)
        if name not in ("total", "mean", "var"):
            np.testing.assert_array_equal(g, wv, err_msg=name)
    assert got[4].keys() == want[4].keys()
    for name in want[4]:
        np.testing.assert_array_equal(got[4][name], want[4][name])


@pytest.mark.parametrize("n,n_keys", [(0, 1), (300, 300), (300, 1)])
def test_segment_aggregate_batch_shapes_match_jax(n, n_keys):
    """An empty batch (no segment), one row per key and one key for all
    rows: the reduce's one upload, one launch and one readback give the
    JAX package's values (rtol 1e-12 for sums, exact otherwise)."""
    rng = np.random.default_rng(n + n_keys)
    kh = rng.integers(0, 2**64, n_keys, dtype=np.uint64)
    kh = rng.permutation(kh)[:n] if n_keys == n else kh[rng.integers(
        0, n_keys, n)]
    ts = rng.integers(0, 10 * SEC, n)
    v = rng.normal(size=n) * 1e3
    v[rng.random(n) < 0.1] = np.nan
    specs = AGG_SETS["columns"] + [("count", None, "n", None)]
    aggs, jaggs = _agg_pairs(specs)
    got = segment_aggregate(kh, ts, {"v": v, "w": v}, tuple(aggs), "cpu")
    want = jax_segment_aggregate(kh, ts, {"v": v, "w": v}, tuple(jaggs))
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    for g_cols, w_cols in ((got[1], want[1]), (got[4], want[4])):
        assert g_cols.keys() == w_cols.keys()
        for name in w_cols:
            g, w = np.asarray(g_cols[name]), np.asarray(w_cols[name])
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=1e-12, equal_nan=True,
                                       err_msg=name)
            if name not in ("total", "mean"):
                np.testing.assert_array_equal(g, w, err_msg=name)


def _interval_batches(rng, n_batches, max_span):
    """Per-batch candidate intervals as the session operator builds them
    (sorted by (key, start), ends a gap past the last event), plus the
    per-interval update times."""
    keys = rng.integers(0, 2**64, 50, dtype=np.uint64)
    t0 = 0
    out = []
    for _ in range(n_batches):
        m = 300
        kh = rng.choice(keys, m)
        st = t0 + rng.integers(0, 3 * SEC, m)
        en = st + rng.integers(SEC // 10, min(2 * SEC, max_span + SEC), m)
        o = np.lexsort((st, kh))
        kh, st, en = kh[o], st[o], en[o]
        out.append((kh, st, en, en - SEC // 10))
        t0 += 2 * SEC
    return out


@pytest.mark.parametrize("max_span", [24 * 3600 * SEC, 2 * SEC])
def test_session_run_state_matches_jax(monkeypatch, max_span):
    """Merge, clamp flags, expire and stats batch by batch against the
    JAX state on its union kernel, and snapshots that restore across the
    two packages in both directions.  A 2 s clamp makes keys fall back
    to the per-key path."""
    monkeypatch.setenv("ARROYO_SESSION_DEVICE", "on")
    rng = np.random.default_rng(17)
    port, jax_st = SessionRunState(max_span=max_span, device="cpu"), \
        JaxRunState(max_span=max_span)
    perf.reset()
    flagged_any = False
    for i, (kh, st, en, tm) in enumerate(_interval_batches(rng, 8,
                                                           max_span)):
        f_port = port.merge_intervals(kh, st, en, tm)
        f_jax = jax_st.merge_intervals(kh, st, en, tm)
        np.testing.assert_array_equal(f_port, f_jax)
        flagged_any |= len(f_jax) > 0
        sp, sj = port.stats(), jax_st.stats()
        # the JAX state stages no partition at this size, so its
        # host-resident (spill) bytes are all of the runs' bytes
        assert sj.pop("hot_partitions") == 0
        sj.pop("staged_devices")
        sj["host_bytes"] = sj.pop("spill_bytes")
        assert sp == sj
        assert port.snapshot() == jax_st.snapshot()
        if i % 3 == 2:
            wm = int(st.max()) - SEC
            ep, ej = port.expire(wm), jax_st.expire(wm)
            for a, b in zip(ep, ej):
                np.testing.assert_array_equal(a, b)
    assert flagged_any == (max_span < SEC * 10)
    assert perf.counter("session_merge_dispatches") == 8
    # CPU: every scan ran session_union's plain version, no kernel
    assert perf.counter("session_merge_device_dispatches") == 0

    # checkpoint interchange: JAX -> port and port -> JAX
    from_jax, from_port = SessionRunState(device="cpu"), JaxRunState()
    from_jax.restore(jax_st.snapshot())
    from_port.restore(port.snapshot())
    assert from_jax.snapshot() == from_port.snapshot() == port.snapshot()
    (kh, st, en, tm), = _interval_batches(np.random.default_rng(3), 1,
                                          max_span)
    np.testing.assert_array_equal(from_jax.merge_intervals(kh, st, en, tm),
                                  from_port.merge_intervals(kh, st, en, tm))
    assert from_jax.snapshot() == from_port.snapshot()


AGG_ROWS = [("count", None, "cnt"), ("sum", "v", "total"),
            ("min", "v", "lo"), ("max", "v", "hi"), ("avg", "v", "mean")]


def _session_batches(rng, n_batches=4, n=1200, n_keys=40, span=4 * SEC):
    """Bursty per-key event times so sessions both merge and close."""
    out = []
    t0 = 0
    for _ in range(n_batches):
        ts = np.sort(rng.integers(t0, t0 + span, n)).astype(np.int64)
        out.append((ts, rng.integers(0, n_keys, n).astype(np.int64),
                    rng.integers(1, 100, n).astype(np.int64)))
        t0 += span + rng.integers(0, SEC)
    return out


def _rows(batches):
    if not batches:
        return []
    names = sorted(batches[0].columns)
    return sorted(
        (int(b.timestamp[i]),) + tuple(float(b.columns[c][i]) for c in names)
        for b in batches for i in range(len(b)))


@pytest.mark.parametrize("layout", ["device", "legacy"])
def test_session_pipeline_matches_jax(monkeypatch, layout):
    """The session pipeline of tests/test_session_state.py (memory source,
    COUNT/SUM/MIN/MAX/AVG, 300 ms gap, fuzzed bursty batches) emits the
    JAX engine's rows under both state layouts; the device layout runs
    the union scan through session_union's plain version (and the JAX
    side through its union kernel)."""
    monkeypatch.setenv("ARROYO_SESSION_STATE", layout)
    monkeypatch.setenv("ARROYO_SESSION_DEVICE", "on")
    data = _session_batches(np.random.default_rng(42))
    jax_clear_sink("ss-jax")
    JaxLocalRunner(
        JaxStream.source("memory", {"batches": [
            JaxBatch(ts, {"k": k, "v": v}) for ts, k, v in data]})
        .watermark(max_lateness_micros=0).key_by("k")
        .window(JaxSessionWindow(300 * MS),
                [JaxAggSpec(JaxAggKind(a), c, o) for a, c, o in AGG_ROWS])
        .sink("memory", {"name": "ss-jax"})).run()
    want = _rows(jax_sink_output("ss-jax"))
    clear_sink("ss-port")
    perf.reset()
    LocalRunner(
        Stream.source("memory", {"batches": [
            Batch(ts, {"k": k, "v": v}) for ts, k, v in data]})
        .watermark(max_lateness_micros=0).key_by("k")
        .window(SessionWindow(300 * MS),
                [AggSpec(AggKind(a), c, o) for a, c, o in AGG_ROWS])
        .sink("memory", {"name": "ss-port"}), device="cpu").run()
    got = _rows(sink_output("ss-port"))
    assert len(want) > 50 and got == want
    if layout == "device":
        assert perf.counter("session_device_merge_rows") > 0
        assert session_union.launches == 0  # CPU: the plain version
    else:
        assert perf.counter("session_host_merge_rows") > 0
