"""The port's ring-pane emission (``ARROYO_RING=on``) against the JAX
package's on the CPU, on the same seeded numpy inputs:

* ``parallel.ring_pane_aggregate`` and ``_2d`` against the JAX functions
  at 1, 2 and 8 bin shards (conftest's forced host devices), W from 1 to
  a whole ring, every kind, and the kinds both reject;
* ``KeyedBinState`` under ``ARROYO_RING=on`` in both packages (the JAX
  side takes its ring branch over 8 devices): batched updates, fires
  between them, eviction, at W = 100 and 300 — COUNT(*) alone;
  SUM/AVG/MIN/MAX/COUNT(col) with NULLs; a derived window's merge-input
  ring; a counts plane promoted to i64 — with equal fires and snapshots,
  and the port's ring fires equal to its dense ones;
* a HOP(1 s, 300 s) SQL aggregate through ``LocalRunner`` in both
  packages, and the port's rows under ``ARROYO_RING=on`` equal to its
  rows under ``off``; the long-window text of ``queries.py`` plans with
  W = 300 bins.

* the CUDA kernel's grouping of its sums (``kernels.ring_emit.
  grouped_sums``: the panes in groups of at most W + 1 sharing a middle,
  lane sums and a butterfly, head and tail scans; up to W = 64 a
  sequential sum a pane) against the plain version and the JAX
  ``_ring_step_2d`` at the fires the kernel treats apart (k = 1, one
  group, several groups, W = 1, W = 5, W on both sides of 64, W not a
  multiple of 32, dead positions at both ends).

Tolerances: integer-valued data (counts, integer prices) is bit-equal,
and so is every MIN/MAX (NaN and -0.0 included: both packages order
-0.0 below +0.0 and let NaN win).  A float sum is the difference of two
running sums; ``jnp.cumsum`` is not a sequential sum on the CPU, and the
kernel groups its additions otherwise again, so non-integer sums agree
to 1e-12 of the row's absolute mass (PERF.md): the bound of any
grouping of n <= 1,000 terms, (n - 1) x 2^-53 of the mass, is under a
tenth of it."""

import numpy as np
import pytest

from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.graph.logical import AggKind as JAggKind
from arroyo_tpu.graph.logical import AggSpec as JAggSpec
from arroyo_tpu.ops.keyed_bins import KeyedBinState as JaxState
from arroyo_tpu.parallel import ring_panes as jax_ring
from arroyo_tpu.sql import SchemaProvider as JaxProvider
from arroyo_tpu.sql import plan_sql as jax_plan_sql
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch import queries
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec, OpKind
from arroyo_tpu_torch.kernels.ring_emit import (grouped_sums,
                                                ring_emit_reference)
from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState as PortState
from arroyo_tpu_torch.parallel import ring_panes as port_ring
from arroyo_tpu_torch.sql import SchemaProvider, plan_sql
from arroyo_tpu_torch.types import Batch

SEC = 1_000_000
N_BINS = 256
KINDS = ("sum", "count", "min", "max")


def _data(rng, what, shape):
    """Integer values, N(0, 1e3) floats, or (MIN/MAX only) signed zeros
    and ones with NaNs among them."""
    if what == "int":
        return rng.integers(-50, 100, shape).astype(np.float64)
    if what == "float":
        return rng.normal(size=shape) * 1e3
    v = rng.choice([0.0, -0.0, 1.0, -1.0], shape)
    v[rng.random(shape) < 0.05] = np.nan
    return v


def _same(got, want, kind, what, bins):
    """Bit-equal (NaN where NaN, the sign of every zero), or for float
    sums within 1e-12 of each row's absolute mass."""
    if what == "float" and kind in ("sum", "count"):
        mass = np.abs(bins).sum(axis=-1, keepdims=True)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * mass.max())
        return
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_shards,widths", [
    (8, (1, 7, 32, 33, 100, 256)),  # halos of 1, 2 and 4+ shard blocks
    (2, (1, 33, 256)),
    (1, (1, 33, 256)),
])
def test_ring_pane_aggregate_matches_jax(kind, n_shards, widths):
    rng = np.random.default_rng(N_BINS + n_shards)
    cases = ["int", "float"] + (["zeros_nan"] if kind in ("min", "max")
                                else [])
    for W in widths:
        for what in cases:
            bins = _data(rng, what, N_BINS)
            want = jax_ring.ring_pane_aggregate(bins, W, kind, n_shards)
            got = port_ring.ring_pane_aggregate(bins, W, kind, n_shards,
                                                device="cpu")
            assert isinstance(got, np.ndarray) and got.shape == (N_BINS,)
            _same(got, want, kind, what, bins)


@pytest.mark.parametrize("kind", KINDS)
def test_ring_pane_aggregate_2d_matches_jax(kind):
    """Five rows at once, 8 shards of 8 bins, windows inside one block and
    across five."""
    rng = np.random.default_rng(7)
    for W in (3, 33):
        for what in ("int", "float") + (("zeros_nan",) if kind in (
                "min", "max") else ()):
            bins = _data(rng, what, (5, 64))
            want = jax_ring.ring_pane_aggregate_2d(bins, W, kind, 8)
            got = port_ring.ring_pane_aggregate_2d(bins, W, kind, 8,
                                                   device="cpu")
            _same(got, want, kind, what, bins)


@pytest.mark.parametrize("W,k,dead", [
    (300, 1, (99, 0)),     # phase 19's median fire: 201 live of 300
    (300, 64, (5, 10)),    # one group, dead positions at both ends
    (300, 300, (0, 0)),    # a final flush: one group of 300
    (300, 700, (3, 40)),   # groups of 301, 301 and 98
    (37, 5, (2, 2)),       # W not a multiple of 32: a thread a pane
    (33, 70, (0, 1)),      # k > W + 1, a thread a pane
    (1, 26, (0, 0)),       # W = 1
    (5, 5, (4, 4)),        # q5's ring fire: one live position
    (64, 40, (3, 5)),      # the widest W a thread folds
    (65, 70, (1, 0)),      # the narrowest a group takes: groups of 66, 4
])
@pytest.mark.parametrize("what", ["int", "float"])
def test_kernel_grouping_matches_plain_and_jax(W, k, dead, what):
    import torch

    rng = np.random.default_rng(W * 1_000 + k)
    rows, L = 6, k + W - 1
    B = L + 8
    values = torch.tensor(_data(rng, what, (1, rows, B)))
    j0, j1 = dead[0], L - 1 - dead[1]
    want, _ = ring_emit_reference(values, None, 0, j0, j1, W, k, ("sum",),
                                  (0,), rows)
    live = (torch.arange(L) >= j0) & (torch.arange(L) <= j1)
    g = torch.where(live, values[0, :, :L], 0.0)
    got = grouped_sums(g, W, k)
    jax_want = jax_ring.ring_pane_aggregate_2d(g.numpy(), W, "sum",
                                               1)[:, W - 1:W - 1 + k]
    bins = g.numpy()
    for other in (want[0].numpy(), jax_want):
        _same(got.numpy(), other, "sum", what, bins)


def test_ring_pane_aggregate_keeps_a_tensor_on_its_device():
    import torch

    bins = torch.arange(16, dtype=torch.float64)
    got = port_ring.ring_pane_aggregate(bins, 4, "sum", 4)
    assert isinstance(got, torch.Tensor) and got.device == bins.device
    want = jax_ring.ring_pane_aggregate(bins.numpy(), 4, "sum", 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["ring_pane_aggregate",
                                "ring_pane_aggregate_2d"])
@pytest.mark.parametrize("kind", ["avg", "median", "SUM"])
def test_ring_pane_aggregate_rejects_kinds_as_jax(fn, kind):
    bins = np.zeros((16,) if fn == "ring_pane_aggregate" else (2, 16))
    for mod, kw in ((jax_ring, {}), (port_ring, {"device": "cpu"})):
        with pytest.raises(ValueError):
            getattr(mod, fn)(bins, 4, kind, 2, **kw)


def test_ring_pane_aggregate_shard_layout_asserted_as_jax():
    bins = np.zeros(12)
    for mod, kw in ((jax_ring, {}), (port_ring, {"device": "cpu"})):
        with pytest.raises(AssertionError):
            mod.ring_pane_aggregate(bins, 4, "sum", 8, **kw)
        with pytest.raises(AssertionError):
            mod.ring_pane_aggregate_2d(bins[None], 4, "sum", 8, **kw)


# -- KeyedBinState ------------------------------------------------------------

FULL_AGGS = [("count", None, "n"), ("sum", "price", "total"),
             ("avg", "price", "mean"), ("min", "price", "lo"),
             ("max", "price", "hi"), ("count", "price", "cp")]


def _states(aggs, width_s, capacity=8):
    j = JaxState(tuple(JAggSpec(JAggKind(k), c, o) for k, c, o in aggs),
                 SEC, width_s * SEC, capacity=capacity)
    p = PortState(tuple(AggSpec(AggKind(k), c, o) for k, c, o in aggs),
                  SEC, width_s * SEC, capacity=capacity, device="cpu")
    return j, p


def _stream(seed, span_s, n_batches, n_keys, floats=False):
    """Batches of (key hashes, timestamps, {price}, watermark): event time
    marching over ``span_s`` seconds with out-of-order jitter, late rows
    now and then, a key space that outgrows the capacity, NULL prices."""
    rng = np.random.default_rng(seed)
    step = span_s * SEC // n_batches
    out = []
    for i in range(n_batches):
        n = int(rng.integers(60, 200))
        keys = rng.integers(0, n_keys, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        now = (i + 1) * step
        ts = now - rng.integers(0, step + 3 * SEC, n)
        if i % 3 == 2:
            ts[: n // 6] -= 40 * SEC  # behind the watermark: dropped
        price = (rng.normal(50, 20, n) if floats else
                 rng.integers(-20, 1_000, n).astype(np.float64))
        price[rng.random(n) < 0.1] = np.nan
        out.append((keys, np.maximum(ts, 0).astype(np.int64),
                    {"price": price}, now - 2 * SEC))
    return out


def _same_fire(a, b, exact=True):
    if a is None or b is None:
        assert a is None and b is None
        return
    (ka, ca, wa, na), (kb, cb, wb, nb) = a, b
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(na, nb)
    assert ca.keys() == cb.keys()
    for name in ca:
        if exact:
            np.testing.assert_array_equal(ca[name], cb[name], err_msg=name)
        else:  # float sums: 1e-12 of the pane's mass (<= 1e5 here)
            np.testing.assert_allclose(ca[name], cb[name], rtol=1e-12,
                                       atol=1e-7, equal_nan=True,
                                       err_msg=name)


def _same_snapshot(a, b):
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(np.asarray(a[name]),
                                      np.asarray(b[name]), err_msg=name)


def _drive(states, batches, feed):
    """Feed every batch to every state and fire at its watermark; then a
    final flush.  Returns the fires, state by state."""
    fires = [[] for _ in states]
    for batch in batches:
        for i, st in enumerate(states):
            feed(st, batch)
            fires[i].append(st.fire_panes(batch[3]))
    for i, st in enumerate(states):
        fires[i].append(st.fire_panes(0, final=True))
    return fires


def _update(st, batch):
    keys, ts, cols, _ = batch
    st.update(keys, ts, cols)


@pytest.mark.parametrize("aggs,width_s,promote,floats", [
    ([("count", None, "n")], 300, False, False),
    (FULL_AGGS, 100, False, False),
    (FULL_AGGS, 100, False, True),
    ([("count", None, "n"), ("max", "price", "hi")], 100, True, False),
], ids=["count-W300", "nulls-W100", "nulls-floats-W100", "i64-W100"])
def test_state_ring_fires_match_jax(monkeypatch, aggs, width_s, promote,
                                    floats):
    """Fire for fire and in the final snapshot the port's ring state
    equals the JAX package's (which sweeps over 8 shards); with eviction
    (700 s of event time against a window of 100 or 300 s).  The port's
    dense fires of the same stream (``ARROYO_RING=off``) equal its ring
    fires."""
    monkeypatch.setenv("ARROYO_RING", "on")
    if promote:
        monkeypatch.setattr(JaxState, "_i32_promote", 300)
        monkeypatch.setattr(PortState, "_i32_promote", 300)
    j, p = _states(aggs, width_s)
    assert j._use_ring() and p._use_ring()
    batches = _stream(width_s + promote + floats, 700, 6, 40, floats)
    fires_j, fires_p = _drive((j, p), batches, _update)
    assert sum(f is not None for f in fires_p) >= 4
    for a, b in zip(fires_j, fires_p):
        _same_fire(a, b, exact=not floats)
    _same_snapshot(j.snapshot(), p.snapshot())
    if promote:
        assert str(p.counts.dtype) == "torch.int64"
    assert p.min_bin > 300  # eviction ran

    monkeypatch.setenv("ARROYO_RING", "off")
    _, dense = _states(aggs, width_s)
    assert not dense._use_ring()
    (fires_d,) = _drive((dense,), batches, _update)
    for a, b in zip(fires_p, fires_d):
        _same_fire(a, b, exact=not floats)


def test_derived_window_ring_matches_jax(monkeypatch):
    """Merge-input mode (a derived window of a factor rewrite): rows are
    fired 1 s factor panes carrying partials; a HOP(1 s, 100 s) derived
    ring fires them through the ring branch in both packages."""
    from arroyo_tpu.graph import factor_windows as jfw
    from arroyo_tpu_torch.graph import factor_windows as pfw

    monkeypatch.setenv("ARROYO_RING", "on")
    aggs = [("count", None, "n"), ("sum", "x", "sx"), ("min", "x", "lo"),
            ("max", "x", "hi"), ("count", "x", "cx")]
    j, p = _states(aggs, 100)
    j.set_merge_inputs(jfw.derived_channel_cols(j.aggs), jfw.ROWS_COLUMN)
    p.set_merge_inputs(pfw.derived_channel_cols(p.aggs), pfw.ROWS_COLUMN)
    rng = np.random.default_rng(5)
    batches = []
    for i in range(5):
        n = 120
        keys = rng.integers(0, 30, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        ts = (i * 90 + rng.integers(0, 90, n)) * SEC + SEC - 1
        cnt = rng.integers(0, 4, n).astype(np.float64)
        cols = {pfw.ROWS_COLUMN: cnt + rng.integers(0, 3, n),
                "__f_cnt_x": cnt,
                "__f_sum_x": np.where(cnt > 0, rng.integers(-99, 99, n), 0.0),
                "__f_min_x": np.where(cnt > 0, rng.integers(-99, 0, n),
                                      np.nan),
                "__f_max_x": np.where(cnt > 0, rng.integers(0, 99, n),
                                      np.nan)}
        batches.append((keys, ts.astype(np.int64), cols, (i + 1) * 90 * SEC))
    fires_j, fires_p = _drive((j, p), batches, _update)
    assert sum(f is not None for f in fires_p) >= 4
    for a, b in zip(fires_j, fires_p):
        _same_fire(a, b)
    _same_snapshot(j.snapshot(), p.snapshot())


def test_ring_auto_takes_the_ring_only_with_several_devices(monkeypatch):
    """``auto``: W >= ``ARROYO_RING_MIN_W`` (64) and more than one device
    of the state's kind — a CPU state is one device, so never; ``on``
    and ``off`` force the branch."""
    _, p = _states([("count", None, "n")], 300)
    monkeypatch.delenv("ARROYO_RING", raising=False)
    assert not p._use_ring()
    monkeypatch.setenv("ARROYO_RING", "on")
    assert p._use_ring()
    monkeypatch.setenv("ARROYO_RING", "off")
    assert not p._use_ring()
    monkeypatch.setenv("ARROYO_RING", "auto")
    monkeypatch.setattr(p, "device", type(p.device)("cuda", 0))
    monkeypatch.setattr("torch.cuda.device_count", lambda: 4)
    assert p._use_ring()
    monkeypatch.setenv("ARROYO_RING_MIN_W", "301")
    assert not p._use_ring()


# -- SQL ----------------------------------------------------------------------

HOP_SQL = (
    "CREATE TABLE out WITH (connector='memory', name='results');"
    "INSERT INTO out SELECT k, HOP(INTERVAL '1' SECOND, INTERVAL '300' "
    "SECOND) as window, count(*) as num, sum(v) as total, max(v) as top "
    "FROM events GROUP BY 1, 2")


def _hop_batches(BatchT):
    """Eight batches over 700 s of event time: 40 string keys, integer
    values with NULLs."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(8):
        n = 150
        ts = np.sort(i * 90 * SEC + rng.integers(0, 90 * SEC, n))
        k = np.array([f"channel-{x}" for x in rng.integers(0, 40, n)],
                     dtype=object)
        v = rng.integers(1, 10_000, n).astype(np.float64)
        v[rng.random(n) < 0.1] = np.nan
        out.append(BatchT(ts.astype(np.int64), {"k": k, "v": v}))
    return out


def _sorted_rows(batches):
    cols = {c: np.concatenate([b.columns[c] for b in batches])
            for c in ("k", "window_end", "num", "total", "top")}
    order = np.lexsort((cols["window_end"], cols["k"].astype(str)))
    return {c: v[order] for c, v in cols.items()}


def test_sql_hop_300s_through_ring_matches_jax(monkeypatch):
    """HOP(1 s, 300 s) COUNT/SUM/MAX by a string key through
    ``LocalRunner``: the port's rows under ``ARROYO_RING=on`` equal the
    JAX package's and the port's under ``off``."""
    monkeypatch.setenv("ARROYO_RING", "on")
    jp = JaxProvider()
    jp.add_memory_table("events", {"k": "s", "v": "f"},
                        _hop_batches(JaxBatch))
    jax_clear_sink("results")
    JaxLocalRunner(jax_plan_sql(HOP_SQL, jp)).run()
    want = _sorted_rows(jax_sink_output("results"))

    runs = []
    for mode in ("on", "off"):
        monkeypatch.setenv("ARROYO_RING", mode)
        pp = SchemaProvider()
        pp.add_memory_table("events", {"k": "s", "v": "f"},
                            _hop_batches(Batch))
        clear_sink("results")
        LocalRunner(plan_sql(HOP_SQL, pp), device="cpu").run()
        runs.append(_sorted_rows(sink_output("results")))
    assert len(want["k"]) > 10_000
    for got in runs:
        assert got.keys() == want.keys()
        for c in want:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
            assert got[c].dtype == want[c].dtype, c


def test_long_window_query_plans_w300():
    """The per-channel five-minute dashboard of ``queries.py`` plans one
    windowed aggregate of 1 s slide and 300 s width, node for node the
    JAX planner's plan."""
    text = queries.HOP_CHANNELS.format(n=10_000, b=8_192)
    program = plan_sql(text)
    aggs = [n.operator for n in program.nodes()
            if n.operator.kind == OpKind.SLIDING_WINDOW_AGGREGATOR]
    assert len(aggs) == 1
    spec = aggs[0].spec
    assert (spec.slide_micros, spec.width_micros) == (SEC, 300 * SEC)
    assert spec.width_micros // spec.slide_micros == 300
    jprog = jax_plan_sql(text)
    assert [(n.operator.name, n.operator.kind.value)
            for n in program.nodes()] == [
        (n.operator.name, n.operator.kind.value) for n in jprog.nodes()]
