"""The port's KeyedBinState (device="cpu") against arroyo_tpu's
KeyedBinState on the same random out-of-order streams: identical fires
(keys, aggregate columns, window ends, counts, in order) on the argmax and
dense branches, through late rows, key-capacity growth, ring growth and
i32->i64 counts promotion; identical canonical snapshots; and snapshots
that restore across the two packages in both directions.

The JAX state is built directly (conftest's 8 CPU devices would make
``make_bin_state`` pick the mesh state).  Both packages run on their
defaults, the host library where it built: key slots in first-seen order
in both (tests/test_torch_native.py holds both packages' numpy paths)."""

import numpy as np
import pytest

from arroyo_tpu.graph.logical import AggKind as JAggKind
from arroyo_tpu.graph.logical import AggSpec as JAggSpec
from arroyo_tpu.ops.keyed_bins import KeyedBinState as JaxState
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec
from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState as PortState

SLIDE, WIDTH = 1_000, 3_000  # W = 3 bins per window, ring B = 16

DENSE_AGGS = [("count", None, "n"), ("sum", "price", "total"),
              ("min", "price", "lo"), ("max", "price", "hi"),
              ("avg", "price", "mean"), ("count", "price", "cp")]


def _pair(aggs, argmax, capacity=8):
    j = JaxState(tuple(JAggSpec(JAggKind(k), c, o) for k, c, o in aggs),
                 SLIDE, WIDTH, capacity=capacity)
    p = PortState(tuple(AggSpec(AggKind(k), c, o) for k, c, o in aggs),
                  SLIDE, WIDTH, capacity=capacity, device="cpu")
    if argmax:
        j.set_argmax_local(aggs[0][2], argmax)
        p.set_argmax_local(aggs[0][2], argmax)
    return j, p


def _stream(seed, n_batches=14):
    """Batches of (key hashes, timestamps, price, watermark) whose event
    time moves forward with out-of-order jitter, periodic late rows far
    behind the watermark, one far-future burst that forces ring growth
    and a key space that outgrows capacity 8."""
    rng = np.random.default_rng(seed)
    out = []
    now = 20_000
    for i in range(n_batches):
        n = int(rng.integers(50, 300))
        keys = rng.integers(0, 20 + 12 * i, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        ts = now + rng.integers(-2_500, 1_500, n)
        if i % 4 == 3:
            ts[: n // 5] -= 9_000  # late rows
        if i == 6:
            ts[: 10] += 25_000  # spans more bins than the ring holds
        price = rng.normal(50, 20, n)
        price[rng.random(n) < 0.1] = np.nan  # SQL NULLs
        out.append((keys, ts.astype(np.int64), price, now - 3_000))
        now += int(rng.integers(500, 2_500))
    return out


def _feed(state, batch):
    keys, ts, price, watermark = batch
    state.update(keys, ts, {"price": price})
    return state.fire_panes(watermark)


def _assert_fires_equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    (ka, ca, wa, na), (kb, cb, wb, nb) = a, b
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(na, nb)
    assert ca.keys() == cb.keys()
    for name in ca:
        np.testing.assert_allclose(ca[name], cb[name], rtol=1e-12,
                                   equal_nan=True)


def _assert_snapshots_equal(a, b):
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(np.asarray(a[name]),
                                      np.asarray(b[name]), err_msg=name)


@pytest.mark.parametrize("aggs,argmax,promote", [
    ([("count", None, "__agg0")], "max", False),
    ([("count", None, "__agg0")], "min", True),
    (DENSE_AGGS, None, False),
    (DENSE_AGGS, None, True),
])
def test_state_matches_jax_with_cross_restore(monkeypatch, aggs, argmax,
                                              promote):
    """(d) fires identical on every batch; at the midpoint the canonical
    snapshots are identical and each package restores the other's
    snapshot, after which all four states fire identically."""
    if promote:  # exercise the i32 -> i64 counts promotion mid-stream
        monkeypatch.setattr(JaxState, "_i32_promote", 1500)
        monkeypatch.setattr(PortState, "_i32_promote", 1500)
    batches = _stream(seed=len(aggs) + (argmax == "min"))
    j, p = _pair(aggs, argmax)
    half = len(batches) // 2
    for batch in batches[:half]:
        _assert_fires_equal(_feed(j, batch), _feed(p, batch))
    assert p.C > 8 and p.B > 16  # key-capacity and ring growth happened
    snap_j, snap_p = j.snapshot(), p.snapshot()
    _assert_snapshots_equal(snap_j, snap_p)
    j2, p2 = _pair(aggs, argmax)
    j2.restore(snap_p)  # port snapshot -> JAX
    p2.restore(snap_j)  # JAX snapshot -> port
    for batch in batches[half:]:
        fires = [_feed(s, batch) for s in (j, p, j2, p2)]
        for f in fires[1:]:
            _assert_fires_equal(fires[0], f)
    if promote:
        assert str(p.counts.dtype) == "torch.int64"
    finals = [s.fire_panes(0, final=True) for s in (j, p, j2, p2)]
    for f in finals[1:]:
        _assert_fires_equal(finals[0], f)
    _assert_snapshots_equal(j.snapshot(), p.snapshot())


def test_ring_mode_on_is_refused(monkeypatch):
    """The ring-parallel emission branch is not ported: forcing it raises
    instead of silently taking another branch."""
    p = PortState((AggSpec(AggKind.COUNT, None, "n"),), SLIDE, WIDTH,
                  device="cpu")
    p.update(np.arange(4, dtype=np.uint64), np.arange(4) * 1000, {})
    monkeypatch.setenv("ARROYO_RING", "on")
    with pytest.raises(NotImplementedError):
        p.fire_panes(10_000)


SIGNED_AGGS = [("count", None, "n"), ("min", "price", "lo"),
               ("max", "price", "hi"), ("sum", "price", "total")]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


@pytest.mark.parametrize("compact", ["on", "off"])
def test_flushes_and_fires_match_jax_with_signed_zeros(monkeypatch, compact):
    """Prices of both signs and +/-0.0 under MIN/MAX/SUM, two update runs
    a flush (merged on the host), through both packages' states: every
    fire equal, the canonical snapshots bit for bit equal (MIN/MAX order
    -0.0 below +0.0 in both); one upload a flush and one a compact fire
    (counted as blocking: a CPU device copies plainly)."""
    from arroyo_tpu_torch.obs import perf

    monkeypatch.setenv("ARROYO_EMIT_COMPACT", compact)
    rng = np.random.default_rng(5)
    j, p = _pair(SIGNED_AGGS, None, capacity=64)
    perf.reset()
    signed = np.array([0.0, -0.0, -2.5, 2.5, -1e300, 1e300, 7.0, -7.0])
    now, fires = 20_000, 0
    for _ in range(10):
        n = int(rng.integers(60, 200))
        keys = rng.integers(0, 40, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        ts = (now + rng.integers(-2_500, 1_500, n)).astype(np.int64)
        price = rng.choice(signed, n)
        for st in (j, p):  # two runs before the fire: merged cells
            st.update(keys[: n // 2], ts[: n // 2], {"price": price[: n // 2]})
            st.update(keys[n // 2:], ts[n // 2:], {"price": price[n // 2:]})
        out = [st.fire_panes(now - 3_000) for st in (j, p)]
        _assert_fires_equal(*out)
        fires += out[1] is not None
        now += int(rng.integers(500, 2_500))
        sj, sp = j.snapshot(), p.snapshot()
        assert sj.keys() == sp.keys()
        for name in sj:
            np.testing.assert_array_equal(_bits(sj[name]), _bits(sp[name]),
                                          err_msg=name)
    assert fires > 3
    flushes = perf.counter("pane_update_dispatches")
    assert flushes > 3
    assert perf.counter("bin_flush_uploads") == flushes
    assert perf.counter("bin_flush_blocking_uploads") == flushes
    compact_fires = perf.counter("bin_compact_fire_uploads")
    assert compact_fires == (fires if compact == "on" else 0)
    assert perf.counter("bin_compact_fire_blocking_uploads") == compact_fires


@pytest.mark.parametrize("shape", ["q5", "hot_items"])
def test_argmax_and_compact_fires_read_back_once(monkeypatch, shape):
    """The two fires of a COUNT(*) state against the JAX state's on the
    same stream: q5's argmax fire (``_emit_argmax``, one fire forced past
    its capacity) and hot items' compact fire (``_emit_compact``).  Rows
    equal; every argmax fire is one upload and one readback (two and one
    overflow past the capacity); every compact fire one upload and, when
    it has rows, one readback of its buffer.  A CPU device copies
    plainly, so the uploads count as blocking here."""
    from arroyo_tpu_torch.obs import perf

    monkeypatch.setenv("ARROYO_EMIT_COMPACT", "on")
    argmax = "max" if shape == "q5" else None
    j, p = _pair([("count", None, "n")], argmax, capacity=4_096)
    what = "bin_argmax_fire" if argmax else "bin_compact_fire"
    rng = np.random.default_rng(13)
    now, fires, overflows = 20_000, 0, 0
    for i in range(10):
        n = 3_000
        keys = rng.integers(0, 2_000, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        ts = (now + rng.integers(-2_500, 1_500, n)).astype(np.int64)
        for st in (j, p):
            st.update(keys, ts, {})
        if argmax and i >= 5 and not overflows:
            p._argmax_cap = 1  # until a fire's candidates overflow it
        cap = p._argmax_cap
        perf.reset()
        out = [st.fire_panes(now - 3_000) for st in (j, p)]
        _assert_fires_equal(*out)
        ups = perf.counter(f"{what}_uploads")
        reads = perf.counter(f"{what}_readbacks")
        over = perf.counter("bin_argmax_fire_overflows")
        rows = 0 if out[1] is None else len(out[1][0])
        assert ups in (0, 1) and perf.counter(f"{what}_blocking_uploads") \
            == ups
        if argmax:
            assert over == (1 if rows > cap else 0) and reads == ups + over
        else:
            assert reads == (1 if rows else 0) and over == 0
        fires += ups
        overflows += over
        now += 1_500
    assert fires >= 5 and (overflows == 1 if argmax else overflows == 0)
    _assert_fires_equal(j.fire_panes(0, final=True),
                        p.fire_panes(0, final=True))


@pytest.mark.parametrize("width,span,shape", [
    (120_000, 30, (256, 120)),  # a 120-bin window's final fire
    (3_000, 1_500, (2048, 3)),  # 1,500 bins of data fired at the end
])
def test_argmax_final_fire_of_many_panes_matches_jax(monkeypatch, width,
                                                     span, shape):
    """q5-shaped argmax states (COUNT(*), local max) whose only fire is
    the final one, over every pane of the stream: rows equal the JAX
    state's, and the fire reached ``argmax_fire_buffer`` with a pane ring
    of ``shape`` (kpad, W) — wide windows and more than 1,024 pending
    panes take the same kernel as q5's fire (the 1,500 panes' ties
    overflow the first capacity, so that fire launches twice)."""
    from arroyo_tpu_torch.ops import keyed_bins as kb

    # conftest's 8 CPU devices would send the JAX state's W >= 64 fire to
    # its bin-sharded ring branch; one device (the port's) never takes it
    monkeypatch.setenv("ARROYO_RING", "off")
    seen = []
    real = kb.argmax_fire_buffer

    def spy(counts, ring, bin_ok, *rest):
        seen.append(tuple(ring.shape))
        return real(counts, ring, bin_ok, *rest)

    monkeypatch.setattr(kb, "argmax_fire_buffer", spy)
    j = JaxState((JAggSpec(JAggKind.COUNT, None, "n"),), SLIDE, width,
                 capacity=64)
    p = PortState((AggSpec(AggKind.COUNT, None, "n"),), SLIDE, width,
                  capacity=64, device="cpu")
    for st in (j, p):
        st.set_argmax_local("n", "max")
    rng = np.random.default_rng(41)
    for _ in range(4):
        keys = rng.integers(0, 150, 2_000).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        ts = (20_000 + rng.integers(0, span * SLIDE, 2_000)).astype(
            np.int64)
        for st in (j, p):
            st.update(keys, ts, {})
            assert st.fire_panes(0) is None
    _assert_fires_equal(j.fire_panes(0, final=True),
                        p.fire_panes(0, final=True))
    assert seen and set(seen) == {shape}  # a second call on overflow
