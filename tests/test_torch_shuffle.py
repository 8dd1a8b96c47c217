"""The port's co-located device shuffle (arroyo_tpu_torch/parallel/
shuffle.py) against the JAX package's ``DeviceShuffle`` / ``_route_step``
and the host ``partition_route``, on the CPU with logical CPU devices
(conftest's eight forced host devices on the JAX side): the exchanged
buffers bit-equal to the JAX step's, the boundary hashes of the range
rule included; the sticky fallback, the enabling rule, the resharding
counter; the collector's device route with the sanitizer's stability
check; a parallelism-2 engine run with the same rows on either route;
and hot join rings placed round robin over the mesh."""

import asyncio

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_prng_guard  # noqa: F401  (ROADMAP C7: registered at import)

from arroyo_tpu.native import partition_route
from arroyo_tpu.parallel import shuffle as jshf
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu.types import hash_columns

from arroyo_tpu_torch.obs import perf
from arroyo_tpu_torch.parallel import shuffle as shf
from arroyo_tpu_torch.types import Batch

SEC = 1_000_000
CPU = torch.device("cpu")
U64_MAX = (1 << 64) - 1


def _cols(rng, n, nkeys=300):
    keys = rng.integers(0, nkeys, n).astype(np.int64)
    kh = hash_columns([keys])
    return (np.sort(rng.integers(0, 10 * SEC, n)).astype(np.int64),
            {"k": keys, "v": rng.standard_normal(n),
             "f32": rng.standard_normal(n).astype(np.float32),
             "flag": rng.random(n) < 0.5, "big": kh.copy(),
             "i32": rng.integers(-100, 100, n).astype(np.int32)}, kh)


def _same_batch(a, b):
    np.testing.assert_array_equal(a.timestamp, b.timestamp)
    np.testing.assert_array_equal(a.key_hash, b.key_hash)
    assert a.key_cols == b.key_cols and list(a.columns) == list(b.columns)
    for c in a.columns:
        assert a.columns[c].dtype == b.columns[c].dtype, c
        np.testing.assert_array_equal(a.columns[c], b.columns[c], err_msg=c)


@pytest.mark.parametrize("nd", [2, 4, 8])
def test_device_route_matches_jax_and_host_route(rng, monkeypatch, nd):
    """Per destination: the JAX device shuffle's rows and the host
    ``partition_route``'s, same order, same dtypes (u64 bit-exact)."""
    monkeypatch.setenv("ARROYO_SHUFFLE_DEVICE", "on")
    ts, cols, kh = _cols(rng, 4000)
    assert shf.device_shuffle_enabled(nd, [CPU] * nd)
    before = perf.counter(shf.COLLECTIVES)
    got = dict(shf.DeviceShuffle(nd, [CPU] * nd, op_id="t").route(
        Batch(ts, cols, kh, ("k",))))
    assert perf.counter(shf.COLLECTIVES) == before + 1
    jax_parts = dict(jshf.DeviceShuffle(nd).route(
        JaxBatch(ts, cols, kh, ("k",))))
    assert got.keys() == jax_parts.keys()
    _, order, bounds = partition_route(kh, nd)
    for d in range(nd):
        lo, hi = bounds[d], bounds[d + 1]
        if hi == lo:
            assert d not in got
            continue
        _same_batch(got[d], jax_parts[d])
        ref = Batch(ts, cols, kh, ("k",)).select(order[lo:hi])
        _same_batch(got[d], ref)


def _boundary(nk):
    lg = nk.bit_length() - 1
    out = []
    for k in range(nk + 1):
        for base in (k * (U64_MAX // nk), k << (64 - lg)):
            out += [(base + d) & U64_MAX for d in (-1, 0, 1)]
    return np.array(out, dtype=np.uint64)


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**32 - 1), nk=st.sampled_from([2, 4, 8]),
       fill=st.floats(0.0, 1.0), boundary=st.floats(0.0, 1.0))
def test_exchange_bit_equal_to_jax_route_step(seed, nk, fill, boundary):
    """mesh_route (the range rule) + exchange against the JAX
    ``_route_step`` on the same stacks: validity, f64 and i64 rows of
    every destination equal word for word, padding included."""
    N, nf, ni = 256, 2, 3
    r = np.random.default_rng(seed)
    m = int(fill * nk * N)
    kh = r.integers(0, 2**64 - 1, nk * N, dtype=np.uint64)
    b = _boundary(nk)
    pick = r.random(nk * N) < boundary
    kh[pick] = b[r.integers(0, len(b), int(pick.sum()))]
    kh[m:] = 0
    ok = np.zeros(nk * N, bool)
    ok[:m] = True
    fv = np.where(ok, r.standard_normal((nf, nk * N)), 0.0)
    iv = np.where(ok, r.integers(-2**62, 2**62, (ni, nk * N)), 0)
    j_ok, j_f, j_i = (np.asarray(x) for x in jshf._route_step(nk, nf, ni, N)(
        kh, fv, iv, ok))
    rows = np.zeros((2 + nf + ni, nk * N), np.int64)
    rows[0] = kh.view(np.int64)
    rows[1] = ok
    rows[2:2 + nf] = fv.view(np.int64)
    rows[2 + nf:] = iv
    ds = shf.DeviceShuffle(nk, [CPU] * nk)
    per_dest = ds.exchange_rows(rows, N)
    got = np.concatenate(per_dest, axis=1)
    np.testing.assert_array_equal(got[1] != 0, j_ok)
    np.testing.assert_array_equal(got[2:2 + nf].view(np.float64), j_f)
    np.testing.assert_array_equal(got[2 + nf:], j_i)


def test_device_route_unsupported_batch_sticky_fallback(rng, monkeypatch):
    """Object (string) columns cannot ride: route returns None and pins
    the host route for the edge's life."""
    monkeypatch.setenv("ARROYO_SHUFFLE_DEVICE", "on")
    keys = rng.integers(0, 50, 200).astype(np.int64)
    kh = hash_columns([keys])
    stringy = Batch(np.zeros(200, np.int64),
                    {"k": keys, "s": np.array(["x"] * 200, object)},
                    kh, ("k",))
    ds = shf.DeviceShuffle(4, [CPU] * 4)
    assert ds.route(stringy) is None
    ts, cols, kh = _cols(rng, 100)
    assert ds.route(Batch(ts, cols, kh, ("k",))) is None  # sticky


def test_device_shuffle_enabled_gates(monkeypatch):
    mesh8 = [CPU] * 8
    monkeypatch.setenv("ARROYO_SHUFFLE_DEVICE", "on")
    monkeypatch.setenv("ARROYO_MESH", "auto")
    assert shf.device_shuffle_enabled(4, mesh8)
    assert not shf.device_shuffle_enabled(3, mesh8)   # not a power of two
    assert not shf.device_shuffle_enabled(16, mesh8)  # beyond the mesh
    assert not shf.device_shuffle_enabled(4, [CPU])   # one device
    monkeypatch.setenv("ARROYO_MESH", "off")
    assert not shf.device_shuffle_enabled(4, mesh8)   # mesh off
    monkeypatch.setenv("ARROYO_MESH", "auto")
    monkeypatch.setenv("ARROYO_SHUFFLE_DEVICE", "off")
    assert not shf.device_shuffle_enabled(4, mesh8)
    # auto takes the host route on any device: the exchange's input and
    # output are host batches, so it only adds transfers
    monkeypatch.setenv("ARROYO_SHUFFLE_DEVICE", "auto")
    assert not shf.device_shuffle_enabled(4, mesh8)
    assert not shf.device_shuffle_enabled(4, [torch.device("cuda:0")] * 8)
    assert shf.partition_device(5, mesh8) == CPU
    assert shf.partition_device(5, [CPU]) is None


def test_ensure_sharded_counts_reshards_only_off_device():
    """A tensor on its shard's device passes free; a host array is
    ingest staging; a tensor elsewhere would be a counted reshard."""
    x = np.arange(64, dtype=np.int64)
    r0 = perf.counter(shf.RESHARDS)
    i0 = perf.counter(shf.INGEST_TRANSFERS)
    t = shf.ensure_sharded(x, CPU)
    assert perf.counter(shf.INGEST_TRANSFERS) == i0 + 1
    assert shf.ensure_sharded(t, CPU) is t
    assert perf.counter(shf.RESHARDS) == r0
    np.testing.assert_array_equal(t.numpy(), x)
    stats = shf.shuffle_stats()
    assert set(stats) == {"reshards", "collectives", "collective_rows",
                          "host_routes", "ingest_transfers"}


def test_collector_device_shuffle_end_to_end(rng, monkeypatch):
    """A collector with a 4-way shuffle group over a 4-device mesh routes
    through the device exchange (``on``), the queues get the host route's
    rows, and the sanitizer sees one stable spec per edge."""
    from arroyo_tpu_torch.analysis.sanitizer import Sanitizer
    from arroyo_tpu_torch.engine.context import Collector, OutQueue
    from arroyo_tpu_torch.types import MessageKind

    ts, cols, kh = _cols(rng, 3000)
    b = Batch(ts, cols, kh, ("k",))

    async def run(mode):
        monkeypatch.setenv("ARROYO_SHUFFLE_DEVICE", mode)
        qs = [asyncio.Queue(maxsize=1000) for _ in range(4)]
        san = Sanitizer("test")
        coll = Collector([[OutQueue(queue=q) for q in qs]], op_id="opX",
                         sanitizer=san, mesh=[CPU] * 4)
        await coll.collect(b)
        await coll.collect(b)  # the spec must not flip
        out = []
        for q in qs:
            rows = []
            while not q.empty():
                msg = q.get_nowait()
                assert msg.kind == MessageKind.RECORD
                rows.append(msg.batch)
            out.append(rows)
        return out, san

    c0 = perf.counter(shf.COLLECTIVES)
    h0 = perf.counter(shf.HOST_ROUTES)
    dev_out, san = asyncio.run(run("on"))
    assert perf.counter(shf.COLLECTIVES) == c0 + 2
    assert san._edge_sharding == {("opX", 0, 0): "keys@4"}
    host_out, san_h = asyncio.run(run("off"))
    assert perf.counter(shf.HOST_ROUTES) == h0 + 2
    assert san_h._edge_sharding == {("opX", 0, 0): "host@4"}
    for d in range(4):
        assert len(dev_out[d]) == len(host_out[d])
        for db, hb in zip(dev_out[d], host_out[d]):
            _same_batch(db, hb)


def test_engine_parallel2_device_shuffle_same_rows(monkeypatch):
    """A SQL pipeline at parallelism 2 on a mesh of four logical CPU
    devices emits the same rows with the device shuffle on and off, and
    the device route ran; each subtask's mesh state routes with shift 1
    (the sanitizer is armed by conftest)."""
    from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
    from arroyo_tpu_torch.engine.engine import LocalRunner
    from arroyo_tpu_torch.sql import plan_sql

    text = """
    CREATE TABLE nexmark WITH (
      connector = 'nexmark', event_rate = '1000000', num_events = '20000',
      rate_limited = 'false', batch_size = '2048',
      base_time_micros = '1700000000000000'
    );
    SELECT bid.auction as auction, TUMBLE(INTERVAL '2' SECOND) as window,
           count(*) AS num
    FROM nexmark WHERE bid is not null GROUP BY 1, 2
    """

    def run(mode):
        monkeypatch.setenv("ARROYO_SHUFFLE_DEVICE", mode)
        clear_sink("results")
        runner = LocalRunner(plan_sql(text, parallelism=2),
                             device=("cpu",) * 4)
        runner.run()
        shifts = sorted(op.state.route_shift
                        for op, _c in runner.engine.members.values()
                        if hasattr(op, "state"))
        return sorted(
            (int(a), int(w), int(n))
            for b in sink_output("results")
            for a, w, n in zip(b.columns["auction"],
                               b.columns["window_end"], b.columns["num"])
        ), shifts

    c0 = perf.counter(shf.COLLECTIVES)
    rows_dev, shifts = run("on")
    assert perf.counter(shf.COLLECTIVES) > c0
    assert shifts == [1, 1]
    rows_host, _ = run("off")
    assert rows_dev and rows_dev == rows_host


def test_join_ring_mesh_placement(rng, monkeypatch):
    """Hot join partitions place their rings round robin over the mesh
    (partition p on mesh device p mod nk); probes answer as the host
    probe does."""
    from arroyo_tpu_torch.state.join_state import PartitionedJoinBuffer

    monkeypatch.setenv("ARROYO_DEVICE_JOIN", "on")
    monkeypatch.setenv("ARROYO_JOIN_HOT_MIN_ROWS", "1")
    monkeypatch.setenv("ARROYO_JOIN_HOT_PARTITIONS", "8")
    mesh = [CPU] * 4
    placed = []
    orig = shf.partition_device

    def spy(p, devices):
        placed.append((p, devices is mesh or list(devices) == mesh))
        return orig(p, devices)

    monkeypatch.setattr(shf, "partition_device", spy)
    buf = PartitionedJoinBuffer(n_partitions=8, device="cpu", mesh=mesh)
    n = 20_000
    keys = rng.integers(0, 5000, n).astype(np.int64)
    kh = hash_columns([keys])
    b = Batch(np.sort(rng.integers(0, 30 * SEC, n)).astype(np.int64),
              {"k": keys, "v": rng.integers(0, 99, n)}, kh, ("k",))
    for lo in range(0, n, 4096):
        buf.append(b.select(np.arange(lo, min(lo + 4096, n))))
    assert buf.stats()["hot_partitions"] >= 2
    assert placed and all(ok for _p, ok in placed)
    assert all(p.dev_device == CPU for p in buf.parts if p.dev is not None)
    probe = np.sort(rng.choice(kh, 500, replace=False))
    q_dev, g_dev = buf.probe_positions(probe)
    monkeypatch.setenv("ARROYO_DEVICE_JOIN", "off")
    host = PartitionedJoinBuffer(n_partitions=8, device="cpu")
    host.append(b)
    q_h, g_h = host.probe_positions(probe)
    assert sorted(zip(q_dev.tolist(), g_dev.tolist())) == sorted(
        zip(q_h.tolist(), g_h.tolist()))
