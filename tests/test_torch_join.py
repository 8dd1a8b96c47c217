"""The port's join state (``arroyo_tpu_torch.ops.join``,
``arroyo_tpu_torch.state.join_state``) against arroyo_tpu's on the same
numpy inputs, on the CPU: the hot-partition ring round trip (stage ->
merge -> gather -> unpack) per payload dtype, and whole
``PartitionedJoinBuffer`` runs with the ring path forced on — identical
window joins, gathered rows and ``stats()``, and checkpoints that restore
across the two packages in both directions."""

import numpy as np
import pytest

from arroyo_tpu.ops import join as jj
from arroyo_tpu.state.join_state import PartitionedJoinBuffer as JaxBuffer
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch.ops import join as pj
from arroyo_tpu_torch.state.join_state import PartitionedJoinBuffer
from arroyo_tpu_torch.types import Batch

# one payload column per dtype kind the rings transport
DTYPES = {"u": np.uint64, "dt": "datetime64[us]", "flag": np.bool_,
          "f32": np.float32, "i32": np.int32, "i64": np.int64,
          "f64": np.float64}


def _cols(rng, n):
    return {
        "u": rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2) + 1,
        "dt": (rng.integers(0, 2**40, n)).astype("datetime64[us]"),
        "flag": rng.random(n) < 0.5,
        "f32": rng.normal(size=n).astype(np.float32),
        "i32": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, n),
        "f64": rng.normal(size=n) * 1e6,
    }


def _same_cols(a, b):
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, c
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)


@pytest.mark.parametrize("name", list(DTYPES) + [None])
def test_ring_round_trip_matches_jax(name):
    """stage_ring -> merge_ring -> gather_ring -> unpack_payload, one
    payload column of each dtype (None: all of them), bit-exact against
    the JAX package, key planes included."""
    rng = np.random.default_rng(41)
    n, m = 300, 120
    keys = np.sort(rng.integers(0, 2**63, n + m, dtype=np.uint64))
    all_cols = _cols(rng, n + m)
    if name is not None:
        all_cols = {name: all_cols[name]}
    ts = rng.integers(0, 10**9, n + m)
    resident = np.sort(rng.choice(n + m, n, replace=False))
    delta = np.setdiff1d(np.arange(n + m), resident)
    rk, dk = keys[resident], keys[delta]
    res_cols = {c: v[resident] for c, v in all_cols.items()}
    d_cols = {c: v[delta] for c, v in all_cols.items()}
    ins = np.searchsorted(rk, dk, side="right")
    dpos = ins + np.arange(m)
    keep = np.ones(n + m, dtype=bool)
    keep[dpos] = False
    res_pos = np.nonzero(keep)[0]

    rings = []
    for mod, dev in ((jj, None), (pj, "cpu")):
        ring = mod.stage_ring(rk, dev, sorted_ts=ts[resident],
                              sorted_cols=res_cols)
        rings.append(mod.merge_ring(ring, res_pos, dk, dpos,
                                    delta_ts=ts[delta], delta_cols=d_cols))
    jr, pr = rings
    assert (pr.cap, pr.nf, pr.ni, pr.plan) == (jr.cap, jr.nf, jr.ni, jr.plan)
    np.testing.assert_array_equal(pr.hi.numpy(), np.asarray(jr.hi))
    np.testing.assert_array_equal(pr.lo.numpy(), np.asarray(jr.lo))
    spos = np.sort(rng.integers(0, n + m, 200))
    jts, jcols = jj.unpack_payload(jr, *jj.gather_ring(jr, spos))
    pts, pcols = pj.unpack_payload(pr, *pj.gather_ring(pr, spos))
    np.testing.assert_array_equal(pts, jts)
    _same_cols(pcols, jcols)
    # and the gathered rows are the merged run's rows
    order = np.concatenate([resident, delta])[np.argsort(
        np.concatenate([np.nonzero(keep)[0], dpos]))]
    np.testing.assert_array_equal(pts, ts[order][spos])
    for c in all_cols:
        np.testing.assert_array_equal(pcols[c], all_cols[c][order][spos])


@pytest.mark.parametrize("name", ["f64", "i64", None])
@pytest.mark.parametrize("queries", ["hits", "collide", "none"])
def test_probe_expand_gather_matches_jax(name, queries):
    """probe_ring -> expand_gather on a resident ring: the port's one
    readback of the kernel's buffer gives the JAX package's five arrays
    (query index, ring position, the full-key verify, both payload
    stacks), bit-exact; then unpack_payload gives the same columns.
    ``hits``: queries drawn from the ring's keys and others; ``collide``:
    queries sharing a ring key's top 32 bits only; ``none``: no pair."""
    rng = np.random.default_rng(43)
    n, m = 400, 150
    keys = np.sort(rng.integers(0, 2**40, n, dtype=np.uint64) << np.uint64(
        20))
    keys[50:60] = keys[50]  # a run of equal keys
    keys = np.sort(keys)
    cols = _cols(rng, n)
    if name is not None:
        cols = {name: cols[name]}
    ts = rng.integers(0, 10**9, n)
    if queries == "none":
        q = keys[rng.integers(0, n, m)] + np.uint64(1) + (np.uint64(1) << np.uint64(35))
    else:
        q = keys[rng.integers(0, n, m)]
        other = rng.random(m) < 0.3
        q[other] = rng.integers(0, 2**60, int(other.sum()), dtype=np.uint64)
        if queries == "collide":  # same top 32 bits, other low bits
            q[~other] ^= np.uint64(0x5)
            q[:5] = keys[:5]
    q = np.sort(q)
    got = []
    for mod, dev in ((jj, None), (pj, "cpu")):
        ring = mod.stage_ring(keys, dev, sorted_ts=ts, sorted_cols=cols)
        hit = mod.probe_ring(ring, q, n)
        if mod is jj:
            total = int(np.asarray(hit.counts).sum())
            out = mod.expand_gather(ring, hit, total) if total else None
        else:
            assert hit.total == total
            out = mod.expand_gather(ring, hit) if total else None
        got.append((ring, out))
    (jr, jout), (pr, pout) = got
    assert (total == 0) == (queries == "none")
    if not total:
        return
    for g, w in zip(pout, jout):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    valid = pout[2]
    if queries == "collide":
        assert valid.any() and not valid.all()
    jts, jcols = jj.unpack_payload(jr, jout[3][:, valid], jout[4][:, valid])
    pts, pcols = pj.unpack_payload(pr, pout[3][:, valid], pout[4][:, valid])
    np.testing.assert_array_equal(pts, jts)
    _same_cols(pcols, jcols)


def test_split_helpers_match_jax():
    rng = np.random.default_rng(43)
    keys = rng.integers(0, 2**63, 1000, dtype=np.uint64) * np.uint64(2)
    np.testing.assert_array_equal(pj.split_hi32(keys), jj.split_hi32(keys))
    np.testing.assert_array_equal(pj.split_lo32(keys), jj.split_lo32(keys))
    assert (pj.SENT32_HI, pj.SENT32_LO, pj.SENTINEL) == (
        jj.SENT32_HI, jj.SENT32_LO, jj.SENTINEL)
    top = np.array([0xFFFFFFFF00000001], dtype=np.uint64)
    assert pj.ring_stageable(keys) and not pj.ring_stageable(top)
    counts = np.array([2, 0, 3, 1])
    for a, b in zip(pj.expand_counts(counts), jj.expand_counts(counts)):
        np.testing.assert_array_equal(a, b)
    lk = np.sort(rng.integers(0, 20, 50).astype(np.uint64))
    rk = np.sort(rng.integers(0, 20, 40).astype(np.uint64))
    for a, b in zip(pj._host_pairs(lk, rk), jj._host_pairs(lk, rk)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def ring_knobs(monkeypatch):
    """Both packages take the ring path on the CPU (JAX's mesh off, so
    its rings stay on one device as the port's do)."""
    monkeypatch.setenv("ARROYO_DEVICE_JOIN", "on")
    monkeypatch.setenv("ARROYO_JOIN_HOT_MIN_ROWS", "16")
    monkeypatch.setenv("ARROYO_MESH", "off")


def _side_batches(rng, n_batches, size, t0):
    """Keyed batches of one join side: keys from a small space (so both
    sides match), timestamps over ten 1 ms windows."""
    out = []
    for i in range(n_batches):
        kh = rng.integers(0, 400, size).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        ts = t0 + rng.integers(0, 10_000, size) + i * 500
        out.append((ts, _cols(rng, size), kh))
    return out


def _same_batch(p, j):
    np.testing.assert_array_equal(p.timestamp, j.timestamp)
    np.testing.assert_array_equal(p.key_hash, j.key_hash)
    _same_cols(p.columns, j.columns)


def _to_port(b):
    return Batch(b.timestamp, dict(b.columns), b.key_hash, b.key_cols)


def _to_jax(b):
    return JaxBatch(b.timestamp, dict(b.columns), b.key_hash, b.key_cols)


def _drive(bufs, rng):
    """Append both sides batch by batch, firing and evicting windows as
    the (batch-granular) event time advances; every step must agree."""
    (jl, jr), (pl, pr) = bufs
    lefts = _side_batches(rng, 12, 200, 0)
    rights = _side_batches(rng, 12, 150, 0)
    fired = 0
    for i, ((lts, lc, lk), (rts, rc, rkh)) in enumerate(zip(lefts, rights)):
        for buf, cls in ((jl, JaxBatch), (pl, Batch)):
            buf.append(cls(lts, lc, lk, ("k",)))
        for buf, cls in ((jr, JaxBatch), (pr, Batch)):
            buf.append(cls(rts, rc, rkh, ("k",)))
        for a, b in ((jl, pl), (jr, pr)):
            assert b.stats() == {**a.stats(), "ring_devices":
                                 min(a.stats()["hot_partitions"], 1)}
        if i % 3 == 2:
            start, end = i * 500, i * 500 + 2_000
            jres = jl.range_join(jr, start, end)
            pres = pl.range_join(pr, start, end)
            for a, b in zip(pres, jres):
                np.testing.assert_array_equal(a, b)
            for buf_j, buf_p, pos in ((jl, pl, jres[0]), (jr, pr, jres[1]),
                                      (jl, pl, jres[2])):
                _same_batch(buf_p.gather(pos), buf_j.gather(pos))
            fired += len(jres[0])
            for buf in (jl, jr, pl, pr):
                buf.evict_before(start)
    return fired


def test_partitioned_buffer_matches_jax(ring_knobs):
    """Same window joins, same gathered rows (device-ring and host
    partitions alike) and the same ``stats()``: ``ring_devices`` counts
    the devices holding rings, which is the one device here (the JAX
    package would spread rings over a mesh)."""
    from arroyo_tpu.obs import perf as jperf
    from arroyo_tpu_torch.obs import perf

    rng = np.random.default_rng(47)
    perf.reset()
    before = jperf.counter("join_device_gather_rows")
    bufs = ((JaxBuffer(), JaxBuffer()),
            (PartitionedJoinBuffer(device="cpu"),
             PartitionedJoinBuffer(device="cpu")))
    assert _drive(bufs, rng) > 0
    assert perf.counter("join_state_device_merges") > 0
    assert perf.counter("join_device_gather_rows") > 0
    assert perf.counter("join_device_gather_rows") == (
        jperf.counter("join_device_gather_rows") - before)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_join_buffer_snapshots_restore_across_packages(ring_knobs,
                                                      direction):
    """A buffer's ``snapshot_batch`` restores in the other package's
    buffer: the same rows, the same window join afterwards."""
    rng = np.random.default_rng(53)
    src = JaxBuffer() if direction == "jax_to_port" else \
        PartitionedJoinBuffer(device="cpu")
    other = JaxBuffer() if direction == "jax_to_port" else \
        PartitionedJoinBuffer(device="cpu")
    cls = JaxBatch if direction == "jax_to_port" else Batch
    for ts, cols, kh in _side_batches(rng, 4, 300, 0):
        src.append(cls(ts, cols, kh, ("k",)))
    for ts, cols, kh in _side_batches(rng, 4, 300, 0):
        other.append(cls(ts, cols, kh, ("k",)))
    src.evict_before(700)
    snap = src.snapshot_batch()
    if direction == "jax_to_port":
        dst = PartitionedJoinBuffer(device="cpu")
        dst.restore_batch(_to_port(snap))
        peer = PartitionedJoinBuffer(device="cpu")
        peer.restore_batch(_to_port(other.snapshot_batch()))
    else:
        dst = JaxBuffer()
        dst.restore_batch(_to_jax(snap))
        peer = JaxBuffer()
        peer.restore_batch(_to_jax(other.snapshot_batch()))
    _same_batch(dst.snapshot_batch(), snap)
    assert dst.stats()["hot_partitions"] > 0
    want = src.range_join(other, 0, 4_000)
    got = dst.range_join(peer, 0, 4_000)
    assert len(want[0]) > 0
    # restore re-appends live rows in storage order, so sorted-run
    # positions may differ: compare the joined pairs themselves
    def pairs(left, right, res):
        lrows, rrows = left.gather(res[0]), right.gather(res[1])
        return sorted(zip(lrows.key_hash.tolist(),
                          lrows.columns["i64"].tolist(),
                          rrows.columns["i64"].tolist()))

    assert pairs(dst, peer, got) == pairs(src, other, want)


def _colliding_keys(rng, n):
    """Key hashes from a small space with many top-32-equal keys that
    differ in their low bits within one partition (the low 4 bits), so a
    ring probe's hi-plane candidates include false ones."""
    hi = rng.integers(1, 40, n).astype(np.uint64) << np.uint64(32)
    mid = rng.integers(0, 6, n).astype(np.uint64) << np.uint64(8)
    return hi | mid | rng.integers(0, 16, n).astype(np.uint64)


@pytest.mark.parametrize("with_string", [False, True])
def test_probe_side_matches_jax(ring_knobs, with_string):
    """``probe``/``probe_rows`` per partition and ``probe_batch``,
    ``contains_keys``, ``rows_with_keys`` per buffer equal the JAX
    buffer's after every append and TTL eviction — rings with payload
    planes (the fused expand-gather) or, with a string column, keys-only
    rings (expand + host verify) — and so do the stats registry's
    notes."""
    from arroyo_tpu.obs import perf as jperf
    from arroyo_tpu.state.join_state import (
        aggregate_stats_registry as jax_fold)
    from arroyo_tpu_torch.obs import perf
    from arroyo_tpu_torch.state.join_state import aggregate_stats_registry

    rng = np.random.default_rng(67 + with_string)
    perf.reset()
    jperf.note("join_state_registry", {})
    jb, pb = JaxBuffer(), PartitionedJoinBuffer(device="cpu")
    probes = 0
    for i in range(10):
        n = 300
        kh = _colliding_keys(rng, n)
        ts = i * 1_000 + rng.integers(0, 1_000, n)
        cols = {"i64": rng.integers(-2**62, 2**62, n),
                "f64": rng.normal(size=n)}
        if with_string:
            cols["s"] = np.array([f"x{v}" for v in
                                  rng.integers(0, 9, n)], dtype=object)
        jb.append(JaxBatch(ts, dict(cols), kh, ("k",)))
        pb.append(Batch(ts, dict(cols), kh, ("k",)))
        if i % 3 == 2:
            for b in (jb, pb):
                b.evict_before(i * 1_000 - 2_500)
        qk = _colliding_keys(rng, 200)
        qts = np.full(200, i * 1_000 + 999)
        got = pb.probe_batch(Batch(qts, {}, qk, ("k",)))
        want = jb.probe_batch(JaxBatch(qts, {}, qk, ("k",)))
        np.testing.assert_array_equal(got[0], want[0])
        _same_batch(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        probes += len(got[0])
        np.testing.assert_array_equal(pb.contains_keys(qk),
                                      jb.contains_keys(qk))
        _same_batch(pb.rows_with_keys(qk[:50]), jb.rows_with_keys(qk[:50]))
        qs = np.sort(qk)
        dest = (qs & np.uint64(pb.P - 1)).astype(np.int64)
        for p in range(pb.P):
            q = qs[dest == p]
            for a, b in zip(pb.parts[p].probe(q), jb.parts[p].probe(q)):
                np.testing.assert_array_equal(a, b)
            a, b = pb.parts[p].probe_rows(q), jb.parts[p].probe_rows(q)
            for x, y in zip(a[:2], b[:2]):
                np.testing.assert_array_equal(x, y)
            assert (a[2] is None) == (b[2] is None)
            if a[2] is not None:
                _same_cols(a[2], b[2])
                np.testing.assert_array_equal(a[3], b[3])
    assert probes > 0
    hot = [p for p in pb.parts if p.dev is not None]
    assert hot and all((p.dev.plan is None) == with_string for p in hot)
    assert perf.counter("join_state_device_merges") > 0
    want = jax_fold(jperf.get_note("join_state_registry"))
    got = aggregate_stats_registry(perf.get_note("join_state_registry"))
    assert got == {**want, "ring_devices": min(want["hot_partitions"], 1)}
