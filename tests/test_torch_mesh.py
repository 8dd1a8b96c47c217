"""The port's keyed mesh (arroyo_tpu_torch/parallel/mesh_window.py) against
the JAX package's ``MeshKeyedBinState`` on conftest's eight forced host
devices, on the CPU: the port runs its shards on logical CPU devices
(``("cpu",) * nk``), the kernels through their plain versions.

* state: fires, overflow counters and snapshots equal the JAX mesh
  state's exactly at nk = 2, 4, 8 (and a numpy oracle), under key
  pressure that grows the shards, with NULLs, out-of-order rows, a route
  shift, the i32 -> i64 counts promotion and factor-ring drains;
* snapshots: mesh <-> single device and 8 <-> 4 <-> 2 shards, across the
  packages both ways;
* kernels: mesh_route, mesh_merge and mesh_remap's plain versions against
  the halves of the JAX ``_update_step`` and ``_roll_step`` (hypothesis,
  the route rules' boundary hashes included);
* the engine: ``make_bin_state``'s choice, the operator's route shift at
  parallelism, and SQL q5 and a factored plan with the same rows on the
  mesh and on one device."""

import asyncio

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_prng_guard  # noqa: F401  (ROADMAP C7: registered at import)

from arroyo_tpu.graph.logical import AggKind as JaxKind
from arroyo_tpu.graph.logical import AggSpec as JaxSpec
from arroyo_tpu.ops.keyed_bins import KeyedBinState as JaxKeyed
from arroyo_tpu.parallel import mesh_window as jmw
from arroyo_tpu.types import hash_columns

from arroyo_tpu_torch.graph.logical import AggKind, AggSpec
from arroyo_tpu_torch.kernels.join_sort import join_sort_reference
from arroyo_tpu_torch.kernels.mesh_merge import mesh_merge_reference
from arroyo_tpu_torch.kernels.mesh_remap import mesh_remap_reference
from arroyo_tpu_torch.kernels.mesh_route import (
    RULE_MESH, RULE_SHUFFLE, destinations, mesh_route_reference)
from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState
from arroyo_tpu_torch.parallel import shuffle as shf
from arroyo_tpu_torch.parallel.mesh_window import (
    MeshKeyedBinState, make_bin_state, mesh_key_shards)

SEC = 1_000_000
CPU = torch.device("cpu")
U64_MAX = (1 << 64) - 1


def _aggs(kind=AggKind, spec=AggSpec):
    return (spec(kind.COUNT, None, "cnt"), spec(kind.SUM, "v", "total"),
            spec(kind.MIN, "v", "lo"), spec(kind.MAX, "v", "hi"))


def _pair(nk, width_s=2, slide_s=1, capacity=256, port_shards=None,
          aggs=None):
    """(JAX mesh state, port mesh state) of the same shape."""
    j = jmw.MeshKeyedBinState(aggs[0] if aggs else _aggs(JaxKind, JaxSpec),
                              slide_s * SEC, width_s * SEC,
                              capacity=capacity, n_shards=nk)
    ps = port_shards or nk
    t = MeshKeyedBinState(aggs[1] if aggs else _aggs(), slide_s * SEC,
                          width_s * SEC, capacity=capacity, n_shards=ps,
                          device=("cpu",) * ps)
    return j, t


def same_fire(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return 0
    for x, y in zip(a[:1] + a[2:], b[:1] + b[2:]):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    assert list(a[1]) == list(b[1])
    for c in a[1]:
        np.testing.assert_array_equal(a[1][c], b[1][c], err_msg=c)
        assert a[1][c].dtype == b[1][c].dtype, c
    return len(a[0])


def same_snapshot(a, b):
    assert set(a) == set(b)
    for k in a:
        x = np.asarray(a[k])
        np.testing.assert_array_equal(x, b[k], err_msg=k)
        assert x.dtype == b[k].dtype, k


def oracle_windows(ts, kh, vals, width, slide):
    exp = {}
    for t, k, v in zip(ts.tolist(), kh.tolist(), vals.tolist()):
        e = (t // slide + 1) * slide
        while e - width <= t < e:
            c, s, mn, mx = exp.get((k, e), (0, 0, 1 << 60, -(1 << 60)))
            exp[(k, e)] = (c + 1, s + v, min(mn, v), max(mx, v))
            e += slide
    return exp


def collect(fires, got=None):
    got = {} if got is None else got
    for f in fires:
        if f is None:
            continue
        kk, oc, wend, _ = f
        for j in range(len(kk)):
            key = (int(kk[j]), int(wend[j]))
            assert key not in got, f"pane fired twice: {key}"
            got[key] = (int(oc["cnt"][j]), int(oc["total"][j]),
                        int(oc["lo"][j]), int(oc["hi"][j]))
    return got


def drive_both(states, kh, ts, vals, batches=3, final=True):
    """Feed both states the same batches with interleaved fires; every
    fire equal; returns the port's fires."""
    bounds = np.linspace(0, len(kh), batches + 1).astype(int)
    fires = []
    for s, e in zip(bounds[:-1], bounds[1:]):
        if e <= s:
            continue
        outs = []
        for st_ in states:
            st_._lookup_or_insert(kh[s:e])
            st_.update(kh[s:e], ts[s:e], {"v": vals[s:e]})
            outs.append(st_.fire_panes(int(ts[e - 1])))
        same_fire(*outs)
        fires.append(outs[-1])
    if final:
        outs = [st_.fire_panes(1 << 60, final=True) for st_ in states]
        same_fire(*outs)
        fires.append(outs[-1])
    return fires


def _stream(rng, n, n_keys, span_s):
    ts = np.sort(rng.integers(0, span_s * SEC, n)).astype(np.int64)
    keys = rng.integers(0, n_keys, n).astype(np.int64)
    vals = rng.integers(1, 100, n).astype(np.int64)
    return ts, hash_columns([keys]), vals


# -- the state against the JAX mesh state ---------------------------------------


@pytest.mark.parametrize("nk,width_s,slide_s", [
    (8, 2, 1), (4, 1, 1), (2, 3, 1), (8, 1, 1)])
def test_mesh_state_matches_oracle(rng, nk, width_s, slide_s):
    ts, kh, vals = _stream(rng, 4000, 40, 8)
    j, t = _pair(nk, width_s, slide_s, capacity=512)
    fires = drive_both((j, t), kh, ts, vals)
    assert collect(fires) == oracle_windows(ts, kh, vals, width_s * SEC,
                                            slide_s * SEC)
    assert t.overflow_counters() == j.overflow_counters() == (0, 0)
    same_snapshot(j.snapshot(), t.snapshot())


@pytest.mark.parametrize("nk", [2, 4, 8])
def test_mesh_overflow_pressure_zero_loss(rng, nk):
    """~3,000 keys against a 64-slot floor: the host directory doubles
    the shards' capacity ahead of every batch that could overflow one,
    as the JAX state does; no row lost, both counters 0."""
    ts, kh, vals = _stream(rng, 6000, 3000, 4)
    j, t = _pair(nk, capacity=64)
    assert t.C == j.C == 64
    fires = drive_both((j, t), kh, ts, vals, batches=5)
    assert collect(fires) == oracle_windows(ts, kh, vals, 2 * SEC, SEC)
    assert t.overflow_counters() == j.overflow_counters() == (0, 0)
    assert t.C == j.C > 64
    np.testing.assert_array_equal(t.shard_counts, j.shard_counts)


def test_mesh_null_skipping(rng):
    """NaN (SQL NULL) rows skip SUM and AVG's divisor on the mesh too:
    COUNT(v), AVG(v), SUM(v) fires equal the JAX state's, NaN for a pane
    of NULLs only."""
    n = 600
    ts = np.sort(rng.integers(0, 2 * SEC, n)).astype(np.int64)
    keys = rng.integers(0, 6, n).astype(np.int64)
    keys[::50] = 99  # a key whose rows are all NULL
    kh = hash_columns([keys])
    col = np.where((rng.random(n) < 0.5) | (keys == 99), np.nan,
                   rng.integers(1, 100, n).astype(np.float64))

    def aggs(kind, spec):
        return (spec(kind.COUNT, "v", "cv"), spec(kind.AVG, "v", "mean"),
                spec(kind.SUM, "v", "total"))

    j, t = _pair(8, 1, 1, capacity=128,
                 aggs=(aggs(JaxKind, JaxSpec), aggs(AggKind, AggSpec)))
    outs = []
    for st_ in (j, t):
        st_._lookup_or_insert(kh)
        st_.update(kh, ts, {"v": col})
        outs.append(st_.fire_panes(1 << 60, final=True))
    assert same_fire(*outs) > 0
    assert np.isnan(outs[1][1]["mean"]).any()


@pytest.mark.parametrize("first,second", [(8, 4), (4, 2), (2, 8)])
def test_mesh_snapshot_restore_rescale(rng, first, second):
    """A snapshot of a ``first``-shard mesh restored into a ``second``-
    shard mesh mid-stream, in each package and across the packages both
    ways: the snapshots equal and the continued output equals the
    uninterrupted run."""
    ts, kh, vals = _stream(rng, 3000, 30, 6)
    half = len(kh) // 2
    j1, t1 = _pair(first)
    f1 = drive_both((j1, t1), kh[:half], ts[:half], vals[:half], batches=1,
                    final=False)
    snap_j, snap_t = j1.snapshot(), t1.snapshot()
    same_snapshot(snap_j, snap_t)
    exp = oracle_windows(ts, kh, vals, 2 * SEC, SEC)
    for src in (snap_j, snap_t):
        j2, t2 = _pair(second)
        j2.restore({k: np.asarray(v) for k, v in src.items()})
        t2.restore({k: np.asarray(v) for k, v in src.items()})
        f2 = drive_both((j2, t2), kh[half:], ts[half:], vals[half:],
                        batches=1)
        assert collect(f1 + f2) == exp
        same_snapshot(j2.snapshot(), t2.snapshot())


def test_snapshot_cross_topology(rng):
    """Mesh -> single device and single device -> mesh, in the port and
    from the JAX package's states, with identical continued output."""
    ts, kh, vals = _stream(rng, 2000, 20, 6)
    half = len(kh) // 2
    exp = oracle_windows(ts, kh, vals, 2 * SEC, SEC)
    makers = {
        "port mesh 8": lambda: MeshKeyedBinState(
            _aggs(), SEC, 2 * SEC, capacity=128, n_shards=8,
            device=("cpu",) * 8),
        "port mesh 4": lambda: MeshKeyedBinState(
            _aggs(), SEC, 2 * SEC, capacity=128, n_shards=4,
            device=("cpu",) * 4),
        "port single": lambda: KeyedBinState(_aggs(), SEC, 2 * SEC,
                                             capacity=128, device="cpu"),
        "jax mesh 8": lambda: jmw.MeshKeyedBinState(
            _aggs(JaxKind, JaxSpec), SEC, 2 * SEC, capacity=128,
            n_shards=8),
        "jax single": lambda: JaxKeyed(_aggs(JaxKind, JaxSpec), SEC,
                                       2 * SEC, capacity=128),
    }
    for first, second in [("port mesh 8", "port single"),
                          ("port single", "port mesh 4"),
                          ("jax mesh 8", "port mesh 4"),
                          ("port mesh 8", "jax single"),
                          ("jax single", "port mesh 8")]:
        st1 = makers[first]()
        st1._lookup_or_insert(kh[:half])
        st1.update(kh[:half], ts[:half], {"v": vals[:half]})
        f1 = st1.fire_panes(int(ts[half - 1]))
        snap = {k: np.asarray(v) for k, v in st1.snapshot().items()}
        st2 = makers[second]()
        st2.restore(snap)
        st2._lookup_or_insert(kh[half:])
        st2.update(kh[half:], ts[half:], {"v": vals[half:]})
        f2 = st2.fire_panes(1 << 60, final=True)
        assert collect([f1, f2]) == exp, (first, second)


def test_mesh_out_of_order_before_fire():
    """Rows older than the first batch, before any fire, are live: the
    ring rebases down (``mesh_remap`` with a negative shift)."""
    j, t = _pair(4, capacity=64)
    kh = hash_columns([np.array([7, 7, 7], dtype=np.int64)])
    for st_ in (j, t):
        st_._lookup_or_insert(kh[:1])
        st_.update(kh[:1], np.array([10 * SEC], np.int64),
                   {"v": np.array([5])})
        st_._lookup_or_insert(kh[1:2])
        st_.update(kh[1:2], np.array([2 * SEC], np.int64),
                   {"v": np.array([9])})
    assert t.B == j.B and t.base_bin == j.base_bin == 2
    outs = [st_.fire_panes(1 << 60, final=True) for st_ in (j, t)]
    same_fire(*outs)
    kk, oc, wend, _ = outs[1]
    got = {int(w): (int(c), int(s)) for w, c, s in
           zip(wend, oc["cnt"], oc["total"])}
    assert got == {3 * SEC: (1, 9), 4 * SEC: (1, 9),
                   11 * SEC: (1, 5), 12 * SEC: (1, 5)}
    assert t.late_rows == 0


def test_route_shift_spreads_subtask_key_slice(rng):
    """Keys of one subtask's top-bit slice funnel onto one shard without
    the shift; with it they spread, the fires equal the JAX state's."""
    ts, kh, vals = _stream(rng, 3000, 60, 6)
    kh = (kh >> np.uint64(2)) | (np.uint64(3) << np.uint64(62))
    plain = MeshKeyedBinState(_aggs(), SEC, 2 * SEC, capacity=256,
                              n_shards=4, device=("cpu",) * 4)
    plain._lookup_or_insert(kh)
    assert (plain.shard_counts > 0).sum() == 1
    j, t = _pair(4)
    for st_ in (j, t):
        st_.set_route_shift(2)
    fires = drive_both((j, t), kh, ts, vals)
    assert collect(fires) == oracle_windows(ts, kh, vals, 2 * SEC, SEC)
    assert t.overflow_counters() == (0, 0)
    assert (t.shard_counts > 0).sum() > 1
    np.testing.assert_array_equal(t.shard_counts, j.shard_counts)


def test_mesh_i32_counts_plane_promotes_to_i64(rng, monkeypatch):
    """The counts planes promote to i64 before the batch that could wrap
    an i32 cell, and a promoted snapshot restores promoted."""
    monkeypatch.setattr(KeyedBinState, "_i32_promote", 500)
    monkeypatch.setattr(JaxKeyed, "_i32_promote", 500)
    j, t = _pair(4, capacity=64)
    total = 0
    for _ in range(3):
        ts, kh, vals = _stream(rng, 300, 10, 3)
        for st_ in (j, t):
            st_.update(kh, ts, {"v": vals})
        total += 300
    assert all(c.dtype == torch.int64 for c in t.d_counts)
    same_snapshot(j.snapshot(), t.snapshot())
    t2 = MeshKeyedBinState(_aggs(), SEC, 2 * SEC, capacity=64, n_shards=4,
                           device=("cpu",) * 4)
    t2.restore(j.snapshot())
    assert t2.total_rows == total
    assert all(c.dtype == torch.int64 for c in t2.d_counts)
    r = t2.fire_panes(10 ** 9, final=True)
    assert int(r[1]["cnt"].sum()) == 2 * total and (r[3] > 0).all()


@pytest.mark.parametrize("nk", [2, 8])
def test_mesh_drain_deltas_matches_jax(rng, nk):
    """A factor ring (W == 1) drained at barriers between fires: every
    drain and fire equals the JAX mesh state's, drained cells reset."""
    j, t = _pair(nk, width_s=1, slide_s=1)
    fired = 0
    for i in range(4):
        ts, kh, vals = _stream(rng, 800, 50, 3)
        ts = ts + i * 2 * SEC
        for st_ in (j, t):
            st_._lookup_or_insert(kh)
            st_.update(kh, ts, {"v": vals})
        fired += same_fire(j.drain_deltas(), t.drain_deltas())
        fired += same_fire(j.fire_panes(int(ts[-1]) - SEC),
                           t.fire_panes(int(ts[-1]) - SEC))
        same_snapshot(j.snapshot(), t.snapshot())
    assert fired > 0


# -- the kernels' plain versions against the JAX steps --------------------------


def _boundary_keys(nk):
    lg = nk.bit_length() - 1
    out = []
    for k in range(nk + 1):
        for base in (k * (U64_MAX // nk), k << (64 - lg)):
            out += [(base + d) & U64_MAX for d in (-1, 0, 1)]
    return np.array(out, dtype=np.uint64)


def _keys(draw_seed, n, nk, boundary_share):
    r = np.random.default_rng(draw_seed)
    keys = r.integers(0, 2**64 - 2, n, dtype=np.uint64)
    b = _boundary_keys(nk)
    pick = r.random(n) < boundary_share
    keys[pick] = b[r.integers(0, len(b), int(pick.sum()))]
    # a real key is never EMPTY (the host maps it to EMPTY - 1)
    keys[keys == np.uint64(U64_MAX)] = np.uint64(U64_MAX - 1)
    return keys


@pytest.mark.parametrize("nk", [2, 4, 8])
def test_route_rules_match_the_jax_rules_at_boundaries(nk):
    """Both destination rules on the boundary hashes: the mesh rule as the
    JAX route and the host directory's ``_shard_of`` (shift 0 and 5), the
    shuffle rule as ``server_for_hash``."""
    from arroyo_tpu.types import server_for_hash_array

    keys = np.concatenate([_boundary_keys(nk), _keys(1, 500, nk, 0.0)])
    keys[keys == np.uint64(U64_MAX)] = np.uint64(U64_MAX - 1)
    t = torch.tensor(keys.view(np.int64))
    np.testing.assert_array_equal(
        destinations(t, nk, RULE_SHUFFLE).numpy(),
        server_for_hash_array(keys, nk))
    for shift in (0, 5):
        j = jmw.MeshKeyedBinState(_aggs(JaxKind, JaxSpec), SEC, 2 * SEC,
                                  capacity=64, n_shards=nk)
        j.route_shift = shift
        np.testing.assert_array_equal(
            destinations(t, nk, RULE_MESH, shift).numpy(), j._shard_of(keys))


def _port_update(keys, bins, counts, of, rows, nk, C, B, N, shift, kinds):
    """The port's update step over per-shard numpy state (the JAX step's
    global arrays cut by shard): route, exchange, sort, merge, re-lay,
    scatter, through the kernels' plain versions."""
    from arroyo_tpu_torch.kernels.bin_update import (bin_update_reference,
                                                     channel_plan)

    F = rows.shape[0]
    routes, drops = [], np.zeros((nk, 2), np.int64)
    for s in range(nk):
        out, d = mesh_route_reference(
            torch.tensor(rows[:, s * N:(s + 1) * N]), nk, RULE_MESH, shift)
        routes.append(out)
        drops[s, 0] = d
    incoming = shf.exchange(routes, [CPU] * nk)
    res = []
    for d in range(nk):
        inc = incoming[d].view(F, nk * N)
        order, ks = join_sort_reference(inc[0].clone())
        new_keys, src, cells, kd = mesh_merge_reference(
            torch.tensor(keys[d * C:(d + 1) * C].view(np.int64)), ks, order,
            inc.contiguous())
        drops[d, 1] = kd
        v, c = mesh_remap_reference(
            torch.tensor(bins[:, d * C:(d + 1) * C]),
            torch.tensor(counts[d * C:(d + 1) * C]), src, 0, C, B, kinds)
        v, c = v.clone(), c.clone()
        bin_update_reference(v, c, cells, channel_plan(kinds))
        res.append((new_keys.numpy().view(np.uint64), v.numpy(), c.numpy()))
    return (np.concatenate([r[0] for r in res]),
            np.concatenate([r[1] for r in res], axis=1),
            np.concatenate([r[2] for r in res]), of + drops)


@settings(max_examples=12, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**32 - 1), nk=st.sampled_from([2, 4, 8]),
       shift=st.sampled_from([0, 3]), fill=st.floats(0.0, 1.0),
       boundary=st.floats(0.0, 1.0), old_keys=st.integers(0, 120))
def test_update_step_halves_match_jax(seed, nk, shift, fill, boundary,
                                      old_keys):
    """mesh_route + exchange + join_sort + mesh_merge + mesh_remap +
    bin_update (plain versions) equal the JAX ``_update_step`` on the
    same global state and rows: keys, planes and overflow counters,
    including keys cut at C (a shard's table overfilled) and the
    boundary hashes of both route rules."""
    kinds = ("count", "sum", "min", "max")
    C, B, N = 64, 8, 256
    r = np.random.default_rng(seed)
    # old state: each shard's table sorted, its keys its own range's
    pool = _keys(seed, 4 * old_keys + 4, nk, boundary)
    dest = destinations(torch.tensor(pool.view(np.int64)), nk, RULE_MESH,
                        shift).numpy()
    keys = np.full(nk * C, np.uint64(U64_MAX), np.uint64)
    bins = np.empty((len(kinds), nk * C, B))
    for j, k in enumerate(kinds):
        bins[j] = {"count": 0.0, "sum": 0.0, "min": np.finfo(np.float64).max,
                   "max": -np.finfo(np.float64).max}[k]
    counts = np.zeros((nk * C, B), np.int32)
    for s in range(nk):
        mine = np.unique(pool[dest == s])[:min(old_keys, C)]
        keys[s * C:s * C + len(mine)] = mine
        bins[:, s * C:s * C + len(mine)] = r.integers(1, 50, (
            len(kinds), len(mine), B))
        counts[s * C:s * C + len(mine)] = r.integers(1, 9, (len(mine), B))
    of = np.zeros((nk, 2), np.int32)
    m = int(fill * nk * N)
    new = _keys(seed + 1, m, nk, boundary)
    mix = np.concatenate([pool, new])
    kh = mix[r.integers(0, len(mix), m)]
    rows = np.zeros((4 + len(kinds), nk * N), np.int64)
    rows[0] = -1
    rows[0, :m] = kh.view(np.int64)
    rows[1, :m] = 1
    rel = r.integers(0, B, m).astype(np.int32)
    rows[2, :m] = rel
    rc = r.integers(1, 5, m).astype(np.float64)
    vals = r.integers(-20, 20, (len(kinds), m)).astype(np.float64)
    vals[0] = rc
    rows[3, :m] = rc.view(np.int64)
    rows[4:, :m] = vals.view(np.int64)

    step = jmw._update_step(kinds, nk, C, B, N, shift)
    kp = np.full(nk * N, np.uint64(U64_MAX), np.uint64)
    kp[:m] = kh
    rp = np.zeros(nk * N, np.int32)
    rp[:m] = rel
    vp = np.zeros((len(kinds) + 1, nk * N))
    vp[0, :m] = rc
    vp[1:, :m] = vals
    okp = np.zeros(nk * N, bool)
    okp[:m] = True
    jk, jb, jc, jo = (np.asarray(x) for x in step(
        keys, bins, counts, of, kp, rp, vp, okp))
    pk, pb, pc, po = _port_update(keys, bins, counts, of.astype(np.int64),
                                  rows, nk, C, B, N, shift, kinds)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(po, jo)


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**32 - 1), nk=st.sampled_from([2, 4]),
       shift=st.integers(1, 16))
def test_roll_matches_jax_roll_step(seed, nk, shift):
    """mesh_remap with no row map equals the JAX ``_roll_step`` shard by
    shard (the columns shifted left, the tail the identities; a shift of
    B clears every column)."""
    kinds = ("count", "sum", "min", "max")
    C, B = 64, 16
    rng = np.random.default_rng(seed)
    bins = rng.normal(size=(len(kinds), nk * C, B))
    counts = rng.integers(0, 9, (nk * C, B)).astype(np.int32)
    jb, jc = (np.asarray(x) for x in jmw._roll_step(kinds, nk, C, B)(
        bins, counts, np.int32(shift)))
    for s in range(nk):
        v, c = mesh_remap_reference(
            torch.tensor(bins[:, s * C:(s + 1) * C]),
            torch.tensor(counts[s * C:(s + 1) * C]), None, shift, C, B,
            kinds)
        np.testing.assert_array_equal(v.numpy(), jb[:, s * C:(s + 1) * C])
        np.testing.assert_array_equal(c.numpy(), jc[s * C:(s + 1) * C])


# -- the engine ---------------------------------------------------------------------


def test_make_bin_state_selects_mesh(monkeypatch):
    monkeypatch.setenv("ARROYO_MESH", "auto")
    assert isinstance(make_bin_state(_aggs(), SEC, 2 * SEC, device="cpu"),
                      KeyedBinState)  # one visible CPU device
    st_ = make_bin_state(_aggs(), SEC, 2 * SEC, mesh=("cpu",) * 8)
    assert isinstance(st_, MeshKeyedBinState) and st_.nk == 8
    assert mesh_key_shards([CPU] * 6) == 4
    monkeypatch.setenv("ARROYO_MESH", "2")
    assert make_bin_state(_aggs(), SEC, 2 * SEC, mesh=("cpu",) * 8).nk == 2
    monkeypatch.setenv("ARROYO_MESH", "off")
    assert isinstance(make_bin_state(_aggs(), SEC, 2 * SEC,
                                     mesh=("cpu",) * 8), KeyedBinState)
    # long windows keep the single-device ring fire, as in the JAX package
    monkeypatch.setenv("ARROYO_MESH", "auto")
    assert isinstance(make_bin_state(_aggs(), SEC, 300 * SEC,
                                     mesh=("cpu",) * 8), KeyedBinState)


@pytest.mark.parametrize("par,shift", [(1, 0), (2, 1), (4, 2)])
def test_binagg_sets_route_shift_at_parallelism(par, shift):
    """BinAggOperator sets the route shift from its parallelism before
    its table registers; on the mesh the argmax pre-filter is not set (the
    mesh state fires dense panes)."""
    from arroyo_tpu_torch.engine.context import Collector, Context, OutQueue
    from arroyo_tpu_torch.engine.operators_window import BinAggOperator
    from arroyo_tpu_torch.state.backend import InMemoryBackend
    from arroyo_tpu_torch.state.store import StateStore
    from arroyo_tpu_torch.types import TaskInfo

    async def scenario():
        ti = TaskInfo("job", "agg-0", "agg", par - 1, par)
        ctx = Context(ti, Collector([[OutQueue(asyncio.Queue())]]), 1,
                      state_store=StateStore(ti, InMemoryBackend()))
        op = BinAggOperator("agg", 2 * SEC, SEC,
                            (AggSpec(AggKind.COUNT, None, "cnt"),),
                            argmax_local=("cnt", "max"), device="cpu",
                            mesh=("cpu",) * 4)
        await op.on_start(ctx)
        return op.state

    state = asyncio.run(scenario())
    assert isinstance(state, MeshKeyedBinState)
    assert state.route_shift == shift


Q5_SHAPE = """
WITH bids as (SELECT k as auction, ts_col as datetime FROM events)
SELECT B1.auction, HOP(INTERVAL '1' SECOND, INTERVAL '2' SECOND)
       as window, count(*) AS num
FROM bids B1 GROUP BY 1, 2
"""


def _events(seed=11, n=3000, keys=25, span_s=5):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, span_s * SEC, n)).astype(np.int64)
    return ts, rng.integers(0, keys, n).astype(np.int64)


def _run_port_sql(text, device, ts, k):
    from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
    from arroyo_tpu_torch.engine.engine import LocalRunner
    from arroyo_tpu_torch.sql import SchemaProvider, plan_sql
    from arroyo_tpu_torch.types import Batch

    p = SchemaProvider()
    p.add_memory_table("events", {"k": "i", "ts_col": "t"},
                       [Batch(ts, {"k": k, "ts_col": ts.copy()})])
    clear_sink("mesh-results")
    runner = LocalRunner(plan_sql(
        "CREATE TABLE out WITH (connector='memory', name='mesh-results');"
        "INSERT INTO out " + text, p), device=device)
    runner.run()
    states = [type(op.state).__name__
              for op, _c in runner.engine.members.values()
              if hasattr(op, "state")]
    out = sink_output("mesh-results")
    cols = sorted(out[0].columns) if out else []
    rows = sorted(tuple(int(b.columns[c][i]) if c != "avg_v"
                        else float(b.columns[c][i]) for c in cols)
                  for b in out for i in range(len(b)))
    return rows, states


def test_sql_q5_mesh_matches_single_device():
    """The q5-shaped SQL through plan_sql -> LocalRunner on 2, 4 and 8
    logical CPU shards: the rows of one device and of the JAX package's
    run (on its 8-device mesh)."""
    from arroyo_tpu.connectors.memory import clear_sink, sink_output
    from arroyo_tpu.engine.engine import LocalRunner as JaxRunner
    from arroyo_tpu.sql import SchemaProvider, plan_sql
    from arroyo_tpu.types import Batch

    ts, k = _events()
    single, states = _run_port_sql(Q5_SHAPE, "cpu", ts, k)
    assert states == ["KeyedBinState"] and single
    for nk in (2, 4, 8):
        rows, states = _run_port_sql(Q5_SHAPE, ("cpu",) * nk, ts, k)
        assert states == ["MeshKeyedBinState"]
        assert rows == single, nk
    p = SchemaProvider()
    p.add_memory_table("events", {"k": "i", "ts_col": "t"},
                       [Batch(ts, {"k": k, "ts_col": ts.copy()})])
    clear_sink("results")
    JaxRunner(plan_sql(
        "CREATE TABLE out WITH (connector='memory', name='results');"
        "INSERT INTO out " + Q5_SHAPE, p)).run()
    out = sink_output("results")
    cols = sorted(out[0].columns)
    jax_rows = sorted(tuple(int(b.columns[c][i]) for c in cols)
                      for b in out for i in range(len(b)))
    assert jax_rows == single


FACTORED = """
SELECT k, HOP(INTERVAL '1' SECOND, INTERVAL '{w}' SECOND) as window,
       count(*) AS n, sum(ts_col) AS s
FROM events GROUP BY 1, 2
"""


def test_factored_plan_on_the_mesh_matches_single_device():
    """Two HOP windows sharing a 1 s pane (the factor-window rewrite: a
    shared pane ring and two derived rings, all mesh states on 4 logical
    shards) emit the rows of one device."""
    text = ("SELECT * FROM (" + FACTORED.format(w=2) + ") UNION ALL "
            "SELECT * FROM (" + FACTORED.format(w=4) + ")")
    ts, k = _events(seed=5, n=4000, keys=30, span_s=8)
    try:
        single, s_states = _run_port_sql(text, "cpu", ts, k)
    except Exception as e:  # the union of two windows must plan
        pytest.fail(f"plan failed: {e}")
    mesh, m_states = _run_port_sql(text, ("cpu",) * 4, ts, k)
    assert mesh == single and single
    assert set(m_states) == {"MeshKeyedBinState"}


@pytest.mark.parametrize("first,second", [
    (("cpu",) * 4, "cpu"), ("cpu", ("cpu",) * 2), (("cpu",) * 4,
                                                   ("cpu",) * 2)])
def test_mesh_checkpoint_interchange_engine_roundtrip(first, second):
    """q5 (20,000 events/s, so panes fire all along) checkpointed and
    stopped at its 6th batch on one topology, restored from that epoch on
    another: the two runs' rows together are the straight run's, each
    once."""
    from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
    from arroyo_tpu_torch.engine.drills import hold_sources
    from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
    from arroyo_tpu_torch.q5 import q5_program

    def program():
        return q5_program(200_000, 16_384, "mesh-rt", event_rate=20_000.0,
                          base_time_micros=0)

    def rows():
        return sorted((int(b.timestamp[i]), int(b.columns["auction"][i]),
                       int(b.columns["num"][i]))
                      for b in sink_output("mesh-rt") for i in range(len(b)))

    clear_sink("mesh-rt")
    LocalRunner(program(), device="cpu").run()
    straight = rows()
    job = f"mesh-rt-{first}-{second}"

    async def cut():
        engine = Engine.for_local(program(), job, device=first)
        running = engine.start()
        held, = hold_sources(engine, (6,))
        await held.wait()
        await running.checkpoint(1, then_stop=True)
        await running.join()

    clear_sink("mesh-rt")
    asyncio.run(cut())
    before = rows()
    clear_sink("mesh-rt")
    LocalRunner(program(), job_id=job, device=second, restore_epoch=1).run()
    after = rows()
    every = before + after
    assert before and after
    assert sorted(every) == straight and len(set(every)) == len(every)
