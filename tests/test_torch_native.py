"""The port's host library (``arroyo_tpu_torch.native``) against its numpy
versions and against the JAX package's library, on the CPU:

* every binding — ``hash_u64``, ``hash_combine``, ``partition_route``,
  ``assign_bins`` (negative timestamps, all rows dead), ``NativeDir``
  against the sorted directory and a first-seen model, ``agg_cells``
  against ``preaggregate`` — bit for bit (the cases of
  tests/test_native.py, merged as parametrised cases);
* a first build started by two processes at once;
* with both packages forced to their numpy versions: key hashes, the
  keyed-bin state's fires and snapshots, and q5's rows planned from SQL,
  still equal between the packages;
* the two paths of one package: snapshots holding the same keys and
  cells, slot order aside."""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import arroyo_tpu.native as jax_native
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.graph.logical import AggKind as JAggKind
from arroyo_tpu.graph.logical import AggSpec as JAggSpec
from arroyo_tpu.ops.keyed_bins import KeyedBinState as JaxState
from arroyo_tpu.sql import plan_sql as jax_plan_sql
from arroyo_tpu_torch import native, queries
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec
from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState as PortState
from arroyo_tpu_torch.ops.keyed_bins import directory_insert, preaggregate
from arroyo_tpu_torch.sql import plan_sql
from arroyo_tpu_torch.types import (_py_hash_u64, hash_columns,
                                    server_for_hash_array)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def port_numpy(monkeypatch):
    """The port's bindings on their numpy versions."""
    monkeypatch.setattr(native, "_lib", None)


@pytest.fixture
def numpy_paths(port_numpy, monkeypatch):
    """Both packages on their numpy versions, the JAX one on one device."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "HAVE_NATIVE", False)
    monkeypatch.setenv("ARROYO_MESH", "off")


def test_library_builds_and_loads():
    """The image has g++, so the library builds into the repository's
    build/arroyo_tpu_torch/ from the port's own copy of the source."""
    assert native.HAVE_NATIVE
    path = Path(native.LIBRARY)
    assert path.parent == REPO / "build" / "arroyo_tpu_torch"
    assert path.name.startswith("libarroyo_host-") and path.exists()
    assert native.SOURCE == REPO / "arroyo_tpu_torch" / "native" / \
        "host_ops.cpp"


# -- every binding: port library, port numpy, JAX library ---------------------


def _keys(rng, n):
    x = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    x[:5] = [0, 1, 2**64 - 1, 2**63, 12345]
    return x


def _hash_u64(mod, rng):
    x = _keys(rng, 50_000)
    return [mod.hash_u64(x), mod.hash_u64(x.astype(np.int64))]


def _hash_combine(mod, rng):
    a, h = _keys(rng, 30_000), _keys(rng, 30_000)
    return [mod.hash_combine(a, h), a]  # a untouched


def _route(n_parts):
    def run(mod, rng):
        kh = _keys(rng, 20_000)
        dest, order, bounds = mod.partition_route(kh, n_parts)
        np.testing.assert_array_equal(
            dest, server_for_hash_array(kh, n_parts).astype(np.int32))
        for p in range(n_parts):  # stable within each destination
            seg = order[bounds[p]:bounds[p + 1]]
            assert (dest[seg] == p).all() and (np.diff(seg) > 0).all()
        assert bounds[0] == 0 and bounds[-1] == len(kh)
        return [dest, order, bounds]
    return run


def _bins(ts, slide, ring, thr):
    def run(mod, _rng):
        bins, live, n_live, lo, hi = mod.assign_bins(ts, slide, ring, thr)
        abs_bins = ts // slide  # numpy floors
        want = abs_bins >= (-(2**63) if thr is None else thr)
        np.testing.assert_array_equal(live, want)
        np.testing.assert_array_equal(bins,
                                      (abs_bins % ring).astype(np.int32))
        assert n_live == int(want.sum())
        if n_live:
            assert (lo, hi) == (int(abs_bins[want].min()),
                                int(abs_bins[want].max()))
        else:
            assert lo is None and hi is None
        return [bins, live.astype(bool), np.array([n_live])]
    return run


BINDINGS = {
    "hash_u64": _hash_u64,
    "hash_combine": _hash_combine,
    "partition_route_1": _route(1),
    "partition_route_3": _route(3),
    "partition_route_16": _route(16),
    "assign_bins": _bins(np.random.default_rng(3).integers(
        0, 10**9, 30_000).astype(np.int64), 1_000_000, 16, 250),
    "assign_bins_negative_ts": _bins(np.array(
        [-1, -1_000_000, -1_500_000, 0, 999_999, -(2**40)], dtype=np.int64),
        1_000_000, 8, None),
    "assign_bins_all_dead": _bins(np.arange(5, dtype=np.int64), 1, 8, 100),
}


@pytest.mark.parametrize("name", sorted(BINDINGS))
def test_binding_matches_numpy_and_jax(name, monkeypatch):
    """The port's library, its numpy version and (where it loaded) the
    JAX package's library give the same arrays, bit for bit."""
    fn = BINDINGS[name]
    got = fn(native, np.random.default_rng(42))
    jax_got = (fn(jax_native, np.random.default_rng(42))
               if jax_native.HAVE_NATIVE else got)
    monkeypatch.setattr(native, "_lib", None)
    want = fn(native, np.random.default_rng(42))
    for g, j, w in zip(got, jax_got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)


def test_hash_u64_matches_splitmix_reference():
    x = _keys(np.random.default_rng(5), 10_000)
    np.testing.assert_array_equal(native.hash_u64(x), _py_hash_u64(x))
    assert native.hash_u64(np.uint64(7)) == _py_hash_u64(np.uint64(7))
    grid = x[:600].reshape(20, 30)
    np.testing.assert_array_equal(native.hash_u64(grid), _py_hash_u64(grid))


def test_native_dir_matches_first_seen_model_and_jax():
    """Slots, new-key order and lookups across table growth equal a
    first-seen dict model and the JAX package's NativeDir."""
    rng = np.random.default_rng(42)
    d = native.NativeDir(16)
    jd = jax_native.NativeDir.create(16)
    seen, next_slot = {}, 0
    for _ in range(5):
        kh = _keys(rng, 3_000)[rng.integers(0, 1_000, 3_000)]
        slots, new_keys = d.insert(kh, next_slot)
        expect_new = []
        expect_slots = []
        for k in kh.tolist():
            if k not in seen:
                seen[k] = next_slot + len(expect_new)
                expect_new.append(k)
            expect_slots.append(seen[k])
        next_slot += len(expect_new)
        assert new_keys.tolist() == expect_new
        assert slots.tolist() == expect_slots
        if jd is not None:
            js, jn = jd.insert(kh, next_slot - len(expect_new))
            np.testing.assert_array_equal(js, slots)
            np.testing.assert_array_equal(jn, new_keys)
    probe = np.array(list(seen)[:100] + [1, 2, 3], dtype=np.uint64)
    want = np.array([seen.get(int(k), -1) for k in probe], dtype=np.int64)
    np.testing.assert_array_equal(d.lookup(probe), want)
    loaded = native.NativeDir(8)
    loaded.load(np.array(list(seen), dtype=np.uint64),
                np.array(list(seen.values()), dtype=np.int64))
    np.testing.assert_array_equal(loaded.lookup(probe), want)


def _dir_state(cap):
    from types import SimpleNamespace

    st = SimpleNamespace(key_sorted=np.zeros(0, np.uint64),
                         slot_of_sorted=np.zeros(0, np.int64), next_slot=0,
                         slot_to_key=np.zeros(cap, np.uint64))

    def ensure(total, _new):
        if total > len(st.slot_to_key):
            st.slot_to_key = np.concatenate(
                [st.slot_to_key, np.zeros(total, np.uint64)])
    return st, ensure


def test_directory_insert_paths_hold_one_directory():
    """``directory_insert`` through NativeDir (first-seen slots) and
    through the sorted arrays (ascending-hash slots): the same key set,
    sorted arrays that map every key to the slot each path returned, and
    each path's slots equal to its model."""
    rng = np.random.default_rng(8)
    nat, ensure_n = _dir_state(64)
    nat._ndir = native.NativeDir.create(64)
    srt, ensure_s = _dir_state(64)
    for _ in range(6):
        kh = _keys(rng, 4_000)[rng.integers(0, 1_500, 4_000)]
        before = set(nat.key_sorted.tolist())
        got_n = directory_insert(nat, kh, ensure_n)
        got_s = directory_insert(srt, kh, ensure_s)
        new = [k for k in dict.fromkeys(kh.tolist()) if k not in before]
        np.testing.assert_array_equal(
            nat.slot_to_key[nat.next_slot - len(new):nat.next_slot],
            np.array(new, dtype=np.uint64))
        for st, got in ((nat, got_n), (srt, got_s)):
            assert (np.diff(st.key_sorted.astype(object)) > 0).all()
            idx = np.searchsorted(st.key_sorted, kh)
            np.testing.assert_array_equal(st.slot_of_sorted[idx], got)
            np.testing.assert_array_equal(st.slot_to_key[got], kh)
    np.testing.assert_array_equal(nat.key_sorted, srt.key_sorted)


def test_agg_cells_matches_preaggregate_and_jax():
    """The library's one-pass cell reduction is ``preaggregate`` in
    first-appearance order, for every channel kind, live rows only; the
    JAX package's library gives the same cells in the same order."""
    rng = np.random.default_rng(42)
    n, ring = 4_000, 16
    slots = rng.integers(0, 200, n).astype(np.int64)
    bins = rng.integers(0, ring, n).astype(np.int32)
    kinds = ("sum", "min", "max", "count")
    vals = rng.random((len(kinds), n))
    live = rng.random(n) < 0.8
    got = native.agg_cells(slots, bins, live, ring, vals, kinds)
    if jax_native.HAVE_NATIVE:
        want = jax_native.agg_cells(slots, bins, live, ring, vals, kinds)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    idx = live.nonzero()[0]
    ref = preaggregate(slots[idx], bins[idx], kinds, vals[:, idx])
    cs, cb = got[0], got[1]
    first = {}
    for s, b in zip(slots[idx].tolist(), bins[idx].tolist()):
        first.setdefault((s, b), len(first))
    assert list(zip(cs.tolist(), cb.tolist())) == list(first)
    order = np.lexsort((cb, cs))
    for g, r in zip(got, ref):
        g = g[..., order]
        np.testing.assert_allclose(g, r, rtol=1e-12)


def test_agg_cells_needs_the_library(port_numpy):
    """Switching ``_lib`` off is the whole switch: ``HAVE_NATIVE`` reads
    it, and ``agg_cells`` refuses to run without the library."""
    assert native.HAVE_NATIVE is False
    with pytest.raises(RuntimeError, match="host library"):
        native.agg_cells(np.zeros(3, np.int64), np.zeros(3, np.int32), None,
                         8, np.zeros((1, 3)), ("sum",))


def test_first_build_in_two_processes(tmp_path):
    """Two interpreters that find no library build it at once into one
    directory: the lock lets one compile, both return the same file, it
    loads with the right ABI, and no temporary file is left."""
    code = (
        "import ctypes, sys, time\n"
        "from pathlib import Path\n"
        "import arroyo_tpu_torch.native as n\n"
        "n.BUILD_DIR = Path(sys.argv[1])\n"
        "while time.time() < float(sys.argv[2]):\n"
        "    time.sleep(0.001)\n"
        "p = n._build()\n"
        "assert n._abi_ok(ctypes.CDLL(str(p)))\n"
        "print(p)\n")
    import time

    start = str(time.time() + 3.0)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path), start], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    so = [f.name for f in tmp_path.iterdir() if f.suffix == ".so"]
    assert so == [Path(paths.pop()).name]
    assert ctypes.CDLL(str(tmp_path / so[0])).arroyo_abi_version() == 2


def test_arroyo_native_0_forces_the_numpy_versions():
    code = ("import arroyo_tpu_torch.native as n, numpy as np\n"
            "from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState\n"
            "from arroyo_tpu_torch.graph.logical import AggKind, AggSpec\n"
            "st = KeyedBinState((AggSpec(AggKind.COUNT, None, 'n'),), 10, 10,"
            " device='cpu')\n"
            "print(n.HAVE_NATIVE, n.LIBRARY, st._ndir)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ARROYO_NATIVE"] = "0"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "None", "None"]


# -- both packages on their numpy versions ------------------------------------


SLIDE, WIDTH = 1_000, 3_000
AGGS = [("count", None, "n"), ("sum", "price", "total"),
        ("min", "price", "lo"), ("max", "price", "hi")]


def _stream(seed, n_batches=8):
    rng = np.random.default_rng(seed)
    now, out = 20_000, []
    for i in range(n_batches):
        n = int(rng.integers(50, 300))
        keys = rng.integers(0, 20 + 12 * i, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        ts = now + rng.integers(-2_500, 1_500, n)
        out.append((keys, ts.astype(np.int64), rng.normal(50, 20, n),
                    now - 3_000))
        now += int(rng.integers(500, 2_500))
    return out


def _states():
    j = JaxState(tuple(JAggSpec(JAggKind(k), c, o) for k, c, o in AGGS),
                 SLIDE, WIDTH, capacity=8)
    p = PortState(tuple(AggSpec(AggKind(k), c, o) for k, c, o in AGGS),
                  SLIDE, WIDTH, capacity=8, device="cpu")
    return j, p


def _run(state, batches):
    fires = []
    for keys, ts, price, wm in batches:
        state.update(keys, ts, {"price": price})
        fires.append(state.fire_panes(wm))
    return fires, state.snapshot()


def _assert_fires(a, b):
    for fa, fb in zip(a, b):
        if fa is None or fb is None:
            assert fa is None and fb is None
            continue
        for x, y in zip((fa[0], fa[2], fa[3]), (fb[0], fb[2], fb[3])):
            np.testing.assert_array_equal(x, y)
        for name in fa[1]:
            np.testing.assert_allclose(fa[1][name], fb[1][name], rtol=1e-12)


def test_numpy_paths_keyed_state_matches_jax(numpy_paths):
    """Both packages on numpy: no hash directory, fires in the same order
    and byte-equal canonical snapshots (slots in ascending hash order)."""
    j, p = _states()
    assert p._ndir is None and j._ndir is None
    batches = _stream(4)
    fj, sj = _run(j, batches)
    fp, sp = _run(p, batches)
    _assert_fires(fj, fp)
    assert sj.keys() == sp.keys()
    for k in sj:
        np.testing.assert_array_equal(np.asarray(sj[k]), sp[k], err_msg=k)
    keys = sp["slot_to_key"]
    assert (np.diff(keys[:len(np.unique(keys))].astype(object)) != 0).all()


def test_numpy_paths_hash_columns_match_jax(numpy_paths):
    from arroyo_tpu.types import hash_columns as jax_hash_columns

    rng = np.random.default_rng(6)
    cols = [rng.integers(-1000, 1000, 5_000), rng.normal(size=5_000),
            rng.integers(0, 9, 5_000).astype(np.int32)]
    np.testing.assert_array_equal(hash_columns(cols), jax_hash_columns(cols))


def test_snapshots_of_the_two_paths_hold_the_same_cells(monkeypatch):
    """The library path (first-seen slots) and the numpy path (hash-order
    slots) of the port: fires with the same (key, pane) rows and the same
    cells in snapshots taken by key; each snapshot restores into a state
    of the other path and fires on the same."""
    batches = _stream(9)
    nat = _states()[1]
    f_nat, s_nat = _run(nat, batches[:5])
    monkeypatch.setattr(native, "_lib", None)
    num = _states()[1]
    f_num, s_num = _run(num, batches[:5])

    def by_key(fires):
        """Each fire's (key, window end, count) rows sorted, with the
        channel values in that order (sums may round differently: the
        cells reach the planes in another order)."""
        out = []
        for fire in fires:
            if fire is None:
                out.append(None)
                continue
            keys, cols, ends, counts = fire
            order = np.lexsort((ends, keys))
            out.append((np.stack([keys.astype(np.int64), ends,
                                  counts])[:, order],
                        np.stack([cols[c] for c in sorted(cols)])[:, order]))
        return out

    def assert_same(a, b):
        assert len(a) == len(b)
        for x, y in zip(by_key(a), by_key(b)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x[0], y[0])
                np.testing.assert_allclose(x[1], y[1], rtol=1e-12)

    assert_same(f_nat, f_num)

    def cells(s):
        order = np.argsort(s["bin_keys"])
        return (s["bin_keys"][order], s["bin_vals"][:, order],
                s["bin_counts"][order], s["meta"], s["key_sorted"])

    for i, (a, b) in enumerate(zip(cells(s_nat), cells(s_num))):
        if i == 1:  # channel values
            np.testing.assert_allclose(a, b, rtol=1e-12)
        else:
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(s_nat["slot_to_key"], s_num["slot_to_key"])
    # cross restores: the numpy state takes the library's snapshot and the
    # library's state the numpy one (restore rebuilds NativeDir)
    into_num = _states()[1]
    into_num.restore(s_nat)
    monkeypatch.undo()
    into_nat = _states()[1]
    into_nat.restore(s_num)
    assert into_nat._ndir is not None and into_num._ndir is None
    rest = batches[5:]
    assert_same(_run(into_nat, rest)[0], _run(into_num, rest)[0])


def test_numpy_paths_q5_rows_match_jax(numpy_paths):
    """bench.py's Q5 planned and run by both packages on their numpy host
    paths (60,000 events): the same sink rows."""
    sql = queries.Q5.format(n=60_000, b=8_192).replace(
        "batch_size = '8192'", "batch_size = '8192', base_time_micros = '0'")
    jax_clear_sink("results")
    JaxLocalRunner(jax_plan_sql(sql)).run()
    want = sorted(
        (int(b.timestamp[i]), int(b.columns["auction"][i]),
         int(b.columns["num"][i]))
        for b in jax_sink_output("results") for i in range(len(b)))
    clear_sink("results")
    LocalRunner(plan_sql(sql), device="cpu").run()
    got = sorted(
        (int(b.timestamp[i]), int(b.columns["auction"][i]),
         int(b.columns["num"][i]))
        for b in sink_output("results") for i in range(len(b)))
    clear_sink("results")
    assert want and got == want
