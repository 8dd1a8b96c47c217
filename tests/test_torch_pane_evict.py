"""The dense pane fire (``pane_emit``) and the eviction (``bin_evict``) of
the port, which take a fire's geometry and the expired bins as scalars,
against the JAX package's ``_emit_kernel`` and ``_evict_kernel`` fed the
ring arrays that ``fire_geometry`` builds from the same scalars; and the
port's ``KeyedBinState`` planes, whole, against the JAX state's after
updates, fires, key-capacity growth, ring growth and a restore — the
invariant that lets ``bin_evict`` stop at the occupied slots (every cell
at a slot >= ``next_slot`` holds its identity and count 0).

On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels are held against those by tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arroyo_tpu.graph.logical import AggKind as JAggKind
from arroyo_tpu.graph.logical import AggSpec as JAggSpec
from arroyo_tpu.ops.keyed_bins import KeyedBinState as JaxState
from arroyo_tpu.ops.keyed_bins import _bucket, _emit_kernel, _evict_kernel
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec
from arroyo_tpu_torch.kernels.bin_evict import bin_evict
from arroyo_tpu_torch.kernels.bin_update import channel_identity
from arroyo_tpu_torch.kernels.pane_emit import (fire_geometry, pane_emit,
                                                pane_emit_reference,
                                                pane_views)
from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState as PortState

MIXED = ("count", "sum", "sum", "count", "min", "max", "sum", "sum")
XFER = (1, 2, 3, 4, 5, 6, 7)
B = 16

# (first_bin, lo, hi, W, k): the fire's geometry as KeyedBinState.fire_panes
# passes it — pane p's bin w is first_bin + p + w, live in [lo, hi]
GEOMETRIES = {
    "q8 W=1 k=1": (16 * 7 + 5, 16 * 7 + 5, 16 * 7 + 5, 1, 1),
    "no live bin": (16 * 7 + 5, 16 * 7 + 6, 16 * 7 + 9, 1, 1),
    "ring wrap": (16 * 1000 + 9, 16 * 1000 + 9, 16 * 1000 + 20, 5, 8),
    "evicted, negative bins": (-4, 0, 6, 5, 3),
    # the final flush: k = B + W - 1 panes, the newest B bins live
    "final flush": (16 * 3 + 2, 16 * 3 + 6, 16 * 3 + 6 + B - 1, 5, B + 5 - 1),
}


def _planes(rng, kinds, C, rows, cdt):
    """Random planes for the first ``rows`` slots (identities on a random
    quarter), each channel's identity and count 0 past them."""
    values = np.empty((len(kinds), C, B))
    for j, kind in enumerate(kinds):
        values[j] = channel_identity(kind)
        values[j, :rows] = rng.normal(size=(rows, B)) * 100
        values[j, :rows][rng.random((rows, B)) < 0.25] = channel_identity(kind)
    counts = np.zeros((C, B), dtype=cdt)
    counts[:rows] = rng.integers(0, 50, (rows, B))
    return values, counts


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("cdt", [np.int32, np.int64])
def test_pane_emit_scalar_geometry_matches_emit_kernel(geometry, cdt):
    """Counts, min and max exact; f64 pane sums at rtol 1e-12 (XLA's
    reduction over W may add in another order).  The buffer's two views
    hold the plain version's outputs."""
    first_bin, lo, hi, W, k = GEOMETRIES[geometry]
    rng = np.random.default_rng(31)
    C, c_slice = 160, 128
    values, counts = _planes(rng, MIXED, C, C, cdt)
    ring, bin_ok = fire_geometry(first_bin, lo, hi, W, k, B)
    assert ring.min() >= 0 and ring.max() < B
    jo, jc = _emit_kernel(MIXED, C, B, W, k, XFER)(
        jnp.asarray(values), jnp.asarray(counts), jnp.asarray(ring),
        jnp.asarray(bin_ok))
    tv, tc = torch.tensor(values), torch.tensor(counts)
    buf = pane_emit(tv, tc, first_bin, lo, hi, W, k, MIXED, XFER, c_slice)
    assert buf.dtype == torch.uint8
    to, tcnt = pane_views(buf, len(XFER), c_slice, k, tc.dtype)
    assert tcnt.dtype == tc.dtype and tuple(to.shape) == (len(XFER),
                                                          c_slice, k)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jc)[:c_slice])
    jo = np.asarray(jo)[:, :c_slice]
    for r, j in enumerate(XFER):
        if MIXED[j] in ("min", "max"):
            np.testing.assert_array_equal(to[r].numpy(), jo[r])
        else:
            np.testing.assert_allclose(to[r].numpy(), jo[r], rtol=1e-12,
                                       atol=1e-9)
    ro, rc = pane_emit_reference(tv, tc, first_bin, lo, hi, W, k, MIXED,
                                 XFER, c_slice)
    assert torch.equal(ro, to) and torch.equal(rc, tcnt)
    if geometry == "no live bin":
        assert not bin_ok.any() and not tcnt.any()


@pytest.mark.parametrize("first_bin,n_bins", [
    (16 * 9 + 5, 1),  # q8's one expired bin
    (16 * 9 + 14, 4),  # wraps past ring column B - 1
    (-3, 40),  # more bins than the ring: every column
])
@pytest.mark.parametrize("cdt", [np.int32, np.int64])
def test_bin_evict_occupied_rows_match_evict_kernel_whole_planes(
        first_bin, n_bins, cdt):
    """Exact, on the whole planes: the port resets the expired columns of
    the first ``rows`` slots only, the JAX kernel of all C; past ``rows``
    every cell holds its identity (KeyedBinState's invariant), so the two
    planes are equal, and the port left those rows untouched."""
    rng = np.random.default_rng(37)
    C, rows = 300, 173
    values, counts = _planes(rng, MIXED, C, rows, cdt)
    cols = np.unique((first_bin + np.arange(min(n_bins, B))) % B)
    epad = _bucket(len(cols))
    ring = np.zeros(epad, dtype=np.int32)
    ring[:len(cols)] = cols
    ok = np.zeros(epad, dtype=bool)
    ok[:len(cols)] = True
    jv, jc = _evict_kernel(MIXED, C, B)(
        jnp.asarray(values), jnp.asarray(counts), jnp.asarray(ring),
        jnp.asarray(ok))
    tv, tc = torch.tensor(values), torch.tensor(counts)
    tail_v, tail_c = tv[:, rows:].clone(), tc[rows:].clone()
    bin_evict(tv, tc, first_bin, n_bins, rows, MIXED)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert torch.equal(tv[:, rows:], tail_v) and torch.equal(tc[rows:],
                                                             tail_c)
    assert not tc[:rows][:, cols].any()


SLIDE, WIDTH = 1_000, 3_000  # W = 3 bins per window, ring B = 16
DENSE_AGGS = [("count", None, "n"), ("sum", "price", "total"),
              ("min", "price", "lo"), ("max", "price", "hi")]


def _stream(seed):
    """Batches (key hashes, timestamps, price, watermark): event time
    moving forward with jitter, a key space that outgrows capacity 64,
    and a far-future burst that outgrows the ring."""
    rng = np.random.default_rng(seed)
    now, out = 20_000, []
    for i in range(8):
        n = int(rng.integers(40, 160))
        keys = rng.integers(0, 20 + 12 * i, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        ts = now + rng.integers(-2_500, 1_500, n)
        if i == 3:
            ts[:6] += 25_000
        price = rng.normal(50, 20, n)
        out.append((keys, ts.astype(np.int64), price, now - 3_000))
        now += int(rng.integers(500, 2_500))
    return out


def _assert_planes_equal(j, p):
    assert (p.C, p.B, p.next_slot) == (j.C, j.B, j.next_slot)
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(p.values.numpy(), np.asarray(j.values))


def test_state_planes_match_jax_after_fires_growth_and_restore(monkeypatch):
    """After every fire (its evictions over the occupied slots only), a
    key-capacity growth, a ring growth and a restore, the port's whole
    ``values`` and ``counts`` planes equal the JAX state's, whose
    eviction rewrites every slot; the fires' keys and counts are equal
    too (tests/test_torch_keyed_bins.py holds every column and branch)."""
    monkeypatch.setenv("ARROYO_EMIT_COMPACT", "off")  # the dense fire

    def pair():
        return (JaxState(tuple(JAggSpec(JAggKind(k), c, o)
                               for k, c, o in DENSE_AGGS),
                         SLIDE, WIDTH, capacity=64),
                PortState(tuple(AggSpec(AggKind(k), c, o)
                                for k, c, o in DENSE_AGGS),
                          SLIDE, WIDTH, capacity=64, device="cpu"))

    j, p = pair()
    batches = _stream(seed=41)
    fired = 0
    for i, (keys, ts, price, wm) in enumerate(batches):
        if i == 5:  # restore both from the port's snapshot
            snap = p.snapshot()
            j, p = pair()
            j.restore(snap)
            p.restore(snap)
            _assert_planes_equal(j, p)
        for s in (j, p):
            s.update(keys, ts, {"price": price})
        fj, fp = j.fire_panes(wm), p.fire_panes(wm)
        assert (fj is None) == (fp is None)
        if fp is not None:
            fired += 1
            np.testing.assert_array_equal(fj[0], fp[0])
            np.testing.assert_array_equal(fj[3], fp[3])
        for s in (j, p):
            s.flush_updates()
        _assert_planes_equal(j, p)
    assert fired >= 3 and p.B > 16 and p.C > 64
    for s in (j, p):
        s.fire_panes(0, final=True)
    _assert_planes_equal(j, p)
