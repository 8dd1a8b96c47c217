"""The port's device kernels (arroyo_tpu_torch.kernels) against the JAX
package's kernels on the same numpy inputs.

On the CPU the wrappers run their plain PyTorch versions, so these tests
hold those versions against ``_update_kernel`` (XLA), the Pallas
``scatter_add_channels`` (interpret mode, as tests/test_pallas.py runs
it), the argmax fire kernels, the dense emit and evict kernels, the
join ring's merge, gather, probe, expand and fused expand-gather
kernels, the session union scan and the segment aggregate.  The CUDA
kernels themselves are held against the plain versions by
tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arroyo_tpu.ops.join import _bucket as jax_join_bucket
from arroyo_tpu.ops.join import (_expand_gather_kernel, _expand_kernel,
                                 _gather32_kernel, _merge32_kernel,
                                 _probe_kernel)
from arroyo_tpu.ops.keyed_bins import (NEG_INF as JAX_NEG_INF,
                                       POS_INF as JAX_POS_INF,
                                       _argmax_gather_kernel,
                                       _argmax_nnz_kernel, _bucket,
                                       _emit_kernel, _evict_kernel,
                                       _update_kernel)
from arroyo_tpu.ops.pallas_kernels import HAVE_PALLAS, pad_batch, scatter_add_channels
from arroyo_tpu.ops.segment import _segment_agg_kernel
from arroyo_tpu.ops.session import _union_kernel
from arroyo_tpu_torch.kernels.argmax_fire import (argmax_fire,
                                                 argmax_fire_buffer,
                                                 argmax_views)
from arroyo_tpu_torch.kernels.bin_evict import bin_evict
from arroyo_tpu_torch.kernels.bin_update import (bin_update, cell_views,
                                                  channel_plan, pack_cells)
from arroyo_tpu_torch.kernels.expand_gather import (
    expand_gather, expand_gather_buffer, expand_views)
from arroyo_tpu_torch.kernels.join_expand import (join_expand,
                                                  join_expand_buffer,
                                                  pair_views)
from arroyo_tpu_torch.kernels.join_probe import join_probe
from arroyo_tpu_torch.kernels.pane_emit import fire_geometry, pane_emit, pane_views
from arroyo_tpu_torch.kernels.ring_gather import ring_gather, ring_gather_rows
from arroyo_tpu_torch.kernels.ring_merge import SENT32_HI, SENT32_LO, ring_merge
from arroyo_tpu_torch.kernels.segment_agg import segment_agg, segment_agg_buffer
from arroyo_tpu_torch.kernels.session_union import (session_union,
                                                    session_union_buffer,
                                                    union_views)
from arroyo_tpu_torch.ops.keyed_bins import NEG_INF, POS_INF

# (channel kinds, COUNT(*) channels): q5's bare COUNT(*), and a mixed
# SUM/AVG/COUNT(col)/MIN/MAX set with validity channels beside a COUNT(*)
KIND_SETS = [
    (("count",), (0,)),
    (("count", "sum", "sum", "count", "min", "max", "sum", "sum"), (0,)),
]


def _update_fixture(rng, kinds, dup, C, B, m, dup_cells):
    n_ch = len(kinds)
    n_src = 1 + n_ch - len(dup)
    if dup_cells:
        slots = rng.integers(0, C, m)
        bins = rng.integers(0, B, m)
    else:
        cells = rng.choice(C * B, m, replace=False)
        slots, bins = cells // B, cells % B
    rowcnt = rng.integers(1, 20, m).astype(np.float64)
    rowcnt[rng.random(m) < 0.15] = 0.0  # padding rows
    packed = np.empty((n_src, m), dtype=np.float64)
    packed[0] = rowcnt
    packed[1:] = rng.normal(size=(n_src - 1, m)) * 1e3
    idx = np.stack([slots, bins]).astype(np.int32)
    values = rng.normal(size=(n_ch, C, B)) * 10
    for j, k in enumerate(kinds):  # identities on a random half
        ident = POS_INF if k == "min" else NEG_INF if k == "max" else 0.0
        values[j][rng.random((C, B)) < 0.5] = ident
    counts = rng.integers(0, 100, (C, B))
    return values, counts, idx, packed


def _cells(idx, packed):
    """The one-buffer form of (idx i32[2, m], packed f64[1 + n_xfer, m])."""
    idx, packed = np.asarray(idx), np.asarray(packed)
    return torch.tensor(pack_cells(idx[0], idx[1], packed[0], packed[1:]))


@pytest.mark.parametrize("kinds,dup", KIND_SETS)
@pytest.mark.parametrize("cdt", [np.int32, np.int64])
@pytest.mark.parametrize("dup_cells", [False, True])
def test_bin_update_plain_matches_update_kernel(kinds, dup, cdt, dup_cells):
    """(a) exact for counts/min/max; rtol 1e-12 for f64 sums, whose
    accumulation order differs once cells repeat."""
    rng = np.random.default_rng(11)
    C, B, m = 64, 16, 700
    values, counts, idx, packed = _update_fixture(rng, kinds, dup, C, B, m,
                                                  dup_cells)
    counts = counts.astype(cdt)
    jv, jc = _update_kernel(kinds, C, B, m, dup)(
        jnp.asarray(values), jnp.asarray(counts), jnp.asarray(idx),
        jnp.asarray(packed))
    tv, tc = torch.tensor(values), torch.tensor(counts)
    bin_update(tv, tc, _cells(idx, packed), channel_plan(kinds, dup))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for j, k in enumerate(kinds):
        if k in ("min", "max") or not dup_cells:
            np.testing.assert_array_equal(tv[j].numpy(), np.asarray(jv[j]))
        else:
            np.testing.assert_allclose(tv[j].numpy(), np.asarray(jv[j]),
                                       rtol=1e-12, atol=1e-9)


def test_bin_update_skips_invalid_rows_and_uses_f64_extremes():
    """Padding rows and out-of-plane slots/bins are skipped, never
    clipped into a real cell; min/max identities are the f64 extremes of
    the JAX package."""
    assert (NEG_INF, POS_INF) == (JAX_NEG_INF, JAX_POS_INF)
    C, B = 4, 8
    values = torch.full((1, C, B), POS_INF, dtype=torch.float64)
    counts = torch.zeros((C, B), dtype=torch.int32)
    idx = torch.tensor([[0, C, -1, 2, 3], [1, 0, 0, B, 2]], dtype=torch.int32)
    packed = torch.tensor([[3.0, 2.0, 2.0, 2.0, 0.4],
                           [5.0, -1.0, -1.0, -1.0, -7.0]],
                          dtype=torch.float64)
    bin_update(values, counts, _cells(idx, packed), channel_plan(("min",)))
    want = torch.zeros((C, B), dtype=torch.int32)
    want[0, 1] = 3
    assert torch.equal(counts, want)
    assert values[0, 0, 1] == 5.0
    assert int((values[0] != POS_INF).sum()) == 1


@pytest.mark.skipif(not HAVE_PALLAS, reason="no pallas")
@pytest.mark.parametrize("C,B,n,k", [(64, 16, 1000, 2), (2048, 32, 3 * 1024 + 17, 1)])
def test_bin_update_plain_matches_pallas_scatter(C, B, n, k):
    """(b) the additive channels against the Pallas MXU scatter on
    tests/test_pallas.py's fixtures, at that file's tolerance (the gap is
    the TPU path's bf16 hi/lo rounding)."""
    rng = np.random.default_rng(7 if k == 2 else 11)
    slots = rng.integers(0, C, n)
    bins = rng.integers(0, B, n)
    w = np.ones((1, n))
    if k == 2:
        w = np.stack([np.ones(n), rng.normal(size=n) * 50])
    w = w.astype(np.float32)
    s, b, wp = pad_batch(slots, bins, w)
    want = np.asarray(scatter_add_channels(s, b, wp, C, B))
    values = torch.zeros((k - 1, C, B), dtype=torch.float64)
    counts = torch.zeros((C, B), dtype=torch.int32)
    bin_update(values, counts, _cells(np.stack([s, b]), wp),
               channel_plan(("sum",) * (k - 1)))
    np.testing.assert_allclose(counts.numpy(), want[0], rtol=1e-4, atol=1e-3)
    for j in range(k - 1):
        np.testing.assert_allclose(values[j].numpy(), want[j + 1],
                                   rtol=1e-4, atol=1e-3)


# values whose MIN/MAX a single integer atomic on the f64 bits must order
# right: both signs, +/-0.0, tiny and huge magnitudes (no subnormals: XLA
# on the CPU flushes them to zero)
SIGNED = np.array([0.0, -0.0, 1.5, -1.5, 1e-300, -1e-300, 1e300, -1e300,
                   3.0, -3.0])


@pytest.mark.parametrize("cdt", [np.int32, np.int64])
@pytest.mark.parametrize("dup_cells", [False, True])
def test_bin_update_signed_minmax_bit_equal_to_update_kernel(cdt, dup_cells):
    """MIN/MAX over values of both signs and +/-0.0, in the cells and in
    the planes, beside padding rows and slots past the planes: counts and
    MIN/MAX bit for bit equal to ``_update_kernel`` (XLA orders -0.0
    below +0.0), the sum exact on unique cells, rtol 1e-12 on duplicates."""
    rng = np.random.default_rng(23)
    kinds, dup = ("count", "min", "max", "min", "max", "sum"), (0,)
    C, B, m = 64, 16, 700
    values, counts, idx, packed = _update_fixture(rng, kinds, dup, C, B, m,
                                                  dup_cells)
    packed[1:5] = rng.choice(SIGNED, (4, m))
    live = rng.random((4, C, B)) < 0.4
    values[1:5][live] = rng.choice(SIGNED, int(live.sum()))
    idx[0, :25] = C + 3  # past the planes: skipped
    counts = counts.astype(cdt)
    jv, jc = _update_kernel(kinds, C, B, m, dup)(
        jnp.asarray(values), jnp.asarray(counts), jnp.asarray(idx),
        jnp.asarray(packed))
    tv, tc = torch.tensor(values), torch.tensor(counts)
    bin_update(tv, tc, _cells(idx, packed), channel_plan(kinds, dup))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for j, k in enumerate(kinds):
        if k == "sum" and dup_cells:
            np.testing.assert_allclose(tv[j].numpy(), np.asarray(jv[j]),
                                       rtol=1e-12, atol=1e-9)
        else:
            np.testing.assert_array_equal(
                tv[j].numpy().view(np.int64),
                np.asarray(jv[j]).view(np.int64), err_msg=f"channel {j} {k}")


def test_channel_plan_and_cell_buffer():
    """The plan's masks and transferred rows, and the one cell buffer's
    views (i32 slots and bins in row 0, f64 rows after) on numpy arrays
    and tensors alike."""
    plan = channel_plan(("count", "sum", "min", "count", "max", "avg"),
                        (0, 3))
    assert plan == (6, 0b1001, 0b100, 0b10000) and plan.n_xfer == 4
    assert channel_plan(()) == (0, 0, 0, 0)
    with pytest.raises(ValueError):
        channel_plan(("median",))
    with pytest.raises(ValueError):
        channel_plan(("sum",) * 65)
    slots = np.array([4, 0, 7], dtype=np.int64)
    bins = np.array([1, 2, 3], dtype=np.int64)
    rows = np.array([[2.0, 1.0, 9.0], [-0.0, 0.5, -7.25]])
    buf = pack_cells(slots, bins, rows[0], rows[1:])
    assert buf.dtype == np.int64 and buf.shape == (3, 3)
    for views in (cell_views(buf), cell_views(torch.tensor(buf))):
        got = [np.asarray(v) for v in views]
        np.testing.assert_array_equal(got[0], slots)
        np.testing.assert_array_equal(got[1], bins)
        np.testing.assert_array_equal(got[2].view(np.int64),
                                      rows.view(np.int64))


def _argmax_fixture(rng, C, B, W, kpad, cdt):
    counts = rng.poisson(0.8, (C, B)).astype(cdt)
    ring = rng.integers(0, B, (kpad, W)).astype(np.int32)
    bin_ok = rng.random((kpad, W)) < 0.8
    bin_ok[kpad // 2:] = False  # padded panes of a partial fire
    return counts, ring, bin_ok


@pytest.mark.parametrize("kpad", [1, 4, 8])
@pytest.mark.parametrize("minmax", ["max", "min"])
@pytest.mark.parametrize("cdt", [np.int32, np.int64])
def test_argmax_fire_plain_matches_jax(kpad, minmax, cdt):
    """(c) exact, including the row-major output order."""
    rng = np.random.default_rng(5)
    C, B, W = 300, 16, 5
    counts, ring, bin_ok = _argmax_fixture(rng, C, B, W, kpad, cdt)
    cnt, sel, nnz = _argmax_nnz_kernel(C, B, W, kpad, minmax)(
        jnp.asarray(counts), jnp.asarray(ring), jnp.asarray(bin_ok))
    nnz = int(nnz)
    idx2, got_cnt = argmax_fire(torch.tensor(counts), torch.tensor(ring),
                                torch.tensor(bin_ok), minmax)
    assert idx2.shape == (2, nnz)
    if nnz:
        jidx, jcnt = _argmax_gather_kernel(C, B, W, kpad, _bucket(nnz))(cnt,
                                                                       sel)
        np.testing.assert_array_equal(idx2.numpy(), np.asarray(jidx)[:, :nnz])
        np.testing.assert_array_equal(got_cnt.numpy(),
                                      np.asarray(jcnt)[:nnz])


def _argmax_buffer_case(rng, case, cdt):
    """(counts, ring, bin_ok, rows, capacity) of a fire whose slots past
    ``rows`` hold zeros (a state's unoccupied slots): panes with every
    bin live, padded panes and a middle pane with no live bin, no
    candidate at all, ties past the capacity, 2,048 panes, or a final
    fire of a 120-bin window (122 panes, the last ones short of bins)."""
    C, B, W = 300, 16, 5
    kpad = {"ragged_rows": 4, "padded_panes": 8, "no_candidate": 2,
            "overflow": 4, "panes_2048": 2048, "final_w120": 128}[case]
    if case == "final_w120":
        B, W = 128, 120
    counts = rng.poisson(0.8, (C, B)).astype(cdt)
    ring = ((np.arange(kpad)[:, None] + np.arange(W)[None, :] + 7)
            % B).astype(np.int32)
    bin_ok = np.ones((kpad, W), dtype=bool)
    bin_ok[0, :2] = False
    if case == "final_w120":
        # pane p holds bins p .. p + 119 of a stream whose last bin is 124
        bin_ok = (np.arange(kpad)[:, None] + np.arange(W)[None, :]) <= 124
        bin_ok[122:] = False
    if case == "padded_panes":
        bin_ok[5:] = False  # kpad pads k = 5 panes
        bin_ok[2] = False  # a pane with no live bin
    if case == "no_candidate":
        counts[:] = 0
    if case == "overflow":
        counts = np.minimum(counts, 1)  # ties by the dozen
    rows = 211
    counts[rows:] = 0
    return counts, ring, bin_ok, rows, (5 if case == "overflow" else 64)


@pytest.mark.parametrize("case", ["ragged_rows", "padded_panes",
                                  "no_candidate", "overflow", "panes_2048",
                                  "final_w120"])
@pytest.mark.parametrize("minmax", ["max", "min"])
@pytest.mark.parametrize("cdt", [np.int32, np.int64])
def test_argmax_fire_buffer_plain_matches_jax(case, minmax, cdt):
    """The buffer form over the occupied rows only equals the JAX kernels
    over all C slots: word 0 the whole candidate total, then the first
    ``capacity`` candidates in row-major order; the tuple form equals
    them all."""
    rng = np.random.default_rng(31)
    counts, ring, bin_ok, rows, cap = _argmax_buffer_case(rng, case, cdt)
    C, B = counts.shape
    kpad, W = ring.shape
    cnt, sel, nnz = _argmax_nnz_kernel(C, B, W, kpad, minmax)(
        jnp.asarray(counts), jnp.asarray(ring), jnp.asarray(bin_ok))
    nnz = int(nnz)
    t = torch.tensor
    buf = argmax_fire_buffer(t(counts), t(ring), t(bin_ok), rows, minmax,
                             cap)
    assert buf.dtype == torch.int32 and int(buf[0]) == nnz
    key, pane, got_cnt = argmax_views(buf.numpy(), nnz, cap,
                                      torch.int64 if cdt == np.int64
                                      else torch.int32)
    idx2, tuple_cnt = argmax_fire(t(counts), t(ring), t(bin_ok), minmax)
    assert idx2.shape == (2, nnz)
    if case == "no_candidate":
        assert nnz == 0 and len(key) == 0
        return
    if case == "overflow":
        assert nnz > cap and len(key) == cap
    jidx, jcnt = _argmax_gather_kernel(C, B, W, kpad, _bucket(nnz))(cnt, sel)
    jidx, jcnt = np.asarray(jidx)[:, :nnz], np.asarray(jcnt)[:nnz]
    n = min(nnz, cap)
    np.testing.assert_array_equal(key, jidx[0, :n])
    np.testing.assert_array_equal(pane, jidx[1, :n])
    np.testing.assert_array_equal(got_cnt, jcnt[:n])
    assert got_cnt.dtype == cdt
    np.testing.assert_array_equal(idx2.numpy(), jidx)
    np.testing.assert_array_equal(tuple_cnt.numpy(), jcnt)
    if case == "padded_panes":
        assert set(np.unique(pane)) <= {0, 1, 3, 4}


def _planes(rng, kinds, C, B, cdt):
    """Bin-ring planes with data in a random half of the cells and each
    channel's identity elsewhere."""
    values = rng.normal(size=(len(kinds), C, B)) * 100
    for j, k in enumerate(kinds):
        ident = POS_INF if k == "min" else NEG_INF if k == "max" else 0.0
        values[j][rng.random((C, B)) < 0.5] = ident
    return values, rng.integers(0, 50, (C, B)).astype(cdt)


# (kinds, transferred channels): q8's bare COUNT(*) (nothing transferred,
# the counts plane is the aggregate), and every channel kind together
EMIT_SETS = [
    (("count",), ()),
    (("count", "sum", "sum", "count", "min", "max", "sum", "sum"),
     (1, 2, 3, 4, 5, 6, 7)),
]


@pytest.mark.parametrize("kinds,xfer", EMIT_SETS)
@pytest.mark.parametrize("W,k,kpad", [(1, 1, 1), (5, 3, 4), (5, 8, 8)])
@pytest.mark.parametrize("cdt", [np.int32, np.int64])
def test_pane_emit_plain_matches_emit_kernel(kinds, xfer, W, k, kpad, cdt):
    """Exact for counts, min and max; rtol 1e-12 for f64 pane sums (the
    summation order over W may differ).  The fire's geometry is scalars
    (a first bin whose panes wrap the ring, the first bin evicted when
    W > 1, the last past the newest bin when k > 1); JAX takes the ring
    arrays built from them, padded to kpad panes, over all C slots; the
    port reads the c_slice occupied slots and the k real panes, so the
    JAX result is sliced to them."""
    rng = np.random.default_rng(17)
    C, B, c_slice = 300, 16, 256
    values, counts = _planes(rng, kinds, C, B, cdt)
    first_bin = 16 * 40 + 13
    lo = first_bin + (W > 1)
    hi = first_bin + k + W - 2 - (k > 1)
    ring, bin_ok = fire_geometry(first_bin, lo, hi, W, k, B, kpad=kpad)
    jo, jc = _emit_kernel(kinds, C, B, W, kpad, tuple(xfer))(
        jnp.asarray(values), jnp.asarray(counts), jnp.asarray(ring),
        jnp.asarray(bin_ok))
    tcounts = torch.tensor(counts)
    to, tc = pane_views(pane_emit(torch.tensor(values), tcounts, first_bin,
                                  lo, hi, W, k, kinds, xfer, c_slice),
                        len(xfer), c_slice, k, tcounts.dtype)
    assert tuple(to.shape) == (len(xfer), c_slice, k)
    np.testing.assert_array_equal(tc.numpy(),
                                  np.asarray(jc)[:c_slice, :k])
    jo = np.asarray(jo)[:, :c_slice, :k]
    for r, j in enumerate(xfer):
        if kinds[j] in ("min", "max"):
            np.testing.assert_array_equal(to[r].numpy(), jo[r])
        else:
            np.testing.assert_allclose(to[r].numpy(), jo[r], rtol=1e-12,
                                       atol=1e-9)


@pytest.mark.parametrize("kinds,_xfer", EMIT_SETS)
@pytest.mark.parametrize("cdt", [np.int32, np.int64])
def test_bin_evict_plain_matches_evict_kernel(kinds, _xfer, cdt):
    """Exact: the expired columns (absolute bins 83..85, ring columns
    3..5) reset to 0 and each channel's identity over all C slots, every
    other cell untouched; JAX pads the column list to a bucket with
    invalid entries, the port takes the expired span as scalars."""
    rng = np.random.default_rng(23)
    C, B = 300, 16
    values, counts = _planes(rng, kinds, C, B, cdt)
    cols = np.array([3, 4, 5], dtype=np.int32)
    epad = _bucket(len(cols))
    ring = np.zeros(epad, dtype=np.int32)
    ring[:len(cols)] = cols
    ok = np.zeros(epad, dtype=bool)
    ok[:len(cols)] = True
    jv, jc = _evict_kernel(kinds, C, B)(
        jnp.asarray(values), jnp.asarray(counts), jnp.asarray(ring),
        jnp.asarray(ok))
    tv, tc = torch.tensor(values), torch.tensor(counts)
    bin_evict(tv, tc, 5 * B + 3, len(cols), C, kinds)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# (resident entries, delta entries, where the delta lands) in a ring of
# 1,024: join_state's merge is an insert of the sorted delta
MERGE_LAYOUTS = {"interleaved": (600, 300), "no_residents": (0, 300),
                 "no_delta": (600, 0), "before": (600, 300),
                 "after": (600, 300), "full": (700, 324)}


def _merge_fixture(rng, cap, layout, nf, ni):
    """A resident run of n_res entries in a ring of cap (sentinels past
    it), a delta of m entries and its insert positions, strictly
    increasing in [0, n_res + m) as join_state computes them; and the
    JAX kernel's inputs for the same merge: ``res_pos`` the ascending
    complement of the positions, the delta padded to a bucket, unused
    resident slots and delta padding pointing at cap or beyond (dropped,
    the JAX kernel's mode="drop")."""
    n_res, m = MERGE_LAYOUTS[layout]
    if layout == "before":
        dpos = np.arange(m)
    elif layout == "after":
        dpos = n_res + np.arange(m)
    else:
        dpos = np.sort(rng.choice(n_res + m, m, replace=False))
    keep = np.ones(n_res + m, dtype=bool)
    keep[dpos] = False
    res_pos = np.full(cap, cap, np.int64)
    res_pos[:n_res] = np.nonzero(keep)[0]
    db = _bucket(max(m, 1), floor=8)
    delta_pos = np.full(db, cap, np.int64)
    delta_pos[:m] = dpos
    delta_pos[m:m + 2] = cap + 5
    hi = np.full(cap, SENT32_HI, np.int32)
    lo = np.full(cap, SENT32_LO, np.int32)
    hi[:n_res] = rng.integers(-2**31, 2**31 - 1, n_res)
    lo[:n_res] = rng.integers(-2**31, 2**31 - 1, n_res)
    d_hi = rng.integers(-2**31, 2**31 - 1, db).astype(np.int32)
    d_lo = rng.integers(-2**31, 2**31 - 1, db).astype(np.int32)
    fs = rng.normal(size=(nf, cap))
    ist = rng.integers(-2**62, 2**62, (ni, cap))
    d_f = rng.normal(size=(nf, db))
    d_i = rng.integers(-2**62, 2**62, (ni, db))
    jax_args = (hi, lo, fs, ist, res_pos, d_hi, d_lo, d_f, d_i, delta_pos)
    port_args = (hi, lo, fs, ist, n_res, d_hi[:m], d_lo[:m], d_f[:, :m],
                 d_i[:, :m], delta_pos[:m])
    return jax_args, port_args


@pytest.mark.parametrize("layout", list(MERGE_LAYOUTS))
@pytest.mark.parametrize("nf,ni", [(0, 0), (2, 6), (0, 3)])
def test_ring_merge_plain_matches_merge32_kernel(layout, nf, ni):
    """Bit-exact, keys-only (nf = ni = 0) and with payload stacks: the
    port's merge from the delta positions and the resident count equals
    the JAX kernel's scatter with ``res_pos`` the complement — no
    residents, no delta, the delta all before or all after the residents,
    interleaved, and a ring filled to its last slot."""
    rng = np.random.default_rng(29 + len(layout) + nf)
    cap = 1024
    ja, pa = _merge_fixture(rng, cap, layout, nf, ni)
    db = len(ja[5])
    t = lambda x: torch.tensor(x) if isinstance(x, np.ndarray) else x  # noqa: E731
    if ni:
        want = _merge32_kernel(cap, db, nf, ni)(*map(jnp.asarray, ja))
        got = ring_merge(*map(t, pa))
    else:
        hi, lo, _fs, _ist, res_pos, d_hi, d_lo, _df, _di, delta_pos = ja
        want = _merge32_kernel(cap, db, 0, 0)(
            jnp.asarray(hi), jnp.asarray(lo), 0, 0, jnp.asarray(res_pos),
            jnp.asarray(d_hi), jnp.asarray(d_lo), 0, 0,
            jnp.asarray(delta_pos))
        got = ring_merge(t(pa[0]), t(pa[1]), None, None, pa[4], t(pa[5]),
                         t(pa[6]), None, None, t(pa[9]))
        assert got[2] is None and got[3] is None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("delta_pos,n_res", [
    ([1, 1], 3),  # repeated
    ([2, 1], 3),  # decreasing
    ([0, 5], 3),  # past n_res + m
    ([-1, 2], 3)])  # negative
def test_ring_merge_plain_rejects_positions_that_are_not_an_insert(
        delta_pos, n_res):
    """The plain version holds its caller to the precondition the kernel
    does not check: positions strictly increasing in [0, n_res + m)."""
    hi = torch.zeros(8, dtype=torch.int32)
    d = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="strictly"):
        ring_merge(hi, hi, None, None, n_res, d, d, None, None,
                   torch.tensor(delta_pos))


@pytest.mark.parametrize("nf,ni", [(2, 6), (0, 3)])
def test_ring_gather_plain_matches_gather32_kernel(nf, ni):
    """Bit-exact at sorted-run positions, including repeats."""
    rng = np.random.default_rng(31)
    cap, m = 1024, 700
    fs = rng.normal(size=(nf, cap))
    ist = rng.integers(-2**62, 2**62, (ni, cap))
    idx = np.sort(rng.integers(0, cap, m))
    mb = _bucket(m, floor=8)
    idx_p = np.zeros(mb, np.int64)
    idx_p[:m] = idx
    wf, wi = _gather32_kernel(cap, mb, nf, ni)(
        jnp.asarray(idx_p), jnp.asarray(fs), jnp.asarray(ist))
    gf, gi = ring_gather(torch.tensor(idx), torch.tensor(fs),
                         torch.tensor(ist))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf)[:, :m])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi)[:, :m])


@pytest.mark.parametrize("nf,ni", [(2, 6), (0, 3), (2, 0)])
def test_ring_gather_rows_stack_the_gather32_kernel_outputs(nf, ni):
    """ring_gather_rows: the f64 rows' bits over the i64 rows in one i64
    buffer, equal to the JAX kernel's two outputs."""
    rng = np.random.default_rng(37 + nf)
    cap, m = 512, 300
    fs = rng.normal(size=(nf, cap))
    ist = rng.integers(-2**62, 2**62, (ni, cap))
    idx = np.sort(rng.integers(0, cap, m))
    mb = _bucket(m, floor=8)
    idx_p = np.zeros(mb, np.int64)
    idx_p[:m] = idx
    wf, wi = _gather32_kernel(cap, mb, nf, ni)(
        jnp.asarray(idx_p), jnp.asarray(fs), jnp.asarray(ist))
    rows = ring_gather_rows(torch.tensor(idx), torch.tensor(fs),
                            torch.tensor(ist))
    assert rows.dtype == torch.int64 and tuple(rows.shape) == (nf + ni, m)
    np.testing.assert_array_equal(rows[:nf].numpy().view(np.float64),
                                  np.asarray(wf)[:, :m])
    np.testing.assert_array_equal(rows[nf:].numpy(), np.asarray(wi)[:, :m])


def test_wrappers_run_plain_versions_on_cpu_and_reject_other_devices():
    """CPU tensors take the plain version (no launch is counted); a
    tensor on any other non-CUDA device raises instead of falling back."""
    before = (bin_update.launches, argmax_fire.launches, pane_emit.launches,
              bin_evict.launches, ring_merge.launches, ring_gather.launches)
    values = torch.zeros((1, 8, 8), dtype=torch.float64)
    counts = torch.zeros((8, 8), dtype=torch.int32)
    cells = _cells([[1], [2]], [[2.0]])
    plan = channel_plan(("count",), (0,))
    bin_update(values, counts, cells, plan)
    assert counts[1, 2] == 2 and values[0, 1, 2] == 2.0
    argmax_fire(counts, torch.zeros((1, 1), dtype=torch.int32),
                torch.ones((1, 1), dtype=torch.bool), "max")
    outs, cnts = pane_views(pane_emit(values, counts, 2, 0, 2, 1, 1,
                                      ("count",), (), 8), 0, 8, 1, torch.int32)
    assert cnts[1, 0] == 2 and outs.shape == (0, 8, 1)
    bin_evict(values, counts, 2, 1, 8, ("count",))
    assert int(counts.sum()) == 0 and float(values.sum()) == 0.0
    hi = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    out_hi, _lo, _f, _i = ring_merge(hi, hi, None, None, 2, hi[3:],
                                     hi[3:], None, None, torch.tensor([1]))
    assert out_hi.tolist() == [5, 8, 6, int(SENT32_HI)]
    f = torch.arange(4, dtype=torch.float64)[None]
    gf, _gi = ring_gather(torch.tensor([3, 0]), f,
                          torch.zeros((1, 4), dtype=torch.int64))
    assert gf.tolist() == [[3.0, 0.0]]
    assert (bin_update.launches, argmax_fire.launches, pane_emit.launches,
            bin_evict.launches, ring_merge.launches,
            ring_gather.launches) == before
    meta = [t.to("meta") for t in (values, counts, cells)]
    with pytest.raises(ValueError):
        bin_update(*meta, plan)
    with pytest.raises(ValueError):
        pane_emit(meta[0], meta[1], 2, 0, 2, 1, 1, ("count",), (), 8)
    with pytest.raises(ValueError):
        bin_evict(meta[0], meta[1], 2, 1, 8, ("count",))
    with pytest.raises(ValueError):
        ring_gather(torch.tensor([0], device="meta"), f.to("meta"),
                    torch.zeros((1, 4), dtype=torch.int64, device="meta"))


def _union_fixture(rng, n, n_keys, touching):
    """Interval rows sorted by (key, start), u64 hash keys, micros times;
    ``touching`` makes a third of the starts equal the running end."""
    keys = rng.integers(0, 2**64, n_keys, dtype=np.uint64)
    kh = np.sort(rng.choice(keys, n))
    st = rng.integers(1_700_000_000_000_000, 1_700_000_000_200_000, n)
    order = np.lexsort((st, kh))
    kh, st = kh[order], st[order]
    en = st + rng.integers(1, 30_000, n)
    if touching and n > 1:
        t = np.nonzero(rng.random(n - 1) < 0.33)[0] + 1
        t = t[kh[t] == kh[t - 1]]
        st[t] = en[t - 1]  # st == the predecessor's end: must merge
        order = np.lexsort((st, kh))
        kh, st, en = kh[order], st[order], en[order]
    return kh, st, en


@pytest.mark.parametrize("n,n_keys,touching", [
    (300, 40, False),  # many keys
    (1000, 1, False),  # one key spanning the input
    (517, 9, True),  # touching intervals merge
    (1, 1, False),
    (192, 48, True),  # a config5-sized merge
    (1023, 70, False),  # one row short of the kernel's 1,024-row tile
    (1024, 70, True),  # one tile
    (1025, 70, False),  # one row into a second tile
    (3000, 1, True)])  # one key spanning three tiles
def test_session_union_plain_matches_union_kernel(n, n_keys, touching):
    """Exact new-session flags and running ends on the first n rows of
    the JAX kernel's padded scan; the buffer form's sessions (first rows,
    merged ends) equal the flags' heads and ``np.maximum.reduceat`` of
    the ends over them, as the JAX package's caller reduces."""
    rng = np.random.default_rng(n + n_keys)
    kh, st, en = _union_fixture(rng, n, n_keys, touching)
    npad = max(1 << (n - 1).bit_length(), 2)
    khp = np.zeros(npad, dtype=np.uint64)
    stp = np.full(npad, np.iinfo(np.int64).max)
    enp = np.full(npad, np.iinfo(np.int64).min)
    vp = np.zeros(npad, dtype=bool)
    khp[:n], stp[:n], enp[:n], vp[:n] = kh, st, en, True
    want_new, want_run = _union_kernel(npad)(
        jnp.asarray(khp), jnp.asarray(stp), jnp.asarray(enp),
        jnp.asarray(vp))
    new, run = session_union(torch.tensor(kh.view(np.int64)),
                             torch.tensor(st), torch.tensor(en))
    np.testing.assert_array_equal(new.numpy(), np.asarray(want_new)[:n])
    np.testing.assert_array_equal(run.numpy(), np.asarray(want_run)[:n])
    buf = session_union_buffer(torch.tensor(kh.view(np.int64)),
                               torch.tensor(st), torch.tensor(en))
    assert buf.dtype == torch.int64 and tuple(buf.shape) == (1 + 2 * n,)
    s, first, m_en = union_views(buf.numpy(), n)
    heads = np.nonzero(np.asarray(want_new)[:n])[0]
    np.testing.assert_array_equal(first, heads)
    np.testing.assert_array_equal(m_en, np.maximum.reduceat(en, heads))
    assert s == len(heads)
    if touching:
        assert new.sum() < n_keys + (n - n_keys) // 2  # merges happened


SEG_KINDS = [("sum",), ("min",), ("max",), ("count",),
             ("count", "sum", "min", "max", "sum")]


def _segment_layout(rng, layout):
    """(n, n_seg, offsets) of a test batch: ``dense`` — 900 rows over 37
    non-empty segments; ``empties`` — empty segments at the start, in the
    middle and at the end; ``none`` — no segment and no row."""
    if layout == "none":
        return 0, 0, np.zeros(1, dtype=np.int64)
    n, n_seg = 900, 37
    seg = np.sort(rng.integers(0, n_seg, n))
    seg[:n_seg] = np.arange(n_seg)  # every segment non-empty
    seg = np.sort(seg)
    if layout == "empties":  # segments 0, 1, 17 and 36 hold no row
        seg[seg == 0], seg[seg == 1] = 2, 2
        seg[seg == 17], seg[seg == 36] = 18, 35
        seg = np.sort(seg)
    return n, n_seg, np.searchsorted(seg, np.arange(n_seg + 1))


@pytest.mark.parametrize("kinds,layout", [
    *(pytest.param(k, "dense", id=f"kinds{i}")
      for i, k in enumerate(SEG_KINDS)),
    *(pytest.param(k, layout, id=f"{layout}-kinds{i}")
      for layout in ("empties", "none") for i, k in enumerate(SEG_KINDS))])
def test_segment_agg_plain_matches_segment_agg_kernel(kinds, layout):
    """Exact counts, min, max and count channels; rtol 1e-12 for sums
    (XLA's segment_sum adds in another order).  The port takes value rows
    for the channels that are not counts only.  An empty segment gets
    count 0, sum 0 and XLA's empty-segment MIN/MAX, +inf/-inf.
    ``segment_agg_buffer``'s rows (counts, then the channels as their
    bits) hold the same values."""
    rng = np.random.default_rng(len(kinds) * 7 + len(kinds[0]))
    n, n_seg, offsets = _segment_layout(rng, layout)
    seg = np.repeat(np.arange(n_seg), np.diff(offsets))
    values = rng.normal(size=(len(kinds), n)) * 1e3
    npad, spad = 1024, 64
    vals = np.zeros((len(kinds), npad))
    vals[:, :n] = values
    sid = np.zeros(npad, dtype=np.int32)
    sid[:n] = seg
    valid = np.arange(npad) < n
    want, want_counts = _segment_agg_kernel(npad, spad, kinds)(
        jnp.asarray(vals), jnp.asarray(sid), jnp.asarray(valid))
    reduced = [c for c, k in enumerate(kinds) if k != "count"]
    args = (torch.tensor(values[reduced]).reshape(len(reduced), n),
            torch.tensor(offsets), kinds)
    got, counts = segment_agg(*args)
    buf = segment_agg_buffer(*args)
    assert buf.dtype == torch.int64 and tuple(buf.shape) == (
        len(kinds) + 1, n_seg)
    for cnt, out in ((counts, got), (buf[0], buf[1:].view(torch.float64))):
        np.testing.assert_array_equal(cnt.numpy(),
                                      np.asarray(want_counts)[:n_seg])
        for c, k in enumerate(kinds):
            w = np.asarray(want)[c, :n_seg]
            if k == "sum":
                np.testing.assert_allclose(out[c].numpy(), w, rtol=1e-12)
            else:
                np.testing.assert_array_equal(out[c].numpy(), w)


def test_session_kernels_run_plain_versions_on_cpu_and_reject_others():
    """The session kernels' wrappers (both forms of session_union) count
    no launch for CPU tensors and raise for tensors on another non-CUDA
    device."""
    before = (session_union.launches, segment_agg.launches)
    kh = torch.tensor([5, 5, 5, 9])
    st = torch.tensor([0, 10, 30, 0])
    en = torch.tensor([10, 20, 40, 3])
    new, run = session_union(kh, st, en)
    assert new.tolist() == [True, False, True, True]
    assert run.tolist() == [10, 20, 40, 3]
    buf = session_union_buffer(kh, st, en)
    assert buf.tolist() == [3, 0, 2, 3, 0, 20, 40, 3, 0]
    out, cnt = segment_agg(torch.tensor([[1.0, 2.0, 4.0]],
                                        dtype=torch.float64),
                           torch.tensor([0, 2, 3]), ("sum",))
    assert out.tolist() == [[3.0, 4.0]] and cnt.tolist() == [2, 1]
    assert (session_union.launches, segment_agg.launches) == before
    with pytest.raises(ValueError):
        session_union(kh.to("meta"), st.to("meta"), en.to("meta"))
    with pytest.raises(ValueError):
        session_union_buffer(kh.to("meta"), st.to("meta"), en.to("meta"))
    with pytest.raises(ValueError):
        segment_agg(torch.zeros((1, 3), dtype=torch.float64, device="meta"),
                    torch.tensor([0, 3], device="meta"), ("sum",))
    with pytest.raises(ValueError, match="value rows"):  # count: no row
        segment_agg(torch.zeros((1, 3), dtype=torch.float64),
                    torch.tensor([0, 3]), ("count",))
    with pytest.raises(TypeError):
        session_union(kh.to(torch.int32), st, en)
    with pytest.raises(TypeError):
        session_union_buffer(kh, st.to(torch.int32), en)


def _probe_fixture(rng, case):
    """A ring (sorted ``hi`` with repeats, sentinel padding past
    ``n_valid``; random ``lo``) and sorted queries padded to ``mq``:
    ``empty`` — no query matches; ``skew`` — one query spans the whole
    full ring; ``collide`` — hi-equal candidates whose lo mostly differs;
    ``padded`` — a partly filled ring and many padding queries;
    ``past_last`` — a third of the queries above the ring's last row;
    ``at_last`` — queries equal to the last row, which ends a run of
    equal rows; ``all_padding`` — sentinel queries only; ``no_rows`` — an
    empty ring; ``tiles`` — 2,048 queries, two scan tiles."""
    cap, mq = 1024, 512
    n_valid, m = {"empty": (900, 400), "skew": (cap, 1),
                  "collide": (1000, 300), "padded": (700, 37),
                  "past_last": (800, 300), "at_last": (800, 300),
                  "all_padding": (800, 0), "no_rows": (0, 300),
                  "tiles": (1000, 1900)}[case]
    if case == "tiles":
        mq = 2048
    hi = np.full(cap, SENT32_HI, np.int32)
    lo = rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)
    q_hi = np.full(mq, SENT32_HI, np.int32)
    q_lo = np.full(mq, SENT32_LO, np.int32)
    if case == "skew":
        hi[:] = 12345
        q_hi[0] = 12345
        q_lo[0] = lo[500]
    else:
        span = 60 if case == "collide" else 2_000
        ring = np.sort(rng.integers(0, span, n_valid) * 2).astype(np.int32)
        if case == "at_last":
            ring[-40:] = ring[-41]  # the last row closes a run of 41
        hi[:n_valid] = ring
        q = rng.integers(0, span, m) * 2
        if case == "empty":
            q = q + 1  # odd: never in the ring
        elif case == "past_last":
            q[: m // 3] = rng.integers(2 * span, 3 * span, m // 3)
        elif case == "at_last":
            q[: m // 4] = ring[-1]
        order = np.argsort(q, kind="stable")
        q_hi[:m] = q[order]
        # a third of the queries copy the lo of a ring row with their hi
        pick = np.searchsorted(ring, q_hi[:m])
        own = (rng.random(m) < 0.33) & (pick < n_valid)
        q_lo[:m] = rng.integers(-2**31, 2**31 - 1, m)
        q_lo[:m][own] = lo[pick[own]]
    return hi, lo, q_hi, q_lo, m, n_valid


@pytest.mark.parametrize("case", ["empty", "skew", "collide", "padded",
                                  "past_last", "at_last", "all_padding",
                                  "no_rows", "tiles"])
def test_join_probe_expand_gather_plain_match_jax_kernels(case):
    """K9 against ``_probe_kernel`` in both its searchsorted and
    merged-rank forms — among them the inputs the CUDA kernel answers
    without a search (queries above the ring's last row or equal to it,
    padding only, an empty ring) and several scan tiles — K10 against
    ``_expand_kernel`` and K11 against ``_expand_gather_kernel``, all
    bit-exact (the JAX outputs are i32 and bucket-padded: compared
    widened, sliced to the exact pair total); the buffer forms' views at
    the total's capacity hold the same outputs under the total's header
    word."""
    rng = np.random.default_rng(61)
    hi, lo, q_hi, q_lo, m, n_valid = _probe_fixture(rng, case)
    cap, mq = len(hi), len(q_hi)
    nf, ni = 1, 3
    fs = rng.normal(size=(nf, cap))
    ist = rng.integers(-2**62, 2**62, (ni, cap))
    start, counts, cum = join_probe(torch.tensor(q_hi), torch.tensor(hi), m,
                                    n_valid)
    assert (start.dtype, counts.dtype, cum.dtype) == (
        torch.int32, torch.int32, torch.int64)
    for merged in (False, True):
        want = _probe_kernel(mq, cap, merged)(jnp.asarray(q_hi),
                                              jnp.asarray(hi), m, n_valid)
        for g, w in zip((start, counts, cum), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    total = int(cum[-1])
    assert (total == 0) == (case in ("empty", "all_padding", "no_rows"))
    assert case != "skew" or total == cap
    if case == "past_last":
        assert (start.numpy()[q_hi > hi[n_valid - 1]] == n_valid).all()
    if not total:
        lidx, ridx = join_expand(start, cum, 0)
        assert lidx.shape == ridx.shape == (0,)
        buf = expand_gather_buffer(start, cum, 0, *map(
            torch.tensor, (hi, lo, q_hi, q_lo, fs, ist)))
        assert buf.tolist() == [0]
        assert [tuple(v.shape) for v in expand_views(buf, 0, nf, ni)] == [
            (0,), (0,), (0,), (nf, 0), (ni, 0)]
        return
    mb = jax_join_bucket(total)
    jl, jr = _expand_kernel(mq, mb)(jnp.asarray(start.numpy()),
                                    jnp.asarray(cum.numpy().astype(np.int32)))
    lidx, ridx = join_expand(start, cum, total)
    np.testing.assert_array_equal(lidx.numpy(), np.asarray(jl)[:total])
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(jr)[:total])
    want = _expand_gather_kernel(mq, cap, mb, nf, ni)(
        jnp.asarray(start.numpy()), jnp.asarray(cum.numpy().astype(np.int32)),
        *map(jnp.asarray, (hi, lo, q_hi, q_lo, fs, ist)))
    got = expand_gather(start, cum, total, *map(torch.tensor,
                                                (hi, lo, q_hi, q_lo, fs,
                                                 ist)))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:total])
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, :total])
    buf = expand_gather_buffer(start, cum, total, *map(
        torch.tensor, (hi, lo, q_hi, q_lo, fs, ist)))
    assert buf.dtype == torch.int64 and buf.numel() == (
        1 + (2 + nf + ni) * total + (total + 7) // 8) and buf[0] == total
    for g, v in zip(got, expand_views(buf, total, nf, ni)):
        assert g.dtype == v.dtype and torch.equal(g, v)
    pairs = join_expand_buffer(start, cum, total)
    assert pairs.numel() == 1 + 2 * total and pairs[0] == total
    for g, v in zip((lidx, ridx), pair_views(pairs, total)):
        assert torch.equal(g, v)
    valid = got[2].numpy()
    if case == "collide":
        assert valid.any() and not valid.all()
    if case == "skew":
        assert valid.sum() == 1


def test_join_kernels_run_plain_versions_on_cpu_and_reject_others():
    """K9-K11 count no launch for CPU tensors, work with no float stack
    (join-stress has only integer columns) and raise for tensors on
    another non-CUDA device."""
    before = (join_probe.launches, join_expand.launches,
              expand_gather.launches)
    hi = torch.tensor([1, 3, 3, 7, int(SENT32_HI)], dtype=torch.int32)
    lo = torch.tensor([0, 5, 6, 0, int(SENT32_LO)], dtype=torch.int32)
    q_hi = torch.tensor([3, 7, int(SENT32_HI)], dtype=torch.int32)
    q_lo = torch.tensor([6, 1, int(SENT32_LO)], dtype=torch.int32)
    start, counts, cum = join_probe(q_hi, hi, 2, 4)
    assert (start.tolist(), counts.tolist(), cum.tolist()) == (
        [1, 3, 4], [2, 1, 0], [2, 3, 3])
    lidx, ridx = join_expand(start, cum, 3)
    assert (lidx.tolist(), ridx.tolist()) == ([0, 0, 1], [1, 2, 3])
    ist = torch.arange(10, dtype=torch.int64).reshape(2, 5)
    fst = torch.zeros((0, 5), dtype=torch.float64)
    _l, _r, valid, gf, gi = expand_gather(start, cum, 3, hi, lo, q_hi, q_lo,
                                          fst, ist)
    assert valid.tolist() == [False, True, False]
    assert gf.shape == (0, 3) and gi.tolist() == [[1, 2, 3], [6, 7, 8]]
    assert (join_probe.launches, join_expand.launches,
            expand_gather.launches) == before
    meta = [t.to("meta") for t in (hi, lo, q_hi, q_lo, start, cum)]
    with pytest.raises(ValueError):
        join_probe(meta[2], meta[0], 2, 4)
    with pytest.raises(ValueError):
        join_expand(meta[4], meta[5], 3)
    with pytest.raises(ValueError):
        expand_gather(meta[4], meta[5], 3, *meta[:4], fst.to("meta"),
                      ist.to("meta"))
    with pytest.raises(ValueError):
        join_probe(q_hi, hi, 4, 4)  # m > mq
    with pytest.raises(TypeError):
        join_probe(q_hi.long(), hi, 2, 4)
