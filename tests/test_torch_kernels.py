"""The port's device kernels (arroyo_tpu_torch.kernels) against the JAX
package's kernels on the same numpy inputs.

On the CPU the wrappers run their plain PyTorch versions, so these tests
hold those versions against ``_update_kernel`` (XLA), the Pallas
``scatter_add_channels`` (interpret mode, as tests/test_pallas.py runs
it), the argmax fire kernels, the dense emit and evict kernels and the
join ring's merge and gather kernels.  The CUDA kernels themselves are held
against the plain versions by tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arroyo_tpu.ops.join import _gather32_kernel, _merge32_kernel
from arroyo_tpu.ops.keyed_bins import (NEG_INF as JAX_NEG_INF,
                                       POS_INF as JAX_POS_INF,
                                       _argmax_gather_kernel,
                                       _argmax_nnz_kernel, _bucket,
                                       _emit_kernel, _evict_kernel,
                                       _update_kernel)
from arroyo_tpu.ops.pallas_kernels import HAVE_PALLAS, pad_batch, scatter_add_channels
from arroyo_tpu_torch.kernels.argmax_fire import argmax_fire
from arroyo_tpu_torch.kernels.bin_evict import bin_evict
from arroyo_tpu_torch.kernels.bin_update import bin_update
from arroyo_tpu_torch.kernels.pane_emit import pane_emit
from arroyo_tpu_torch.kernels.ring_gather import ring_gather
from arroyo_tpu_torch.kernels.ring_merge import SENT32_HI, SENT32_LO, ring_merge
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
    bin_update(tv, tc, torch.tensor(idx), torch.tensor(packed), kinds, dup)
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
    bin_update(values, counts, idx, packed, ("min",))
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
    bin_update(values, counts, torch.tensor(np.stack([s, b])),
               torch.tensor(wp.astype(np.float64)), ("sum",) * (k - 1))
    np.testing.assert_allclose(counts.numpy(), want[0], rtol=1e-4, atol=1e-3)
    for j in range(k - 1):
        np.testing.assert_allclose(values[j].numpy(), want[j + 1],
                                   rtol=1e-4, atol=1e-3)


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
    summation order over W may differ).  JAX computes the padded kpad
    panes over all C slots; the port reads the c_slice occupied slots
    and the k real panes, so the JAX result is sliced to them."""
    rng = np.random.default_rng(17)
    C, B, c_slice = 300, 16, 256
    values, counts = _planes(rng, kinds, C, B, cdt)
    ring = rng.integers(0, B, (kpad, W)).astype(np.int32)
    bin_ok = rng.random((kpad, W)) < 0.8
    bin_ok[k:] = False
    jo, jc = _emit_kernel(kinds, C, B, W, kpad, tuple(xfer))(
        jnp.asarray(values), jnp.asarray(counts), jnp.asarray(ring),
        jnp.asarray(bin_ok))
    to, tc = pane_emit(torch.tensor(values), torch.tensor(counts),
                       torch.tensor(ring[:k]), torch.tensor(bin_ok[:k]),
                       kinds, xfer, c_slice)
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
    """Exact: the expired columns reset to 0 and each channel's identity,
    every other cell untouched; JAX pads the column list to a bucket with
    invalid entries, the port takes the real columns only."""
    rng = np.random.default_rng(23)
    C, B = 300, 16
    values, counts = _planes(rng, kinds, C, B, cdt)
    cols = np.array([3, 4, 5, 4], dtype=np.int32)  # a repeat is harmless
    epad = _bucket(len(cols))
    ring = np.zeros(epad, dtype=np.int32)
    ring[:len(cols)] = cols
    ok = np.zeros(epad, dtype=bool)
    ok[:len(cols)] = True
    jv, jc = _evict_kernel(kinds, C, B)(
        jnp.asarray(values), jnp.asarray(counts), jnp.asarray(ring),
        jnp.asarray(ok))
    tv, tc = torch.tensor(values), torch.tensor(counts)
    bin_evict(tv, tc, torch.tensor(cols), kinds)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _merge_fixture(rng, cap, n_res, m, nf, ni):
    """A resident sorted run of n_res keys in a ring of cap, a sorted
    delta of m keys, and the positions join_state computes for them
    (unused resident slots and delta padding point at cap, plus two
    explicit positions beyond cap, all dropped)."""
    res_keys = np.sort(rng.integers(0, 2**63, n_res, dtype=np.uint64))
    dkeys = np.sort(rng.integers(0, 2**63, m, dtype=np.uint64))
    ins = np.searchsorted(res_keys, dkeys, side="right")
    dpos = ins + np.arange(m)
    keep = np.ones(n_res + m, dtype=bool)
    keep[dpos] = False
    res_pos = np.full(cap, cap, np.int64)
    res_pos[:n_res] = np.nonzero(keep)[0]
    db = _bucket(m, floor=8)
    delta_pos = np.full(db, cap, np.int64)
    delta_pos[:m] = dpos
    delta_pos[m:m + 2] = cap + 5  # explicit out-of-range: dropped
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
    return hi, lo, fs, ist, res_pos, d_hi, d_lo, d_f, d_i, delta_pos


@pytest.mark.parametrize("nf,ni", [(0, 0), (2, 6), (0, 3)])
def test_ring_merge_plain_matches_merge32_kernel(nf, ni):
    """Bit-exact, keys-only (nf = ni = 0) and with payload stacks, with
    padding positions at and beyond cap dropped."""
    rng = np.random.default_rng(29)
    cap, n_res, m = 1024, 600, 300
    a = _merge_fixture(rng, cap, n_res, m, nf, ni)
    hi, lo, fs, ist, res_pos, d_hi, d_lo, d_f, d_i, delta_pos = a
    db = len(d_hi)
    if ni:
        want = _merge32_kernel(cap, db, nf, ni)(*map(jnp.asarray, a))
        got = ring_merge(*(torch.tensor(x) for x in a))
    else:
        want = _merge32_kernel(cap, db, 0, 0)(
            jnp.asarray(hi), jnp.asarray(lo), 0, 0, jnp.asarray(res_pos),
            jnp.asarray(d_hi), jnp.asarray(d_lo), 0, 0,
            jnp.asarray(delta_pos))
        got = ring_merge(torch.tensor(hi), torch.tensor(lo), None, None,
                         torch.tensor(res_pos), torch.tensor(d_hi),
                         torch.tensor(d_lo), None, None,
                         torch.tensor(delta_pos))
        assert got[2] is None and got[3] is None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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


def test_wrappers_run_plain_versions_on_cpu_and_reject_other_devices():
    """CPU tensors take the plain version (no launch is counted); a
    tensor on any other non-CUDA device raises instead of falling back."""
    before = (bin_update.launches, argmax_fire.launches, pane_emit.launches,
              bin_evict.launches, ring_merge.launches, ring_gather.launches)
    values = torch.zeros((1, 8, 8), dtype=torch.float64)
    counts = torch.zeros((8, 8), dtype=torch.int32)
    idx = torch.tensor([[1], [2]], dtype=torch.int32)
    packed = torch.tensor([[2.0]], dtype=torch.float64)
    bin_update(values, counts, idx, packed, ("count",), (0,))
    assert counts[1, 2] == 2 and values[0, 1, 2] == 2.0
    argmax_fire(counts, torch.zeros((1, 1), dtype=torch.int32),
                torch.ones((1, 1), dtype=torch.bool), "max")
    ring = torch.tensor([[2]], dtype=torch.int32)
    ok = torch.ones((1, 1), dtype=torch.bool)
    outs, cnts = pane_emit(values, counts, ring, ok, ("count",), (), 8)
    assert cnts[1, 0] == 2 and outs.shape == (0, 8, 1)
    bin_evict(values, counts, torch.tensor([2], dtype=torch.int32),
              ("count",))
    assert int(counts.sum()) == 0 and float(values.sum()) == 0.0
    hi = torch.full((4,), 7, dtype=torch.int32)
    pos = torch.tensor([3, 0, 4, 4])
    out_hi, _lo, _f, _i = ring_merge(hi, hi, None, None, pos, hi[:1],
                                     hi[:1], None, None, pos[2:3])
    assert out_hi.tolist() == [7, int(SENT32_HI), int(SENT32_HI), 7]
    f = torch.arange(4, dtype=torch.float64)[None]
    gf, _gi = ring_gather(torch.tensor([3, 0]), f,
                          torch.zeros((1, 4), dtype=torch.int64))
    assert gf.tolist() == [[3.0, 0.0]]
    assert (bin_update.launches, argmax_fire.launches, pane_emit.launches,
            bin_evict.launches, ring_merge.launches,
            ring_gather.launches) == before
    meta = [t.to("meta") for t in (values, counts, idx, packed)]
    with pytest.raises(ValueError):
        bin_update(*meta, ("count",), (0,))
    with pytest.raises(ValueError):
        pane_emit(meta[0], meta[1], ring.to("meta"), ok.to("meta"),
                  ("count",), (), 8)
    with pytest.raises(ValueError):
        bin_evict(meta[0], meta[1], torch.tensor([2], dtype=torch.int32,
                                                 device="meta"), ("count",))
    with pytest.raises(ValueError):
        ring_gather(torch.tensor([0], device="meta"), f.to("meta"),
                    torch.zeros((1, 4), dtype=torch.int64, device="meta"))
