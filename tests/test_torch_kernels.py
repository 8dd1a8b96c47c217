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
from arroyo_tpu_torch.kernels.argmax_fire import argmax_fire
from arroyo_tpu_torch.kernels.bin_evict import bin_evict
from arroyo_tpu_torch.kernels.bin_update import bin_update
from arroyo_tpu_torch.kernels.expand_gather import (
    expand_gather, expand_gather_buffer, expand_views)
from arroyo_tpu_torch.kernels.join_expand import join_expand
from arroyo_tpu_torch.kernels.join_probe import join_probe
from arroyo_tpu_torch.kernels.pane_emit import fire_geometry, pane_emit, pane_views
from arroyo_tpu_torch.kernels.ring_gather import ring_gather, ring_gather_rows
from arroyo_tpu_torch.kernels.ring_merge import SENT32_HI, SENT32_LO, ring_merge
from arroyo_tpu_torch.kernels.segment_agg import segment_agg, segment_agg_buffer
from arroyo_tpu_torch.kernels.session_union import session_union
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
    idx = torch.tensor([[1], [2]], dtype=torch.int32)
    packed = torch.tensor([[2.0]], dtype=torch.float64)
    bin_update(values, counts, idx, packed, ("count",), (0,))
    assert counts[1, 2] == 2 and values[0, 1, 2] == 2.0
    argmax_fire(counts, torch.zeros((1, 1), dtype=torch.int32),
                torch.ones((1, 1), dtype=torch.bool), "max")
    outs, cnts = pane_views(pane_emit(values, counts, 2, 0, 2, 1, 1,
                                      ("count",), (), 8), 0, 8, 1, torch.int32)
    assert cnts[1, 0] == 2 and outs.shape == (0, 8, 1)
    bin_evict(values, counts, 2, 1, 8, ("count",))
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
    (1, 1, False)])
def test_session_union_plain_matches_union_kernel(n, n_keys, touching):
    """Exact new-session flags and running ends on the first n rows of
    the JAX kernel's padded scan."""
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
    the identities and count 0.  Its MIN/MAX identities are the f64
    extremes (the plain version's, ROADMAP C8) where the JAX kernel gives
    XLA's empty-segment +/-inf; callers never pass an empty segment.
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
            w = np.asarray(want)[c, :n_seg].copy()
            if k in ("min", "max"):
                empty = np.diff(offsets) == 0
                assert (w[empty] == (np.inf if k == "min" else -np.inf)).all()
                w[empty] = POS_INF if k == "min" else NEG_INF
            if k == "sum":
                np.testing.assert_allclose(out[c].numpy(), w, rtol=1e-12)
            else:
                np.testing.assert_array_equal(out[c].numpy(), w)


def test_session_kernels_run_plain_versions_on_cpu_and_reject_others():
    """The session kernels' wrappers count no launch for CPU tensors and
    raise for tensors on another non-CUDA device."""
    before = (session_union.launches, segment_agg.launches)
    kh = torch.tensor([5, 5, 5, 9])
    st = torch.tensor([0, 10, 30, 0])
    en = torch.tensor([10, 20, 40, 3])
    new, run = session_union(kh, st, en)
    assert new.tolist() == [True, False, True, True]
    assert run.tolist() == [10, 20, 40, 3]
    out, cnt = segment_agg(torch.tensor([[1.0, 2.0, 4.0]],
                                        dtype=torch.float64),
                           torch.tensor([0, 2, 3]), ("sum",))
    assert out.tolist() == [[3.0, 4.0]] and cnt.tolist() == [2, 1]
    assert (session_union.launches, segment_agg.launches) == before
    with pytest.raises(ValueError):
        session_union(kh.to("meta"), st.to("meta"), en.to("meta"))
    with pytest.raises(ValueError):
        segment_agg(torch.zeros((1, 3), dtype=torch.float64, device="meta"),
                    torch.tensor([0, 3], device="meta"), ("sum",))
    with pytest.raises(ValueError, match="value rows"):  # count: no row
        segment_agg(torch.zeros((1, 3), dtype=torch.float64),
                    torch.tensor([0, 3]), ("count",))
    with pytest.raises(TypeError):
        session_union(kh.to(torch.int32), st, en)


def _probe_fixture(rng, case):
    """A ring (sorted ``hi`` with repeats, sentinel padding past
    ``n_valid``; random ``lo``) and sorted queries padded to ``mq``:
    ``empty`` — no query matches; ``skew`` — one query spans the whole
    full ring; ``collide`` — hi-equal candidates whose lo mostly differs;
    ``padded`` — a partly filled ring and many padding queries."""
    cap, mq = 1024, 512
    n_valid, m = {"empty": (900, 400), "skew": (cap, 1),
                  "collide": (1000, 300), "padded": (700, 37)}[case]
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
        hi[:n_valid] = ring
        q = rng.integers(0, span, m) * 2
        if case == "empty":
            q = q + 1  # odd: never in the ring
        order = np.argsort(q, kind="stable")
        q_hi[:m] = q[order]
        # a third of the queries copy the lo of a ring row with their hi
        pick = np.searchsorted(ring, q_hi[:m])
        own = (rng.random(m) < 0.33) & (pick < n_valid)
        q_lo[:m] = rng.integers(-2**31, 2**31 - 1, m)
        q_lo[:m][own] = lo[pick[own]]
    return hi, lo, q_hi, q_lo, m, n_valid


@pytest.mark.parametrize("case", ["empty", "skew", "collide", "padded"])
def test_join_probe_expand_gather_plain_match_jax_kernels(case):
    """K9 against ``_probe_kernel`` in both its searchsorted and
    merged-rank forms, K10 against ``_expand_kernel`` and K11 against
    ``_expand_gather_kernel``, all bit-exact (the JAX outputs are i32 and
    bucket-padded: compared widened, sliced to the exact pair total);
    ``expand_gather_buffer``'s views hold the same outputs."""
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
    assert (total == 0) == (case == "empty")
    assert case != "skew" or total == cap
    if not total:
        lidx, ridx = join_expand(start, cum, 0)
        assert lidx.shape == ridx.shape == (0,)
        buf = expand_gather_buffer(start, cum, 0, *map(
            torch.tensor, (hi, lo, q_hi, q_lo, fs, ist)))
        assert buf.numel() == 0
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
        (2 + nf + ni) * total + (total + 7) // 8)
    for g, v in zip(got, expand_views(buf, total, nf, ni)):
        assert g.dtype == v.dtype and torch.equal(g, v)
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
