"""The port's device kernels (arroyo_tpu_torch.kernels) against the JAX
package's kernels on the same numpy inputs.

On the CPU the wrappers run their plain PyTorch versions, so these tests
hold those versions against ``_update_kernel`` (XLA), the Pallas
``scatter_add_channels`` (interpret mode, as tests/test_pallas.py runs
it) and the argmax fire kernels.  The CUDA kernels themselves are held
against the plain versions by tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arroyo_tpu.ops.keyed_bins import (NEG_INF as JAX_NEG_INF,
                                       POS_INF as JAX_POS_INF,
                                       _argmax_gather_kernel,
                                       _argmax_nnz_kernel, _bucket,
                                       _update_kernel)
from arroyo_tpu.ops.pallas_kernels import HAVE_PALLAS, pad_batch, scatter_add_channels
from arroyo_tpu_torch.kernels.argmax_fire import argmax_fire
from arroyo_tpu_torch.kernels.bin_update import bin_update
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


def test_wrappers_run_plain_versions_on_cpu_and_reject_other_devices():
    """CPU tensors take the plain version (no launch is counted); a
    tensor on any other non-CUDA device raises instead of falling back."""
    before = (bin_update.launches, argmax_fire.launches)
    values = torch.zeros((1, 8, 8), dtype=torch.float64)
    counts = torch.zeros((8, 8), dtype=torch.int32)
    idx = torch.tensor([[1], [2]], dtype=torch.int32)
    packed = torch.tensor([[2.0]], dtype=torch.float64)
    bin_update(values, counts, idx, packed, ("count",), (0,))
    assert counts[1, 2] == 2 and values[0, 1, 2] == 2.0
    argmax_fire(counts, torch.zeros((1, 1), dtype=torch.int32),
                torch.ones((1, 1), dtype=torch.bool), "max")
    assert (bin_update.launches, argmax_fire.launches) == before
    meta = [t.to("meta") for t in (values, counts, idx, packed)]
    with pytest.raises(ValueError):
        bin_update(*meta, ("count",), (0,))
