"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor arroyo_tpu, so it runs on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips (CUDA kernels have no CPU mode)."""

import warnings

import numpy as np
import pytest
import torch

from arroyo_tpu_torch.kernels.argmax_fire import argmax_fire, argmax_fire_reference
from arroyo_tpu_torch.kernels.bin_evict import bin_evict, bin_evict_reference
from arroyo_tpu_torch.kernels.bin_update import bin_update, bin_update_reference
from arroyo_tpu_torch.kernels.emit_compact import (
    emit_count,
    emit_count_reference,
    emit_gather,
    emit_gather_reference,
)
from arroyo_tpu_torch.kernels.expand_gather import (
    expand_gather,
    expand_gather_buffer,
    expand_gather_reference,
    expand_views,
)
from arroyo_tpu_torch.kernels.join_expand import join_expand, join_expand_reference
from arroyo_tpu_torch.kernels.join_probe import join_probe, join_probe_reference
from arroyo_tpu_torch.kernels.pane_emit import (
    fire_geometry,
    pane_emit,
    pane_emit_reference,
    pane_views,
)
from arroyo_tpu_torch.kernels.ring_gather import (
    ring_gather,
    ring_gather_reference,
    ring_gather_rows,
)
from arroyo_tpu_torch.kernels.ring_merge import ring_merge, ring_merge_reference
from arroyo_tpu_torch.kernels.segment_agg import (
    TILE_ROWS,
    segment_agg,
    segment_agg_buffer,
    segment_agg_reference,
)
from arroyo_tpu_torch.kernels.segment_top_k import (
    FINAL_ROWS,
    TILE_ROWS,
    segment_top_k,
    segment_top_k_reference,
)
from arroyo_tpu_torch.kernels.session_union import (
    session_union,
    session_union_reference,
)

F64_MAX = torch.finfo(torch.float64).max

# (channel kinds, COUNT(*) channels): q5's bare COUNT(*), and a mixed
# SUM/AVG/COUNT(col)/MIN/MAX set with validity channels beside a COUNT(*)
KIND_SETS = [
    (("count",), (0,)),
    (("count", "sum", "sum", "count", "min", "max", "sum", "sum"), (0,)),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kinds,dup", KIND_SETS)
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
def test_bin_update_cuda_matches_plain(cuda_device, kinds, dup, cdt):
    """Duplicate cells, padding rows and out-of-plane slots; exact for
    counts/min/max, rtol 1e-12 for f64 sums (atomics reorder them)."""
    rng = np.random.default_rng(3)
    C, B, m = 4096, 16, 20000
    n_ch, n_src = len(kinds), 1 + len(kinds) - len(dup)
    idx = np.stack([rng.integers(-2, C + 2, m), rng.integers(0, B, m)])
    packed = rng.normal(size=(n_src, m)) * 1e3
    packed[0] = rng.integers(0, 20, m)
    values = rng.normal(size=(n_ch, C, B)) * 10
    for j, k in enumerate(kinds):
        if k in ("min", "max"):
            values[j][rng.random((C, B)) < 0.5] = F64_MAX * (
                1 if k == "min" else -1)
    counts = torch.tensor(rng.integers(0, 100, (C, B)), dtype=cdt,
                          device=cuda_device)
    v = torch.tensor(values, device=cuda_device)
    idx_t = torch.tensor(idx.astype(np.int32), device=cuda_device)
    packed_t = torch.tensor(packed, device=cuda_device)
    v_ref, c_ref = v.clone(), counts.clone()
    before = bin_update.launches
    bin_update(v, counts, idx_t, packed_t, kinds, dup)
    bin_update_reference(v_ref, c_ref, idx_t, packed_t, kinds, dup)
    torch.cuda.synchronize()
    assert bin_update.launches == before + 1
    assert torch.equal(counts, c_ref)
    for j, k in enumerate(kinds):
        if k in ("min", "max"):
            assert torch.equal(v[j], v_ref[j])
        else:
            torch.testing.assert_close(v[j], v_ref[j], rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("kpad", [1, 8])
@pytest.mark.parametrize("minmax", ["max", "min"])
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
def test_argmax_fire_cuda_matches_plain(cuda_device, kpad, minmax, cdt):
    """Exact, including the row-major output order."""
    rng = np.random.default_rng(9)
    C, B, W = 131072, 16, 5
    counts = torch.tensor(rng.poisson(0.8, (C, B)), dtype=cdt,
                          device=cuda_device)
    ring = torch.tensor(rng.integers(0, B, (kpad, W)).astype(np.int32),
                        device=cuda_device)
    ok_np = rng.random((kpad, W)) < 0.8
    ok_np[kpad // 2:] = False  # padded panes of a partial fire
    ok = torch.tensor(ok_np, device=cuda_device)
    got = argmax_fire(counts, ring, ok, minmax)
    want = argmax_fire_reference(counts, ring, ok, minmax)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _planes(rng, dev, kinds, C, B, cdt):
    values = rng.normal(size=(len(kinds), C, B)) * 100
    for j, k in enumerate(kinds):
        if k in ("min", "max"):
            values[j][rng.random((C, B)) < 0.5] = F64_MAX * (
                1 if k == "min" else -1)
    counts = torch.tensor(rng.integers(0, 50, (C, B)), dtype=cdt, device=dev)
    return torch.tensor(values, device=dev), counts


@pytest.mark.cuda
@pytest.mark.parametrize("kinds,xfer,W,k", [
    (("count",), (), 1, 1),  # q8's tumbling COUNT(*) fire
    (("count", "sum", "sum", "count", "min", "max", "sum", "sum"),
     (1, 2, 3, 4, 5, 6, 7), 5, 8)])
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
def test_pane_emit_cuda_matches_plain(cuda_device, kinds, xfer, W, k, cdt):
    """Exact for counts, min and max; rtol 1e-12 for f64 pane sums.  The
    fire's panes wrap the ring; at W > 1 the first bin is evicted and the
    last lies past the newest.  One launch; both outputs view one
    buffer."""
    rng = np.random.default_rng(13)
    C, B, c_slice = 65536, 16, 60000
    values, counts = _planes(rng, cuda_device, kinds, C, B, cdt)
    first_bin = 16 * 3 + 13
    lo = first_bin + (W > 1)
    hi = first_bin + k + W - 2 - (k > 1)
    args = (values, counts, first_bin, lo, hi, W, k, kinds, xfer, c_slice)
    before = pane_emit.launches
    got = pane_views(pane_emit(*args), len(xfer), c_slice, k, cdt)
    want = pane_emit_reference(*args)
    torch.cuda.synchronize()
    assert pane_emit.launches == before + 1
    assert got[0].untyped_storage().data_ptr() == \
        got[1].untyped_storage().data_ptr()
    assert torch.equal(got[1], want[1])
    for r, j in enumerate(xfer):
        if kinds[j] in ("min", "max"):
            assert torch.equal(got[0][r], want[0][r])
        else:
            torch.testing.assert_close(got[0][r], want[0][r], rtol=1e-12,
                                       atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("B,first_bin,lo,hi,W,k", [
    (16, 16 * 3 + 2, 16 * 3 + 6, 16 * 3 + 21, 5, 20),  # final flush
    (16, -4, 0, 6, 5, 3),  # evicted bins, negative absolute bins
    (16, 7, 9, 12, 1, 1),  # no live bin
    (8, 8 * 9 + 6, 8 * 9 + 6, 8 * 9 + 6, 1, 1),  # q8's ring
    (64, 64 * 2 + 50, 64 * 2 + 50, 64 * 2 + 95, 3, 44),  # a wide ring
])
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
def test_pane_emit_cuda_geometries_match_plain(cuda_device, B, first_bin,
                                               lo, hi, W, k, cdt):
    """Fires whose live span is empty, wraps, holds every ring column (a
    final flush of k = B + W - 1 panes) or covers 46 columns of a 64-bin
    ring: exact against the plain version."""
    rng = np.random.default_rng(B + k)
    kinds = ("count", "sum", "min", "max")
    xfer = (1, 2, 3)
    C, c_slice = 8192, 6144
    values, counts = _planes(rng, cuda_device, kinds, C, B, cdt)
    args = (values, counts, first_bin, lo, hi, W, k, kinds, xfer, c_slice)
    want = pane_emit_reference(*args)
    got = pane_views(pane_emit(*args), len(xfer), c_slice, k, cdt)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][1:], want[0][1:])  # min, max
    torch.testing.assert_close(got[0][0], want[0][0], rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
@pytest.mark.parametrize("first_bin,n_bins", [
    (16 * 7 + 3, 1), (16 * 7 + 2, 4), (16 * 7 + 13, 6), (-5, 40)])
def test_bin_evict_cuda_matches_plain(cuda_device, cdt, first_bin, n_bins):
    """Exact: one column, an unaligned run of four, a run wrapping past
    column B - 1, every column; the rows past ``rows`` untouched."""
    rng = np.random.default_rng(19)
    kinds = ("count", "sum", "min", "max")
    C, rows = 65536, 60001
    values, counts = _planes(rng, cuda_device, kinds, C, 16, cdt)
    v_ref, c_ref = values.clone(), counts.clone()
    before = bin_evict.launches
    bin_evict(values, counts, first_bin, n_bins, rows, kinds)
    bin_evict_reference(v_ref, c_ref, first_bin, n_bins, rows, kinds)
    torch.cuda.synchronize()
    assert bin_evict.launches == before + 1
    assert torch.equal(counts, c_ref) and torch.equal(values, v_ref)
    assert not torch.equal(counts[rows:, (first_bin % 16)],
                           torch.zeros_like(counts[rows:, 0]))


def _merge_inputs(rng, dev, cap, n_res, m, nf, ni):
    """Positions as the join state computes them: a permutation of
    [0, n_res + m) split between resident and delta entries, padding at
    and beyond cap."""
    perm = rng.permutation(n_res + m)
    res_pos = np.full(cap, cap, np.int64)
    res_pos[:n_res] = np.sort(perm[:n_res])
    db = 1 << max(int(m - 1).bit_length(), 3)
    delta_pos = np.full(db, cap + 3, np.int64)
    delta_pos[:m] = np.sort(perm[n_res:])
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    i32 = lambda n: rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)  # noqa: E731
    stacks = (None,) * 4
    if nf or ni:
        stacks = (t(rng.normal(size=(nf, cap))),
                  t(rng.integers(-2**62, 2**62, (ni, cap))),
                  t(rng.normal(size=(nf, db))),
                  t(rng.integers(-2**62, 2**62, (ni, db))))
    return (t(i32(cap)), t(i32(cap)), stacks[0], stacks[1], t(res_pos),
            t(i32(db)), t(i32(db)), stacks[2], stacks[3], t(delta_pos))


@pytest.mark.cuda
@pytest.mark.parametrize("nf,ni", [(0, 0), (2, 6)])
def test_ring_merge_cuda_matches_plain(cuda_device, nf, ni):
    """Bit-exact, keys-only and with payload stacks."""
    rng = np.random.default_rng(37)
    args = _merge_inputs(rng, cuda_device, 65536, 40000, 9000, nf, ni)
    before = ring_merge.launches
    got = ring_merge(*args)
    want = ring_merge_reference(*args)
    torch.cuda.synchronize()
    assert ring_merge.launches == before + 1
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.cuda
def test_ring_gather_cuda_matches_plain(cuda_device):
    """Bit-exact at sorted-run positions with repeats."""
    rng = np.random.default_rng(39)
    cap = 65536
    f = torch.tensor(rng.normal(size=(2, cap)), device=cuda_device)
    i = torch.tensor(rng.integers(-2**62, 2**62, (6, cap)),
                     device=cuda_device)
    idx = torch.tensor(np.sort(rng.integers(0, cap, 5000)),
                       device=cuda_device)
    before = ring_gather.launches
    got = ring_gather(idx, f, i)
    want = ring_gather_reference(idx, f, i)
    torch.cuda.synchronize()
    assert ring_gather.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # both outputs are views of one [nf + ni, m] buffer: gi's rows follow
    # gf's in the same storage
    storage = got[1].untyped_storage()
    assert got[0].untyped_storage().data_ptr() == storage.data_ptr()
    assert storage.nbytes() == 8 * 8 * 5000
    assert got[1].data_ptr() == got[0].data_ptr() + 2 * 8 * 5000


@pytest.mark.cuda
@pytest.mark.parametrize("m,nf,ni", [(0, 2, 6), (700, 0, 1), (700, 2, 0),
                                     (1, 1, 1)])
def test_ring_gather_cuda_edges_and_clamping(cuda_device, m, nf, ni):
    """m = 0 and an empty stack launch nothing; indices outside [0, cap)
    clamp to its ends; the rows buffer holds the f64 rows' bits over the
    i64 rows."""
    rng = np.random.default_rng(m + 10 * nf + ni)
    cap = 1024
    f = torch.tensor(rng.normal(size=(nf, cap)), device=cuda_device)
    i = torch.tensor(rng.integers(-2**62, 2**62, (ni, cap)),
                     device=cuda_device)
    idx = torch.tensor(rng.integers(-3 * cap, 3 * cap, m),
                       device=cuda_device)
    before = ring_gather.launches
    rows = ring_gather_rows(idx, f, i)
    gf, gi = ring_gather(idx, f, i)
    want = ring_gather_reference(idx, f, i)
    torch.cuda.synchronize()
    assert ring_gather.launches == before + (2 if m and nf + ni else 0)
    assert tuple(rows.shape) == (nf + ni, m)
    assert torch.equal(gf, want[0]) and torch.equal(gi, want[1])
    assert torch.equal(rows[:nf].view(torch.float64), want[0])
    assert torch.equal(rows[nf:], want[1])


def _allocs_and_syncs(fn):
    """(allocations, host syncs) of one warm call of ``fn``, as the caching
    allocator and PyTorch's sync debug mode see them."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    # the mode's first use also warns that it is a prototype: not a sync
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    return allocs, syncs


@pytest.mark.cuda
def test_kernels_cuda_allocations_and_syncs_per_call(cuda_device):
    """ring_gather, pane_emit, segment_agg and expand_gather: one
    allocation and no host sync a call; bin_evict: neither; segment_top_k
    at hot items' steady fire: the one sync its wrapper counts.  A known readback checks that the sync
    detector sees one."""
    rng = np.random.default_rng(40)
    x = torch.ones(1000, device=cuda_device)
    assert _allocs_and_syncs(lambda: x.sum().item())[1] == 1
    cap, m = 65536, 5000
    f = torch.tensor(rng.normal(size=(2, cap)), device=cuda_device)
    i = torch.tensor(rng.integers(-2**62, 2**62, (6, cap)),
                     device=cuda_device)
    idx = torch.tensor(np.sort(rng.integers(0, cap, m)), device=cuda_device)
    assert _allocs_and_syncs(lambda: ring_gather_rows(idx, f, i)) == (1, 0)
    assert _allocs_and_syncs(lambda: ring_gather(idx, f, i)) == (1, 0)
    n = 599_800
    seg = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    val = torch.tensor(_topk_values(rng, n, 3_000), device=cuda_device)
    _allocs, syncs = _allocs_and_syncs(lambda: segment_top_k(seg, val, 10))
    assert syncs == segment_top_k.last_syncs == 1
    kinds = ("count", "sum", "min")
    values, counts = _planes(rng, cuda_device, kinds, 65536, 16, torch.int32)
    assert _allocs_and_syncs(lambda: pane_emit(
        values, counts, 16 * 5 + 2, 16 * 5 + 2, 16 * 5 + 9, 5, 4, kinds,
        (1, 2), 60000)) == (1, 0)
    assert _allocs_and_syncs(lambda: bin_evict(
        values, counts, 16 * 5 + 2, 1, 60000, kinds)) == (0, 0)
    # segment_agg at config5's fire and over many tiles; expand_gather at
    # a join-stress probe
    for n, n_seg, kinds in ((8192, 256, ("count",)),
                            (1 << 20, 4096, ("sum", "count", "max"))):
        offsets, vals = _segments(rng, n, n_seg, kinds, cuda_device)
        assert _allocs_and_syncs(
            lambda: segment_agg_buffer(vals, offsets, kinds)) == (1, 0)
        assert _allocs_and_syncs(
            lambda: segment_agg(vals, offsets, kinds)) == (1, 0)
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    hi, lo, q_hi, q_lo = map(t, _ring_and_queries(rng, 8192, 5905, 1024,
                                                  520, 6250))
    start, _counts, cum = join_probe_reference(q_hi, hi, 520, 5905)
    total = int(cum[-1])
    args = (start, cum, total, hi, lo, q_hi, q_lo,
            torch.zeros((0, 8192), dtype=torch.float64, device=cuda_device),
            t(rng.integers(-2**62, 2**62, (3, 8192))))
    assert _allocs_and_syncs(lambda: expand_gather_buffer(*args)) == (1, 0)
    assert _allocs_and_syncs(lambda: expand_gather(*args)) == (1, 0)


def _intervals(rng, n, n_keys):
    """(kh, st, en) sorted by (kh, st): hash-like keys (full int64 range),
    micros starts, ends a gap past them, some intervals touching."""
    keys = rng.integers(-2**63, 2**63 - 1, n_keys, dtype=np.int64)
    kh = np.sort(rng.choice(keys, n))
    st = rng.integers(1_700_000_000_000_000, 1_700_000_100_000_000, n)
    order = np.lexsort((st, kh))
    kh, st = kh[order], st[order]
    en = st + rng.integers(1, 3_000_000, n)
    touch = rng.random(n) < 0.1  # st == the predecessor's end
    touch[0] = False
    st[touch] = en[np.nonzero(touch)[0] - 1]
    order = np.lexsort((st, kh))
    return kh[order], st[order], en[order]


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_keys", [(1, 1), (256, 40), (65536, 3000),
                                      (65536, 1), (1_048_576, 200_000),
                                      (1_048_576, 1)])
def test_session_union_cuda_matches_plain(cuda_device, n, n_keys):
    """Exact flags and running ends, including one key spanning every
    tile (the carry crosses all 1,024 blocks)."""
    rng = np.random.default_rng(n + n_keys)
    kh, st, en = (torch.tensor(a, device=cuda_device)
                  for a in _intervals(rng, n, n_keys))
    before = session_union.launches
    got = session_union(kh, st, en)
    want = session_union_reference(kh, st, en)
    torch.cuda.synchronize()
    assert session_union.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_seg,kinds", [
    (8192, 256, ("count",)),  # config5's COUNT(*) fire
    (200_000, 2048, ("count",)),  # config5's final flush
    (1_048_576, 65536,
     ("sum", "min", "max", "count", "sum", "min", "max")),
    (1_048_576, 1, ("sum", "min", "max", "count")),  # one skewed segment
    (1000, 1000, ("sum", "min"))])  # one row per segment
def test_segment_agg_cuda_matches_plain(cuda_device, n, n_seg, kinds):
    """Exact counts, min and max; rtol 1e-12 for the f64 sums (the
    kernel's fixed order differs from index_add_'s); two calls give
    bit-equal sums."""
    rng = np.random.default_rng(n_seg)
    cuts = np.sort(rng.choice(np.arange(1, n), n_seg - 1, replace=False))
    offsets = torch.tensor(np.concatenate([[0], cuts, [n]]),
                           device=cuda_device)
    n_reduced = sum(k != "count" for k in kinds)  # count reads no row
    values = torch.tensor(rng.normal(size=(n_reduced, n)) * 1e3,
                          device=cuda_device)
    before = segment_agg.launches
    got = segment_agg(values, offsets, kinds)
    want = segment_agg_reference(values, offsets, kinds)
    again = segment_agg(values, offsets, kinds)
    torch.cuda.synchronize()
    assert segment_agg.launches == before + 2
    assert torch.equal(got[0], again[0])  # deterministic: bit-equal
    assert torch.equal(got[1], want[1])
    for c, k in enumerate(kinds):
        if k == "sum":
            torch.testing.assert_close(got[0][c], want[0][c], rtol=1e-12,
                                       atol=1e-9)
        else:
            assert torch.equal(got[0][c], want[0][c])


def _segments(rng, n, n_seg, kinds, device, offsets=None):
    """(offsets, values) of n rows over n_seg random non-empty segments,
    or over the given offsets; one value row per channel not a count."""
    if offsets is None:
        cuts = np.sort(rng.choice(np.arange(1, n), n_seg - 1, replace=False))
        offsets = np.concatenate([[0], cuts, [n]])
    n_reduced = sum(k != "count" for k in kinds)  # count reads no row
    values = rng.normal(size=(n_reduced, n)) * 1e3
    return (torch.tensor(np.asarray(offsets, np.int64), device=device),
            torch.tensor(values, device=device).reshape(n_reduced, n))


def _tile_layout(case):
    """Offsets that straddle segment_agg's row tiles (TILE_ROWS rows)."""
    T = TILE_ROWS
    if case == "tile_edges":  # segments ending exactly on tile edges
        return [0, 100, T, T + 5, 2 * T, 3 * T, 3 * T + 1, 5 * T]
    if case == "long_then_ones":  # one segment over 40 tiles, then 1-row
        return [0, 40 * T + 77] + list(range(40 * T + 78, 42 * T + 1))
    if case == "empties":  # empty at the start, the middle and the end
        return [0, 0, 0, 5, 5, 5, T, T, T + 1, 3 * T + 10, 3 * T + 10,
                3 * T + 10]
    if case == "many_empties":  # a tile holding thousands of empty ones
        return [0] + [100] * 3000 + [T + 50] * 10 + [2 * T]
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tile_edges", "long_then_ones", "empties",
                                  "many_empties"])
@pytest.mark.parametrize("kinds", [("sum", "min", "max", "count", "sum"),
                                   ("count",)])  # k_r = 5 and k_r = 0
def test_segment_agg_cuda_straddles_tiles(cuda_device, case, kinds):
    """Segments across and on the edges of the kernel's row tiles, empty
    segments and value-free calls: counts, min and max exact against the
    plain version, sums within rtol 1e-12 of math.fsum, and two calls
    bit-equal (the order of additions is fixed by the offsets)."""
    import math
    rng = np.random.default_rng(len(case) + len(kinds))
    offs = _tile_layout(case)
    n = offs[-1]
    offsets, values = _segments(rng, n, len(offs) - 1, kinds, cuda_device,
                                offs)
    before = segment_agg.launches
    got = segment_agg(values, offsets, kinds)
    again = segment_agg_buffer(values, offsets, kinds)
    want = segment_agg_reference(values, offsets, kinds)
    torch.cuda.synchronize()
    assert segment_agg.launches == before + 2
    assert torch.equal(again[0], got[1])
    assert torch.equal(again[1:].view(torch.float64), got[0])  # bit-equal
    assert torch.equal(got[1], want[1])
    vals = values.cpu().numpy()
    r = 0
    for c, k in enumerate(kinds):
        if k == "sum":
            exact = torch.tensor([math.fsum(vals[r, a:b]) for a, b in zip(
                offs[:-1], offs[1:])], dtype=torch.float64)
            torch.testing.assert_close(got[0][c].cpu(), exact, rtol=1e-12,
                                       atol=1e-9)
        else:
            assert torch.equal(got[0][c], want[0][c])
        r += k != "count"


SENT32_HI = 0x7FFFFFFF


def _ring_and_queries(rng, cap, n_valid, mq, m, span):
    """A sorted ring with repeats (keys in [0, 2 * span), sentinels past
    n_valid, random lo) and sorted queries, a third of which copy the lo
    of a ring row with their hi; span 1 puts every row under one key."""
    hi = np.full(cap, SENT32_HI, np.int32)
    hi[:n_valid] = np.sort(rng.integers(0, span, n_valid) * 2)
    lo = rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)
    q_hi = np.full(mq, SENT32_HI, np.int32)
    miss = (rng.random(m) < 0.2) & (span > 1)  # odd keys: no match
    q_hi[:m] = np.sort(rng.integers(0, span, m) * 2 + miss)
    q_lo = rng.integers(-2**31, 2**31 - 1, mq).astype(np.int32)
    pick = np.minimum(np.searchsorted(hi[:n_valid], q_hi), n_valid - 1)
    own = rng.random(mq) < 0.33
    q_lo[own] = lo[pick[own]]
    return hi, lo, q_hi, q_lo


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_valid,mq,m,span", [
    (4096, 3000, 512, 480, 5000),  # a join-stress partition probe
    (8192, 8192, 1024, 1024, 300),  # one full tile of queries
    (65536, 60000, 65536, 50000, 20000),  # 64 tiles: the carry scan
    (1 << 20, 1 << 20, 512, 1, 1),  # one query spans the whole ring
    (4096, 10, 512, 400, 3)])  # a nearly empty ring
def test_join_kernels_cuda_match_plain(cuda_device, cap, n_valid, mq, m,
                                       span):
    """K9-K11 bit-exact against their plain versions: bounds, counts and
    the i64 prefix sum across tiles; pairs, verify flags and both
    stacks (nf = 0 as in join-stress, and nf = 2)."""
    rng = np.random.default_rng(cap + mq + span)
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    hi, lo, q_hi, q_lo = map(t, _ring_and_queries(rng, cap, n_valid, mq, m,
                                                  span))
    before = (join_probe.launches, join_expand.launches,
              expand_gather.launches)
    got = join_probe(q_hi, hi, m, n_valid)
    want = join_probe_reference(q_hi, hi, m, n_valid)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    start, _counts, cum = want
    total = int(cum[-1])
    assert total > 0
    pairs = join_expand(start, cum, total)
    for g, w in zip(pairs, join_expand_reference(start, cum, total)):
        assert torch.equal(g, w)
    for nf in (0, 2):
        fst = t(rng.normal(size=(nf, cap)))
        ist = t(rng.integers(-2**62, 2**62, (3, cap)))
        args = (start, cum, total, hi, lo, q_hi, q_lo, fst, ist)
        got = expand_gather(*args)
        want = expand_gather_reference(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)
    assert (join_probe.launches, join_expand.launches,
            expand_gather.launches) == (before[0] + 1, before[1] + 1,
                                        before[2] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("total", [1, 512, 513, 5000])
@pytest.mark.parametrize("nf", [0, 2])
def test_expand_gather_cuda_block_edges(cuda_device, total, nf):
    """Pair totals of 1, one block of 512 pairs, one more, and many
    blocks, over queries whose counts include long runs of zeros: all
    five outputs bit-equal to the plain version, as views of one buffer."""
    rng = np.random.default_rng(total + nf)
    cap, mq = 8192, 1024
    counts = np.zeros(mq, np.int64)
    hit = np.sort(rng.choice(mq, min(mq, 40), replace=False))
    counts[hit] = rng.multinomial(total - len(hit), np.ones(len(hit))
                                  / len(hit)) + 1 if total >= len(hit) else 0
    if total < len(hit):
        counts[hit[:total]] = 1
    assert counts.sum() == total
    cum = np.cumsum(counts)
    start = np.minimum(rng.integers(0, cap, mq), cap - counts)
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    hi = t(rng.integers(0, 50, cap).astype(np.int32))
    lo = t(rng.integers(0, 3, cap).astype(np.int32))
    q_hi = t(rng.integers(0, 50, mq).astype(np.int32))
    q_lo = t(rng.integers(0, 3, mq).astype(np.int32))
    args = (t(start.astype(np.int32)), t(cum), total, hi, lo, q_hi, q_lo,
            t(rng.normal(size=(nf, cap))).reshape(nf, cap),
            t(rng.integers(-2**62, 2**62, (3, cap))))
    before = expand_gather.launches
    buf = expand_gather_buffer(*args)
    got = expand_gather(*args)
    want = expand_gather_reference(*args)
    torch.cuda.synchronize()
    assert expand_gather.launches == before + 2
    for g, v, w in zip(got, expand_views(buf, total, nf, 3), want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w) and torch.equal(v, w)
    assert got[0].untyped_storage().data_ptr() == \
        got[4].untyped_storage().data_ptr()


@pytest.mark.cuda
def test_join_kernels_cuda_count_no_launch_without_work(cuda_device):
    """No queries, or no candidate pair: the wrappers return empty
    outputs of the right types and count no launch."""
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    hi = t(np.array([2, 4, 0x7FFFFFFF], np.int32))
    lo = t(np.zeros(3, np.int32))
    q = t(np.zeros(0, np.int32))
    before = (join_probe.launches, join_expand.launches,
              expand_gather.launches)
    start, counts, cum = join_probe(q, hi, 0, 2)
    assert [x.shape[0] for x in (start, counts, cum)] == [0, 0, 0]
    start, cum = t(np.zeros(2, np.int32)), t(np.zeros(2, np.int64))
    q2 = t(np.array([1, 3], np.int32))
    lidx, ridx = join_expand(start, cum, 0)
    assert lidx.shape == ridx.shape == (0,)
    out = expand_gather(start, cum, 0, hi, lo, q2, q2,
                        torch.zeros((0, 3), dtype=torch.float64,
                                    device=cuda_device),
                        t(np.zeros((2, 3), np.int64)))
    assert [tuple(x.shape) for x in out] == [(0,), (0,), (0,), (0, 0),
                                             (2, 0)]
    assert (join_probe.launches, join_expand.launches,
            expand_gather.launches) == before


def _topk_values(rng, n, hi):
    """Bid counts (small integers: heavy ties) with a few NaN, -0.0 and
    +/-inf mixed in."""
    v = rng.integers(1, hi, n).astype(np.float64)
    r = rng.random(n)
    v[r < 0.001] = np.nan
    v[(r >= 0.001) & (r < 0.002)] = -0.0
    v[(r >= 0.002) & (r < 0.003)] = np.inf
    v[(r >= 0.003) & (r < 0.004)] = -np.inf
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_seg,k,skew", [
    (599_800, 1, 10, False),  # hot items at steady state: one window
    (1_410_844, 5, 10, False),  # the final flush: five windows
    (200_000, 20_000, 3, False),  # many segments smaller than k
    (300_000, 5_000, 10, True),  # one segment holds half the rows
    (5_000, 7, 100_000, False),  # k beyond every segment
    (1_410_844, 100_000, 10, False),  # the general path after a round
    (100_000, 3, 3_000, False),  # k beyond a tile: the general path
    (6_000, 4, 6_000, False),  # k = n in the final block alone
    (70_000, 2, 0, False),  # k = 0 keeps nothing
    (1, 1, 1, False)])
def test_segment_top_k_cuda_matches_plain(cuda_device, n, n_seg, k, skew):
    """The kept index array equals the plain version's exactly."""
    rng = np.random.default_rng(n + n_seg)
    seg = rng.integers(0, n_seg, n)
    if skew:
        seg[rng.random(n) < 0.5] = n_seg // 2
    seg = np.searchsorted(np.unique(seg), seg).astype(np.int32)
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    args = (t(seg), t(_topk_values(rng, n, 3_000)), k)
    before = segment_top_k.launches
    got = segment_top_k(*args)
    want = segment_top_k_reference(*args)
    torch.cuda.synchronize()
    assert segment_top_k.launches == before + (1 if k else 0)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_seg,ties", [
    (599_800, 1, False),  # hot items' steady fire: two rounds to 20 rows
    (1_410_844, 5, False),  # the flush: a second round takes 34k to <= 850
    (599_800, 1, True),  # the 10th place tied across many tiles
])
def test_segment_top_k_cuda_prefilter_launches_and_syncs(cuda_device, n,
                                                         n_seg, ties):
    """The prefilter path at hot items' sizes: a zero-fill, two rounds and
    the final block (4 launches, at most 6) and one host sync, exact."""
    rng = np.random.default_rng(n + n_seg)
    seg = rng.integers(0, n_seg, n).astype(np.int32)
    v = (np.where(rng.random(n) < 0.0005, 7.0, 3.0) if ties
         else _topk_values(rng, n, 3_000))
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    args = (t(seg), t(v), 10)
    got = segment_top_k(*args)
    assert (segment_top_k.last_launches, segment_top_k.last_syncs) == (4, 1)
    assert torch.equal(got, segment_top_k_reference(*args))


@pytest.mark.cuda
def test_segment_top_k_cuda_path_tallies(cuda_device):
    """Launches and syncs per call on each path: nothing for k = 0; the
    final block alone up to FINAL_ROWS rows; the general radix path (two
    more syncs) when k fills a tile or the candidates do not shrink."""
    rng = np.random.default_rng(5)

    def run(n, n_seg, k):
        seg = torch.tensor(rng.integers(0, n_seg, n).astype(np.int32),
                           device=cuda_device)
        val = torch.tensor(_topk_values(rng, n, 50), device=cuda_device)
        got = segment_top_k(seg, val, k)
        assert torch.equal(got, segment_top_k_reference(seg, val, k))
        return segment_top_k.last_launches, segment_top_k.last_syncs

    assert run(1_000, 3, 0) == (0, 0)
    assert run(FINAL_ROWS, 3, 10) == (1, 1)
    launches, syncs = run(100_000, 3, TILE_ROWS)
    assert syncs == 2 and launches >= 7
    launches, syncs = run(1_410_844, 100_000, 10)
    assert syncs == 3 and launches >= 4 + 7


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
def test_emit_compact_cuda_matches_plain_and_pane_emit(cuda_device, k, cdt):
    """Hot items' compact fire (C = 2^22 slots, a quarter of them live):
    counts, offsets, rows and counts exact against the plain versions,
    and every channel bit-equal to the dense fire's (pane_emit) at the
    live cells, sums included."""
    g = torch.Generator(device=cuda_device).manual_seed(k)
    kinds = ("count", "sum", "min", "max")
    xfer = (1, 2, 3)
    C, B, W = 4_194_304, 16, 5
    dev = cuda_device
    values = torch.randn((len(kinds), C, B), generator=g, dtype=torch.float64,
                         device=dev) * 100
    live = torch.rand((C, B), generator=g, device=dev) < 0.06
    counts = torch.where(live, torch.randint(1, 9, (C, B), generator=g,
                                             device=dev), 0).to(cdt)
    values[2][~live] = F64_MAX  # the channels' identities where no row
    values[3][~live] = -F64_MAX
    # panes p < k over the absolute bins p + w, bin 0 evicted
    ring_np, ok_np = fire_geometry(0, 1, k + W, W, k, B)
    assert not ok_np[0, 0] and ok_np.sum() == k * W - 1
    ring = torch.tensor(ring_np, device=cuda_device)
    ok = torch.tensor(ok_np, device=cuda_device)
    rows = C - 1_000
    before = (emit_count.launches, emit_gather.launches)
    cnt, offsets = emit_count(counts, ring, ok, rows)
    cnt_r, offsets_r = emit_count_reference(counts, ring, ok, rows)
    torch.cuda.synchronize()
    assert torch.equal(cnt, cnt_r) and torch.equal(offsets, offsets_r)
    nnz = int(offsets[-1])
    assert 0.1 < nnz / (rows * k) < 0.5
    got = emit_gather(values, cnt, ring, ok, kinds, xfer, offsets, nnz)
    want = emit_gather_reference(values, cnt, ring, ok, kinds, xfer,
                                 offsets, nnz)
    torch.cuda.synchronize()
    assert (emit_count.launches, emit_gather.launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for r, j in enumerate(xfer):
        if kinds[j] in ("min", "max"):
            assert torch.equal(got[2][r], want[2][r])
        else:
            torch.testing.assert_close(got[2][r], want[2][r], rtol=1e-12,
                                       atol=1e-9)
    dense, _ = pane_views(pane_emit(values, counts, 0, 1, k + W, W, k, kinds,
                                    xfer, rows), len(xfer), rows, k, cdt)
    s, p = got[0][0].long(), got[0][1].long()
    assert torch.equal(got[2], dense[:, s, p])
