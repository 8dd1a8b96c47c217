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
    expand_gather_reference,
)
from arroyo_tpu_torch.kernels.join_expand import join_expand, join_expand_reference
from arroyo_tpu_torch.kernels.join_probe import join_probe, join_probe_reference
from arroyo_tpu_torch.kernels.pane_emit import pane_emit, pane_emit_reference
from arroyo_tpu_torch.kernels.ring_gather import (
    ring_gather,
    ring_gather_reference,
    ring_gather_rows,
)
from arroyo_tpu_torch.kernels.ring_merge import ring_merge, ring_merge_reference
from arroyo_tpu_torch.kernels.segment_agg import segment_agg, segment_agg_reference
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
    """Exact for counts, min and max; rtol 1e-12 for f64 pane sums."""
    rng = np.random.default_rng(13)
    C, B, c_slice = 65536, 16, 60000
    values, counts = _planes(rng, cuda_device, kinds, C, B, cdt)
    ring = torch.tensor(rng.integers(0, B, (k, W)).astype(np.int32),
                        device=cuda_device)
    ok = torch.tensor(rng.random((k, W)) < 0.8, device=cuda_device)
    before = pane_emit.launches
    got = pane_emit(values, counts, ring, ok, kinds, xfer, c_slice)
    want = pane_emit_reference(values, counts, ring, ok, kinds, xfer,
                               c_slice)
    torch.cuda.synchronize()
    assert pane_emit.launches == before + 1
    assert torch.equal(got[1], want[1])
    for r, j in enumerate(xfer):
        if kinds[j] in ("min", "max"):
            assert torch.equal(got[0][r], want[0][r])
        else:
            torch.testing.assert_close(got[0][r], want[0][r], rtol=1e-12,
                                       atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
def test_bin_evict_cuda_matches_plain(cuda_device, cdt):
    """Exact, with a repeated and an out-of-ring column."""
    rng = np.random.default_rng(19)
    kinds = ("count", "sum", "min", "max")
    values, counts = _planes(rng, cuda_device, kinds, 65536, 16, cdt)
    cols = torch.tensor([3, 9, 3, 16], dtype=torch.int32, device=cuda_device)
    v_ref, c_ref = values.clone(), counts.clone()
    bin_evict(values, counts, cols, kinds)
    bin_evict_reference(v_ref, c_ref, cols, kinds)
    torch.cuda.synchronize()
    assert torch.equal(counts, c_ref) and torch.equal(values, v_ref)


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
    """ring_gather: one allocation and no host sync a call; segment_top_k
    at hot items' steady fire: the one sync its wrapper counts.  A known
    readback checks that the sync detector sees one."""
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
    kernel's fixed tree order differs from index_add_'s)."""
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
    torch.cuda.synchronize()
    assert segment_agg.launches == before + 1
    assert torch.equal(got[1], want[1])
    for c, k in enumerate(kinds):
        if k == "sum":
            torch.testing.assert_close(got[0][c], want[0][c], rtol=1e-12,
                                       atol=1e-9)
        else:
            assert torch.equal(got[0][c], want[0][c])


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
    ring = torch.tensor(((np.arange(k)[:, None] + np.arange(W)[None, :])
                         % B).astype(np.int32), device=cuda_device)
    ok_np = np.ones((k, W), dtype=bool)
    ok_np[0, :1] = False
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
    dense, _ = pane_emit(values, counts, ring, ok, kinds, xfer, rows)
    s, p = got[0][0].long(), got[0][1].long()
    assert torch.equal(got[2], dense[:, s, p])
