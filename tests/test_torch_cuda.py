"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor arroyo_tpu, so it runs on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips (CUDA kernels have no CPU mode)."""

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
from arroyo_tpu_torch.kernels.ring_gather import ring_gather, ring_gather_reference
from arroyo_tpu_torch.kernels.ring_merge import ring_merge, ring_merge_reference
from arroyo_tpu_torch.kernels.segment_agg import segment_agg, segment_agg_reference
from arroyo_tpu_torch.kernels.segment_top_k import (
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
    got = ring_gather(idx, f, i)
    want = ring_gather_reference(idx, f, i)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
    assert segment_top_k.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


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
