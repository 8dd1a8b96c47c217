"""The exact tile prefilter of the port's ``segment_top_k`` kernel, on the
CPU.

The CUDA kernel (arroyo_tpu_torch/csrc/segment_top_k.cu) runs rounds
that keep each tile's local top k per segment — first each warp chunk's,
then the tile's among the chunks' survivors — passing their input on
once it fits one tile or the round before kept more than half, then ranks
the survivors in one block (or, above its capacity, through the general
radix path).  CUDA has no CPU mode, so this file writes those rounds in
plain PyTorch — the device's control rules included — and holds their
final kept set against ``segment_top_k_reference`` and the JAX package's
``_topk_kernel`` path (arroyo_tpu/ops/topk.py:25) on inputs made from a
numpy seed: heavy ties at the k-th place, NaN of both signs, +/-0.0 and
+/-inf, k = 0, k >= n and k beyond a tile."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from arroyo_tpu.ops.topk import segment_top_k as jax_segment_top_k
from arroyo_tpu_torch.kernels.segment_top_k import (
    FINAL_ROWS,
    TILE_ROWS,
    prefilter_rounds,
    segment_top_k,
    segment_top_k_reference,
)

CHUNK = 128  # candidates a warp of the kernel sorts in registers


def grouped_top_k(group, val, k):
    """Indices (ascending) of the rows ranked below k inside their group
    (any i64 ids), ties by index: the plain version over dense ids."""
    dense = torch.unique(group, return_inverse=True)[1].to(torch.int32)
    return segment_top_k_reference(dense, val, k).long()


def plain_tiles(seg, val, cand, k, tile, chunk):
    """One prefilter stage over candidates ``cand`` (rows, ascending) cut
    into tiles of ``tile`` positions: as each warp of the kernel does, the
    local top k per segment of every chunk of ``chunk`` positions (kept
    whole when k >= chunk), then the survivors ranked per (tile,
    segment)."""
    n = seg.shape[0]
    pos = torch.arange(cand.shape[0])
    s, v = seg[cand].long(), val[cand]
    if k < chunk:
        pos = pos[grouped_top_k((pos // chunk) * n + s, v, k)]
    pos = pos[grouped_top_k((pos // tile) * n + s[pos], v[pos], k)]
    return cand[pos]


def plain_prefilter(seg, val, k, tile, final, chunk):
    """The kernel's rounds and final block in plain PyTorch, its control
    rules included: (kept row indices ascending, candidates after each
    launched round, whether the general path took them)."""
    n = seg.shape[0]
    if n == 0 or k == 0:
        return torch.zeros(0, dtype=torch.int32), [], False
    k = min(k, n)
    cand = torch.arange(n)
    counts = [n]  # each round's input count, as the control words hold
    for r in range(prefilter_rounds(n, k, tile, final)):
        m, m_prev = counts[r], counts[r - 1] if r > 1 else n
        if m > tile and (r == 0 or 2 * m <= m_prev):
            cand = plain_tiles(seg, val, cand, k, tile, chunk)
        counts.append(cand.shape[0])
    general = cand.shape[0] > final
    if general:  # the radix path ranks the candidates as they are
        kept = cand[grouped_top_k(seg[cand].long(), val[cand], k)]
    else:  # the final block: one tile holding every candidate
        kept = plain_tiles(seg, val, cand, k, max(1, cand.shape[0]), chunk)
    return kept.to(torch.int32), counts[1:], general


def values(rng, n, distinct):
    """Few distinct values (ties at the k-th place) with NaN, -NaN, +/-0.0
    and +/-inf mixed in."""
    v = rng.integers(0, distinct, n).astype(np.float64)
    r = rng.random(n)
    v[r < 0.04] = np.nan
    v[(r >= 0.04) & (r < 0.07)] = -np.nan
    v[(r >= 0.07) & (r < 0.12)] = -0.0
    v[(r >= 0.12) & (r < 0.15)] = 0.0
    v[(r >= 0.15) & (r < 0.17)] = np.inf
    v[(r >= 0.17) & (r < 0.19)] = -np.inf
    return v


def partitions(rng, n, n_seg, skew):
    """A sparse, signed partition column (dense segment ids come from
    np.unique on both sides); with ``skew`` one segment holds about half
    the rows."""
    part = rng.integers(0, n_seg, n)
    if skew:
        part[rng.random(n) < 0.5] = n_seg // 2
    return (part - n_seg // 2) * 977


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**32 - 1), n=st.integers(1, 1024),
       n_seg=st.sampled_from([1, 2, 5, 40, 1000]),
       tile_log2=st.integers(3, 6), distinct=st.sampled_from([2, 4, 50]),
       skew=st.booleans(),
       k_kind=st.sampled_from(["0", "1", "3", "10", "chunk", "tile",
                               "over-tile", "n", "over-n"]))
def test_prefilter_rounds_keep_exactly_the_top_k(seed, n, n_seg, tile_log2,
                                                 distinct, skew, k_kind):
    tile = 1 << tile_log2
    final = 4 * tile  # the kernel's final block holds four tiles
    chunk = tile // 4  # and a tile holds sixteen warp chunks
    k = {"0": 0, "1": 1, "3": 3, "10": 10, "chunk": chunk, "tile": tile,
         "over-tile": tile + 1, "n": n, "over-n": n + 7}[k_kind]
    rng = np.random.default_rng(seed)
    part = partitions(rng, n, n_seg, skew)
    vals = values(rng, n, distinct)
    seg = torch.tensor(np.searchsorted(np.unique(part), part)
                       .astype(np.int32))
    got, counts, _general = plain_prefilter(seg, torch.tensor(vals), k, tile,
                                            final, chunk)
    want = segment_top_k_reference(seg, torch.tensor(vals), k)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(),
                                  jax_segment_top_k(part, vals, k))
    # each launched round keeps at most k rows per (tile, segment)
    m = n
    for c in counts:
        assert c <= m
        m = c


@pytest.mark.parametrize("n,n_seg,after", [
    (599_800, 1, [2_930, 20]),  # hot items' steady fire: one window
    (1_410_844, 5, [34_450, 850]),  # the final flush: five windows
])
def test_prefilter_at_hot_items_sizes(n, n_seg, after):
    """At the kernel's tile (2,048) and final block (8,192): two rounds
    bring hot items' fires down to one block — exactly k a tile with one
    segment, at most 5k a tile with five — and the final set is exact."""
    rng = np.random.default_rng(n)
    seg = torch.tensor(rng.integers(0, n_seg, n).astype(np.int32))
    v = rng.geometric(0.35, n).astype(np.float64)
    hot = rng.random(n) < 0.002
    v[hot] = rng.integers(50, 900, int(hot.sum()))
    val = torch.tensor(v)
    assert prefilter_rounds(n, 10) == 2
    got, counts, general = plain_prefilter(seg, val, 10, TILE_ROWS,
                                           FINAL_ROWS, CHUNK)
    assert not general
    assert counts[0] <= after[0] and counts[1] <= after[1]
    if n_seg == 1:
        assert counts == after
    assert torch.equal(got, segment_top_k_reference(seg, val, 10))


def test_prefilter_hands_many_small_segments_to_the_general_path():
    """100,000 segments of ~14 rows: a tile keeps nearly every row, the
    second round is passed over (the first did not halve), and the general
    path ranks the candidates — still exactly."""
    rng = np.random.default_rng(3)
    n = 1_410_844
    seg = torch.tensor(rng.integers(0, 100_000, n).astype(np.int32))
    val = torch.tensor(rng.integers(0, 30, n).astype(np.float64))
    got, counts, general = plain_prefilter(seg, val, 10, TILE_ROWS,
                                           FINAL_ROWS, CHUNK)
    assert general and counts[0] == counts[1] > n // 2
    assert torch.equal(got, segment_top_k_reference(seg, val, 10))


@pytest.mark.parametrize("n,k,rounds", [
    (599_800, 10, 2), (1_410_844, 10, 2), (8_192, 10, 0), (8_193, 10, 1),
    (100_000, TILE_ROWS, 0), (100_000, 900, 4), (10**8, 10, 3)])
def test_prefilter_round_count_is_decided_from_n_and_k(n, k, rounds):
    """No rounds when the rows fit the final block or k fills a tile; else
    enough for k rows a tile to reach one tile, at most four."""
    assert prefilter_rounds(n, k) == rounds


def test_wrapper_counts_nothing_on_the_cpu():
    """CPU tensors take the plain version: no launch, and the per-call
    launch and sync tallies of the card path stay as they were."""
    before = (segment_top_k.launches, segment_top_k.last_launches,
              segment_top_k.last_syncs)
    seg = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    val = torch.tensor([1.0, 5.0, 3.0, float("nan")], dtype=torch.float64)
    assert segment_top_k(seg, val, 1).tolist() == [1, 2]
    assert (segment_top_k.launches, segment_top_k.last_launches,
            segment_top_k.last_syncs) == before
