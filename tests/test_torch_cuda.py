"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor arroyo_tpu, so it runs on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips (CUDA kernels have no CPU mode)."""

import warnings

import numpy as np
import pytest
import torch

from arroyo_tpu_torch.kernels.argmax_fire import (
    argmax_fire,
    argmax_fire_buffer,
    argmax_fire_buffer_reference,
    argmax_fire_reference,
    argmax_views,
)
from arroyo_tpu_torch.kernels.bin_evict import bin_evict, bin_evict_reference
from arroyo_tpu_torch.kernels.bin_update import (
    bin_update,
    bin_update_reference,
    channel_plan,
    pack_cells,
)
from arroyo_tpu_torch.kernels.emit_compact import (
    emit_count,
    emit_count_reference,
    compact_views,
    emit_gather,
    emit_gather_buffer,
    emit_gather_buffer_reference,
    emit_gather_reference,
)
from arroyo_tpu_torch.kernels.expand_gather import (
    expand_gather,
    expand_gather_buffer,
    expand_gather_reference,
    expand_views,
)
from arroyo_tpu_torch.kernels.join_expand import (
    join_expand,
    join_expand_buffer,
    join_expand_reference,
    pair_views,
)
from arroyo_tpu_torch.kernels.join_probe import join_probe, join_probe_reference
from arroyo_tpu_torch.kernels.join_sort import (
    ONE_BLOCK_MAX, join_sort, join_sort_reference)
from arroyo_tpu_torch.kernels.mesh_merge import (
    merge_views, mesh_merge, mesh_merge_reference)
from arroyo_tpu_torch.kernels.mesh_remap import (
    mesh_remap, mesh_remap_reference)
from arroyo_tpu_torch.kernels.mesh_route import (
    RULE_MESH, RULE_SHUFFLE, mesh_route, mesh_route_reference, route_views)
from arroyo_tpu_torch.kernels.pane_emit import (
    fire_geometry,
    pane_emit,
    pane_emit_reference,
    pane_views,
)
from arroyo_tpu_torch.kernels.ring_emit import (
    grouped_sums, ring_emit, ring_emit_reference)
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
    session_union_buffer,
    session_union_buffer_reference,
    session_union_reference,
    union_views,
)

F64_MAX = torch.finfo(torch.float64).max

# q5's one argmax fire at 2,000,000 events (a CPU run of its path):
# 119,938 occupied slots of 131,072, one live ring bin (column 0) in each
# of the first five of eight panes
Q5_ROWS = 119_938
Q5_RING = [[12, 13, 14, 15, 0], [13, 14, 15, 0, 1], [14, 15, 0, 1, 2],
           [15, 0, 1, 2, 3], [0, 1, 2, 3, 4]] + [[0] * 5] * 3
Q5_OK = [[w == 4 - p for w in range(5)] if p < 5 else [False] * 5
         for p in range(8)]

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
    cells = torch.tensor(pack_cells(idx[0], idx[1], packed[0], packed[1:]),
                         device=cuda_device)
    plan = channel_plan(kinds, dup)
    v_ref, c_ref = v.clone(), counts.clone()
    before = bin_update.launches
    bin_update(v, counts, cells, plan)
    bin_update_reference(v_ref, c_ref, cells, plan)
    torch.cuda.synchronize()
    assert bin_update.launches == before + 1
    assert torch.equal(counts, c_ref)
    for j, k in enumerate(kinds):
        if k in ("min", "max"):
            assert torch.equal(v[j], v_ref[j])
        else:
            torch.testing.assert_close(v[j], v_ref[j], rtol=1e-12, atol=1e-9)


# hot items' key capacity and ring at 40,000,000 events; the largest
# flush of q5 at 2,000,000 events and of hot items at 40,000,000 (cells
# per flush printed by chip_smoke.py's q5 and hot-items phases)
C_HOT, B_HOT = 4_194_304, 16
FLUSHES = [(131_072, 70_738), (C_HOT, 70_836)]


@pytest.mark.cuda
@pytest.mark.parametrize("C,m", FLUSHES)
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
def test_bin_update_cuda_at_flush_sizes(cuda_device, C, m, cdt):
    """A COUNT(*) flush as the state makes it — unique cells sorted by
    (slot, bin) — at the flush sizes of q5 and hot items: counts and the
    channel bit-equal to the plain version; one launch, no allocation
    and no host sync a call."""
    rng = np.random.default_rng(m)
    cells = np.sort(rng.choice(C * B_HOT, m, replace=False))
    buf = pack_cells(cells // B_HOT, cells % B_HOT,
                     rng.integers(1, 40, m).astype(np.float64),
                     np.zeros((0, m)))
    cells_t = torch.tensor(buf, device=cuda_device)
    plan = channel_plan(("count",), (0,))
    v = torch.zeros((1, C, B_HOT), dtype=torch.float64, device=cuda_device)
    counts = torch.zeros((C, B_HOT), dtype=cdt, device=cuda_device)
    v_ref, c_ref = v.clone(), counts.clone()
    before = bin_update.launches
    bin_update(v, counts, cells_t, plan)
    bin_update_reference(v_ref, c_ref, cells_t, plan)
    torch.cuda.synchronize()
    assert bin_update.launches == before + 1
    assert torch.equal(counts, c_ref) and torch.equal(v, v_ref)
    assert _allocs_and_syncs(lambda: bin_update(v, counts, cells_t,
                                                plan)) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
def test_bin_update_cuda_signed_minmax_and_warp_duplicates(cuda_device, cdt):
    """MIN/MAX over values of both signs and +/-0.0, in the cells and in
    the planes, with runs of one cell straddling warp boundaries (cells
    28-35 and 60-67 the same): counts and MIN/MAX bit-equal to the plain
    version (-0.0 below +0.0), sums within rtol 1e-12."""
    rng = np.random.default_rng(12)
    kinds, dup = ("count", "min", "max", "sum"), (0,)
    C, B, m = 64, 16, 4096
    slots = rng.integers(0, C, m)
    bins = rng.integers(0, B, m)
    for lo in range(28, m - 8, 32):
        slots[lo:lo + 8], bins[lo:lo + 8] = slots[lo], bins[lo]
    signed = np.array([0.0, -0.0, -1.5, 1.5, -1e300, 1e300, 4.0, -4.0])
    rows = rng.choice(signed, (4, m))
    rows[0] = rng.integers(0, 5, m)  # rowcounts, some padding
    rows[3] = rng.normal(size=m) * 1e3  # the sum: no cancelling extremes
    values = np.zeros((4, C, B))
    values[1:3] = rng.choice(signed, (2, C, B))
    v = torch.tensor(values, device=cuda_device)
    counts = torch.zeros((C, B), dtype=cdt, device=cuda_device)
    cells = torch.tensor(pack_cells(slots, bins, rows[0], rows[1:]),
                         device=cuda_device)
    plan = channel_plan(kinds, dup)
    v_ref, c_ref = v.clone(), counts.clone()
    bin_update(v, counts, cells, plan)
    bin_update_reference(v_ref, c_ref, cells, plan)
    torch.cuda.synchronize()
    assert torch.equal(counts, c_ref)
    for j in (1, 2):
        assert torch.equal(v[j].view(torch.int64), v_ref[j].view(torch.int64))
    torch.testing.assert_close(v[3], v_ref[3], rtol=1e-12, atol=1e-9)
    assert torch.equal(v[0], v_ref[0])  # small integer sums are exact


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




# (C, occupied rows, kpad, B, W) of the named fires past q5's
ARGMAX_CASES = {
    "recount": (1 << 21, 1 << 21, 8, 16, 5),
    "empty": (4096, 4000, 4, 16, 5),
    "overflow": (65_536, 60_000, 2, 16, 5),
    "ragged": (9_000, 8_191, 3, 16, 5),
    # 300 live panes of 512: two pane tiles a slot
    "tiles": (20_000, 19_000, 512, 16, 3),
    # 2,048 panes staged past 48 KiB of shared memory, eight tiles
    "panes_2048": (4096, 4000, 2048, 16, 5),
    # a 120-bin window's final fire: 122 panes, the last ones short
    "final_w120": (8_192, 8_000, 128, 128, 120),
    # panes too wide for shared memory: ring and ok read from global
    # memory, one tile, then eight
    "unstaged": (2_048, 2_000, 128, 512, 500),
    "unstaged_tiles": (1_024, 1_000, 2048, 64, 40),
}


def _argmax_case(rng, dev, case, cdt):
    """(counts, ring, ok, rows, capacity) of a named argmax fire: q5's
    real fire; a full 2^21-slot state whose blocks count their chunks
    again after the barrier; a fire with no candidate; ties past the
    capacity; a ragged occupied prefix; more than 256 live panes; 2,048
    panes; a 120-bin window's final fire; panes that do not fit in
    shared memory."""
    if case == "q5":
        C, rows, kpad, B, W = 131_072, Q5_ROWS, 8, 16, 5
        ring_np, ok_np = np.array(Q5_RING, np.int32), np.array(Q5_OK)
    else:
        C, rows, kpad, B, W = ARGMAX_CASES[case]
        ring_np = ((np.arange(kpad)[:, None] + np.arange(W)[None, :])
                   % B).astype(np.int32)
        ok_np = np.ones((kpad, W), dtype=bool)
        ok_np[0, :2] = False
        if case == "tiles":
            ok_np[300:] = False  # padded panes
        if case == "final_w120":
            ok_np = (np.arange(kpad)[:, None] + np.arange(W)[None, :]) <= 124
            ok_np[122:] = False
    cells = rng.poisson(2.0, (C, B))
    if case == "empty":
        cells[:] = 0
    elif case == "overflow":
        cells = np.minimum(cells, 1)  # ties by the thousand at count W
    cells[rows:] = 0  # the unoccupied slots of a state
    counts = torch.tensor(cells, dtype=cdt, device=dev)
    # the fires past q5's shapes hold every candidate (up to ~89,000)
    capacity = {"overflow": 100, "q5": 1024, "recount": 1024, "empty": 1024,
                "ragged": 1024}.get(case, 1 << 17)
    return (counts, torch.tensor(ring_np, device=dev),
            torch.tensor(ok_np, device=dev), rows, capacity)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["q5", *ARGMAX_CASES])
@pytest.mark.parametrize("minmax", ["max", "min"])
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
def test_argmax_fire_buffer_cuda(cuda_device, case, minmax, cdt):
    """The buffer form: one launch, one allocation and no host sync a
    call; its total and candidates equal the plain version's over the
    occupied rows and over all C, on consecutive calls (each finds the
    workspace as the last left it); past the capacity the total is whole
    and the first candidates are kept."""
    rng = np.random.default_rng(17)
    counts, ring, ok, rows, cap = _argmax_case(rng, cuda_device, case, cdt)
    want_all = argmax_fire_reference(counts, ring, ok, minmax)
    want = argmax_fire_buffer_reference(counts, ring, ok, rows, minmax, cap)
    total = int(want[0])
    assert total == want_all[0].shape[1]
    if case == "empty":
        assert total == 0
    if case == "overflow":
        assert total > cap
    for _ in range(3):
        before = argmax_fire.launches
        got = argmax_fire_buffer(counts, ring, ok, rows, minmax, cap)
        torch.cuda.synchronize()
        assert argmax_fire.launches == before + 1
        assert int(got[0]) == total
        for g, w in zip(argmax_views(got, total, cap, cdt),
                        argmax_views(want, total, cap, cdt)):
            assert torch.equal(g, w)
    n = min(total, cap)
    key, pane, cnt = argmax_views(got, total, cap, cdt)
    assert torch.equal(key, want_all[0][0, :n])
    assert torch.equal(pane, want_all[0][1, :n])
    assert torch.equal(cnt, want_all[1][:n])
    assert _allocs_and_syncs(lambda: argmax_fire_buffer(
        counts, ring, ok, rows, minmax, cap)) == (1, 0)


@pytest.mark.cuda
def test_argmax_fire_workspace_cuda(cuda_device):
    """Calls of several shapes in turn, on the current stream and on a
    second one: a fire of 2,048 panes grows the stream's workspace, a
    fire that does not fit in shared memory folds its extrema there, and
    every call equals the plain version."""
    rng = np.random.default_rng(23)
    cases = [_argmax_case(rng, cuda_device, c, torch.int32)
             for c in ("q5", "panes_2048", "unstaged", "tiles")]
    side = torch.cuda.Stream()
    for _ in range(2):
        for stream in (torch.cuda.current_stream(), side):
            with torch.cuda.stream(stream):
                for counts, ring, ok, rows, cap in cases:
                    for minmax in ("max", "min"):
                        got = argmax_fire_buffer(counts, ring, ok, rows,
                                                 minmax, cap)
                        want = argmax_fire_buffer_reference(
                            counts, ring, ok, rows, minmax, cap)
                        stream.synchronize()
                        total = int(want[0])
                        assert int(got[0]) == total
                        for g, w in zip(
                                argmax_views(got, total, cap, torch.int32),
                                argmax_views(want, total, cap, torch.int32)):
                            assert torch.equal(g, w)


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


def _merge_inputs(rng, dev, cap, n_res, m, nf, ni, layout="interleaved"):
    """A resident run of n_res entries (sentinel keys past it), a delta of
    m entries and its insert positions as the join state computes them:
    strictly increasing in [0, n_res + m) — spread over the run, all
    before the residents or all after them."""
    if layout == "before":
        dpos = np.arange(m)
    elif layout == "after":
        dpos = n_res + np.arange(m)
    else:
        dpos = np.sort(rng.choice(n_res + m, m, replace=False))
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    i32 = lambda n: rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)  # noqa: E731
    hi, lo = i32(cap), i32(cap)
    hi[n_res:], lo[n_res:] = 0x7FFFFFFF, -1
    stacks = (None,) * 4
    if nf or ni:
        stacks = (t(rng.normal(size=(nf, cap))),
                  t(rng.integers(-2**62, 2**62, (ni, cap))),
                  t(rng.normal(size=(nf, m))).reshape(nf, m),
                  t(rng.integers(-2**62, 2**62, (ni, m))).reshape(ni, m))
    return (t(hi), t(lo), stacks[0], stacks[1], n_res, t(i32(m)), t(i32(m)),
            stacks[2], stacks[3], t(dpos.astype(np.int64)))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_res,m,nf,ni,layout", [
    (65536, 39321, 13107, 0, 0, "interleaved"),  # q8's largest ring
    (65536, 39321, 13107, 2, 6, "interleaved"),
    (16384, 9830, 3276, 2, 6, "interleaved"),
    (8192, 5905, 520, 0, 3, "interleaved"),  # a join-stress merge
    (8192, 0, 520, 0, 3, "interleaved"),  # no residents
    (8192, 5905, 0, 0, 3, "interleaved"),  # no delta
    (8192, 5905, 520, 2, 6, "before"),
    (8192, 5905, 520, 2, 6, "after"),
    (8192, 7000, 1192, 2, 6, "interleaved"),  # n_res + m == cap
    (300, 100, 77, 1, 1, "interleaved")])  # cap not a multiple of a block
def test_ring_merge_cuda_matches_plain(cuda_device, cap, n_res, m, nf, ni,
                                       layout):
    """Bit-exact against the plain version, keys-only and with payload
    stacks; one launch, and the four planes views of one buffer."""
    rng = np.random.default_rng(cap + n_res + m + nf)
    args = _merge_inputs(rng, cuda_device, cap, n_res, m, nf, ni, layout)
    before = ring_merge.launches
    got = ring_merge(*args)
    want = ring_merge_reference(*args)
    torch.cuda.synchronize()
    assert ring_merge.launches == before + 1
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    assert len({g.untyped_storage().data_ptr() for g in got
                if g is not None}) == 1


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
                                      (1_048_576, 1), (192, 48), (1023, 70),
                                      (1024, 70), (1025, 70), (3000, 1)])
def test_session_union_cuda_matches_plain(cuda_device, n, n_keys):
    """Both forms exact against their plain versions — flags and running
    ends; session count, first rows and merged ends — at the one-block
    call's 1,024-row edge and across look-backs over up to 256 tiles,
    with one key spanning every tile.  One kernel launch a call, and the
    zero-fill of the look-back's status words only above one block."""
    rng = np.random.default_rng(n + n_keys)
    kh, st, en = (torch.tensor(a, device=cuda_device)
                  for a in _intervals(rng, n, n_keys))
    before = session_union.launches
    got = session_union(kh, st, en)
    want = session_union_reference(kh, st, en)
    torch.cuda.synchronize()
    assert session_union.launches == before + 1
    assert session_union.last_launches == (1 if n <= 1024 else 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    buf = session_union_buffer(kh, st, en)
    want_buf = session_union_buffer_reference(kh, st, en)
    torch.cuda.synchronize()
    assert session_union.launches == before + 2
    assert tuple(buf.shape) == (1 + 2 * n,)
    s, first, m_en = union_views(buf, n)
    want_s, want_first, want_en = union_views(want_buf, n)
    assert s == want_s == int(want[0].sum())
    assert torch.equal(first, want_first) and torch.equal(m_en, want_en)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 192, 256, 1024])
def test_session_union_cuda_one_tile_launch_allocations_syncs(cuda_device,
                                                               n):
    """Up to one tile (every config5 merge): one launch, one allocation
    and no host sync a call, in both forms."""
    rng = np.random.default_rng(n)
    kh, st, en = (torch.tensor(a, device=cuda_device)
                  for a in _intervals(rng, n, max(n // 4, 1)))
    for fn in (session_union, session_union_buffer):
        before = session_union.launches
        assert _allocs_and_syncs(lambda: fn(kh, st, en)) == (1, 0)
        assert session_union.launches == before + 2
        assert session_union.last_launches == 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empties", "many_empties"])
def test_segment_agg_cuda_empty_segments_are_infinite(cuda_device, case):
    """An empty segment's MIN is +inf and its MAX -inf (XLA's
    segment_min/segment_max of no rows), its SUM 0 and count 0, on the
    card as in the plain version; the other segments hold their rows'."""
    rng = np.random.default_rng(3)
    kinds = ("min", "max", "sum", "count")
    offs = _tile_layout(case)
    offsets, values = _segments(rng, offs[-1], len(offs) - 1, kinds,
                                cuda_device, offs)
    got, counts = segment_agg(values, offsets, kinds)
    want = segment_agg_reference(values, offsets, kinds)
    torch.cuda.synchronize()
    empty = counts == 0
    assert bool(empty.any()) and bool((~empty).any())
    assert bool((got[0][empty] == float("inf")).all())
    assert bool((got[1][empty] == float("-inf")).all())
    assert bool((got[2][empty] == 0).all())
    assert torch.isfinite(got[:2, ~empty]).all()
    for c in (0, 1, 3):
        assert torch.equal(got[c], want[0][c])


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


def _probe_case(rng, case):
    """(hi, q_hi, m, n_valid) for the inputs join_probe answers without a
    full search, or stages samples for: queries above the ring's last row
    (``past_last``), equal to it at the end of a run (``at_last``),
    padding only, an empty ring, several scan tiles, rings past the 8,192
    rows a block stages whole and a ring with few queries (every 2^k-th
    row staged)."""
    cap, n_valid, mq, m = {
        "past_last": (8192, 5905, 1024, 520), "at_last": (8192, 5905, 1024,
                                                          520),
        "all_padding": (8192, 5905, 1024, 0), "no_rows": (8192, 0, 1024, 520),
        "tiles": (8192, 8000, 4096, 3000),
        "sampled": (1 << 17, 100_000, 1024, 1000),
        "sampled_at_last": (1 << 17, 100_000, 1024, 1000),
        "sampled_full": (1 << 20, 1 << 20, 2048, 2000),
        "few_queries": (8192, 5905, 512, 3)}[case]
    hi = np.full(cap, 0x7FFFFFFF, np.int32)
    ring = np.sort(rng.integers(0, 2 * n_valid + 2, n_valid)).astype(np.int32)
    if case.endswith("at_last"):
        ring[-300:] = ring[-301]  # a run of 301 ends the ring
    hi[:n_valid] = ring
    q = rng.integers(0, 2 * n_valid + 2, m)
    if case == "past_last":
        q[: m // 3] = rng.integers(2 * n_valid + 2, 2**31 - 2, m // 3)
    elif case.endswith("at_last"):
        q[: m // 4] = ring[-1]
    q_hi = np.full(mq, 0x7FFFFFFF, np.int32)
    q_hi[:m] = np.sort(q)
    return hi, q_hi, m, n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["past_last", "at_last", "all_padding",
                                  "no_rows", "tiles", "sampled",
                                  "sampled_at_last", "sampled_full",
                                  "few_queries"])
def test_join_probe_cuda_shortcuts_match_plain(cuda_device, case):
    """join_probe bit-exact against its plain version where the kernel
    skips or shortens searches, over several tiles and over rings staged
    as samples; one launch a call below 1,024 queries, one allocation and
    no host sync a call."""
    rng = np.random.default_rng(len(case))
    hi, q_hi, m, n_valid = (torch.tensor(x, device=cuda_device)
                            if isinstance(x, np.ndarray) else x
                            for x in _probe_case(rng, case))
    before = join_probe.launches
    got = join_probe(q_hi, hi, m, n_valid)
    want = join_probe_reference(q_hi, hi, m, n_valid)
    torch.cuda.synchronize()
    assert join_probe.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert len({g.untyped_storage().data_ptr() for g in got}) == 1
    assert _allocs_and_syncs(lambda: join_probe(q_hi, hi, m, n_valid)) == (
        1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", ["below", "exact", "above", "zero"])
def test_expansion_buffers_cuda_capacity(cuda_device, capacity):
    """expand_gather_buffer and join_expand_buffer at a capacity below, at
    and above the pair total (and 0): the header holds the total the
    kernel read on the device, and the first min(total, capacity) pairs
    equal the plain version's; one allocation and no host sync a call."""
    rng = np.random.default_rng(7)
    t = lambda a: torch.tensor(a, device=cuda_device)  # noqa: E731
    hi, lo, q_hi, q_lo = map(t, _ring_and_queries(rng, 8192, 5905, 1024,
                                                  520, 6250))
    start, _counts, cum = join_probe(q_hi, hi, 520, 5905)
    total = int(cum[-1])
    cap = {"below": total // 2, "exact": total, "above": 2 * total + 3,
           "zero": 0}[capacity]
    n = min(total, cap)
    ist = t(rng.integers(-2**62, 2**62, (3, 8192)))
    fst = t(rng.normal(size=(2, 8192)))
    args = (hi, lo, q_hi, q_lo, fst, ist)
    buf = expand_gather_buffer(start, cum, cap, *args)
    pairs = join_expand_buffer(start, cum, cap)
    want = expand_gather_reference(start, cum, n, *args)
    torch.cuda.synchronize()
    assert int(buf[0]) == int(pairs[0]) == total
    for g, w in zip(expand_views(buf, n, 2, 3, cap), want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for g, w in zip(pair_views(pairs, n, cap), want[:2]):
        assert torch.equal(g, w)
    assert _allocs_and_syncs(
        lambda: expand_gather_buffer(start, cum, cap, *args)) == (1, 0)
    assert _allocs_and_syncs(
        lambda: join_expand_buffer(start, cum, cap)) == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("payload", [True, False])
def test_join_ring_paths_cuda_sync_once_a_probe(cuda_device, payload):
    """The hot join partition's ring paths on the card: staging and
    merging upload without a host sync; a probe with its expansion makes
    one (the buffer's readback), and two when the pair capacity is below
    the total; the rows equal those of the same ring on the CPU."""
    from arroyo_tpu_torch.ops import join as pj
    rng = np.random.default_rng(11 + payload)
    n, m, nq = 5905, 520, 520
    keys = np.sort(rng.integers(0, 2**40, n + m, dtype=np.uint64)
                   << np.uint64(20))
    ts = rng.integers(0, 10**9, n + m)
    cols = {"v": rng.integers(-2**62, 2**62, n + m)} if payload else None
    delta = np.sort(rng.choice(n + m, m, replace=False))
    res = np.setdiff1d(np.arange(n + m), delta)
    dpos = np.searchsorted(keys[res], keys[delta], side="right") + np.arange(m)
    q = np.sort(keys[rng.integers(0, n + m, nq)])
    rows = []
    for dev in (cuda_device, torch.device("cpu")):
        pick = lambda ix: ({c: v[ix] for c, v in cols.items()}  # noqa: E731
                           if payload else None)
        ring = pj.stage_ring(keys[res], dev, sorted_ts=ts[res],
                             sorted_cols=pick(res))
        merge = lambda: pj.merge_ring(ring, n, keys[delta], dpos,  # noqa: E731
                                      delta_ts=ts[delta],
                                      delta_cols=pick(delta))
        merged = merge()
        expand = pj.expand_gather if payload else pj.expand_hit
        probe = lambda cap=None: expand(  # noqa: E731
            merged, pj.probe_ring(merged, q, n + m), cap)
        got = probe()
        if dev.type == "cuda":
            assert _allocs_and_syncs(merge)[1] == 0
            assert _allocs_and_syncs(probe)[1] == 1
            assert _allocs_and_syncs(lambda: probe(len(got[0]) // 2))[1] == 2
        rows.append(got)
    for g, w in zip(*rows):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_keyed_bins_cuda_flush_and_compact_fire_upload_once(cuda_device,
                                                            monkeypatch):
    """KeyedBinState on the card: each flush is one upload from pinned
    memory and no host sync; the compact fire uploads its panes once; the
    fires equal a CPU state's on the same stream (MIN over +/-0.0 too)."""
    from arroyo_tpu_torch.graph.logical import AggKind, AggSpec
    from arroyo_tpu_torch.obs import perf
    from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState

    monkeypatch.setenv("ARROYO_EMIT_COMPACT", "on")
    aggs = (AggSpec(AggKind.COUNT, None, "n"),
            AggSpec(AggKind.MIN, "price", "lo"))
    card = KeyedBinState(aggs, 1_000, 3_000, capacity=4_096,
                         device=cuda_device)
    host = KeyedBinState(aggs, 1_000, 3_000, capacity=4_096, device="cpu")
    rng = np.random.default_rng(8)
    perf.reset()
    now, n = 20_000, 5_000

    def batch():
        keys = rng.integers(0, 3_000, n).astype(np.uint64)
        ts = (now + rng.integers(-2_500, 1_500, n)).astype(np.int64)
        return keys, ts, {"price": rng.choice([0.0, -0.0, -3.5, 3.5], n)}

    names = ("bin_flush_uploads", "bin_flush_blocking_uploads",
             "bin_compact_fire_uploads", "bin_compact_fire_blocking_uploads")
    compact = 0
    for i in range(6):
        b = batch()
        for _ in range(3 if i % 2 else 1):  # the card's flushes, one a run
            host.update(*b)
            host.flush_updates()
        before = [perf.counter(x) for x in names]
        card.update(*b)
        card.flush_updates()
        if i % 2:  # two more runs, each flushed alone: no host sync
            assert _allocs_and_syncs(lambda: (card.update(*b),
                                              card.flush_updates()))[1] == 0
        got = card.fire_panes(now - 3_000)
        delta = [perf.counter(x) - y for x, y in zip(names, before)]
        assert delta[:2] == [3 if i % 2 else 1, 0] and delta[3] == 0
        compact += delta[2]
        want = host.fire_panes(now - 3_000)
        assert (got is None) == (want is None)
        if got is not None:
            for x, y in ((got[0], want[0]), (got[2], want[2]),
                         (got[3], want[3])):
                np.testing.assert_array_equal(x, y)
            for name in got[1]:
                np.testing.assert_array_equal(
                    np.asarray(got[1][name]).view(np.int64),
                    np.asarray(want[1][name]).view(np.int64))
        now += 1_500
    assert compact > 0


@pytest.mark.cuda
def test_to_device_cuda_does_not_sync(cuda_device):
    """device.to_device: one non-blocking copy from pinned memory (no host
    sync), equal to the array, from a read-only array too."""
    from arroyo_tpu_torch.device import to_device
    arr = np.arange(100_000, dtype=np.int64).reshape(2, 50_000)
    arr.flags.writeable = False
    got = to_device(arr, cuda_device)
    assert got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), arr)
    assert _allocs_and_syncs(lambda: to_device(arr, cuda_device))[1] == 0


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
@pytest.mark.parametrize("total", [1, 512, 513, 2048, 2049, 5000])
@pytest.mark.parametrize("mq", [1024, 3000])
def test_join_expand_cuda_block_edges(cuda_device, total, mq):
    """Pair totals of 1, expand_gather's block of 512 pairs and one more,
    join_expand's block of 2,048 and one more, and many blocks, over
    queries whose counts include long runs of zeros; with
    3,000 queries a block stages its stretch of ``cum`` (found by the warp
    searches), or searches it in global memory when a run of 1,500
    queries without pairs makes it longer than 1,024: the buffer
    bit-equal to the plain version, at the exact capacity and above
    it."""
    rng = np.random.default_rng(total + mq)
    cap = 8192
    counts = np.zeros(mq, np.int64)
    # above 1,024 queries, none with a pair in [1000, 2500): a block
    # across that run searches global memory
    pool = np.r_[0:1000, 2500:mq] if mq > 1024 else np.arange(mq)
    hit = np.sort(rng.choice(pool, min(total, 40), replace=False))
    counts[hit] = rng.multinomial(total - len(hit), np.ones(len(hit))
                                  / len(hit)) + 1
    assert counts.sum() == total
    cum = torch.tensor(np.cumsum(counts), device=cuda_device)
    start = torch.tensor(np.minimum(rng.integers(0, cap, mq),
                                    cap - counts).astype(np.int32),
                         device=cuda_device)
    want = join_expand_reference(start, cum, total)
    before = join_expand.launches
    for capacity in (total, total + 700):
        buf = join_expand_buffer(start, cum, capacity)
        torch.cuda.synchronize()
        assert int(buf[0]) == total
        for g, w in zip(pair_views(buf, total, capacity), want):
            assert torch.equal(g, w)
    assert join_expand.launches == before + 2


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
@pytest.mark.parametrize("rows,k,B,cdt", [
    (3_000_000, 1, 16, torch.int32),  # hot items' compact fires
    (3_000_000, 5, 16, torch.int32),
    (1, 3, 16, torch.int32),
    (255, 1, 16, torch.int64),
    (257, 7, 8, torch.int32),
    (50_001, 3, 16, torch.int64),
    (20_000, 60, 256, torch.int64),  # a wide ring, 60 panes
])
def test_emit_count_cuda_one_launch(cuda_device, rows, k, B, cdt):
    """emit_count is one launch, one allocation and no host sync a call;
    cnt and offsets equal the plain version's, over one tile, ragged
    groups, thousands of tiles chained by the look-back and tiles that do
    not align with the 256-cell groups, and again on the next calls (new
    look-back epochs over the same status words)."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + k)
    C = rows + 100
    live = torch.rand((C, B), generator=g, device=cuda_device) < 0.06
    counts = torch.where(live, torch.randint(1, 9, (C, B), generator=g,
                                             device=cuda_device), 0).to(cdt)
    W = min(5, B)
    ring_np, ok_np = fire_geometry(B - 2, B - 1, B + k + W, W, k, B)
    ring = torch.tensor(ring_np, device=cuda_device)
    ok = torch.tensor(ok_np, device=cuda_device)
    want = emit_count_reference(counts, ring, ok, rows)
    for _ in range(3):
        before = emit_count.launches
        got = emit_count(counts, ring, ok, rows)
        torch.cuda.synchronize()
        assert emit_count.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _allocs_and_syncs(lambda: emit_count(counts, ring, ok,
                                                rows)) == (1, 0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("kinds,dup", [(("count",), (0,)),
                                       (("count", "sum", "min", "max"), (0,)),
                                       (("sum", "count", "max"), ())])
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows", [1, 255, 50_001])
def test_emit_gather_buffer_cuda(cuda_device, kinds, dup, cdt, rows):
    """The buffer form: one launch, one allocation and no host sync a
    call; its views equal the plain version's with and without transferred
    channels, over one group, a ragged last group and many skipped
    groups."""
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    C, B, W, k = rows + 77, 16, 5, 3
    dev = cuda_device
    plan = channel_plan(kinds, dup)
    values = torch.randn((len(kinds), C, B), generator=g,
                         dtype=torch.float64, device=dev)
    live = torch.rand((C, B), generator=g, device=dev) < 0.02
    counts = torch.where(live, torch.randint(1, 9, (C, B), generator=g,
                                             device=dev), 0).to(cdt)
    counts[0] = 1  # slot 0 is live in every pane
    ring_np, ok_np = fire_geometry(2, 3, 2 + k + W, W, k, B)
    ring = torch.tensor(ring_np, device=dev)
    ok = torch.tensor(ok_np, device=dev)
    cnt, offsets = emit_count(counts, ring, ok, rows)
    nnz = int(offsets[-1])
    assert nnz >= k
    want = compact_views(emit_gather_buffer_reference(
        values, cnt, ring, ok, plan, offsets, nnz), nnz, plan.n_xfer, cdt)
    before = emit_gather.launches
    got = compact_views(emit_gather_buffer(values, cnt, ring, ok, plan,
                                           offsets, nnz),
                        nnz, plan.n_xfer, cdt)
    torch.cuda.synchronize()
    assert emit_gather.launches == before + 1
    for x, y in zip(got[:3], want[:3]):
        assert torch.equal(x, y)
    for r, j in enumerate(j for j in range(len(kinds)) if j not in dup):
        if kinds[j] in ("min", "max"):
            assert torch.equal(got[3][r], want[3][r])
        else:
            torch.testing.assert_close(got[3][r], want[3][r], rtol=1e-12,
                                       atol=1e-9)
    assert _allocs_and_syncs(lambda: emit_gather_buffer(
        values, cnt, ring, ok, plan, offsets, nnz)) == (1, 0)


@pytest.mark.cuda
def test_keyed_bins_cuda_fires_read_back_once(cuda_device, monkeypatch):
    """KeyedBinState on the card: an argmax fire is one pinned upload, no
    blocking one and one readback (two, and one overflow, when its
    candidates pass the capacity); a compact fire syncs twice (its live
    total and its one readback); the rows equal a CPU state's."""
    from arroyo_tpu_torch.graph.logical import AggKind, AggSpec
    from arroyo_tpu_torch.obs import perf
    from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState

    rng = np.random.default_rng(21)
    aggs = (AggSpec(AggKind.COUNT, None, "n"),)
    names = ("bin_argmax_fire_uploads", "bin_argmax_fire_blocking_uploads",
             "bin_argmax_fire_readbacks", "bin_argmax_fire_overflows")
    monkeypatch.setenv("ARROYO_EMIT_COMPACT", "on")
    for mode in ("argmax", "compact"):
        states = [KeyedBinState(aggs, 1_000, 3_000, capacity=8_192,
                                device=d) for d in (cuda_device, "cpu")]
        if mode == "argmax":
            for st in states:
                st.set_argmax_local("n", "min")  # ties by the hundred
        now, fired, overflows = 20_000, 0, 0
        for i in range(6):
            keys = rng.integers(0, 6_000, 5_000)
            ts = (now + rng.integers(-2_500, 1_500, 5_000)).astype(np.int64)
            for st in states:
                st.update(keys.astype(np.uint64), ts, {})
                st.flush_updates()
            card = states[0]
            if mode == "argmax" and i == 3:
                card._argmax_cap = 1  # the fire's candidates overflow it
            if mode == "compact":
                geometry = fire_geometry(card.min_bin, card.min_bin,
                                         card.max_bin, card.W, 2, card.B)
                assert _allocs_and_syncs(
                    lambda: card._emit_compact(*geometry))[1] == 2
            cap = card._argmax_cap
            perf.reset()
            got = card.fire_panes(now - 3_000)
            ups, blocking, reads, over = (perf.counter(x) for x in names)
            if mode == "argmax":
                n = 0 if got is None else len(got[0])
                assert ups in (0, 1) and blocking == 0
                assert reads == ups + over
                assert over == (1 if n > cap else 0)
                fired += ups
                overflows += over
            want = states[1].fire_panes(now - 3_000)
            assert (got is None) == (want is None)
            if got is not None:
                for x, y in zip((got[0], got[2], got[3]),
                                (want[0], want[2], want[3])):
                    np.testing.assert_array_equal(x, y)
            now += 1_500
        assert mode == "compact" or (fired >= 3 and overflows >= 1)


# -- SQL expressions on the card (ops/expr.py CompiledExpr.__call__) ---------

EXPR_KINDS = {"i": "i", "j": "i", "k": "i", "f": "f", "g": "f", "oi": "i",
              "ob": "b", "tm": "i"}

# (expression, transcendental): the operators and DEVICE_FUNCTIONS the
# device path evaluates (tests/test_torch_sql_expr.py holds the CPU paths
# against the JAX package's)
EXPR_CORPUS = [
    ("i + j", False), ("i * 0.908", False), ("f + i", False),
    ("i / j", False), ("i % j", False), ("f / j", False), ("f % j", False),
    ("i / 2.5", False), ("100 / f", False), ("2.5 / (k + 1)", False),
    ("oi / j", False), ("oi * f", False),
    ("i = j", False), ("f >= i", False), ("i > 0 AND f > 0", False),
    ("i > 0 OR ob", False), ("NOT ob", False), ("i BETWEEN -10 AND 10", False),
    ("oi NOT IN (1, 2)", False),
    ("CASE WHEN i > 0 THEN 1 WHEN i < -20 THEN 2 ELSE 3 END", False),
    ("CASE WHEN f > 0 THEN f END", False),
    ("CASE j WHEN 0 THEN 10 WHEN 1 THEN 11 END", False),
    ("CAST(f AS BIGINT)", False), ("CAST(oi AS BIGINT)", False),
    ("CAST(i AS DOUBLE)", False), ("CAST(i AS BOOLEAN)", False),
    ("f IS NULL", False), ("oi IS NOT NULL", False), ("1 + 2", False),
    ("abs(f)", False), ("ceil(f)", False), ("round(f)", False),
    ("signum(f)", False), ("trunc(f)", False), ("sqrt(abs(f))", True),
    ("exp(g)", True), ("ln(abs(f))", True), ("sin(f)", True),
    ("atan2(f, i)", True), ("power(k, 0.5)", True), ("cbrt(f)", True),
    ("log(2, k + 1)", True), ("factorial(k)", False), ("gcd(i, j)", False),
    ("lcm(i, k)", False), ("nullif(f, 0.0)", False),
    ("coalesce(oi, f, 7)", False), ("date_trunc('hour', tm)", False),
    ("extract(dow FROM tm)", False), ("to_timestamp_millis(i)", False),
    ("date_bin(INTERVAL '15' MINUTE, tm, 60000000)", False),
]


def _expr_batch(n):
    from arroyo_tpu_torch.types import Batch

    rng = np.random.default_rng(99)
    f = rng.normal(0, 10, n)
    f[rng.random(n) < 0.15] = np.nan
    f[:2] = -0.0, 0.0
    cols = {"i": rng.integers(-50, 50, n), "j": rng.integers(-4, 5, n),
            "k": rng.integers(0, 25, n), "f": f,
            "g": rng.uniform(-0.99, 0.99, n),
            "oi": np.array([None if r < 0.2 else int(x) for r, x in zip(
                rng.random(n), rng.integers(-9, 9, n))], dtype=object),
            "ob": np.array([None if r < 0.25 else bool(x) for r, x in zip(
                rng.random(n), rng.integers(0, 2, n))], dtype=object),
            "tm": rng.integers(0, 10 * 86_400_000_000, n)}
    return Batch(np.arange(n, dtype=np.int64) * 1000, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("text,trans", EXPR_CORPUS,
                         ids=[e for e, _ in EXPR_CORPUS])
def test_sql_expression_on_the_card_matches_cpu(cuda_device, text, trans):
    """A SQL expression evaluated on the card (columns uploaded, torch ops
    there, results read back) gives the CPU's device path exactly
    (transcendental functions within rtol 1e-12, NaN in the same rows);
    each call counts as one device expression call."""
    from arroyo_tpu_torch.obs import perf
    from arroyo_tpu_torch.ops.expr import CompiledExpr, eval_record_expr
    from arroyo_tpu_torch.sql.compiler import Schema, compile_scalar
    from arroyo_tpu_torch.sql.parser import parse_sql
    from arroyo_tpu_torch.sql.planner import _wrap_record

    e = parse_sql(f"SELECT {text} AS x FROM t")[0].items[0].expr
    c = compile_scalar(e, Schema(columns=dict(EXPR_KINDS)))
    assert not c.needs_host
    fn = _wrap_record([("x", c)], [])
    batch = _expr_batch(4_097)
    perf.reset()
    got = eval_record_expr(CompiledExpr("x", fn, cuda_device), batch)
    assert perf.counter("expr_device_calls") == 1
    want = eval_record_expr(CompiledExpr("x", fn, torch.device("cpu")),
                            batch)
    a, b = want.columns["x"], got.columns["x"]
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        assert np.array_equal(np.isnan(a), np.isnan(b))
        if trans:
            np.testing.assert_allclose(b, a, rtol=1e-12, equal_nan=True)
        else:
            ok = ~np.isnan(a)
            u = f"u{a.itemsize}"
            assert np.array_equal(a[ok].view(u), b[ok].view(u))
    else:
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_sql_predicate_on_the_card_matches_cpu(cuda_device):
    from arroyo_tpu_torch.ops.expr import CompiledExpr, eval_predicate
    from arroyo_tpu_torch.sql.compiler import Schema, compile_scalar
    from arroyo_tpu_torch.sql.parser import parse_sql
    from arroyo_tpu_torch.sql.planner import _wrap_predicate

    batch = _expr_batch(1_000)
    for text in ("i > 0", "oi = 3", "ob", "i / j > 1", "1 = 1",
                 "CASE WHEN i > 0 THEN ob ELSE FALSE END"):
        e = parse_sql(f"SELECT * FROM t WHERE {text}")[0].where
        fn = _wrap_predicate(compile_scalar(e, Schema(
            columns=dict(EXPR_KINDS))))
        got = eval_predicate(CompiledExpr("p", fn, cuda_device), batch)
        want = eval_predicate(CompiledExpr("p", fn, torch.device("cpu")),
                              batch)
        assert got.dtype == np.bool_ and np.array_equal(got, want), text


# -- the buffered window and the updating aggregate on the card --------------------


def _agg_events(seed, n, n_keys, span, nulls):
    """Integer-valued f64 columns (exact f64 sums in any order), with
    NULLs (NaN) where ``nulls``."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, span, n)).astype(np.int64)
    v = rng.integers(1, 1_000, n).astype(np.float64)
    if nulls:
        v[rng.random(n) < 0.1] = np.nan
    return ts, {"k": rng.integers(0, n_keys, n).astype(np.int64), "v": v}


def _run_rows(build, pieces, device):
    """``build`` over a memory source of ``pieces`` on ``device``: sorted
    (timestamp, column values by name) rows."""
    from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
    from arroyo_tpu_torch.engine.engine import LocalRunner
    from arroyo_tpu_torch.graph.logical import Stream
    from arroyo_tpu_torch.types import Batch

    clear_sink("card-agg")
    src = Stream.source("memory", {"batches": [
        Batch(t.copy(), {c: v.copy() for c, v in cols.items()})
        for t, cols in pieces]}).watermark(max_lateness_micros=0)
    LocalRunner(build(src).sink("memory", {"name": "card-agg"}),
                device=device).run()
    rows = []
    for b in sink_output("card-agg"):
        names = sorted(b.columns)
        cols = [["NaN" if isinstance(x, float) and x != x else x
                 for x in b.columns[n].tolist()] for n in names]
        rows.extend(zip(b.timestamp.tolist(), *cols))
    return sorted(rows, key=repr)


def _agg_specs(kinds):
    from arroyo_tpu_torch.graph.logical import AggKind, AggSpec

    return [AggSpec(getattr(AggKind, k), None if k == "COUNT" else "v",
                    k.lower()) for k in kinds]


@pytest.mark.cuda
@pytest.mark.parametrize("typ", ["tumbling", "sliding"])
@pytest.mark.parametrize("nulls", [False, True])
def test_window_operator_cuda_matches_cpu(cuda_device, typ, nulls):
    """``WindowOperator`` on the card (its per-window reduce through the
    ``segment_agg`` kernel) emits the CPU run's rows exactly: 200,000
    rows over 5,000 keys and 8 s, COUNT, SUM, MIN, MAX, AVG and
    COUNT(DISTINCT)."""
    from arroyo_tpu_torch.graph.logical import SlidingWindow, TumblingWindow

    ts, cols = _agg_events(3, 200_000, 5_000, 8_000_000, nulls)
    cuts = np.linspace(0, len(ts), 9).astype(int)
    pieces = [(ts[a:b], {c: v[a:b] for c, v in cols.items()})
              for a, b in zip(cuts, cuts[1:])]
    window = (TumblingWindow(1_000_000) if typ == "tumbling"
              else SlidingWindow(2_000_000, 1_000_000))
    aggs = _agg_specs(("COUNT", "SUM", "MIN", "MAX", "AVG",
                       "COUNT_DISTINCT"))

    def build(s):
        return s.key_by("k").window(window, aggs)

    before = segment_agg.launches
    got = _run_rows(build, pieces, cuda_device)
    launched = segment_agg.launches - before
    want = _run_rows(build, pieces, "cpu")
    assert got and got == want
    assert launched >= (8 if typ == "tumbling" else 9)


@pytest.mark.cuda
@pytest.mark.parametrize("flush_key", [False, True])
def test_nonwindow_aggregate_cuda_matches_cpu(cuda_device, flush_key):
    """``NonWindowAggOperator`` on the card (one ``segment_agg`` launch a
    batch) emits the CPU run's rows exactly, as CREATE/UPDATE rows or,
    with ``flush_key``, each window's final row once."""
    ts, cols = _agg_events(5, 100_000, 2_000, 6_000_000, True)
    cols["window_end"] = (ts // 1_000_000 + 1) * 1_000_000
    cuts = np.linspace(0, len(ts), 7).astype(int)
    pieces = [(ts[a:b], {c: v[a:b] for c, v in cols.items()})
              for a, b in zip(cuts, cuts[1:])]
    aggs = _agg_specs(("COUNT", "SUM", "MIN", "MAX", "AVG"))

    def build(s):
        keys = ("window_end", "k") if flush_key else ("k",)
        return s.key_by(*keys).non_window_aggregate(
            86_400_000_000, aggs,
            flush_key="window_end" if flush_key else None)

    before = segment_agg.launches
    got = _run_rows(build, pieces, cuda_device)
    launched = segment_agg.launches - before
    want = _run_rows(build, pieces, "cpu")
    assert got and got == want
    assert launched >= 1


SENTINEL64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _u64_keys(rng, n, kind):
    """u64 join keys of one kind, the last seventh SENTINEL padding:
    hash-like (half at or above 2^63), a few varying digits, heavy
    duplicates, all equal, only the top digit varying, or straddling
    2^63 (the low digits and the top bit vary)."""
    m = n - n // 7
    k = np.full(n, SENTINEL64, np.uint64)
    if kind == "hash":
        k[:m] = rng.integers(0, 2**64 - 1, m, dtype=np.uint64)
    elif kind == "few_digits":
        k[:m] = (rng.integers(0, 256, m).astype(np.uint64)
                 << np.uint64(40)) | np.uint64(7)
    elif kind == "duplicates":
        k[:m] = rng.choice(rng.integers(0, 2**64 - 1, 30, dtype=np.uint64),
                           m)
    elif kind == "top_digit":
        k[:] = (rng.integers(0, 256, n).astype(np.uint64) << np.uint64(56)) \
            | np.uint64(0x0012345678ABCDEF)
    elif kind == "straddle":
        k[:m] = (np.uint64(2**63) - np.uint64(300)
                 + rng.integers(0, 600, m).astype(np.uint64))
    else:
        k[:] = np.uint64(2**63 + 5)
    return k, m


# the one-block path's edges (2,048: its 256-thread form; 8,192 its
# limit), the onesweep tile of 4,096 keys +/- 1 above it (20,480 = five
# tiles), 8a's largest bucket, an odd n and 2^20
SORT_NS = [1, 512, 2048, 2049, 4096, 4097, 8192, 8193, 16384, 20479, 20481,
           65536, 99_999, 1 << 20]
SORT_KINDS = ["hash", "few_digits", "duplicates", "equal", "top_digit",
              "straddle"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", SORT_NS)
@pytest.mark.parametrize("kind", SORT_KINDS)
def test_join_sort_cuda_matches_plain(cuda_device, n, kind):
    """``join_sort`` on the card: the order bit-equal to the plain
    version's and to numpy's stable argsort of the u64 keys (keys at and
    above 2^63, SENTINEL padding last), the keys in that order; views of
    one buffer."""
    rng = np.random.default_rng(n)
    k, _m = _u64_keys(rng, n, kind)
    kt = torch.tensor(k.view(np.int64), device=cuda_device)
    before = join_sort.launches
    order, keys = join_sort(kt)
    assert join_sort.launches - before == 1
    want = join_sort_reference(kt)
    assert torch.equal(order, want[0]) and torch.equal(keys, want[1])
    assert np.array_equal(order.cpu().numpy(), np.argsort(k, kind="stable"))
    assert order.untyped_storage().data_ptr() == \
        keys.untyped_storage().data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 8192, 8193, 1 << 20])
def test_join_sort_cuda_one_allocation_no_sync(cuda_device, n):
    """One allocation and no host sync a call, on both paths."""
    rng = np.random.default_rng(n + 1)
    k, _m = _u64_keys(rng, n, "hash")
    kt = torch.tensor(k.view(np.int64), device=cuda_device)
    assert _allocs_and_syncs(lambda: join_sort(kt)) == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, ONE_BLOCK_MAX, ONE_BLOCK_MAX + 1,
                               1 << 20])
def test_join_sort_cuda_device_launches(cuda_device, n):
    """Up to ONE_BLOCK_MAX keys a call is one device launch; above it a
    memset and 9 launches (torch.profiler's device activity)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(n + 2)
    k, _m = _u64_keys(rng, n, "few_digits")
    kt = torch.tensor(k.view(np.int64), device=cuda_device)
    join_sort(kt)
    torch.cuda.synchronize()
    for _ in range(3):  # now and then a profile records no device activity
        with warnings.catch_warnings():
            # the profiler warns that it clears its events at each cycle
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                join_sort(kt)
                torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert len(names) == (1 if n <= ONE_BLOCK_MAX else 10), names


@pytest.mark.cuda
def test_join_sort_cuda_back_to_back_calls(cuda_device):
    """50 calls of different sizes and kinds back to back on one stream,
    each result copied out and its buffer freed, so that later calls of
    the same size reuse memory whose look-back status words and tile
    counters an earlier call left set: every result equals the plain
    version's."""
    rng = np.random.default_rng(50)
    sizes = [8193, 20481, 65536, 40_000, 100_000, 16384, 5_000, 20481,
             65536, 8193]
    cases = []
    for i in range(50):
        k, _m = _u64_keys(rng, sizes[i % len(sizes)],
                          SORT_KINDS[i % len(SORT_KINDS)])
        cases.append(torch.tensor(k.view(np.int64), device=cuda_device))
    torch.cuda.synchronize()
    got = []
    for kt in cases:
        order, keys = join_sort(kt)
        got.append((order.clone(), keys.clone()))
        del order, keys
    torch.cuda.synchronize()
    for kt, (order, keys) in zip(cases, got):
        want = join_sort_reference(kt)
        assert torch.equal(order, want[0]) and torch.equal(keys, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nl,nr", [(512, 512), (5_000, 30_000),
                                   (200_000, 600_000)])
def test_join_probe_u64_cuda_matches_plain(cuda_device, nl, nr):
    """The u64 form of ``join_probe`` (sorted left keys against sorted
    right keys, both SENTINEL-padded to their buckets) equals its plain
    version output for output, and counts its launches apart."""
    rng = np.random.default_rng(nl)
    bl, br = 1 << (nl - 1).bit_length(), 1 << (nr - 1).bit_length()
    pool = rng.integers(0, 2**64 - 1, max(nl, nr) // 3 + 1, dtype=np.uint64)
    lk = np.full(bl, SENTINEL64, np.uint64)
    rk = np.full(br, SENTINEL64, np.uint64)
    lk[:nl] = np.sort(rng.choice(pool, nl))
    rk[:nr] = np.sort(rng.choice(pool, nr))
    q = torch.tensor(lk.view(np.int64), device=cuda_device)
    r = torch.tensor(rk.view(np.int64), device=cuda_device)
    before = join_probe.u64_launches
    got = join_probe(q, r, nl, nr)
    assert join_probe.u64_launches - before == 1
    want = join_probe_reference(q, r, nl, nr)
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))
    assert int(got[2][-1]) > 0


def _u64_probe_case(rng, case):
    """(queries, plane, m, n_valid) of one adversarial u64 probe, as
    numpy u64 arrays: sorted, SENTINEL past m and n_valid."""
    if case == "hot key":  # one key over half of a 2^20 plane
        n = 1 << 20
        hot = np.uint64(2**63 + 12_345)
        rk = np.sort(np.concatenate([
            np.full(n // 2, hot, np.uint64),
            rng.integers(0, 2**64 - 1, n // 2 - 4_096, dtype=np.uint64)]))
        lk = np.sort(np.concatenate([np.full(200_000, hot, np.uint64),
                                     rng.choice(rk, 700_000)]))
        mq, cap = n, n
    elif case == "8b probe":  # 8,192 queries against 400,000 rows
        rk = np.sort(rng.integers(0, 2**64 - 1, 400_000, dtype=np.uint64))
        lk = np.sort(rng.choice(rk, 8_000))
        mq, cap = 8_192, 524_288
    elif case == "all padding":
        rk = np.sort(rng.integers(0, 2**64 - 1, 3_000, dtype=np.uint64))
        lk = rk[:0]
        mq, cap = 5_000, 4_096
    elif case == "empty plane":
        lk = np.sort(rng.integers(0, 2**64 - 1, 3_000, dtype=np.uint64))
        rk = lk[:0]
        mq, cap = 4_096, 4_096
    elif case in ONE_KEY_WHOLE_PLANE:  # a tile's window is the plane
        m, n_valid = ONE_KEY_WHOLE_PLANE[case]
        key = rng.integers(0, 2**64 - 1, dtype=np.uint64)
        rk = np.sort(np.concatenate([
            np.full(3, key, np.uint64),
            rng.integers(0, 2**64 - 1, n_valid - 3, dtype=np.uint64)]))
        lk = (np.full(m, key, np.uint64) if m in (1, 100)
              else np.sort(rng.choice(rk, m)))
        mq, cap = m, 1 << (n_valid - 1).bit_length()
    else:  # keys straddling 2^63, SENTINEL among the real keys
        pool = np.concatenate([np.uint64(2**63) - np.uint64(40) + rng.integers(
            0, 80, 60).astype(np.uint64), [SENTINEL64]])
        rk = np.sort(rng.choice(pool, 30_000))
        lk = np.sort(rng.choice(pool, 9_000))
        mq, cap = 10_000, 32_768
    q = np.full(mq, SENTINEL64, np.uint64)
    h = np.full(cap, SENTINEL64, np.uint64)
    q[:len(lk)], h[:len(rk)] = lk, rk
    return q, h, len(lk), len(rk)


# (m, n_valid): probes whose tiles hold one key (or one real query) and
# whose window is the whole plane, which fits the staging budget
ONE_KEY_WHOLE_PLANE = {"one query against 2,047 rows": (1, 2_047),
                       "1,025 queries against 1,023 rows": (1_025, 1_023),
                       "100 equal keys against 3,000 rows": (100, 3_000)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hot key", "8b probe", "all padding",
                                  "empty plane", "keys at and above 2^63",
                                  *ONE_KEY_WHOLE_PLANE])
def test_join_probe_u64_cuda_adversarial_windows(cuda_device, case):
    """The u64 probe where a tile's window is not its share of the plane
    (a hot key, sparse queries: sampled windows), or there is none (all
    padding, an empty plane), or the keys straddle 2^63 with SENTINEL
    among them (padding at the plane's last row), or a tile holds one key
    or one real query while its window is the whole plane (no search
    bounds it: its queries still merge): bit-equal to the plain
    version."""
    rng = np.random.default_rng(len(case))
    q_np, h_np, m, n_valid = _u64_probe_case(rng, case)
    q = torch.tensor(q_np.view(np.int64), device=cuda_device)
    h = torch.tensor(h_np.view(np.int64), device=cuda_device)
    got = join_probe(q, h, m, n_valid)
    want = join_probe_reference(q, h, m, n_valid)
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("mq", [1_024, 1 << 20])
def test_join_probe_u64_cuda_launches_allocations_syncs(cuda_device, mq):
    """One wrapper launch, one allocation and no host sync a call (the
    device launches: test_device_launches_per_call_in_a_fresh_process)."""
    rng = np.random.default_rng(mq)
    keys = np.sort(rng.integers(0, 2**64 - 1, mq, dtype=np.uint64))
    q = torch.tensor(keys.view(np.int64), device=cuda_device)
    h = torch.tensor(np.sort(rng.choice(keys, mq)).view(np.int64),
                     device=cuda_device)

    def call():
        return join_probe(q, h, mq, mq)

    before = join_probe.u64_launches
    call()
    assert join_probe.u64_launches == before + 1
    assert _allocs_and_syncs(call) == (1, 0)


# Device launches a call, read by torch.profiler in a process of its own:
# late in a long test session its profiles now and then hold no device
# activity for seconds on end, while a fresh process records every launch.
_LAUNCH_SCRIPT = r"""
import json, sys, time, warnings
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from arroyo_tpu_torch.kernels.join_probe import join_probe
from arroyo_tpu_torch.kernels.ring_emit import ring_emit

warnings.simplefilter("ignore")
REPS = 10


def launches(fn):
    fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        if attempt >= 3:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        if names and len(names) % REPS == 0:
            break
    return names[:len(names) // REPS]


rng = np.random.default_rng(7)
out = {}
for mq, nv, cap in ((1_024, 1_000, 1_024), (1 << 20, 838_861, 1 << 20),
                    (8_192, 400_000, 524_288)):
    q = torch.tensor(np.sort(rng.integers(0, 2**64 - 1, mq,
                                          dtype=np.uint64)).view(np.int64),
                     device="cuda")
    h = torch.tensor(np.sort(rng.integers(0, 2**64 - 1, cap,
                                          dtype=np.uint64)).view(np.int64),
                     device="cuda")
    out[f"join_probe {mq}"] = launches(lambda: join_probe(q, h, mq, nv))
kinds = ("count", "sum", "sum", "min", "max")
v = torch.tensor(rng.normal(size=(5, 4096, 1024)), device="cuda")
c = torch.tensor(rng.integers(0, 50, (4096, 1024)), dtype=torch.int32,
                 device="cuda")
for k in (1, 64, 700):
    out[f"ring_emit {k}"] = launches(lambda: ring_emit(
        v, c, 3000, 3000, 3000 + k + 298, 300, k, kinds, (1, 2, 3, 4),
        4000))
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_device_launches_per_call_in_a_fresh_process(cuda_device):
    """On the device, per call: the u64 probe for one tile (1,024
    queries) is its kernel alone, for several tiles (2^20, and 8b's
    8,192 queries on 64-query tiles) a memset of the ticket and status
    words and its kernel; ring_emit is its kernel alone, with one group of
    panes (k = 1, 64) or three (k = 700)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    run = subprocess.run([sys.executable, "-c", _LAUNCH_SCRIPT, root],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    for case, names in got.items():
        if case.startswith("join_probe"):
            assert len(names) == (1 if case.endswith(" 1024") else 2), (
                case, names)
            assert "probe_u64" in names[-1], (case, names)
        else:
            assert len(names) == 1 and "ring_emit" in names[0], (case, names)


@pytest.mark.cuda
@pytest.mark.parametrize("nl,nr", [(3_000, 7_000), (100_000, 300_000)])
def test_join_pairs_cuda_matches_host(cuda_device, nl, nr, monkeypatch):
    """The legacy layout's ``join_pairs`` on the card (sort x2, the u64
    probe and the expansion, read back in one synchronization) returns
    the host branch's five outputs; a capacity overflow (a Zipf head key)
    expands once more."""
    from arroyo_tpu_torch.obs import perf
    from arroyo_tpu_torch.ops.join import _bucket, join_pairs

    rng = np.random.default_rng(nl)
    pool = rng.integers(0, 2**64 - 1, nl, dtype=np.uint64)
    lk = rng.choice(pool, nl)
    rk = rng.choice(pool, nr)
    lk[: nl // 50] = pool[0]  # a head key: its pairs pass the capacity
    rk[: nr // 50] = pool[0]
    monkeypatch.setenv("ARROYO_DEVICE_JOIN", "off")
    want = join_pairs(lk, rk, torch.device("cpu"))
    over = int(len(want[2]) > max(_bucket(nl), _bucket(nr)))
    assert over
    monkeypatch.setenv("ARROYO_DEVICE_JOIN", "auto")
    perf.reset()
    got = join_pairs(lk, rk, cuda_device)
    assert perf.counter("join_pairs_device") == 1
    assert perf.counter("join_pairs_overflows") == over
    assert perf.counter("join_pairs_readbacks") == 1 + over
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))


@pytest.mark.cuda
def test_factored_windows_cuda_match_cpu(cuda_device, monkeypatch):
    """bench.py's correlated windows at K = 2 (HOP 10 s and 4 s, 2 s
    slide), factored onto one shared pane ring: the card's rows equal the
    CPU run's exactly, through ``bin_update`` for the factor's events and
    the derived rings' fired panes, and ``bin_evict`` for the fires."""
    from arroyo_tpu_torch import queries
    from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
    from arroyo_tpu_torch.engine.engine import LocalRunner
    from arroyo_tpu_torch.sql import plan_sql

    monkeypatch.setenv("ARROYO_FACTOR_WINDOWS", "auto")
    text = queries.SRC.format(n=400_000, b=8_192).replace(
        "batch_size = '8192'", "batch_size = '8192', base_time_micros = '0'")
    for i, w in enumerate((10, 4)):
        text += (
            f"CREATE TABLE cw{i} (auction BIGINT, window_end BIGINT, num "
            f"BIGINT, tot BIGINT) WITH (connector = 'memory', name = "
            f"'cw{i}', type = 'sink');\nINSERT INTO cw{i} SELECT "
            f"bid.auction as auction, HOP(INTERVAL '2' SECOND, INTERVAL "
            f"'{w}' SECOND) as window, count(*) AS num, sum(bid.price) AS "
            f"tot FROM nexmark WHERE bid is not null GROUP BY 1, 2;\n")

    def run(device):
        prog = plan_sql(text)
        assert sum(n.operator.kind.value == "derived_window"
                   for n in prog.nodes()) == 2
        for i in range(2):
            clear_sink(f"cw{i}")
        LocalRunner(prog, device=device).run()
        return [sorted((int(b.timestamp[j]), int(b.columns["auction"][j]),
                        int(b.columns["num"][j]), int(b.columns["tot"][j]))
                       for b in sink_output(f"cw{i}") for j in range(len(b)))
                for i in range(2)]

    before = (bin_update.launches, bin_evict.launches)
    got = run(cuda_device)
    launched = (bin_update.launches - before[0],
                bin_evict.launches - before[1])
    want = run("cpu")
    assert all(want) and got == want
    assert launched[0] > 0 and launched[1] > 0


@pytest.mark.cuda
def test_config5_filesystem_cut_and_restore_cuda(cuda_device, tmp_path):
    """tests/test_torch_connectors.py's config5 cut on the card: epochs 1
    and 2 committed, epoch 3 sealed and cut before its commit, restored
    from epoch 3; the promoted parts hold the CPU run's rows, each once,
    and no part stays staged.  The session union and the segment reduce
    run their kernels."""
    import asyncio
    import json
    import os

    from arroyo_tpu_torch.config5 import config5_produce, config5_sql
    from arroyo_tpu_torch.engine.drills import cut_before_commit
    from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
    from arroyo_tpu_torch.kernels.segment_agg import segment_agg
    from arroyo_tpu_torch.kernels.session_union import session_union
    from arroyo_tpu_torch.sql import plan_sql, register_udaf, unregister_udfs
    from arroyo_tpu_torch.types import StopMode

    def sql(root):
        return config5_sql(20_000, 1_024, "c5-cuda", "json", (
            f"CREATE TABLE out WITH (connector = 'filesystem', path = "
            f"'file://{root}', format = 'json', type = 'sink');"))

    def rows(root):
        out, staged = [], []
        for dirpath, _, names in os.walk(root):
            for n in names:
                path = os.path.join(dirpath, n)
                if ".staging" in path:
                    staged.append(n)
                    continue
                with open(path) as f:
                    out += [tuple(json.loads(line).values()) for line in f]
        return sorted(out), staged

    unregister_udfs()
    register_udaf("median", np.median)
    try:
        config5_produce("c5-cuda", 20_000, 0, 1_000)
        cut = str(tmp_path / "cut")
        before = (session_union.launches, segment_agg.launches)
        epoch = asyncio.run(cut_before_commit(
            lambda: Engine(plan_sql(sql(cut)), "c5-cuda-cut",
                           device=cuda_device),
            (4, 8, 12, 13), StopMode.IMMEDIATE))
        assert rows(cut)[1]  # epoch 3's part is staged, not promoted
        LocalRunner(plan_sql(sql(cut)), job_id="c5-cuda-cut",
                    device=cuda_device, restore_epoch=epoch).run()
        launched = (session_union.launches - before[0],
                    segment_agg.launches - before[1])
        straight = str(tmp_path / "straight")
        LocalRunner(plan_sql(sql(straight)), device="cpu").run()
    finally:
        unregister_udfs()
    got, staged = rows(cut)
    want, _ = rows(straight)
    assert got == want and len(set(got)) == len(got) == 256
    assert not staged and launched[0] > 0 and launched[1] > 0


# -- ring_emit: the long-window fire ------------------------------------------

RING_KINDS = ("count", "sum", "sum", "min", "max", "sum", "sum")
RING_XFER = (1, 2, 3, 4, 5, 6)  # channel 0 is a COUNT(*): the counts plane


def _ring_case(values, counts, geometry, kinds, xfer, rows, cdt):
    """The kernel's buffer against the plain version run on CPU copies:
    counts, min and max exact, NaN and signed zeros included; f64 sums
    (the kernel's grouping, a sequential cumsum in the plain version)
    within 1e-12 of the rows' absolute mass, and bit-equal to
    ``grouped_sums``, the kernel's grouping in plain PyTorch."""
    first_bin, lo, hi, W, k = geometry
    args = (first_bin, lo, hi, W, k, kinds, xfer, rows)
    before = ring_emit.launches
    buf = ring_emit(values, counts, *args)
    torch.cuda.synchronize()
    assert ring_emit.launches == before + 1
    n_f = 8 * len(xfer) * rows * k
    outs = buf[:n_f].view(torch.float64).view(len(xfer), rows, k).cpu()
    want_o, want_c = ring_emit_reference(
        values.cpu(), None if counts is None else counts.cpu(), *args)
    if counts is not None:
        cnts = buf[n_f:].view(cdt).view(rows, k).cpu()
        assert cnts.dtype == counts.dtype and torch.equal(cnts, want_c)
    mass = values.abs().nan_to_num(0.0).sum(-1).max().item()
    for r, j in enumerate(xfer):
        if kinds[j] in ("min", "max"):
            torch.testing.assert_close(outs[r], want_o[r], rtol=0, atol=0,
                                       equal_nan=True)
            assert torch.equal(torch.signbit(outs[r]),
                               torch.signbit(want_o[r]))
        else:
            torch.testing.assert_close(outs[r], want_o[r], rtol=0,
                                       atol=1e-12 * mass)
            bins = first_bin + torch.arange(k + W - 1)
            live = (bins >= lo) & (bins <= hi)
            g = torch.where(live, values[j, :rows].cpu()[
                :, bins % values.shape[2]], 0.0)
            assert torch.equal(outs[r], grouped_sums(g, W, k))


@pytest.mark.cuda
@pytest.mark.parametrize("first_bin,lo,hi,W,k", [
    (1024 * 3 + 900, 1024 * 3 + 900, 1024 * 4 + 199, 300, 1),  # steady
    (1024 * 3 + 900, 1024 * 3 + 920, 1024 * 4 + 240, 300, 64),  # wraps
    (-299, 0, 40, 300, 1),  # the first fire: negative bins, 41 live
    (1024 * 5, 1024 * 5 + 10, 1024 * 5 + 400, 300, 700),  # final flush
    (7, 9, 12, 300, 3),  # past the newest bin
    (100, 300, 299, 5, 8),  # no live bin
    (1024 * 2 + 5, 1024 * 2 + 5, 1024 * 2 + 30, 1, 26),  # W = 1
    (1024 * 6 + 1000, 1024 * 6 + 1003, 1024 * 6 + 1030, 37, 5),  # W = 37
    (1024 * 4 + 12, 1024 * 4 + 16, 1024 * 4 + 16, 5, 5),  # q5's: one live
    (1024 + 1020, 1024 + 1021, 1024 * 2 + 40, 64, 40),  # W = 64, wrapping
    (1024 + 1000, 1024 + 1001, 1024 * 2 + 60, 65, 70),  # W = 65: groups
])
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
def test_ring_emit_cuda_matches_plain(cuda_device, first_bin, lo, hi, W, k,
                                      cdt):
    """HOP(1 s, 300 s) fires over a ring of B = 1,024 bins: the steady
    fire (k = 1), a 64-pane fire whose span wraps the ring, the first
    fire, a final flush of 700 panes (k > W, so several groups), panes
    past the newest bin, no live bin, W = 1, W = 37 (no multiple of 32)
    wrapping with dead positions at both ends (W = 1, 5 and 37 fold a
    pane a thread), q5's W = 5 fire with one live bin, W = 64 (the widest
    folded by a thread) wrapping, and W = 65 (the narrowest in groups)
    with k > W + 1."""
    rng = np.random.default_rng(W + k)
    C, B, rows = 2048, 1024, 1500
    values, counts = _planes(rng, cuda_device, RING_KINDS, C, B, cdt)
    _ring_case(values, counts, (first_bin, lo, hi, W, k), RING_KINDS,
               RING_XFER, rows, cdt)


@pytest.mark.cuda
def test_ring_emit_cuda_signed_zeros_nan_and_no_counts(cuda_device):
    """MIN/MAX over +/-0.0, +/-inf and NaN in XLA's order (NaN wins, -0.0
    below +0.0), exact; the counts part left out (``counts=None``, the
    1-D and 2-D aggregates' form)."""
    rng = np.random.default_rng(21)
    kinds = ("min", "max", "sum")
    v = rng.choice([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf], (3, 512, 128))
    v[rng.random(v.shape) < 0.01] = np.nan
    v[2] = rng.integers(-9, 9, (512, 128))
    values = torch.tensor(v, device=cuda_device)
    for W, k in ((1, 128), (7, 100), (33, 96), (128, 1)):
        _ring_case(values, None, (1 - W, 0, 127, W, k), kinds, (0, 1, 2),
                   512, None)


@pytest.mark.cuda
def test_ring_emit_cuda_one_allocation_no_sync(cuda_device):
    rng = np.random.default_rng(23)
    values, counts = _planes(rng, cuda_device, RING_KINDS, 4096, 1024,
                             torch.int32)
    def call():
        return ring_emit(values, counts, 3000, 3000, 3299, 300, 1,
                         RING_KINDS, RING_XFER, 4000)

    assert _allocs_and_syncs(call) == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 64, 700])
def test_ring_emit_cuda_launches_allocations_syncs(cuda_device, k):
    """One wrapper launch, one allocation and no host sync a call, one
    group of panes (k = 1, 64) or three (k = 700; the device launches:
    test_device_launches_per_call_in_a_fresh_process)."""
    rng = np.random.default_rng(k)
    values, counts = _planes(rng, cuda_device, RING_KINDS, 4096, 1024,
                             torch.int32)

    def call():
        return ring_emit(values, counts, 3000, 3000, 3000 + k + 298, 300, k,
                         RING_KINDS, RING_XFER, 4000)

    before = ring_emit.launches
    call()
    assert ring_emit.launches == before + 1
    assert _allocs_and_syncs(call) == (1, 0)


@pytest.mark.cuda
def test_ring_pane_aggregate_cuda_matches_cpu(cuda_device):
    """The 1-D and 2-D aggregates swept on the card equal the CPU's: a
    tensor stays on the card, a numpy array goes there and comes back."""
    from arroyo_tpu_torch.parallel.ring_panes import (
        ring_pane_aggregate, ring_pane_aggregate_2d)

    rng = np.random.default_rng(29)
    bins = rng.integers(-50, 100, (6, 256)).astype(np.float64)
    for kind in ("sum", "count", "min", "max"):
        for W in (1, 33, 256):
            want = ring_pane_aggregate_2d(bins, W, kind, 8, device="cpu")
            got = ring_pane_aggregate_2d(torch.tensor(bins,
                                                      device=cuda_device),
                                         W, kind, 8)
            assert got.device.type == "cuda"
            np.testing.assert_array_equal(got.cpu().numpy(), want)
            np.testing.assert_array_equal(
                ring_pane_aggregate(bins[0], W, kind, 4), want[0])


@pytest.mark.cuda
def test_keyed_bins_cuda_ring_fires_match_cpu(cuda_device, monkeypatch):
    """KeyedBinState under ``ARROYO_RING=on`` on the card: every fire one
    ``ring_emit`` launch and no other fire kernel, the fires equal the
    CPU state's, with eviction over 700 s of a 300 s window."""
    from arroyo_tpu_torch.graph.logical import AggKind, AggSpec
    from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState

    monkeypatch.setenv("ARROYO_RING", "on")
    aggs = (AggSpec(AggKind.COUNT, None, "n"),
            AggSpec(AggKind.SUM, "p", "s"), AggSpec(AggKind.MAX, "p", "m"))
    sec = 1_000_000
    card = KeyedBinState(aggs, sec, 300 * sec, capacity=1024)
    host = KeyedBinState(aggs, sec, 300 * sec, capacity=1024, device="cpu")
    rng = np.random.default_rng(31)
    before = (ring_emit.launches, pane_emit.launches, emit_count.launches,
              argmax_fire.launches)
    fires = 0
    for i in range(14):
        n = 4000
        keys = rng.integers(0, 3000, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        ts = (i * 50 + rng.integers(0, 50, n)) * sec
        p = rng.integers(1, 10_000, n).astype(np.float64)
        p[rng.random(n) < 0.1] = np.nan
        outs = []
        for st in (card, host):
            st.update(keys, ts.astype(np.int64), {"p": p})
            outs.append(st.fire_panes((i + 1) * 50 * sec))
        a, b = outs
        assert (a is None) == (b is None)
        if a is not None:
            fires += 1
            for x, y in zip(a[:1] + a[2:], b[:1] + b[2:]):
                np.testing.assert_array_equal(x, y)
            for c in a[1]:
                np.testing.assert_array_equal(a[1][c], b[1][c])
    assert fires >= 12 and card.min_bin > 300
    assert ring_emit.launches - before[0] == fires
    assert (pane_emit.launches, emit_count.launches,
            argmax_fire.launches) == before[1:]


# -- the keyed mesh: mesh_route, mesh_merge, mesh_remap ----------------------

U64_MAX = (1 << 64) - 1


def _boundary_keys(nk):
    """Keys at both destination rules' range edges: k * (U64_MAX // nk)
    and k * 2**(64 - lg), each -1, 0, +1."""
    lg = nk.bit_length() - 1
    out = []
    for k in range(nk + 1):
        for base in (k * (U64_MAX // nk), k << (64 - lg)):
            out += [(base + d) & U64_MAX for d in (-1, 0, 1)]
    return out


def _route_rows(rng, N, m, nk, case, stack=3):
    keys = rng.integers(0, 2**64 - 1, N, dtype=np.uint64)
    if case == "one shard":
        keys = (keys >> np.uint64(4)) | np.uint64(0xF << 60)
    elif case == "boundary":
        b = np.array(_boundary_keys(nk), dtype=np.uint64)
        keys = b[rng.integers(0, len(b), N)]
    rows = np.zeros((2 + stack, N), np.int64)
    rows[0] = -1
    rows[0, :m] = keys[:m].view(np.int64)
    rows[1, :m] = 1
    rows[2:, :m] = rng.integers(-2**62, 2**62, (stack, m))
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [1, 2, 4, 8])
@pytest.mark.parametrize("rule", [RULE_MESH, RULE_SHUFFLE])
@pytest.mark.parametrize("case", ["hash", "one shard", "boundary",
                                  "padding"])
def test_mesh_route_cuda_matches_plain(cuda_device, nk, rule, case):
    """Buckets and drop counter bit-equal to the plain version, at a slice
    of several tiles and one of less than a tile."""
    rng = np.random.default_rng(nk * 10 + rule)
    for N in (300, 20_000):
        m = 0 if case == "padding" else N - N // 7
        rows = torch.tensor(_route_rows(rng, N, m, nk, case),
                            device=cuda_device)
        counter = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        before = mesh_route.launches
        buf = mesh_route(rows, nk, rule, shift=3 if rule == RULE_MESH else 0,
                         counter=counter)
        assert mesh_route.launches == before + 1
        out, drop = route_views(buf, rows.shape[0], nk, N)
        want, dropped = mesh_route_reference(
            rows, nk, rule, 3 if rule == RULE_MESH else 0)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert int(counter.item()) == dropped == 0 and int(drop.item()) == 0


def _merge_inputs(rng, C, n_old, R, n_new_pool, dev, n_ch=2):
    pool = np.unique(rng.integers(0, 2**64 - 2, n_old + n_new_pool,
                                  dtype=np.uint64))
    rng.shuffle(pool)
    old_keys = np.sort(pool[:n_old])
    old = np.full(C, U64_MAX, np.uint64)
    old[:n_old] = old_keys
    m = R - R // 5
    inc_keys = np.full(R, U64_MAX, np.uint64)
    inc_keys[:m] = rng.choice(pool, m)
    inc = np.zeros((4 + n_ch, R), np.int64)
    inc[0] = inc_keys.view(np.int64)
    inc[1, :m] = 1
    inc[2, :m] = rng.integers(0, 16, m)
    inc[3:, :m] = rng.normal(size=(1 + n_ch, m)).view(np.int64)
    t_old = torch.tensor(old.view(np.int64), device=dev)
    t_inc = torch.tensor(inc, device=dev)
    order, keys_sorted = join_sort_reference(t_inc[0].cpu())
    return t_old, keys_sorted.to(dev), order.to(dev), t_inc


@pytest.mark.cuda
@pytest.mark.parametrize("C,n_old,R,pool", [
    (256, 100, 512, 80),          # a small merge, one tile each
    (8192, 3000, 40_000, 4000),   # several tiles of routed keys
    (256, 250, 512, 300),         # new keys past C: cut and counted
    (1024, 0, 4096, 500),         # an empty table
])
def test_mesh_merge_cuda_matches_plain(cuda_device, C, n_old, R, pool):
    rng = np.random.default_rng(C + R)
    old, keys, order, inc = _merge_inputs(rng, C, n_old, R, pool,
                                          cuda_device)
    counter = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    before = mesh_merge.launches
    buf = mesh_merge(old, keys, order, inc, counter=counter)
    assert mesh_merge.launches == before + 1
    got = merge_views(buf, C, R, inc.shape[0] - 4)
    want = mesh_merge_reference(old.cpu(), keys.cpu(), order.cpu(),
                                inc.cpu())
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g.cpu(), w)
    assert int(counter.item()) == want[3]


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
@pytest.mark.parametrize("what", ["merge map", "roll", "rebase", "grow"])
def test_mesh_remap_cuda_matches_plain(cuda_device, cdt, what):
    rng = np.random.default_rng(5)
    kinds = ("count", "sum", "min", "max")
    C, B = 2048, 16
    values = torch.tensor(rng.normal(size=(4, C, B)), device=cuda_device)
    counts = torch.tensor(rng.integers(0, 50, (C, B)), dtype=cdt,
                          device=cuda_device)
    src, shift, C_out, B_out = None, 0, C, B
    if what == "merge map":
        src = torch.tensor(np.where(rng.random(C) < 0.3, -1,
                                    rng.permutation(C)), device=cuda_device)
    elif what == "roll":
        shift = 5
    elif what == "rebase":
        shift, B_out = -3, 32
    else:
        C_out = 2 * C
    before = mesh_remap.launches
    v, c = mesh_remap(values, counts, src, shift, C_out, B_out, kinds)
    assert mesh_remap.launches == before + 1
    wv, wc = mesh_remap_reference(values.cpu(), counts.cpu(),
                                  None if src is None else src.cpu(), shift,
                                  C_out, B_out, kinds)
    torch.cuda.synchronize()
    assert torch.equal(v.cpu(), wv) and torch.equal(c.cpu(), wc)
    assert c.dtype == cdt


@pytest.mark.cuda
def test_mesh_state_cuda_matches_cpu(cuda_device):
    """Four logical shards of one card against four on the CPU: every
    fire, the overflow counters and the snapshot equal, the three mesh
    kernels launched."""
    from arroyo_tpu_torch.graph.logical import AggKind, AggSpec
    from arroyo_tpu_torch.parallel.mesh_window import MeshKeyedBinState

    aggs = (AggSpec(AggKind.COUNT, None, "cnt"),
            AggSpec(AggKind.SUM, "v", "total"),
            AggSpec(AggKind.MIN, "v", "lo"), AggSpec(AggKind.MAX, "v", "hi"))
    sec = 1_000_000
    states = [MeshKeyedBinState(aggs, sec, 2 * sec, capacity=256,
                                n_shards=4, device=(dev,) * 4)
              for dev in ("cuda", "cpu")]
    rng = np.random.default_rng(8)
    before = (mesh_route.launches, mesh_merge.launches, mesh_remap.launches)
    for i in range(6):
        n = 3000
        kh = rng.integers(0, 2000, n).astype(np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        ts = np.sort(i * 2 * sec + rng.integers(0, 2 * sec, n))
        v = rng.integers(-50, 50, n).astype(np.float64)
        fires = []
        for st in states:
            st.update(kh, ts.astype(np.int64), {"v": v})
            fires.append(st.fire_panes(int(ts[-1])))
        a, b = fires
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a[:1] + a[2:], b[:1] + b[2:]):
                np.testing.assert_array_equal(x, y)
            for c in a[1]:
                np.testing.assert_array_equal(a[1][c], b[1][c])
    snaps = [st.snapshot() for st in states]
    for k in snaps[1]:
        np.testing.assert_array_equal(snaps[0][k], snaps[1][k], err_msg=k)
    assert states[0].overflow_counters() == (0, 0)
    assert all(now > was for now, was in zip(
        (mesh_route.launches, mesh_merge.launches, mesh_remap.launches),
        before))
