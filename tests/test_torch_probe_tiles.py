"""The tile co-ranking of the port's u64 ``join_probe`` kernel, on the CPU.

The CUDA kernel (arroyo_tpu_torch/csrc/join_probe.cu ``probe_u64``) gives
each block a tile of consecutive sorted queries and CUDA has no CPU mode,
so this file writes the kernel's steps again in plain Python, branch for
branch: the tile's plane window (the whole plane when it fits the
staging budget, else ``[lower_bound(first query), upper_bound(last real
query))`` by the first warp's two 16-way half-warp searches); a tile of
one key answered by its window alone when the window was searched; each
thread's consecutive queries merged into the staged window (the first
from where an even spread of the window would put it, each next one
stepping on from the last upper bound, an equal query repeating the last
answer); past the budget every 2^shift-th row staged and each search
finished in global memory inside the window (the tile's first and last
real keys taking its ends); padding queries at or below the plane's last
row; and the counts' prefix sum by the look-back's 32 x 2-word rounds
over tiles that publish in any order.  The outputs are held against
``join_probe_reference`` and the JAX package's ``_probe_kernel``
(arroyo_tpu/ops/join.py:76) in both its forms (``searchsorted`` and the
merged-rank one), on inputs made from a numpy seed: one key over half
the plane, sparse queries over a large plane, all padding, an empty
plane, m < mq, keys at and above 2^63, and tiles of one key or one real
query whose window is the whole plane."""

import bisect as pybisect

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from arroyo_tpu.ops import join as jax_join
from arroyo_tpu_torch.kernels.join_probe import (join_probe_reference,
                                                 u64_stage_rows, u64_tile)

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
LANES = 32
HALF = 16  # probes a half-warp makes a window-search round
LOOK_DEPTH = 2  # status words a lane reads a look-back round
# the kernel's (threads, queries a thread) for each of its tiles
SHAPES = {64: (64, 1), 1_024: (256, 4), 2_048: (256, 8)}


def window_bound(a, n, q, known, strict):
    """One half of ``window_bounds``: the first index of sorted ``a[0,
    n)`` whose row is >= q (> q when ``strict``), n when the bound is
    ``known`` to be n already; each round 16 evenly spaced probes narrow
    the stretch to the one between the last probe below and the next."""
    def below(v):
        return v <= q if strict else v < q

    lo, hi = (0 if known else n), n
    while hi - lo > HALF:
        step = (hi - lo + HALF - 1) // HALF
        c = sum(1 for h in range(HALF)
                if lo + (h + 1) * step - 1 < hi
                and below(a[lo + (h + 1) * step - 1]))
        top = lo + (c + 1) * step - 1
        lo += c * step
        hi = min(hi, top)
    return lo + sum(1 for h in range(HALF) if h < hi - lo and below(a[lo + h]))


def gallop(w, lo, n, q, strict):
    """``gallop32``: the first index in [lo, n] whose row is >= q (> q
    when ``strict``), given that none before lo is: steps of 1, 2, 4, ...
    rows, then a binary search."""
    hi, step = n, 1
    while lo < hi:
        p = lo + step - 1
        if p >= hi:
            break
        if (w[p] > q) if strict else (w[p] >= q):
            hi = p
            break
        lo, step = p + 1, step * 2
    find = pybisect.bisect_right if strict else pybisect.bisect_left
    return find(w, q, lo, hi)


def step_past(w, n, q, r, v, strict):
    """``step_past``: r moved past the rows < q (<= q when ``strict``), a
    row at a time for up to four rows, then a gallop; returns (r, w[r] or
    0 at n)."""
    for _ in range(4):
        if r >= n or ((v > q) if strict else (v >= q)):
            return r, v
        r += 1
        v = w[r] if r < n else 0
    if r < n and ((v <= q) if strict else (v < q)):
        r = gallop(w, r + 1, n, q, strict)
        v = w[r] if r < n else 0
    return r, v


def lower_from(w, n, g, q):
    """``lower_from``: the first index in [0, n] whose row is >= q,
    galloping from the guess g in whichever direction w[g - 1] says."""
    if g == 0 or w[g - 1] < q:
        return gallop(w, g, n, q, False)
    hi, lo, step = g - 1, 0, 1
    while hi - step >= 0:
        if w[hi - step] < q:
            lo = hi - step + 1
            break
        hi -= step
        step *= 2
    return gallop(w, lo, hi, q, False)


def probe_tile(plane, n_valid, sq, nr, stage, threads, items):
    """One tile of ``probe_u64``: its queries ``sq`` (``nr`` real ones
    first) against ``plane[0, n_valid)``, all unsigned Python ints.
    Returns (starts, counts, what the tile did)."""
    nq = len(sq)
    last = plane[n_valid - 1] if n_valid else 0
    if nr == 0:
        a = b = n_valid
    elif n_valid <= stage:  # the whole plane: no search
        a, b = 0, n_valid
    else:
        kf, kl = sq[0], sq[nr - 1]
        a = window_bound(plane, n_valid, kf, n_valid > 0 and kf <= last,
                         False)
        b = window_bound(plane, n_valid, kl, n_valid > 0 and kl < last,
                         True)
    n_win = b - a if nr > 0 else 0
    one_key = nr > 0 and n_valid > stage and sq[0] == sq[nr - 1]
    shift = 0
    while ((n_win - 1) >> shift) + 1 > stage:
        shift += 1
    ns = ((n_win - 1) >> shift) + 1 if n_win > 0 else 0
    w = plane[a:a + n_win] if shift == 0 else [
        plane[a + (t << shift)] for t in range(ns)]
    starts, counts = [0] * nq, [0] * nq
    for tid in range(threads):
        have, px, pv, ps, pe = False, 0, 0, 0, 0
        for j in range(tid * items, min((tid + 1) * items, nq)):
            x = sq[j]
            s = e = n_valid
            if n_valid > 0 and x <= last:
                if j >= nr:  # padding at or below the last row
                    s = e = pybisect.bisect_left(plane, x, 0, n_valid)
                elif one_key:
                    s, e = a, a + n_win
                elif have and x == px:
                    s, e = ps, pe
                elif shift == 0:
                    if have:
                        r, v = step_past(w, n_win, x, pe - a, pv, False)
                    else:
                        r = lower_from(w, n_win, n_win * j // nr, x)
                        v = w[r] if r < n_win else 0
                    s = a + r
                    r, v = step_past(w, n_win, x, r, v, True)
                    e, pv = a + r, v
                else:
                    t = 0
                    if x == sq[0]:
                        s = a
                    else:
                        t = pybisect.bisect_left(w, x, 0, ns)
                        lo = a + ((t - 1) << shift) + 1 if t > 0 else a
                        up = a + (t << shift) if t < ns else b
                        s = pybisect.bisect_left(plane, x, lo, up)
                    if x == sq[nr - 1]:
                        e = b
                    else:
                        t2 = pybisect.bisect_right(w, x, t, ns)
                        lo2 = a + ((t2 - 1) << shift) + 1 if t2 > 0 else a
                        up2 = a + (t2 << shift) if t2 < ns else b
                        e = pybisect.bisect_right(plane, x, max(lo2, s), up2)
                if j < nr:
                    have, px, ps, pe = True, x, s, e
            starts[j] = s
            counts[j] = e - s if j < nr else 0
    info = {"window": n_win, "shift": shift, "samples": ns,
            "one_key": one_key, "whole_plane": nr > 0 and n_valid <= stage,
            "real": nr}
    return starts, counts, info


def plain_tiles(q, hi, m, n_valid, tile=None, stage=None, order=None,
                threads=None):
    """``probe_u64`` in plain Python on i64 key bits: (start i32, counts
    i32, cum i64, what each tile did).  ``tile`` is the queries a block
    (``threads`` threads, ``tile / threads`` queries each; the kernel's
    shapes when None) and ``stage`` the staging budget in rows (the
    kernel's ``u64_tile`` and ``u64_stage_rows`` when None); ``order`` the
    order in which the tiles run their look-back after all have
    published their totals (ascending when None)."""
    mask = (1 << 64) - 1
    qs = [int(x) & mask for x in q.tolist()]
    plane = [int(x) & mask for x in hi.tolist()]
    mq = len(qs)
    tile = u64_tile(mq, n_valid) if tile is None else tile
    stage = u64_stage_rows(m, n_valid, tile) if stage is None else stage
    threads = SHAPES[tile][0] if threads is None else threads
    items = tile // threads
    start, counts, totals, info = [], [], [], []
    for q0 in range(0, mq, tile):
        sq = qs[q0:q0 + tile]
        s, c, note = probe_tile(plane, n_valid, sq,
                                max(0, min(len(sq), m - q0)), stage,
                                threads, items)
        start += s
        counts += c
        totals.append(sum(c))
        info.append(note)
    carry = look_back_carries(totals, order)
    counts_t = torch.tensor(counts, dtype=torch.int64)
    cum = torch.empty(mq, dtype=torch.int64)
    for t, q0 in enumerate(range(0, mq, tile)):
        cum[q0:q0 + tile] = carry[t] + torch.cumsum(counts_t[q0:q0 + tile],
                                                    0)
        info[t]["carry"] = carry[t]
    return (torch.tensor(start, dtype=torch.int32),
            counts_t.to(torch.int32), cum, info)


def look_back_carries(totals, order=None):
    """Each tile's carry from the kernel's look-back: every tile has
    published its total (tile 0 as an inclusive prefix) when the tiles
    look back in ``order``; a look-back reads 32 x 2 status words a round,
    newest first, adds the values up to the newest inclusive prefix (all
    of them when there is none and goes on), then publishes its own."""
    n = len(totals)
    state = [("inc" if t == 0 else "agg", totals[t]) for t in range(n)]
    carry = [0] * n
    for t in (range(1, n) if order is None else order):
        if t == 0:
            continue
        excl, top = 0, t - 1
        while True:
            n = LANES * LOOK_DEPTH
            words = [state[i] if i >= 0 else ("inc", 0)
                     for i in range(top, top - n, -1)]
            first = next((j for j, w in enumerate(words) if w[0] == "inc"),
                         None)
            excl += sum(v for _, v in words[:n if first is None
                                            else first + 1])
            if first is not None:
                break
            top -= n
        carry[t] = excl
        state[t] = ("inc", excl + totals[t])
    return carry


def sorted_inputs(lk, rk, m, n_valid, mq, cap):
    """Sorted queries (``mq``, SENTINEL past ``m``) and plane (``cap``,
    SENTINEL past ``n_valid``) from u64 key arrays."""
    q = np.full(mq, SENTINEL, np.uint64)
    h = np.full(cap, SENTINEL, np.uint64)
    q[:m] = np.sort(lk[:m])
    h[:n_valid] = np.sort(rk[:n_valid])
    return q, h


def _t(keys):
    return torch.from_numpy(np.ascontiguousarray(keys).view(np.int64).copy())


def jax_probe(q, h, m, n_valid, merged):
    out = jax_join._probe_kernel(q.shape[0], h.shape[0], merged)(
        q, h, m, n_valid)
    return [np.asarray(o).astype(np.int64) for o in out]


def check(q, h, m, n_valid, tile, stage, order=None, jax=True,
          threads=None):
    """The tile model against the plain version and (``jax``) both forms
    of the JAX kernel; returns the model's tile notes."""
    *got, info = plain_tiles(_t(q), _t(h), m, n_valid, tile, stage, order,
                             threads)
    want = join_probe_reference(_t(q), _t(h), m, n_valid)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if jax:
        for merged in (False, True):
            for g, w in zip(got, jax_probe(q, h, m, n_valid, merged)):
                np.testing.assert_array_equal(g.numpy().astype(np.int64), w)
    return info


POOL = np.array([0, 1, 7, 2**40, 2**63 - 1, 2**63, 2**63 + 3, 2**64 - 2,
                 2**64 - 1], np.uint64)
MQ, CAP = 64, 256  # one JAX compile a form for every case below


def case_keys(rng, case):
    """(queries, plane, m, n_valid) of one named case at MQ x CAP."""
    if case == "hot key over half the plane":
        rk = np.concatenate([np.full(CAP // 2, 2**63 + 11, np.uint64),
                             rng.integers(0, 2**64 - 1, CAP // 2 - 20,
                                          dtype=np.uint64)])
        lk = np.concatenate([np.full(40, 2**63 + 11, np.uint64),
                             rng.choice(rk, MQ - 48)])
        return (*sorted_inputs(lk, rk, MQ - 8, len(rk), MQ, CAP),
                MQ - 8, len(rk))
    if case == "sparse queries over a large plane":
        rk = rng.integers(0, 2**64 - 1, CAP, dtype=np.uint64)
        lk = rng.choice(rk, 12)
        return (*sorted_inputs(lk, rk, 12, CAP, MQ, CAP), 12, CAP)
    if case == "all padding":
        rk = rng.integers(0, 2**64 - 1, 200, dtype=np.uint64)
        return (*sorted_inputs(rk, rk, 0, 200, MQ, CAP), 0, 200)
    if case == "empty plane":
        lk = rng.integers(0, 2**64 - 1, MQ, dtype=np.uint64)
        return (*sorted_inputs(lk, lk, 50, 0, MQ, CAP), 50, 0)
    if case == "m < mq":
        rk = rng.choice(POOL[:6], 180)
        lk = rng.choice(POOL[:6], 33)
        return (*sorted_inputs(lk, rk, 33, 180, MQ, CAP), 33, 180)
    if case == "keys at and above 2^63":
        rk = np.uint64(2**63) - np.uint64(20) + rng.integers(
            0, 40, 230).astype(np.uint64)
        lk = np.concatenate([rng.choice(rk, 50), POOL[-3:]])
        return (*sorted_inputs(lk, rk, len(lk), 230, MQ, CAP), len(lk), 230)
    # tiles of one key or of one real query, the plane within the budget
    key = np.uint64(2**63 + 5)
    rk = np.concatenate([np.full(3, key, np.uint64),
                         rng.integers(0, 2**64 - 1, 60, dtype=np.uint64)])
    if case == "one query against the whole plane":
        lk = np.full(1, key, np.uint64)
    elif case == "a tail tile of one query":
        lk = rng.choice(rk, 17)
    else:
        assert case == "one key in every tile against the whole plane"
        lk = np.full(MQ - 4, key, np.uint64)
    return (*sorted_inputs(lk, rk, len(lk), len(rk), MQ, CAP), len(lk),
            len(rk))


CASES = ["hot key over half the plane", "sparse queries over a large plane",
         "all padding", "empty plane", "m < mq", "keys at and above 2^63",
         "one query against the whole plane", "a tail tile of one query",
         "one key in every tile against the whole plane"]
WHOLE_PLANE = CASES[-3:]


@pytest.mark.parametrize("case", CASES)
def test_named_cases_match_reference_and_jax(case):
    """Each named case through tiles of 8 queries (2 threads of 4) with a
    budget of 8 rows, or of 64 rows where the tiles' window must be the
    whole plane."""
    rng = np.random.default_rng(len(case))
    q, h, m, n_valid = case_keys(rng, case)
    whole = case in WHOLE_PLANE
    info = check(q, h, m, n_valid, tile=8, stage=64 if whole else 8,
                 order=list(rng.permutation(MQ // 8)), threads=2)
    if case in ("hot key over half the plane",
                "sparse queries over a large plane"):
        assert any(t["shift"] > 0 for t in info)  # the sampled path
        assert any(t["one_key"] for t in info) == (case.startswith("hot"))
    if case in ("all padding", "empty plane"):
        assert all(t["window"] == 0 for t in info)
    if whole:  # one key or one real query, no search: the queries merge
        assert all(t["whole_plane"] and not t["one_key"] for t in info
                   if t["real"])
        assert any(t["real"] == 1 or t["real"] == 8 for t in info)


@settings(max_examples=80, deadline=None, derandomize=True)
@given(data=st.data(), tile=st.sampled_from([4, 8, 16]),
       stage=st.sampled_from([2, 4, 8, 64, 256]))
def test_tiles_match_reference_and_jax(data, tile, stage):
    """Random sorted inputs over a small alphabet (duplicates, keys at
    and above 2^63, real SENTINEL keys) at MQ x CAP, through tiles of 1 to
    ``tile`` threads, with budgets below and above the plane (the window
    searched or the whole plane); the queries drawn as any, as one key
    (every full tile of one key), or ending one past a tile (a tail tile
    of one real query): every tile path and look-back order gives the
    plain version's and the JAX kernel's outputs."""
    seed = data.draw(st.integers(0, 2**31))
    rng = np.random.default_rng(seed)
    alphabet = data.draw(st.sampled_from(["pool", "wide", "hot"]))
    if alphabet == "pool":
        keys = POOL
    elif alphabet == "wide":
        keys = rng.integers(0, 2**64 - 1, 300, dtype=np.uint64)
    else:
        keys = np.array([5, 2**63 + 1, 2**63 + 1, 2**63 + 1, 9], np.uint64)
    threads = data.draw(st.sampled_from([t for t in (1, 2, 4, 16)
                                         if tile % t == 0]))
    queries = data.draw(st.sampled_from(["any", "one key", "tail of one"]))
    if queries == "tail of one":
        m = tile * data.draw(st.integers(0, MQ // tile - 1)) + 1
    else:
        m = data.draw(st.integers(0, MQ))
    n_valid = data.draw(st.integers(0, CAP))
    lk = (np.full(MQ, rng.choice(keys), np.uint64) if queries == "one key"
          else rng.choice(keys, MQ))
    q, h = sorted_inputs(lk, rng.choice(keys, CAP), m, n_valid, MQ, CAP)
    order = list(rng.permutation(-(-MQ // tile)))
    check(q, h, m, n_valid, tile, stage, order, threads=threads)


@pytest.mark.parametrize("mq,cap,m,n_valid,tile,sampled", [
    (4_096, 65_536, 4_000, 60_000, 64, False),  # sparse: small tiles
    (1_024, 262_144, 1_000, 200_000, 64, True),  # sparser: sampled
    (5_000, 4_096, 4_700, 4_000, 1_024, False),  # dense, a ragged tile
    (8_192, 8_192, 8_192, 8_192, 1_024, False),
    (65_536, 65_536, 60_000, 50_000, 1_024, False)])  # 64 tiles
def test_kernel_tiles_match_reference(mq, cap, m, n_valid, tile, sampled):
    """The kernel's own tile and staging budget, several tiles, keys
    drawn so that about a third of the queries match."""
    rng = np.random.default_rng(mq + cap)
    rk = rng.integers(0, 2**64 - 1, n_valid, dtype=np.uint64)
    lk = np.concatenate([rng.choice(rk, m - m // 3),
                         rng.integers(0, 2**64 - 1, m // 3,
                                      dtype=np.uint64)])
    q, h = sorted_inputs(lk, rk, m, n_valid, mq, cap)
    assert u64_tile(mq, n_valid) == tile
    info = check(q, h, m, n_valid, None, None,
                 order=list(rng.permutation(-(-mq // tile))), jax=False)
    assert any(t["shift"] > 0 for t in info) == sampled


def test_wide_tile_matches_reference():
    """The 2,048-query tile (256 threads of eight queries), which the
    kernel takes past 524,288 queries, at 16,384 queries with its own
    staging budget: eight tiles against the plain version."""
    rng = np.random.default_rng(2_048)
    mq = cap = 16_384
    m, n_valid = 15_000, 13_000
    rk = rng.integers(0, 2**64 - 1, n_valid, dtype=np.uint64)
    lk = np.concatenate([rng.choice(rk, m - m // 3),
                         rng.integers(0, 2**64 - 1, m // 3,
                                      dtype=np.uint64)])
    q, h = sorted_inputs(lk, rk, m, n_valid, mq, cap)
    info = check(q, h, m, n_valid, 2_048, u64_stage_rows(m, n_valid, 2_048),
                 order=list(rng.permutation(8)), jax=False)
    assert len(info) == 8 and not any(t["shift"] for t in info)


def test_look_back_rounds_cross_64_tiles():
    """Tiles up to 300 in, every earlier one holding only its total (the
    later ones look back first): the look-back walks up to five rounds of
    64 words and finds the plain exclusive sum."""
    totals = list(range(1, 301))
    order = list(range(299, 0, -1))
    carry = look_back_carries(totals, order)
    assert carry == [sum(totals[:t]) for t in range(300)]


def test_tile_and_stage_rows_follow_the_expected_window():
    assert u64_tile(1_048_576, 838_861) == 2_048
    assert u64_stage_rows(1_048_576, 838_861, 2_048) == 2 * 1_639 + 64
    assert u64_tile(524_288, 419_431) == 1_024
    assert u64_tile(524_289, 1) == 2_048
    assert u64_tile(8_192, 400_000) == 64  # 8b: 49 rows a query
    assert u64_stage_rows(8_000, 400_000, 64) == 4_096  # ~3,200 a window
    assert u64_tile(1_048_576, 400_000) == 2_048  # all padding: dense
    assert u64_tile(1, 5) == 64 and u64_tile(1, 4) == 1_024
    assert u64_stage_rows(0, 100, 64) == 256
    assert u64_stage_rows(7_000, 7_000, 1_024) % 2 == 0
