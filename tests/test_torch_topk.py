"""The port's hot-items slice against arroyo_tpu, on the CPU:

* ``segment_top_k`` (plain version) against ``arroyo_tpu.ops.topk`` —
  identical index arrays over sizes, segment counts, k and values with
  ties, NaN, +/-0 and +/-inf;
* the compact-emission kernels' plain versions against the JAX package's
  ``_emit_count_kernel`` / ``_emit_compact_kernel``;
* ``_apply_top_n`` on both sides of the 512-row device threshold, with and
  without the ROW_NUMBER() column, and ``TumblingTopNOperator``;
* ``KeyedBinState`` fires with ``ARROYO_EMIT_COMPACT`` = on and auto: the
  same rows, and under auto the compact branch on the same fires;
* ``hot_items_program`` against the JAX engine's ``plan_sql`` run, with
  identical sink rows and node names and kinds;
* a checkpointed, stopped and restored run that emits exactly the rows of
  an uninterrupted one, and the fused TopN's tables restoring across the
  two packages in both directions while a TopN window is buffered.

The JAX side runs on one device, as the port does, and both packages on
their default host paths: a TopN's ties at the k-th place are decided by
row order, which follows key-slot order (first-seen with the host
library's key directory in both packages), which the mesh state would
change."""

import asyncio

import numpy as np
import pytest
import torch

from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.context import TimerHeap as JaxTimerHeap
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.engine.operators_window import BinAggOperator as JaxBinAgg
from arroyo_tpu.engine.operators_window import \
    TumblingTopNOperator as JaxTopN
from arroyo_tpu.engine.operators_window import _apply_top_n as jax_top_n
from arroyo_tpu.graph.logical import AggKind as JAggKind
from arroyo_tpu.graph.logical import AggSpec as JAggSpec
from arroyo_tpu.ops import keyed_bins as jax_kb
from arroyo_tpu.ops.keyed_bins import KeyedBinState as JaxState
from arroyo_tpu.ops.topk import segment_top_k as jax_segment_top_k
from arroyo_tpu.sql import plan_sql
from arroyo_tpu.state.tables import BatchBuffer as JaxBatchBuffer
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu.types import TaskInfo as JaxTaskInfo
from arroyo_tpu_torch.config import reset_config
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.context import TimerHeap
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
from arroyo_tpu_torch.engine.operators_window import (BinAggOperator,
                                                      TumblingTopNOperator,
                                                      _apply_top_n)
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec
from arroyo_tpu_torch.hot_items import hot_items_program, hot_items_sql
from arroyo_tpu_torch.kernels.bin_update import channel_plan
from arroyo_tpu_torch.kernels.emit_compact import (compact_views, emit_count,
                                                   emit_gather,
                                                   emit_gather_buffer,
                                                   pack_panes, panes_views)
from arroyo_tpu_torch.kernels.segment_top_k import (segment_top_k,
                                                    segment_top_k_reference)
from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState as PortState
from arroyo_tpu_torch.ops.topk import segment_top_k as port_segment_top_k
from arroyo_tpu_torch.state.backend import InMemoryBackend
from arroyo_tpu_torch.state.tables import BatchBuffer
from arroyo_tpu_torch.types import Batch, TaskInfo, hash_columns


@pytest.fixture
def jax_like_port(monkeypatch):
    """The JAX package on one device (no mesh state), its host library
    on its default, as the port's."""
    monkeypatch.setenv("ARROYO_MESH", "off")


def _values(rng, n):
    """Small integer values (ties) with NaN, -NaN, +/-0 and +/-inf."""
    v = rng.integers(0, 6, n).astype(np.float64)
    r = rng.random(n)
    v[r < 0.05] = np.nan
    v[(r >= 0.05) & (r < 0.08)] = -np.nan
    v[(r >= 0.08) & (r < 0.14)] = -0.0
    v[(r >= 0.14) & (r < 0.17)] = np.inf
    v[(r >= 0.17) & (r < 0.2)] = -np.inf
    return v


@pytest.mark.parametrize("n_seg", [1, 5, 1000])
@pytest.mark.parametrize("n", [1, 7, 511, 512, 4097])
def test_segment_top_k_plain_matches_jax(n, n_seg):
    """Identical kept indices (ascending) for k = 1, 3, 10, 64; with 1,000
    segments most are smaller than k.  The partition column is sparse and
    signed, so the dense segment ids come from np.unique on both sides."""
    rng = np.random.default_rng(n * 7 + n_seg)
    part = (rng.integers(0, n_seg, n) - n_seg // 2) * 131
    vals = _values(rng, n)
    uniq = np.unique(part)
    seg = torch.tensor(np.searchsorted(uniq, part).astype(np.int32))
    for k in (1, 3, 10, 64):
        want = jax_segment_top_k(part, vals, k)
        got = segment_top_k(seg, torch.tensor(vals), k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")
        np.testing.assert_array_equal(
            port_segment_top_k(part, vals, k, "cpu"), want)


def test_segment_top_k_edges():
    """k = 0 keeps nothing, k beyond n keeps every row, and an empty input
    gives an empty output; the order keys fold -0.0 onto +0.0 and put
    every NaN last."""
    seg = torch.tensor([0, 0, 1], dtype=torch.int32)
    val = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    assert segment_top_k(seg, val, 0).tolist() == []
    assert segment_top_k(seg, val, 5).tolist() == [0, 1, 2]
    empty = torch.zeros(0, dtype=torch.int32)
    assert segment_top_k(empty, empty.double(), 3).tolist() == []
    with pytest.raises(ValueError):
        segment_top_k(seg, val, -1)
    ties = torch.tensor([-0.0, 0.0, float("nan"), -float("nan"), 5.0,
                         float("inf")], dtype=torch.float64)
    got = segment_top_k_reference(torch.zeros(6, dtype=torch.int32), ties, 3)
    assert got.tolist() == [0, 4, 5]  # inf, 5, then -0.0 (the first zero)


def _bin_planes(rng, kinds, C, B, cdt):
    values = rng.normal(size=(len(kinds), C, B)) * 100
    counts = rng.poisson(0.4, (C, B)).astype(np.int64 if cdt == "int64"
                                             else np.int32)
    for j, kind in enumerate(kinds):
        ident = jax_kb._init_value(JAggKind(kind))
        values[j][counts == 0] = ident
    return values, counts


@pytest.mark.parametrize("cdt", ["int32", "int64"])
@pytest.mark.parametrize("k", [1, 5])
def test_emit_compact_plain_matches_jax_kernels(cdt, k):
    """emit_count + emit_gather (plain) against ``_emit_count_kernel`` +
    ``_emit_compact_kernel`` on the same planes: the live total, the
    (slot, pane) rows in order and their counts exactly, min/max
    channels exactly, sums to rtol 1e-12."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11 + k)
    kinds = ("count", "sum", "min", "max", "sum")
    xfer = (1, 2, 3, 4)
    C, B, W = 256, 16, 5
    values, counts = _bin_planes(rng, kinds, C, B, cdt)
    ring = ((np.arange(k)[:, None] + np.arange(W)[None, :] + 3)
            % B).astype(np.int32)
    bin_ok = np.ones((k, W), dtype=bool)
    bin_ok[0, :2] = False  # the oldest bins of the first pane evicted
    cnt_j, nnz_j = jax_kb._emit_count_kernel(C, B, W, k)(
        jnp.asarray(counts), jnp.asarray(ring), jnp.asarray(bin_ok))
    nnz = int(nnz_j)
    npad = jax_kb._bucket(nnz, floor=256)
    idx2_j, cc_j, ch_j = jax_kb._emit_compact_kernel(
        kinds, C, B, W, k, xfer, npad)(jnp.asarray(values), cnt_j,
                                       jnp.asarray(ring),
                                       jnp.asarray(bin_ok))
    t = torch.tensor
    cnt, offsets = emit_count(t(counts), t(ring), t(bin_ok), C)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert int(offsets[-1]) == nnz > 0
    idx2, cc, ch = emit_gather(t(values), cnt, t(ring), t(bin_ok), kinds,
                               xfer, offsets, nnz)
    np.testing.assert_array_equal(idx2.numpy(),
                                  np.asarray(idx2_j)[:, :nnz])
    np.testing.assert_array_equal(cc.numpy(), np.asarray(cc_j)[:nnz])
    ch_j = np.asarray(ch_j)[:, :nnz]
    for r, j in enumerate(xfer):
        if kinds[j] in ("min", "max"):
            np.testing.assert_array_equal(ch[r].numpy(), ch_j[r])
        else:
            np.testing.assert_allclose(ch[r].numpy(), ch_j[r], rtol=1e-12)
    # the per-block offsets: live cells before each block of 256 cells
    live = (cnt.numpy().reshape(-1) > 0)
    starts = np.arange(0, C * k, 256)
    np.testing.assert_array_equal(
        offsets.numpy()[:-1], [int(live[:s].sum()) for s in starts])


@pytest.mark.parametrize("cdt", ["int32", "int64"])
@pytest.mark.parametrize("kinds,dup", [
    (("count", "sum", "min", "max", "count"), (0,)),  # hot items + columns
    (("count",), (0,)),  # hot items: nothing transferred
    (("sum", "count", "max"), ()),
])
def test_emit_gather_buffer_plain_matches_jax(cdt, kinds, dup):
    """The gather's one buffer, split by ``compact_views``, against
    ``_emit_compact_kernel`` with the state's channel plan (its non-dup
    channels transferred): rows and counts exact, min/max exact, sums to
    rtol 1e-12; the count channel of a column (not COUNT(*)) rides as a
    sum."""
    import jax.numpy as jnp

    rng = np.random.default_rng(23 + len(kinds))
    C, B, W, k = 300, 16, 5, 3
    values, counts = _bin_planes(rng, kinds, C, B, cdt)
    ring = ((np.arange(k)[:, None] + np.arange(W)[None, :] + 9)
            % B).astype(np.int32)
    bin_ok = np.ones((k, W), dtype=bool)
    bin_ok[0, :3] = False
    rows = 287
    plan = channel_plan(kinds, dup)
    xfer = tuple(j for j in range(len(kinds)) if j not in dup)
    t = torch.tensor
    cnt, offsets = emit_count(t(counts), t(ring), t(bin_ok), rows)
    nnz = int(offsets[-1])
    cnt_j, nnz_j = jax_kb._emit_count_kernel(rows, B, W, k)(
        jnp.asarray(counts[:rows]), jnp.asarray(ring), jnp.asarray(bin_ok))
    assert nnz == int(nnz_j) > 0
    idx2_j, cc_j, ch_j = jax_kb._emit_compact_kernel(
        kinds, rows, B, W, k, xfer, jax_kb._bucket(nnz, floor=256))(
            jnp.asarray(values[:, :rows]), cnt_j, jnp.asarray(ring),
            jnp.asarray(bin_ok))
    buf = emit_gather_buffer(t(values), cnt, t(ring), t(bin_ok), plan,
                             offsets, nnz)
    assert buf.dtype == torch.int32
    key, pane, cc, ch = compact_views(buf.numpy(), nnz, len(xfer),
                                      torch.int64 if cdt == "int64"
                                      else torch.int32)
    np.testing.assert_array_equal(key, np.asarray(idx2_j)[0, :nnz])
    np.testing.assert_array_equal(pane, np.asarray(idx2_j)[1, :nnz])
    np.testing.assert_array_equal(cc, np.asarray(cc_j)[:nnz])
    assert cc.dtype == np.dtype(cdt) and ch.shape == (len(xfer), nnz)
    ch_j = np.asarray(ch_j)[:, :nnz]
    for r, j in enumerate(xfer):
        if kinds[j] in ("min", "max"):
            np.testing.assert_array_equal(ch[r], ch_j[r])
        else:
            np.testing.assert_allclose(ch[r], ch_j[r], rtol=1e-12)
    # the tensor views and the tuple form give the same rows
    tk, tp, tc, tch = compact_views(buf, nnz, len(xfer), cnt.dtype)
    idx2, cc2, ch2 = emit_gather(t(values), cnt, t(ring), t(bin_ok), kinds,
                                 xfer, offsets, nnz)
    np.testing.assert_array_equal(idx2.numpy(), np.stack([tk, tp]))
    np.testing.assert_array_equal(cc2.numpy(), tc.numpy())
    np.testing.assert_array_equal(ch2.numpy(), tch.numpy())


@pytest.mark.parametrize("k", range(1, 9))
def test_emit_count_plain_matches_jax_at_ragged_rows(k):
    """emit_count (plain) against ``_emit_count_kernel``'s (cnt, total)
    over a row count that is not a multiple of the 256-cell group, for 1
    to 8 panes whose bins wrap around the ring and lose an evicted bin;
    the offsets are the live cells before each group, ending in the
    total."""
    import jax.numpy as jnp

    rng = np.random.default_rng(40 + k)
    C, B, W = 400, 16, 5
    rows = 257 + 13 * k  # a ragged last group for every k
    counts = np.where(rng.random((C, B)) < 0.3,
                      rng.integers(1, 9, (C, B)), 0).astype(np.int32)
    ring = ((np.arange(k)[:, None] + np.arange(W)[None, :] + 13)
            % B).astype(np.int32)
    bin_ok = np.ones((k, W), dtype=bool)
    bin_ok[0, 0] = False
    cnt_j, nnz_j = jax_kb._emit_count_kernel(rows, B, W, k)(
        jnp.asarray(counts[:rows]), jnp.asarray(ring), jnp.asarray(bin_ok))
    cnt, offsets = emit_count(torch.tensor(counts), torch.tensor(ring),
                              torch.tensor(bin_ok), rows)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    live = cnt.numpy().reshape(-1) > 0
    starts = np.arange(0, rows * k, 256)
    np.testing.assert_array_equal(
        offsets.numpy(), [int(live[:s].sum()) for s in starts] + [int(nnz_j)])


def test_pane_buffer_round_trip():
    """A fire's ring and bin_ok travel as one byte buffer (one upload):
    its two views give them back."""
    ring = np.array([[3, 4, 5], [4, 5, 6]], dtype=np.int32)
    bin_ok = np.array([[False, True, True], [True, True, False]])
    buf = pack_panes(ring, bin_ok)
    assert buf.dtype == np.uint8 and buf.shape == (5 * ring.size,)
    r, o = panes_views(torch.tensor(buf), *ring.shape)
    assert r.dtype == torch.int32 and o.dtype == torch.bool
    np.testing.assert_array_equal(r.numpy(), ring)
    np.testing.assert_array_equal(o.numpy(), bin_ok)


def test_new_wrappers_run_plain_versions_on_cpu_and_reject_others():
    """CPU tensors take the plain versions (no launch counted); a tensor on
    any other non-CUDA device raises instead of falling back."""
    before = (segment_top_k.launches, emit_count.launches,
              emit_gather.launches)
    seg = torch.zeros(4, dtype=torch.int32)
    val = torch.arange(4, dtype=torch.float64)
    assert segment_top_k(seg, val, 2).tolist() == [2, 3]
    counts = torch.zeros((8, 4), dtype=torch.int32)
    counts[3, 1] = 2
    ring = torch.tensor([[1]], dtype=torch.int32)
    ok = torch.ones((1, 1), dtype=torch.bool)
    cnt, offsets = emit_count(counts, ring, ok, 8)
    values = torch.zeros((1, 8, 4), dtype=torch.float64)
    idx2, cc, ch = emit_gather(values, cnt, ring, ok, ("count",), (),
                               offsets, 1)
    assert idx2.tolist() == [[3], [0]] and cc.tolist() == [2]
    assert ch.shape == (0, 1)
    assert (segment_top_k.launches, emit_count.launches,
            emit_gather.launches) == before
    with pytest.raises(ValueError):
        segment_top_k(seg.to("meta"), val.to("meta"), 2)
    with pytest.raises(ValueError):
        emit_count(counts.to("meta"), ring.to("meta"), ok.to("meta"), 8)
    with pytest.raises(ValueError):
        emit_gather(values.to("meta"), cnt.to("meta"), ring.to("meta"),
                    ok.to("meta"), ("count",), (), offsets.to("meta"), 1)
    with pytest.raises(ValueError):
        emit_count(counts, ring, ok, 9)  # more rows than slots


def _topn_batch(cls, rng, n, n_windows=3):
    """Aggregate-like rows: window columns, a partition column, an integer
    count with ties, stamped at window end - 1."""
    ends = (rng.integers(0, n_windows, n) + 1) * 2_000_000
    cols = {"p": rng.integers(0, 23, n).astype(np.int64),
            "v": rng.integers(0, 40, n).astype(np.int64),
            "window_start": ends - 10_000_000, "window_end": ends}
    return cls(ends - 1, cols, hash_columns([cols["p"]]), ("p",))


def _same_batch(got, want):
    np.testing.assert_array_equal(got.timestamp, want.timestamp)
    np.testing.assert_array_equal(got.key_hash, want.key_hash)
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        assert got.columns[c].dtype == want.columns[c].dtype, c
        np.testing.assert_array_equal(got.columns[c], want.columns[c],
                                      err_msg=c)


@pytest.mark.parametrize("rank_column", [None, "rn"])
@pytest.mark.parametrize("n", [511, 512])
@pytest.mark.parametrize("partition_cols", [(), ("p",)])
def test_apply_top_n_matches_jax(n, rank_column, partition_cols):
    """The host lexsort below 512 rows and the device segment_top_k from
    512 on keep the same rows, in order, and the same ROW_NUMBER()."""
    rng = np.random.default_rng(n)
    port = _topn_batch(Batch, rng, n)
    jax_b = JaxBatch(port.timestamp, dict(port.columns), port.key_hash,
                     port.key_cols)
    got = _apply_top_n(port, partition_cols, "v", 3, rank_column, "cpu")
    want = jax_top_n(jax_b, partition_cols, "v", 3, rank_column)
    _same_batch(got, want)
    assert 0 < len(got) < n


class _State:
    def __init__(self, buffer_cls):
        self.buffer_cls = buffer_cls
        self.tables = {}

    def get_batch_buffer(self, name, *_args, **_kw):
        return self.tables.setdefault(name, self.buffer_cls())

    def register_device(self, desc, table):
        self.tables[desc.name] = table


class _Ctx:
    """What the aggregate and TopN operators touch of a task context."""

    def __init__(self, buffer_cls, timers, task_info_cls):
        self.state = _State(buffer_cls)
        self.timers = timers
        self.task_info = task_info_cls("j", "op", "op", 0, 1)
        self.last_watermark = None
        self.out = []

    async def collect(self, batch):
        self.out.append(batch)

    async def broadcast(self, _msg):
        pass


PKGS = {"port": (Batch, BatchBuffer, TimerHeap, TaskInfo),
        "jax": (JaxBatch, JaxBatchBuffer, JaxTimerHeap, JaxTaskInfo)}


def _topn_ops(pkg):
    """A fused sliding TopN (HOP(2 ms, 10 ms) COUNT(*), top 3 per window)
    feeding a global TopN (per window, top 3, rank column), as the
    planner chains them."""
    if pkg == "port":
        agg = BinAggOperator("agg", 10_000, 2_000,
                             (AggSpec(AggKind.COUNT, None, "__agg0"),),
                             top_n=((), "__agg0", 3), device="cpu")
        top = TumblingTopNOperator("top", 1, 3, "__agg0", (), None, "rn",
                                   "cpu")
    else:
        agg = JaxBinAgg("agg", 10_000, 2_000,
                        (JAggSpec(JAggKind.COUNT, None, "__agg0"),),
                        top_n=((), "__agg0", 3))
        top = JaxTopN("top", 1, 3, "__agg0", (), None, "rn")
    return agg, top


class _Pipe:
    """One package's fused TopN -> global TopN pair, driven by hand: the
    aggregate's output batches reach the TopN, then the watermark fires
    its timers."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.cls, buf, timers, ti = PKGS[pkg]
        self.agg, self.top = _topn_ops(pkg)
        self.agg_ctx = _Ctx(buf, timers(), ti)
        self.top_ctx = _Ctx(buf, timers(), ti)

    async def start(self):
        await self.agg.on_start(self.agg_ctx)
        await self.top.on_start(self.top_ctx)

    async def step(self, keys, ts, wm, pause=None):
        cols = {"auction": keys}
        await self.agg.process_batch(
            self.cls(ts, cols, hash_columns([keys]), ("auction",)),
            self.agg_ctx)
        self.agg_ctx.out.clear()
        await self.agg.handle_watermark(wm, self.agg_ctx)
        for b in self.agg_ctx.out:
            await self.top.process_batch(b, self.top_ctx)
        if pause is not None:
            pause(self)  # a TopN window is buffered here
        for t, key, payload in self.top_ctx.timers.fire(wm):
            await self.top.handle_timer(t, key, payload, self.top_ctx)

    def snapshot(self):
        return (self.agg_ctx.state.tables["a"].snapshot(),
                self.top_ctx.state.tables["t"].snapshot_batch(),
                self.top_ctx.timers.snapshot())

    def restore(self, snap):
        arrays, buffered, timers = snap
        self.agg_ctx.state.tables["a"].restore(dict(arrays))
        self.top_ctx.state.tables["t"].restore_batch(self.cls(
            buffered.timestamp, dict(buffered.columns), buffered.key_hash,
            buffered.key_cols))
        self.top_ctx.timers.restore(timers)


def _topn_steps(seed, n_steps=16):
    """Batches of churning auctions (ids drift upward) whose event time
    moves 1.5-2.5 ms a batch, each followed by a watermark."""
    rng = np.random.default_rng(seed)
    steps, now = [], 10_000
    for i in range(n_steps):
        n = int(rng.integers(100, 400))
        keys = (rng.integers(0, 40, n) + 6 * i).astype(np.int64)
        ts = (now + rng.integers(-1_500, 1_000, n)).astype(np.int64)
        steps.append((keys, ts, now - 2_000))
        now += int(rng.integers(1_500, 2_500))
    return steps


def _drive(pipe, steps, pause_at=None, pause=None, fresh=True):
    async def go():
        if fresh:
            await pipe.start()
        for i, (keys, ts, wm) in enumerate(steps):
            await pipe.step(keys, ts, wm, pause if i == pause_at else None)
    asyncio.run(go())
    return pipe.top_ctx.out


def test_topn_operators_emit_jax_batches(jax_like_port):
    """The fused sliding TopN and the global TopN stage emit the JAX
    operators' batches, rows and order, ROW_NUMBER() included."""
    steps = _topn_steps(5)
    got = _drive(_Pipe("port"), steps)
    want = _drive(_Pipe("jax"), steps)
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        _same_batch(g, w)
    assert max(int(b.columns["rn"].max()) for b in got) == 3


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_topn_tables_restore_across_packages(jax_like_port, direction):
    """The aggregate's bin-state table, the TopN's buffer and its timers,
    snapshotted by one package while a TopN window is buffered, restore
    into the other package's operators, which then emit what an
    uninterrupted run emits."""
    steps = _topn_steps(9)
    half = len(steps) // 2
    src, dst = direction.split("_to_")
    snaps, emitted = [], []

    def pause(pipe):
        snaps.append(pipe.snapshot())
        emitted.append(len(pipe.top_ctx.out))
        assert len(pipe.top_ctx.state.tables["t"]) > 0

    _drive(_Pipe(src), steps[:half + 1], pause_at=half, pause=pause)
    reference = _drive(_Pipe(dst), steps, pause_at=half, pause=pause)
    restored = _Pipe(dst)
    asyncio.run(restored.start())
    restored.restore(snaps[0])

    async def fire_buffered():  # the buffered window fires on the watermark
        wm = steps[half][2]
        for t, key, payload in restored.top_ctx.timers.fire(wm):
            await restored.top.handle_timer(t, key, payload,
                                            restored.top_ctx)
    asyncio.run(fire_buffered())
    got = _drive(restored, steps[half + 1:], fresh=False)
    want = reference[emitted[1]:]
    assert emitted[0] == emitted[1] and len(got) == len(want) > 2
    for g, w in zip(got, want):
        _same_batch(g, w)


DENSE_AGGS = [("count", None, "n"), ("sum", "price", "total"),
              ("min", "price", "lo"), ("max", "price", "hi")]


def _bin_stream(seed, n_batches=12):
    """(key hashes, timestamps, price, watermark) per batch: churning keys
    (ids drift upward, so fire density falls), out-of-order times, NULL
    prices."""
    rng = np.random.default_rng(seed)
    out, now = [], 20_000
    for i in range(n_batches):
        n = int(rng.integers(80, 300))
        keys = (rng.integers(0, 50, n) + 25 * i).astype(np.uint64) \
            * np.uint64(0x9E3779B97F4A7C15)
        ts = now + rng.integers(-2_500, 1_500, n)
        price = rng.normal(50, 20, n)
        price[rng.random(n) < 0.1] = np.nan
        out.append((keys, ts.astype(np.int64), price, now - 3_000))
        now += int(rng.integers(500, 2_500))
    return out


def _assert_fires_equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    (ka, ca, wa, na), (kb, cb, wb, nb) = a, b
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(na, nb)
    assert ca.keys() == cb.keys()
    for name in ca:
        if name in ("total",):  # f64 sums: rtol 1e-12
            np.testing.assert_allclose(ca[name], cb[name], rtol=1e-12,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(ca[name], cb[name])


@pytest.mark.parametrize("mode,promote", [("on", False), ("auto", False),
                                          ("auto", True)])
def test_compact_fires_match_jax(jax_like_port, monkeypatch, mode, promote):
    """The port's KeyedBinState fires what the JAX state fires, fire for
    fire, with ``ARROYO_EMIT_COMPACT`` set in both packages; under auto
    both take the compact branch on the same fires.  The default margin
    (256 KiB, the JAX package's allowance for a TPU round trip) is only
    crossed at ~65k slots, so the margin is 0 here."""
    monkeypatch.setenv("ARROYO_EMIT_COMPACT", mode)
    monkeypatch.setenv("ARROYO_EMIT_COMPACT_MARGIN", "0")
    if promote:
        monkeypatch.setattr(JaxState, "_i32_promote", 1500)
        monkeypatch.setattr(PortState, "_i32_promote", 1500)
    fires = {"jax": [], "port": []}

    def spy(cls, name):
        orig = cls._emit_compact

        def wrapped(self, *args):
            fires[name].append(self.last_fired_pane)
            return orig(self, *args)
        monkeypatch.setattr(cls, "_emit_compact", wrapped)

    spy(JaxState, "jax")
    spy(PortState, "port")
    # capacity for every key of the stream: no growth, so the JAX side
    # compiles few kernel variants (growth is covered in
    # tests/test_torch_keyed_bins.py)
    j = JaxState(tuple(JAggSpec(JAggKind(k), c, o) for k, c, o in DENSE_AGGS),
                 1_000, 3_000, capacity=512)
    p = PortState(tuple(AggSpec(AggKind(k), c, o) for k, c, o in DENSE_AGGS),
                  1_000, 3_000, capacity=512, device="cpu")
    n_fires = 0
    for keys, ts, price, wm in _bin_stream(17 + promote):
        out = []
        for st in (j, p):
            st.update(keys, ts, {"price": price})
            out.append(st.fire_panes(wm))
        _assert_fires_equal(*out)
        n_fires += out[0] is not None
    _assert_fires_equal(j.fire_panes(0, final=True),
                        p.fire_panes(0, final=True))
    assert fires["jax"] == fires["port"]
    if mode == "on":
        assert len(fires["port"]) >= n_fires
    else:
        assert 0 < len(fires["port"]) <= n_fires
    if promote:
        assert p.counts.dtype == torch.int64


def _rows(batches):
    rows = []
    for b in batches:
        names = sorted(b.columns)
        for i in range(len(b)):
            rows.append((int(b.timestamp[i]),)
                        + tuple(b.columns[n][i].item() for n in names))
    return sorted(rows)


def _plan(program):
    """(name, kind, parallelism, max parallelism) of each node in order."""
    out = []
    for op_id in program.topo_order():
        node = program.node(op_id)
        out.append((node.operator.name, node.operator.kind.value,
                    node.parallelism, node.max_parallelism))
    return out


@pytest.mark.parametrize("rate", [5_000, 1_000_000])
def test_hot_items_port_matches_jax_sql_plan(jax_like_port, monkeypatch,
                                             rate):
    """The hot-items SQL through the JAX engine and ``hot_items_program``
    through the port's emit the same rows (200k events, batch 16384, the
    event-time origin pinned).  At 5,000 events/s the 200k events span
    40 s, panes fire mid-stream on churning auctions and both packages
    take the compact branch under auto (margin 0, as above); at bench.py's
    1M events/s everything fires at the final flush, 5 windows in one
    TopN call."""
    monkeypatch.setenv("ARROYO_EMIT_COMPACT_MARGIN", "0")
    n, b = 200_000, 16_384
    sql = hot_items_sql(n, b, event_rate=rate).replace(
        f"batch_size = '{b}'", f"batch_size = '{b}', base_time_micros = '0'")
    compact = {"jax": 0, "port": 0}
    for cls, name in ((JaxState, "jax"), (PortState, "port")):
        orig = cls._emit_compact

        def wrapped(self, *args, _o=orig, _n=name):
            compact[_n] += 1
            return _o(self, *args)
        monkeypatch.setattr(cls, "_emit_compact", wrapped)
    jax_program = plan_sql(sql)
    jax_clear_sink("results")
    JaxLocalRunner(jax_program).run()
    want = _rows(jax_sink_output("results"))
    clear_sink("hot-port")
    program = hot_items_program(n, b, sink="hot-port",
                                event_rate=float(rate), base_time_micros=0)
    LocalRunner(program, device="cpu").run()
    got = _rows(sink_output("hot-port"))
    assert want and got == want
    assert _plan(program) == _plan(jax_program)
    if rate == 5_000:
        assert compact["port"] == compact["jax"] > 0
    windows = {r[1] for r in got}
    assert len(got) <= 10 * len(windows)


@pytest.fixture
def no_linger(monkeypatch):
    """The input coalescer's linger pinned at 0: a buffered batch is
    processed at the task loop's next turn, before another can merge."""
    monkeypatch.setenv("COALESCE_LINGER_MICROS", "0")
    reset_config()
    yield
    monkeypatch.undo()
    reset_config()


def test_hot_items_checkpoint_stop_restore_is_exactly_once(no_linger):
    """A port run checkpointed (InMemoryBackend) mid-stream, stopped and
    restored emits exactly the rows of an uninterrupted run; 100k events
    at 5,000 events/s fire panes before and after the barrier.  The input
    coalescer's linger is pinned at 0, so no two 4,096-row batches merge:
    which ones would merge depends on when they arrive, new keys take
    slots in the order batches reach the state, and the 10th-place ties
    follow slot order (ROADMAP C6)."""
    def prog(sink):
        return hot_items_program(100_000, 4_096, sink=sink,
                                 event_rate=5_000.0, base_time_micros=0)

    clear_sink("hot-ref")
    LocalRunner(prog("hot-ref"), device="cpu").run()
    reference = _rows(sink_output("hot-ref"))
    assert reference

    clear_sink("hot-rt")
    program = prog("hot-rt")
    agg_id = next(n.operator_id for n in program.nodes()
                  if "top_n" in n.operator_id and "sliding" in n.operator_id)

    async def phase1():
        engine = Engine(program, "hot-rt", InMemoryBackend(), device="cpu")
        running = engine.start()
        state = engine.members[(agg_id, 0)][0].state
        while state.total_rows < 40_000:  # mid-stream, past a pane fire
            await asyncio.sleep(0.001)
        await running.checkpoint(1, then_stop=True)
        assert await running.wait_for_checkpoint(1, timeout=60)
        await running.join()

    asyncio.run(phase1())
    emitted_before = len(_rows(sink_output("hot-rt")))
    assert 0 < emitted_before < len(reference)

    async def phase2():
        engine = Engine(program, "hot-rt", InMemoryBackend(),
                        restore_epoch=1, device="cpu")
        await engine.start().join()

    asyncio.run(phase2())
    assert _rows(sink_output("hot-rt")) == reference
