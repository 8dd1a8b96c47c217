"""The port's semi join (``x IN (SELECT ...)``) against arroyo_tpu's, on
the CPU:

* ``SemiJoinOperator`` alone, fed one fixed sequence of left and right
  batches and watermarks: every emitted batch equal, rows and order, and
  the same pending left rows and right keys at the end;
* its ``l`` (BATCH_BUFFER) and ``r`` (KEYED) tables snapshotted by either
  package mid-sequence restore in the other, which then emits the same
  batches for the rest of the sequence;
* SQL: the rows and NULL semantics of tests/test_sql.py's semi-join
  tests (a left row once per match, never once per right row; a NULL
  never matches, on either side), through both planners and engines;
* ``BatchBuffer.remove_keys`` and ``PartitionedJoinBuffer.remove_keys``
  against the JAX tables'."""

import asyncio

import numpy as np
import pytest

from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.engine.operators_window import (
    SemiJoinOperator as JaxSemiJoin)
from arroyo_tpu.sql import SchemaProvider as JaxProvider
from arroyo_tpu.sql.planner import Planner as JaxPlanner
from arroyo_tpu.state.join_state import PartitionedJoinBuffer as JaxBuffer
from arroyo_tpu.state.tables import BatchBuffer as JaxFlatBuffer
from arroyo_tpu.state.tables import KeyedState as JaxKeyedState
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.engine.operators_window import SemiJoinOperator
from arroyo_tpu_torch.sql import SchemaProvider
from arroyo_tpu_torch.sql.planner import Planner
from arroyo_tpu_torch.state.join_state import PartitionedJoinBuffer
from arroyo_tpu_torch.state.tables import BatchBuffer, KeyedState
from arroyo_tpu_torch.types import Batch, hash_columns


class _State:
    def __init__(self, flat, keyed):
        self.flat, self.keyed = flat, keyed
        self.tables = {}

    def get_batch_buffer(self, name, *_args, **_kw):
        return self.tables.setdefault(name, self.flat())

    def get_keyed_state(self, name, *_args, **_kw):
        return self.tables.setdefault(name, self.keyed())


class _Ctx:
    """What the operator touches of its task context."""

    def __init__(self, flat, keyed):
        self.state = _State(flat, keyed)
        self.out = []

    async def collect(self, batch):
        self.out.append(batch)

    async def broadcast(self, _msg):
        pass


def _steps(seed, n_steps=16):
    """Left and right batches over a 50-key space (left rows wait, right
    keys arrive late, some keys re-sighted out of time order) and
    watermarks, with TTLs of 3,000 us so keys and rows expire."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(n_steps):
        side = int(rng.random() < 0.45)
        n = int(rng.integers(20, 80))
        k = rng.integers(0, 50, n)
        cols = {"k": k, "v": rng.integers(-2**40, 2**40, n)}
        ts = i * 1_000 + rng.integers(-1_500, 1_000, n)
        steps.append(("batch", side, ts, cols))
        if i % 4 == 3:
            steps.append(("wm", i * 1_000 - 2_000, None, None))
    return steps


def _port_ctx():
    return _Ctx(BatchBuffer, KeyedState)


def _jax_ctx():
    return _Ctx(JaxFlatBuffer, JaxKeyedState)


def _run(op, ctx, steps, start=True):
    async def go():
        if start:
            await op.on_start(ctx)
        for kind, side, ts, cols in steps:
            if kind == "wm":
                await op.handle_watermark(side, ctx)
                continue
            cls = Batch if isinstance(op, SemiJoinOperator) else JaxBatch
            kh = hash_columns([cols["k"]])
            await op.process_batch(cls(ts, dict(cols), kh, ("k",)), ctx,
                                   side)

    asyncio.run(go())
    return ctx.out


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.timestamp, w.timestamp)
        np.testing.assert_array_equal(g.key_hash, w.key_hash)
        assert list(g.columns) == list(w.columns)
        for c in g.columns:
            np.testing.assert_array_equal(g.columns[c], w.columns[c])


TTL = 3_000


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_semi_join_operator_emits_jax_batches(seed):
    steps = _steps(seed)
    port, jax_op = SemiJoinOperator("s", TTL, TTL), JaxSemiJoin("s", TTL, TTL)
    got = _run(port, _port_ctx(), steps)
    want = _run(jax_op, _jax_ctx(), steps)
    _same_batches(got, want)
    assert sum(len(b) for b in got) > 0
    pend, jpend = port.left.all(), jax_op.left.all()
    assert (pend is None) == (jpend is None)
    if pend is not None:
        np.testing.assert_array_equal(pend.key_hash, jpend.key_hash)
    assert sorted(port.rkeys.snapshot()) == sorted(jax_op.rkeys.snapshot())


def test_semi_join_emits_a_left_row_once():
    """Repeated right keys release a waiting left row once, and a left
    row arriving after its key emits at once, once."""
    port = SemiJoinOperator("s", 10**9, 10**9)
    k = lambda *v: np.array(v)  # noqa: E731
    steps = [("batch", 0, np.array([1, 2, 3]), {"k": k(5, 6, 5),
                                                "v": k(1, 2, 3)}),
             ("batch", 1, np.array([4, 5]), {"k": k(5, 5), "v": k(0, 0)}),
             ("batch", 1, np.array([6]), {"k": k(5), "v": k(0)}),
             ("batch", 0, np.array([7]), {"k": k(5), "v": k(4)})]
    out = _run(port, _port_ctx(), steps)
    assert sorted(int(v) for b in out for v in b.columns["v"]) == [1, 3, 4]
    assert len(port.left) == 1  # key 6 waits


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_semi_join_tables_restore_across_packages(direction):
    steps = _steps(21)
    half = len(steps) // 2
    src_port = direction == "port_to_jax"
    src = (SemiJoinOperator("s", TTL, TTL) if src_port
           else JaxSemiJoin("s", TTL, TTL))
    _run(src, _port_ctx() if src_port else _jax_ctx(), steps[:half])
    lsnap, rsnap = src.left.snapshot_batch(), src.rkeys.snapshot()
    assert lsnap is not None and len(lsnap) and rsnap

    def restored(ctx, cls):
        ctx.state.get_batch_buffer("l").restore_batch(cls(
            lsnap.timestamp, dict(lsnap.columns), lsnap.key_hash,
            lsnap.key_cols))
        ctx.state.get_keyed_state("r").restore(list(rsnap))
        return ctx

    port, jax_op = SemiJoinOperator("s", TTL, TTL), JaxSemiJoin("s", TTL, TTL)
    got = _run(port, restored(_port_ctx(), Batch), steps[half:])
    want = _run(jax_op, restored(_jax_ctx(), JaxBatch), steps[half:])
    _same_batches(got, want)
    assert sum(len(b) for b in got) > 0


def test_remove_keys_matches_jax_tables():
    rng = np.random.default_rng(5)
    n = 3_000
    k = rng.integers(0, 300, n)
    cols = {"k": k, "v": rng.normal(size=n)}
    ts = np.sort(rng.integers(0, 10_000, n))
    kh = hash_columns([k])
    gone = kh[rng.choice(n, 40)]
    for port, jax_buf in ((BatchBuffer(), JaxFlatBuffer()),
                          (PartitionedJoinBuffer(device="cpu"),
                           JaxBuffer())):
        port.append(Batch(ts, dict(cols), kh, ("k",)))
        jax_buf.append(JaxBatch(ts, dict(cols), kh, ("k",)))
        port.evict_before(1_000)
        jax_buf.evict_before(1_000)
        port.remove_keys(gone)
        jax_buf.remove_keys(gone)
        got, want = port.snapshot_batch(), jax_buf.snapshot_batch()
        assert not np.isin(got.key_hash, gone).any()
        order_g = np.lexsort((got.timestamp, got.key_hash))
        order_w = np.lexsort((want.timestamp, want.key_hash))
        np.testing.assert_array_equal(got.key_hash[order_g],
                                      want.key_hash[order_w])
        np.testing.assert_array_equal(got.columns["v"][order_g],
                                      want.columns["v"][order_w])


def _providers(tables):
    jp, pp = JaxProvider(), SchemaProvider()
    for name, (kinds, ts, cols) in tables.items():
        jp.add_memory_table(name, kinds, [JaxBatch(ts.copy(), {
            c: v.copy() for c, v in cols.items()})])
        pp.add_memory_table(name, kinds, [Batch(ts.copy(), {
            c: v.copy() for c, v in cols.items()})])
    return jp, pp


def _both(tables, sql, cols):
    jp, pp = _providers(tables)
    jax_clear_sink("results")
    JaxLocalRunner(JaxPlanner(jp).plan(sql)).run()
    want = sorted(tuple(b.columns[c][i].item() for c in cols)
                  for b in jax_sink_output("results") for i in range(len(b)))
    clear_sink("results")
    LocalRunner(Planner(pp).plan(sql), device="cpu").run()
    got = sorted(tuple(b.columns[c][i].item() for c in cols)
                 for b in sink_output("results") for i in range(len(b)))
    return got, want


def test_sql_in_subquery_rows_match_jax():
    """tests/test_sql.py's shape: auction 2 twice on the right, 5 and 6
    never on the left; each matching bid exactly once."""
    lts = np.arange(6, dtype=np.int64) * 100
    tables = {
        "bids": ({"auction": "i", "price": "i"}, lts, {
            "auction": np.array([1, 2, 3, 4, 2, 9]),
            "price": np.array([10, 20, 30, 40, 21, 90])}),
        "hot": ({"a": "i"}, np.arange(4, dtype=np.int64) * 100, {
            "a": np.array([2, 3, 2, 5])})}
    got, want = _both(tables, "SELECT auction, price FROM bids WHERE "
                      "auction IN (SELECT a FROM hot)", ("auction", "price"))
    assert got == want == [(2, 20), (2, 21), (3, 30)]


def test_sql_in_subquery_null_never_matches():
    """A NULL left key is never IN anything, and a NULL in the subquery
    matches nothing."""
    ts = np.arange(3, dtype=np.int64) * 1000
    tables = {
        "l": ({"a": "f", "x": "i"}, ts, {
            "a": np.array([1.0, np.nan, 3.0]),
            "x": np.array([10, 11, 12], np.int64)}),
        "r": ({"b": "f"}, ts, {"b": np.array([np.nan, 3.0, 4.0])})}
    got, want = _both(tables, "SELECT x FROM l WHERE a IN (SELECT b FROM r)",
                      ("x",))
    assert got == want == [(12,)]
