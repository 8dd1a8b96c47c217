"""The port's multi-way join against arroyo_tpu's, on the CPU:

* tests/test_join_state.py's ``MW_SQL`` (q8 extended by each person's
  bids as bidder: persons, sellers and bidders per 10 s tumble) and
  ``MW_TTL_SQL`` (a three-way self-join of the expensive bids on the
  auction, with TTL state) at that file's sizes: one ``multi_way_join``
  node, the JAX plan node for node, rows equal to the JAX run's and to
  the port's own ``ARROYO_MULTIWAY=0`` (nested pairwise) run;
* a second join on a different key keeps the pairwise plan;
* ``MultiWayJoinOperator`` in TTL mode alone, with the join rings forced
  on (its probes through the ring kernels' plain versions), fed one
  fixed sequence of three sides' batches and watermarks: every emitted
  batch equal to the JAX operator's;
* the ``j0``..``j2`` side buffers snapshotted by either package's
  operator mid-sequence restore in the other, which then emits the same
  batches."""

import asyncio
import os
import sys

import numpy as np
import pytest

from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.engine.operators_window import (
    MultiWayJoinOperator as JaxMultiWay)
from arroyo_tpu.sql import plan_sql as jax_plan_sql
from arroyo_tpu.state.join_state import PartitionedJoinBuffer as JaxBuffer
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.engine.operators_window import MultiWayJoinOperator
from arroyo_tpu_torch.obs import perf
from arroyo_tpu_torch.sql import plan_sql
from arroyo_tpu_torch.state.join_state import PartitionedJoinBuffer
from arroyo_tpu_torch.types import Batch, hash_columns

sys.path.insert(0, os.path.dirname(__file__))
from test_join_state import MW_SQL, MW_TTL_SQL  # noqa: E402
from test_torch_sql_plan import _signature  # noqa: E402

MW_COLS = ("id", "np", "na", "nb")
TTL_COLS = ("a1", "p2", "b3")


def _kinds(prog):
    return sorted(prog.node(n).operator.kind.value
                  for n in prog.topo_order() if "join" in n)


def _rows(batches, cols):
    """The sink rows as one sorted structured array (a field a column)."""
    parts = {c: np.concatenate([b.columns[c] for b in batches])
             for c in cols}
    rows = np.empty(len(parts[cols[0]]),
                    dtype=[(c, parts[c].dtype) for c in cols])
    for c in cols:
        rows[c] = parts[c]
    return np.sort(rows, order=list(cols))


def _port(sql, cols):
    clear_sink("results")
    prog = plan_sql(sql)
    LocalRunner(prog, device="cpu").run()
    return prog, _rows(sink_output("results"), cols)


def _jax(sql, cols):
    jax_clear_sink("results")
    prog = jax_plan_sql(sql)
    JaxLocalRunner(prog).run()
    return prog, _rows(jax_sink_output("results"), cols)


@pytest.fixture
def ring_knobs(monkeypatch):
    """Both packages' join rings on, on the CPU."""
    monkeypatch.setenv("ARROYO_DEVICE_JOIN", "on")
    monkeypatch.setenv("ARROYO_JOIN_HOT_MIN_ROWS", "16")
    monkeypatch.setenv("ARROYO_MESH", "off")


@pytest.mark.parametrize("query", ["windowed", "ttl"])
def test_multiway_plan_and_rows_match_jax(query, monkeypatch):
    sql, cols = (MW_SQL, MW_COLS) if query == "windowed" else (MW_TTL_SQL,
                                                               TTL_COLS)
    monkeypatch.setenv("ARROYO_MULTIWAY", "1")
    jax_prog, want = _jax(sql, cols)
    perf.reset()
    prog, got = _port(sql, cols)
    assert _kinds(prog) == ["multi_way_join"]
    assert _signature(prog) == _signature(jax_prog)
    assert len(want) and np.array_equal(got, want)
    monkeypatch.setenv("ARROYO_MULTIWAY", "0")
    pairwise, rows = _port(sql, cols)
    assert _kinds(pairwise) == (
        ["window_join", "window_join"] if query == "windowed"
        else ["join_with_expiration", "join_with_expiration"])
    assert np.array_equal(rows, want)


def test_multiway_bails_on_different_keys(monkeypatch):
    monkeypatch.setenv("ARROYO_MULTIWAY", "1")
    sql = """
CREATE TABLE nexmark WITH (
  connector = 'nexmark', event_rate = '1000000', num_events = '2000',
  rate_limited = 'false', batch_size = '512');
WITH b AS (SELECT bid.auction AS auction, bid.bidder AS bidder,
                  bid.price AS price FROM nexmark WHERE bid is not null)
SELECT X.price AS p1, Y.price AS p2, Z.price AS p3
FROM b X
JOIN b Y ON X.auction = Y.auction
JOIN b Z ON X.bidder = Z.bidder
"""
    prog = plan_sql(sql)
    assert _kinds(prog) == ["join_with_expiration", "join_with_expiration"]
    assert _signature(prog) == _signature(jax_plan_sql(sql))


class _State:
    def __init__(self, make):
        self.make = make
        self.tables = {}

    def get_join_buffer(self, name, *_args, **_kw):
        return self.tables.setdefault(name, self.make())


class _Ctx:
    def __init__(self, make):
        self.state = _State(make)
        self.out = []

    async def collect(self, batch):
        self.out.append(batch)

    async def broadcast(self, _msg):
        pass


def _steps(seed, n_steps=15):
    """Batches on three sides over a 40-key space and watermarks; a
    4,000 us TTL, so rows expire mid-sequence."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(n_steps):
        side = int(rng.integers(0, 3))
        n = int(rng.integers(20, 60))
        cols = {"k": rng.integers(0, 40, n),
                f"v{side}": rng.integers(-2**40, 2**40, n)}
        ts = i * 1_000 + rng.integers(0, 1_000, n)
        steps.append(("batch", side, ts, cols))
        if i % 3 == 2:
            steps.append(("wm", i * 1_000, None, None))
    return steps


def _run(op, ctx, steps):
    async def go():
        await op.on_start(ctx)
        for kind, side, ts, cols in steps:
            if kind == "wm":
                await op.handle_watermark(side, ctx)
                continue
            cls = Batch if isinstance(op, MultiWayJoinOperator) else JaxBatch
            await op.process_batch(cls(ts, dict(cols),
                                       hash_columns([cols["k"]]), ("k",)),
                                   ctx, side)

    asyncio.run(go())
    return ctx.out


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.timestamp, w.timestamp)
        assert list(g.columns) == list(w.columns)
        for c in g.columns:
            np.testing.assert_array_equal(g.columns[c], w.columns[c],
                                          err_msg=c)


def _port_ctx():
    return _Ctx(lambda: PartitionedJoinBuffer(device="cpu"))


def test_multiway_ttl_operator_emits_jax_batches(ring_knobs):
    steps = _steps(31)
    port = MultiWayJoinOperator("m", None, 4_000, 3, device="cpu")
    jax_op = JaxMultiWay("m", None, 4_000, 3)
    perf.reset()
    got = _run(port, _port_ctx(), steps)
    want = _run(jax_op, _Ctx(JaxBuffer), steps)
    _same_batches(got, want)
    assert sum(len(b) for b in got) > 0
    assert perf.counter("join_ring_probes") > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_multiway_buffers_restore_across_packages(ring_knobs, direction):
    steps = _steps(37)
    half = len(steps) // 2
    src_port = direction == "port_to_jax"
    src = (MultiWayJoinOperator("m", None, 4_000, 3, device="cpu")
           if src_port else JaxMultiWay("m", None, 4_000, 3))
    _run(src, _port_ctx() if src_port else _Ctx(JaxBuffer), steps[:half])
    snaps = {f"j{i}": b.snapshot_batch() for i, b in enumerate(src.bufs)}
    assert sum(len(s) for s in snaps.values() if s is not None) > 0

    def restored(ctx, cls):
        for name, snap in snaps.items():
            if snap is None:
                continue
            ctx.state.get_join_buffer(name).restore_batch(cls(
                snap.timestamp, dict(snap.columns), snap.key_hash,
                snap.key_cols))
        return ctx

    port = MultiWayJoinOperator("m", None, 4_000, 3, device="cpu")
    jax_op = JaxMultiWay("m", None, 4_000, 3)
    got = _run(port, restored(_port_ctx(), Batch), steps[half:])
    want = _run(jax_op, restored(_Ctx(JaxBuffer), JaxBatch), steps[half:])
    _same_batches(got, want)
    assert sum(len(b) for b in got) > 0
