"""Nexmark q1 and q7 in the port against arroyo_tpu, on the CPU:

* ``q1_program`` / ``q7_program`` through the port's engine emit exactly
  the sorted rows of bench.py's Q1 / Q7 SQL through the JAX engine
  (``price_dol`` equal in f64), at bench.py's event rate and slower
  ones (5,000 events/s spreads 200k events over four 10 s windows);
* the raw mode of ``WindowArgmaxOperator`` against the JAX operator's on
  the same hand-built batches and watermarks: a late row tying a
  released maximum emits, one above it drops, a late row of an empty
  middle window emits nothing, and the final-extrema table ``f`` evicts
  past its TTL;
* ``TimeKeyMap`` snapshots restore across packages in both directions,
  alone and as the operator's table in the middle of a stream;
* a q7 run checkpointed, stopped and restored emits exactly the rows of
  an uninterrupted run, with ``f`` restored."""

import asyncio

import numpy as np
import pytest

import bench
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.context import TimerHeap as JaxTimerHeap
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.engine.operators_window import (
    WindowArgmaxOperator as JaxArgmax)
from arroyo_tpu.sql import plan_sql
from arroyo_tpu.state.tables import BatchBuffer as JaxBatchBuffer
from arroyo_tpu.state.tables import TimeKeyMap as JaxTimeKeyMap
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.context import TimerHeap
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
from arroyo_tpu_torch.engine.operators_window import WindowArgmaxOperator
from arroyo_tpu_torch.obs import perf
from arroyo_tpu_torch.q1 import q1_program
from arroyo_tpu_torch.q7 import q7_program
from arroyo_tpu_torch.state.backend import InMemoryBackend
from arroyo_tpu_torch.state.tables import BatchBuffer, TableType, TimeKeyMap
from arroyo_tpu_torch.types import Batch, hash_columns

SEC = 1_000_000
W = 10 * SEC


def _rows(batches):
    """Sorted (timestamp, column values by sorted name...) rows."""
    rows = []
    for b in batches:
        names = sorted(b.columns)
        cols = [b.columns[n].tolist() for n in names]
        rows.extend(zip(b.timestamp.tolist(), *cols))
    return sorted(rows)


def _sql(query, n, b, rate):
    return query.format(n=n, b=b).replace(
        f"batch_size = '{b}'", f"batch_size = '{b}', base_time_micros = '0'"
    ).replace("event_rate = '1000000'", f"event_rate = '{rate}'")


@pytest.mark.parametrize("rate", [1_000_000, 50_000, 5_000])
@pytest.mark.parametrize("query", ["q1", "q7"])
def test_port_matches_jax_sql_plan(query, rate):
    """200k events, batch 16,384, event time from 0: the port's rows
    equal the JAX engine's, sorted, every value exact (q1's price_dol
    is ``price * 0.908`` in f64 in both)."""
    n, b = 200_000, 16_384
    program, sql = {"q1": (q1_program, bench.Q1),
                    "q7": (q7_program, bench.Q7)}[query]
    jax_clear_sink("results")
    JaxLocalRunner(plan_sql(_sql(sql, n, b, rate))).run()
    want_batches = jax_sink_output("results")
    want = _rows(want_batches)
    sink = f"{query}-port"
    clear_sink(sink)
    LocalRunner(program(n, b, sink, event_rate=float(rate),
                        base_time_micros=0), device="cpu").run()
    got_batches = sink_output(sink)
    assert want and _rows(got_batches) == want
    assert ({c: v.dtype for c, v in got_batches[0].columns.items()}
            == {c: v.dtype for c, v in want_batches[0].columns.items()})
    if query == "q7":
        windows = {r[0] for r in want}
        assert len(windows) == {1_000_000: 1, 50_000: 1, 5_000: 4}[rate]


# -- raw-mode window argmax, operator against operator --------------------------


class _State:
    def __init__(self, buffer_cls, map_cls):
        self.buffer_cls, self.map_cls = buffer_cls, map_cls
        self.tables = {}

    def get_batch_buffer(self, name, *_args, **_kw):
        return self.tables.setdefault(name, self.buffer_cls())

    def get_time_key_map(self, name, *_args, **_kw):
        return self.tables.setdefault(name, self.map_cls())


class _Ctx:
    """What the operator touches of its task context: its tables, timers,
    the current watermark and ``collect``."""

    def __init__(self, port, last_watermark=None):
        self.state = (_State(BatchBuffer, TimeKeyMap) if port
                      else _State(JaxBatchBuffer, JaxTimeKeyMap))
        self.timers = TimerHeap() if port else JaxTimerHeap()
        self.last_watermark = last_watermark
        self.out = []

    async def collect(self, batch):
        self.out.append(batch)


def _bids(ends, prices, auction0=0):
    """Raw q7 rows as win_assign leaves them: timestamp window_end - 1,
    keyed by window_end."""
    ends = np.asarray(ends, dtype=np.int64)
    n = len(ends)
    cols = {"auction": np.arange(auction0, auction0 + n, dtype=np.int64),
            "price": np.asarray(prices, dtype=np.int64),
            "window_start": ends - W, "window_end": ends}
    return ends - 1, cols, hash_columns([ends])


# (step, payload): a batch of (window ends, prices) or a watermark
STEPS = [
    ("batch", ([W] * 4, [5, 9, 3, 9])),
    ("batch", ([W] * 3 + [3 * W], [8, 9, 11, 7])),  # 8 drops, 9 ties
    ("batch", ([3 * W] * 2, [7, 2])),
    ("wm", 2 * W),  # fires W; the middle window 2W saw no row
    # late: 11 ties W's released max (emits), 12 is above it, 3 below
    # (both drop); 100 in the empty middle window matches nothing
    ("batch", ([W, W, W, 2 * W, 3 * W], [11, 12, 3, 100, 7])),
    ("wm", 3 * W),  # fires 3W; f evicts W (TTL = one window span)
    # W's max is gone: its late 11 matches nothing; 3W's late 7 ties
    ("batch", ([W, 3 * W], [11, 7])),
    ("batch", ([4 * W, 4 * W], [np.iinfo(np.int64).max, 1])),
    ("wm", 5 * W),
]


def _operator(port):
    cls = WindowArgmaxOperator if port else JaxArgmax
    return cls("window_argmax_6", "price", "max", (("maxprice", "price"),),
               W, raw=True, late_ttl_micros=0)


async def _drive(op, ctx, steps, port, start=0):
    """The runner's order: a watermark advances ``last_watermark``, then
    fires the timers at or below it.  ``start`` is the index of the first
    step (auction ids are numbered by step)."""
    batch_cls = Batch if port else JaxBatch
    finals = []
    for i, (kind, payload) in enumerate(steps, start):
        if kind == "wm":
            ctx.last_watermark = payload
            for t, key, p in ctx.timers.fire(payload):
                await op.handle_timer(t, key, p, ctx)
        else:
            ts, cols, kh = _bids(*payload, auction0=100 * i)
            await op.process_batch(batch_cls(ts, cols, kh, ("window_end",)),
                                   ctx)
        finals.append(sorted(op.final.snapshot()))
    return finals


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.timestamp, w.timestamp)
        np.testing.assert_array_equal(g.key_hash, w.key_hash)
        assert list(g.columns) == list(w.columns)
        for c in g.columns:
            assert g.columns[c].dtype == w.columns[c].dtype, c
            np.testing.assert_array_equal(g.columns[c], w.columns[c])


def test_raw_argmax_matches_jax_operator():
    """Same batches and watermarks into both operators: the same emitted
    batches, in order, and the same ``f`` after every step."""
    out = {}
    perf.reset()
    for port in (True, False):
        op, ctx = _operator(port), _Ctx(port)

        async def go(_op=op, _ctx=ctx, _port=port):
            await _op.on_start(_ctx)
            return await _drive(_op, _ctx, STEPS, _port)

        out[port] = (asyncio.run(go()), ctx.out, op)
    (pf, pout, pop), (jf, jout, jop) = out[True], out[False]
    assert pf == jf
    _same_batches(pout, jout)
    assert pop.late_ttl == jop.late_ttl == W  # clamped to one window
    emitted = [(int(b.columns["window_end"][i]), int(b.columns["price"][i]))
               for b in pout for i in range(len(b))]
    # W fires its one 11; the late tying 11 emits at once, the late 12
    # and 3 and the empty middle window's 100 drop; 3W fires three 7s;
    # after f evicted W a late 11 matches nothing, 3W's late 7 emits
    assert emitted == [(W, 11), (W, 11)] + [(3 * W, 7)] * 4 + [
        (4 * W, np.iinfo(np.int64).max)]
    assert pf[3] == [(W, "x", 11)]
    assert pf[5] == [(3 * W, "x", 7)]  # W evicted past the TTL
    assert perf.counter("window_argmax_late_rows") == 6
    assert perf.counter("window_argmax_late_hits") == 2
    assert all(set(b.columns) == {"auction", "price", "window_start",
                                  "window_end", "maxprice"} for b in pout)


def test_raw_argmax_drops_nan_and_admits_ties():
    """NaN values never enter; rows tying the running max stay, rows
    below it drop before buffering (both packages)."""
    for port in (True, False):
        op, ctx = _operator(port), _Ctx(port)
        batch_cls = Batch if port else JaxBatch
        parts = [np.array([1.0, np.nan, 4.0]),
                 np.array([4.0, 2.0, np.nan])]

        async def go(_op=op, _ctx=ctx, _cls=batch_cls):
            await _op.on_start(_ctx)
            for price in parts:  # the first batch of a window: all kept
                ends = np.full(3, W, np.int64)
                await _op.process_batch(
                    _cls(ends - 1, {"price": price, "window_end": ends},
                         hash_columns([ends]), ("window_end",)), _ctx)
            return _op.buf.all()

        kept = asyncio.run(go())
        assert kept.columns["price"].tolist() == [1.0, 4.0, 4.0]
        assert op._running == {W: 4.0}


# -- TimeKeyMap across packages ----------------------------------------------------


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_time_key_map_restores_across_packages(direction):
    src_cls, dst_cls = ((TimeKeyMap, JaxTimeKeyMap)
                        if direction == "port_to_jax"
                        else (JaxTimeKeyMap, TimeKeyMap))
    src = src_cls()
    for t, v in ((W, np.int64(11)), (2 * W, np.float64(2.5)), (5, "s")):
        src.insert(t, "x", v)
    src.insert(W, "y", 3)
    src.evict_before(6)  # drops time 5
    dst = dst_cls()
    dst.restore(src.snapshot())
    assert sorted(dst.snapshot()) == sorted(src.snapshot())
    assert dst.get(W, "x") == 11 and dst.get(2 * W, "x") == 2.5
    assert dst.get_all_for_time(W) == {"x": 11, "y": 3}
    assert len(dst) == 3 and dst.all_times() == [W, 2 * W]
    assert TableType.TIME_KEY_MAP.value == "time_key_map"


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_raw_argmax_tables_restore_across_packages(direction):
    """One package runs the first four steps; its ``b`` and ``f`` tables
    and watermark restore into the other package's operator, which runs
    the rest: the same batches as that package run straight through."""
    src_port = direction == "port_to_jax"
    half = 4

    async def first(op, ctx):
        await op.on_start(ctx)
        await _drive(op, ctx, STEPS[:half], src_port)
        return ctx

    ctx = asyncio.run(first(_operator(src_port), _Ctx(src_port)))
    f_entries = ctx.state.tables["f"].snapshot()
    assert f_entries == [(W, "x", 11)]
    buffered = ctx.state.tables["b"].snapshot_batch()
    dst_batch = JaxBatch if src_port else Batch
    timers = ctx.timers.snapshot()

    async def rest(op, dctx):
        dctx.state.get_time_key_map("f").restore(f_entries)
        dctx.state.get_batch_buffer("b").restore_batch(dst_batch(
            buffered.timestamp, dict(buffered.columns), buffered.key_hash,
            buffered.key_cols))
        dctx.timers.restore(timers)
        await op.on_start(dctx)
        await _drive(op, dctx, STEPS[half:], not src_port, start=half)
        return dctx.out

    got = asyncio.run(rest(_operator(not src_port),
                           _Ctx(not src_port, last_watermark=2 * W)))

    async def straight(op, sctx):
        await op.on_start(sctx)
        await _drive(op, sctx, STEPS, not src_port)
        return sctx.out

    want = asyncio.run(straight(_operator(not src_port), _Ctx(not src_port)))
    first_out = len(ctx.out)
    _same_batches(got, want[first_out:])


def test_q7_checkpoint_stop_restore_is_exactly_once():
    """A q7 run checkpointed (InMemoryBackend) mid-stream, stopped and
    restored emits exactly the rows of an uninterrupted run, and the
    restored operator holds the final extrema of the windows released
    before the barrier.  200k events at 5,000 events/s span four 10 s
    windows; the source is held after its 15th batch of 8,192 (24.6 s of
    event time, two windows released) until the barrier is queued."""
    batch, hold_after = 8_192, 15

    def prog(sink):
        return q7_program(200_000, batch, sink, event_rate=5_000.0,
                          base_time_micros=0)

    clear_sink("q7-ref")
    LocalRunner(prog("q7-ref"), device="cpu").run()
    reference = _rows(sink_output("q7-ref"))
    assert len({r[0] for r in reference}) == 4

    clear_sink("q7-rt")
    program = prog("q7-rt")
    argmax_id = next(n.operator_id for n in program.nodes()
                     if n.operator.name == "window_argmax_6")
    finals = {}

    async def phase1():
        engine = Engine(program, "q7-rt", InMemoryBackend(), device="cpu")
        running = engine.start()
        source = next(h.runner for h in engine.subtasks.values()
                      if h.is_source)
        poll = source.poll_source_control
        held, batches = asyncio.Event(), [0]

        async def hold_then_poll():
            batches[0] += 1
            if batches[0] == hold_after:
                held.set()
                while source.control_rx.empty():
                    await asyncio.sleep(0.001)
            return await poll()

        source.poll_source_control = hold_then_poll
        await held.wait()
        await running.checkpoint(1, then_stop=True)
        assert await running.wait_for_checkpoint(1, timeout=60)
        await running.join()
        finals["before"] = sorted(
            engine.members[(argmax_id, 0)][0].final.snapshot())

    asyncio.run(phase1())
    emitted_before = _rows(sink_output("q7-rt"))
    assert 0 < len(emitted_before) < len(reference)
    assert [t for t, _k, _v in finals["before"]] == [W, 2 * W]

    async def phase2():
        engine = Engine(program, "q7-rt", InMemoryBackend(),
                        restore_epoch=1, device="cpu")
        await engine.start().join()
        finals["after"] = sorted(
            engine.members[(argmax_id, 0)][0].final.snapshot())

    asyncio.run(phase2())
    assert _rows(sink_output("q7-rt")) == reference
    # the windows released before the barrier fire no timer after the
    # restore: their extrema are in f only because f was restored
    assert set(finals["before"]) <= set(finals["after"])
    assert len(finals["after"]) == 4
