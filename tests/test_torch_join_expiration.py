"""The port's join with expiration against arroyo_tpu's, on the CPU, with
the join state's rings forced on in both packages:

* ``JoinWithExpirationOperator`` alone, fed one fixed sequence of batches
  and watermarks on both sides: every emitted batch equal, rows and
  order, for INNER, LEFT, RIGHT and FULL, on both state layouts;
* its ``l``/``r`` BATCH_BUFFER tables snapshotted by either package
  restore in the other and join on identically;
* bench.py's join-stress through ``LocalRunner``: INNER rows equal the
  JAX run's as a set, LEFT net rows (CREATE minus DELETE) as a multiset;
* a checkpointed, stopped and restored run emits exactly the rows of an
  uninterrupted one."""

import asyncio
from collections import Counter

import numpy as np
import pytest

from arroyo_tpu import Stream as JaxStream
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.engine.operators_window import (
    JoinWithExpirationOperator as JaxJoinOperator)
from arroyo_tpu.graph.logical import JoinType as JaxJoinType
from arroyo_tpu.state.join_state import PartitionedJoinBuffer as JaxBuffer
from arroyo_tpu.state.tables import BatchBuffer as JaxFlatBuffer
from arroyo_tpu.types import Batch as JaxBatch
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.connectors.registry import validate_config
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
from arroyo_tpu_torch.engine.operators_window import JoinWithExpirationOperator
from arroyo_tpu_torch.graph.logical import JoinType
from arroyo_tpu_torch.join_stress import (BASE_TIME_MICROS, LEFT_COLS,
                                          PLANNER_TTL_MICROS, RIGHT_COLS,
                                          join_stress_program, zipf_map)
from arroyo_tpu_torch.obs import perf
from arroyo_tpu_torch.state.backend import InMemoryBackend
from arroyo_tpu_torch.state.join_state import PartitionedJoinBuffer
from arroyo_tpu_torch.state.tables import BatchBuffer
from arroyo_tpu_torch.types import Batch, hash_columns

HOWS = ["inner", "left", "right", "full"]


@pytest.fixture
def ring_knobs(monkeypatch):
    """Both packages take the ring path on the CPU, on one device."""
    monkeypatch.setenv("ARROYO_DEVICE_JOIN", "on")
    monkeypatch.setenv("ARROYO_JOIN_HOT_MIN_ROWS", "16")
    monkeypatch.setenv("ARROYO_MESH", "off")


class _State:
    def __init__(self, make):
        self.make = make
        self.tables = {}

    def get_join_buffer(self, name, *_args, **_kw):
        return self.tables.setdefault(name, self.make())


class _Ctx:
    """What the operator touches of its task context: join buffers,
    ``collect`` and ``broadcast``."""

    def __init__(self, make):
        self.state = _State(make)
        self.out = []

    async def collect(self, batch):
        self.out.append(batch)

    async def broadcast(self, _msg):
        pass


def _steps(seed, n_steps=14):
    """A fixed interleaving of side batches (keys from a 60-key space, so
    sides match and miss) and watermarks, with a 2,500 us TTL so rows
    expire mid-sequence."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(n_steps):
        side = int(rng.random() < 0.5)
        n = int(rng.integers(60, 200))
        k = rng.integers(0, 60, n) + (100 if i == 5 else 0)  # 5: all new
        cols = {"k": k, f"v{side}": rng.integers(-2**40, 2**40, n),
                "x": rng.normal(size=n)}
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
            cls = Batch if isinstance(op, JoinWithExpirationOperator) \
                else JaxBatch
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
            assert g.columns[c].dtype == w.columns[c].dtype, c
            np.testing.assert_array_equal(g.columns[c], w.columns[c],
                                          err_msg=c)


def _operators(how, ttl=2_500):
    return (JoinWithExpirationOperator("j", ttl, ttl, JoinType(how)),
            JaxJoinOperator("j", ttl, ttl, JaxJoinType(how)))


@pytest.mark.parametrize("layout", ["partitioned", "legacy"])
@pytest.mark.parametrize("how", HOWS)
def test_operator_emits_jax_batches(ring_knobs, how, layout):
    """Matched CREATEs, null-padded CREATEs, pad retractions (DELETE) and
    expiry: the same batches in the same order as the JAX operator."""
    part = layout == "partitioned"
    steps = _steps(71)
    port, jax_op = _operators(how)
    got = _run(port, _Ctx(lambda: PartitionedJoinBuffer(device="cpu")
                          if part else BatchBuffer()), steps)
    want = _run(jax_op, _Ctx(JaxBuffer if part else JaxFlatBuffer), steps)
    _same_batches(got, want)
    assert sum(len(b) for b in got) > 0
    if how != "inner":
        ops = np.concatenate([b.columns["__op"] for b in got])
        assert (ops == 2).any() and (ops == 0).any()  # DELETE and CREATE
    if part:
        assert any(p.dev is not None for p in port.left.parts)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_join_tables_restore_across_packages(ring_knobs, direction):
    """The ``l``/``r`` tables snapshotted by one package's operator
    mid-sequence restore into either package's operator; the two then
    emit the same batches for the rest of the sequence (LEFT join, so
    the restored state also answers ``rows_with_keys``)."""
    steps = _steps(73)
    half = len(steps) // 2
    port, jax_op = _operators("left")
    src_port = direction == "port_to_jax"
    src = port if src_port else jax_op
    _run(src, _Ctx(lambda: PartitionedJoinBuffer(device="cpu")) if src_port
         else _Ctx(JaxBuffer), steps[:half])
    snaps = {n: getattr(src, side).snapshot_batch()
             for n, side in (("l", "left"), ("r", "right"))}
    assert all(s is not None and len(s) for s in snaps.values())

    def restored(make, cls):
        ctx = _Ctx(make)
        for name, snap in snaps.items():
            buf = ctx.state.get_join_buffer(name)
            buf.restore_batch(cls(snap.timestamp, dict(snap.columns),
                                  snap.key_hash, snap.key_cols))
        return ctx

    port2, jax2 = _operators("left")
    got = _run(port2, restored(lambda: PartitionedJoinBuffer(device="cpu"),
                               Batch), steps[half:])
    want = _run(jax2, restored(JaxBuffer, JaxBatch), steps[half:])
    _same_batches(got, want)
    assert sum(len(b) for b in got) > 0


N, BATCH = 20_000, 2_048


def _jax_program(n, how, ttl, sink):
    cfg = {"event_rate": 1e9, "message_count": n,
           "event_time_interval_micros": 1000,
           "base_time_micros": BASE_TIME_MICROS, "batch_size": BATCH}
    left = (JaxStream.source("impulse", cfg)
            .watermark(max_lateness_micros=0)
            .udf(zipf_map(0), name="zl").key_by("k"))
    right = (JaxStream.source("impulse", cfg, program=left.program)
             .watermark(max_lateness_micros=0)
             .udf(zipf_map(1), name="zr").key_by("k"))
    return left.join_with_expiration(right, ttl, ttl, JaxJoinType(how),
                                     LEFT_COLS, RIGHT_COLS,
                                     name="stress_join").sink(
        "memory", {"name": sink})


def _net_rows(batches):
    """Multiset of (k, v0, v1) rows, CREATEs minus DELETEs (-1 for a
    NULL side)."""
    net = Counter()
    for b in batches:
        n = len(b)
        op = b.columns.get("__op", np.zeros(n, np.int8))
        cols = [np.nan_to_num(np.asarray(b.columns.get(c, np.full(n, -1.0)),
                                         dtype=np.float64), nan=-1.0)
                for c in ("k", "v0", "v1")]
        for i in range(n):
            net[tuple(int(c[i]) for c in cols)] += -1 if op[i] == 2 else 1
    assert all(v >= 0 for v in net.values())
    return +net


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_stress_matches_jax(ring_knobs, how):
    """bench.py's join-stress streams with a TTL longer than the stream:
    INNER rows equal the JAX engine's as a set, LEFT net rows as a
    multiset (the two engines interleave the sides differently, which
    changes when pads are emitted and retracted, not what remains)."""
    jax_clear_sink("js")
    JaxLocalRunner(_jax_program(N, how, PLANNER_TTL_MICROS, "js")).run()
    perf.reset()
    clear_sink("js")
    LocalRunner(join_stress_program(N, JoinType(how), PLANNER_TTL_MICROS,
                                    "js", BATCH), device="cpu").run()
    want, got = _net_rows(jax_sink_output("js")), _net_rows(sink_output("js"))
    assert want and got == want
    if how == "inner":
        assert max(got.values()) == 1  # no pair twice
    assert perf.counter("join_state_device_merges") > 0
    assert perf.counter("join_device_gather_rows") > 0


def test_join_stress_checkpoint_stop_restore_is_exactly_once(
        ring_knobs, monkeypatch):
    """A run checkpointed into InMemoryBackend mid-stream, stopped and
    restored emits exactly the rows of an uninterrupted run: the impulse
    sources resume from their counters and the join state restores."""
    from arroyo_tpu_torch.config import reset_config

    monkeypatch.setenv("QUEUE_SIZE", "4")  # keep the sources close
    reset_config()
    n, batch = 8_000, 256  # 32 batches a side: the barrier lands mid-stream
    program = join_stress_program(n, JoinType.INNER, PLANNER_TTL_MICROS,
                                  "js-rt", batch)
    clear_sink("js-ref")
    LocalRunner(join_stress_program(n, JoinType.INNER, PLANNER_TTL_MICROS,
                                    "js-ref", batch), device="cpu").run()
    reference = _net_rows(sink_output("js-ref"))
    clear_sink("js-rt")

    async def phase1():
        engine = Engine(program, "js-rt", InMemoryBackend(), device="cpu")
        running = engine.start()
        while not sink_output("js-rt"):
            await asyncio.sleep(0.001)
        await running.checkpoint(1, then_stop=True)
        assert await running.wait_for_checkpoint(1, timeout=60)
        await running.join()

    asyncio.run(phase1())
    before = sum(_net_rows(sink_output("js-rt")).values())
    assert 0 < before < sum(reference.values())

    async def phase2():
        engine = Engine(program, "js-rt", InMemoryBackend(), restore_epoch=1,
                        device="cpu")
        await engine.start().join()

    asyncio.run(phase2())
    reset_config()
    assert _net_rows(sink_output("js-rt")) == reference


def test_impulse_config_validates():
    cfg = validate_config("impulse", {"message_count": "10",
                                      "batch_size": 4})
    assert cfg["message_count"] == 10 and cfg["event_rate"] == 1e6
    with pytest.raises(TypeError):
        validate_config("impulse", {"rate": 1})
    with pytest.raises(ValueError):
        validate_config("impulse", {"batch_size": 0})
