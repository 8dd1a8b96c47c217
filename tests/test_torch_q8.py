"""Nexmark q8 through the port against arroyo_tpu: bench.py's q8 SQL
through the JAX engine and ``q8_program`` through the port's engine emit
the same rows, with the join's hot-partition rings forced on in both so
the CPU run goes through the ring merge and gather (and, on the legacy
layout, through the device branch of ``join_pairs``); and a port run
checkpointed, stopped and restored emits exactly the rows of an
uninterrupted one."""

import asyncio

import numpy as np
import pytest

import bench
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.sql import plan_sql
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
from arroyo_tpu_torch.obs import perf
from arroyo_tpu_torch.q8 import q8_program
from arroyo_tpu_torch.state.backend import InMemoryBackend

N, BATCH = 200_000, 16_384


@pytest.fixture
def ring_knobs(monkeypatch):
    """The rings of the JAX engine on an accelerator, on the CPU: device
    join on (``auto`` is off on the CPU) and a hot-partition floor small
    enough for 200k events."""
    monkeypatch.setenv("ARROYO_DEVICE_JOIN", "on")
    monkeypatch.setenv("ARROYO_JOIN_HOT_MIN_ROWS", "16")


def _rows(batches):
    """Sorted (timestamp, id, np, na) sink rows."""
    return sorted((int(b.timestamp[i]), int(b.columns["id"][i]),
                   int(b.columns["np"][i]), int(b.columns["na"][i]))
                  for b in batches for i in range(len(b)))


def _port_rows(sink, rate, batch=BATCH):
    clear_sink(sink)
    LocalRunner(q8_program(N, batch, sink, event_rate=float(rate),
                           base_time_micros=0), device="cpu").run()
    return _rows(sink_output(sink))


@pytest.mark.parametrize("rate", [1_000_000, 10_000])
def test_q8_port_matches_jax_sql_plan(ring_knobs, rate):
    """200k events, batch 16,384, event-time origin pinned; bench.py's
    rate (one window, fired at the final watermark) and 10,000/s, which
    spans 20 s so windows fire mid-stream and the rings merge deltas."""
    sql = bench.Q8.format(n=N, b=BATCH).replace(
        f"batch_size = '{BATCH}'",
        f"batch_size = '{BATCH}', base_time_micros = '0'"
    ).replace("event_rate = '1000000'", f"event_rate = '{rate}'")
    jax_clear_sink("results")
    JaxLocalRunner(plan_sql(sql)).run()
    want = _rows(jax_sink_output("results"))
    perf.reset()
    got = _port_rows("q8-port", rate)
    assert want and got == want
    assert perf.counter("join_state_promotions") > 0
    assert perf.counter("join_device_gather_rows") > 0
    if rate == 10_000:
        assert perf.counter("join_state_device_merges") > 0


def test_q8_legacy_join_layout_emits_the_same_rows(ring_knobs, monkeypatch):
    """``ARROYO_JOIN_STATE=legacy`` (flat buffers re-sorted at each fire)
    emits the partitioned layout's rows; under ``ARROYO_DEVICE_JOIN=on``
    the fires pair their keys on the device branch of ``join_pairs``
    (the sort, u64 probe and expansion kernels' plain versions here)."""
    want = _port_rows("q8-part", 10_000)
    monkeypatch.setenv("ARROYO_JOIN_STATE", "legacy")
    perf.reset()
    assert _port_rows("q8-legacy", 10_000) == want
    assert perf.counter("join_pairs_device") > 0


@pytest.fixture
def short_queues(monkeypatch):
    """Edge queues of 4 messages, so the source cannot run more than a
    few batches ahead of the join (the barrier below must find it
    mid-stream, however loaded the machine is)."""
    from arroyo_tpu_torch.config import reset_config

    monkeypatch.setenv("QUEUE_SIZE", "4")
    reset_config()
    yield
    reset_config()  # re-read after monkeypatch restores the environment


def test_q8_checkpoint_stop_restore_is_exactly_once(ring_knobs, short_queues):
    """A port run checkpointed (InMemoryBackend) once the first window has
    reached the sink, stopped and restored emits exactly the rows of an
    uninterrupted run: join buffers, aggregate state and timers all
    restore.  Batches of 2,048 spread the stream over ~100 batches."""
    batch = 2_048
    reference = _port_rows("q8-ref", 10_000, batch)
    assert reference
    clear_sink("q8-rt")
    program = q8_program(N, batch, "q8-rt", event_rate=10_000.0,
                         base_time_micros=0)

    async def phase1():
        engine = Engine(program, "q8-rt", InMemoryBackend(), device="cpu")
        running = engine.start()
        while not sink_output("q8-rt"):  # mid-stream, past a window fire
            await asyncio.sleep(0.001)
        await running.checkpoint(1, then_stop=True)
        assert await running.wait_for_checkpoint(1, timeout=60)
        await running.join()

    asyncio.run(phase1())
    emitted_before = len(_rows(sink_output("q8-rt")))
    assert 0 < emitted_before < len(reference)

    async def phase2():
        engine = Engine(program, "q8-rt", InMemoryBackend(),
                        restore_epoch=1, device="cpu")
        await engine.start().join()

    asyncio.run(phase2())
    assert _rows(sink_output("q8-rt")) == reference


def test_q8_join_keys_are_float32_with_a_zero_nonce():
    """The join-key map casts keys to float32 as the JAX planner does and
    gives valid rows nonce 0, NULL-keyed rows unique nonces."""
    from arroyo_tpu_torch.ops.expr import join_key_fn, normalize_join_key

    fn = join_key_fn(lambda c: {"__jk0": normalize_join_key(c["x"])},
                     ["__jk0"])
    out = fn({"__timestamp": np.zeros(4, np.int64),
              "x": np.array([1.0, np.nan, 3.0, np.nan])})
    assert out["__jk0"].dtype == np.float32
    nonce = out["__jknonce"]
    assert nonce.dtype == np.int64 and nonce[0] == nonce[2] == 0
    assert nonce[1] != 0 and nonce[3] != 0 and nonce[1] != nonce[3]


def test_float32_join_key_hashes_match_jax():
    """The join's key hash over (float32 id, float32 window end, i64
    nonce) is bit-identical to the JAX package's, so rows route to the
    same join partitions."""
    from arroyo_tpu.types import hash_columns as jax_hash
    from arroyo_tpu_torch.types import hash_columns

    rng = np.random.default_rng(59)
    cols = [rng.integers(0, 2**24, 5000).astype(np.float32),
            (rng.integers(1, 5, 5000) * 10_000_000).astype(np.float32),
            np.where(rng.random(5000) < 0.1, rng.integers(1, 2**62, 5000),
                     0)]
    np.testing.assert_array_equal(hash_columns(cols), jax_hash(cols))
