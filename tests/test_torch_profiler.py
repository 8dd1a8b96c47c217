"""The phase profiler (obs/profiler.py) against the JAX package's: the
same q5 program gives the same (operator, phase) buckets in both; nested
phases stay exclusive; the stall watchdog names a blocking call and its
sampler thread ends with the run; disarmed, nothing is recorded."""

import asyncio
import threading
import time

import pytest

import bench
from arroyo_tpu.config import reset_config as jax_reset_config
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.obs import profiler as jax_profiler
from arroyo_tpu.sql import plan_sql as jax_plan_sql
from arroyo_tpu_torch.config import reset_config
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import LocalRunner
from arroyo_tpu_torch.obs import profiler
from arroyo_tpu_torch.obs.metrics import job_operator_summary
from arroyo_tpu_torch.sql import plan_sql

N, B = 200_000, 16_384


def q5_sql(n=N, b=B):
    """bench.py's q5 with the event-time origin pinned, so windows align
    run to run."""
    return bench.Q5.format(n=n, b=b).replace(
        f"batch_size = '{b}'", f"batch_size = '{b}', base_time_micros = '0'")


@pytest.fixture(autouse=True)
def _disarm(monkeypatch):
    # a merge of coalesced batches depends on arrival time: no linger; and
    # the JAX side on one device's state, as the port (conftest's 8 CPU
    # devices would pick its mesh state, which launches per batch)
    monkeypatch.setenv("COALESCE_LINGER_MICROS", "0")
    monkeypatch.setenv("ARROYO_MESH", "off")
    reset_config(), jax_reset_config()
    profiler.disarm()
    jax_profiler.disarm()
    yield
    profiler.disarm()
    jax_profiler.disarm()
    monkeypatch.undo()
    reset_config(), jax_reset_config()


def test_phase_keys_match_jax():
    """The same SQL through both engines: equal (operator, phase) work
    buckets, equal wait phases, and each names the expected choke
    points; the port's phases sum to the order of the run's wall."""
    jprof = jax_profiler.arm("prof-job")
    JaxLocalRunner(jax_plan_sql(q5_sql()), job_id="prof-job").run()
    prof = profiler.arm("prof-job")
    clear_sink("results")
    t0 = time.perf_counter()
    LocalRunner(plan_sql(q5_sql()), job_id="prof-job", device="cpu").run()
    wall = time.perf_counter() - t0
    assert sink_output("results")
    want, got = jprof.work_snapshot(), prof.work_snapshot()
    assert set(got) == set(want)
    assert ({ph for _op, ph in prof.wait_snapshot()}
            == {ph for _op, ph in jprof.wait_snapshot()})
    snap = prof.snapshot()
    for phase in ("source_decode", "proc", "dispatch", "watermark",
                  "shuffle_prep"):
        assert snap["phases"].get(phase, 0.0) > 0.0, snap["phases"]
    assert "queue_wait" in snap["waits"]
    assert 0.0 < sum(snap["phases"].values()) < 1.5 * wall
    # the rollup carries the buckets as phase_seconds.* keys
    summary = job_operator_summary("prof-job")
    op, phase = next(iter(got))
    assert summary[op][f"phase_seconds.{phase}"] == round(got[(op, phase)],
                                                          6)
    assert (prof.collapsed_stacks().splitlines()[0].split(";")[0]
            == "prof-job")


def test_phase_nesting_is_exclusive():
    """A child frame's full span (waits included) subtracts from its
    parent, so nested phases never double-count."""
    prof = profiler.arm("t")
    prof.reset()
    outer = prof.begin("op", "proc")
    time.sleep(0.02)
    inner = prof.begin("op", "dispatch")
    time.sleep(0.03)
    prof.end(inner)
    wait = prof.begin("op", "send_wait", wait=True)
    time.sleep(0.02)
    prof.end(wait)
    prof.end(outer)
    work = prof.work_snapshot()
    waits = prof.wait_snapshot()
    assert 0.025 <= work[("op", "dispatch")] <= 0.06
    assert 0.015 <= waits[("op", "send_wait")] <= 0.05
    # proc is exclusive: ~0.02, never the inclusive ~0.07
    assert work[("op", "proc")] < 0.04
    total = sum(work.values()) + sum(waits.values())
    assert 0.06 <= total <= 0.12


def _watchdog_threads():
    return [t for t in threading.enumerate()
            if t.name == "arroyo-loop-watchdog"]


def test_watchdog_catches_blocking_sleep():
    """An injected time.sleep on the event loop is caught in the act: a
    stall event naming the blocking frame, once an episode."""
    prof = profiler.arm("wd-test")
    prof.watchdog.reset()

    async def scenario():
        prof.watchdog.ensure_ticker()
        await asyncio.sleep(0.1)  # let the ticker and sampler spin up
        time.sleep(0.5)  # the blocking call
        await asyncio.sleep(0.2)  # the stall ends; the sampler re-arms

    try:
        asyncio.run(scenario())
    finally:
        prof.watchdog.stop()
    stats = prof.watchdog.stats()
    assert 1 <= stats["stalls"] <= 2, stats
    stacks = "".join(s["stack"] for s in prof.watchdog.stalls)
    assert "time.sleep" in stacks or "scenario" in stacks, stacks
    assert not _watchdog_threads()


def test_watchdog_quiet_loop_records_no_stalls():
    prof = profiler.arm("wd-quiet")
    prof.watchdog.reset()

    async def scenario():
        prof.watchdog.ensure_ticker()
        for _ in range(10):
            await asyncio.sleep(0.02)

    try:
        asyncio.run(scenario())
    finally:
        prof.watchdog.stop()
    assert prof.watchdog.stats()["stalls"] == 0


def test_watchdog_thread_ends_with_the_run():
    """Armed, the engine starts the watchdog's ticker and sampler thread;
    LocalRunner.run stops and joins the thread, and the profiler stays
    armed with its buckets."""
    prof = profiler.arm("prof-job")
    runner = LocalRunner(plan_sql(q5_sql()), job_id="prof-job",
                         device="cpu")
    seen = []

    async def run():
        async def look():
            await asyncio.sleep(0.05)
            seen.append(len(_watchdog_threads()))

        looker = asyncio.ensure_future(look())
        await runner.run_async()
        await looker

    asyncio.run(run())
    assert seen == [1]  # the sampler ran during the run
    assert profiler.active() is prof and prof.work_snapshot()
    assert not _watchdog_threads()


def test_off_path_records_nothing():
    """Disarmed (the default): no profiler exists and a run creates no
    buckets anywhere."""
    assert profiler.active() is None
    LocalRunner(plan_sql(q5_sql(20_000)), job_id="prof-off",
                device="cpu").run()
    assert profiler.active() is None
    for keys in job_operator_summary("prof-off").values():
        assert not any(k.startswith(("phase_seconds.", "wait_seconds."))
                       for k in keys)


@pytest.mark.parametrize("armed", [False, True])
def test_broadcast_park_is_send_wait(armed):
    """A producer whose watermark broadcast parks on a full downstream
    queue charges the park to a ``send_wait`` wait child, not to its
    ``watermark`` work phase (ROADMAP C15: the JAX package charges it to
    the work phase); the queue receives the same messages armed or not."""
    from arroyo_tpu_torch.engine.context import Collector, OutQueue
    from arroyo_tpu_torch.types import Message, Watermark

    prof = profiler.arm("c15") if armed else None
    q = OutQueue(asyncio.Queue(maxsize=1))
    col = Collector([[q]], op_id="src")
    park = 0.2

    async def main():
        await q.queue.put(Message.stop())  # the queue is full

        async def drain():
            await asyncio.sleep(park)
            return [await q.queue.get(), await q.queue.get()]

        task = asyncio.ensure_future(drain())
        frame = prof.begin("src", "watermark") if armed else None
        await col.broadcast(Message.wm(Watermark.event_time(1_000)))
        if armed:
            prof.end(frame)
        return await task

    got = asyncio.run(main())
    assert [m.kind for m in got] == [Message.stop().kind,
                                    Message.wm(Watermark.event_time(1_000)
                                               ).kind]
    assert got[1].watermark == Watermark.event_time(1_000)
    if armed:
        assert prof.wait_snapshot()[("src", "send_wait")] >= 0.8 * park
        assert prof.work_snapshot()[("src", "watermark")] < 0.5 * park
