"""The port's engine slice against arroyo_tpu: nexmark generation, Nexmark
q5 end to end (SQL-planned on the JAX side, ``q5_program`` on the port
side), checkpoint/restore, device resolution, and that the port never
imports JAX or the JAX package."""

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink
from arroyo_tpu.connectors.memory import sink_output as jax_sink_output
from arroyo_tpu.connectors.nexmark import NexmarkConfig as JaxNexmarkConfig
from arroyo_tpu.connectors.nexmark import NexmarkGenerator as JaxGenerator
from arroyo_tpu.engine.engine import LocalRunner as JaxLocalRunner
from arroyo_tpu.sql import plan_sql
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.connectors.nexmark import NexmarkConfig, NexmarkGenerator
from arroyo_tpu_torch.device import resolve_device
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner
from arroyo_tpu_torch.q1 import q1_program
from arroyo_tpu_torch.q5 import q5_program
from arroyo_tpu_torch.q7 import q7_program
from arroyo_tpu_torch.state.backend import InMemoryBackend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(batches):
    """Sorted (timestamp, column values...) rows of sink batches."""
    rows = []
    for b in batches:
        names = sorted(b.columns)
        for i in range(len(b)):
            rows.append((int(b.timestamp[i]),)
                        + tuple(b.columns[n][i].item() for n in names))
    return sorted(rows)


@pytest.mark.parametrize("projection", [None, ["bid_auction", "bid_datetime",
                                               "event_type"],
                                        ["bid_channel", "bid_price",
                                         "event_type"]])
def test_nexmark_batches_match_jax_generator(projection):
    """(e) the first batches are identical column for column, timestamps
    included, with and without projection pushdown (the bid channel's
    family: channels, urls and padding strings)."""
    kw = dict(num_events=5000, rate_limited=False, event_rate=1_000_000.0,
              projection=projection)
    gens = [cls(cfg(**kw), 123, 1, 5000, 1, seed=0)
            for cls, cfg in ((JaxGenerator, JaxNexmarkConfig),
                             (NexmarkGenerator, NexmarkConfig))]
    for g in gens:
        g.set_rate(1_000_000.0, 1)
    for _ in range(3):
        (jb, jn), (pb, pn) = (g.next_batch(1000) for g in gens)
        np.testing.assert_array_equal(jb.timestamp, pb.timestamp)
        np.testing.assert_array_equal(jn, pn)
        assert list(jb.columns) == list(pb.columns)
        for name in jb.columns:
            np.testing.assert_array_equal(jb.columns[name], pb.columns[name],
                                          err_msg=name)


@pytest.mark.parametrize("rate", [1_000_000, 50_000])
def test_q5_port_matches_jax_sql_plan(rate):
    """(f) bench.py's q5 SQL through the JAX engine and ``q5_program``
    through the port's engine emit the same rows (200k events, batch
    16384, the event-time origin pinned so windows align; bench.py's
    event rate, and a slower one that spreads the events over 4 s of
    event time and so over more windows)."""
    n, b = 200_000, 16_384
    sql = bench.Q5.format(n=n, b=b).replace(
        f"batch_size = '{b}'", f"batch_size = '{b}', base_time_micros = '0'"
    ).replace("event_rate = '1000000'", f"event_rate = '{rate}'")
    jax_clear_sink("results")
    JaxLocalRunner(plan_sql(sql)).run()
    want = _rows(jax_sink_output("results"))
    clear_sink("q5-port")
    LocalRunner(q5_program(n, b, "q5-port", event_rate=float(rate),
                           base_time_micros=0), device="cpu").run()
    got = _rows(sink_output("q5-port"))
    assert want and got == want


def test_q5_checkpoint_stop_restore_is_exactly_once():
    """(f) a port run checkpointed (InMemoryBackend) mid-stream, stopped
    and restored emits exactly the rows of an uninterrupted run.  The
    slower event rate spreads 200k events over 4 s of event time, so
    panes fire before and after the barrier.  The source is held after
    its 15th batch (122,880 events) until the barrier is queued, so the
    barrier enters the stream there on every run, however the host
    schedules the tasks."""
    batch, hold_after = 8_192, 15

    def prog(sink):
        return q5_program(200_000, batch, sink, event_rate=50_000.0,
                          base_time_micros=0)

    clear_sink("q5-ref")
    LocalRunner(prog("q5-ref"), device="cpu").run()
    reference = _rows(sink_output("q5-ref"))
    assert reference

    clear_sink("q5-rt")
    program = prog("q5-rt")

    async def phase1():
        engine = Engine(program, "q5-rt", InMemoryBackend(), device="cpu")
        running = engine.start()
        source = next(h.runner for h in engine.subtasks.values()
                      if h.is_source)
        poll = source.poll_source_control
        held = asyncio.Event()
        batches = [0]

        async def hold_then_poll():
            # the source polls once a batch; after the 15th it waits for
            # the barrier before polling again
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
        assert batches[0] == hold_after  # stopped at the barrier

    asyncio.run(phase1())
    emitted_before = len(_rows(sink_output("q5-rt")))
    assert 0 < emitted_before < len(reference)

    async def phase2():
        engine = Engine(program, "q5-rt", InMemoryBackend(),
                        restore_epoch=1, device="cpu")
        await engine.start().join()

    asyncio.run(phase2())
    assert _rows(sink_output("q5-rt")) == reference


def test_entry_points_default_to_cuda_and_never_fall_back():
    """``device=None`` means CUDA: without a card the entry points raise
    instead of running on the host; ``device='cpu'`` is explicit."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalRunner(q5_program(1000, 500, "unused"))
    for program in (q1_program, q7_program):
        with pytest.raises(RuntimeError, match="CUDA"):
            LocalRunner(program(1000, 500, "unused"))


# modules the walk below must reach (added with q1/q7 and chaining)
NEW_MODULES = ("arroyo_tpu_torch.q1", "arroyo_tpu_torch.q7",
               "arroyo_tpu_torch.kernels.join_sort",
               "arroyo_tpu_torch.graph.chaining",
               "arroyo_tpu_torch.engine.chained",
               "arroyo_tpu_torch.engine.coalesce",
               "arroyo_tpu_torch.queries",
               "arroyo_tpu_torch.graph.factor_windows",
               "arroyo_tpu_torch.analysis.plan_validator",
               "arroyo_tpu_torch.ops.colmath",
               "arroyo_tpu_torch.sql.lexer",
               "arroyo_tpu_torch.sql.ast_nodes",
               "arroyo_tpu_torch.sql.parser",
               "arroyo_tpu_torch.sql.schema_provider",
               "arroyo_tpu_torch.sql.functions",
               "arroyo_tpu_torch.sql.compiler",
               "arroyo_tpu_torch.sql.planner",
               "arroyo_tpu_torch.obs.tracing",
               "arroyo_tpu_torch.obs.metrics",
               "arroyo_tpu_torch.obs.logging_setup",
               "arroyo_tpu_torch.obs.profiler",
               "arroyo_tpu_torch.obs.latency",
               "arroyo_tpu_torch.analysis.sanitizer",
               "arroyo_tpu_torch.native",
               "arroyo_tpu_torch.utils",
               "arroyo_tpu_torch.utils.storage",
               "arroyo_tpu_torch.state.backend",
               "arroyo_tpu_torch.connectors.two_phase",
               "arroyo_tpu_torch.connectors.filesystem",
               "arroyo_tpu_torch.connectors.single_file",
               "arroyo_tpu_torch.connectors.preview",
               "arroyo_tpu_torch.connectors.schema_registry",
               "arroyo_tpu_torch.kernels.ring_emit",
               "arroyo_tpu_torch.parallel",
               "arroyo_tpu_torch.parallel.ring_panes",
               "arroyo_tpu_torch.kernels.mesh_route",
               "arroyo_tpu_torch.kernels.mesh_merge",
               "arroyo_tpu_torch.kernels.mesh_remap",
               "arroyo_tpu_torch.parallel.mesh_window",
               "arroyo_tpu_torch.parallel.shuffle")


def test_port_imports_neither_jax_nor_the_jax_package():
    """(g) in a fresh interpreter, importing every arroyo_tpu_torch module
    leaves ``jax``, ``arroyo_tpu``, ``pydantic``, ``pyarrow``,
    ``prometheus_client``, ``fsspec``, ``aiokafka``, ``aiohttp`` and
    ``grpc`` (the card machine has none of the last seven) out of
    sys.modules (a subprocess, because this test process imported
    them already)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import arroyo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'arroyo_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'arroyo_tpu', 'pydantic', 'pyarrow', "
        "'prometheus_client', 'fsspec', 'aiokafka', 'aiohttp', 'grpc'))\n"
        "missing = sorted({" + ", ".join(repr(m) for m in NEW_MODULES)
        + "} - set(names))\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 20 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
