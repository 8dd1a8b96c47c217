"""config5's checkpoint cadence in the JAX package and in the PyTorch port,
on the CPU: bench.py's CONFIG5_SQL (JAX, planned by ``plan_sql``) and
``config5_program`` (port) over the same producer's events, each run by
its ``LocalRunner.run(checkpoint_interval_secs=1.0)``.  Prints one JSON
line per package: wall seconds, the epochs every subtask completed, and
for each epoch the seconds from the run's start to its barrier and to
its seal (``wait_for_checkpoint``: every subtask reported it); for the
port also the rows of each session-union call.

    JAX_PLATFORMS=cpu python3 tools/torch_config5_epochs.py [EVENTS]

EVENTS defaults to 2,000,000 (chip_smoke.py's config5 cell); the JAX run
takes about as long as the port's (~15 s each on a CPU, plus ~15 s each
to fill the topics)."""

import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402
from arroyo_tpu.connectors.memory import clear_sink as jax_clear_sink  # noqa: E402
from arroyo_tpu.engine import engine as jax_engine  # noqa: E402
from arroyo_tpu.sql import SchemaProvider, plan_sql  # noqa: E402
from arroyo_tpu.sql.functions import unregister_udfs  # noqa: E402
from arroyo_tpu_torch.config5 import config5_produce, config5_program  # noqa: E402
from arroyo_tpu_torch.connectors.memory import clear_sink  # noqa: E402
from arroyo_tpu_torch.engine import engine as port_engine  # noqa: E402
from arroyo_tpu_torch.ops import session as session_ops  # noqa: E402

BATCH = 4_096  # bench.py's CONFIG5_SQL batch_size
SPACING = 10


def timeline(engine_mod, log, t0):
    """Record each barrier and seal of ``engine_mod.RunningEngine``."""
    cls = engine_mod.RunningEngine
    checkpoint, wait = cls.checkpoint, cls.wait_for_checkpoint

    async def traced_checkpoint(self, epoch, *args, **kwargs):
        log.append(("barrier", epoch, time.perf_counter() - t0[0]))
        return await checkpoint(self, epoch, *args, **kwargs)

    async def traced_wait(self, epoch, *args, **kwargs):
        sealed = await wait(self, epoch, *args, **kwargs)
        log.append(("sealed" if sealed else "not sealed", epoch,
                    time.perf_counter() - t0[0]))
        return sealed

    cls.checkpoint, cls.wait_for_checkpoint = traced_checkpoint, traced_wait


def summary(which, n, wall, log):
    """An epoch is complete when ``wait_for_checkpoint`` saw every subtask
    report it (the ticker then commits it)."""
    return {"package": which, "events": n, "wall_s": wall,
            "completed_epochs": [e for what, e, _t in log
                                 if what == "sealed"],
            "timeline_s": log}


def run_jax(n):
    t0, log = [0.0], []
    timeline(jax_engine, log, t0)
    unregister_udfs()  # median is registered process-wide
    try:
        provider = SchemaProvider()
        provider.register_udaf("median", np.median)
        prog = plan_sql(bench.CONFIG5_SQL.format(b=BATCH, n=n), provider)
    finally:
        unregister_udfs()
    bench._config5_produce("bench5", n, 0, SPACING)
    jax_clear_sink("results")
    runner = jax_engine.LocalRunner(prog)
    t0[0] = time.perf_counter()
    runner.run(checkpoint_interval_secs=1.0)
    return summary("arroyo_tpu", n, time.perf_counter() - t0[0], log)


def run_port(n):
    t0, log, sizes = [0.0], [], []
    timeline(port_engine, log, t0)
    union = session_ops.session_union_buffer

    def recorded(kh, st, en):
        sizes.append(kh.shape[0])
        return union(kh, st, en)

    session_ops.session_union_buffer = recorded
    config5_produce("epochs", n, 0, SPACING)
    clear_sink("epochs")
    runner = port_engine.LocalRunner(
        config5_program(n, BATCH, "epochs", broker="epochs"), device="cpu")
    t0[0] = time.perf_counter()
    runner.run(checkpoint_interval_secs=1.0)
    out = summary("arroyo_tpu_torch", n, time.perf_counter() - t0[0], log)
    session_ops.session_union_buffer = union
    out["union_calls"] = len(sizes)
    out["union_rows"] = int(sum(sizes))
    out["union_n_histogram"] = sorted(collections.Counter(sizes).items())
    return out


if __name__ == "__main__":
    events = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    for run in (run_port, run_jax):
        print(json.dumps(run(events)), flush=True)
