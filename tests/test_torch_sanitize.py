"""The runtime sanitizer (analysis/sanitizer.py) against the JAX
package's: each streaming invariant, injected as tests/test_sanitize.py
injects it, raises ``SanitizerError`` with the same code in both packages
(directly at the hook, through the real ``StateStore`` and through a real
``TaskRunner``), and a clean run records events and no violation."""

import asyncio

import numpy as np
import pytest

import arroyo_tpu.analysis.sanitizer as jax_san
import arroyo_tpu.engine.context as jax_context
import arroyo_tpu.engine.operator as jax_operator
import arroyo_tpu.engine.task as jax_task
import arroyo_tpu.state.backend as jax_backend
import arroyo_tpu.state.store as jax_store
import arroyo_tpu.types as jax_types
import arroyo_tpu_torch.analysis.sanitizer as port_san
import arroyo_tpu_torch.engine.context as port_context
import arroyo_tpu_torch.engine.operator as port_operator
import arroyo_tpu_torch.engine.task as port_task
import arroyo_tpu_torch.state.backend as port_backend
import arroyo_tpu_torch.state.store as port_store
import arroyo_tpu_torch.types as port_types
from arroyo_tpu_torch import Stream
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output
from arroyo_tpu_torch.engine.engine import LocalRunner

PKGS = {
    "jax": (jax_san, jax_context, jax_operator, jax_task, jax_backend,
            jax_store, jax_types),
    "torch": (port_san, port_context, port_operator, port_task,
              port_backend, port_store, port_types),
}


@pytest.fixture(autouse=True)
def _clean_rings():
    jax_san._reset_ring()
    port_san._reset_ring()
    yield


def _batch(types, n=4, cols=("a",)):
    return types.Batch(np.arange(n, dtype=np.int64),
                       {c: np.arange(n) for c in cols})


def _codes(run):
    """The SanitizerError code ``run(pkg)`` raises in each package (None
    when it raises nothing), as {package: code}."""
    out = {}
    for name, pkg in PKGS.items():
        try:
            run(pkg)
            out[name] = None
        except pkg[0].SanitizerError as e:
            out[name] = e.code
    return out


def test_enable_knob_and_default_off(monkeypatch):
    monkeypatch.delenv("ARROYO_SANITIZE", raising=False)
    for san, *_ in PKGS.values():
        assert not san.sanitize_enabled() and san.maybe_sanitizer() is None
    monkeypatch.setenv("ARROYO_SANITIZE", "1")
    for san, *_ in PKGS.values():
        assert san.sanitize_enabled()
        assert isinstance(san.maybe_sanitizer(), san.Sanitizer)


def _watermark_regression(pkg):
    san, types = pkg[0].Sanitizer(), pkg[6]
    san.on_watermark(("t-0", 0), types.Watermark.event_time(100))
    san.on_watermark(("t-0", 0), types.Watermark.event_time(50))


def _watermark_idle_and_other_edges(pkg):
    san, types = pkg[0].Sanitizer(), pkg[6]
    san.on_watermark(("t-0", 0), types.Watermark.event_time(100))
    san.on_watermark(("t-0", 0), types.Watermark.idle())
    san.on_watermark(("t-0", 0), types.Watermark.event_time(100))
    san.on_watermark(("t-0", 1), types.Watermark.event_time(10))


def _schema_instability(pkg):
    san, types = pkg[0].Sanitizer(), pkg[6]
    edge = ("t-1", 0)
    san.on_record(edge, _batch(types, cols=("a", "b")))
    # dtype promotion is legal: names are the contract
    san.on_record(edge, types.Batch(np.arange(3, dtype=np.int64),
                                    {"a": np.arange(3.0), "b": np.arange(3)}))
    san.on_record(edge, _batch(types, cols=("a", "c")))


def _stamp_is_not_a_column(pkg):
    san, types = pkg[0].Sanitizer(), pkg[6]
    san.on_record(("t-1", 0), _batch(types))
    b = _batch(types)
    b.lat_stamp = 123
    san.on_record(("t-1", 0), b)


def _sharding_flip(pkg):
    san = pkg[0].Sanitizer()
    san.on_sharding(("opX", 0), "keys@4")
    san.on_sharding(("opX", 0), "keys@4")
    san.on_sharding(("opY", 0), "host@4")
    san.on_sharding(("opX", 0), "host@4")


def _barrier_crossing(pkg):
    class Counter:
        seen = {7: {0}}

    san = pkg[0].Sanitizer()
    san.on_record_during_alignment("t-2", 1, Counter())  # other input ok
    san.on_record_during_alignment("t-2", 0, Counter())


def _coalesce_unflushed(pkg):
    class Pending:
        pending = True

    class Drained:
        pending = False

    san = pkg[0].Sanitizer()
    san.before_control("t-3", "watermark", Drained())
    san.before_control("t-3", "watermark", None)
    san.before_control("t-3", "barrier", Pending())


def _duplicate_completion(pkg):
    san = pkg[0].Sanitizer()
    san.on_checkpoint_completed("op-1", 0, 1)
    san.on_checkpoint_completed("op-1", 1, 1)
    san.on_checkpoint_completed("op-1", 0, 2)
    san.on_checkpoint_completed("op-1", 0, 1)


@pytest.mark.parametrize("inject,code", [
    (_watermark_regression, "watermark-regression"),
    (_watermark_idle_and_other_edges, None),
    (_schema_instability, "schema-instability"),
    (_stamp_is_not_a_column, None),
    (_sharding_flip, "sharding-instability"),
    (_barrier_crossing, "barrier-crossing"),
    (_coalesce_unflushed, "coalesce-unflushed"),
    (_duplicate_completion, "duplicate-checkpoint"),
], ids=lambda v: getattr(v, "__name__", str(v)).strip("_"))
def test_invariant_raises_as_in_jax(inject, code):
    assert _codes(inject) == {"jax": code, "torch": code}


def test_violation_carries_the_event_ring():
    for pkg in PKGS.values():
        with pytest.raises(pkg[0].SanitizerError) as ei:
            _watermark_regression(pkg)
        assert f"arroyosan[{ei.value.code}]" in str(ei.value)
        assert [e[1] for e in ei.value.events].count("watermark") >= 2


def _mutating_store(pkg):
    """A store whose backend inserts into a live table while persisting
    (an upload path that touches live state), the sanitizer armed."""
    san, _c, _o, _t, backend, store_mod, types = pkg

    class MutatingBackend(backend.InMemoryBackend):
        def __init__(self, ref):
            super().__init__()
            self.ref = ref

        def write_subtask_checkpoint(self, task, epoch, tables, wm):
            self.ref[0].get_global_keyed_state("g").insert("sneak", 1)
            return super().write_subtask_checkpoint(task, epoch, tables, wm)

    ref = []
    ti = types.TaskInfo("san-job", "op-0", "op", 0, 1)
    store = store_mod.StateStore(ti, MutatingBackend(ref))
    ref.append(store)
    store.sanitizer = san.Sanitizer()
    store.get_global_keyed_state("g").insert("k", 42)
    store.checkpoint(1, None)


def _clean_store(pkg):
    san, _c, _o, _t, backend, store_mod, types = pkg
    ti = types.TaskInfo("san-job", "op-0", "op", 0, 1)
    store = store_mod.StateStore(ti, backend.InMemoryBackend())
    store.sanitizer = san.Sanitizer()
    store.get_global_keyed_state("g").insert("k", 42)
    assert store.checkpoint(2, None).epoch == 2


@pytest.mark.parametrize("run,code", [
    (_mutating_store, "mutation-during-checkpoint"), (_clean_store, None)],
    ids=["mutating", "clean"])
def test_mutation_during_checkpoint_through_real_store(run, code):
    assert _codes(run) == {"jax": code, "torch": code}


def _runner(pkg, san):
    """A real TaskRunner over a pass-through operator, one input queue."""
    _s, context, operator, task, backend, store_mod, types = pkg

    class Collect(operator.Operator):
        def __init__(self):
            super().__init__("collect")
            self.rows = 0

        async def process_batch(self, batch, ctx, side=0):
            self.rows += len(batch)
            await ctx.collect(batch)

    ti = types.TaskInfo("san-job", "op-0", "collect", 0, 1)
    out = asyncio.Queue(maxsize=10_000)
    ctx = context.Context(ti, context.Collector([[context.OutQueue(out)]]),
                          1, state_store=store_mod.StateStore(
                              ti, backend.InMemoryBackend()))
    op = Collect()
    inq = asyncio.Queue()
    runner = task.TaskRunner(ti, op, ctx, [(0, inq)], asyncio.Queue(),
                             asyncio.Queue(), sanitizer=san)
    return runner, inq, op


def _drive(pkg, msgs, forge=None):
    """Run a sanitized TaskRunner over ``msgs`` (built from the package's
    types); returns (runner, sanitizer, operator)."""
    types = pkg[6]

    async def go():
        san = pkg[0].Sanitizer()
        runner, inq, op = _runner(pkg, san)
        if forge is not None:
            forge(runner)
        t = asyncio.ensure_future(runner.start())
        for m in msgs(types):
            await inq.put(m)
        await asyncio.wait_for(runner.finished.wait(), 10)
        await t
        return runner, san, op

    return asyncio.run(go())


def _regressing(types):
    return [types.Message.wm(types.Watermark.event_time(1_000)),
            types.Message.wm(types.Watermark.event_time(500)),
            types.Message.end_of_data()]


def _clean(types):
    return [types.Message.record(_batch(types)),
            types.Message.wm(types.Watermark.event_time(1_000)),
            types.Message.record(_batch(types)),
            types.Message.wm(types.Watermark.event_time(2_000)),
            types.Message.end_of_data()]


def _crossing(types):
    return [types.Message.record(_batch(types)), types.Message.end_of_data()]


def _partially_aligned(runner):
    # input 0 already delivered its barrier for epoch 3: a healthy pump
    # would now be parked
    runner.ctx.counter.seen = {3: {0}}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("msgs,forge,code", [
    (_regressing, None, "watermark-regression"),
    (_crossing, _partially_aligned, "barrier-crossing"),
    (_clean, None, None)], ids=["regression", "crossing", "clean"])
def test_task_runner_fails_the_task_as_jax(pkg, msgs, forge, code):
    runner, san, op = _drive(PKGS[pkg], msgs, forge)
    if code is None:
        assert runner.failed is None and san.violations == 0
        assert op.rows == 8
        kinds = {e[1] for e in PKGS[pkg][0].recent_events(256)}
        assert {"watermark", "schema", "control"} <= kinds
    else:
        assert isinstance(runner.failed, PKGS[pkg][0].SanitizerError)
        assert runner.failed.code == code


@pytest.mark.parametrize("armed", [False, True])
def test_engine_arms_the_sanitizer_from_the_environment(monkeypatch, armed):
    """Unset, the engine wires None into every hook site; armed, one
    sanitizer a run, and a clean pipeline records events, no violation."""
    if armed:
        monkeypatch.setenv("ARROYO_SANITIZE", "1")
    else:
        monkeypatch.delenv("ARROYO_SANITIZE", raising=False)
    clear_sink("san-engine")
    prog = Stream.source("impulse", {"event_rate": 0.0,
                                     "message_count": 500,
                                     "batch_size": 64}).sink(
        "memory", {"name": "san-engine"})
    runner = LocalRunner(prog, device="cpu")
    runner.run()
    assert sum(len(b) for b in sink_output("san-engine")) == 500
    if not armed:
        assert runner.engine.sanitizer is None
        return
    san = runner.engine.sanitizer
    assert isinstance(san, port_san.Sanitizer) and san.violations == 0
    assert {e[1] for e in port_san.recent_events(256)} >= {"schema",
                                                            "control"}
