"""Lightweight performance accounting — the counters, the per-task
kernel accumulator and ``timed_device`` of ``arroyo_tpu.obs.perf``.

Two tiers, as in the JAX package:

* **Always-cheap per-operator accumulator** — every ``timed_device`` call
  made while a task has installed a :class:`KernelAccumulator` (the
  TaskRunner does this) adds its launch wall time to that operator's
  ``arroyo_worker_kernel_seconds_total`` counter and, for spans above a
  floor, to the flight-recorder trace ring.  Nothing waits for the
  device, so the cost is two ``perf_counter_ns`` reads per kernel.
* **Blocking measurement mode**, ``ARROYO_TIMING=1``: after the call,
  ``torch.cuda.synchronize()`` (where the JAX package calls
  ``block_until_ready``), so ``device_ns`` accumulates true device time.
  That serializes dispatch: it is for measurement runs, not production.

With the phase profiler armed, each call is also a ``dispatch`` phase
(``device_execute`` under ``ARROYO_TIMING=1``) nested in the caller's.

The sharded data plane counts here under the JAX package's keys
(``parallel/shuffle.py``): ``reshard_transfers``, ``shuffle_collectives``,
``shuffle_collective_rows``, ``shuffle_host_routes`` and
``mesh_ingest_transfers``; ``shuffle.shuffle_stats()`` reads them."""

from __future__ import annotations

import contextvars
import os
import time
from contextvars import ContextVar
from typing import Any, Dict, Optional

import torch

from . import profiler as _profiler

_COUNTERS: Dict[str, int] = {}
_NOTES: Dict[str, Any] = {}

# spans shorter than this don't earn a trace-ring entry (the counter
# still accumulates them); keeps micro-kernels from flooding the ring
_TRACE_FLOOR_NS = 50_000


class KernelAccumulator:
    """Per-subtask kernel-time sink: a counter child plus identity for
    trace spans.  Installed by the TaskRunner for the duration of its
    coroutine (contextvars flow through awaits, so every kernel the
    operator launches on the event loop lands here)."""

    __slots__ = ("task_id", "operator_id", "counter")

    def __init__(self, task_info, metrics=None):
        self.task_id = task_info.task_id
        self.operator_id = task_info.operator_id
        self.counter = getattr(metrics, "kernel_time", None)

    def add(self, ns: int) -> None:
        if self.counter is not None:
            self.counter.inc(ns / 1e9)
        if ns >= _TRACE_FLOOR_NS:
            from . import tracing

            end = tracing.now_us()
            tracing.record_span("kernel", "kernel", end - ns / 1e3,
                                ns / 1e3, tid=self.task_id)


_ACTIVE_TASK: ContextVar[Optional[KernelAccumulator]] = ContextVar(
    "arroyo_torch_active_kernel_acc", default=None)


def set_active_task(acc: Optional[KernelAccumulator]):
    """Install the accumulator for the current (coroutine) context;
    returns a token for ``reset_active_task``."""
    return _ACTIVE_TASK.set(acc)


def reset_active_task(token) -> None:
    _ACTIVE_TASK.reset(token)


def active_operator_id() -> Optional[str]:
    """Operator id of the current (coroutine) context's task, or None
    off-task."""
    acc = _ACTIVE_TASK.get()
    return acc.operator_id if acc is not None else None


def run_offloaded(loop, fn, *args):
    """``loop.run_in_executor`` with contextvars propagated: executor
    threads don't inherit the caller's context, so kernels launched from
    an offloaded update or fire would otherwise bypass the active task's
    accumulator and the profiler's attribution."""
    ctx = contextvars.copy_context()
    return loop.run_in_executor(None, lambda: ctx.run(fn, *args))


def timing_enabled() -> bool:
    return bool(os.environ.get("ARROYO_TIMING"))


def reset() -> None:
    _COUNTERS.clear()
    _NOTES.clear()


def counter(key: str) -> int:
    return _COUNTERS.get(key, 0)


def count(key: str, n: int = 1) -> None:
    _COUNTERS[key] = _COUNTERS.get(key, 0) + n


def note(key: str, value: Any) -> None:
    """Keep a non-counter observation (e.g. a state shape) under ``key``."""
    _NOTES[key] = value


def get_note(key: str, default: Any = None) -> Any:
    return _NOTES.get(key, default)


def timed_device(call, *args) -> Any:
    """Run one device-kernel call and count it (``kernel_dispatches``).
    With a task's accumulator installed, its launch wall time goes to that
    task's kernel counter; with the profiler armed, to a ``dispatch``
    phase.  With ``ARROYO_TIMING=1`` the call is followed by
    ``torch.cuda.synchronize()``, the elapsed time goes to ``device_ns``
    and to ``device_ns:<the call's name>`` (which also holds any copy
    queued on the stream ahead of it, such as an upload from pinned
    memory), and the profiler's phase is ``device_execute``."""
    count("kernel_dispatches")
    blocking = timing_enabled()
    acc = _ACTIVE_TASK.get()
    if not blocking and acc is None:
        return call(*args)
    prof = _profiler.active()
    frame = None
    if prof is not None:
        frame = prof.begin(
            acc.operator_id if acc is not None else "kernel",
            "device_execute" if blocking else "dispatch")
    t0 = time.perf_counter_ns()
    try:
        out = call(*args)
        if blocking and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        dt = time.perf_counter_ns() - t0
        if frame is not None:
            prof.end(frame)
    if blocking:
        count("device_ns", dt)
        count(f"device_ns:{call.__name__}", dt)
    if acc is not None:
        acc.add(dt)
    return out


def counters(prefix: str) -> Dict[str, int]:
    """The counters whose names start with ``prefix``."""
    return {k: v for k, v in _COUNTERS.items() if k.startswith(prefix)}
