"""Phase-attributed host/device profiler (port of
``arroyo_tpu.obs.profiler``): account for every microsecond of the hot
path.

ROADMAP item 5 ("kill the host path") needs the host time *decomposed*
before anyone can kill it: the bench's old ``host_time_share`` was a
residual (1 - device/wall) with zero attribution.  This module measures
every batch's journey as named phases at the runtime's existing choke
points:

==================  =========================================================
phase               measured where
==================  =========================================================
``source_decode``   connector decode / generation (nexmark generator,
                    kafka format decode, impulse batch assembly); the
                    nexmark generator's runs on its prefetch thread,
                    beside the event loop
``proc``            operator ``process_batch`` host compute, EXCLUSIVE of
                    the nested phases below (per chain member for fused
                    operators)
``dispatch``        host-side kernel launch wall time (``perf.timed_device``
                    without a sync — the Python and ctypes envelope around
                    the CUDA launch)
``device_execute``  same site under ``ARROYO_TIMING=1``: the launch then
                    ``torch.cuda.synchronize()``, so the span is the
                    kernel's device time (and what was queued before it)
``shuffle_prep``    Collector partition/route/select CPU before fan-out
``coalesce_merge``  input-side batch concat in the coalescer
``watermark``       timer fires + ``handle_watermark`` (window fires live
                    here)
``checkpoint``      state snapshot sync phase at a barrier
``emit_encode``     sink-side encode (single_file JSON lines, ...)
``frame_encode``    data-plane Arrow IPC encode per frame
``frame_decode``    data-plane decode on the receiving worker
``reshard``         shard tensors moved because they were off their
                    shard's device (parallel/shuffle.ensure_sharded —
                    steady state shows NO such phase at all)
``shuffle_collective``  the device exchange carrying a co-located SHUFFLE
                    edge (parallel/shuffle.py: route, exchange and the
                    per-destination readback)
``gather``          join payload materialization per emitted match set
                    (state/join_state.py — device-ring gather or host
                    fancy-index, whichever path ran; the device/host row
                    split rides the ``join_*_gather_rows`` counters)
==================  =========================================================

``emit_encode``, ``frame_*`` and ``session_merge`` keep their names for
the sinks, data plane and staged session partitions still to port.

plus overlapping **wait** phases (reported separately, never summed into
the work table): ``queue_wait``, ``coalesce_wait``, ``send_wait``
(backpressure enqueue), ``net_flush`` (socket drain).

Accounting model
----------------

Each asyncio task (and each executor thread) owns its own frame stack
(contextvar-held, thread-id-guarded), so ``begin``/``end`` pairs nest
LIFO within one task.  A frame's recorded time is **exclusive**: child
frames — including *wait* frames that span awaits — subtract their full
inclusive span from the parent.  Work phases are only opened around
synchronous blocks (their only interior awaits are wrapped as wait
children), so no other task's work can ever be charged to them: summed
work phases per thread can never exceed that thread's busy wall time.
Executor-side work (source prefetch, offloaded transfers) overlaps the
event loop by design, so a job's summed work phases may exceed wall
time — the bench reports the raw ratio and flags the overlap, exactly
like ``device_time_share`` already does.

Off-path discipline (same as arroyosan): every instrumentation site
holds a local that is ``None`` unless the profiler was armed
(``ARROYO_PROFILE=1`` at engine build, or an explicit :func:`arm`), so
the disabled path is a single ``is not None`` test.

The event-loop **stall watchdog** pairs an on-loop ticker task with a
sampler thread: the ticker heartbeats a timestamp every few ms; when
the thread sees the heartbeat stall past the threshold it captures the
loop thread's live stack (``sys._current_frames()``) — naming the
blocking call *while it blocks*.  ``LocalRunner.run`` stops and joins
the sampler thread when the run ends (:meth:`LoopWatchdog.stop`), so no
thread the profiler starts outlives a run; the ticker task dies with its
loop.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
import weakref
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Profiler",
    "LoopWatchdog",
    "profile_enabled",
    "active",
    "arm",
    "disarm",
    "ensure_armed",
    "WORK_PHASES",
    "WAIT_PHASES",
]

WORK_PHASES = ("source_decode", "proc", "dispatch", "device_execute",
               "shuffle_prep", "coalesce_merge", "watermark", "checkpoint",
               "emit_encode", "frame_encode", "frame_decode", "reshard",
               "shuffle_collective", "gather", "session_merge")
WAIT_PHASES = ("queue_wait", "coalesce_wait", "send_wait", "net_flush")


def profile_enabled() -> bool:
    """``ARROYO_PROFILE=1`` arms the profiler at engine build (read per
    build, not at import, so tests and bench can toggle per run)."""
    return os.environ.get("ARROYO_PROFILE", "0") not in ("0", "off",
                                                         "false", "")


_ACTIVE: Optional["Profiler"] = None


def active() -> Optional["Profiler"]:
    """The armed profiler, or ``None`` — the instrumentation sites'
    single cheap test."""
    return _ACTIVE


def arm(job_id: str = "") -> "Profiler":
    """Arm the process-wide profiler (idempotent: an already-armed
    profiler is returned unchanged, keeping its buckets)."""
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = Profiler(job_id)
    return _ACTIVE


def disarm() -> None:
    global _ACTIVE
    prof = _ACTIVE
    _ACTIVE = None
    if prof is not None:
        prof.watchdog.stop()


def ensure_armed(job_id: str = "") -> Optional["Profiler"]:
    """Engine-build hook: arm iff ``ARROYO_PROFILE`` asks for it (or an
    explicit :func:`arm` already did); returns the active profiler or
    ``None``."""
    if _ACTIVE is not None:
        return _ACTIVE
    if profile_enabled():
        return arm(job_id)
    return None


# -- frame stacks ------------------------------------------------------------

# Per-task stacks: a contextvar gives every asyncio task its own box (so
# begin/end pairs nest LIFO even when awaits interleave tasks); the tid
# guard gives executor threads a fresh box when a copied context (e.g.
# perf.run_offloaded) would otherwise share the loop task's live list
# across threads.
class _StackBox:
    __slots__ = ("tid", "frames")

    def __init__(self, tid: int):
        self.tid = tid
        self.frames: List[list] = []


_STACK: ContextVar[Optional[_StackBox]] = ContextVar(
    "arroyo_profiler_stack", default=None)

# frame layout: [op_id, phase, is_wait, t0, child_inclusive_secs]
_OP, _PHASE, _WAIT, _T0, _CHILD = range(5)


class Profiler:
    """Process-wide phase accounting (one job per worker process; the
    embedded multi-job scheduler shares one profiler, documented)."""

    def __init__(self, job_id: str = ""):
        self.job_id = job_id
        self._lock = threading.Lock()
        self._work: Dict[Tuple[str, str], float] = {}
        self._waits: Dict[Tuple[str, str], float] = {}
        self._counts: Dict[Tuple[str, str], int] = {}
        self._t0 = time.perf_counter()
        self.watchdog = LoopWatchdog(job_id=job_id)

    # -- hot-path API ------------------------------------------------------

    def _frames(self) -> List[list]:
        box = _STACK.get()
        tid = threading.get_ident()
        if box is None or box.tid != tid:
            box = _StackBox(tid)
            _STACK.set(box)
        return box.frames

    def begin(self, op_id: str, phase: str, wait: bool = False) -> list:
        """Open a phase frame; returns the token for :meth:`end`.  Work
        frames must not span an await except through nested wait
        children (the site discipline the accounting model rests on)."""
        f = [op_id, phase, wait, time.perf_counter(), 0.0]
        self._frames().append(f)
        return f

    def end(self, f: list) -> None:
        now = time.perf_counter()
        frames = self._frames()
        if frames and frames[-1] is f:
            frames.pop()
        else:
            # defensive: a corrupted interleaving (shouldn't happen with
            # per-task stacks) degrades to attribution blur, never an
            # exception or unbounded stack growth
            try:
                frames.remove(f)
            except ValueError:
                pass
        dt = now - f[_T0]
        excl = dt - f[_CHILD]
        if excl < 0.0:
            excl = 0.0
        if frames:
            frames[-1][_CHILD] += dt
        key = (f[_OP], f[_PHASE])
        with self._lock:
            d = self._waits if f[_WAIT] else self._work
            d[key] = d.get(key, 0.0) + excl
            self._counts[key] = self._counts.get(key, 0) + 1

    def add(self, op_id: str, phase: str, secs: float,
            wait: bool = False, count: int = 1) -> None:
        """Direct accounting for sites that measure their own span and
        cannot nest (executor-thread source generation, the task loop's
        input waits)."""
        key = (op_id, phase)
        with self._lock:
            d = self._waits if wait else self._work
            d[key] = d.get(key, 0.0) + secs
            self._counts[key] = self._counts.get(key, 0) + count

    @contextmanager
    def phase(self, op_id: str, phase: str,
              wait: bool = False) -> Iterator[None]:
        """Context-manager convenience for non-hot paths."""
        f = self.begin(op_id, phase, wait)
        try:
            yield
        finally:
            self.end(f)

    # -- reads -------------------------------------------------------------

    def reset(self) -> None:
        with self._lock:
            self._work.clear()
            self._waits.clear()
            self._counts.clear()
            self._t0 = time.perf_counter()
        self.watchdog.reset()

    def work_snapshot(self) -> Dict[Tuple[str, str], float]:
        with self._lock:
            return dict(self._work)

    def wait_snapshot(self) -> Dict[Tuple[str, str], float]:
        with self._lock:
            return dict(self._waits)

    def snapshot(self) -> Dict[str, Any]:
        """Full structured snapshot: per-operator work/wait phase maps,
        job-level phase totals, wall since arm/reset, watchdog stats."""
        with self._lock:
            work, waits = dict(self._work), dict(self._waits)
            counts = dict(self._counts)
            wall = time.perf_counter() - self._t0
        ops: Dict[str, Dict[str, Any]] = {}
        phases: Dict[str, float] = {}
        wait_totals: Dict[str, float] = {}
        for (op, ph), secs in work.items():
            ops.setdefault(op, {"phases": {}, "waits": {}})[
                "phases"][ph] = round(secs, 6)
            phases[ph] = phases.get(ph, 0.0) + secs
        for (op, ph), secs in waits.items():
            ops.setdefault(op, {"phases": {}, "waits": {}})[
                "waits"][ph] = round(secs, 6)
            wait_totals[ph] = wait_totals.get(ph, 0.0) + secs
        attributed = sum(phases.values())
        return {
            "job_id": self.job_id,
            "wall_secs": round(wall, 6),
            "phases": {k: round(v, 6) for k, v in sorted(phases.items())},
            "waits": {k: round(v, 6) for k, v in sorted(
                wait_totals.items())},
            "attributed_secs": round(attributed, 6),
            "attributed_share": round(attributed / wall, 4) if wall > 0
            else 0.0,
            "unattributed_share": round(
                max(1.0 - attributed / wall, 0.0), 4) if wall > 0 else 0.0,
            "operators": {op: v for op, v in sorted(ops.items())},
            "counts": {f"{op}/{ph}": n for (op, ph), n in sorted(
                counts.items())},
            "watchdog": self.watchdog.stats(),
        }

    def collapsed_stacks(self) -> str:
        """pprof/flamegraph folded-stack text: one ``job;operator;phase
        <microseconds>`` line per bucket (waits carry a ``(wait)``
        leaf so they are visually separable from summed work)."""
        job = self.job_id or "job"
        lines: List[str] = []
        with self._lock:
            work, waits = dict(self._work), dict(self._waits)
        for (op, ph), secs in sorted(work.items()):
            lines.append(f"{job};{op};{ph} {int(secs * 1e6)}")
        for (op, ph), secs in sorted(waits.items()):
            lines.append(f"{job};{op};{ph} (wait) {int(secs * 1e6)}")
        return "\n".join(lines) + ("\n" if lines else "")


# -- event-loop stall watchdog -----------------------------------------------


class LoopWatchdog:
    """Scheduling-lag sampler + blocking-call catcher.

    The on-loop ticker (:meth:`run`) sleeps ``interval`` and records how
    late the loop woke it — the scheduling lag every other coroutine on
    that loop also experiences.  A daemon sampler thread watches the
    ticker's heartbeat; when it stalls past ``stall_threshold`` the
    thread snapshots the loop thread's current Python stack, so the
    blocking call is named **while it is still blocking**.  One stall
    episode records once, however long it lasts.
    """

    def __init__(self, interval: float = 0.02,
                 stall_threshold: Optional[float] = None,
                 job_id: str = ""):
        self.interval = interval
        self.stall_threshold = stall_threshold if stall_threshold is not None \
            else float(os.environ.get("ARROYO_PROFILE_STALL_MS", "250")) / 1e3
        self.job_id = job_id
        self.lags: deque = deque(maxlen=1024)  # recent lag samples (secs)
        self.stalls: deque = deque(maxlen=64)  # {t, lag, stack}
        self.stall_count = 0
        self._last_tick = time.perf_counter()
        self._loop_tid: Optional[int] = None
        self._stop = threading.Event()
        self._sampler_started = False
        self._thread: Optional[threading.Thread] = None
        self._tickers: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()  # loop -> ticker task
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def ensure_ticker(self) -> None:
        """Idempotently start the ticker task on the running loop (and
        the sampler thread on first use).  Called from Engine.start when
        the profiler is armed; the task dies with its loop."""
        import asyncio

        loop = asyncio.get_running_loop()
        t = self._tickers.get(loop)
        if t is not None and not t.done():
            return
        self._tickers[loop] = asyncio.ensure_future(self.run())

    async def run(self) -> None:
        self._loop_tid = threading.get_ident()
        self._last_tick = time.perf_counter()
        if not self._sampler_started:
            self._sampler_started = True
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._sample, name="arroyo-loop-watchdog",
                daemon=True)
            self._thread.start()
        import asyncio

        from .metrics import event_loop_lag_gauge, event_loop_stalls_counter

        gauge_p50 = event_loop_lag_gauge(self.job_id, "p50")
        gauge_p99 = event_loop_lag_gauge(self.job_id, "p99")
        stalls_c = event_loop_stalls_counter(self.job_id)
        reported_stalls = 0
        last_gauge = 0.0
        try:
            while True:
                t0 = time.perf_counter()
                await asyncio.sleep(self.interval)
                now = time.perf_counter()
                self._last_tick = now
                self.lags.append(max(now - t0 - self.interval, 0.0))
                if now - last_gauge >= 1.0:
                    last_gauge = now
                    p50, p99 = self._percentiles()
                    gauge_p50.set(p50)
                    gauge_p99.set(p99)
                    if self.stall_count > reported_stalls:
                        stalls_c.inc(self.stall_count - reported_stalls)
                        reported_stalls = self.stall_count
        finally:
            # the loop is going away: freeze the heartbeat far in the
            # future so the sampler never mistakes shutdown for a stall
            self._last_tick = float("inf")

    def stop(self) -> None:
        """Stop the sampler thread and wait for it to exit (it polls every
        few ms); a later :meth:`ensure_ticker` starts a new one."""
        self._stop.set()
        self._sampler_started = False
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    # -- sampling ----------------------------------------------------------

    def _percentiles(self) -> Tuple[float, float]:
        lags = sorted(self.lags)
        if not lags:
            return 0.0, 0.0
        return (lags[len(lags) // 2],
                lags[min(int(len(lags) * 0.99), len(lags) - 1)])

    def _sample(self) -> None:
        poll = max(self.interval / 2, 0.005)
        while not self._stop.is_set():
            time.sleep(poll)
            last = self._last_tick
            if last == float("inf"):
                continue
            lag = time.perf_counter() - last
            if lag < self.stall_threshold or self._loop_tid is None:
                continue
            frame = sys._current_frames().get(self._loop_tid)
            stack = ("".join(traceback.format_stack(frame, limit=12))
                     if frame is not None else "<no frame>")
            with self._lock:
                self.stall_count += 1
                self.stalls.append({
                    "t": round(time.time(), 3),
                    "lag_secs": round(lag, 4),
                    "stack": stack,
                })
            # one record per stall episode: wait for the loop to tick
            # again before re-arming (bounded so a dead loop can't wedge
            # the sampler thread forever)
            deadline = time.perf_counter() + 60.0
            while (self._last_tick <= last
                   and time.perf_counter() < deadline
                   and not self._stop.is_set()):
                time.sleep(poll)

    # -- reads -------------------------------------------------------------

    def reset(self) -> None:
        with self._lock:
            self.lags.clear()
            self.stalls.clear()
            self.stall_count = 0

    def stats(self) -> Dict[str, Any]:
        p50, p99 = self._percentiles()
        with self._lock:
            stalls = list(self.stalls)
            count = self.stall_count
        return {
            "lag_p50_secs": round(p50, 6),
            "lag_p99_secs": round(p99, 6),
            "stalls": count,
            "stall_threshold_secs": self.stall_threshold,
            "recent_stalls": [
                {"t": s["t"], "lag_secs": s["lag_secs"],
                 # last frames name the blocking call; the full stack
                 # stays in-process
                 "stack_tail": s["stack"].strip().splitlines()[-4:]}
                for s in stalls[-8:]],
        }
