"""Flight-recorder span tracing (port of ``arroyo_tpu.obs.tracing``): a
fixed-size ring of completed spans, exportable as Chrome-trace /
Perfetto JSON.

The reference leans on pyroscope for continuous profiling and on tokio
tracing for structured spans; here one lock-guarded ring buffer records
the runtime's interesting intervals — task lifecycle, barrier alignment,
checkpoint phases, window fires, kernel dispatch, data-plane flushes —
at a cost of one ``perf_counter`` pair and a deque append per span.
Always on: the ring bounds memory (``ARROYO_TRACE_CAP`` spans, default
16384) and recording never allocates more than one tuple.

Export (``chrome_trace()``) produces the Chrome Trace Event Format
(``{"traceEvents": [{"ph": "X", ...}]}``) which loads directly in
https://ui.perfetto.dev or ``chrome://tracing``.  (The JAX package's
admin server serves it at ``/trace``; that server is not ported.)
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

_CAP = int(os.environ.get("ARROYO_TRACE_CAP", "16384"))
_lock = threading.Lock()
# (name, cat, start_us, dur_us, pid, tid, args)
_spans: deque = deque(maxlen=_CAP)

# wall-clock anchor for perf_counter timestamps: Chrome-trace ts fields
# are absolute microseconds, perf_counter is an arbitrary monotonic
# origin — one pairing at import maps between them
_WALL_ANCHOR_US = time.time() * 1e6 - time.perf_counter() * 1e6


def now_us() -> float:
    """Monotonic wall-clock microseconds, comparable across spans."""
    return _WALL_ANCHOR_US + time.perf_counter() * 1e6


def set_capacity(n: int) -> None:
    """Resize the ring (tests / long capture sessions); keeps the newest
    spans."""
    global _spans
    with _lock:
        _spans = deque(_spans, maxlen=max(int(n), 1))


def reset() -> None:
    with _lock:
        _spans.clear()


def record_span(name: str, cat: str, start_us: float, dur_us: float,
                pid: str = "worker", tid: str = "",
                args: Optional[Dict[str, Any]] = None) -> None:
    """Append one completed span.  ``start_us`` is absolute microseconds
    (use :func:`now_us`); ``dur_us`` the span length."""
    with _lock:
        _spans.append((name, cat, start_us, dur_us, pid, tid, args))


def instant(name: str, cat: str, pid: str = "worker", tid: str = "",
            args: Optional[Dict[str, Any]] = None) -> None:
    """A zero-duration marker (rendered as an instant event)."""
    record_span(name, cat, now_us(), 0.0, pid, tid, args)


@contextmanager
def span(name: str, cat: str, pid: str = "worker", tid: str = "",
         args: Optional[Dict[str, Any]] = None) -> Iterator[None]:
    """Time a block and record it; exceptions still record the span."""
    t0 = time.perf_counter()
    start = _WALL_ANCHOR_US + t0 * 1e6
    try:
        yield
    finally:
        record_span(name, cat, start,
                    (time.perf_counter() - t0) * 1e6, pid, tid, args)


def ctx_tid(ctx) -> str:
    """Trace track id for an operator context — tolerant of the
    duck-typed test contexts that carry no task_info."""
    ti = getattr(ctx, "task_info", None)
    return getattr(ti, "task_id", "") if ti is not None else ""


def spans(cat: Optional[str] = None) -> List[tuple]:
    """Snapshot of the ring, oldest first (optionally one category)."""
    with _lock:
        out = list(_spans)
    if cat is not None:
        out = [s for s in out if s[1] == cat]
    return out


def chrome_trace(cat: Optional[str] = None) -> Dict[str, Any]:
    """Chrome Trace Event Format JSON dict (Perfetto-loadable)."""
    events: List[Dict[str, Any]] = []
    tids: Dict[tuple, None] = {}
    for name, scat, start, dur, pid, tid, args in spans(cat):
        if dur > 0:
            ev: Dict[str, Any] = {
                "name": name, "cat": scat, "ph": "X",
                "ts": round(start, 1), "dur": round(dur, 1),
                "pid": pid, "tid": tid or scat,
            }
        else:
            # zero-width "X" slices are invisible in Perfetto; instants
            # (watermark.emit markers) render as thread-scoped arrows
            ev = {
                "name": name, "cat": scat, "ph": "i", "s": "t",
                "ts": round(start, 1), "pid": pid, "tid": tid or scat,
            }
        if args:
            ev["args"] = args
        events.append(ev)
        tids.setdefault((pid, ev["tid"]))
    # thread-name metadata keeps Perfetto's track labels readable
    for pid, tid in tids:
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": str(tid)}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
