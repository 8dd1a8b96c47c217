"""Lightweight performance accounting — the counters and ``timed_device``
of ``arroyo_tpu.obs.perf``.

``timed_device`` wraps each device-kernel call: it counts the dispatch
(``kernel_dispatches``) and, under ``ARROYO_TIMING=1``, synchronizes the
CUDA device after the call so ``device_ns`` accumulates true device time.
That serializes dispatch: it is for measurement runs, not production."""

from __future__ import annotations

import os
import time
from typing import Any, Dict

import torch

_COUNTERS: Dict[str, int] = {}
_NOTES: Dict[str, Any] = {}


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


def get_note(key: str) -> Any:
    return _NOTES.get(key)


def timed_device(call, *args) -> Any:
    """Run one device-kernel call; with ``ARROYO_TIMING=1`` block until
    the device is done and add the elapsed time to ``device_ns`` and to
    ``device_ns:<the call's name>`` (which also holds any copy queued on
    the stream ahead of it, such as an upload from pinned memory)."""
    count("kernel_dispatches")
    if not timing_enabled():
        return call(*args)
    t0 = time.perf_counter_ns()
    out = call(*args)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter_ns() - t0
    count("device_ns", dt)
    count(f"device_ns:{call.__name__}", dt)
    return out


def counters(prefix: str) -> Dict[str, int]:
    """The counters whose names start with ``prefix``."""
    return {k: v for k, v in _COUNTERS.items() if k.startswith(prefix)}
