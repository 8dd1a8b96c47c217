"""Streaming-invariant runtime sanitizer (port of
``arroyo_tpu.analysis.sanitizer``).

TSAN/UBSAN analogue for the asyncio runtime — ``ARROYO_SANITIZE=1``
arms invariant assertions at the runtime's protocol choke points:

- **watermark monotonicity** per input edge: an event-time watermark
  must never regress behind the previous one on the same edge;
- **barrier alignment**: no data batch crosses a partially-aligned
  barrier — once an input delivered its barrier for an epoch, records
  from that input must park until alignment completes;
- **snapshot/upload atomicity**: no state-table mutation between the
  checkpoint snapshot and its persistence (a mutation there ships a
  torn epoch);
- **coalescer flush-before-control**: buffered record fragments must be
  flushed before any watermark/barrier/end is handled (the coalescer's
  ordering contract);
- **per-edge batch schema stability**: the column layout of record
  batches on one edge must stay stable (a silent layout change
  corrupts the data-plane continuation-frame cache and coalescer);
- **per-edge sharding stability**: an operator's OUTPUT sharding spec
  on one shuffle edge must not flip mid-stream (device exchange one
  batch, host route the next): the collector reports each keyed
  multi-destination batch's route (:meth:`Sanitizer.on_sharding`,
  ``keys@n`` or ``host@n``);
- **checkpoint completeness**: each epoch sees exactly one completion
  per distinct (member operator, subtask) — a duplicate means two
  snapshots raced for the same slot.

A violation raises :class:`SanitizerError` carrying a ring of the most
recent protocol events (and the obs/tracing span tail), so the triage
starts from the interleaving that broke the invariant rather than a
bare assert.

Zero steady-state cost when off: every instrumented site holds a local
that is ``None`` unless ``ARROYO_SANITIZE`` was set when the engine was
built, so the disabled path is a single ``is not None`` test.
"""

from __future__ import annotations

import os
import threading
import time as _time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "SanitizerError",
    "Sanitizer",
    "sanitize_enabled",
    "maybe_sanitizer",
    "recent_events",
]

_RING_CAP = int(os.environ.get("ARROYO_SANITIZE_RING", "256"))

# one process-wide event ring (like obs.tracing's span ring): events are
# cheap tuples, and violations in one engine may need events from a
# peer (controller vs worker paths share the process in local mode)
_ring_lock = threading.Lock()
_ring: deque = deque(maxlen=_RING_CAP)


def sanitize_enabled() -> bool:
    """``ARROYO_SANITIZE=1`` arms the sanitizer (read per engine build,
    not at import, so tests and bench can toggle per run)."""
    return os.environ.get("ARROYO_SANITIZE", "0") not in ("0", "off",
                                                          "false", "")


def maybe_sanitizer(scope: str = "job") -> Optional["Sanitizer"]:
    """The instrumentation sites' constructor: a live Sanitizer when
    armed, else ``None`` (the hot paths guard on ``is not None``)."""
    return Sanitizer(scope) if sanitize_enabled() else None


def recent_events(limit: int = 64) -> List[tuple]:
    """Tail of the process-wide sanitizer event ring, oldest first."""
    with _ring_lock:
        out = list(_ring)
    return out[-limit:]


def _reset_ring() -> None:
    """Test hook: clear the shared ring between fixtures."""
    with _ring_lock:
        _ring.clear()


class SanitizerError(AssertionError):
    """A streaming invariant was violated at runtime.

    ``code`` names the invariant; ``events`` is the tail of the
    sanitizer event ring at violation time (oldest first) — the recent
    protocol interleaving that led here."""

    def __init__(self, code: str, message: str,
                 events: Optional[List[tuple]] = None):
        self.code = code
        self.events = events or []
        tail = "\n".join(
            f"  {ts:.6f} {kind:<12} {task} {detail}"
            for ts, kind, task, detail in self.events[-16:])
        super().__init__(
            f"arroyosan[{code}]: {message}\n"
            f"recent events (oldest first):\n{tail or '  (none)'}")


class Sanitizer:
    """Per-engine-run invariant state.  All hooks are cheap dict/tuple
    operations; none dispatches to a device or takes an await point."""

    def __init__(self, scope: str = "job"):
        self.scope = scope
        # (edge key) -> last event-time watermark micros
        self._edge_wm: Dict[Any, int] = {}
        # (edge key) -> (column names, key_cols, has key_hash)
        self._edge_schema: Dict[Any, Tuple] = {}
        # (edge key) -> output sharding spec string ("keys@n" / "host@n");
        # only the multi-device port will fill it
        self._edge_sharding: Dict[Any, str] = {}
        # epoch -> {(operator_id, subtask)} completions seen; epochs far
        # behind the newest are pruned (they can never recur within one
        # run — the controller's per-epoch trackers are bounded the same
        # way), so a years-long sanitized job doesn't leak memory
        self._completed: Dict[int, set] = {}
        self.violations = 0

    # -- event ring --------------------------------------------------------

    def event(self, kind: str, task: str, detail: Any = "") -> None:
        with _ring_lock:
            _ring.append((_time.monotonic(), kind, task, detail))

    def violation(self, code: str, message: str) -> None:
        self.violations += 1
        err = SanitizerError(code, message, recent_events())
        try:
            from ..obs import tracing

            tracing.instant("sanitizer.violation", "sanitizer",
                            args={"code": code, "scope": self.scope})
        except Exception:
            pass
        raise err

    # -- invariant hooks ---------------------------------------------------

    def on_watermark(self, edge: Any, wm: Any) -> None:
        """Per-edge watermark monotonicity (event-time only: Idle
        carries no time and a later event-time watermark may follow)."""
        if getattr(wm, "is_idle", False):
            self.event("wm-idle", str(edge))
            return
        t = int(wm.time)
        prev = self._edge_wm.get(edge)
        self.event("watermark", str(edge), t)
        if prev is not None and t < prev:
            self.violation(
                "watermark-regression",
                f"edge {edge}: watermark went backwards "
                f"({prev} -> {t}, delta {t - prev}us)")
        self._edge_wm[edge] = t

    def reset_edge(self, edge: Any) -> None:
        """Forget an edge's schema tracker — called at a *declared*
        schema change point (the data plane's full KIND_DATA frame
        mid-stream), so the next batch re-seeds stability tracking
        instead of raising."""
        self.event("schema-reset", str(edge))
        self._edge_schema.pop(edge, None)

    def on_record(self, edge: Any, batch: Any) -> None:
        """Per-edge batch schema stability: column names / key layout
        must not drift mid-stream (dtypes may promote — numpy concat
        semantics — but a column appearing or vanishing is corruption)."""
        sig = (tuple(batch.columns.keys()), tuple(batch.key_cols),
               batch.key_hash is not None)
        prev = self._edge_schema.get(edge)
        if prev is None:
            self._edge_schema[edge] = sig
            self.event("schema", str(edge), list(sig[0]))
            return
        if prev != sig:
            self.event("schema", str(edge), list(sig[0]))
            self.violation(
                "schema-instability",
                f"edge {edge}: batch layout changed mid-stream "
                f"{prev} -> {sig}")

    def on_sharding(self, edge: Any, spec: str) -> None:
        """Per-edge output sharding stability: the routing decision for
        one shuffle edge (on-device ``all_to_all`` vs host partition)
        must be made once and hold for the stream's life.  The device
        path is sticky-by-construction (``DeviceShuffle`` falls back
        permanently on the first unsupported batch); a flip reaching
        here means the stickiness broke — the resharding analogue of a
        mid-stream column-layout change."""
        prev = self._edge_sharding.get(edge)
        if prev is None:
            self._edge_sharding[edge] = spec
            self.event("sharding", str(edge), spec)
            return
        if prev != spec:
            self.event("sharding", str(edge), spec)
            self.violation(
                "sharding-instability",
                f"edge {edge}: output sharding spec flipped mid-stream "
                f"({prev} -> {spec})")

    def on_record_during_alignment(self, task: str, input_idx: int,
                                   counter: Any) -> None:
        """No data batch crosses a partially-aligned barrier: if input
        ``input_idx`` already delivered its barrier for a pending epoch,
        a record from it must not reach the operator until the barrier
        aligns (the pump should have parked the channel)."""
        for epoch, seen in getattr(counter, "seen", {}).items():
            if input_idx in seen:
                self.violation(
                    "barrier-crossing",
                    f"task {task}: record from input {input_idx} "
                    f"crossed its own barrier for epoch {epoch} "
                    "(partially-aligned barrier overtaken by data)")

    def on_barrier(self, task: str, input_idx: int, epoch: int) -> None:
        self.event("barrier", task, {"input": input_idx, "epoch": epoch})

    def before_control(self, task: str, kind: str,
                       coalescer: Any = None) -> None:
        """Coalescer flush-before-control: at the moment a watermark/
        barrier/end is handled, no record fragment may still sit in the
        input coalescer (it would be reordered past the control event)."""
        self.event("control", task, kind)
        if coalescer is not None and getattr(coalescer, "pending", False):
            self.violation(
                "coalesce-unflushed",
                f"task {task}: {kind} handled while the input coalescer "
                "still buffers record fragments (flush-before-control "
                "ordering broken)")

    def on_checkpoint_completed(self, operator_id: str, subtask: int,
                                epoch: int) -> None:
        """Checkpoint completeness: one completion per distinct
        (member, subtask) per epoch."""
        key = (operator_id, subtask)
        self.event("ckpt-done", f"{operator_id}-{subtask}",
                   {"epoch": epoch})
        if key in self._completed.get(epoch, ()):
            self.violation(
                "duplicate-checkpoint",
                f"{operator_id}-{subtask} reported checkpoint epoch "
                f"{epoch} twice (two snapshots raced for one slot)")
        self._completed.setdefault(epoch, set()).add(key)
        # epochs strictly increase within one run: anything far behind
        # the newest can never legitimately complete again
        for e in [e for e in self._completed if e < epoch - 16]:
            del self._completed[e]

    # -- snapshot/upload atomicity ----------------------------------------

    @staticmethod
    def _table_fingerprint(tables: Dict[str, Any]) -> Dict[str, int]:
        """Cheap per-table size token.  Device tables are skipped — their
        snapshot is the copy to the host itself, and sizing them would
        add a host sync to every checkpoint."""
        fp: Dict[str, int] = {}
        for name, table in tables.items():
            try:
                if hasattr(table, "n_keys"):
                    fp[name] = int(table.n_keys())
                elif hasattr(table, "__len__"):
                    fp[name] = len(table)
            except (TypeError, ValueError):
                continue
        return fp

    def checkpoint_begin(self, task: str,
                         tables: Dict[str, Any]) -> Dict[str, int]:
        self.event("ckpt-snap", task, {"tables": sorted(tables)})
        return self._table_fingerprint(tables)

    def checkpoint_end(self, task: str, tables: Dict[str, Any],
                       before: Dict[str, int]) -> None:
        after = self._table_fingerprint(tables)
        if after != before:
            changed = sorted(k for k in set(before) | set(after)
                             if before.get(k) != after.get(k))
            self.violation(
                "mutation-during-checkpoint",
                f"task {task}: state tables {changed} mutated between "
                "snapshot and upload (the persisted epoch is torn)")
