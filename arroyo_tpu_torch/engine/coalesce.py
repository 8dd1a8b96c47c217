"""Micro-batch coalescing at task inputs (port of the ``BatchCoalescer``
of ``arroyo_tpu.engine.coalesce``): consecutive record batches arriving
at a task (or chain) input merge into one batch before the operator
sees it, so small fragments pay one operator pass between them.

Ordering rules:

* a buffered batch is never reordered past a watermark, barrier or
  end-of-stream marker: the task loop flushes every buffer before it
  handles any of them;
* batches merge only within one input side (join sides never mix) and
  only while the column names and key layout match: a mismatch flushes
  the old buffer first;
* the first buffered fragment starts a linger deadline, and the task
  loop flushes on expiry even if the target size was never reached.

``ARROYO_COALESCE=0`` turns coalescing off; ``COALESCE_TARGET``
(0: ``BATCH_SIZE``) and ``COALESCE_LINGER_MICROS`` bound the size and
the added latency.  The JAX package's ``SourceBatcher`` (connector
fragments merged before decode) is not ported."""

from __future__ import annotations

import os
import time as _time
from typing import Dict, List, Optional, Tuple

from ..types import Batch


def coalescing_enabled() -> bool:
    """``ARROYO_COALESCE=0`` turns coalescing off (read per call)."""
    return os.environ.get("ARROYO_COALESCE", "1") not in ("0", "off",
                                                          "false")


def _signature(batch: Batch) -> Tuple:
    """What two batches must share to merge: column names, key columns
    and whether a key hash rides along (numpy promotes dtypes)."""
    return (tuple(batch.columns.keys()), batch.key_cols,
            batch.key_hash is not None)


class _SideBuffer:
    __slots__ = ("sig", "batches", "rows")

    def __init__(self, sig: Tuple, batch: Batch):
        self.sig = sig
        self.batches: List[Batch] = [batch]
        self.rows = len(batch)


class BatchCoalescer:
    """Record batches buffered per side up to ``target`` rows within a
    ``linger`` deadline.  ``add`` returns the batches that became ready;
    ``flush_all`` drains every buffer, in arrival order."""

    def __init__(self, target: int, linger_secs: float):
        self.target = max(int(target), 1)
        self.linger = max(float(linger_secs), 0.0)
        self._bufs: Dict[int, _SideBuffer] = {}  # side -> buffer (ordered)
        self._deadline: Optional[float] = None

    @property
    def pending(self) -> bool:
        return bool(self._bufs)

    @property
    def deadline(self) -> Optional[float]:
        """Monotonic time by which pending buffers must flush."""
        return self._deadline

    def add(self, side: int, batch: Batch) -> List[Tuple[int, Batch]]:
        """Buffer one batch; returns ``[(side, batch)]`` for what became
        ready (a layout change can release the old buffer and the new
        batch in one call)."""
        out: List[Tuple[int, Batch]] = []
        if len(batch) == 0:
            return out
        sig = _signature(batch)
        buf = self._bufs.get(side)
        if buf is not None and buf.sig != sig:
            out.append((side, Batch.concat(buf.batches)))
            del self._bufs[side]
            buf = None
        if buf is None:
            if len(batch) >= self.target:
                out.append((side, batch))  # at target: no copy, no linger
                self._retime()
                return out
            self._bufs[side] = _SideBuffer(sig, batch)
            if self._deadline is None:
                self._deadline = _time.monotonic() + self.linger
            return out
        buf.batches.append(batch)
        buf.rows += len(batch)
        if buf.rows >= self.target:
            out.append((side, Batch.concat(buf.batches)))
            del self._bufs[side]
            self._retime()
        return out

    def flush_all(self) -> List[Tuple[int, Batch]]:
        """Drain every buffer in arrival order (before any watermark,
        barrier or end of stream, and on linger expiry)."""
        out = [(side, Batch.concat(buf.batches))
               for side, buf in self._bufs.items()]
        self._bufs.clear()
        self._deadline = None
        return out

    def _retime(self) -> None:
        if not self._bufs:
            self._deadline = None
