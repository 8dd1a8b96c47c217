"""Vectorized session-interval union: ONE merge dispatch per batch (port
of ``arroyo_tpu.ops.session``).

Over ``(key_hash, start, end)`` interval rows sorted by ``(key, start)``
it computes, for ALL keys at once:

1. a **segmented running max of ends** (int64-exact; the per-group
   offset trick would overflow int64 with micros timestamps),
2. a *new-session* flag wherever an interval's start exceeds the running
   end of every prior interval of its key (touching intervals merge),
3. per-session merged bounds: each session's first row and its running
   end at its last row.

All three are the ``session_union`` kernel's buffer form on the state's
device (its plain PyTorch version when that device is the CPU): one
upload of the three columns, one launch, one readback.  The max-size
clamp is not vectorized: the caller re-runs the authoritative per-key
path for keys whose union span crosses it (see state/session_state.py).

``session_union_uploads`` / ``session_union_readbacks`` count a union's
host-to-device and device-to-host copies, ``session_union_blocking_uploads``
the uploads that held the host (a plain copy to a CPU device); the card
makes none."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import to_device, to_host
from ..kernels.session_union import session_union_buffer
from ..obs import perf
from ..obs.perf import timed_device


def union_sorted_intervals(
    kh: np.ndarray, st: np.ndarray, en: np.ndarray,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Union interval rows sorted by ``(key, start)`` into disjoint
    sessions per key (touching intervals merge); the scan runs through
    ``session_union_buffer`` on ``device``.

    Returns ``(m_kh, m_st, m_en, sid, sess_first)``: merged session
    keys/bounds (still sorted by ``(key, start)``), the per-input-row
    merged-session ordinal ``sid``, and the first input row of each
    session."""
    n = len(kh)
    if n == 0:
        z64 = np.zeros(0, dtype=np.int64)
        return (np.zeros(0, dtype=np.uint64), z64.copy(), z64.copy(),
                z64.copy(), z64.copy())
    rows = np.empty((3, n), dtype=np.int64)
    rows[0] = np.asarray(kh, dtype=np.uint64).view(np.int64)
    rows[1] = st
    rows[2] = en
    if device.type != "cuda":
        perf.count("session_union_blocking_uploads")
    up = to_device(rows, device)
    perf.count("session_union_uploads")
    host = to_host(timed_device(session_union_buffer, up[0], up[1], up[2]))
    perf.count("session_union_readbacks")
    s = int(host[0])
    sess_first = host[1:1 + s].copy()
    m_en = host[1 + n:1 + n + s].copy()
    sid = np.repeat(np.arange(s, dtype=np.int64),
                    np.diff(sess_first, append=n))
    # sorted by start: a session's first interval owns its min start
    return kh[sess_first], st[sess_first], m_en, sid, sess_first
