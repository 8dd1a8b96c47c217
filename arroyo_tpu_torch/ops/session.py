"""Vectorized session-interval union: ONE merge dispatch per batch (port
of ``arroyo_tpu.ops.session``).

Over ``(key_hash, start, end)`` interval rows sorted by ``(key, start)``
it computes, for ALL keys at once:

1. a **segmented running max of ends** (int64-exact; the per-group
   offset trick would overflow int64 with micros timestamps),
2. a *new-session* flag wherever an interval's start exceeds the running
   end of every prior interval of its key (touching intervals merge),
3. per-session merged bounds by ``reduceat`` over the flag boundaries.

Steps 1-2 are the ``session_union`` kernel on the state's device (its
plain PyTorch version when that device is the CPU).  The max-size clamp is not vectorized: the caller re-runs the authoritative
per-key path for keys whose union span crosses it (see
state/session_state.py)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels.session_union import session_union
from ..obs.perf import timed_device


def union_sorted_intervals(
    kh: np.ndarray, st: np.ndarray, en: np.ndarray,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Union interval rows sorted by ``(key, start)`` into disjoint
    sessions per key (touching intervals merge); the scan runs through
    ``session_union`` on ``device``.

    Returns ``(m_kh, m_st, m_en, sid, sess_first)``: merged session
    keys/bounds (still sorted by ``(key, start)``), the per-input-row
    merged-session ordinal ``sid``, and the first input row of each
    session."""
    n = len(kh)
    if n == 0:
        z64 = np.zeros(0, dtype=np.int64)
        return (np.zeros(0, dtype=np.uint64), z64.copy(), z64.copy(),
                z64.copy(), z64.copy())
    new_t, _run = timed_device(
        session_union,
        torch.tensor(np.ascontiguousarray(kh, dtype=np.uint64)
                     .view(np.int64), device=device),
        torch.tensor(st, dtype=torch.int64, device=device),
        torch.tensor(en, dtype=torch.int64, device=device))
    new = new_t.cpu().numpy()
    sess_first = np.nonzero(new)[0]
    sid = np.cumsum(new) - 1
    m_kh = kh[sess_first]
    m_st = st[sess_first]  # sorted by start: first interval owns the min
    m_en = np.maximum.reduceat(en, sess_first)
    return m_kh, m_st, m_en, sid.astype(np.int64), sess_first
