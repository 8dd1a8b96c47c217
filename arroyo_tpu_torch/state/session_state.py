"""Partition-adaptive session-window state (port of
``arroyo_tpu.state.session_state``).

The legacy session path keeps each key's ``[(start, end), ...]`` session
list in a :class:`~arroyo_tpu_torch.state.tables.KeyedState` dict and
merges arriving intervals with a Python loop per key.  This module keeps
ALL keys' live sessions as hash-partitioned, **incrementally sorted
interval runs**:

* one flat ``(key_hash, start, end)`` run per partition, sorted by
  ``(key, start)`` — partitions route on the LOW hash bits
  (``kh & (P-1)``), orthogonal to the subtask key ranges on the HIGH
  bits, so rescale never re-partitions;
* an arriving batch's candidate intervals merge in **one vectorized
  interval-union dispatch for all keys at once**
  (:func:`arroyo_tpu_torch.ops.session.union_sorted_intervals`, the
  ``session_union`` kernel on the state's device): only the touched
  keys' resident rows join the scan, untouched rows splice back
  positionally;
* the max-session-size clamp keeps the per-key path authoritative: any
  key whose unclamped union span exceeds the clamp is returned to the
  caller, which re-runs the legacy merge for exactly that key — the
  device/host split is counted (``session_device_merge_rows`` /
  ``session_host_merge_rows``);
* watermark fires are a **mask-compress**: ``expire()`` splits each
  partition's run at ``end <= watermark`` in O(rows) vector ops.

The runs stay host numpy: the union scan uploads the touched rows it
reads, and no kernel reads resident planes, so the JAX package's staging
of hot partitions onto the device is not ported.

Checkpoint contract: :class:`SessionRunState` duck-types
:class:`~arroyo_tpu_torch.state.tables.KeyedState` — ``snapshot()``
emits the same ``[(time, key, sessions)]`` entries and ``restore()``
accepts them, so epochs written by either layout (or by the JAX
package's) restore into the other.

Knobs, as in the JAX package:
  ARROYO_SESSION_STATE=device|legacy    state layout (default device)
  ARROYO_SESSION_PARTITIONS=16          partitions (power of two)
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..obs import perf
from ..obs.metrics import session_merge_counter

_SESSION_UIDS = itertools.count()


def session_state_enabled() -> bool:
    return os.environ.get("ARROYO_SESSION_STATE", "device") != "legacy"


def session_partitions() -> int:
    p = int(os.environ.get("ARROYO_SESSION_PARTITIONS", 16))
    b = 1
    while b * 2 <= max(p, 1):
        b *= 2
    return b


def _count_merge(dev_rows: int, host_rows: int) -> None:
    """Account merged interval rows to the device/host split (perf
    counters and their metric mirrors) — the vectorized-merge share is a
    measured number, not an assumption."""
    if dev_rows:
        perf.count("session_device_merge_rows", dev_rows)
        session_merge_counter("device").inc(dev_rows)
    if host_rows:
        perf.count("session_host_merge_rows", host_rows)
        session_merge_counter("host").inc(host_rows)


class _SessionPartition:
    """One hash partition: a flat session-interval run sorted by
    ``(key, start)`` plus per-row last-update times (the KEYED snapshot
    ``t`` column)."""

    __slots__ = ("kh", "st", "en", "tm")

    def __init__(self) -> None:
        self.kh = np.empty(0, dtype=np.uint64)
        self.st = np.empty(0, dtype=np.int64)
        self.en = np.empty(0, dtype=np.int64)
        self.tm = np.empty(0, dtype=np.int64)

    @property
    def n(self) -> int:
        return len(self.kh)

    def set_rows(self, kh: np.ndarray, st: np.ndarray, en: np.ndarray,
                 tm: np.ndarray) -> None:
        self.kh, self.st, self.en, self.tm = kh, st, en, tm

    def key_slice(self, kh: int) -> slice:
        k = np.uint64(kh)
        lo = int(np.searchsorted(self.kh, k, side="left"))
        hi = int(np.searchsorted(self.kh, k, side="right"))
        return slice(lo, hi)

    def touched_mask(self, keys_sorted: np.ndarray) -> np.ndarray:
        """Row mask of resident rows whose key is in ``keys_sorted`` —
        one flag-array cumsum over the per-key searchsorted ranges, no
        per-key loop."""
        n = self.n
        if n == 0 or len(keys_sorted) == 0:
            return np.zeros(n, dtype=bool)
        lo = np.searchsorted(self.kh, keys_sorted, side="left")
        hi = np.searchsorted(self.kh, keys_sorted, side="right")
        f = np.zeros(n + 1, dtype=np.int64)
        np.add.at(f, lo, 1)
        np.add.at(f, hi, -1)
        return np.cumsum(f[:-1]) > 0

    def splice(self, keep: np.ndarray, bkh: np.ndarray, bst: np.ndarray,
               ben: np.ndarray, btm: np.ndarray) -> None:
        """Replace this run with (kept resident rows) ∪ (replacement
        rows ``b*``, sorted by (key, start), keys disjoint from the kept
        rows' keys) — one positional merge, no comparison sort of
        resident state."""
        akh = self.kh[keep]
        ast_ = self.st[keep]
        aen = self.en[keep]
        atm = self.tm[keep]
        na, nb = len(akh), len(bkh)
        if nb == 0:
            self.set_rows(akh, ast_, aen, atm)
            return
        # all rows of one key live on one side, so a key-level
        # searchsorted places every replacement row correctly
        ins = np.searchsorted(akh, bkh, side="left")
        bpos = ins + np.arange(nb, dtype=np.int64)
        total = na + nb
        okh = np.empty(total, dtype=np.uint64)
        ost = np.empty(total, dtype=np.int64)
        oen = np.empty(total, dtype=np.int64)
        otm = np.empty(total, dtype=np.int64)
        kmask = np.ones(total, dtype=bool)
        kmask[bpos] = False
        okh[bpos], ost[bpos], oen[bpos], otm[bpos] = bkh, bst, ben, btm
        okh[kmask], ost[kmask], oen[kmask], otm[kmask] = (akh, ast_, aen,
                                                          atm)
        self.set_rows(okh, ost, oen, otm)


class SessionRunState:
    """Device-capable session-window state (module docstring).  Duck-
    types :class:`~arroyo_tpu_torch.state.tables.KeyedState` — the per-key
    API (``get``/``insert``/``remove``/``items``) keeps the legacy
    clamp path and checkpoint interchange working against the same
    object that serves the vectorized batch merge."""

    def __init__(self, n_partitions: Optional[int] = None,
                 max_span: Optional[int] = None, device: DeviceLike = None):
        from ..engine.operators_window import MAX_SESSION_SIZE_MICROS

        self.device = resolve_device(device)  # None: the CUDA device
        self.P = n_partitions or session_partitions()
        self.parts = [_SessionPartition() for _ in range(self.P)]
        self.max_span = (MAX_SESSION_SIZE_MICROS if max_span is None
                         else max_span)
        self._uid = next(_SESSION_UIDS)
        self._merges = 0

    # -- routing -----------------------------------------------------------

    def _route(self, kh: np.ndarray) -> np.ndarray:
        return (kh & np.uint64(self.P - 1)).astype(np.int64)

    def _part_of(self, kh: int) -> _SessionPartition:
        return self.parts[int(kh) & (self.P - 1)]

    # -- vectorized batch merge --------------------------------------------

    def merge_intervals(self, ikh: np.ndarray, ist: np.ndarray,
                        ien: np.ndarray, itm: np.ndarray) -> np.ndarray:
        """Merge a batch's candidate session intervals (sorted by
        ``(key, start)``, gap already applied to ends) into the resident
        runs — ONE union dispatch across every touched key.  Returns the
        keys whose merged span would cross the max-session clamp; their
        resident rows are left UNTOUCHED for the caller's authoritative
        per-key re-merge."""
        m = len(ikh)
        if m == 0:
            return np.zeros(0, dtype=np.uint64)
        from ..ops.session import union_sorted_intervals

        dest = self._route(ikh)
        touched_parts = np.unique(dest).tolist()
        dkeys = np.unique(ikh)
        # 1. pull the touched keys' resident rows out of each partition
        pulled: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]] = {}
        keeps: Dict[int, np.ndarray] = {}
        for p in touched_parts:
            part = self.parts[p]
            tm_mask = part.touched_mask(dkeys)
            keeps[p] = ~tm_mask
            pulled[p] = (part.kh[tm_mask], part.st[tm_mask],
                         part.en[tm_mask], part.tm[tm_mask])
        # 2. one global (key, start) sort of touched-resident + delta
        #    rows, then ONE vectorized union for ALL keys at once
        ckh = np.concatenate([pulled[p][0] for p in touched_parts] + [ikh])
        cst = np.concatenate([pulled[p][1] for p in touched_parts] + [ist])
        cen = np.concatenate([pulled[p][2] for p in touched_parts] + [ien])
        ctm = np.concatenate([pulled[p][3] for p in touched_parts] + [itm])
        order = np.lexsort((cst, ckh))
        ckh, cst, cen, ctm = ckh[order], cst[order], cen[order], ctm[order]
        m_kh, m_st, m_en, _sid, sess_first = union_sorted_intervals(
            ckh, cst, cen, device=self.device)
        m_tm = np.maximum.reduceat(ctm, sess_first)
        self._merges += 1
        perf.count("session_merge_dispatches")
        if self.device.type == "cuda":  # the kernel, not its plain version
            perf.count("session_merge_device_dispatches")
        # 3. clamp detection: an unclamped union span over the max is
        #    EXACTLY the condition under which the legacy per-key merge
        #    would have clamped (ops/session.py module docstring) —
        #    those keys fall back wholesale, state untouched
        over = (m_en - m_st) > self.max_span
        if over.any():
            flagged = np.unique(m_kh[over])
            ok_rows = ~np.isin(m_kh, flagged)
            m_kh, m_st, m_en, m_tm = (m_kh[ok_rows], m_st[ok_rows],
                                      m_en[ok_rows], m_tm[ok_rows])
            flag_mask = np.isin(ikh, flagged)
            host_rows = int(flag_mask.sum())
        else:
            flagged = np.zeros(0, dtype=np.uint64)
            host_rows = 0
        _count_merge(m - host_rows, 0)  # caller counts fallback rows
        # 4. splice merged runs back per partition; flagged keys keep
        #    their resident rows (restored from the pulled copies)
        mdest = self._route(m_kh)
        for p in touched_parts:
            part = self.parts[p]
            sel = mdest == p
            bkh, bst, ben, btm = (m_kh[sel], m_st[sel], m_en[sel],
                                  m_tm[sel])
            if len(flagged):
                # resident rows of flagged keys re-enter untouched;
                # their keys are disjoint from the merged keys so the
                # combined replacement stays (key, start)-sortable
                rkh, rst, ren, rtm = pulled[p]
                fm = np.isin(rkh, flagged)
                if fm.any():
                    bkh = np.concatenate([bkh, rkh[fm]])
                    bst = np.concatenate([bst, rst[fm]])
                    ben = np.concatenate([ben, ren[fm]])
                    btm = np.concatenate([btm, rtm[fm]])
                    o = np.lexsort((bst, bkh))
                    bkh, bst, ben, btm = bkh[o], bst[o], ben[o], btm[o]
            part.splice(keeps[p], bkh, bst, ben, btm)
        if self._merges % 16 == 1:
            reg = perf.get_note("session_state_registry")
            if not isinstance(reg, dict):
                reg = {}
                perf.note("session_state_registry", reg)
            reg[self._uid] = self.stats()
        return flagged

    # -- watermark fires ---------------------------------------------------

    def expire(self, watermark: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[int]]:
        """Mask-compress every session with ``end <= watermark`` out of
        the runs.  Returns ``(keys, starts, ends)`` of the fired
        sessions plus the fully-expired keys (for ``note_delete``
        tombstones).  Remaining rows of partially fired keys take
        ``watermark`` as their update time — the legacy
        ``windows.insert(watermark, kh, remain)`` contract."""
        fk: List[np.ndarray] = []
        fs: List[np.ndarray] = []
        fe: List[np.ndarray] = []
        removed: List[int] = []
        for part in self.parts:
            if part.n == 0:
                continue
            fired = part.en <= watermark
            if not fired.any():
                continue
            fk.append(part.kh[fired])
            fs.append(part.st[fired])
            fe.append(part.en[fired])
            kept = ~fired
            kkh = part.kh[kept]
            gone = np.setdiff1d(part.kh[fired], kkh)
            removed.extend(int(k) for k in gone.tolist())
            ktm = part.tm[kept]
            if len(kkh):
                # keys that fired some sessions but keep others
                partial = np.isin(kkh, np.unique(part.kh[fired]))
                ktm = np.where(partial, np.int64(watermark), ktm)
            part.set_rows(kkh, part.st[kept], part.en[kept], ktm)
        if not fk:
            z = np.zeros(0, dtype=np.int64)
            return np.zeros(0, dtype=np.uint64), z, z.copy(), removed
        return (np.concatenate(fk), np.concatenate(fs),
                np.concatenate(fe), removed)

    def min_end(self) -> Optional[int]:
        ends = [int(part.en.min()) for part in self.parts if part.n]
        return min(ends) if ends else None

    def min_live_start(self) -> Optional[int]:
        starts = [int(part.st.min()) for part in self.parts if part.n]
        return min(starts) if starts else None

    # -- KeyedState duck interface (per-key fallback + checkpoints) --------

    def insert(self, time: int, key: Any, value: Sequence[Tuple[int, int]]
               ) -> None:
        part = self._part_of(key)
        sl = part.key_slice(key)
        keep = np.ones(part.n, dtype=bool)
        keep[sl] = False
        rows = sorted((int(s), int(e)) for s, e in value)
        nb = len(rows)
        bkh = np.full(nb, np.uint64(key), dtype=np.uint64)
        bst = np.fromiter((s for s, _ in rows), dtype=np.int64, count=nb)
        ben = np.fromiter((e for _, e in rows), dtype=np.int64, count=nb)
        btm = np.full(nb, int(time), dtype=np.int64)
        part.splice(keep, bkh, bst, ben, btm)

    def get(self, key: Any) -> Optional[List[Tuple[int, int]]]:
        part = self._part_of(key)
        sl = part.key_slice(key)
        if sl.start == sl.stop:
            return None
        return list(zip(part.st[sl].tolist(), part.en[sl].tolist()))

    def get_time(self, key: Any) -> Optional[int]:
        part = self._part_of(key)
        sl = part.key_slice(key)
        if sl.start == sl.stop:
            return None
        return int(part.tm[sl].max())

    def remove(self, key: Any) -> None:
        part = self._part_of(key)
        sl = part.key_slice(key)
        if sl.start == sl.stop:
            return
        keep = np.ones(part.n, dtype=bool)
        keep[sl] = False
        z = np.zeros(0, dtype=np.int64)
        part.splice(keep, np.zeros(0, dtype=np.uint64), z, z.copy(),
                    z.copy())

    def items(self) -> Iterator[Tuple[int, List[Tuple[int, int]]]]:
        for part in self.parts:
            n = part.n
            if n == 0:
                continue
            bounds = np.nonzero(np.concatenate(
                [[True], part.kh[1:] != part.kh[:-1]]))[0]
            bounds = np.append(bounds, n)
            for i in range(len(bounds) - 1):
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                yield (int(part.kh[lo]),
                       list(zip(part.st[lo:hi].tolist(),
                                part.en[lo:hi].tolist())))

    def snapshot(self) -> List[Tuple[int, Any, Any]]:
        """The KEYED table entry form — ``[(time, key, sessions)]`` —
        so epochs interchange with the legacy KeyedState layout in both
        directions (and rescale's key-range filter applies per key)."""
        out: List[Tuple[int, Any, Any]] = []
        for kh, sessions in self.items():
            out.append((self.get_time(kh) or 0, kh, sessions))
        return out

    def restore(self, entries: Sequence[Tuple[int, Any, Any]]) -> None:
        """Bulk-load KEYED entries (either layout wrote them) into
        sorted runs: one lexsort per partition, not one splice per
        key."""
        rows_kh: List[int] = []
        rows_st: List[int] = []
        rows_en: List[int] = []
        rows_tm: List[int] = []
        latest: Dict[int, Tuple[int, Any]] = {}
        for t, k, v in entries:
            latest[int(k)] = (int(t), v)  # last write wins (restore order)
        for k, (t, v) in latest.items():
            for s, e in v:
                rows_kh.append(k)
                rows_st.append(int(s))
                rows_en.append(int(e))
                rows_tm.append(t)
        kh = np.array(rows_kh, dtype=np.uint64)
        st = np.array(rows_st, dtype=np.int64)
        en = np.array(rows_en, dtype=np.int64)
        tm = np.array(rows_tm, dtype=np.int64)
        dest = self._route(kh) if len(kh) else np.zeros(0, dtype=np.int64)
        for p in range(self.P):
            sel = dest == p
            pkh, pst, pen, ptm = kh[sel], st[sel], en[sel], tm[sel]
            o = np.lexsort((pst, pkh))
            self.parts[p].set_rows(pkh[o], pst[o], pen[o], ptm[o])

    def n_keys(self) -> int:
        total = 0
        for part in self.parts:
            if part.n:
                total += 1 + int((part.kh[1:] != part.kh[:-1]).sum())
        return total

    def __len__(self) -> int:
        return self.n_keys()  # KeyedState len() counts keys

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Session-state shape for bench/ops: resident rows (live
        session intervals), keys and their host bytes — bench's
        ``state_bounded`` gate holds ``rows`` against the session-churn
        horizon."""
        rows = sum(part.n for part in self.parts)
        host_bytes = sum(part.kh.nbytes + part.st.nbytes + part.en.nbytes
                         + part.tm.nbytes for part in self.parts)
        return {"partitions": self.P, "rows": rows, "keys": self.n_keys(),
                "host_bytes": host_bytes, "merge_dispatches": self._merges}


def aggregate_session_registry(reg: Optional[Dict[Any, Dict[str, Any]]]
                               ) -> Dict[str, Any]:
    """Fold the per-state stats registry into one shape summary for the
    bench counters block."""
    entries = list((reg or {}).values())
    if not entries:
        return {}
    out = {"partitions": max(e.get("partitions", 0) for e in entries),
           "states": len(entries)}
    for k in ("rows", "keys", "host_bytes", "merge_dispatches"):
        out[k] = int(sum(e.get(k, 0) for e in entries))
    return out
