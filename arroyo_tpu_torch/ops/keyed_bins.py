"""Keyed binned aggregation state on the device — the port of
``arroyo_tpu.ops.keyed_bins``.

* the **key directory** lives on the host: a sorted uint64 array of known
  key hashes with a parallel slot array;
* the **bin ring** lives on the device as torch tensors:
  ``values`` f64[n_ch, C, B] (C key slots x B time bins of ``slide``
  width) and ``counts`` i32[C, B] (promoted to i64 before it could wrap);
* updates pre-aggregate rows to (slot, bin) cells on the host, buffer
  them (the JAX package's default update coalescing), and flush them
  with one :func:`~arroyo_tpu_torch.kernels.bin_update`
  launch;
* pane emission on watermark advance runs one device pass over all
  pending panes: under ``ARROYO_RING=on`` (or ``auto`` with a long
  window and several cards) the ring branch,
  :func:`~arroyo_tpu_torch.kernels.ring_emit.ring_emit` — one sweep of
  each occupied row's bin span, one launch, one readback; else the q5
  argmax branch through
  :func:`~arroyo_tpu_torch.kernels.argmax_fire.argmax_fire_buffer` (one
  upload, one launch, one readback); every other fire through the
  compact branch (:func:`~arroyo_tpu_torch.kernels.emit_count` +
  :func:`~arroyo_tpu_torch.kernels.emit_compact.emit_gather_buffer`, live
  cells only, two syncs) when the last fire was sparse enough, else the
  dense branch,
  :func:`~arroyo_tpu_torch.kernels.pane_emit` — the JAX package's choice,
  fire for fire.  A fire's geometry is a few scalars (first bin, live
  range, W, k); the ring and dense branches pass them to their kernels,
  the other branches take ring arrays built from them by
  ``fire_geometry``;
* a derived window of a factor-window rewrite runs the ring in
  merge-input mode (``set_merge_inputs``): its rows are fired factor
  panes, each channel reads its partial column and the row mass rides
  the cell reduction as a summed channel; a factor ring (W == 1) drains
  its un-fired cells at a checkpoint barrier (``drain_deltas``: the dense
  read, then ``bin_evict`` over the drained span) without moving the
  fire bookkeeping;
* eviction resets expired ring columns of the occupied slots on the
  device through :func:`~arroyo_tpu_torch.kernels.bin_evict`.  Slots at
  and past ``next_slot`` are never written: every cell there holds its
  channel's identity and count 0 (``__init__``, ``_grow``, ``_grow_ring``
  and ``restore`` make them so, and updates only reach directory slots).

Snapshots use the canonical, topology-independent numpy format of the
JAX package, so a checkpoint taken by either package restores in the
other."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device, to_host
from ..graph.logical import AggKind, AggSpec
from ..kernels.argmax_fire import argmax_fire_buffer, argmax_views
from ..kernels.bin_evict import bin_evict
from ..kernels.bin_update import (bin_update, channel_identity,
                                  channel_plan, pack_cells)
from ..kernels.emit_compact import (compact_views, emit_count,
                                    emit_gather_buffer, pack_panes,
                                    panes_views)
from ..kernels.pane_emit import fire_geometry, pane_emit, pane_views
from ..kernels.ring_emit import ring_emit
from .. import native
from ..native import NativeDir, agg_cells, assign_bins

# f64 extremes: the accumulation channels are float64, so f32 extremes
# would clip MIN/MAX values beyond +/-3.4e38
NEG_INF = channel_identity("max")
POS_INF = channel_identity("min")

# every channel accumulates in f64: int64 SUM/COUNT stay exact to 2^53
ACC_DTYPE = np.float64

# the least candidate capacity of an argmax fire's buffer
ARGMAX_MIN_CAP = 1024


def _init_value(kind: AggKind) -> float:
    return channel_identity(kind.value)


def _bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A whole plane on ``device`` (ring relayout, restore): a plain copy,
    kept out of the pinned cache, which would hold up to its size."""
    # torch.tensor copies, so read-only numpy views are fine
    return torch.tensor(np.ascontiguousarray(arr), device=device)


def _upload(arr: np.ndarray, device: torch.device, what: str
            ) -> torch.Tensor:
    """A flush's or a fire's one upload, through ``device.to_device`` (on
    the card a non-blocking copy from pinned memory), counted as
    ``<what>_uploads``; one that holds the host — a plain copy to a CPU
    device — also as ``<what>_blocking_uploads``."""
    from ..obs import perf

    perf.count(f"{what}_uploads")
    if device.type != "cuda":
        perf.count(f"{what}_blocking_uploads")
    return to_device(arr, device)


def restored_count_state(raw_counts: np.ndarray, promote_at: int
                         ) -> Tuple[int, np.dtype]:
    """(total restored rows, counts-plane dtype) for a snapshot restore:
    restored mass at or beyond the promotion threshold restores straight
    into i64."""
    total = int(raw_counts.sum())
    return total, (np.int64 if total >= promote_at else np.int32)


# -- channel + directory semantics (shared with the JAX package) ---------------


def build_channels(aggs: Tuple[AggSpec, ...]
                   ) -> Tuple[Tuple[str, ...], Dict[int, int]]:
    """(kernel channel kinds, visible-agg -> hidden-validity-channel map):
    one channel per visible agg (AVG accumulates as a sum) plus a hidden
    additive validity-count channel per column-reading agg, so null (NaN)
    rows neither poison SUM/MIN/MAX nor inflate AVG's divisor."""
    ch_kinds: List[str] = []
    for a in aggs:
        ch_kinds.append("sum" if a.kind == AggKind.AVG else a.kind.value)
    valid_ch: Dict[int, int] = {}
    for i, a in enumerate(aggs):
        if a.column is not None and a.kind != AggKind.COUNT:
            valid_ch[i] = len(ch_kinds)
            ch_kinds.append("sum")
    return tuple(ch_kinds), valid_ch


def _coerce_float(col: np.ndarray) -> np.ndarray:
    """Numeric column -> f64 with None/non-numeric as NaN (SQL NULL)."""
    arr = np.asarray(col)
    if arr.dtype != object:
        return arr.astype(ACC_DTYPE)
    out = np.full(len(arr), np.nan, dtype=ACC_DTYPE)
    for i, v in enumerate(arr.tolist()):
        if v is not None and not isinstance(v, str):
            out[i] = float(v)
    return out


def channel_input(aggs: Tuple[AggSpec, ...], ch_kinds: Tuple[str, ...],
                  valid_of: Dict[int, int], j: int,
                  agg_inputs: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """Per-row contribution of channel ``j`` with nulls (NaN) masked to the
    channel's identity so they are skipped, not aggregated."""
    src = valid_of.get(j)
    if src is not None:  # hidden validity count for agg `src`
        raw = _coerce_float(agg_inputs[aggs[src].column])
        return (~np.isnan(raw)).astype(ACC_DTYPE)
    a = aggs[j]
    if a.column is None:
        return np.ones(n, dtype=ACC_DTYPE)
    raw = _coerce_float(agg_inputs[a.column])
    ok = ~np.isnan(raw)
    if a.kind == AggKind.COUNT:  # COUNT(col) counts non-null rows
        return ok.astype(ACC_DTYPE)
    ident = _init_value(AggKind(ch_kinds[j]))
    return np.where(ok, raw, ACC_DTYPE(ident)).astype(ACC_DTYPE)


def channel_inits(ch_kinds: Tuple[str, ...]) -> np.ndarray:
    """Per-channel aggregation identities, carried inside canonical
    snapshots so merges pad uncovered bins with the right identity."""
    return np.array([_init_value(AggKind(k)) for k in ch_kinds],
                    dtype=ACC_DTYPE)


def _reduce_runs(vals: np.ndarray, starts: np.ndarray,
                 ch_kinds: Tuple[str, ...]) -> np.ndarray:
    out = np.empty((len(ch_kinds), len(starts)), dtype=ACC_DTYPE)
    for j, kind in enumerate(ch_kinds):
        if kind == "min":
            out[j] = np.minimum.reduceat(vals[j], starts)
        elif kind == "max":
            out[j] = np.maximum.reduceat(vals[j], starts)
        else:  # sum / count channels are additive
            out[j] = np.add.reduceat(vals[j], starts)
    return out


def preaggregate(kh: np.ndarray, bins: np.ndarray,
                 ch_kinds: Tuple[str, ...], vals: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Two-phase aggregation, local half: reduce rows with the same
    (key, bin) on the host before the device update.  Returns (unique
    keys, bins, per-cell row counts, reduced channel values [n_ch, m])."""
    order = np.lexsort((bins, kh))
    kh_s, bin_s = kh[order], bins[order]
    is_first = np.ones(len(kh_s), dtype=bool)
    is_first[1:] = (kh_s[1:] != kh_s[:-1]) | (bin_s[1:] != bin_s[:-1])
    starts = is_first.nonzero()[0]
    out = _reduce_runs(vals[:, order], starts, ch_kinds)
    rowcnt = np.diff(np.append(starts, len(kh_s))).astype(ACC_DTYPE)
    return kh_s[starts], bin_s[starts], rowcnt, out


# buffered cells above which updates flush even without a reader
# (bounds host memory and the size of one update launch)
FLUSH_CELLS = 65536


def _merge_cells(slots: np.ndarray, bins: np.ndarray, rowcnt: np.ndarray,
                 vals: np.ndarray, ch_kinds: Tuple[str, ...]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Reduce duplicate (slot, bin) cells across buffered batch runs."""
    order = np.lexsort((bins, slots))
    s, b = slots[order], bins[order]
    is_first = np.ones(len(s), dtype=bool)
    is_first[1:] = (s[1:] != s[:-1]) | (b[1:] != b[:-1])
    starts = is_first.nonzero()[0]
    if len(starts) == len(s):
        return slots, bins, rowcnt, vals  # already unique
    out = _reduce_runs(vals[:, order], starts, ch_kinds)
    rc = np.add.reduceat(rowcnt[order], starts)
    return s[starts], b[starts], rc, out


def directory_insert(state, kh: np.ndarray, ensure_capacity) -> np.ndarray:
    """Vectorized key-hash -> slot lookup over the host directory
    (``key_sorted``, ``slot_of_sorted``, ``next_slot``, ``slot_to_key``),
    inserting unknown keys with sequential slots.
    ``ensure_capacity(total_slots, new_keys)`` is the growth hook.

    With the host library the state carries a hash directory
    (``state._ndir``): the lookup is one linear-probe pass and new keys
    get slots in first-seen order, as in the JAX package; the sorted
    arrays, which checkpoints and emission read, are kept from the new
    keys alone.  Without it new keys get slots in ascending hash order,
    and the directory is searched with the batch's sorted distinct keys
    (a search with sorted needles walks the directory once; one with the
    batch's own order misses the cache on every key of a large one)."""
    ndir = getattr(state, "_ndir", None)
    if ndir is not None:
        slots, new_keys = ndir.insert(kh, state.next_slot)
        _append_new_keys(state, new_keys, ensure_capacity)
        return slots
    uniq, inv = np.unique(kh, return_inverse=True)
    pos = np.searchsorted(state.key_sorted, uniq)
    if len(state.key_sorted):
        pos_c = np.minimum(pos, len(state.key_sorted) - 1)
        new_keys = uniq[state.key_sorted[pos_c] != uniq]
    else:
        new_keys = uniq
    if len(new_keys):
        _append_new_keys(state, new_keys, ensure_capacity)
        pos = np.searchsorted(state.key_sorted, uniq)
    return state.slot_of_sorted[pos][inv.reshape(-1)]


def _append_new_keys(state, new_keys: np.ndarray, ensure_capacity) -> None:
    """Register absent, distinct keys: sequential slots from
    ``next_slot`` in the order given, ``slot_to_key``, and a sorted
    insert into ``key_sorted`` / ``slot_of_sorted`` (one linear pass: a
    re-sort of the whole directory a batch dominates once it holds
    millions).  Shared by both directory paths, so the checkpointed
    arrays are built the same way."""
    n_new = len(new_keys)
    if not n_new:
        return
    ensure_capacity(state.next_slot + n_new, new_keys)
    new_slots = np.arange(state.next_slot, state.next_slot + n_new)
    state.slot_to_key[new_slots] = new_keys
    state.next_slot += n_new
    order = np.argsort(new_keys, kind="stable")
    keys_s = new_keys[order]
    at = np.searchsorted(state.key_sorted, keys_s)
    state.key_sorted = np.insert(state.key_sorted, at, keys_s)
    state.slot_of_sorted = np.insert(state.slot_of_sorted, at,
                                     new_slots[order])


class KeyedBinState:
    """Keyed bin-ring aggregation state for one subtask, on one device."""

    # rows after which the i32 counts plane could wrap (class attr so
    # tests can exercise the promotion without 2^31 rows)
    _i32_promote = 2**31 - 1

    def __init__(self, aggs: Tuple[AggSpec, ...], slide_micros: int,
                 width_micros: int, capacity: int = 0,
                 device: DeviceLike = None):
        if capacity <= 0:
            from ..config import config

            capacity = config().state_capacity
        if width_micros % slide_micros:
            raise ValueError("window width must be a multiple of slide")
        self.device = resolve_device(device)
        self.aggs = aggs
        self._ch_kinds, self._valid_ch = build_channels(aggs)
        self._valid_of = {v: k for k, v in self._valid_ch.items()}
        # COUNT(*) channels accumulate exactly the per-cell row count:
        # their values never ride a transfer — the update kernel rebuilds
        # them from the rowcount, emission reads them from the counts plane
        self._dup_ch = tuple(i for i, a in enumerate(aggs)
                             if a.kind == AggKind.COUNT and a.column is None)
        dup_set = frozenset(self._dup_ch)
        self._xfer_ch = tuple(j for j in range(len(self._ch_kinds))
                              if j not in dup_set)
        self._xfer_pos = {j: r for r, j in enumerate(self._xfer_ch)}
        # the channel plan of the update kernel and of the compact fire's
        # gather (restore keeps the aggregates)
        self._plan = channel_plan(self._ch_kinds, self._dup_ch)
        self.slide = slide_micros
        self.W = width_micros // slide_micros  # bins per window
        # ring holds W bins for the window plus out-of-order headroom
        self.B = _bucket(2 * self.W + 4, floor=8)
        self.C = _bucket(capacity)

        self.key_sorted = np.zeros(0, dtype=np.uint64)
        self.slot_of_sorted = np.zeros(0, dtype=np.int64)
        self.next_slot = 0
        self.slot_to_key = np.zeros(self.C, dtype=np.uint64)
        # the host library's hash directory (None without it): slots in
        # first-seen order
        self._ndir = NativeDir.create(self.C)

        self.values = self._identity_planes(self.C, self.B)
        self.counts = torch.zeros((self.C, self.B), dtype=torch.int32,
                                  device=self.device)

        self.min_bin: Optional[int] = None  # oldest retained absolute bin
        self.max_bin: Optional[int] = None
        self.last_fired_pane: Optional[int] = None
        # rows ever accumulated into the counts plane: any cell or pane
        # sum is bounded by it, so once it could cross 2^31 the plane is
        # promoted to i64 before the rows land
        self.total_rows = 0
        self._argmax_local: Optional[str] = None  # 'max' | 'min'
        # candidates the argmax fire's buffer holds: max(1,024, twice the
        # last fire's total); a fire past it launches again at its total
        self._argmax_cap = ARGMAX_MIN_CAP
        # live cells over (keys x panes) of the last fire: picks the
        # compact or the dense branch of the next one
        self._fire_density: Optional[float] = None
        # update coalescing: pre-aggregated cell runs buffer here and
        # flush in one update launch when a reader needs the planes
        self._pending: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]] = []
        self._pending_cells = 0
        # merge-input mode (derived windows, graph/factor_windows.py):
        # channel j reads an already-aggregated per-pane partial column,
        # and the counts plane accumulates the per-pane row-mass column,
        # so the ring equals the one the unfactored member would build
        # from the same rows
        self._merge_cols: Optional[Dict[int, str]] = None
        self._rows_col: Optional[str] = None

    def _identity_planes(self, C: int, B: int) -> torch.Tensor:
        inits = torch.tensor(channel_inits(self._ch_kinds),
                             dtype=torch.float64, device=self.device)
        return inits[:, None, None].expand(len(self._ch_kinds), C,
                                           B).contiguous()

    # -- key directory -------------------------------------------------------

    def _lookup_or_insert(self, kh: np.ndarray) -> np.ndarray:
        """Vectorized key hash -> slot id, inserting unknown keys."""
        def ensure(total, _new_keys):
            if total > self.C:
                self._grow(total)

        return directory_insert(self, kh, ensure)

    def _grow(self, needed: int) -> None:
        newC = self.C
        while newC < needed:
            newC <<= 1
        pad = newC - self.C
        self.values = torch.cat(
            [self.values, self._identity_planes(pad, self.B)], dim=1)
        self.counts = torch.cat(
            [self.counts, torch.zeros((pad, self.B), dtype=self.counts.dtype,
                                      device=self.device)], dim=0)
        self.slot_to_key = np.concatenate(
            [self.slot_to_key, np.zeros(pad, dtype=np.uint64)])
        self.C = newC

    # -- update --------------------------------------------------------------

    def set_merge_inputs(self, channel_cols: Dict[int, str],
                         rows_col: str) -> None:
        """Arm merge-input mode before any row lands: channel ``j`` reads
        ``channel_cols[j]``, a per-(key, pane) partial of its own kind
        (NaN: the pane had no contributing row, masked to the channel's
        identity), and the per-cell row count accumulates ``rows_col``,
        so COUNT(*) channels count rows, not pane arrivals."""
        if self.next_slot or self.total_rows:
            raise ValueError("merge inputs must be set before any key is "
                             "admitted")
        missing = [j for j in self._xfer_ch if j not in channel_cols]
        if missing:
            raise ValueError(f"no merge column for channels {missing}")
        self._merge_cols = dict(channel_cols)
        self._rows_col = rows_col

    def update(self, key_hash: np.ndarray, timestamps: np.ndarray,
               agg_inputs: Dict[str, np.ndarray]) -> None:
        n = len(key_hash)
        if n == 0:
            return
        from ..obs import perf

        # rows entering pane-update state: ~K a source event unfactored
        # (every private ring sees every event), ~1 + O(panes) factored
        # (derived rings see fired pane cells only)
        perf.count("pane_update_rows", n)
        if self._merge_cols is not None:
            self._update_merged(key_hash, timestamps, agg_inputs)
            return
        admitted = self._admit_bins(timestamps)
        if admitted is None:
            return
        bins_mod, live, n_live, lo, hi = admitted
        self._note_mass(int(n_live))

        slots = self._lookup_or_insert(key_hash)
        # only non-COUNT(*) channels are materialized and shipped; the
        # kernel rebuilds COUNT(*) channels from the rowcount
        xfer_kinds = tuple(self._ch_kinds[j] for j in self._xfer_ch)
        vals = np.empty((len(self._xfer_ch), n), dtype=ACC_DTYPE)
        for r, j in enumerate(self._xfer_ch):
            vals[r] = channel_input(self.aggs, self._ch_kinds,
                                    self._valid_of, j, agg_inputs, n)
        if self._ndir is not None:
            # one hash pass in the library, the liveness filter folded in
            cells = agg_cells(slots, bins_mod, None if live.all() else live,
                              self.B, vals, xfer_kinds)
        else:
            if not live.all():
                idx = live.nonzero()[0]
                slots, bins_mod, vals = \
                    slots[idx], bins_mod[idx], vals[:, idx]
            cells = preaggregate(slots, bins_mod, xfer_kinds, vals)
        self._enqueue_cells(*cells)

    def _update_merged(self, key_hash: np.ndarray, timestamps: np.ndarray,
                       agg_inputs: Dict[str, np.ndarray]) -> None:
        """Merge-input update (derived windows): one row a fired factor
        (key, pane); the channel values come straight from the mapped
        partial columns (their kinds reduce partial into partial without
        loss) and a cell's row count is the SUM of the pane row-mass
        column, so the ring is the one the unfactored member would hold
        after the same raw rows."""
        n = len(key_hash)
        admitted = self._admit_bins(timestamps)
        if admitted is None:
            return
        bins_mod, live, _n_live, _lo, _hi = admitted
        w = _coerce_float(agg_inputs[self._rows_col])
        w = np.where(np.isnan(w), 0.0, w)
        self._note_mass(int(np.ceil(w[live].sum())))

        slots = self._lookup_or_insert(key_hash)
        xfer_kinds = tuple(self._ch_kinds[j] for j in self._xfer_ch)
        vals = np.empty((len(self._xfer_ch), n), dtype=ACC_DTYPE)
        for r, j in enumerate(self._xfer_ch):
            raw = _coerce_float(agg_inputs[self._merge_cols[j]])
            ident = ACC_DTYPE(_init_value(AggKind(self._ch_kinds[j])))
            vals[r] = np.where(np.isnan(raw), ident, raw)
        if not live.all():
            idx = live.nonzero()[0]
            slots, bins_mod = slots[idx], bins_mod[idx]
            vals, w = vals[:, idx], w[idx]
        # the row mass rides the cell reduction as one more additive
        # channel, so duplicate (slot, bin) cells sum their masses:
        # preaggregate's own row count would count pane arrivals
        slots_c, bins_c, _arrivals, red = preaggregate(
            slots, bins_mod, xfer_kinds + ("sum",),
            np.concatenate([vals, w[None]]))
        self._enqueue_cells(slots_c, bins_c, red[-1], red[:-1])

    def _admit_bins(self, timestamps: np.ndarray
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, int,
                                        int, int]]:
        """A row in bin b feeds panes b..b+W-1 and is late (dropped) only
        when all those panes already fired.  Returns (bins_mod, live,
        n_live, lo, hi), or None when nothing is live."""
        threshold = (self.last_fired_pane - self.W + 2
                     if self.last_fired_pane is not None else None)
        bins_mod, live, n_live, lo, hi = assign_bins(
            timestamps, self.slide, self.B, threshold)
        if n_live == 0:
            return None
        lo_new = lo if self.min_bin is None else min(self.min_bin, lo)
        hi_new = hi if self.max_bin is None else max(self.max_bin, hi)
        # grow BEFORE extending min/max: _grow_ring copies the span
        # [min_bin, max_bin] the old ring actually holds
        if hi_new - lo_new >= self.B:
            self._grow_ring(hi_new - lo_new + 1)
            bins_mod = ((timestamps // self.slide) % self.B).astype(np.int32)
        self.min_bin = lo_new
        self.max_bin = hi_new
        return bins_mod, live, n_live, lo, hi

    def _note_mass(self, mass: int) -> None:
        """Promote the counts plane to i64 before accumulated mass could
        wrap an i32 cell or pane sum."""
        self.total_rows += mass
        if (self.total_rows >= self._i32_promote
                and self.counts.dtype == torch.int32):
            self.counts = self.counts.to(torch.int64)

    def _enqueue_cells(self, slots_c: np.ndarray, bins_c: np.ndarray,
                       rowcnt: np.ndarray, vals_c: np.ndarray) -> None:
        """Buffer the pre-aggregated cell run (update coalescing: the
        planes are only read at pane fires, snapshots and ring relayouts,
        and every reader flushes first)."""
        self._pending.append((slots_c, bins_c, rowcnt, vals_c))
        self._pending_cells += len(slots_c)
        if self._pending_cells >= FLUSH_CELLS:
            self.flush_updates()

    def flush_updates(self) -> None:
        """Apply every buffered cell run to the device planes in ONE
        update launch."""
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        self._pending_cells = 0
        if len(pend) == 1:
            cells = pend[0]
        else:
            xfer_kinds = tuple(self._ch_kinds[j] for j in self._xfer_ch)
            cells = _merge_cells(
                np.concatenate([p[0] for p in pend]),
                np.concatenate([p[1] for p in pend]),
                np.concatenate([p[2] for p in pend]),
                np.concatenate([p[3] for p in pend], axis=1), xfer_kinds)
        self._dispatch_cells(*cells)

    def _dispatch_cells(self, slots_c: np.ndarray, bins_c: np.ndarray,
                        rowcnt: np.ndarray, vals_c: np.ndarray) -> None:
        from ..obs import perf

        perf.count("pane_update_dispatches")
        # one host->device copy a flush: indices and values in one buffer
        cells = _upload(pack_cells(slots_c, bins_c, rowcnt, vals_c),
                        self.device, "bin_flush")
        perf.timed_device(bin_update, self.values, self.counts, cells,
                          self._plan)

    def _grow_ring(self, needed: int) -> None:
        """Rare: data spans more bins than the ring; re-layout host-side."""
        # buffered cells carry ring indices mod the OLD B
        self.flush_updates()
        newB = self.B
        while newB < needed:
            newB <<= 1
        vals = self.values.cpu().numpy()
        cnts = self.counts.cpu().numpy()
        new_vals = np.empty((len(self._ch_kinds), self.C, newB),
                            dtype=ACC_DTYPE)
        new_vals[:] = channel_inits(self._ch_kinds)[:, None, None]
        new_cnts = np.zeros((self.C, newB), dtype=cnts.dtype)
        if self.min_bin is not None and self.max_bin is not None:
            for ab in range(self.min_bin, self.max_bin + 1):
                new_vals[:, :, ab % newB] = vals[:, :, ab % self.B]
                new_cnts[:, ab % newB] = cnts[:, ab % self.B]
        self.values = _to_device(new_vals, self.device)
        self.counts = _to_device(new_cnts, self.device)
        self.B = newB

    # -- pane emission --------------------------------------------------------

    def _use_ring(self) -> bool:
        """The ring branch of a fire, as the JAX package chooses it:
        ``ARROYO_RING=on`` always, ``off`` never, ``auto`` (the default)
        for windows of at least ``ARROYO_RING_MIN_W`` bins (64) when there
        is more than one device of the state's kind.  It sweeps each row's
        bin span once instead of folding W bins a pane."""
        mode = os.environ.get("ARROYO_RING", "auto")
        if mode == "off":
            return False
        if mode == "on":
            return True
        w_min = int(os.environ.get("ARROYO_RING_MIN_W", 64))
        n_dev = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        return self.W >= w_min and n_dev > 1

    def _emit_ring(self, first_bin: int, lo: int, hi: int, k: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """The ring branch's read: one device call sweeps the occupied
        rows' span of every transferred channel and of the counts plane
        (trailing-W cumsum differences, van Herk's extrema) into one
        buffer, read back in one copy; (outs f64[n_xfer, rows, k], cnts
        [rows, k] in the plane's dtype)."""
        from ..obs import perf

        perf.count("bin_ring_fires")
        rows = self.next_slot
        buf = perf.timed_device(
            ring_emit, self.values, self.counts, first_bin, lo, hi, self.W,
            k, self._ch_kinds, self._xfer_ch, rows)
        outs, cnts = pane_views(torch.from_numpy(to_host(buf)),
                                len(self._xfer_ch), rows, k,
                                self.counts.dtype)
        return outs.numpy(), cnts.numpy()

    def set_argmax_local(self, agg_out: str, minmax: str) -> None:
        """Enable candidate-only emission for the given COUNT(*) agg (the
        value IS the counts plane)."""
        target = next((i for i, a in enumerate(self.aggs)
                       if a.output == agg_out), None)
        if target is None or target not in self._dup_ch:
            raise ValueError(f"argmax_local target {agg_out!r} is not a bare "
                             "COUNT(*) aggregate of this state")
        if minmax not in ("max", "min"):
            raise ValueError(minmax)
        self._argmax_local = minmax

    def _emit_argmax(self, ring: np.ndarray, bin_ok: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """Candidate-only emission: (key_idx, pane_idx, counts, empty
        channel block) for cells at their pane's count extremum, over the
        occupied slots.  The panes go up in one pinned upload, the kernel
        writes the total and up to ``_argmax_cap`` candidates into one
        buffer, read back once; a total past the capacity launches once
        more at its size (``bin_argmax_fire_overflows``)."""
        from ..obs import perf

        ring_t, ok_t = panes_views(
            _upload(pack_panes(ring, bin_ok), self.device, "bin_argmax_fire"),
            *ring.shape)
        cap = self._argmax_cap
        while True:
            buf = perf.timed_device(argmax_fire_buffer, self.counts, ring_t,
                                    ok_t, self.next_slot,
                                    self._argmax_local, cap)
            host = to_host(buf)
            perf.count("bin_argmax_fire_readbacks")
            total = int(host[0])
            if total <= cap:
                break
            perf.count("bin_argmax_fire_overflows")
            cap = total
        self._argmax_cap = max(ARGMAX_MIN_CAP, 2 * total)
        key, pane, cnt = argmax_views(host, total, cap, self.counts.dtype)
        return (key.astype(np.int64), pane.astype(np.int64),
                cnt.astype(np.int64), np.zeros((len(self._xfer_ch), total)))

    def fire_panes(self, watermark: int, final: bool = False
                   ) -> Optional[Tuple[np.ndarray, Dict[str, np.ndarray],
                                       np.ndarray, np.ndarray]]:
        """Emit all panes whose window end <= watermark.

        Pane with absolute end-bin e covers bins (e-W, e]; its window end
        time is (e+1)*slide.  Returns (keys, {agg_output: values},
        window_end, counts) flattened over (pane, key-with-data), or None.
        """
        if self.max_bin is None or self.next_slot == 0:
            return None
        if final:
            # the last data bin feeds panes up to max_bin + W - 1
            last_pane = self.max_bin + self.W - 1
        else:
            last_pane = min(int(watermark // self.slide) - 1, self.max_bin)
        first_pane = (self.last_fired_pane + 1
                      if self.last_fired_pane is not None
                      else (self.min_bin or 0))
        if last_pane < first_pane:
            return None
        self.flush_updates()
        pane_ends = np.arange(first_pane, last_pane + 1, dtype=np.int64)
        k = len(pane_ends)
        # the fire's geometry: pane p's bin w is the absolute bin
        # first_bin + p + w; only bins in [min_bin, max_bin] are live
        first_bin = int(first_pane) - (self.W - 1)
        lo = int(self.min_bin) if self.min_bin is not None else 0
        hi = int(self.max_bin)

        if self._use_ring():
            outs, cnts = self._emit_ring(first_bin, lo, hi, k)
            key_idx, pane_idx, cnt_sel, ch_sel = self._flatten_dense(
                outs, cnts, k)
        elif self._argmax_local is not None and not self._xfer_ch:
            # every output column derives from the counts plane
            key_idx, pane_idx, cnt_sel, ch_sel = self._emit_argmax(
                *fire_geometry(first_bin, lo, hi, self.W, k, self.B,
                               kpad=_bucket(k, floor=1)))
        elif self._use_compact_emit(self._c_slice(), k):
            key_idx, pane_idx, cnt_sel, ch_sel = self._emit_compact(
                *fire_geometry(first_bin, lo, hi, self.W, k, self.B))
        else:
            outs, cnts = self._read_dense(first_bin, lo, hi, k)
            key_idx, pane_idx, cnt_sel, ch_sel = self._flatten_dense(
                outs, cnts, k)

        self.last_fired_pane = last_pane
        # evict bins no future pane needs: abs bins <= last_pane - W + 1
        new_min = last_pane - self.W + 2
        if self.min_bin is not None and new_min > self.min_bin:
            n_expired = min(new_min, self.max_bin + 1) - self.min_bin
            if n_expired > 0:
                self._evict(int(self.min_bin), int(n_expired))
            self.min_bin = new_min

        self._fire_density = len(key_idx) / max(self.next_slot * k, 1)
        if len(key_idx) == 0:
            return None
        keys = self.slot_to_key[key_idx]
        window_end = (pane_ends[pane_idx] + 1) * self.slide
        return keys, self._out_cols(cnt_sel, ch_sel), window_end, cnt_sel

    def _use_compact_emit(self, c_slice: int, k: int) -> bool:
        """Compact emission (an extra scalar readback, then only live
        cells) when the last fire's density predicts fewer bytes than the
        dense read of ``c_slice`` slots; ``ARROYO_EMIT_COMPACT`` =
        ``on``/``off`` forces a branch, ``auto`` (the default) predicts,
        with the JAX package's byte model and margin."""
        mode = os.environ.get("ARROYO_EMIT_COMPACT", "auto")
        if mode == "off":
            return False
        if mode == "on":
            return True
        if self._fire_density is None:
            return False  # no evidence yet: dense is the safe default
        itemsize = self.counts.element_size()
        row_bytes = 8 + itemsize + 8 * len(self._xfer_ch)  # idx2+cnt+chans
        compact_bytes = self._fire_density * self.next_slot * k * row_bytes
        dense_bytes = (8 * len(self._xfer_ch) + itemsize) * c_slice * k
        # the margin stands in for the extra readback and gather pass
        margin = int(os.environ.get("ARROYO_EMIT_COMPACT_MARGIN",
                                    256 * 1024))
        return compact_bytes + margin < dense_bytes

    def _emit_compact(self, ring: np.ndarray, bin_ok: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
        """(key_idx, pane_idx, counts, channel values [n_xfer, m]) for the
        live cells of the occupied slots only, compacted on the device in
        row-major order (the dense branch's np.nonzero order).  Two syncs:
        the live total, then the one readback of the gather's buffer
        (``bin_compact_fire_readbacks``); the panes go up in one pinned
        upload."""
        from ..obs import perf

        ring_t, ok_t = panes_views(
            _upload(pack_panes(ring, bin_ok), self.device, "bin_compact_fire"),
            *ring.shape)
        cnt, offsets = perf.timed_device(emit_count, self.counts, ring_t,
                                         ok_t, self.next_slot)
        nnz = int(offsets[-1].item())  # the live total, as in JAX
        if nnz == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int64),
                    np.zeros((len(self._xfer_ch), 0)))
        buf = perf.timed_device(emit_gather_buffer, self.values, cnt, ring_t,
                                ok_t, self._plan, offsets, nnz)
        # one readback, pinned: a fire's rows run to tens of megabytes
        host = to_host(buf)
        perf.count("bin_compact_fire_readbacks")
        # i32 views of the one host copy: fire_panes only indexes with them
        return compact_views(host, nnz, len(self._xfer_ch),
                             self.counts.dtype)

    def _evict(self, first_bin: int, n_bins: int) -> None:
        """Reset the ring columns of the expired absolute bins first_bin
        .. first_bin + n_bins - 1 to each channel's identity and zero their
        counts, in place, in one device call over the occupied slots."""
        from ..obs import perf

        perf.timed_device(bin_evict, self.values, self.counts, first_bin,
                          n_bins, self.next_slot, self._ch_kinds)

    def _c_slice(self) -> int:
        """Occupied-key rows read back by a dense fire."""
        if self.next_slot <= 2048:
            return min(_bucket(max(self.next_slot, 1), floor=256), self.C)
        return min(-(-self.next_slot // 2048) * 2048, self.C)

    def _read_dense(self, first_bin: int, lo: int, hi: int, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense pane read: one device call computes the occupied keys'
        counts and transferred channels for the real panes into one
        buffer, which is read back in one copy."""
        from ..obs import perf

        c_slice = self._c_slice()
        buf = perf.timed_device(
            pane_emit, self.values, self.counts, first_bin, lo, hi,
            self.W, k, self._ch_kinds, self._xfer_ch, c_slice)
        outs, cnts = pane_views(buf.cpu(), len(self._xfer_ch), c_slice, k,
                                self.counts.dtype)
        return outs.numpy(), cnts.numpy()

    def _flatten_dense(self, outs: np.ndarray, cnts: np.ndarray, k: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
        """(key_idx, pane_idx, counts, channel values) for the live cells
        of a dense read, in row-major order."""
        cnts_u = cnts[:self.next_slot, :k]
        key_idx, pane_idx = np.nonzero(cnts_u)
        cnt_sel = cnts_u[key_idx, pane_idx]
        ch_sel = outs[:, :self.next_slot, :k][:, key_idx, pane_idx]
        return key_idx, pane_idx, cnt_sel, ch_sel

    def _out_cols(self, cnt_sel: np.ndarray, ch_sel: np.ndarray
                  ) -> Dict[str, np.ndarray]:
        """Visible aggregate columns from flattened fired cells."""
        out_cols: Dict[str, np.ndarray] = {}
        dup_set = frozenset(self._dup_ch)
        for i, a in enumerate(self.aggs):
            if i in dup_set:
                # COUNT(*): the counts plane IS the aggregate
                out_cols[a.output] = cnt_sel.astype(np.int64)
                continue
            col = ch_sel[self._xfer_pos[i]]
            if a.kind == AggKind.COUNT:
                col = col.astype(np.int64)
            elif i in self._valid_ch:
                # nulls-skipping: AVG divides by non-null rows; an
                # all-null pane is NULL
                nv = ch_sel[self._xfer_pos[self._valid_ch[i]]]
                if a.kind == AggKind.AVG:
                    col = col / np.maximum(nv, 1)
                col = np.where(nv > 0, col, np.nan)
            out_cols[a.output] = col
        return out_cols

    def drain_deltas(self) -> Optional[Tuple[np.ndarray,
                                             Dict[str, np.ndarray],
                                             np.ndarray, np.ndarray]]:
        """Checkpoint-barrier drain of a factor pane ring (W == 1): read
        every un-fired (key, bin) cell as a pane delta and reset those
        cells to their identities, without moving ``last_fired_pane``,
        ``min_bin`` or the fire branch's density, so rows arriving after
        the drain accumulate in the same bins again and ship as a later
        delta.  Derived rings merge deltas without loss, so the factor's
        snapshot holds no un-shipped mass and a factored checkpoint
        restores into an unfactored plan.  The read is the dense one (the
        JAX package's choice); the reset is ``bin_evict`` over the drained
        span, which the later fire's eviction resets again (idempotent).
        Same return shape as ``fire_panes``; None when nothing is
        pending."""
        if self.W != 1:
            raise ValueError("drain_deltas is the factor-pane path (W == 1)")
        if self.max_bin is None or self.next_slot == 0:
            return None
        self.flush_updates()
        first_pane = (self.last_fired_pane + 1
                      if self.last_fired_pane is not None
                      else (self.min_bin or 0))
        last_pane = self.max_bin
        if last_pane < first_pane:
            return None
        pane_ends = np.arange(first_pane, last_pane + 1, dtype=np.int64)
        k = len(pane_ends)
        lo = int(self.min_bin) if self.min_bin is not None else 0
        hi = int(self.max_bin)
        # W == 1: pane p is the absolute bin first_pane + p
        outs, cnts = self._read_dense(int(first_pane), lo, hi, k)
        # reset the drained bins (the live ones: [max(first, lo), hi]);
        # the fire bookkeeping stays where it is
        start = max(int(first_pane), lo)
        if hi >= start:
            self._evict(start, hi - start + 1)
        key_idx, pane_idx, cnt_sel, ch_sel = self._flatten_dense(
            outs, cnts, k)
        if len(key_idx) == 0:
            return None
        keys = self.slot_to_key[key_idx]
        window_end = (pane_ends[pane_idx] + 1) * self.slide
        return keys, self._out_cols(cnt_sel, ch_sel), window_end, cnt_sel

    # -- checkpoint ------------------------------------------------------------
    #
    # Canonical topology-independent format shared with the JAX package:
    # compact per-key LINEAR bin columns (column j = absolute bin lo+j)
    # plus the host key directory.

    def device_bytes(self) -> int:
        """Resident bytes of the bin planes, read off the tensor handles
        (no transfer): the device-memory ledger's pane entry
        (obs/latency.py ``device_state_tables``)."""
        return (self.values.numel() * self.values.element_size()
                + self.counts.numel() * self.counts.element_size())

    def snapshot(self) -> Dict[str, np.ndarray]:
        self.flush_updates()  # buffered cells belong to this epoch
        n = self.next_slot
        if self.min_bin is not None and self.max_bin is not None:
            lo = self.min_bin
            cols = (np.arange(lo, self.max_bin + 1) % self.B)
        else:
            lo = -1
            cols = np.zeros(0, dtype=np.int64)
        # the occupied rows' live columns are gathered where the planes
        # live, so only they cross to the host (a barrier copies the
        # snapshot of every ring of a job)
        cols_t = torch.from_numpy(cols).to(self.device)
        return {
            "bin_keys": self.slot_to_key[:n].copy(),
            "bin_vals": self.values[:, :n].index_select(2, cols_t).cpu()
            .numpy(),
            "bin_counts": self.counts[:n].index_select(1, cols_t).cpu()
            .numpy(),
            "ch_init": channel_inits(self._ch_kinds),
            "mesh_shards": np.array([1], dtype=np.int64),
            "key_sorted": self.key_sorted.copy(),
            "slot_of_sorted": self.slot_of_sorted.copy(),
            "slot_to_key": self.slot_to_key[:n].copy(),
            "meta": np.array([
                n, lo,  # lo == min_bin: first linear column's absolute bin
                -1 if self.max_bin is None else self.max_bin,
                -1 if self.last_fired_pane is None else self.last_fired_pane,
            ], dtype=np.int64),
        }

    def restore(self, arrays: Dict[str, np.ndarray]) -> None:
        self._pending = []  # buffered updates from a pre-restore life
        self._pending_cells = 0
        meta = arrays["meta"]
        self.next_slot = int(meta[0])
        lo = int(meta[1])
        self.max_bin = None if meta[2] < 0 else int(meta[2])
        self.last_fired_pane = None if meta[3] < 0 else int(meta[3])
        self.min_bin = None if lo < 0 else lo
        self.key_sorted = np.asarray(arrays["key_sorted"]).astype(np.uint64)
        self.slot_of_sorted = np.asarray(
            arrays["slot_of_sorted"]).astype(np.int64)
        self._ndir = NativeDir.create(max(self.next_slot, 8))
        if self._ndir is not None:
            self._ndir.load(self.key_sorted, self.slot_of_sorted)
        self.C = _bucket(max(self.next_slot, 8))
        self.slot_to_key = np.zeros(self.C, dtype=np.uint64)
        self.slot_to_key[:self.next_slot] = np.asarray(
            arrays["slot_to_key"]).astype(np.uint64)[:self.next_slot]

        bin_keys = np.asarray(arrays["bin_keys"]).astype(np.uint64)
        bin_vals = np.asarray(arrays["bin_vals"], dtype=ACC_DTYPE)
        raw_counts = np.asarray(arrays["bin_counts"])
        self.total_rows, cnt_dtype = restored_count_state(
            raw_counts, self._i32_promote)
        span = bin_vals.shape[-1]
        self.B = _bucket(max(span, 2 * self.W + 4), floor=8)
        values = np.empty((len(self._ch_kinds), self.C, self.B), ACC_DTYPE)
        values[:] = channel_inits(self._ch_kinds)[:, None, None]
        counts = np.zeros((self.C, self.B), cnt_dtype)
        if len(bin_keys) and span and lo >= 0:
            # rows land at their DIRECTORY slot (a mesh snapshot may order
            # rows differently than this state's slots)
            idx = np.searchsorted(self.key_sorted, bin_keys)
            slots = self.slot_of_sorted[idx]
            cols = (np.arange(lo, lo + span) % self.B)
            values[:, slots[:, None], cols[None, :]] = bin_vals
            counts[slots[:, None], cols[None, :]] = raw_counts.astype(
                cnt_dtype)
        self.values = _to_device(values, self.device)
        self.counts = _to_device(counts, self.device)


def filter_canonical_snapshot(arrays: Dict[str, np.ndarray],
                              key_range: Tuple[int, int]
                              ) -> Dict[str, np.ndarray]:
    """Restrict a canonical bin-state snapshot (incl. the operator's kv_*
    key-column arrays) to the keys a subtask owns under its key range —
    restore-time re-partitioning on a rescale."""
    lo, hi = np.uint64(key_range[0]), np.uint64(key_range[1])
    slot_to_key = arrays["slot_to_key"].astype(np.uint64)
    n_old = len(slot_to_key)
    own_slot = (slot_to_key >= lo) & (slot_to_key <= hi)
    if own_slot.all():
        return arrays  # 1:1 restore: nothing to drop
    old_slots = own_slot.nonzero()[0]  # kept keys, old slot order
    kept_keys = slot_to_key[old_slots]

    out = dict(arrays)
    out["slot_to_key"] = kept_keys
    order = np.argsort(kept_keys, kind="stable")
    out["key_sorted"] = kept_keys[order]
    # new slots are positions in old-slot order
    out["slot_of_sorted"] = np.arange(len(kept_keys), dtype=np.int64)[order]

    bin_keys = arrays["bin_keys"].astype(np.uint64)
    own_row = (bin_keys >= lo) & (bin_keys <= hi)
    out["bin_keys"] = bin_keys[own_row]
    out["bin_vals"] = arrays["bin_vals"][:, own_row]
    out["bin_counts"] = arrays["bin_counts"][own_row]

    meta = arrays["meta"].copy()
    meta[0] = len(kept_keys)
    out["meta"] = meta

    # operator key-column values are indexed by OLD slot
    for name, arr in arrays.items():
        if name.startswith("kv_") and name != "kv_size":
            if len(arr) < n_old:
                raise ValueError(
                    f"canonical snapshot kv array {name!r} has {len(arr)} "
                    f"rows for {n_old} slots")
            out[name] = arr[old_slots]
    if "kv_size" in arrays:
        out["kv_size"] = np.array([len(kept_keys)])
    return out


def merge_canonical_snapshots(a: Dict[str, np.ndarray],
                              b: Dict[str, np.ndarray]
                              ) -> Dict[str, np.ndarray]:
    """Merge two canonical bin-state snapshots from parent subtasks with
    disjoint key ranges (restore-time re-partitioning)."""
    if not a:
        return b
    if not b:
        return a
    am, bm = a["meta"], b["meta"]
    if am[0] == 0:
        return b
    if bm[0] == 0:
        return a

    # unified linear-column span over absolute bins [lo, hi]
    spans = []
    for arrs, m in ((a, am), (b, bm)):
        spans.append((int(m[1]), arrs["bin_vals"].shape[-1]))
    los = [lo for lo, s in spans if lo >= 0]
    his = [lo + s - 1 for lo, s in spans if lo >= 0]
    lo_u = min(los) if los else -1
    hi_u = max(his) if his else -1
    width = (hi_u - lo_u + 1) if lo_u >= 0 else 0

    n_ch = a["bin_vals"].shape[0]
    # bins one parent never held pad with each channel's identity
    ch_init = None
    for arrs in (a, b):
        if "ch_init" in arrs:
            ch_init = np.asarray(arrs["ch_init"], dtype=ACC_DTYPE)
            break
    if ch_init is None or len(ch_init) != n_ch:
        ch_init = np.zeros(n_ch, dtype=ACC_DTYPE)
    parts_keys, parts_vals, parts_counts = [], [], []
    kv_parts: Dict[str, List[np.ndarray]] = {}
    slot_parts: List[np.ndarray] = []
    for arrs, (lo, span) in ((a, spans[0]), (b, spans[1])):
        keys = arrs["bin_keys"].astype(np.uint64)
        vals = np.asarray(arrs["bin_vals"], dtype=ACC_DTYPE)
        counts = np.asarray(arrs["bin_counts"])
        if width and len(keys):
            pv = np.broadcast_to(ch_init[:, None, None],
                                 (n_ch, len(keys), width)).copy()
            pc = np.zeros((len(keys), width), counts.dtype)
            if lo >= 0 and span:
                off = lo - lo_u
                pv[:, :, off:off + span] = vals
                pc[:, off:off + span] = counts
            vals, counts = pv, pc
        parts_keys.append(keys)
        parts_vals.append(vals)
        parts_counts.append(counts)
        slot_parts.append(arrs["slot_to_key"].astype(np.uint64))
        n_keys = int(arrs["meta"][0])
        for k, v in arrs.items():
            if k.startswith("kv_") and k != "kv_size":
                kv_parts.setdefault(k, []).append(
                    v[:n_keys] if len(v) >= n_keys else v)

    out: Dict[str, np.ndarray] = {}
    out["bin_keys"] = np.concatenate(parts_keys)
    out["bin_vals"] = (np.concatenate(parts_vals, axis=1) if width else
                       a["bin_vals"][:, :0])
    out["bin_counts"] = (np.concatenate(parts_counts, axis=0) if width else
                         a["bin_counts"][:0])
    slot_to_key = np.concatenate(slot_parts)
    out["slot_to_key"] = slot_to_key
    order = np.argsort(slot_to_key, kind="stable")
    out["key_sorted"] = slot_to_key[order]
    out["slot_of_sorted"] = np.arange(len(slot_to_key), dtype=np.int64)[order]
    for k, vs in kv_parts.items():
        out[k] = np.concatenate(vs) if len(vs) > 1 else vs[0]
    out["kv_size"] = np.array([len(slot_to_key)])
    out["ch_init"] = ch_init
    # panes fired under the SAME aligned barrier: parents agree; max is
    # the safe choice if they ever differ (never re-fire an emitted pane)
    out["meta"] = np.array([
        len(slot_to_key), lo_u,
        max(int(am[2]), int(bm[2])),
        max(int(am[3]), int(bm[3])),
    ], dtype=np.int64)
    return out
