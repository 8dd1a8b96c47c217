"""Mesh-sharded keyed bin aggregation — the port of
``arroyo_tpu.parallel.mesh_window``.

The same keyed bin state as :class:`~arroyo_tpu_torch.ops.keyed_bins.
KeyedBinState`, sharded by key range over a list of devices, one shard on
each entry (an entry may repeat: several logical shards on one card, or on
the CPU in the tests).  The JAX package runs the shards as one
``shard_map`` program over a ``("keys",)`` mesh; the port drives them from
one process, shard by shard, with the same state and the same steps:

1. **route**: the host pre-aggregates a batch's rows to (key, bin) cells
   and slices them over the shards (``nk`` slices of ``N`` cells); each
   slice's cells are bucketed by owner shard (the top ``log2(nk)`` key
   bits after ``route_shift``) by ``mesh_route`` on the slice's device, and
   the buckets are exchanged device to device (``parallel/shuffle.
   exchange``: ``nk**2`` copies, the ``all_to_all``);
2. **merge**: each shard sorts the keys routed to it (``join_sort``),
   merges them into its sorted u64 key table of ``C`` slots
   (``mesh_merge``), re-lays its old rows into the merged slots
   (``mesh_remap``) and scatters the cells (``bin_update``);
3. **fire**: panes over the shard's linear (base-relative) bin columns by
   ``pane_emit``; eviction rolls the columns left (``mesh_remap``), a
   factor ring's barrier drain resets a column span (``bin_evict``).

Zero loss is HOST-enforced, as in the JAX package: a bucket holds a
whole slice (the route-drop counter proves none is dropped), the host
directory counts each shard's keys exactly and doubles ``C`` before a
batch could overflow one (the key-drop counter proves it), and the host
widens the bin axis when data runs ahead of the watermark.

The planes are f64 (the JAX step's docstring says f32; its planes are
f64 under x64), counts i32 until the rows could wrap one, then i64.
Snapshots are the canonical topology-independent format, equal array for
array to the JAX mesh state's: a mesh or single-device snapshot of either
package restores into either at any shard count."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import (DevicesLike, DeviceLike, mesh_devices, on_device,
                      resolve_device, resolve_devices, to_host)
from ..graph.logical import AggKind, AggSpec
from ..kernels.bin_evict import bin_evict
from ..kernels.bin_update import bin_update, channel_plan
from ..kernels.join_sort import join_sort
from ..kernels.mesh_merge import merge_views, mesh_merge
from ..kernels.mesh_remap import mesh_remap
from ..kernels.mesh_route import RULE_MESH, mesh_route, route_views
from ..kernels.pane_emit import pane_emit, pane_views
from ..ops.keyed_bins import (
    KeyedBinState,
    _bucket,
    _coerce_float,
    _init_value,
    _to_device,
    build_channels,
    channel_input,
    channel_inits,
    directory_insert,
    preaggregate,
    restored_count_state,
)

EMPTY = np.uint64(0xFFFF_FFFF_FFFF_FFFF)  # sentinel: empty key slot
EMPTY_BITS = -1  # EMPTY as i64 bits
_MIN_ROWS = 256  # per-slice row-buffer floor (power-of-two bucketed)


def mesh_key_shards(devices: Sequence) -> int:
    """Key shards over the mesh ``devices``: ``ARROYO_MESH`` = 'off' (1),
    an integer (rounded down to a power of two, at most the devices), or
    'auto' (the default: the largest power of two <= the devices).  The
    route takes the top log2(nk) key bits, hence the power of two."""
    mode = os.environ.get("ARROYO_MESH", "auto").lower()
    if mode in ("off", "0", "1", "none"):
        return 1
    n = len(devices)
    if mode.isdigit():
        n = min(int(mode), n)
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _init_filled(ch_kinds: Tuple[str, ...], shape: Tuple[int, ...]
                 ) -> np.ndarray:
    """[n_ch, *shape] f64 array filled with each channel's identity."""
    out = np.zeros((len(ch_kinds),) + shape, np.float64)
    for j, k in enumerate(ch_kinds):
        out[j] = _init_value(AggKind(k))
    return out


def _channel_rows(aggs, ch_kinds, valid_of, agg_inputs, n) -> np.ndarray:
    """[n_ch, n] per-row channel contributions, nulls masked to identity."""
    vals = np.zeros((len(ch_kinds), n), dtype=np.float64)
    for j in range(len(ch_kinds)):
        vals[j] = channel_input(aggs, ch_kinds, valid_of, j, agg_inputs, n)
    return vals


class MeshKeyedBinState:
    """Drop-in replacement for :class:`KeyedBinState` whose state lives
    sharded by key range over ``device`` (a sequence: one shard on each
    of its first ``nk`` entries).

    The host keeps the key directory (key hash -> slot, for key-column
    values and exact per-shard key counts), the window bookkeeping (base
    bin, last fired pane) and admission control; each shard holds its
    sorted key table ``d_keys[s]`` i64[C] (u64 bits, EMPTY-padded), its
    planes ``d_bins[s]`` f64[n_ch, C, B] and ``d_counts[s]`` [C, B] over
    base-relative bins, and its overflow counters ``d_of[s]`` i64[2]
    (route drops, key drops)."""

    GROW_AT = 0.85  # per-shard occupancy that triggers host-side growth

    def __init__(self, aggs: Tuple[AggSpec, ...], slide_micros: int,
                 width_micros: int, capacity: int = 0,
                 n_shards: Optional[int] = None, device: DevicesLike = None):
        if capacity <= 0:
            from ..config import config

            capacity = config().state_capacity
        if width_micros % slide_micros:
            raise ValueError("window width must be a multiple of slide")
        devices = resolve_devices(device)
        self.nk = n_shards or mesh_key_shards(devices)
        if self.nk & (self.nk - 1) or len(devices) < self.nk:
            raise ValueError(f"{self.nk} key shards over {len(devices)} "
                             "devices")
        self.devices = devices[:self.nk]
        self.device = self.devices[0]
        self.aggs = aggs
        self._ch_kinds, self._valid_ch = build_channels(aggs)
        self._valid_of = {v: k for k, v in self._valid_ch.items()}
        # every channel rides the route (no COUNT(*) rebuilt from counts)
        self._plan = channel_plan(self._ch_kinds)
        self._all_ch = tuple(range(len(self._ch_kinds)))
        self.slide = slide_micros
        self.W = width_micros // slide_micros
        self.B = _bucket(2 * self.W + 4, floor=8)
        self.C = _bucket(max(capacity // self.nk, 64))  # per-shard slots
        # key-hash bits to skip when routing (set_route_shift)
        self.route_shift = 0

        # host key directory (same layout as KeyedBinState for _emit)
        self.key_sorted = np.zeros(0, dtype=np.uint64)
        self.slot_of_sorted = np.zeros(0, dtype=np.int64)
        self.next_slot = 0
        self.slot_to_key = np.zeros(64, dtype=np.uint64)
        from ..native import NativeDir

        self._ndir = NativeDir.create(self.C)
        self.shard_counts = np.zeros(self.nk, dtype=np.int64)

        # window bookkeeping (absolute bins; the shards work base-relative)
        self.base_bin: Optional[int] = None
        self.min_bin: Optional[int] = None
        self.max_bin: Optional[int] = None
        self.last_fired_pane: Optional[int] = None
        self.late_rows = 0
        # bounds any cell or pane count: drives the i32 -> i64 promotion
        self.total_rows = 0
        # merge-input mode (factor windows), see set_merge_inputs
        self._merge_cols: Optional[Dict[int, str]] = None
        self._rows_col: Optional[str] = None

        self._alloc_device()

    # -- device state ------------------------------------------------------

    def _identity(self, C: int, B: int, dev: torch.device) -> torch.Tensor:
        inits = torch.tensor(channel_inits(self._ch_kinds),
                             dtype=torch.float64, device=dev)
        return inits[:, None, None].expand(len(self._ch_kinds), C,
                                           B).contiguous()

    def _alloc_device(self) -> None:
        self.d_keys: List[torch.Tensor] = []
        self.d_bins: List[torch.Tensor] = []
        self.d_counts: List[torch.Tensor] = []
        self.d_of: List[torch.Tensor] = []
        for dev in self.devices:
            with on_device(dev):
                self.d_keys.append(torch.full((self.C,), EMPTY_BITS,
                                              dtype=torch.int64, device=dev))
                self.d_bins.append(self._identity(self.C, self.B, dev))
                self.d_counts.append(torch.zeros((self.C, self.B),
                                                 dtype=torch.int32,
                                                 device=dev))
                self.d_of.append(torch.zeros(2, dtype=torch.int64,
                                             device=dev))

    def device_bytes(self) -> int:
        """Resident bytes of every shard's tensors, read off the handles
        (no transfer): the device-memory ledger's pane entry."""
        return sum(t.numel() * t.element_size()
                   for ts in (self.d_keys, self.d_bins, self.d_counts,
                              self.d_of) for t in ts)

    def _placed(self) -> None:
        """The resharding invariant: every shard tensor on its shard's
        device (``shuffle.ensure_sharded`` moves and counts any other)."""
        from .shuffle import ensure_sharded

        for s, dev in enumerate(self.devices):
            for ts in (self.d_keys, self.d_bins, self.d_counts, self.d_of):
                ts[s] = ensure_sharded(ts[s], dev)

    def set_route_shift(self, shift: int) -> None:
        """Skip the top ``shift`` key-hash bits when routing rows to shards
        (host directory and device route stay in lockstep).  Set by
        BinAggOperator before any row lands when the operator runs at
        parallelism > 1: subtask ranges split the top bits, so without
        the shift every subtask's keys collapse onto ~nk/parallelism
        shards."""
        if self.next_slot or self.total_rows:
            raise ValueError("route shift must be set before any key is "
                             "admitted")
        if not 0 <= shift <= 32:
            raise ValueError(f"route shift {shift} outside [0, 32]")
        self.route_shift = int(shift)

    def _shard_of(self, kh: np.ndarray) -> np.ndarray:
        if self.nk == 1:
            return np.zeros(len(kh), dtype=np.int64)
        lg = int(np.log2(self.nk))
        if self.route_shift:
            kh = kh << np.uint64(self.route_shift)
        return (kh >> np.uint64(64 - lg)).astype(np.int64)

    def _c_slice(self, s: int) -> int:
        """Rows of shard ``s`` that can hold a key: its real keys are a
        prefix of its table, and the directory counts a superset of them
        (it also holds keys that only ever had late rows)."""
        return min(self.C, int(self.shard_counts[s]))

    # -- host key directory ------------------------------------------------

    def _lookup_or_insert(self, kh: np.ndarray) -> np.ndarray:
        kh = np.where(kh == EMPTY, EMPTY - np.uint64(1), kh)  # sentinel

        def ensure(total, new_keys):
            if total > len(self.slot_to_key):
                grown = np.zeros(_bucket(total, floor=64), np.uint64)
                grown[:self.next_slot] = self.slot_to_key[:self.next_slot]
                self.slot_to_key = grown
            np.add.at(self.shard_counts, self._shard_of(new_keys), 1)
            # grow BEFORE any shard can overflow: exact host-side counts
            while self.shard_counts.max() > self.GROW_AT * self.C:
                self._grow_capacity()

        return directory_insert(self, kh, ensure)

    def _relayout(self, src_shift: int, C: int, B: int) -> None:
        """Every shard's planes re-laid by ``mesh_remap``: rows kept (the
        first ``C``; new ones empty), column c from old column c +
        ``src_shift``."""
        for s, dev in enumerate(self.devices):
            with on_device(dev):
                self.d_bins[s], self.d_counts[s] = mesh_remap(
                    self.d_bins[s], self.d_counts[s], None, src_shift, C, B,
                    self._ch_kinds)

    def _grow_capacity(self) -> None:
        """Double the per-shard capacity on the devices (EMPTY keys sort
        after the real ones; new rows hold the identities)."""
        C2 = self.C * 2
        for s, dev in enumerate(self.devices):
            with on_device(dev):
                self.d_keys[s] = torch.cat([
                    self.d_keys[s],
                    torch.full((self.C,), EMPTY_BITS, dtype=torch.int64,
                               device=dev)])
        self._relayout(0, C2, self.B)
        self.C = C2

    def _grow_ring(self, needed: int) -> None:
        """Data ran ahead of the watermark beyond the bin axis: widen B."""
        B2 = self.B
        while B2 < needed:
            B2 <<= 1
        self._relayout(0, self.C, B2)
        self.B = B2

    def _rebase(self, new_base: int) -> None:
        """Out-of-order rows landed below the base while their panes are
        still unfired: shift the linear columns right so column 0 becomes
        ``new_base``."""
        off = self.base_bin - new_base
        B2 = _bucket(off + self.B, floor=8)
        self._relayout(-off, self.C, B2)
        self.B = B2
        self.base_bin = new_base

    # -- update ------------------------------------------------------------

    def set_merge_inputs(self, channel_cols: Dict[int, str],
                         rows_col: str) -> None:
        """Arm merge-input mode (factor windows), as
        :meth:`KeyedBinState.set_merge_inputs`; every channel (visible and
        hidden validity) needs a partial column, since all ride the
        route."""
        if self.next_slot or self.total_rows:
            raise ValueError("merge inputs must be set before any key is "
                             "admitted")
        missing = [j for j in range(len(self._ch_kinds))
                   if j not in channel_cols]
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

        perf.count("pane_update_rows", n)
        kh = np.where(key_hash == EMPTY, EMPTY - np.uint64(1),
                      key_hash.astype(np.uint64))
        self._lookup_or_insert(kh)  # idempotent; ensures capacity

        abs_bin = (timestamps // self.slide).astype(np.int64)
        # a row in bin b feeds panes b..b+W-1; it is late (dropped) only
        # when all those panes already fired
        if self.last_fired_pane is not None:
            live = abs_bin >= self.last_fired_pane - self.W + 2
        else:
            live = np.ones(n, dtype=bool)
        self.late_rows += int((~live).sum())
        if not live.any():
            return
        if self._merge_cols is not None:
            w_rows = _coerce_float(agg_inputs[self._rows_col])
            w_rows = np.where(np.isnan(w_rows), 0.0, w_rows)
            self.total_rows += int(np.ceil(w_rows[live].sum()))
        else:
            w_rows = None
            self.total_rows += int(live.sum())
        if (self.total_rows >= KeyedBinState._i32_promote
                and self.d_counts[0].dtype == torch.int32):
            # promote BEFORE the crossing batch lands
            for s, dev in enumerate(self.devices):
                with on_device(dev):
                    self.d_counts[s] = self.d_counts[s].to(torch.int64)
        lo = int(abs_bin[live].min())
        hi = int(abs_bin[live].max())
        self.min_bin = lo if self.min_bin is None else min(self.min_bin, lo)
        self.max_bin = hi if self.max_bin is None else max(self.max_bin, hi)
        if self.base_bin is None:
            self.base_bin = lo
        elif lo < self.base_bin:
            self._rebase(lo)
        if hi - self.base_bin >= self.B:
            self._grow_ring(hi - self.base_bin + 1)
        rel = (abs_bin - self.base_bin).astype(np.int32)

        if self._merge_cols is not None:
            # the row mass rides as one more additive channel, so duplicate
            # cells sum their masses instead of counting pane arrivals
            vals = np.zeros((len(self._ch_kinds), n), dtype=np.float64)
            for j, kind in enumerate(self._ch_kinds):
                raw = _coerce_float(agg_inputs[self._merge_cols[j]])
                ident = np.float64(_init_value(AggKind(kind)))
                vals[j] = np.where(np.isnan(raw), ident, raw)
            if not live.all():
                idx = live.nonzero()[0]
                kh, rel, vals = kh[idx], rel[idx], vals[:, idx]
                w_rows = w_rows[idx]
            kh_c, rel_c, _arrivals, red = preaggregate(
                kh, rel, self._ch_kinds + ("sum",),
                np.concatenate([vals, w_rows[None]]))
            rowcnt, vals_c = red[-1], red[:-1]
        else:
            vals = _channel_rows(self.aggs, self._ch_kinds, self._valid_of,
                                 agg_inputs, n)
            if not live.all():
                idx = live.nonzero()[0]
                kh, rel, vals = kh[idx], rel[idx], vals[:, idx]
            kh_c, rel_c, rowcnt, vals_c = preaggregate(
                kh, rel, self._ch_kinds, vals)
        perf.count("pane_update_dispatches")
        perf.timed_device(self._step, kh_c, rel_c, rowcnt, vals_c)

    def _step(self, kh_c: np.ndarray, rel_c: np.ndarray,
              rowcnt: np.ndarray, vals_c: np.ndarray) -> None:
        """Route, exchange, merge and scatter one batch's cells.  The
        cells are padded to nk slices of N (a power of two), slice s
        staged on shard s's device as ONE i64 buffer [4 + n_ch, N]: key
        bits (EMPTY padding), validity, bin, row count and channel values
        (f64 bits)."""
        from ..obs import perf
        from . import shuffle as _shuffle

        nk, C, B = self.nk, self.C, self.B
        m = len(kh_c)
        N = _bucket(-(-m // nk), floor=_MIN_ROWS)
        F = 4 + len(self._ch_kinds)
        rows = np.zeros((F, nk * N), np.int64)
        rows[0] = EMPTY_BITS
        rows[0, :m] = kh_c.view(np.int64)
        rows[1, :m] = 1
        rows[2, :m] = rel_c
        rows[3, :m] = np.asarray(rowcnt, np.float64).view(np.int64)
        rows[4:, :m] = np.asarray(vals_c, np.float64).view(np.int64)
        if nk > 1:
            # the route half of this step IS the keyed shuffle
            perf.count(_shuffle.COLLECTIVES)
            perf.count(_shuffle.COLLECTIVE_ROWS, m)
        self._placed()
        routes = []
        for s, dev in enumerate(self.devices):
            with on_device(dev):
                part = _shuffle.stage(rows[:, s * N:(s + 1) * N], dev)
                buf = mesh_route(part, nk, RULE_MESH, self.route_shift,
                                 counter=self.d_of[s][0:1])
                routes.append(route_views(buf, F, nk, N)[0])
        incoming = _shuffle.exchange(routes, self.devices)
        R = nk * N
        for d, dev in enumerate(self.devices):
            with on_device(dev):
                inc = incoming[d].view(F, R)
                order, keys_sorted = join_sort(inc[0])
                buf = mesh_merge(self.d_keys[d], keys_sorted, order, inc,
                                 counter=self.d_of[d][1:2])
                new_keys, src, cells, _ = merge_views(
                    buf, C, R, len(self._ch_kinds))
                bins, counts = mesh_remap(self.d_bins[d], self.d_counts[d],
                                          src, 0, C, B, self._ch_kinds)
                bin_update(bins, counts, cells, self._plan)
                self.d_keys[d], self.d_bins[d], self.d_counts[d] = (
                    new_keys, bins, counts)

    # -- pane emission -----------------------------------------------------

    def overflow_counters(self) -> Tuple[int, int]:
        """(route_dropped, keys_dropped) summed over the shards — both
        stay 0 under the host's admission control."""
        of = sum(to_host(t).astype(np.int64) for t in self.d_of)
        return int(of[0]), int(of[1])

    def _read_fired(self, first_rel: int, wm_rel: int):
        """Every shard's panes [first_rel, wm_rel] (relative) over its
        occupied rows, by ``pane_emit``, read back and stacked in shard
        order: (outs f64[n_ch, rows, k], cnts i64[rows, k], keys
        u64[rows]) — the read half of :meth:`fire_panes` and
        :meth:`drain_deltas`.  The counts are i64 whatever the plane's
        type, as the JAX fire's sums of them are."""
        k = wm_rel - first_rel + 1
        n_ch = len(self._ch_kinds)
        self._placed()
        outs, cnts, keys = [], [], []
        for s, dev in enumerate(self.devices):
            cs = self._c_slice(s)
            if cs == 0:
                continue
            with on_device(dev):
                buf = pane_emit(self.d_bins[s], self.d_counts[s],
                                first_rel - (self.W - 1), 0, self.B - 1,
                                self.W, k, self._ch_kinds, self._all_ch, cs)
                host = torch.from_numpy(to_host(buf))
                keys.append(to_host(self.d_keys[s][:cs]).view(np.uint64))
            o, c = pane_views(host, n_ch, cs, k, self.d_counts[s].dtype)
            outs.append(o.numpy())
            cnts.append(c.numpy())
        if not keys:
            return (np.zeros((n_ch, 0, k)), np.zeros((0, k), np.int64),
                    np.zeros(0, np.uint64))
        return (np.concatenate(outs, axis=1),
                np.concatenate(cnts).astype(np.int64), np.concatenate(keys))

    def _flatten_fired(self, outs, cnts, keys_h, base: int, first_rel: int):
        """Visible aggregate columns from the fired-cell grid (one home for
        both emission paths, as in the JAX package)."""
        mask = (cnts > 0) & (keys_h != EMPTY)[:, None]
        cell_idx, pane_idx = np.nonzero(mask)
        if len(cell_idx) == 0:
            return None
        keys = keys_h[cell_idx]
        window_end = (base + first_rel + pane_idx.astype(np.int64) + 1) \
            * self.slide
        out_cols: Dict[str, np.ndarray] = {}
        for i, a in enumerate(self.aggs):
            col = outs[i][cell_idx, pane_idx]
            if a.kind == AggKind.COUNT:
                col = col.astype(np.int64)
            elif i in self._valid_ch:
                nv = outs[self._valid_ch[i]][cell_idx, pane_idx]
                if a.kind == AggKind.AVG:
                    col = col / np.maximum(nv, 1)
                col = np.where(nv > 0, col, np.nan)
            out_cols[a.output] = col
        return keys, out_cols, window_end, cnts[cell_idx, pane_idx]

    def fire_panes(self, watermark: int, final: bool = False):
        if self.max_bin is None or self.next_slot == 0:
            return None
        if final:
            last_pane = self.max_bin + self.W - 1
        else:
            last_pane = min(int(watermark // self.slide) - 1,
                            self.max_bin + self.W - 1)
        first_pane = (self.last_fired_pane + 1
                      if self.last_fired_pane is not None
                      else (self.min_bin or 0))
        if last_pane < first_pane:
            return None
        base = self.base_bin if self.base_bin is not None else 0
        # relative panes stay within [0, B + W - 2]: last_pane is capped
        # at max_bin + W - 1 and max_bin < base + B
        wm_rel = last_pane - base
        first_rel = first_pane - base
        from ..obs import perf

        outs, cnts, keys_h = perf.timed_device(self._read_fired, first_rel,
                                               wm_rel)
        self.last_fired_pane = last_pane
        # evict: roll the base past bins no future pane needs
        new_base = last_pane - self.W + 2
        if new_base > base:
            shift = int(min(new_base - base, self.B))
            perf.timed_device(self._relayout, shift, self.C, self.B)
            self.base_bin = base + shift
            if self.min_bin is not None:
                self.min_bin = max(self.min_bin, self.base_bin)
        return self._flatten_fired(outs, cnts, keys_h, base, first_rel)

    def drain_deltas(self):
        """Checkpoint-barrier drain of a factor pane ring (W == 1), as
        :meth:`KeyedBinState.drain_deltas`: read every un-fired cell as a
        pane delta, reset those columns on every shard (``bin_evict``),
        leave ``last_fired_pane`` and ``base_bin`` where they are."""
        if self.W != 1:
            raise ValueError("drain_deltas is the factor-pane path (W == 1)")
        if self.max_bin is None or self.next_slot == 0:
            return None
        first_pane = (self.last_fired_pane + 1
                      if self.last_fired_pane is not None
                      else (self.min_bin or 0))
        last_pane = self.max_bin
        if last_pane < first_pane:
            return None
        base = self.base_bin if self.base_bin is not None else 0
        first_rel = max(first_pane - base, 0)
        wm_rel = last_pane - base
        from ..obs import perf

        outs, cnts, keys_h = perf.timed_device(self._read_fired, first_rel,
                                               wm_rel)
        for s, dev in enumerate(self.devices):
            with on_device(dev):
                perf.timed_device(bin_evict, self.d_bins[s],
                                  self.d_counts[s], first_rel,
                                  wm_rel - first_rel + 1, self.C,
                                  self._ch_kinds)
        return self._flatten_fired(outs, cnts, keys_h, base, first_rel)

    # -- checkpoint --------------------------------------------------------

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Canonical topology-independent snapshot (KeyedBinState's
        format): the real keys in shard order with their LINEAR bin
        columns (column j = absolute bin lo + j), plus the host key
        directory, so a restore re-shards onto any mesh or one device."""
        base = self.base_bin if self.base_bin is not None else -1
        if base >= 0 and self.max_bin is not None:
            lo = max(base, self.min_bin if self.min_bin is not None else base)
            span = self.max_bin - lo + 1
            first = lo - base  # the shards' columns are base-relative
        else:
            lo, span, first = -1, 0, 0
        keys, bins, counts = [], [], []
        for s, dev in enumerate(self.devices):
            cs = self._c_slice(s)
            with on_device(dev):
                k = to_host(self.d_keys[s][:cs])
                b = to_host(self.d_bins[s][:, :cs, first:first + span])
                c = to_host(self.d_counts[s][:cs, first:first + span])
            real = k != EMPTY_BITS
            keys.append(k[real].view(np.uint64))
            bins.append(b[:, real])
            counts.append(c[real])
        return {
            "bin_keys": np.concatenate(keys),
            "bin_vals": np.concatenate(bins, axis=1),
            "bin_counts": np.concatenate(counts),
            "ch_init": channel_inits(self._ch_kinds),
            # provenance marker, ignored by restore
            "mesh_shards": np.array([self.nk], dtype=np.int64),
            "key_sorted": self.key_sorted.copy(),
            "slot_of_sorted": self.slot_of_sorted.copy(),
            "slot_to_key": self.slot_to_key[:self.next_slot].copy(),
            "meta": np.array([
                self.next_slot, lo,  # lo == min_bin (min_bin >= base_bin)
                -1 if self.max_bin is None else self.max_bin,
                -1 if self.last_fired_pane is None else self.last_fired_pane,
            ], dtype=np.int64),
        }

    def restore(self, arrays: Dict[str, np.ndarray]) -> None:
        meta = arrays["meta"]
        self.next_slot = int(meta[0])
        lo = int(meta[1])
        self.max_bin = None if meta[2] < 0 else int(meta[2])
        self.last_fired_pane = None if meta[3] < 0 else int(meta[3])
        self.min_bin = None if lo < 0 else lo
        # base starts at the oldest stored bin (column 0); update()'s
        # _rebase lowers it if live out-of-order rows arrive below it
        self.base_bin = lo if lo >= 0 else None
        self.key_sorted = np.asarray(arrays["key_sorted"]).astype(np.uint64)
        self.slot_of_sorted = np.asarray(
            arrays["slot_of_sorted"]).astype(np.int64)
        from ..native import NativeDir

        self._ndir = NativeDir.create(max(self.next_slot, 64))
        if self._ndir is not None:
            self._ndir.load(self.key_sorted, self.slot_of_sorted)
        self.slot_to_key = np.zeros(
            _bucket(max(self.next_slot, 1), floor=64), np.uint64)
        self.slot_to_key[:self.next_slot] = np.asarray(
            arrays["slot_to_key"]).astype(np.uint64)[:self.next_slot]

        keys = np.asarray(arrays["bin_keys"]).astype(np.uint64)
        bins = np.asarray(arrays["bin_vals"], dtype=np.float64)
        raw_counts = np.asarray(arrays["bin_counts"])
        self.total_rows, cnt_dtype = restored_count_state(
            raw_counts, KeyedBinState._i32_promote)
        counts = raw_counts.astype(cnt_dtype)
        span = bins.shape[-1]
        self.B = _bucket(max(span, 2 * self.W + 4), floor=8)
        # admission control counts come from the HOST directory (a superset
        # of the device-resident keys), so growth still precedes overflow
        self.shard_counts = np.bincount(
            self._shard_of(self.key_sorted), minlength=self.nk).astype(
                np.int64)
        shard = self._shard_of(keys)
        while self.shard_counts.max() > self.GROW_AT * self.C:
            self.C *= 2
        self._alloc_device()
        for s, dev in enumerate(self.devices):
            sel = shard == s
            ks = keys[sel]
            order = np.argsort(ks)
            m = len(ks)
            keys2 = np.full(self.C, EMPTY, np.uint64)
            keys2[:m] = ks[order]
            bins2 = _init_filled(self._ch_kinds, (self.C, self.B))
            bins2[:, :m, :span] = bins[:, sel][:, order]
            counts2 = np.zeros((self.C, self.B), cnt_dtype)
            counts2[:m, :span] = counts[sel][order]
            self.d_keys[s] = _to_device(keys2.view(np.int64), dev)
            self.d_bins[s] = _to_device(bins2, dev)
            self.d_counts[s] = _to_device(counts2, dev)


def make_bin_state(aggs: Tuple[AggSpec, ...], slide_micros: int,
                   width_micros: int, capacity: int = 0,
                   device: DeviceLike = None,
                   mesh: Optional[DevicesLike] = None):
    """State factory for BinAggOperator: mesh-sharded over ``mesh`` (by
    default the distinct visible devices of ``device``'s type) when it
    gives more than one key shard, single-device on ``device`` otherwise.

    Long-window shapes (W = width/slide >= ARROYO_RING_MIN_W, e.g.
    HOP(1s, 300s)) stay on one device, whose ring-pane fire replaces the
    [C, k, W] gather that dominates memory at large W, as in the JAX
    package."""
    if mesh is not None:
        devices = resolve_devices(mesh)
        dev = devices[0] if device is None else resolve_device(device)
    else:
        dev = resolve_device(device)
        devices = mesh_devices(dev)
    nk = mesh_key_shards(devices)
    W = width_micros // max(slide_micros, 1)
    ring_min = int(os.environ.get("ARROYO_RING_MIN_W", 64))
    ring_shape = (W >= ring_min
                  and os.environ.get("ARROYO_RING", "auto") != "off")
    if nk > 1 and not ring_shape:
        return MeshKeyedBinState(aggs, slide_micros, width_micros,
                                 capacity=capacity, n_shards=nk,
                                 device=devices)
    return KeyedBinState(aggs, slide_micros, width_micros,
                         capacity=capacity, device=dev)
