"""Windowed keyed-state operators on the device (port of
``BinAggOperator`` and ``WindowArgmaxOperator`` from
``arroyo_tpu.engine.operators_window``).

* :class:`BinAggOperator` — sliding/tumbling two-phase window aggregate
  over :class:`~arroyo_tpu_torch.ops.keyed_bins.KeyedBinState`; panes are
  emitted on watermark advance by one device pass over all pending panes.
* :class:`WindowArgmaxOperator` — the fused per-window argmax stage that
  consumes the aggregate's (pre-filtered) panes and settles the global
  answer;
* :class:`WindowJoinOperator` — the windowed stream-stream equi-join over
  partition-adaptive join state (``state/join_state.py``), whose hot
  partitions live on the device."""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from ..graph.logical import (
    AggSpec,
    ColumnExpr,
    InstantWindow,
    JoinType,
    LogicalOperator,
    OpKind,
    SlidingWindow,
    TumblingWindow,
)
from ..ops.expr import CompiledExpr, eval_record_expr
from ..ops.keyed_bins import KeyedBinState, filter_canonical_snapshot
from ..state.join_state import PartitionedJoinBuffer
from ..state.tables import DeviceTable, TableDescriptor, TableType
from ..types import MAX_TIMESTAMP, Batch, Message, Watermark
from .build import register_builder
from .context import Context
from .operator import Operator


class _SlotKeyValues:
    """Host-side slot -> key-column-values store for bin-state operators."""

    def __init__(self) -> None:
        self.cols: Dict[str, np.ndarray] = {}
        self.size = 0

    def ensure(self, batch: Batch, slots: np.ndarray, prev_next: int,
               new_next: int) -> None:
        if new_next <= self.size and self.cols:
            return
        cap = max(new_next, 64)
        for c in list(self.cols):
            old = self.cols[c]
            if len(old) < cap:
                grown = np.empty(cap * 2, dtype=old.dtype)
                grown[:len(old)] = old
                self.cols[c] = grown
        for c in batch.key_cols:
            if c in batch.columns and c not in self.cols:
                self.cols[c] = np.empty(cap * 2, dtype=batch.columns[c].dtype)
        new_mask = slots >= prev_next
        if new_mask.any():
            idx = new_mask.nonzero()[0]
            for c in batch.key_cols:
                if c in batch.columns:
                    self.cols[c][slots[idx]] = batch.columns[c][idx]
        self.size = max(self.size, new_next)

    def gather(self, slot_idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {c: v[slot_idx] for c, v in self.cols.items()}

    def snapshot(self) -> Dict[str, np.ndarray]:
        return {f"kv_{c}": v[:self.size] for c, v in self.cols.items()} | {
            "kv_size": np.array([self.size])}

    def restore(self, arrays: Dict[str, np.ndarray]) -> None:
        self.size = int(arrays["kv_size"][0])
        for k, v in arrays.items():
            if k.startswith("kv_") and k != "kv_size":
                self.cols[k[3:]] = v.copy()


class BinAggOperator(Operator):
    """Two-phase binned window aggregate over device state."""

    def __init__(self, name: str, width_micros: int, slide_micros: int,
                 aggs: Tuple[AggSpec, ...],
                 projection: Optional[ColumnExpr] = None,
                 argmax_local: Optional[Tuple[str, str]] = None,
                 device: DeviceLike = None):
        super().__init__(name)
        self.width = width_micros
        self.slide = slide_micros
        self.aggs = aggs
        self.state = KeyedBinState(aggs, slide_micros, width_micros,
                                   device=device)
        if argmax_local is not None:
            # emission pre-filters to local per-pane argmax candidates
            self.state.set_argmax_local(*argmax_local)
        self.keyvals = _SlotKeyValues()
        self.projection = (CompiledExpr(projection.name, projection.fn)
                           if projection else None)
        self._key_cols: Tuple[str, ...] = ()

    def _offload_transfers(self) -> bool:
        """Run device update/emit in an executor thread when the state
        lives on an accelerator, so host<->device copies and the fire's
        sync do not hold the event loop; on the CPU the thread hop is
        pure overhead."""
        return self.state.device.type != "cpu"

    async def on_start(self, ctx: Context) -> None:
        def snap():
            return self.state.snapshot() | self.keyvals.snapshot()

        def restore(arrays, _kr=ctx.task_info.key_range):
            # rescale re-partitioning: keep only the keys this subtask owns
            arrays = filter_canonical_snapshot(arrays, _kr)
            self.state.restore(arrays)
            self.keyvals.restore(arrays)

        ctx.state.register_device(
            TableDescriptor("a", TableType.DEVICE, "bin aggregates",
                            retention_micros=self.width),
            DeviceTable(snap, restore))

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        if batch.key_hash is None:
            raise ValueError(f"{self.name} requires keyed input")
        self._key_cols = batch.key_cols
        prev = self.state.next_slot
        slots = self.state._lookup_or_insert(batch.key_hash)
        self.keyvals.ensure(batch, slots, prev, self.state.next_slot)
        # safe to offload: this operator's messages are processed serially
        if self._offload_transfers():
            await asyncio.get_running_loop().run_in_executor(
                None, self.state.update, batch.key_hash, batch.timestamp,
                batch.columns)
        else:
            self.state.update(batch.key_hash, batch.timestamp, batch.columns)

    async def handle_watermark(self, watermark: int, ctx: Context) -> None:
        final = watermark >= int(MAX_TIMESTAMP) - 1
        if self._offload_transfers():
            fired = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.state.fire_panes(watermark, final=final))
        else:
            fired = self.state.fire_panes(watermark, final=final)
        if fired is not None:
            await self._emit(fired, ctx)
        await ctx.broadcast(Message.wm(Watermark.event_time(watermark)))

    async def _emit(self, fired, ctx: Context) -> None:
        keys, out_cols, window_end, _counts = fired
        slot_idx = self.state.slot_of_sorted[
            np.searchsorted(self.state.key_sorted, keys)]
        cols: Dict[str, np.ndarray] = {}
        cols.update(self.keyvals.gather(slot_idx))
        cols["window_start"] = window_end - self.width
        cols["window_end"] = window_end
        cols.update(out_cols)
        ts = window_end - 1  # rows stamp at window end - 1
        key_cols = self._key_cols or tuple(self.keyvals.cols)
        out = Batch(ts, cols, keys.astype(np.uint64), key_cols)
        if self.projection is not None:
            out = eval_record_expr(self.projection, out)
        await ctx.collect(out)


class WindowArgmaxOperator(Operator):
    """Fused ``A JOIN (SELECT max(x), window FROM A GROUP BY window)``:
    rows arrive keyed by window, buffer per window until the watermark
    passes, then emit exactly the rows achieving the window's max/min of
    ``value_col`` (ties included) plus the pruned side's synthesized
    columns.  Sound at any upstream parallelism: every global argmax row
    is also a local argmax row upstream."""

    def __init__(self, name: str, value_col: str, minmax: str,
                 synth_cols: Tuple[Tuple[str, str], ...], width_micros: int):
        super().__init__(name)
        self.value_col = value_col
        self.minmax = minmax
        self.synth_cols = synth_cols
        self.width = max(int(width_micros), 1)
        self._released_wm: Optional[int] = None

    def tables(self) -> List[TableDescriptor]:
        return [TableDescriptor("b", TableType.BATCH_BUFFER,
                                "per-window candidate rows",
                                retention_micros=self.width)]

    async def on_start(self, ctx: Context) -> None:
        self.buf = ctx.state.get_batch_buffer("b")
        if ctx.last_watermark is not None:
            # windows at or below the checkpoint watermark fired before
            # the restore
            self._released_wm = ctx.last_watermark

    async def _emit(self, rows: Batch, ctx: Context) -> None:
        cols = dict(rows.columns)
        for out_name, src in self.synth_cols:
            cols[out_name] = cols[src]
        await ctx.collect(Batch(rows.timestamp, cols, rows.key_hash,
                                rows.key_cols))

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        self.buf.append(batch)
        # one timer per distinct window end; aggregate rows stamp
        # timestamp = window_end - 1
        for e in np.unique(np.asarray(batch.columns["window_end"],
                                      dtype=np.int64)).tolist():
            ctx.timers.schedule(int(e), ("am", int(e)))

    async def handle_timer(self, time: int, key: Any, payload: Any,
                           ctx: Context) -> None:
        end = key[1]
        rows = self.buf.query_range(end - 1, end)  # ts == end - 1
        self.buf.evict_before(end)
        self._released_wm = (end if self._released_wm is None
                             else max(self._released_wm, end))
        if rows is None or not len(rows):
            return
        vals = np.asarray(rows.columns[self.value_col])
        # SQL NULLs (NaN) never equal the extremum
        valid = (~np.isnan(vals) if vals.dtype.kind == "f"
                 else np.ones(len(vals), dtype=bool))
        if not valid.any():
            return
        vv = vals[valid]
        best = vv.max() if self.minmax == "max" else vv.min()
        await self._emit(rows.select(np.nonzero(valid & (vals == best))[0]),
                         ctx)


# -- window join ----------------------------------------------------------------------


def _window_params(typ) -> Tuple[int, int]:
    """(width, slide) micros for uniform window types."""
    if isinstance(typ, TumblingWindow):
        return typ.width_micros, typ.width_micros
    if isinstance(typ, SlidingWindow):
        return typ.width_micros, typ.slide_micros
    if isinstance(typ, InstantWindow):
        return 1, 1
    raise TypeError(f"not a uniform window: {typ}")


def _null_column(n: int, like: Optional[np.ndarray] = None,
                 kind: str = "") -> np.ndarray:
    """A NULL-filled column: None for object/string columns, NaN (f64)
    for everything else — the engine's null conventions."""
    stringy = (kind == "s" if like is None
               else (like.dtype == object or like.dtype.kind in "US"))
    if stringy:
        return np.full(n, None, dtype=object)
    return np.full(n, np.nan, dtype=np.float64)


def _join_name_maps(l_names, r_names
                    ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Column-name mapping for a join output: left names win, colliding
    right names get the ``r_`` prefix."""
    lmap = {c: c for c in l_names}
    rmap: Dict[str, str] = {}
    taken = set(lmap.values())
    for c in r_names:
        name = c
        if name in taken:
            name = "r_" + name
        rmap[c] = name
        taken.add(name)
    return lmap, rmap


def _internal_join_col(name: str) -> bool:
    """Planner-internal join key columns: ``__jk<i>`` + ``__jknonce``."""
    return name.startswith("__jk")


def _drop_null_keyed(batch: Batch) -> Optional[Batch]:
    """Strip rows whose ``__jknonce`` is nonzero — SQL-NULL join keys
    hashed to a unique nonce can never match any row.  Returns None when
    nothing survives."""
    nonce = batch.columns.get("__jknonce")
    if nonce is None:
        return batch
    keep = np.asarray(nonce) == 0
    if keep.all():
        return batch
    if not keep.any():
        return None
    return batch.select(keep)


def _stable_join_part(left_cols: Dict[str, np.ndarray],
                      right_cols: Dict[str, np.ndarray], n: int,
                      key_names: Sequence[str]) -> Dict[str, np.ndarray]:
    """One joined-output column layout per join, whichever side a row
    came from: the right role never carries internal join-key columns;
    the left role always does (filled with same-dtype zeros when the
    left role is itself a pad), keys first and ``__jknonce`` last."""
    witness = {c: v for c, v in right_cols.items()
               if _internal_join_col(c)}
    right_cols = {c: v for c, v in right_cols.items()
                  if not _internal_join_col(c)}

    def _key_fill(c: str) -> np.ndarray:
        w = witness.get(c)
        if w is not None:
            return np.zeros(n, dtype=w.dtype)
        return _null_column(n)

    ordered: Dict[str, Optional[np.ndarray]] = {}
    for c in key_names:
        if c != "__jknonce":
            ordered[c] = left_cols.get(c)
    for c, v in left_cols.items():
        if c not in ordered and c != "__jknonce":
            ordered[c] = v
    if "__jknonce" in key_names:
        ordered["__jknonce"] = left_cols.get("__jknonce")
    cols = {c: (v if v is not None else _key_fill(c))
            for c, v in ordered.items()}
    lmap, rmap = _join_name_maps(list(cols), list(right_cols))
    out = {lmap[c]: v for c, v in cols.items()}
    for c, v in right_cols.items():
        out[rmap[c]] = v
    return out


class _SideTemplate:
    """Column template for null-padding one side of an outer join: the
    dtypes of batches seen on that side, else the planner's (name, kind)
    schema."""

    def __init__(self, spec_cols: Tuple[Tuple[str, str], ...]):
        self.spec_cols = tuple(spec_cols)
        self.seen: Optional[Dict[str, np.dtype]] = None

    def observe(self, batch: Batch) -> None:
        self.seen = {c: v.dtype for c, v in batch.columns.items()}

    def null_cols(self, n: int) -> Dict[str, np.ndarray]:
        if self.seen is not None:
            return {c: _null_column(n, like=np.empty(0, dtype=dt))
                    for c, dt in self.seen.items()}
        return {c: _null_column(n, kind=k) for c, k in self.spec_cols}


def _empty_like_side(tmpl: _SideTemplate, other: Batch) -> Batch:
    """A 0-row batch shaped like one join side (for windows where that
    side saw no data)."""
    cols = {c: v[:0] for c, v in tmpl.null_cols(0).items()}
    return Batch(np.zeros(0, dtype=np.int64), cols,
                 np.zeros(0, dtype=np.uint64), other.key_cols)


def _concat_col(parts: List[np.ndarray]) -> np.ndarray:
    """Concatenate column fragments, promoting to object when any
    fragment is (None-padded rows mix with typed rows); int64 fragments
    mixed with NaN pads promote to float64, the engine's nullable-int
    convention."""
    if any(p.dtype == object for p in parts):
        out = np.empty(sum(len(p) for p in parts), dtype=object)
        at = 0
        for p in parts:
            out[at:at + len(p)] = p
            at += len(p)
        return out
    return np.concatenate(parts)


def _assemble_join_output(l_rows: Batch, r_rows: Batch,
                          l_un: Optional[Batch], r_un: Optional[Batch],
                          end: int, how: JoinType, key_cols,
                          tmpl: Tuple[_SideTemplate, _SideTemplate]
                          ) -> Batch:
    """One join-output batch from aligned matched rows plus each side's
    unmatched rows; every part shares one column layout."""
    key_names = tuple(key_cols)
    parts: List[Tuple[Dict[str, np.ndarray], np.ndarray]] = []  # (cols, kh)
    parts.append((_stable_join_part(
        dict(l_rows.columns), dict(r_rows.columns), len(l_rows),
        key_names), l_rows.key_hash))
    if how in (JoinType.LEFT, JoinType.FULL) and l_un is not None \
            and len(l_un):
        parts.append((_stable_join_part(
            dict(l_un.columns), tmpl[1].null_cols(len(l_un)), len(l_un),
            key_names), l_un.key_hash))
    if how in (JoinType.RIGHT, JoinType.FULL) and r_un is not None \
            and len(r_un):
        parts.append((_stable_join_part(
            tmpl[0].null_cols(len(r_un)), dict(r_un.columns), len(r_un),
            key_names), r_un.key_hash))
    if len(parts) == 1:
        cols, kh = parts[0]
        return Batch(np.full(len(kh), end - 1, dtype=np.int64), cols, kh,
                     key_names)
    names = list(parts[0][0])
    out_cols = {c: _concat_col([p[0][c] for p in parts]) for c in names}
    kh = np.concatenate([p[1] for p in parts])
    return Batch(np.full(len(kh), end - 1, dtype=np.int64), out_cols, kh,
                 key_names)


def join_batches(l: Batch, r: Batch, end: int, how: JoinType,
                 tmpl: Tuple[_SideTemplate, _SideTemplate]) -> Batch:
    """The legacy layout's fire (CPU only): sort both sides' key hashes,
    equi-join them on the host, null-pad the unmatched rows."""
    from ..ops.join import _host_pairs
    from ..state.join_state import _count_gather

    lo = np.argsort(l.key_hash, kind="stable")
    ro = np.argsort(r.key_hash, kind="stable")
    lidx, ridx, counts = _host_pairs(l.key_hash[lo], r.key_hash[ro])
    l_rows = l.select(lo[lidx])
    r_rows = r.select(ro[ridx])
    l_un = (l.select(lo[counts == 0])
            if how in (JoinType.LEFT, JoinType.FULL) else None)
    r_un = None
    if how in (JoinType.RIGHT, JoinType.FULL):
        r_matched = np.zeros(len(r.key_hash), dtype=bool)
        r_matched[ro[ridx]] = True
        r_un = r.select(~r_matched)
    _count_gather(0, len(l_rows) + len(r_rows)
                  + (len(l_un) if l_un is not None else 0)
                  + (len(r_un) if r_un is not None else 0))
    return _assemble_join_output(l_rows, r_rows, l_un, r_un, end, how,
                                 l.key_cols, tmpl)


class WindowJoinOperator(Operator):
    """Windowed stream-stream hash join: both sides buffered, joined per
    fired window.  On the partitioned layout a fire mask-compresses each
    partition's sorted run to the window (no sort), merge-probes the two
    sides on the host mirror and gathers the matched rows — from the
    device rings of hot partitions.  Outer kinds null-pad the unmatched
    side per fired window (append-only: each window fires once)."""

    def __init__(self, name: str, typ, join_type: JoinType = JoinType.INNER,
                 left_cols: Tuple[Tuple[str, str], ...] = (),
                 right_cols: Tuple[Tuple[str, str], ...] = ()):
        super().__init__(name)
        self.typ = typ
        self.join_type = join_type
        self.width, self.slide = _window_params(typ)
        self._tmpl = (_SideTemplate(left_cols), _SideTemplate(right_cols))

    async def on_start(self, ctx: Context) -> None:
        self.left = ctx.state.get_join_buffer("l", "left buffer", self.width)
        self.right = ctx.state.get_join_buffer("r", "right buffer",
                                               self.width)
        self._partitioned = isinstance(self.left, PartitionedJoinBuffer)

    def _drop_never_emitting(self, batch: Batch,
                             side: int) -> Optional[Batch]:
        """Null-keyed rows stay only when this side's unmatched rows
        null-pad at fire; otherwise they can never emit."""
        padded = self.join_type in (
            (JoinType.LEFT, JoinType.FULL) if side == 0
            else (JoinType.RIGHT, JoinType.FULL))
        return batch if padded else _drop_null_keyed(batch)

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        if batch.key_hash is None:
            raise ValueError(f"{self.name} requires keyed inputs")
        self._tmpl[side].observe(batch)
        buffered = self._drop_never_emitting(batch, side)
        if buffered is not None and len(buffered):
            (self.left if side == 0 else self.right).append(buffered)
        first_end = (batch.timestamp // self.slide + 1) * self.slide
        if isinstance(self.typ, SlidingWindow):
            ends = np.unique(np.concatenate([
                first_end + i * self.slide
                for i in range(self.width // self.slide)]))
        else:
            ends = np.unique(first_end - self.slide + self.width)
        for e in ends.tolist():
            ctx.timers.schedule(int(e), ("wj", int(e)))

    async def handle_timer(self, time: int, key: Any, payload: Any,
                           ctx: Context) -> None:
        end = key[1]
        start = end - self.width
        out = (self._fire_partitioned(start, end) if self._partitioned
               else self._fire_legacy(start, end))
        if out is not None and len(out):
            await ctx.collect(out)
        evict_to = end - self.width + self.slide
        self.left.evict_before(evict_to)
        self.right.evict_before(evict_to)

    def _fires(self, have_l: bool, have_r: bool) -> bool:
        how = self.join_type
        return ((have_l and have_r)
                or (have_l and how in (JoinType.LEFT, JoinType.FULL))
                or (have_r and how in (JoinType.RIGHT, JoinType.FULL)))

    def _fire_partitioned(self, start: int, end: int) -> Optional[Batch]:
        how = self.join_type
        lg, rg, lu, ru = self.left.range_join(self.right, start, end)
        if not self._fires(bool(len(lg) or len(lu)),
                           bool(len(rg) or len(ru))):
            return None
        l_rows = self.left.gather(lg)
        r_rows = self.right.gather(rg)
        if not len(l_rows.columns):
            l_rows = _empty_like_side(self._tmpl[0], r_rows)
        if not len(r_rows.columns):
            r_rows = _empty_like_side(self._tmpl[1], l_rows)
        key_cols = (self.left.key_cols or self.right.key_cols
                    or l_rows.key_cols)
        # unmatched rows only materialize on the side that pads them
        l_un = (self.left.gather(lu)
                if how in (JoinType.LEFT, JoinType.FULL) else None)
        r_un = (self.right.gather(ru)
                if how in (JoinType.RIGHT, JoinType.FULL) else None)
        return _assemble_join_output(l_rows, r_rows, l_un, r_un, end, how,
                                     key_cols, self._tmpl)

    def _fire_legacy(self, start: int, end: int) -> Optional[Batch]:
        l = self.left.query_range(start, end)
        r = self.right.query_range(start, end)
        have_l = l is not None and len(l) > 0
        have_r = r is not None and len(r) > 0
        if not self._fires(have_l, have_r):
            return None
        if not have_l:
            l = _empty_like_side(self._tmpl[0], r)
        if not have_r:
            r = _empty_like_side(self._tmpl[1], l)
        return join_batches(l, r, end, self.join_type, self._tmpl)



# -- builder registration -----------------------------------------------------------


@register_builder(OpKind.SLIDING_WINDOW_AGGREGATOR)
def _build_sliding(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    return BinAggOperator(op.name, s.width_micros, s.slide_micros, s.aggs,
                          s.projection, argmax_local=s.argmax_local,
                          device=device)


@register_builder(OpKind.TUMBLING_WINDOW_AGGREGATOR)
def _build_tumbling(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    return BinAggOperator(op.name, s.width_micros, s.width_micros, s.aggs,
                          s.projection, argmax_local=s.argmax_local,
                          device=device)


@register_builder(OpKind.WINDOW_ARGMAX)
def _build_window_argmax(op: LogicalOperator, device: DeviceLike
                         ) -> Operator:
    s = op.spec
    return WindowArgmaxOperator(op.name, s.value_col, s.minmax, s.synth_cols,
                                s.width_micros)


@register_builder(OpKind.WINDOW_JOIN)
def _build_window_join(op: LogicalOperator, device: DeviceLike) -> Operator:
    s = op.spec
    return WindowJoinOperator(op.name, s.typ, s.join_type, s.left_cols,
                              s.right_cols)
