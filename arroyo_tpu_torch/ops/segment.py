"""Segment aggregation: group-by-key over a batch of buffered rows (port
of ``arroyo_tpu.ops.segment``).

Rows are sorted by key hash on the host (numpy argsort), so each key's
rows form one contiguous segment; the channel reduce runs through the
``segment_agg`` kernel on the caller's device (the operator's state
device: the CUDA kernel on the card, its plain PyTorch version on the
CPU).  COUNT(DISTINCT), string MIN/MAX, the median and UDAFs that do not
decompose into channels reduce on the host, as in the JAX package.

The JAX package pads rows and segments to power-of-two buckets to bound
XLA recompiles; the kernel takes exact sizes, so the port passes the
segment offsets as they are.  COUNT(*) channels upload no values: the
kernel reads rows only for the channels it reduces.  A reduce makes one
upload, one launch and one readback."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, to_host
from ..formats import coerce_float, nan_validity
from ..graph.logical import AggKind, AggSpec
from ..kernels.segment_agg import segment_agg_buffer
from ..obs import perf

# f64 extremes: the channels are float64, so the null identities must not
# clip values beyond the float32 range
NEG_INF = np.finfo(np.float64).min
POS_INF = np.finfo(np.float64).max


def _segmented_median(v: np.ndarray, kh_sorted: np.ndarray,
                      uniq: np.ndarray, seg_start: np.ndarray
                      ) -> np.ndarray:
    """Per-segment median in three vector ops (the np.median UDAF fast
    path): in-segment value sort via one lexsort, NaNs last, then the
    two middle elements of each segment's non-null prefix."""
    n = len(v)
    if n == 0 or len(seg_start) == 0:
        return np.zeros(0, dtype=np.float64)
    so = np.lexsort((v, kh_sorted))  # NaN sorts after every number
    vs = v[so]
    sizes = np.diff(np.append(seg_start, n))
    nn = sizes - np.add.reduceat(np.isnan(vs).astype(np.int64), seg_start)
    lo_i = seg_start + np.maximum(nn - 1, 0) // 2
    hi_i = seg_start + np.maximum(nn, 1) // 2
    med = 0.5 * (vs[np.minimum(lo_i, n - 1)] + vs[np.minimum(hi_i, n - 1)])
    return np.where(nn > 0, med, np.nan)


def _reduce(kinds: List[str], rows: List[np.ndarray], seg_start: np.ndarray,
            n: int, device: torch.device
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(outs f64[len(kinds), n_seg], rows per segment) over the
    segments starting at ``seg_start``; ``rows`` holds the values of the
    channels that are not counts, in channel order.  One upload (the
    offsets, then the value rows as their bits, in one host array of
    8-byte words), one launch and one readback of the kernel's buffer."""
    n_seg = len(seg_start)
    host = np.empty(n_seg + 1 + len(rows) * n, dtype=np.int64)
    host[:n_seg] = seg_start
    host[n_seg] = n
    vals = host[n_seg + 1:].view(np.float64).reshape(len(rows), n)
    for i, row in enumerate(rows):
        vals[i] = row
    up = torch.from_numpy(host).to(device)
    buf = perf.timed_device(
        segment_agg_buffer, up[n_seg + 1:].view(torch.float64).view(
            len(rows), n), up[:n_seg + 1], tuple(kinds))
    out = to_host(buf)
    return out[1:].view(np.float64), out[0]


def segment_aggregate(
    key_hash: np.ndarray,
    timestamps: np.ndarray,
    agg_inputs: Dict[str, np.ndarray],
    aggs: Tuple[AggSpec, ...],
    device: DeviceLike,
) -> Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray, np.ndarray,
           Dict[str, np.ndarray]]:
    """Group rows by key_hash and compute ``aggs`` on ``device``.

    Returns (unique_keys, {output_name: values}, max_ts_per_key,
    row_counts_per_key, {output_name: non_null_counts} for column aggs).
    Nulls (NaN after coercion) are skipped: they feed the aggregate its
    identity, COUNT(col) counts non-null rows only, AVG divides by the
    non-null count, and an all-null segment emits NaN (SQL NULL)."""
    from .udaf import UdafPlan, channel_rows, udaf_channels_enabled, udaf_plan

    device = torch.device(device)
    n = len(key_hash)
    order = np.argsort(key_hash, kind="stable")
    kh = key_hash[order]
    uniq, seg_start = np.unique(kh, return_index=True)
    n_seg = len(uniq)

    host_results: Dict[str, np.ndarray] = {}
    host_valid_counts: Dict[str, np.ndarray] = {}
    device_aggs = []
    kinds: List[str] = []
    rows: List[np.ndarray] = []
    udaf_specs: List[Tuple[AggSpec, UdafPlan, Dict[str, int]]] = []

    def _host_segments(column: np.ndarray):
        """(values in order, per-row validity, per-segment row groups)
        for every host-reduced aggregate (UDAFs, string MIN/MAX)."""
        v = column[order]
        ok = nan_validity(v, None)
        ok_rows = np.ones(len(v), dtype=bool) if ok is None else ok
        return v, ok_rows, np.split(np.arange(n), seg_start[1:])

    for a in aggs:
        if a.kind == AggKind.UDAF:
            col_raw = np.asarray(agg_inputs[a.column])
            if (a.fn is np.median and col_raw.dtype.kind in "if"
                    and udaf_channels_enabled()):
                # vectorized across ALL segments: one in-segment sort,
                # then middle-element picks
                perf.count("udaf_channel_rows", n)
                host_results[a.output] = _segmented_median(
                    np.asarray(col_raw[order], dtype=np.float64), kh, uniq,
                    seg_start)
                continue
            # numeric UDAF expressible over mergeable partials: compile
            # onto channels; object/string columns stay on the host loop
            plan = (udaf_plan(a.fn) if col_raw.dtype.kind in "ifbu"
                    else None)
            if plan is not None:
                raw = coerce_float(col_raw[order], np.float64)
                ok = ~np.isnan(raw)
                chmap: Dict[str, int] = {}
                for ch in plan.channels:
                    kind, rowv = channel_rows(ch, raw, ok)
                    chmap[ch] = len(kinds)
                    kinds.append(kind)
                    rows.append(rowv)
                udaf_specs.append((a, plan, chmap))
                perf.count("udaf_channel_rows", n)
                continue
            # per-segment host call over the non-null values
            perf.count("udaf_host_rows", n)
            v, ok_rows, groups = _host_segments(agg_inputs[a.column])
            out = []
            cnt = np.zeros(n_seg, dtype=np.int64)
            for j, g in enumerate(groups):
                gv = v[g[ok_rows[g]]]
                cnt[j] = len(gv)
                out.append(a.fn(gv) if len(gv) else np.nan)
            host_results[a.output] = np.asarray(out)
            host_valid_counts[a.output] = cnt
        elif (a.kind in (AggKind.MIN, AggKind.MAX)
              and np.asarray(agg_inputs[a.column]).dtype == object):
            # string MIN/MAX (lexicographic, NULLs skipped) cannot ride
            # the f64 channels: per-segment host reduce
            v, ok_rows, groups = _host_segments(agg_inputs[a.column])
            pick = min if a.kind == AggKind.MIN else max
            outv = []
            for g in groups:
                gv = v[g[ok_rows[g]]]
                outv.append(pick(gv) if len(gv) else None)
            host_results[a.output] = np.asarray(outv, dtype=object)
        elif a.kind == AggKind.COUNT_DISTINCT:
            # sort-based on the host over (key, value) pairs; SQL excludes
            # NULLs (and NaN != NaN would count every null as distinct)
            v = agg_inputs[a.column][order]
            ok = nan_validity(v, None)
            if ok is not None and not ok.all():
                vv0, kv0 = v[ok], kh[ok]
            else:
                vv0, kv0 = v, kh
            m = len(vv0)
            pair_sort = np.lexsort((vv0, kv0))
            kv, vv = kv0[pair_sort], vv0[pair_sort]
            is_new = np.ones(m, dtype=bool)
            is_new[1:] = (kv[1:] != kv[:-1]) | (vv[1:] != vv[:-1])
            per_key = np.zeros(n_seg, dtype=np.int64)
            np.add.at(per_key, np.searchsorted(uniq, kv[is_new]), 1)
            host_results[a.output] = per_key
        else:
            device_aggs.append(a)

    # channel layout: one kernel channel per agg, plus a hidden additive
    # validity-count channel per column-reading agg so nulls are skipped;
    # ``rows`` gets a value row for every channel but COUNT(*)'s
    specs: List[Tuple[AggSpec, int, Optional[int]]] = []
    for a in device_aggs:
        if a.column is None:  # COUNT(*) — all rows
            specs.append((a, len(kinds), None))
            kinds.append("count")
            continue
        raw = coerce_float(agg_inputs[a.column][order], np.float64)
        ok = ~np.isnan(raw)
        if a.kind == AggKind.COUNT:  # COUNT(col) — non-null rows
            specs.append((a, len(kinds), None))
            kinds.append("sum")
            rows.append(ok.astype(np.float64))
            continue
        ident = np.float64(0.0 if a.kind in (AggKind.SUM, AggKind.AVG)
                           else (POS_INF if a.kind == AggKind.MIN
                                 else NEG_INF))
        specs.append((a, len(kinds), len(kinds) + 1))
        kinds.append("sum" if a.kind == AggKind.AVG else a.kind.value)
        rows.append(np.where(ok, raw, ident).astype(np.float64))
        kinds.append("sum")
        rows.append(ok.astype(np.float64))

    outs, counts = _reduce(kinds, rows, seg_start, n, device)
    out_cols = dict(host_results)
    valid_counts: Dict[str, np.ndarray] = dict(host_valid_counts)
    for a, plan, chmap in udaf_specs:
        parts = {ch: np.asarray(outs[i], dtype=np.float64)
                 for ch, i in chmap.items()}
        nnz = parts["nnz"]
        with np.errstate(all="ignore"):
            col = plan.combine(parts)
        # all-null segments emit NaN, as the host loop's empty branch
        out_cols[a.output] = np.where(nnz > 0, col, np.nan)
        valid_counts[a.output] = nnz.astype(np.int64)
    for a, ci, vi in specs:
        col = outs[ci]
        if vi is not None:
            nv = outs[vi]
            valid_counts[a.output] = nv.astype(np.int64)
            if a.kind == AggKind.AVG:
                col = col / np.maximum(nv, 1)
            col = np.where(nv > 0, col, np.nan)
        if a.kind == AggKind.COUNT:
            col = col.astype(np.int64)
            valid_counts[a.output] = col
        out_cols[a.output] = col

    # per-key max timestamp (host; the emitted record timestamps)
    ts_sorted = timestamps[order]
    max_ts = np.maximum.reduceat(ts_sorted, seg_start)
    return (uniq, out_cols, max_ts, np.asarray(counts).astype(np.int64),
            valid_counts)
