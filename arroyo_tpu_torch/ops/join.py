"""Equi-join pairs and the device-resident rings of hot join partitions —
the port of ``arroyo_tpu.ops.join``.

LEGACY LAYOUT (``ARROYO_JOIN_STATE=legacy``): :func:`join_pairs` joins two
u64 key arrays by re-sorting both.  On the device (the caller's device is
CUDA, both sides non-empty, at least ``ARROYO_DEVICE_JOIN_MIN`` rows
together, no real key equal to the padding ``SENTINEL`` — the JAX
package's conditions) each side pads to a power-of-two bucket with
``SENTINEL``, both go up in one upload, and four launches follow with no
host sync between them: :func:`~arroyo_tpu_torch.kernels.join_sort` of
each side, the u64 form of :func:`~arroyo_tpu_torch.kernels.join_probe`
and :func:`~arroyo_tpu_torch.kernels.join_expand_buffer`, which reads the
pair total on the device.  The sort orders, the match counts and the
pairs then come back in one synchronization (two when the pairs pass
the expansion's capacity).  Below those conditions it joins in numpy,
as the JAX package does on an accelerator.

Hot join-state partitions (``state/join_state.py``) keep their sorted key
run on the device in a preallocated power-of-two ring, padded with
sentinels, maintained by ONE merge launch per arriving delta
(:func:`~arroyo_tpu_torch.kernels.ring_merge`: the delta, sorted on the
host, goes up in one upload with its insert positions, which place every
resident entry too).  Window fires match on the host mirror's full keys
and gather the matched rows' payload from the ring in one launch and
read both payload stacks back in one copy
(:func:`~arroyo_tpu_torch.kernels.ring_gather.ring_gather_rows`).

SPLIT-HASH LAYOUT: the partition id fixes the low hash bits, and the top
32 bits of the u64 hash are an order-consistent prefix of the host run's
sort, so the ring stores them as a bias-mapped i32 ``hi`` plane
(``u32 ^ 0x80000000`` viewed as i32) and the low 32 bits as an i32 ``lo``
plane (equality only).

PAYLOAD PLANES: the partition's payload columns ride the ring in the
same layout — one f64 stack (floats) and one i64 stack (ints, uints,
bools and datetimes as bit-views or widened; slot 0 holds the sorted
event-time run).  The bit-views stay numpy on the host.  Payload planes
are always on (the JAX package's ``payload_device_enabled`` holds
whenever x64 does, and torch has native i64 and f64); strings cannot
ride the device: the buffer's sticky fallback keeps such sides host.
A ring's planes are views of one device buffer, staged in one upload.

PROBES: joins with expiration probe an arriving batch's sorted keys
against a hot ring: one upload of the queries, one launch of
:func:`~arroyo_tpu_torch.kernels.join_probe` (candidate ranges on the
``hi`` plane, a superset of the true matches) and, right behind it with
no host sync, one expansion sized from the ring's last pair totals: the
unverified (query, ring position) pairs (:func:`expand_hit`,
:func:`~arroyo_tpu_torch.kernels.join_expand`) or the pairs with the
full split key verified and both payload stacks gathered
(:func:`expand_gather`, :func:`~arroyo_tpu_torch.kernels.expand_gather`).
The expansion reads the pair total on the device and returns it in its
buffer, which the join reads back in one copy; a total above the
capacity costs a second launch and copy at the exact total.
``join_ring_probes`` counts the probes, ``join_probe_readbacks`` their
device-to-host copies, ``join_probe_overflows`` the second launches and
``join_blocking_uploads`` the uploads that held the host."""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import to_device, to_host
from ..kernels.expand_gather import expand_gather_buffer, expand_views
from ..kernels.join_expand import join_expand_buffer, pair_views
from ..kernels.join_probe import join_probe
from ..kernels.join_sort import join_sort
from ..kernels.ring_gather import ring_gather_rows
from ..kernels.ring_merge import (SENT32_HI, SENT32_LO, ring_merge,
                                  ring_planes, ring_words)
from ..obs import perf
from ..obs.perf import timed_device

# padding key of the legacy layout: sorts after every real hash
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)

_HI_BIAS = np.uint32(0x80000000)


def _bucket(n: int, floor: int = 512) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def expand_counts(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten per-group match counts into (group_idx, within_offset)
    pairs."""
    total = int(counts.sum())
    gidx = np.repeat(np.arange(len(counts)), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                        counts)
    return gidx, offs


def _host_pairs(lk_sorted: np.ndarray, rk_sorted: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lidx, ridx, per-left-row counts) of an equi-join of two sorted
    key arrays, numpy end to end."""
    left_start = np.searchsorted(rk_sorted, lk_sorted, side="left")
    left_end = np.searchsorted(rk_sorted, lk_sorted, side="right")
    counts = left_end - left_start
    lidx, offs = expand_counts(counts)
    ridx = np.repeat(left_start, counts) + offs
    return lidx, ridx, counts


def _host_join_pairs(lk: np.ndarray, rk: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    lo = np.argsort(lk, kind="stable")
    ro = np.argsort(rk, kind="stable")
    lidx, ridx, counts = _host_pairs(lk[lo], rk[ro])
    return lo, ro, lidx, ridx, counts


def _read_back(device: torch.device, *parts: torch.Tensor
               ) -> Tuple[np.ndarray, ...]:
    """``parts`` on the host after ONE synchronization: on the card each
    is copied into pinned memory without blocking, then the stream is
    waited for once (``join_pairs_readbacks`` counts the waits)."""
    perf.count("join_pairs_readbacks")
    if device.type != "cuda":
        return tuple(p.numpy() for p in parts)
    host = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            for p in parts]
    for h, p in zip(host, parts):
        h.copy_(p, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return tuple(h.numpy() for h in host)


def join_pairs(lk: np.ndarray, rk: np.ndarray, device: torch.device
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                          np.ndarray]:
    """(lo, ro, lidx, ridx, counts) of an equi-join of two u64 key arrays:
    ``lo``/``ro`` sort each side stably, ``lidx``/``ridx`` index pairs
    into the sorted orders, ``counts`` is each sorted left row's match
    count (for outer-join unmatched masks).  The legacy layout's full
    re-sort, counted as ``join_state_resorts``.

    On ``device`` when :func:`device_join_enabled` holds, both sides are
    non-empty and no real key is ``SENTINEL`` (``join_pairs_device``):
    one upload, ``join_sort`` x2, the u64 ``join_probe`` and
    ``join_expand_buffer`` at a capacity of the larger side's bucket,
    then ONE synchronization for the orders, the counts and the pairs;
    a pair total above the capacity expands again at the total and
    syncs once more (``join_pairs_overflows``).  Otherwise numpy
    (``join_pairs_host``).  ``join_pairs_bucket:<n>`` counts the padded
    sides by bucket."""
    perf.count("join_state_resorts")
    nl, nr = len(lk), len(rk)
    device = torch.device(device)
    if not device_join_enabled(device, nl + nr) or nl == 0 or nr == 0 \
            or (lk == SENTINEL).any() or (rk == SENTINEL).any():
        perf.count("join_pairs_host")
        return _host_join_pairs(lk, rk)
    perf.count("join_pairs_device")
    nlp, nrp = _bucket(nl), _bucket(nr)
    perf.count(f"join_pairs_bucket:{nlp}")
    perf.count(f"join_pairs_bucket:{nrp}")
    host = np.full(nlp + nrp, SENTINEL, np.uint64)
    host[:nl] = lk
    host[nlp:nlp + nr] = rk
    keys = _upload(host.view(np.int64), device)
    lo_d, lks = timed_device(join_sort, keys[:nlp])
    ro_d, rks = timed_device(join_sort, keys[nlp:])
    start, counts_d, cum = timed_device(join_probe, lks, rks, nl, nr)
    cap = max(nlp, nrp)
    buf = timed_device(join_expand_buffer, start, cum, cap)
    lo, ro, counts, pairs = _read_back(device, lo_d[:nl], ro_d[:nr],
                                       counts_d[:nl], buf)
    total = int(pairs[0])
    if total > cap:
        perf.count("join_pairs_overflows")
        cap = total
        pairs, = _read_back(device, timed_device(join_expand_buffer, start,
                                                 cum, cap))
    lidx, ridx = pair_views(pairs, total, cap)
    return lo, ro, lidx, ridx, counts


def device_join_enabled(device: torch.device,
                        n_rows: Optional[int] = None) -> bool:
    """``ARROYO_DEVICE_JOIN``: ``auto`` (default) puts hot partitions on
    the device, and pairs the legacy layout's ``n_rows`` keys there from
    ``ARROYO_DEVICE_JOIN_MIN`` (2,048) rows, when ``device`` is CUDA, and
    keeps both on the host on the CPU, where the "device" is the same
    memory; ``on`` always (the CPU tests use it to drive the device paths
    through the kernels' plain versions); ``off`` host numpy only."""
    mode = os.environ.get("ARROYO_DEVICE_JOIN", "auto")
    if mode == "off":
        return False
    if mode == "on":
        return True
    return torch.device(device).type == "cuda" and (
        n_rows is None
        or n_rows >= int(os.environ.get("ARROYO_DEVICE_JOIN_MIN", 2048)))


def split_hi32(keys: np.ndarray) -> np.ndarray:
    """Order-preserving i32 image of the top 32 key-hash bits."""
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    return (hi ^ _HI_BIAS).view(np.int32)


def split_lo32(keys: np.ndarray) -> np.ndarray:
    """i32 bit-view of the low 32 key-hash bits (equality only)."""
    return (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)


def ring_stageable(keys: np.ndarray) -> bool:
    """False when any key's top-32 image would collide with the hi pad
    (the partition then stays host — exactness over speed)."""
    if not len(keys):
        return True
    return int(keys.max() >> np.uint64(32)) != 0xFFFFFFFF


def _pay_to_i64(v: np.ndarray) -> np.ndarray:
    if v.dtype == np.uint64 or v.dtype.kind in "Mm":
        return v.view(np.int64)  # bit-preserving
    if v.dtype == np.int64:
        return v
    return v.astype(np.int64)


def _pay_from_i64(v: np.ndarray, dtype: np.dtype) -> np.ndarray:
    if dtype == np.uint64 or dtype.kind in "Mm":
        return v.view(dtype)
    if dtype == np.bool_:
        return v != 0
    return v.astype(dtype)


PayloadPlan = Tuple[Tuple[str, str, int, Any], ...]


def payload_plan(schema: Dict[str, np.dtype]) -> Optional[PayloadPlan]:
    """(name, stack, slot, dtype) transport plan for a partition's payload
    columns, or None when a column cannot ride the device (strings and
    objects).  i-stack slot 0 holds the sorted event-time run; floats ride
    the f64 stack losslessly, everything else bit-views or widens into
    i64."""
    plan = []
    nf, ni = 0, 1  # i-stack slot 0: timestamps
    for name, dt in schema.items():
        k = dt.kind
        if k == "f":
            plan.append((name, "f", nf, dt))
            nf += 1
        elif k in "iubMm":
            plan.append((name, "i", ni, dt))
            ni += 1
        else:
            return None
    return tuple(plan)


class SplitRing:
    """One hot partition's device residency: split-hash key planes plus
    (optionally) the payload stacks, all in the host mirror's sorted-run
    order and padded to one power-of-two ``cap``, as views of one device
    buffer (``kernels.ring_merge.ring_planes``).  ``plan`` is None for a
    keys-only ring.  ``pair_cap`` is the pair capacity its next probe's
    expansion is sized to, from the last probes' pair totals."""

    __slots__ = ("hi", "lo", "cap", "fstack", "istack", "plan", "nf", "ni",
                 "device", "pair_cap")

    def __init__(self, hi, lo, cap, fstack, istack, plan, nf, ni, device,
                 pair_cap=None):
        self.hi = hi
        self.lo = lo
        self.cap = cap
        self.fstack = fstack
        self.istack = istack
        self.plan = plan
        self.nf = nf
        self.ni = ni
        self.device = device
        self.pair_cap = _bucket(0) if pair_cap is None else pair_cap

    def plan_schema(self) -> Dict[str, Any]:
        return {name: dt for name, _s, _i, dt in (self.plan or ())}

    def payload_bytes(self) -> int:
        return self.cap * (8 + 8 * (self.nf + self.ni))


def _plan_dims(plan: PayloadPlan) -> Tuple[int, int]:
    nf = sum(1 for _n, s, _i, _d in plan if s == "f")
    ni = 1 + sum(1 for _n, s, _i, _d in plan if s == "i")
    return nf, ni


def _pack(keys: np.ndarray, width: int, plan: Optional[PayloadPlan],
          nf: int, ni: int, cols: Optional[Dict[str, np.ndarray]],
          ts: Optional[np.ndarray], lead: int = 0) -> np.ndarray:
    """One host i64 array: ``lead`` words for the caller, then a ring
    buffer of ``width`` slots (``ring_planes``' layout) holding the sorted
    ``keys`` split into ``hi``/``lo`` and, with a plan, the payload
    stacks (i-stack slot 0 the event times), sentinel/zero padded."""
    n = len(keys)
    host = np.zeros(lead + ring_words(width, nf, ni), np.int64)
    hi, lo, fv, iv = ring_planes(host[lead:], width, nf, ni,
                                 plan is not None)
    hi[n:], lo[n:] = SENT32_HI, SENT32_LO
    hi[:n] = split_hi32(keys)
    lo[:n] = split_lo32(keys)
    if plan is not None:
        iv[0, :n] = ts
        for name, stack, idx, _dt in plan:
            if stack == "f":
                fv[idx, :n] = cols[name]
            else:
                iv[idx, :n] = _pay_to_i64(cols[name])
    return host


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on the ring's device through ``device.to_device`` (on the
    card one non-blocking copy from pinned memory).  An upload that holds
    the host until the copy lands — a plain copy to a CPU device — counts
    ``join_blocking_uploads``; the card's join paths make none."""
    if device.type != "cuda":
        perf.count("join_blocking_uploads")
    return to_device(arr, device)


def stage_ring(sorted_keys: np.ndarray, device: torch.device,
               sorted_ts: Optional[np.ndarray] = None,
               sorted_cols: Optional[Dict[str, np.ndarray]] = None
               ) -> Optional[SplitRing]:
    """Upload a sorted key run (plus payload columns when given, in the
    same sorted-run order) into a fresh power-of-two sentinel-padded ring
    on ``device``, in one copy.  Returns None when the run is not
    stageable (top-32 sentinel collision)."""
    if not ring_stageable(sorted_keys):
        return None
    device = torch.device(device)
    cap = _bucket(max(len(sorted_keys), 1))
    plan = (payload_plan({c: v.dtype for c, v in sorted_cols.items()})
            if sorted_cols is not None else None)
    nf, ni = _plan_dims(plan) if plan is not None else (0, 0)
    buf = _upload(_pack(sorted_keys, cap, plan, nf, ni, sorted_cols,
                        sorted_ts), device)
    hi, lo, fstack, istack = ring_planes(buf, cap, nf, ni, plan is not None)
    return SplitRing(hi, lo, cap, fstack, istack, plan, nf, ni, device)


def merge_ring(ring: SplitRing, n_res: int, delta_sorted: np.ndarray,
               delta_pos: np.ndarray, delta_ts: Optional[np.ndarray] = None,
               delta_cols: Optional[Dict[str, np.ndarray]] = None
               ) -> Optional[SplitRing]:
    """ONE merge launch inserting the (already sorted) delta — keys AND
    payload planes in lockstep — at ``delta_pos`` (strictly increasing in
    [0, n_res + m)) between the ring's first ``n_res`` entries, which
    keep their order.  The delta (its positions, then its planes in
    ``ring_planes``' layout, m entries) goes up in one upload.  Returns
    None when the delta is not stageable (the caller demotes to host)."""
    if not ring_stageable(delta_sorted):
        return None
    m = len(delta_sorted)
    host = _pack(delta_sorted, m, ring.plan, ring.nf, ring.ni, delta_cols,
                 delta_ts, lead=m)
    host[:m] = delta_pos
    delta = _upload(host, ring.device)
    d_hi, d_lo, d_f, d_i = ring_planes(delta[m:], m, ring.nf, ring.ni,
                                       ring.plan is not None)
    hi, lo, fstack, istack = timed_device(
        ring_merge, ring.hi, ring.lo, ring.fstack, ring.istack, n_res, d_hi,
        d_lo, d_f, d_i, delta[:m])
    return SplitRing(hi, lo, ring.cap, fstack, istack, ring.plan, ring.nf,
                     ring.ni, ring.device, ring.pair_cap)


class ProbeHit(NamedTuple):
    """One ring probe's intermediates, left on the ring's device for the
    expansion launch: candidate match ranges on the i32 ``hi`` plane (a
    SUPERSET of the true matches — hi-equal, full key unverified) as
    ``start``/``cum``, and the padded queries.  The pair total stays on
    the device: the expansion reads it there."""

    start_d: torch.Tensor
    cum_d: torch.Tensor
    q_hi: torch.Tensor
    q_lo: torch.Tensor


def probe_ring(ring: SplitRing, qkeys_sorted: np.ndarray,
               n_valid: int) -> ProbeHit:
    """Candidate match ranges of sorted query keys against a resident
    ring: one upload of the queries (padded to a power-of-two bucket with
    the ``hi`` sentinel) and one ``join_probe`` launch, no host sync.
    Candidates still need the full-key verify (:func:`expand_hit` /
    :func:`expand_gather`)."""
    m = len(qkeys_sorted)
    mq = _bucket(max(m, 1))
    q = np.empty((2, mq), np.int32)
    q[0], q[1] = SENT32_HI, SENT32_LO
    q[0, :m] = split_hi32(qkeys_sorted)
    q[1, :m] = split_lo32(qkeys_sorted)
    q_d = _upload(q, ring.device)
    start_d, _counts, cum_d = timed_device(join_probe, q_d[0], ring.hi, m,
                                           n_valid)
    perf.count("join_ring_probes")
    return ProbeHit(start_d, cum_d, q_d[0], q_d[1])


def _expand(ring: SplitRing, kernel, head: tuple, tail: tuple,
            capacity: Optional[int]) -> Tuple[np.ndarray, int, int]:
    """Launch an expansion ``kernel(*head, capacity, *tail)`` right behind
    the probe and read its buffer back in one copy; the header holds the
    pair total the device read.  When it exceeds the capacity
    (``ring.pair_cap`` unless given) the expansion runs again at the
    exact total: a second counted readback (``join_probe_overflows``),
    never a truncation.  The ring's next capacity is the bucket of twice
    this total, or half the last capacity when that is larger: it grows
    at once and shrinks slowly, since a partition's totals swing from
    probe to probe (a Zipf head key) and grow with its state.  Returns
    (host buffer, total, its capacity)."""
    last = cap = ring.pair_cap if capacity is None else capacity
    host = to_host(timed_device(kernel, *head, cap, *tail))
    perf.count("join_probe_readbacks")
    total = int(host[0])
    if total > cap:
        perf.count("join_probe_overflows")
        cap = total
        host = to_host(timed_device(kernel, *head, cap, *tail))
        perf.count("join_probe_readbacks")
    ring.pair_cap = max(_bucket(2 * total), last // 2)
    return host, total, cap


def expand_hit(ring: SplitRing, hit: ProbeHit,
               capacity: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Keys-only expansion of candidate ranges: (query index, ring
    position) i64 pairs, UNVERIFIED — the caller kills i32 collisions
    against its host mirror (``skeys[spos] == qkeys[qidx]``).  One launch
    into one buffer, read back in one copy (two on a capacity
    overflow)."""
    host, total, cap = _expand(ring, join_expand_buffer,
                               (hit.start_d, hit.cum_d), (), capacity)
    return pair_views(host, total, cap)


def expand_gather(ring: SplitRing, hit: ProbeHit,
                  capacity: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray]:
    """probe -> expand -> payload materialization, fused: ONE launch turns
    the device-resident candidate ranges into pair indices, the full-key
    verify and the gathered payload stacks, in one buffer read back in
    one copy (two on a capacity overflow).  Returns (qidx, ring_pos,
    valid, f_rows [nf, total], i_rows [ni, total]) on the host, numpy
    views of that copy; ``valid`` is False for i32-equal-but-u64-distinct
    candidates."""
    host, total, cap = _expand(
        ring, expand_gather_buffer, (hit.start_d, hit.cum_d),
        (ring.hi, ring.lo, hit.q_hi, hit.q_lo, ring.fstack, ring.istack),
        capacity)
    return expand_views(host, total, ring.nf, ring.ni, cap)


def gather_ring(ring: SplitRing, spos: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Fire-path payload gather: the payload stacks at the given
    sorted-run positions (already exact — fires match on the host
    mirror's full keys) in one launch, read back in one copy as (f_rows
    [nf, n], i_rows [ni, n])."""
    rows = timed_device(ring_gather_rows,
                        _upload(np.asarray(spos, dtype=np.int64),
                                ring.device),
                        ring.fstack, ring.istack).cpu().numpy()
    nf = ring.fstack.shape[0]
    return rows[:nf].view(np.float64), rows[nf:]


def unpack_payload(ring: SplitRing, gf: np.ndarray, gi: np.ndarray
                   ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(timestamps, columns) from gathered payload stacks, restoring each
    column's storage dtype (bit-views for u64 and datetimes, lossless
    narrowing for f32, int32 and bool)."""
    ts = gi[0].astype(np.int64, copy=False)
    cols = {}
    for name, stack, idx, dt in ring.plan:
        cols[name] = (gf[idx] if dt == np.float64
                      else gf[idx].astype(dt) if stack == "f"
                      else _pay_from_i64(gi[idx], dt))
    return ts, cols
