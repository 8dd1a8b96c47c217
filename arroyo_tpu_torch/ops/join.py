"""Equi-join helpers and the device-resident rings of hot join partitions
— the port of the partitioned-state half of ``arroyo_tpu.ops.join``.

Hot join-state partitions (``state/join_state.py``) keep their sorted key
run on the device in a preallocated power-of-two ring, padded with
sentinels, maintained by ONE scatter-merge launch per arriving delta
(:func:`~arroyo_tpu_torch.kernels.ring_merge`; positions are computed on
the host mirror, where the delta was already sorted).  Window fires match
on the host mirror's full keys and gather the matched rows' payload from
the ring in one launch and read both payload stacks back in one copy
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

PROBES: joins with expiration probe an arriving batch's sorted keys
against a hot ring in one launch (:func:`probe_ring` over
:func:`~arroyo_tpu_torch.kernels.join_probe`: candidate ranges on the
``hi`` plane, a superset of the true matches), read back the pair
total to size the expansion, then either expand the ranges into
unverified (query, ring position) pairs (:func:`expand_hit`,
:func:`~arroyo_tpu_torch.kernels.join_expand`) or expand, verify the full
split key and gather both payload stacks in one more launch
(:func:`expand_gather`, :func:`~arroyo_tpu_torch.kernels.expand_gather`)
into one buffer that is read back in one copy.  ``join_ring_probes``
counts the probes and ``join_probe_readbacks`` their device-to-host
copies (the pair total, then the expansion's).

Left for later: the legacy layout's device ``join_pairs`` (the sort
kernel; the port's ``join_pairs`` is host numpy, CPU only)."""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import to_host
from ..kernels.expand_gather import expand_gather_buffer, expand_views
from ..kernels.join_expand import join_expand
from ..kernels.join_probe import join_probe
from ..kernels.ring_gather import ring_gather_rows
from ..kernels.ring_merge import SENT32_HI, SENT32_LO, ring_merge
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


def join_pairs(lk: np.ndarray, rk: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                          np.ndarray]:
    """(lo, ro, lidx, ridx, counts) of an equi-join of two u64 key arrays,
    on the host: ``lo``/``ro`` sort each side stably, ``lidx``/``ridx``
    index pairs into the sorted orders, ``counts`` is each sorted left
    row's match count (for outer-join unmatched masks).  The legacy
    layout's full re-sort, counted as ``join_state_resorts``."""
    perf.count("join_state_resorts")
    lo = np.argsort(lk, kind="stable")
    ro = np.argsort(rk, kind="stable")
    lidx, ridx, counts = _host_pairs(lk[lo], rk[ro])
    return lo, ro, lidx, ridx, counts


def device_join_enabled(device: torch.device) -> bool:
    """``ARROYO_DEVICE_JOIN``: ``auto`` (default) puts hot partitions on
    the device when the buffer lives on CUDA and keeps them host on the
    CPU, where a "device" ring is the same memory; ``on`` always (the CPU
    tests use it to drive the ring path); ``off`` host numpy only."""
    mode = os.environ.get("ARROYO_DEVICE_JOIN", "auto")
    if mode == "off":
        return False
    if mode == "on":
        return True
    return torch.device(device).type == "cuda"


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
    order and padded to one power-of-two ``cap``.  ``plan`` is None for a
    keys-only ring."""

    __slots__ = ("hi", "lo", "cap", "fstack", "istack", "plan", "nf", "ni",
                 "device")

    def __init__(self, hi, lo, cap, fstack, istack, plan, nf, ni, device):
        self.hi = hi
        self.lo = lo
        self.cap = cap
        self.fstack = fstack
        self.istack = istack
        self.plan = plan
        self.nf = nf
        self.ni = ni
        self.device = device

    def plan_schema(self) -> Dict[str, Any]:
        return {name: dt for name, _s, _i, dt in (self.plan or ())}

    def payload_bytes(self) -> int:
        return self.cap * (8 + 8 * (self.nf + self.ni))


def _plan_dims(plan: PayloadPlan) -> Tuple[int, int]:
    nf = sum(1 for _n, s, _i, _d in plan if s == "f")
    ni = 1 + sum(1 for _n, s, _i, _d in plan if s == "i")
    return nf, ni


def _pack_stacks(plan: PayloadPlan, nf: int, ni: int, width: int, n: int,
                 cols: Dict[str, np.ndarray], ts: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    fv = np.zeros((nf, width), np.float64)
    iv = np.zeros((ni, width), np.int64)
    iv[0, :n] = ts
    for name, stack, idx, _dt in plan:
        if stack == "f":
            fv[idx, :n] = cols[name]
        else:
            iv[idx, :n] = _pay_to_i64(cols[name])
    return fv, iv


def _put(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    # torch.tensor copies, so read-only numpy views are fine
    return torch.tensor(arr, device=device)


def stage_ring(sorted_keys: np.ndarray, device: torch.device,
               sorted_ts: Optional[np.ndarray] = None,
               sorted_cols: Optional[Dict[str, np.ndarray]] = None
               ) -> Optional[SplitRing]:
    """Upload a sorted key run (plus payload columns when given, in the
    same sorted-run order) into a fresh power-of-two sentinel-padded ring
    on ``device``.  Returns None when the run is not stageable (top-32
    sentinel collision)."""
    if not ring_stageable(sorted_keys):
        return None
    n = len(sorted_keys)
    cap = _bucket(max(n, 1))
    hi = np.full(cap, SENT32_HI, np.int32)
    lo = np.full(cap, SENT32_LO, np.int32)
    hi[:n] = split_hi32(sorted_keys)
    lo[:n] = split_lo32(sorted_keys)
    plan = (payload_plan({c: v.dtype for c, v in sorted_cols.items()})
            if sorted_cols is not None else None)
    fstack = istack = None
    nf = ni = 0
    if plan is not None:
        nf, ni = _plan_dims(plan)
        fv, iv = _pack_stacks(plan, nf, ni, cap, n, sorted_cols, sorted_ts)
        fstack, istack = _put(fv, device), _put(iv, device)
    return SplitRing(_put(hi, device), _put(lo, device), cap, fstack, istack,
                     plan, nf, ni, device)


def merge_ring(ring: SplitRing, res_pos: np.ndarray,
               delta_sorted: np.ndarray, delta_pos: np.ndarray,
               delta_ts: Optional[np.ndarray] = None,
               delta_cols: Optional[Dict[str, np.ndarray]] = None
               ) -> Optional[SplitRing]:
    """ONE scatter-merge launch moving resident entries to ``res_pos`` and
    landing the (already sorted) delta — keys AND payload planes in
    lockstep — at ``delta_pos``.  Unused positions pad to ``cap`` and are
    dropped.  Returns None when the delta is not stageable (the caller
    demotes to host)."""
    if not ring_stageable(delta_sorted):
        return None
    cap, dev = ring.cap, ring.device
    m = len(delta_sorted)
    db = _bucket(max(m, 1))
    rp = np.full(cap, cap, np.int64)
    rp[:len(res_pos)] = res_pos
    d_hi = np.full(db, SENT32_HI, np.int32)
    d_lo = np.full(db, SENT32_LO, np.int32)
    d_hi[:m] = split_hi32(delta_sorted)
    d_lo[:m] = split_lo32(delta_sorted)
    dp = np.full(db, cap, np.int64)
    dp[:len(delta_pos)] = delta_pos
    d_f = d_i = None
    if ring.plan is not None:
        fv, iv = _pack_stacks(ring.plan, ring.nf, ring.ni, db, m,
                              delta_cols, delta_ts)
        d_f, d_i = _put(fv, dev), _put(iv, dev)
    hi, lo, fstack, istack = timed_device(
        ring_merge, ring.hi, ring.lo, ring.fstack, ring.istack,
        _put(rp, dev), _put(d_hi, dev), _put(d_lo, dev), d_f, d_i,
        _put(dp, dev))
    return SplitRing(hi, lo, cap, fstack, istack, ring.plan, ring.nf,
                     ring.ni, dev)


class ProbeHit(NamedTuple):
    """One ring probe's intermediates: candidate match ranges on the i32
    ``hi`` plane (a SUPERSET of the true matches — hi-equal, full key
    unverified), with ``start``/``cum`` and the padded queries left on
    the ring's device for the expansion launch; ``total`` is the number
    of candidate pairs, read back to size it."""

    start_d: torch.Tensor
    cum_d: torch.Tensor
    total: int
    q_hi: torch.Tensor
    q_lo: torch.Tensor


def probe_ring(ring: SplitRing, qkeys_sorted: np.ndarray,
               n_valid: int) -> ProbeHit:
    """Candidate match ranges of sorted query keys against a resident
    ring, one ``join_probe`` launch; the queries pad to a power-of-two
    bucket with the ``hi`` sentinel.  Candidates still need the full-key
    verify (:func:`expand_hit` / :func:`expand_gather`)."""
    m = len(qkeys_sorted)
    mq = _bucket(max(m, 1))
    q = np.empty((2, mq), np.int32)
    q[0], q[1] = SENT32_HI, SENT32_LO
    q[0, :m] = split_hi32(qkeys_sorted)
    q[1, :m] = split_lo32(qkeys_sorted)
    q_d = _put(q, ring.device)
    start_d, _counts, cum_d = timed_device(join_probe, q_d[0], ring.hi, m,
                                           n_valid)
    perf.count("join_ring_probes")
    perf.count("join_probe_readbacks")
    # the padded queries count 0, so the last prefix sum is the total
    return ProbeHit(start_d, cum_d, int(cum_d[-1]), q_d[0], q_d[1])


def expand_hit(hit: ProbeHit) -> Tuple[np.ndarray, np.ndarray]:
    """Keys-only expansion of candidate ranges: (query index, ring
    position) i64 pairs, UNVERIFIED — the caller kills i32 collisions
    against its host mirror (``skeys[spos] == qkeys[qidx]``)."""
    lidx, ridx = timed_device(join_expand, hit.start_d, hit.cum_d,
                              hit.total)
    perf.count("join_probe_readbacks", 2)
    return lidx.cpu().numpy(), ridx.cpu().numpy()


def expand_gather(ring: SplitRing, hit: ProbeHit
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray]:
    """probe -> expand -> payload materialization, fused: ONE launch turns
    the device-resident candidate ranges into pair indices, the full-key
    verify and the gathered payload stacks, in one buffer read back in
    one copy.  Returns (qidx, ring_pos, valid, f_rows [nf, total], i_rows
    [ni, total]) on the host, numpy views of that copy; ``valid`` is
    False for i32-equal-but-u64-distinct candidates."""
    buf = timed_device(
        expand_gather_buffer, hit.start_d, hit.cum_d, hit.total, ring.hi,
        ring.lo, hit.q_hi, hit.q_lo, ring.fstack, ring.istack)
    perf.count("join_probe_readbacks")
    return expand_views(to_host(buf), hit.total, ring.fstack.shape[0],
                        ring.istack.shape[0])


def gather_ring(ring: SplitRing, spos: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Fire-path payload gather: the payload stacks at the given
    sorted-run positions (already exact — fires match on the host
    mirror's full keys) in one launch, read back in one copy as (f_rows
    [nf, n], i_rows [ni, n])."""
    rows = timed_device(ring_gather_rows,
                        _put(np.asarray(spos, dtype=np.int64), ring.device),
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
