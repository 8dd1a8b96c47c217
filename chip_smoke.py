"""Smoke test of the PyTorch/CUDA port (arroyo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. environment: torch/CUDA versions, the card, its power limit;
2. build: the CUDA kernels from arroyo_tpu_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes nexmark q5, q8, config5 and hot items give it (and, for the
   session kernels, at larger and skewed shapes), timed with CUDA events
   beside its plain version, a PyTorch yardstick (one call per plane)
   where one exists, and its least possible time on an H100 (bytes /
   3.35 TB/s; pane_emit and bin_evict count the 32-byte sectors their
   rows' columns touch); segment_top_k, ring_gather, pane_emit and
   bin_evict are timed in turns with their yardstick (three rounds of
   library, kernel, kernel, library), and so are segment_agg and
   expand_gather; those six print their launches, host syncs and
   allocations per call (the last two as PyTorch's sync debug mode and
   caching allocator see them) and torch.profiler's device time per
   launch; segment_agg's sums are held to math.fsum and to themselves
   over two calls; ring_gather's and expand_gather's launch paths are
   split into their host steps (expand_gather's with ctypes' cost of one
   argument).  With ``--parent DIR`` (a ``git archive`` of the parent
   commit unpacked at DIR) the parent's pane_emit, bin_evict, segment_agg
   and expand_gather are built from DIR and timed in turns with this
   tree's at the same shapes, and so are the reads their callers made;
4. state: the port's KeyedBinState (q5 aggregates, local argmax) over
   2,000,000 nexmark events on the card and on the CPU — every fire and
   the final snapshot identical, and a card snapshot restored into a
   fresh card state fires identically;
5. main path: nexmark q5 through ``LocalRunner`` at bench.py's size
   (2,000,000 events, batches of 131,072) on the card and on the CPU —
   identical sink rows, both kernels launched during the card run, and
   the share of wall time spent in synchronized kernel calls
   (``ARROYO_TIMING=1``, a separate run);
6. q8 path: nexmark q8 through ``LocalRunner`` at 40,000,000 events
   (batches of 131,072, 1,000,000 events/s, so four 10 s windows) on the
   card — sink rows equal to a numpy control computed here from the same
   generator, the q8 kernels (bin_update, pane_emit, bin_evict,
   ring_merge, ring_gather) all launched, hot join partitions promoted
   and rows gathered from their rings, the device share in a separate
   ``ARROYO_TIMING=1`` run, the same rows from the CPU — and q8 at
   2,000,000 events on the card and on the CPU with identical rows;
7. config5 path: session windows + median UDAF over the Kafka source
   through ``LocalRunner.run(checkpoint_interval_secs=1.0)`` at 2,000,000
   events (bench.py's producer, batches of 4,096, 1 s gap and lateness,
   checkpoints every second into InMemoryBackend) on the card — sink rows
   equal to a numpy control computed here from the same producer (one
   session per key), session_union and segment_agg launched, interval
   rows merged on the device, at least one checkpoint epoch completed;
   the device share in a separate ``ARROYO_TIMING=1`` run; and config5 at
   200,000 events on the card and on the CPU with identical rows;
8. join-stress path: bench.py's join with expiration (two impulse streams
   at 1 event/ms, the left side Zipf-keyed over 100,000 keys, the right
   uniform, batches of 8,192) through ``LocalRunner`` on the card, twice:
   8a INNER with bench.py's 30 s TTL over 1,000,000 events a side — every
   key-equal pair at most one TTL apart (a numpy control from the
   counters) present, every row key-equal, no pair twice, bench.py's
   ``state_bounded`` true; 8b LEFT with the planner's 1 h TTL over
   400,000 events a side — the net rows (CREATE minus DELETE) equal a
   numpy LEFT JOIN of the two streams; the device-to-host copies per hot
   probe (at most two in 8a: the pair total, then the expansion's
   buffer); each once more under ``ARROYO_TIMING=1`` for the device
   share;
9. hot-items path: Nexmark hot items, top 10 per window (the ROW_NUMBER
   form of q5: a HOP(2 s, 10 s) COUNT(*) fused with a per-window TopN,
   then a global TopN stage) through ``LocalRunner`` at 40,000,000 events
   (batches of 131,072, 1,000,000 events/s) on the card — at most 10
   rows per window, each row's count and each window's multiset of counts
   equal to a numpy control from the same generator, segment_top_k
   launched on every fire and the compact fire (emit_count + emit_gather)
   taken under ``ARROYO_EMIT_COMPACT=auto``, the state's bytes, the device
   share in a separate ``ARROYO_TIMING=1`` run — and at 2,000,000 events
   the card's rows equal to the CPU's, also under
   ``ARROYO_EMIT_COMPACT=on``.

Launch counts are set to 0 just before each main-path run (q5, q8,
config5, 8a, 8b, hot items) and read just after it.  It prints a
``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and, last, ``{"ok": true, "device": ...}``.
It needs one card and exits non-zero without one.

    python3 chip_smoke.py --parent DIR   # phase 3 also times the parent's"""

import argparse
import collections
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script "
          "needs an NVIDIA card", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from arroyo_tpu_torch.config5 import (  # noqa: E402
    GAP_MICROS, config5_events, config5_produce, config5_program)
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output  # noqa: E402
from arroyo_tpu_torch.connectors.nexmark import (  # noqa: E402
    EVENT_AUCTION, EVENT_BID, EVENT_PERSON, NexmarkConfig, NexmarkGenerator,
    make_splits)
from arroyo_tpu_torch.device import to_host  # noqa: E402
from arroyo_tpu_torch.engine.engine import LocalRunner  # noqa: E402
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec, JoinType  # noqa: E402
from arroyo_tpu_torch.hot_items import SLIDE_MICROS as HOT_SLIDE  # noqa: E402
from arroyo_tpu_torch.hot_items import WIDTH_MICROS as HOT_WIDTH  # noqa: E402
from arroyo_tpu_torch.hot_items import TOP_K, hot_items_program  # noqa: E402
from arroyo_tpu_torch.join_stress import (  # noqa: E402
    BASE_TIME_MICROS, INTERVAL_MICROS, PLANNER_TTL_MICROS, TTL_MICROS,
    join_stress_keys, join_stress_program, state_bounded)
from arroyo_tpu_torch.kernels import build  # noqa: E402
from arroyo_tpu_torch.kernels.argmax_fire import (  # noqa: E402
    argmax_fire, argmax_fire_reference)
from arroyo_tpu_torch.kernels.bin_evict import (  # noqa: E402
    bin_evict, bin_evict_reference)
from arroyo_tpu_torch.kernels.bin_update import (  # noqa: E402
    bin_update, bin_update_reference, channel_identity)
from arroyo_tpu_torch.kernels.emit_compact import (  # noqa: E402
    emit_count, emit_count_reference, emit_gather, emit_gather_reference)
from arroyo_tpu_torch.kernels import expand_gather as expand_gather_mod  # noqa: E402
from arroyo_tpu_torch.kernels.expand_gather import (  # noqa: E402
    expand_gather, expand_gather_buffer, expand_gather_reference,
    expand_views)
from arroyo_tpu_torch.kernels.join_expand import (  # noqa: E402
    join_expand, join_expand_reference)
from arroyo_tpu_torch.kernels.join_probe import (  # noqa: E402
    join_probe, join_probe_reference)
from arroyo_tpu_torch.kernels.pane_emit import (  # noqa: E402
    fire_geometry, pane_emit, pane_emit_reference, pane_views)
from arroyo_tpu_torch.kernels import pane_emit as pane_emit_mod  # noqa: E402
from arroyo_tpu_torch.kernels import ring_gather as ring_gather_mod  # noqa: E402
from arroyo_tpu_torch.kernels.ring_gather import (  # noqa: E402
    ring_gather, ring_gather_reference)
from arroyo_tpu_torch.kernels.ring_merge import (  # noqa: E402
    ring_merge, ring_merge_reference)
from arroyo_tpu_torch.kernels import join_expand as join_expand_mod  # noqa: E402
from arroyo_tpu_torch.kernels.segment_agg import (  # noqa: E402
    segment_agg, segment_agg_buffer, segment_agg_reference)
from arroyo_tpu_torch.kernels.segment_top_k import (  # noqa: E402
    _round_grid_cap, order_keys, segment_top_k, segment_top_k_reference)
from arroyo_tpu_torch.kernels.session_union import (  # noqa: E402
    session_union, session_union_reference)
from arroyo_tpu_torch.obs import perf  # noqa: E402
from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState  # noqa: E402
from arroyo_tpu_torch.ops.segment import _reduce as segment_reduce  # noqa: E402
from arroyo_tpu_torch.q5 import SLIDE_MICROS, WIDTH_MICROS, q5_program  # noqa: E402
from arroyo_tpu_torch.q8 import WIDTH_MICROS as Q8_WIDTH  # noqa: E402
from arroyo_tpu_torch.q8 import q8_program  # noqa: E402
from arroyo_tpu_torch.state.join_state import (  # noqa: E402
    aggregate_stats_registry)
from arroyo_tpu_torch.state.session_state import (  # noqa: E402
    aggregate_session_registry)
from arroyo_tpu_torch.types import hash_columns  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F64_OPS_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores, data sheet
NUM_EVENTS = 2_000_000  # bench.py:35
BATCH = 131_072  # bench.py:38
C_Q5, B_Q5 = 131_072, 16  # q5's key capacity and ring at that size
Q8_EVENTS = 40_000_000  # four 10 s windows at bench.py's rate
Q8_SMALL = 2_000_000
C_Q8, B_Q8 = 1_048_576, 8  # q8's person-side state at Q8_EVENTS
C_SLICE_Q8 = 800_768  # its occupied slots, rounded as a dense fire reads
RING_CAP = 65_536  # the largest hot join ring q8 stages
C5_EVENTS = 2_000_000  # 20 s of event time at bench.py's 10 us spacing
C5_SMALL = 200_000  # bench.py's BENCH_C5_EVENTS default
C5_BATCH = 4_096  # bench.py's CONFIG5_SQL batch_size
C5_SPACING = 10
JS_INNER = 1_000_000  # 8a: events per side, 2.5x bench.py's 400,000
JS_LEFT = 400_000  # 8b: bench.py's events per side
JS_BATCH = 8_192  # bench.py's join-stress batch
# 8a's median hot-partition probe (4,378 probes of a CPU run of phase 8):
# ring capacity and rows, padded and real queries; 100,000 keys over 16
# join partitions leave 6,250 keys a partition
JS_RING_CAP, JS_RING_ROWS, JS_MQ, JS_M = 8_192, 5_905, 1_024, 520
JS_KEYS = 6_250
HOT_EVENTS = 40_000_000  # the size at which hot items' fires turn sparse
HOT_SMALL = 2_000_000
# hot items at HOT_EVENTS (a CPU run of the JAX package): TopN input rows
# of a steady-state fire (one window) and of the final flush (5 windows);
# the key directory's capacity and ring; fire density when compact
TOPK_STEADY, TOPK_FLUSH = 599_800, 1_410_844
C_HOT, B_HOT, W_HOT = 4_194_304, 16, 5
HOT_DENSITY = 0.25
# its occupied slots (the auctions of a 40M-event run) and the dense
# fire's c_slice for them (rounded up to 2,048)
HOT_ROWS, C_SLICE_HOT = 2_398_860, 2_400_256
SECTOR = 32  # bytes of the card's memory transaction
ATOM = 64  # bytes HBM3 reads or writes at a time

K1_SOURCE = "arroyo_tpu_torch/csrc/bin_update.cu"
K1_REPLACES = ("arroyo_tpu/ops/keyed_bins.py:62 _update_kernel; "
               "arroyo_tpu/ops/pallas_kernels.py:77 _scatter_kernel")
K2_SOURCE = "arroyo_tpu_torch/csrc/argmax_fire.cu"
K2_REPLACES = ("arroyo_tpu/ops/keyed_bins.py:157 _argmax_nnz_kernel + "
               ":180 _argmax_gather_kernel")
K3_SOURCE = "arroyo_tpu_torch/csrc/pane_emit.cu"
K3_REPLACES = ("arroyo_tpu/ops/keyed_bins.py:123 _emit_kernel + "
               ":109 _pane_reduce")
K4_SOURCE = "arroyo_tpu_torch/csrc/bin_evict.cu"
K4_REPLACES = "arroyo_tpu/ops/keyed_bins.py:262 _evict_kernel"
K5_SOURCE = "arroyo_tpu_torch/csrc/ring_merge.cu"
K5_REPLACES = "arroyo_tpu/ops/join.py:372 _merge32_kernel"
K6_SOURCE = "arroyo_tpu_torch/csrc/ring_gather.cu"
K6_REPLACES = "arroyo_tpu/ops/join.py:535 _gather32_kernel"
K7_SOURCE = "arroyo_tpu_torch/csrc/session_union.cu"
K7_REPLACES = "arroyo_tpu/ops/session.py:75 _union_kernel"
K8_SOURCE = "arroyo_tpu_torch/csrc/segment_agg.cu"
K8_REPLACES = "arroyo_tpu/ops/segment.py:30 _segment_agg_kernel"
K9_SOURCE = "arroyo_tpu_torch/csrc/join_probe.cu"
K9_REPLACES = "arroyo_tpu/ops/join.py:76 _probe_kernel"
K10_SOURCE = "arroyo_tpu_torch/csrc/join_expand.cu"
K10_REPLACES = "arroyo_tpu/ops/join.py:121 _expand_kernel"
K11_SOURCE = "arroyo_tpu_torch/csrc/expand_gather.cu"
K11_REPLACES = "arroyo_tpu/ops/join.py:487 _expand_gather_kernel"
K12_SOURCE = "arroyo_tpu_torch/csrc/segment_top_k.cu"
K12_REPLACES = "arroyo_tpu/ops/topk.py:25 _topk_kernel"
K13_SOURCE = K14_SOURCE = "arroyo_tpu_torch/csrc/emit_compact.cu"
K13_REPLACES = "arroyo_tpu/ops/keyed_bins.py:198 _emit_count_kernel"
K14_REPLACES = "arroyo_tpu/ops/keyed_bins.py:213 _emit_compact_kernel"

KERNELS = (bin_update, argmax_fire, pane_emit, bin_evict, ring_merge,
           ring_gather, session_union, segment_agg, join_probe, join_expand,
           expand_gather, segment_top_k, emit_count, emit_gather)
PATHS = ("q5", "q8", "config5", "join_inner", "join_left", "hot_items")


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def read_launches():
    return {k.__name__: k.launches for k in KERNELS}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps=20, warm=3):
    """Median milliseconds of one call, CUDA events around each call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(kernel, other, pairs=3):
    """``kernel`` and ``other`` (a library call, or another version) timed
    in turns, ``pairs`` rounds of (other, kernel, kernel, other), each a
    cuda_ms median: (kernel ms, other ms, the medians in order), the ms
    the means of each side's medians."""
    seq = []
    for _ in range(pairs):
        seq += [cuda_ms(other), cuda_ms(kernel), cuda_ms(kernel),
                cuda_ms(other)]
    mine = [t for i, t in enumerate(seq) if i % 4 in (1, 2)]
    theirs = [t for i, t in enumerate(seq) if i % 4 in (0, 3)]
    return statistics.fmean(mine), statistics.fmean(theirs), seq


def turn_factors(seq):
    """What in_turns' medians say of the two sides: the other's time over
    the kernel's in each round (above 1: the kernel is faster), and each
    side's spread (its slowest median over its fastest) within the call."""
    rounds = [seq[i:i + 4] for i in range(0, len(seq), 4)]
    mine = [t for r in rounds for t in r[1:3]]
    theirs = [t for r in rounds for t in (r[0], r[3])]
    return {"factor_each_round": [(r[0] + r[3]) / (r[1] + r[2])
                                  for r in rounds],
            "kernel_spread": max(mine) / min(mine),
            "other_spread": max(theirs) / min(theirs)}


def host_us(fn, reps=2000):
    """Mean host microseconds of one call (no synchronization inside the
    loop; launches queue on the card)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    dt = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return dt / reps / 1e3


def per_call(fn):
    """(allocations, host syncs) of one warm call of ``fn``: the caching
    allocator's allocation requests (``memory_stats``) and the
    synchronizing operations PyTorch reports while
    ``set_sync_debug_mode`` is "warn"."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    torch.cuda.synchronize()
    # the mode's first use also warns that it is a prototype: not a sync
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    return allocs, syncs


def profile_kernels(fn, reps=20, before=None):
    """Device microseconds of each kernel launch of one ``fn`` call, in
    launch order (``name[i]`` for the i-th launch of a kernel launched
    more than once), means over ``reps`` calls from torch.profiler's CUDA
    activity; empty when the profiler records no device activity.
    ``before`` (an L2 flush) runs ahead of each call; its own launches
    are listed too."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    runs = collections.defaultdict(list)
    for ev in sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start):
        m = re.search(r"([A-Za-z_]\w*)(?:<[^()]*>)?\(", ev.name)
        runs[m.group(1) if m else ev.name[:40]].append(
            ev.time_range.elapsed_us())
    per = {}
    for name, times in runs.items():
        n = max(1, len(times) // reps)
        for i in range(n):
            per[f"{name}[{i}]" if n > 1 else name] = (
                statistics.fmean(times[i::n]))
    return per


def searched(plane_bytes, n, searches):
    """Bytes of a sorted plane of ``n`` entries that ``searches`` binary
    searches must read: a 32-byte sector per step, ceil(log2(n + 1))
    steps each, and never more than the whole plane."""
    return min(plane_bytes, 32 * math.ceil(math.log2(n + 1)) * searches)


def bound(nbytes, ops, op_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 + 2 ------------------------------------------------------------------


def environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    print(f"build {time.perf_counter() - t0:.3f} s -> {path.name}")
    return smi


# -- phase 3: kernels ---------------------------------------------------------------


def k1_case(rng, dev, kinds, dup, m, cdt, unique, shape):
    n_ch = len(kinds)
    n_src = 1 + n_ch - len(dup)
    if unique:
        cells = rng.choice(C_Q5 * B_Q5, m, replace=False)
        slots, bins = cells // B_Q5, cells % B_Q5
    else:  # duplicate cells and padding rows
        slots = rng.integers(0, C_Q5, m)
        bins = rng.integers(0, B_Q5, m)
    rowcnt = rng.integers(1, 40, m).astype(np.float64)
    if not unique:
        rowcnt[rng.random(m) < 0.1] = 0.0
    packed = np.empty((n_src, m))
    packed[0] = rowcnt
    packed[1:] = rng.normal(size=(n_src - 1, m)) * 1e3
    idx_t = torch.tensor(np.stack([slots, bins]).astype(np.int32), device=dev)
    packed_t = torch.tensor(packed, device=dev)
    values = torch.zeros((n_ch, C_Q5, B_Q5), dtype=torch.float64, device=dev)
    for j, k in enumerate(kinds):
        if k in ("min", "max"):
            values[j] = torch.finfo(torch.float64).max * (1 if k == "min"
                                                          else -1)
    counts = torch.zeros((C_Q5, B_Q5), dtype=cdt, device=dev)
    v_k, c_k = values.clone(), counts.clone()
    v_r, c_r = values.clone(), counts.clone()
    bin_update(v_k, c_k, idx_t, packed_t, kinds, dup)
    bin_update_reference(v_r, c_r, idx_t, packed_t, kinds, dup)
    torch.cuda.synchronize()
    check(torch.equal(c_k, c_r), f"bin_update counts differ ({shape})")
    err = 0.0
    for j, k in enumerate(kinds):
        if k in ("min", "max") or unique:
            check(torch.equal(v_k[j], v_r[j]),
                  f"bin_update channel {j} ({k}) not exact ({shape})")
        else:  # f64 sums of duplicate cells: atomics change the order
            torch.testing.assert_close(v_k[j], v_r[j], rtol=1e-12, atol=1e-9)
            err = max(err, float((v_k[j] - v_r[j]).abs().max()))

    ms = cuda_ms(lambda: bin_update(v_k, c_k, idx_t, packed_t, kinds, dup))
    plain = cuda_ms(lambda: bin_update_reference(v_r, c_r, idx_t, packed_t,
                                                 kinds, dup))
    library = None
    if all(k in ("count", "sum", "avg") for k in kinds) and n_ch == len(dup):
        s, b = idx_t[0].long(), idx_t[1].long()
        rc = packed_t[0].to(cdt)
        library = cuda_ms(lambda: c_r.index_put_((s, b), rc,
                                                 accumulate=True))
    valid = rowcnt > 0.5
    touched = len(np.unique((slots * B_Q5 + bins)[valid]))
    itemsize = torch.tensor([], dtype=cdt).element_size()
    nbytes = m * (8 + 8 * n_src) + touched * (16 * n_ch + 2 * itemsize)
    bms, by = bound(nbytes, int(valid.sum()) * n_ch, F64_OPS_PER_S)
    return {"name": "bin_update", "route": "cuda", "source": K1_SOURCE,
            "replaces": K1_REPLACES, "shape": shape,
            "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": library,
            "library_call": "index_put_" if library is not None else None}


def k2_case(rng, dev, kpad, minmax, cdt):
    W = WIDTH_MICROS // SLIDE_MICROS
    counts = torch.tensor(rng.poisson(2.0, (C_Q5, B_Q5)), dtype=cdt,
                          device=dev)
    ring_np = ((np.arange(kpad)[:, None] + np.arange(W)[None, :])
               % B_Q5).astype(np.int32)
    ok_np = np.ones((kpad, W), dtype=bool)
    ok_np[0, :2] = False  # the oldest bins of the first pane were evicted
    ring = torch.tensor(ring_np, device=dev)
    ok = torch.tensor(ok_np, device=dev)
    got = argmax_fire(counts, ring, ok, minmax)
    want = argmax_fire_reference(counts, ring, ok, minmax)
    torch.cuda.synchronize()
    shape = f"C={C_Q5} B={B_Q5} W={W} kpad={kpad} {minmax} {cdt}"
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"argmax_fire differs ({shape})")
    ms = cuda_ms(lambda: argmax_fire(counts, ring, ok, minmax))
    plain = cuda_ms(lambda: argmax_fire_reference(counts, ring, ok, minmax))
    itemsize = counts.element_size()
    nnz = got[0].shape[1]
    cols_read = len(np.unique(ring_np[ok_np]))
    nbytes = C_Q5 * cols_read * itemsize + nnz * (8 + itemsize)
    bms, by = bound(nbytes, C_Q5 * int(ok_np.sum()), F64_OPS_PER_S)
    return {"name": "argmax_fire", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES, "shape": shape + f" nnz={nnz}",
            "max_abs_err": 0.0, "ms": ms, "kernel_ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_call": None}


def row(name, source, replaces, shape, err, ms, plain, nbytes, ops,
        library, library_call):
    bms, by = bound(nbytes, ops, F64_OPS_PER_S)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": library,
            "library_call": library_call if library is not None else None}


def bin_planes(rng, dev, kinds, C, B, cdt):
    """Bin-ring planes: data in 3 of 4 cells, identities elsewhere."""
    values = torch.empty((len(kinds), C, B), dtype=torch.float64, device=dev)
    for j, k in enumerate(kinds):
        values[j] = torch.tensor(rng.normal(size=(C, B)) * 100, device=dev)
        values[j][torch.tensor(rng.random((C, B)) < 0.25, device=dev)] = \
            channel_identity(k)
    counts = torch.tensor(rng.poisson(2.0, (C, B)), dtype=cdt, device=dev)
    return values, counts


def row_sectors(itemsize, B, cols):
    """32-byte sectors of one B-cell row that the ring columns ``cols``
    touch (rows start on a sector: B * itemsize is a multiple of 32)."""
    check(B * itemsize % SECTOR == 0, f"rows of {B * itemsize} bytes")
    return len({c * itemsize // SECTOR for c in cols})


def run_sectors(nbytes):
    """Bytes of the 32-byte sectors a contiguous run of ``nbytes`` fills."""
    return -(-nbytes // SECTOR) * SECTOR


def row_atoms(itemsize, B, cols):
    """HBM3's 64-byte access atoms that the ring columns ``cols`` of one
    B-cell row touch, as a fraction of an atom when rows are shorter
    (rows start on an atom or share one whole)."""
    row = B * itemsize
    if row < ATOM:
        return row / ATOM
    return len({c * itemsize // ATOM for c in cols})


def atom_bound_ms(read_atoms, partial_atoms, full_bytes):
    """The least time IF memory moves whole 64-byte atoms (a model, not
    measured here): atoms read, atoms partly written (read, then written
    back whole), and bytes written in whole atoms."""
    return ((read_atoms + 2 * partial_atoms) * ATOM + full_bytes) \
        / HBM_BYTES_PER_S * 1e3


def parent_kernels(parent):
    """The parent commit's kernel modules, from a ``git archive`` of it
    unpacked at ``parent``: its ``arroyo_tpu_torch/kernels`` imported as
    the package ``parent_kernels`` and built from its own csrc/ into its
    own build/ directory.  Returns a namespace of its pane_emit,
    bin_evict, segment_agg and expand_gather and the build seconds."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(parent), "arroyo_tpu_torch", "kernels")
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_kernels"] = mod
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    importlib.import_module("parent_kernels.build").load()
    secs = time.perf_counter() - t0
    names = ("pane_emit", "bin_evict", "segment_agg", "expand_gather")
    return argparse.Namespace(build_s=secs, **{
        name: getattr(importlib.import_module(f"parent_kernels.{name}"), name)
        for name in names})


def measured(fn, kernel):
    """What a row reports of one wrapper: host microseconds a call (200
    calls queued, no sync between them), torch.profiler's device
    microseconds of each launch — warm, and cold: after writing 64 MiB,
    more than the H100's 50 MB L2 holds, as a fire finds the planes after
    a stretch of other work (``kernel``'s launches only) — and
    allocations and host syncs a call."""
    allocs, syncs = per_call(fn)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    cold = profile_kernels(fn, before=flush.zero_)
    return {"host_us_per_call": host_us(fn, reps=200),
            "device_us_per_call": profile_kernels(fn),
            "device_us_cold": {n: us for n, us in cold.items() if kernel in n},
            "allocations_per_call": allocs, "syncs_per_call": syncs}


def pane_emit_split(args, library):
    """Where a pane_emit call's host time goes: microseconds of its
    argument checks, its one allocation, the launch alone (ctypes,
    cudaLaunchKernel) into a buffer made beforehand, the whole wrapper,
    and the library call."""
    values, counts, first_bin, lo, hi, W, k, kinds, xfer, c_slice = args
    dev = values.device
    nbytes = (8 * len(xfer) + counts.element_size()) * c_slice * k
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    spec = pane_emit_mod._check(values, counts, W, k, kinds, xfer, c_slice)
    return {
        "check_us": host_us(lambda: pane_emit_mod._check(
            values, counts, W, k, kinds, xfer, c_slice)),
        "alloc_us": host_us(lambda: torch.empty(nbytes, dtype=torch.uint8,
                                                device=dev)),
        "launch_us": host_us(lambda: pane_emit_mod._launch(
            values, counts, spec, first_bin, lo, hi, W, k, c_slice, buf)),
        "wrapper_us": host_us(lambda: pane_emit(*args)),
        "library_us": host_us(library)}


def k3_case(rng, dev, kinds, xfer, C, B, W, k, c_slice, cdt, geometry,
            shape, parent=None):
    """K3 on one fire: ``geometry`` (first_bin, lo, hi) as fire_panes
    passes it.  Exact against the plain version (f64 sums rtol 1e-12),
    one launch, one allocation and no host sync a call; timed in turns
    with its library call where one exists and, with ``parent``, with the
    parent commit's kernel."""
    values, counts = bin_planes(rng, dev, kinds, C, B, cdt)
    first_bin, lo, hi = geometry
    args = (values, counts, first_bin, lo, hi, W, k, kinds, xfer, c_slice)
    before = pane_emit.launches
    got = pane_views(pane_emit(*args), len(xfer), c_slice, k, cdt)
    launches = pane_emit.launches - before
    want = pane_emit_reference(*args)
    torch.cuda.synchronize()
    check(launches == 1, f"pane_emit made {launches} launches ({shape})")
    check(torch.equal(got[1], want[1]), f"pane_emit counts differ ({shape})")
    err = 0.0
    for r, j in enumerate(xfer):
        if kinds[j] in ("min", "max"):
            check(torch.equal(got[0][r], want[0][r]),
                  f"pane_emit channel {j} ({kinds[j]}) not exact ({shape})")
        else:  # f64 sums over W bins: rtol 1e-12 (summation order)
            torch.testing.assert_close(got[0][r], want[0][r], rtol=1e-12,
                                       atol=1e-9)
            err = max(err, float((got[0][r] - want[0][r]).abs().max()))
    ring_np, ok_np = fire_geometry(first_bin, lo, hi, W, k, B)
    live = np.unique(ring_np[ok_np])

    def kernel():
        return pane_emit(*args)

    library, library_call = None, None
    planes = [counts[:c_slice]] + [values[j, :c_slice] for j in xfer]
    cols = torch.tensor(live, device=dev)
    if W == 1:  # one index_select per plane reads the pane's one column
        def library():
            return [p.index_select(1, cols) for p in planes]
        library_call = "index_select per plane"
    elif k == 1 and not xfer:  # the pane's W columns of counts, summed
        def library():
            return counts[:c_slice].index_select(1, cols).sum(1)
        library_call = "counts[:c_slice].index_select(1, cols).sum(1)"
    if library is not None:
        ms, lib, turns = in_turns(kernel, library)
    else:
        ms, lib, turns = cuda_ms(kernel), None, None
    plain = cuda_ms(lambda: pane_emit_reference(*args))
    meas = measured(kernel, "pane_emit")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"pane_emit made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    item = counts.element_size()
    n_read = (row_sectors(item, B, live)
              + len(xfer) * row_sectors(8, B, live)) * SECTOR * c_slice
    n_write = (run_sectors(8 * len(xfer) * c_slice * k)
               + run_sectors(item * c_slice * k))
    ops = c_slice * int(ok_np.sum()) * (1 + len(xfer))
    r = row("pane_emit", K3_SOURCE, K3_REPLACES, shape, err, ms, plain,
            n_read + n_write, ops, lib, library_call)
    atoms = c_slice * (row_atoms(item, B, live)
                       + len(xfer) * row_atoms(8, B, live))
    r.update(turns_ms=turns, launches_per_call=launches,
             bound_bytes=n_read + n_write,
             atom_bound_ms=atom_bound_ms(atoms, 0, n_write), **meas)
    if library is not None:
        r["library_device_us"] = profile_kernels(library)
        r["library_turns"] = turn_factors(turns)
    if W == 1:
        r["host_split"] = pane_emit_split(args, library)
    if parent is not None:  # the same kernel: the A/A noise of a turn
        pe = parent.pane_emit
        p_out = pane_views(pe(*args), len(xfer), c_slice, k, cdt)
        torch.cuda.synchronize()
        check(torch.equal(p_out[1], got[1]) and torch.equal(p_out[0], got[0]),
              f"pane_emit differs from the parent's ({shape})")
        c_ms, p_ms, p_turns = in_turns(kernel, lambda: pe(*args))
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       **measured(lambda: pe(*args), "pane_emit")}
    print(f"pane_emit {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms", "bound_bytes",
                                 "atom_bound_ms", "library_device_us",
                                 "host_us_per_call", "device_us_per_call",
                                 "device_us_cold", "allocations_per_call",
                                 "syncs_per_call", "host_split", "parent")
                  if key in r}))
    return r


def k4_case(rng, dev, kinds, C, B, first_bin, n_bins, rows, cdt, shape,
            parent=None):
    """K4 on one eviction of the bins first_bin .. first_bin + n_bins - 1
    over the first ``rows`` slots: exact against the plain version, the
    rows past ``rows`` untouched, one launch, no allocation and no host
    sync a call; timed in turns with ``index_fill_`` per plane over the
    same rows and, with ``parent``, with the parent commit's kernel."""
    values, counts = bin_planes(rng, dev, kinds, C, B, cdt)
    tail_v, tail_c = values[:, rows:].clone(), counts[rows:].clone()
    v_r, c_r = values.clone(), counts.clone()
    before = bin_evict.launches
    bin_evict(values, counts, first_bin, n_bins, rows, kinds)
    launches = bin_evict.launches - before
    bin_evict_reference(v_r, c_r, first_bin, n_bins, rows, kinds)
    torch.cuda.synchronize()
    check(launches == 1, f"bin_evict made {launches} launches ({shape})")
    check(torch.equal(counts, c_r) and torch.equal(values, v_r),
          f"bin_evict differs ({shape})")
    check(torch.equal(values[:, rows:], tail_v)
          and torch.equal(counts[rows:], tail_c),
          f"bin_evict wrote past its {rows} rows ({shape})")
    del v_r, c_r, tail_v, tail_c
    cols = sorted({(first_bin + i) % B for i in range(min(n_bins, B))})
    col64 = torch.tensor(cols, device=dev)

    def kernel():
        bin_evict(values, counts, first_bin, n_bins, rows, kinds)

    def library():  # one index_fill_ per plane, over the same rows
        counts[:rows].index_fill_(1, col64, 0)
        for j, kind in enumerate(kinds):
            values[j, :rows].index_fill_(1, col64, channel_identity(kind))

    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: bin_evict_reference(values, counts, first_bin,
                                                n_bins, rows, kinds))
    meas = measured(kernel, "bin_evict")
    check(meas["allocations_per_call"] == 0 and meas["syncs_per_call"] == 0,
          f"bin_evict made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    # stores only; a sector partly written counts as one 32-byte sector
    nbytes = rows * SECTOR * (row_sectors(counts.element_size(), B, cols)
                              + len(kinds) * row_sectors(8, B, cols))
    r = row("bin_evict", K4_SOURCE, K4_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "index_fill_ per plane")
    atoms = rows * (row_atoms(counts.element_size(), B, cols)
                    + len(kinds) * row_atoms(8, B, cols))
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches, bound_bytes=nbytes,
             atom_bound_ms=atom_bound_ms(0, atoms, 0),
             library_device_us=profile_kernels(library), **meas)
    if parent is not None:  # the same kernel: the A/A noise of a turn
        be = parent.bin_evict
        p_v, p_c = values.clone(), counts.clone()
        be(p_v, p_c, first_bin, n_bins, rows, kinds)
        torch.cuda.synchronize()
        check(torch.equal(p_v, values) and torch.equal(p_c, counts),
              f"bin_evict differs from the parent's ({shape})")
        del p_v, p_c

        def parent_call():
            be(values, counts, first_bin, n_bins, rows, kinds)

        c_ms, p_ms, p_turns = in_turns(kernel, parent_call)
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       **measured(parent_call, "bin_evict")}
    print(f"bin_evict {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms", "bound_bytes",
                                 "atom_bound_ms", "library_device_us",
                                 "host_us_per_call", "device_us_per_call",
                                 "device_us_cold", "allocations_per_call",
                                 "syncs_per_call", "parent") if key in r}))
    return r


def k5_case(rng, dev, cap, nf, ni, shape):
    """Positions as the join state computes them for a resident run of
    0.6 cap and a delta of 0.2 cap: a permutation of the merged run,
    unused resident slots at cap, delta padding at cap and beyond."""
    n_res, m = int(cap * 0.6), int(cap * 0.2)
    db = 1 << (m - 1).bit_length()
    perm = rng.permutation(n_res + m)
    res_pos = np.full(cap, cap, np.int64)
    res_pos[:n_res] = np.sort(perm[:n_res])
    delta_pos = np.full(db, cap + 7, np.int64)
    delta_pos[:m] = np.sort(perm[n_res:])
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    i32 = lambda n: t(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32))  # noqa: E731
    stacks = (None,) * 4
    if nf or ni:
        stacks = (t(rng.normal(size=(nf, cap))),
                  t(rng.integers(-2**62, 2**62, (ni, cap))),
                  t(rng.normal(size=(nf, db))),
                  t(rng.integers(-2**62, 2**62, (ni, db))))
    args = (i32(cap), i32(cap), stacks[0], stacks[1], t(res_pos), i32(db),
            i32(db), stacks[2], stacks[3], t(delta_pos))
    got, want = ring_merge(*args), ring_merge_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        check((g is None and w is None) or torch.equal(g, w),
              f"ring_merge differs ({shape})")
    ms = cuda_ms(lambda: ring_merge(*args))
    plain = cuda_ms(lambda: ring_merge_reference(*args))
    rp, dp = args[4][:n_res], args[9][:m]
    outs = [g.clone() for g in got if g is not None]
    srcs = [(args[0], args[5]), (args[1], args[6])]
    if nf or ni:
        srcs += [(args[2], args[7]), (args[3], args[8])]

    def library():  # index_copy_ per plane: resident, then delta
        for out, (res, delta) in zip(outs, srcs):
            dim = out.dim() - 1
            out.index_copy_(dim, rp, res[..., :n_res])
            out.index_copy_(dim, dp, delta[..., :m])

    lib = cuda_ms(library)
    width = 8 + 8 * (nf + ni)  # hi + lo + one 8-byte word per stack row
    nbytes = cap * (2 * width + 8) + db * (width + 8)
    return row("ring_merge", K5_SOURCE, K5_REPLACES, shape, 0.0, ms, plain,
               nbytes, 0, lib, "index_copy_ per plane, resident then delta")


def launch_split(idx, f, i):
    """Where a ring_gather call's time goes: host microseconds of each
    step of the wrapper, the whole wrapper and the bare ctypes call; the
    kernel's device time from torch.profiler; and CUDA-event ms of the
    wrapper and the bare call."""
    m, nf, ni, cap = idx.shape[0], f.shape[0], i.shape[0], f.shape[1]
    dev = idx.device
    fn = ring_gather_mod._c_fn()
    rows = torch.empty((nf + ni, m), dtype=torch.int64, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (idx.data_ptr(), m, f.data_ptr(), i.data_ptr(), nf, ni, cap,
            rows.data_ptr(), stream)

    def bare():
        return fn(*args)

    return {
        "check_us": host_us(lambda: ring_gather_mod._check(idx, f, i)),
        "alloc_us": host_us(lambda: torch.empty(
            (nf + ni, m), dtype=torch.int64, device=dev)),
        "device_and_stream_us": host_us(lambda: (
            torch._C._cuda_getDevice(),
            torch._C._cuda_getCurrentRawStream(dev.index))),
        "ctypes_launch_us": host_us(bare),
        "views_us": host_us(lambda: (rows[:nf].view(torch.float64),
                                     rows[nf:])),
        "wrapper_us": host_us(lambda: ring_gather(idx, f, i)),
        "index_select_pair_us": host_us(
            lambda: (f.index_select(1, idx), i.index_select(1, idx))),
        "device_us": profile_kernels(lambda: ring_gather(idx, f, i)),
        "wrapper_event_ms": cuda_ms(lambda: ring_gather(idx, f, i)),
        "bare_event_ms": cuda_ms(bare),
    }


def k6_case(rng, dev, cap, nf, ni, m, shape):
    f = torch.tensor(rng.normal(size=(nf, cap)), device=dev)
    i = torch.tensor(rng.integers(-2**62, 2**62, (ni, cap)), device=dev)
    idx = torch.tensor(np.sort(rng.integers(0, cap, m)), device=dev)
    before = ring_gather.launches
    got, want = ring_gather(idx, f, i), ring_gather_reference(idx, f, i)
    torch.cuda.synchronize()
    launches = ring_gather.launches - before
    check(launches == 1, f"ring_gather made {launches} launches")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"ring_gather differs ({shape})")
    check(got[0].untyped_storage().data_ptr()
          == got[1].untyped_storage().data_ptr()
          and got[1].data_ptr() == got[0].data_ptr() + nf * m * 8,
          "ring_gather's outputs are not views of one buffer")
    allocs, syncs = per_call(lambda: ring_gather(idx, f, i))
    check(allocs == 1 and syncs == 0,
          f"ring_gather made {allocs} allocations and {syncs} host syncs")
    ms, lib, turns = in_turns(
        lambda: ring_gather(idx, f, i),
        lambda: (f.index_select(1, idx), i.index_select(1, idx)))
    plain = cuda_ms(lambda: ring_gather_reference(idx, f, i))
    split = launch_split(idx, f, i)
    print("ring_gather launch path: " + json.dumps(split))
    nbytes = m * 8 + 2 * m * 8 * (nf + ni)
    r = row("ring_gather", K6_SOURCE, K6_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "index_select per stack")
    r.update(turns_ms=turns, launches_per_call=launches,
             syncs_per_call=syncs, allocations_per_call=allocs,
             launch_split=split)
    return r


def k7_case(rng, dev, n, n_keys, shape):
    """Interval rows sorted by (key, start) with u64-hash keys (as int64
    bit views), micros starts, ends a gap past them, a tenth touching
    their predecessor."""
    keys = rng.integers(-2**63, 2**63 - 1, n_keys, dtype=np.int64)
    kh = np.sort(rng.choice(keys, n))
    st = rng.integers(1_700_000_000_000_000, 1_700_000_100_000_000, n)
    o = np.lexsort((st, kh))
    kh, st = kh[o], st[o]
    en = st + rng.integers(1, 2 * GAP_MICROS, n)
    touch = np.nonzero(rng.random(n - 1) < 0.1)[0] + 1
    st[touch] = en[touch - 1]
    o = np.lexsort((st, kh))
    kh, st, en = (torch.tensor(a[o], device=dev) for a in (kh, st, en))
    got = session_union(kh, st, en)
    want = session_union_reference(kh, st, en)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"session_union differs ({shape})")
    ms = cuda_ms(lambda: session_union(kh, st, en))
    plain = cuda_ms(lambda: session_union_reference(kh, st, en))
    # three i64 planes read, one i64 plane and one flag byte written; the
    # int64 compares and maxes have no published peak rate, so the bound
    # counts bytes only
    return row("session_union", K7_SOURCE, K7_REPLACES,
               shape + f" sessions={int(got[0].sum())}", 0.0, ms, plain,
               n * (3 * 8 + 8 + 1), 0, None, None)


def k8_case(rng, dev, n, n_seg, kinds, shape, parent=None):
    """K8 on one reduce: counts, min and max exact against the plain
    version, sums within rtol 1e-12 of math.fsum and bit-equal across two
    calls, one launch, one allocation and no host sync a call; timed in
    turns with its library call and, with ``parent``, with the parent
    commit's kernel and the parent's reduce as its caller made it (two
    uploads, the kernel, two readbacks) against this one (one upload, the
    kernel, one readback)."""
    cuts = np.sort(rng.choice(np.arange(1, n), n_seg - 1, replace=False))
    offsets_np = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    offsets = torch.tensor(offsets_np, device=dev)
    reduced = [c for c, k in enumerate(kinds) if k != "count"]
    # one value row per channel that is not a count (count reads none)
    values_np = rng.normal(size=(len(reduced), n)) * 1e3
    values = torch.tensor(values_np, device=dev).reshape(len(reduced), n)
    before = segment_agg.launches
    got = segment_agg(values, offsets, kinds)
    launches = segment_agg.launches - before
    again = segment_agg(values, offsets, kinds)
    want = segment_agg_reference(values, offsets, kinds)
    torch.cuda.synchronize()
    check(launches == 1, f"segment_agg made {launches} launches ({shape})")
    check(torch.equal(got[1], want[1]), f"segment_agg counts differ "
          f"({shape})")
    check(torch.equal(got[0], again[0]), f"segment_agg is not bit-equal "
          f"across two calls ({shape})")
    err = 0.0
    for c, k in enumerate(kinds):
        if k == "sum":
            # f64 sums in the kernel's fixed order against the correctly
            # rounded sums (math.fsum): rtol 1e-12, stable from run to
            # run.  The plain version's index_add_ adds in another order
            # on every run (atomics); an order change moves a sum by ulps
            # of the segment's sum of |x|, ~1,000x its |sum| at 2^20
            # zero-mean rows, so against it: 1e-12 of sum |x| + 1e-9
            r = reduced.index(c)
            exact = torch.tensor([math.fsum(values_np[r, a:b]) for a, b in zip(
                offsets_np[:-1], offsets_np[1:])], dtype=torch.float64,
                device=dev)
            torch.testing.assert_close(got[0][c], exact, rtol=1e-12,
                                       atol=1e-9)
            l1 = segment_agg_reference(values[r:r + 1].abs(), offsets,
                                       ("sum",))[0][0]
            diff = (got[0][c] - want[0][c]).abs()
            check(bool((diff <= 1e-9 + 1e-12 * l1).all()),
                  f"segment_agg channel {c} (sum) differs by "
                  f"{float(diff.max())} ({shape})")
            err = max(err, float(diff.max()))
        else:
            check(torch.equal(got[0][c], want[0][c]),
                  f"segment_agg channel {c} ({k}) not exact ({shape})")

    def kernel():  # the call the segment reduce makes: one buffer
        return segment_agg_buffer(values, offsets, kinds)

    check(torch.equal(kernel()[0], got[1]) and torch.equal(
        kernel()[1:].view(torch.float64), got[0]),
        f"segment_agg_buffer differs from segment_agg ({shape})")
    if not reduced:  # every channel counts rows: the lengths, as f64
        def library():
            return torch.diff(offsets).double()
        library_call = "torch.diff(offsets).double()"
    else:
        lengths = offsets[1:] - offsets[:-1]

        def library():
            return [torch.segment_reduce(values[r], kinds[c], lengths=lengths)
                    for r, c in enumerate(reduced)]
        library_call = "segment_reduce per sum/min/max channel"
    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: segment_agg_reference(values, offsets, kinds))
    meas = measured(kernel, "segment_")
    public = per_call(lambda: segment_agg(values, offsets, kinds))
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0
          and public == (1, 0),
          f"segment_agg made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs, the (out, counts) form "
          f"{public} ({shape})")
    meas["tuple_form_host_us"] = host_us(
        lambda: segment_agg(values, offsets, kinds), reps=200)
    nbytes = (len(reduced) * n * 8 + offsets_np.nbytes
              + len(kinds) * n_seg * 8 + n_seg * 8)
    r = row("segment_agg", K8_SOURCE, K8_REPLACES, shape, err, ms, plain,
            nbytes, len(reduced) * n, lib, library_call)
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches,
             library_device_us=profile_kernels(library), **meas)
    if parent is not None:
        pa = parent.segment_agg
        p_out = pa(values, offsets, kinds)
        torch.cuda.synchronize()
        check(torch.equal(p_out[1], got[1]) and all(
            torch.equal(p_out[0][c], got[0][c]) for c, k in enumerate(kinds)
            if k != "sum"), f"segment_agg differs from the parent's ({shape})")
        c_ms, p_ms, p_turns = in_turns(kernel, lambda: pa(values, offsets,
                                                          kinds))
        rows_np = [values_np[i] for i in range(len(reduced))]
        seg_start = offsets_np[:-1]

        def parent_reduce():  # the parent's ops/segment._reduce
            vals = np.empty((len(rows_np), n), dtype=np.float64)
            for i, row_np in enumerate(rows_np):
                vals[i] = row_np
            offs = np.append(seg_start, n).astype(np.int64)
            o, c = pa(torch.tensor(vals, device=dev),
                      torch.tensor(offs, device=dev), tuple(kinds))
            return o.cpu().numpy(), c.cpu().numpy()

        def reduce():  # this ops/segment._reduce
            return segment_reduce(list(kinds), rows_np, seg_start, n, dev)

        red_ms, p_red_ms, red_turns = in_turns(reduce, parent_reduce)
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       "reduce_ms": p_red_ms, "change_reduce_ms": red_ms,
                       "reduce_turns_ms": red_turns,
                       "reduce_factors": turn_factors(red_turns),
                       **measured(lambda: pa(values, offsets, kinds),
                                  "segment_agg")}
    print(f"segment_agg {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms",
                                 "library_device_us", "host_us_per_call",
                                 "device_us_per_call", "device_us_cold",
                                 "allocations_per_call", "syncs_per_call",
                                 "tuple_form_host_us", "parent")
                  if key in r}))
    return r


def join_cases(rng, dev, cap, n_valid, mq, m, span, ni, shape,
               parent=None):
    """K9-K11 on one ring probe: a sorted ring of ``n_valid`` keys drawn
    from ``span`` values (repeats), sorted queries from the same values
    (a fifth of them absent), a third sharing a ring row's lo."""
    sent = 0x7FFFFFFF
    hi_np = np.full(cap, sent, np.int32)
    hi_np[:n_valid] = np.sort(rng.integers(0, span, n_valid) * 2)
    lo_np = rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)
    q_np = np.full(mq, sent, np.int32)
    miss = (rng.random(m) < 0.2) & (span > 1)
    q_np[:m] = np.sort(rng.integers(0, span, m) * 2 + miss)
    ql_np = rng.integers(-2**31, 2**31 - 1, mq).astype(np.int32)
    pick = np.minimum(np.searchsorted(hi_np[:n_valid], q_np), n_valid - 1)
    own = rng.random(mq) < 0.33
    ql_np[own] = lo_np[pick[own]]
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    hi, lo, q_hi, q_lo = t(hi_np), t(lo_np), t(q_np), t(ql_np)
    ist = t(rng.integers(-2**62, 2**62, (ni, cap)))
    fst = torch.zeros((0, cap), dtype=torch.float64, device=dev)
    got = join_probe(q_hi, hi, m, n_valid)
    want = join_probe_reference(q_hi, hi, m, n_valid)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"join_probe differs ({shape})")
    start, counts, cum = want
    total = int(cum[-1])
    check(total > 0, f"join case has no candidate pair ({shape})")
    n_q = int(torch.unique(q_hi).numel())  # distinct searched values
    shape = f"{shape} total={total}"
    pairs = join_expand(start, cum, total)
    check(all(torch.equal(g, w) for g, w in zip(
        pairs, join_expand_reference(start, cum, total))),
        f"join_expand differs ({shape})")
    eg_args = (start, cum, total, hi, lo, q_hi, q_lo, fst, ist)
    want = expand_gather_reference(*eg_args)
    distinct = int(torch.unique(want[1]).numel())
    used = int(torch.unique(want[0]).numel())  # queries with a pair
    c64 = counts.long()

    def lib_probe():
        s_ = torch.searchsorted(hi, q_hi)
        e_ = torch.searchsorted(hi, q_hi, right=True)
        return torch.cumsum(e_ - s_, 0)

    def lib_expand():
        lidx = torch.repeat_interleave(c64, output_size=total)
        j = torch.arange(total, device=dev)
        return lidx, start[lidx] + j - (cum - c64)[lidx]

    def lib_gather():
        lidx, ridx = lib_expand()
        ridx = ridx.clamp(0, cap - 1)
        ok = (hi[ridx] == q_hi[lidx]) & (lo[ridx] == q_lo[lidx])
        return ok, fst.index_select(1, ridx), ist.index_select(1, ridx)

    rows = []
    for name, src, rep, fn, plain, lib, call, nbytes in (
            ("join_probe", K9_SOURCE, K9_REPLACES,
             lambda: join_probe(q_hi, hi, m, n_valid),
             lambda: join_probe_reference(q_hi, hi, m, n_valid), lib_probe,
             "searchsorted x2 + cumsum",
             4 * mq + searched(4 * cap, cap, 2 * n_q) + 16 * mq),
            ("join_expand", K10_SOURCE, K10_REPLACES,
             lambda: join_expand(start, cum, total),
             lambda: join_expand_reference(start, cum, total), lib_expand,
             "repeat_interleave + arange",
             4 * used + searched(8 * mq, mq, used) + 16 * total)):
        rows.append(row(name, src, rep, shape, 0.0, cuda_ms(fn),
                        cuda_ms(plain), nbytes, 0, cuda_ms(lib), call))
    rows.append(k11_case(eg_args, want, lib_gather, shape,
                         12 * used + searched(8 * mq, mq, used)
                         + distinct * (8 + 8 * ni) + total * (17 + 8 * ni),
                         parent))
    return rows


def expand_gather_split(args):
    """Where an expand_gather call's host time goes: microseconds of its
    argument checks, its one allocation, the launch alone into a buffer
    made beforehand (ctypes' conversion of its 15 arguments and
    cudaLaunchKernel), the ctypes call alone (the same arguments with no
    pairs: the launcher returns before launching), the whole wrapper and
    the five views of the tuple form;
    and the ctypes calls alone of three launchers that take 7, 9 and 15
    arguments, with the slope of a line through them: ctypes' cost of one
    argument."""
    start, cum, total, hi, lo, q_hi, q_lo, fstack, istack = args
    mq, cap, nf, ni = expand_gather_mod._check(*args)
    words = expand_gather_mod.buffer_words(total, nf, ni)
    buf = torch.empty(words, dtype=torch.int64, device=start.device)
    stream = torch._C._cuda_getCurrentRawStream(start.device.index)
    eg = expand_gather_mod._c_fn()
    eg_args = [start.data_ptr(), cum.data_ptr(), mq, total, hi.data_ptr(),
               lo.data_ptr(), cap, q_hi.data_ptr(), q_lo.data_ptr(),
               fstack.data_ptr(), nf, istack.data_ptr(), ni, buf.data_ptr(),
               stream]
    idle = {  # (arguments, the launcher called with no work)
        7: (join_expand_mod._c_fn(), [start.data_ptr(), cum.data_ptr(), mq,
                                      0, buf.data_ptr(), buf.data_ptr(),
                                      stream]),
        9: (ring_gather_mod._c_fn(), [buf.data_ptr(), 0, fstack.data_ptr(),
                                      istack.data_ptr(), nf, ni, cap,
                                      buf.data_ptr(), stream]),
        15: (eg, eg_args[:3] + [0] + eg_args[4:])}
    idle_us = {n_args: host_us(lambda fn=fn, a=a: fn(*a))
               for n_args, (fn, a) in idle.items()}
    xs = sorted(idle_us)
    mx = statistics.fmean(xs)
    my = statistics.fmean(idle_us[x] for x in xs)
    slope = (sum((x - mx) * (idle_us[x] - my) for x in xs)
             / sum((x - mx) ** 2 for x in xs))
    return {
        "check_us": host_us(lambda: expand_gather_mod._check(*args)),
        "alloc_us": host_us(lambda: torch.empty(words, dtype=torch.int64,
                                                device=start.device)),
        "launch_us": host_us(lambda: expand_gather_mod._launch(
            start, cum, mq, total, hi, lo, cap, q_hi, q_lo, fstack, nf,
            istack, ni, buf)),
        "bare_launch_us": host_us(lambda: eg(*eg_args)),
        "ctypes_call_us_by_arguments": idle_us,
        "ctypes_us_per_argument": slope,
        "wrapper_us": host_us(lambda: expand_gather_buffer(*args)),
        "views_us": host_us(lambda: expand_views(buf, total, nf, ni))}


def k11_case(args, want, library, shape, nbytes, parent=None):
    """K11 on one probe's expansion: all five outputs bit-equal to the
    plain version as views of one buffer, one launch, one allocation and
    no host sync a call; timed in turns with its library calls and, with
    ``parent``, with the parent commit's kernel and the parent's caller
    (the kernel, five readbacks) against this one (the kernel into one
    buffer, one readback); its host split."""
    start, cum, total, hi, lo, q_hi, q_lo, fstack, istack = args
    nf, ni = fstack.shape[0], istack.shape[0]
    before = expand_gather.launches
    got = expand_gather(*args)
    launches = expand_gather.launches - before
    torch.cuda.synchronize()
    check(launches == 1, f"expand_gather made {launches} launches ({shape})")
    check(all(g.dtype == w.dtype and torch.equal(g, w)
              for g, w in zip(got, want)),
          f"expand_gather differs ({shape})")
    check(len({g.untyped_storage().data_ptr() for g in got}) == 1,
          "expand_gather's outputs are not views of one buffer")

    def kernel():  # the call the join makes: one buffer
        return expand_gather_buffer(*args)

    check(all(torch.equal(v, w) for v, w in zip(
        expand_views(kernel(), total, nf, ni), want)),
        f"expand_gather_buffer's views differ ({shape})")
    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: expand_gather_reference(*args))
    meas = measured(kernel, "expand_gather")
    public = per_call(lambda: expand_gather(*args))
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0
          and public == (1, 0),
          f"expand_gather made {meas['allocations_per_call']} allocations "
          f"and {meas['syncs_per_call']} host syncs, the five-view form "
          f"{public} ({shape})")
    meas["tuple_form_host_us"] = host_us(lambda: expand_gather(*args),
                                         reps=200)
    r = row("expand_gather", K11_SOURCE, K11_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib,
            "repeat_interleave + arange + index_select per stack")
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches, bound_bytes=nbytes,
             library_device_us=profile_kernels(library), **meas,
             host_split=expand_gather_split(args))
    if parent is not None:
        pe = parent.expand_gather
        p_out = pe(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(p_out, got)),
              f"expand_gather differs from the parent's ({shape})")
        c_ms, p_ms, p_turns = in_turns(kernel, lambda: pe(*args))

        def parent_read():  # the parent's ops/join.expand_gather
            return tuple(x.cpu().numpy() for x in pe(*args))

        def read():  # this ops/join.expand_gather
            return expand_views(to_host(expand_gather_buffer(*args)), total,
                                nf, ni)

        read_ms, p_read_ms, read_turns = in_turns(read, parent_read)
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       "read_ms": p_read_ms, "change_read_ms": read_ms,
                       "read_turns_ms": read_turns,
                       "read_factors": turn_factors(read_turns),
                       **measured(lambda: pe(*args), "expand_gather")}
    print(f"expand_gather {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms", "bound_bytes",
                                 "library_device_us", "host_us_per_call",
                                 "device_us_per_call", "device_us_cold",
                                 "allocations_per_call", "syncs_per_call",
                                 "tuple_form_host_us", "host_split",
                                 "parent") if key in r}))
    return r


def bid_counts(rng, n):
    """TopN input values as a hot-items fire gives them: bids per auction
    in a window — mostly a few, some hot auctions far more, heavy ties."""
    v = rng.geometric(0.35, n).astype(np.float64)
    hot = rng.random(n) < 0.002
    v[hot] = rng.integers(50, 900, int(hot.sum()))
    return v


def topk_case(rng, dev, n, n_seg, shape):
    """K12 at a hot-items fire's size: ``n`` rows over ``n_seg`` windows,
    k = 10; exact against the plain version."""
    seg = torch.tensor(rng.integers(0, n_seg, n).astype(np.int32),
                       device=dev)
    val = torch.tensor(bid_counts(rng, n), device=dev)
    got = segment_top_k(seg, val, TOP_K)
    tally = (segment_top_k.last_launches, segment_top_k.last_syncs)
    want = segment_top_k_reference(seg, val, TOP_K)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"segment_top_k differs ({shape})")
    check(tally[0] <= 6 and tally[1] == 1,
          f"segment_top_k's prefilter path took {tally[0]} launches and "
          f"{tally[1]} host syncs ({shape})")
    allocs, syncs = per_call(lambda: segment_top_k(seg, val, TOP_K))
    check(syncs == tally[1],
          f"segment_top_k counted {tally[1]} host syncs, PyTorch saw "
          f"{syncs} ({shape})")
    keys = order_keys(val)

    def library():  # two stable sorts give the kept rows' order
        by_val = torch.sort(keys, stable=True).indices
        return torch.sort(seg[by_val], stable=True)

    ms, lib, turns = in_turns(lambda: segment_top_k(seg, val, TOP_K),
                              library)
    plain = cuda_ms(lambda: segment_top_k_reference(seg, val, TOP_K))
    device = profile_kernels(lambda: segment_top_k(seg, val, TOP_K))
    host = host_us(lambda: segment_top_k(seg, val, TOP_K), reps=200)
    grid = _round_grid_cap(dev.index)
    print(f"segment_top_k {shape}: {tally[0]} launches, {syncs} host "
          f"syncs, {allocs} allocations per call, round grid <= {grid} "
          f"blocks; kernel {ms:.4f} ms, two "
          f"sorts {lib:.4f} ms; host us per call {host:.1f}; device us per "
          "call " + json.dumps(device))
    # an i32 segment id and an f64 value read a row, an i32 index written
    # a kept row; the compares have no published peak rate
    r = row("segment_top_k", K12_SOURCE, K12_REPLACES,
            f"{shape} kept={got.numel()}", 0.0, ms, plain,
            12 * n + 4 * got.numel(), 0, lib, "two stable torch.sort")
    r.update(turns_ms=turns, launches_per_call=tally[0],
             syncs_per_call=syncs, allocations_per_call=allocs,
             host_us_per_call=host, device_us_per_call=device,
             round_grid_blocks=grid)
    return r


def compact_cases(rng, dev, k, rows, shape):
    """K13/K14 at hot items' compact fires: C_HOT slots, the first
    ``rows`` occupied, a COUNT(*) counts plane whose pane cells are live
    with probability HOT_DENSITY.  Exact against the plain versions and
    against the dense fire (pane_emit) at the live cells."""
    q = 1 - (1 - HOT_DENSITY) ** (1 / W_HOT)  # a bin holds rows
    cells = np.where(rng.random((rows, B_HOT)) < q,
                     rng.integers(1, 9, (rows, B_HOT)), 0)
    counts = torch.zeros((C_HOT, B_HOT), dtype=torch.int32, device=dev)
    counts[:rows] = torch.tensor(cells.astype(np.int32), device=dev)
    values = torch.zeros((1, C_HOT, B_HOT), dtype=torch.float64, device=dev)
    # panes p < k over the absolute bins 3 + p + w, all live
    geometry = (3, 3, 3 + k + W_HOT - 2)
    ring_np, ok_np = fire_geometry(*geometry, W_HOT, k, B_HOT)
    check(ok_np.all(), "hot compact fire: a bin is not live")
    ring = torch.tensor(ring_np, device=dev)
    ok = torch.tensor(ok_np, device=dev)
    kinds, xfer = ("count",), ()
    cnt, offsets = emit_count(counts, ring, ok, rows)
    cnt_r, offsets_r = emit_count_reference(counts, ring, ok, rows)
    torch.cuda.synchronize()
    check(torch.equal(cnt, cnt_r) and torch.equal(offsets, offsets_r),
          f"emit_count differs ({shape})")
    nnz = int(offsets[-1])
    g_args = (values, cnt, ring, ok, kinds, xfer, offsets, nnz)
    got, want = emit_gather(*g_args), emit_gather_reference(*g_args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"emit_gather differs ({shape})")
    _outs, dense = pane_views(
        pane_emit(values, counts, *geometry, W_HOT, k, kinds, xfer, rows),
        len(xfer), rows, k, counts.dtype)
    check(torch.equal(got[1], dense[got[0][0].long(), got[0][1].long()]),
          f"emit_gather's counts differ from pane_emit's ({shape})")
    shape = f"{shape} density={nnz / (rows * k):.4f} nnz={nnz}"
    ring_l = ring.long()

    def lib_count():  # the masked gather-sum of the pane counts
        return torch.where(ok[None], counts[:rows][:, ring_l], 0).sum(-1)

    def lib_gather():  # nonzero + one index_select per plane
        flat = torch.nonzero(cnt.reshape(-1) > 0).squeeze(1)
        return flat, cnt.reshape(-1).index_select(0, flat)

    item = counts.element_size()
    nb = offsets.numel()
    cols = len(np.unique(ring_np))
    return [
        row("emit_count", K13_SOURCE, K13_REPLACES, shape, 0.0,
            cuda_ms(lambda: emit_count(counts, ring, ok, rows)),
            cuda_ms(lambda: emit_count_reference(counts, ring, ok, rows)),
            rows * cols * item + rows * k * item + 4 * nb,
            rows * k * W_HOT, cuda_ms(lib_count),
            "counts[:, ring] masked sum"),
        row("emit_gather", K14_SOURCE, K14_REPLACES, shape, 0.0,
            cuda_ms(lambda: emit_gather(*g_args)),
            cuda_ms(lambda: emit_gather_reference(*g_args)),
            rows * k * item + 4 * nb + nnz * (8 + item), 0,
            cuda_ms(lib_gather), "nonzero + index_select")]


def kernel_phase(parent=None):
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    rows = []
    for m, cdt in ((4096, torch.int32), (65536, torch.int32),
                   (65536, torch.int64)):
        rows.append(k1_case(rng, dev, ("count",), (0,), m, cdt, True,
                            f"q5 COUNT(*) C={C_Q5} B={B_Q5} m={m} "
                            f"unique {cdt}"))
    mixed = ("count", "sum", "sum", "count", "min", "max", "sum", "sum")
    rows.append(k1_case(rng, dev, mixed, (0,), 65536, torch.int32, False,
                        f"mixed sum/avg/count/min/max C={C_Q5} B={B_Q5} "
                        "m=65536 duplicates+padding int32"))
    for kpad in (1, 8):
        for minmax in ("max", "min"):
            for cdt in (torch.int32, torch.int64):
                rows.append(k2_case(rng, dev, kpad, minmax, cdt))
    # q8's tumbling fire: one live bin; the mixed fire: panes wrapping
    # the ring, bins 0 and 1 evicted; hot items' sliding fire: 5 live bins
    q8_bin = 8 * 5_000 + 3
    for cdt in (torch.int32, torch.int64):
        rows.append(k3_case(rng, dev, ("count",), (), C_Q8, B_Q8, 1, 1,
                            C_SLICE_Q8, cdt, (q8_bin, q8_bin, q8_bin),
                            f"q8 COUNT(*) C={C_Q8} B={B_Q8} W=1 k=1 "
                            f"c_slice={C_SLICE_Q8} {cdt}", parent))
        rows.append(k3_case(rng, dev, mixed, tuple(range(1, 8)), C_Q5, B_Q5,
                            5, 8, C_Q5, cdt,
                            (16 * 9 - 4, 16 * 9 - 2, 16 * 9 + 7),
                            f"mixed sum/avg/count/min/max C={C_Q5} B={B_Q5} "
                            f"W=5 k=8 {cdt}", parent))
    hot_bin = 16 * 50 + 6
    rows.append(k3_case(rng, dev, ("count",), (), C_HOT, B_HOT, W_HOT, 1,
                        C_SLICE_HOT, torch.int32,
                        (hot_bin, hot_bin, hot_bin + W_HOT - 1),
                        f"hot items COUNT(*) C={C_HOT} B={B_HOT} W={W_HOT} "
                        f"k=1 c_slice={C_SLICE_HOT} int32", parent))
    rows.append(k4_case(rng, dev, ("count",), C_Q8, B_Q8, 8 * 5_000 + 3, 1,
                        C_SLICE_Q8, torch.int32,
                        f"q8 COUNT(*) C={C_Q8} B={B_Q8} 1 column "
                        f"rows={C_SLICE_Q8} int32", parent))
    rows.append(k4_case(rng, dev, ("count",), C_Q5, B_Q5, 16 * 9 + 2, 4,
                        C_Q5, torch.int32,
                        f"q5 COUNT(*) C={C_Q5} B={B_Q5} 4 columns "
                        f"rows={C_Q5} int32", parent))
    rows.append(k4_case(rng, dev, ("count",), C_HOT, B_HOT, 16 * 50 + 6, 1,
                        HOT_ROWS, torch.int32,
                        f"hot items COUNT(*) C={C_HOT} B={B_HOT} 1 column "
                        f"rows={HOT_ROWS} int32", parent))
    for cap in (16_384, RING_CAP):
        rows.append(k5_case(rng, dev, cap, 0, 0, f"keys only cap={cap}"))
        rows.append(k5_case(rng, dev, cap, 2, 6,
                            f"q8 payload nf=2 ni=6 cap={cap}"))
    rows.append(k6_case(rng, dev, RING_CAP, 2, 6, 5_000,
                        f"q8 payload nf=2 ni=6 cap={RING_CAP} m=5000"))
    for n, n_keys in ((256, 64), (256, 1), (65_536, 4_096), (65_536, 1),
                      (1_048_576, 65_536), (1_048_576, 1)):
        rows.append(k7_case(rng, dev, n, n_keys,
                            f"n={n} keys={n_keys}"
                            + (" (config5 batch)" if n == 256 else "")))
    mixed7 = ("sum", "min", "max", "count", "sum", "min", "max")
    for n, n_seg, kinds, what in (
            (8_192, 256, ("count",), "config5 fire COUNT(*)"),
            (200_000, 2_048, ("count",), "config5 final flush COUNT(*)"),
            (1_048_576, 65_536, mixed7, "mixed sum/min/max/count k=7"),
            (1_048_576, 1, mixed7, "one skewed segment k=7")):
        rows.append(k8_case(rng, dev, n, n_seg, kinds,
                            f"{what} n={n} n_seg={n_seg}", parent))
    for cap, n_valid, mq, m, span, what in (
            (JS_RING_CAP, JS_RING_ROWS, JS_MQ, JS_M, JS_KEYS,
             "join-stress partition probe"),
            (1 << 20, 1 << 20, 512, 1, 1, "one query spanning 2^20 rows")):
        rows += join_cases(rng, dev, cap, n_valid, mq, m, span, 3,
                           f"{what} cap={cap} n_valid={n_valid} mq={mq} "
                           f"m={m} ni=3", parent)
    for n, n_seg, what in ((TOPK_STEADY, 1, "hot items steady fire"),
                           (TOPK_FLUSH, 5, "hot items final flush")):
        rows.append(topk_case(rng, dev, n, n_seg,
                              f"{what} n={n} n_seg={n_seg} k={TOP_K}"))
    for k in (1, 5):
        rows += compact_cases(rng, dev, k, 3_000_000,
                              f"hot items COUNT(*) C={C_HOT} B={B_HOT} "
                              f"W={W_HOT} k={k} rows=3000000 int32")
    return rows


# -- phase 4: KeyedBinState over the nexmark stream ------------------------------------


def q5_batches(event_rate):
    """(key hashes, timestamps, watermark) per batch of bids, as q5's
    ingest path feeds its sliding aggregate."""
    cfg = NexmarkConfig(num_events=NUM_EVENTS, rate_limited=False,
                        event_rate=event_rate, batch_size=BATCH,
                        projection=["bid_auction", "bid_datetime",
                                    "event_type"])
    first, n, num = make_splits(cfg, 0, 1)[0]
    gen = NexmarkGenerator(cfg, 0, first, n, num, seed=0)
    gen.set_rate(cfg.event_rate, 1)
    max_ts = None
    while gen.has_next:
        b, _ = gen.next_batch(BATCH)
        bid = b.columns["event_type"] == EVENT_BID
        ts = b.timestamp[bid]
        max_ts = int(ts.max()) if max_ts is None else max(max_ts,
                                                          int(ts.max()))
        yield (hash_columns([b.columns["bid_auction"][bid]]), ts,
               max_ts - 1_000)


def new_state(device):
    st = KeyedBinState((AggSpec(AggKind.COUNT, None, "__agg0"),),
                       SLIDE_MICROS, WIDTH_MICROS, device=device)
    st.set_argmax_local("__agg0", "max")
    return st


def same_fire(a, b, what):
    if a is None or b is None:
        check(a is None and b is None, f"{what}: one side fired nothing")
        return 0
    for x, y, name in zip(a, b, ("keys", "cols", "window_end", "counts")):
        if name == "cols":
            check(x.keys() == y.keys(), f"{what}: columns differ")
            for k in x:
                check(np.array_equal(x[k], y[k]), f"{what}: {k} differs")
        else:
            check(np.array_equal(x, y), f"{what}: {name} differs")
    return len(a[0])


def state_phase():
    # 100k events/s spreads the 2M events over 20 s of event time, so
    # panes fire all along the stream, not only at the final flush
    batches = list(q5_batches(event_rate=100_000.0))
    bin_update.launches = argmax_fire.launches = 0
    t0 = time.perf_counter()
    gpu, cpu = new_state("cuda"), new_state("cpu")
    restored = None
    fired = 0
    half = len(batches) // 2
    for i, (kh, ts, wm) in enumerate(batches):
        if i == half:
            snap = gpu.snapshot()
            restored = new_state("cuda")
            restored.restore(snap)
        for st in (gpu, cpu) + ((restored,) if restored else ()):
            st.update(kh, ts, {})
        fires = [st.fire_panes(wm) for st in (gpu, cpu)
                 + ((restored,) if restored else ())]
        fired += same_fire(fires[0], fires[1], f"batch {i} card vs cpu")
        if restored is not None:
            same_fire(fires[0], fires[2], f"batch {i} card vs restored")
    snaps = [gpu.snapshot(), cpu.snapshot(), restored.snapshot()]
    for other in snaps[1:]:
        check(snaps[0].keys() == other.keys(), "snapshot keys differ")
        for k in snaps[0]:
            check(np.array_equal(snaps[0][k], other[k]),
                  f"snapshot array {k} differs")
    finals = [st.fire_panes(0, final=True) for st in (gpu, cpu, restored)]
    fired += same_fire(finals[0], finals[1], "final card vs cpu")
    same_fire(finals[0], finals[2], "final card vs restored")
    check(bin_update.launches > 0 and argmax_fire.launches > 0,
          "state phase did not launch both kernels")
    print(f"state: {len(batches)} batches, C={gpu.C} B={gpu.B} "
          f"keys={gpu.next_slot}, {fired} rows fired, identical on card, "
          f"cpu and card-restored; launches bin_update={bin_update.launches}"
          f" argmax_fire={argmax_fire.launches}; "
          f"{time.perf_counter() - t0:.2f} s")


# -- phase 5: main path --------------------------------------------------------------


def run_q5(sink, device):
    clear_sink(sink)
    t0 = time.perf_counter()
    LocalRunner(q5_program(NUM_EVENTS, BATCH, sink, base_time_micros=0),
                device=device).run()
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rows = sorted(
        (int(b.timestamp[i]), int(b.columns["auction"][i]),
         int(b.columns["num"][i]))
        for b in sink_output(sink) for i in range(len(b)))
    return dt, rows


def main_path():
    run_q5("smoke-warm", None)  # CUDA context, allocator, library load
    reset_launches()
    dt, rows = run_q5("smoke-cuda", None)  # device=None: the card
    launches = read_launches()
    # device-time share: the same run with every kernel call synchronized
    # (ARROYO_TIMING=1 serializes dispatch, so it is timed apart)
    os.environ["ARROYO_TIMING"] = "1"
    perf.reset()
    try:
        dt_timed, rows_timed = run_q5("smoke-timed", None)
    finally:
        del os.environ["ARROYO_TIMING"]
    device_s = perf.counter("device_ns") / 1e9
    check(rows_timed == rows, "q5 rows differ under ARROYO_TIMING")
    dt_cpu, rows_cpu = run_q5("smoke-cpu", "cpu")
    check(rows, "q5 emitted no rows on the card")
    check(rows == rows_cpu, "q5 rows differ between card and cpu")
    check(all(launches[k] > 0 for k in ("bin_update", "argmax_fire",
                                         "bin_evict")),
          f"q5 main path did not launch every kernel: {launches}")
    print("q5 main path: " + json.dumps({
        "events": NUM_EVENTS, "batch": BATCH, "wall_s": dt,
        "events_per_s": NUM_EVENTS / dt, "rows": len(rows),
        "launches": launches, "cpu_wall_s": dt_cpu,
        "timed_wall_s": dt_timed, "timed_device_s": device_s,
        "device_share": device_s / dt_timed,
        "kernel_dispatches": perf.counter("kernel_dispatches")}))
    return launches


# -- phase 6: q8 ---------------------------------------------------------------------


def q8_table(batches):
    """Sink rows as an int64 [n, 4] array (ts, id, np, na), sorted."""
    if not batches:
        return np.zeros((0, 4), dtype=np.int64)
    t = np.stack([np.concatenate([b.timestamp for b in batches])]
                 + [np.concatenate([b.columns[c] for b in batches])
                    for c in ("id", "np", "na")], axis=1).astype(np.int64)
    return t[np.lexsort(t.T[::-1])]


def q8_control(num_events):
    """q8 in numpy from the port's generator: per-(id, window) person
    counts inner-joined with per-(seller, window) auction counts, one row
    (window end - 1, id, np, na) per match."""
    cfg = NexmarkConfig(num_events=num_events, rate_limited=False,
                        event_rate=1_000_000.0, batch_size=BATCH,
                        projection=["auction_seller", "event_type",
                                    "person_id"])
    first, n, num = make_splits(cfg, 0, 1)[0]
    gen = NexmarkGenerator(cfg, 0, first, n, num, seed=0)
    gen.set_rate(cfg.event_rate, 1)
    sides = {EVENT_PERSON: ([], []), EVENT_AUCTION: ([], [])}
    while gen.has_next:
        b, _ = gen.next_batch(BATCH)
        et = b.columns["event_type"]
        for etype, col in ((EVENT_PERSON, "person_id"),
                           (EVENT_AUCTION, "auction_seller")):
            sel = et == etype
            sides[etype][0].append(b.columns[col][sel])
            sides[etype][1].append(b.timestamp[sel] // Q8_WIDTH)

    def counted(etype):
        keys, wins = (np.concatenate(x) for x in sides[etype])
        pairs, cnt = np.unique(np.stack([wins, keys], axis=1), axis=0,
                               return_counts=True)
        return pairs, cnt  # rows sorted by (window, key)

    (pp, pc), (ap, ac) = counted(EVENT_PERSON), counted(EVENT_AUCTION)
    span = int(max(pp[:, 1].max(), ap[:, 1].max())) + 1
    pk, ak = pp[:, 0] * span + pp[:, 1], ap[:, 0] * span + ap[:, 1]
    at = np.searchsorted(ak, pk)
    hit = (at < len(ak)) & (ak[np.minimum(at, len(ak) - 1)] == pk)
    t = np.stack([(pp[hit, 0] + 1) * Q8_WIDTH - 1, pp[hit, 1], pc[hit],
                  ac[at[hit]]], axis=1).astype(np.int64)
    return t[np.lexsort(t.T[::-1])]


def run_q8(num_events, sink, device):
    """q8 through LocalRunner; returns (wall s, sorted rows, state shape)."""
    clear_sink(sink)
    runner = LocalRunner(q8_program(num_events, BATCH, sink,
                                    base_time_micros=0), device=device)
    t0 = time.perf_counter()
    runner.run()
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    shape = {}
    for (op_id, _idx), h in runner.engine.subtasks.items():
        op = h.runner.operator
        st = getattr(op, "state", None)
        if st is not None:
            shape[op_id] = {
                "C": st.C, "B": st.B, "keys": st.next_slot,
                "counts_bytes": st.counts.numel() * st.counts.element_size(),
                "values_bytes": st.values.numel() * 8}
        if hasattr(op, "left"):
            shape[op_id] = {"left": op.left.stats(),
                            "right": op.right.stats()}
    rows = q8_table(sink_output(sink))
    clear_sink(sink)
    return dt, rows, shape


Q8_COUNTERS = ("join_state_promotions", "join_state_device_merges",
               "join_state_ring_regrows", "join_device_gather_rows",
               "join_host_gather_rows", "join_ring_probes",
               "join_probe_readbacks", "kernel_dispatches")


def q8_phase():
    t0 = time.perf_counter()
    control = q8_control(Q8_EVENTS)
    control_s = time.perf_counter() - t0
    perf.reset()
    reset_launches()
    dt, rows, shape = run_q8(Q8_EVENTS, "q8-cuda", None)  # the card
    launches = read_launches()
    counters = {k: perf.counter(k) for k in Q8_COUNTERS}
    check(len(rows) > 0, "q8 emitted no rows on the card")
    check(rows.shape == control.shape and np.array_equal(rows, control),
          f"q8 rows differ from the numpy control ({len(rows)} vs "
          f"{len(control)})")
    check(all(launches[k] > 0 for k in ("bin_update", "pane_emit",
                                         "bin_evict", "ring_merge",
                                         "ring_gather")),
          f"q8 main path did not launch every kernel: {launches}")
    hot = sum(side["hot_partitions"] for st in shape.values()
              for side in (st.get("left"), st.get("right")) if side)
    check(counters["join_state_promotions"] > 0 and hot > 0,
          "q8 ended with no hot join partition")
    check(counters["join_device_gather_rows"] > 0,
          "q8 gathered no rows from a device ring")
    os.environ["ARROYO_TIMING"] = "1"
    perf.reset()
    try:
        dt_timed, rows_timed, _ = run_q8(Q8_EVENTS, "q8-timed", None)
    finally:
        del os.environ["ARROYO_TIMING"]
    device_s = perf.counter("device_ns") / 1e9
    check(np.array_equal(rows_timed, rows), "q8 rows differ under "
          "ARROYO_TIMING")
    dt_cpu, rows_cpu, _ = run_q8(Q8_EVENTS, "q8-cpu", "cpu")
    check(np.array_equal(rows_cpu, rows), "q8 rows differ between card "
          "and cpu")
    dt_small, small, _ = run_q8(Q8_SMALL, "q8-small-cuda", None)
    dt_small_cpu, small_cpu, _ = run_q8(Q8_SMALL, "q8-small-cpu", "cpu")
    check(len(small) > 0 and np.array_equal(small, small_cpu),
          "q8 rows at 2M events differ between card and cpu")
    print("q8 main path: " + json.dumps({
        "events": Q8_EVENTS, "batch": BATCH, "wall_s": dt,
        "events_per_s": Q8_EVENTS / dt, "rows": len(rows),
        "control_rows": len(control), "control_s": control_s,
        "launches": launches, "counters": counters, "state": shape,
        "cpu_wall_s": dt_cpu,
        "timed_wall_s": dt_timed, "timed_device_s": device_s,
        "device_share": device_s / dt_timed,
        "small_events": Q8_SMALL, "small_rows": len(small),
        "small_wall_s": dt_small, "small_cpu_wall_s": dt_small_cpu}))
    return launches


# -- phase 7: config5 -----------------------------------------------------------------

C5_COLS = ("k", "med", "cnt", "window_start", "window_end")
C5_COUNTERS = ("session_merge_dispatches", "session_merge_device_dispatches",
               "session_device_merge_rows", "session_host_merge_rows",
               "udaf_channel_rows", "kernel_dispatches")


def c5_table(batches):
    """Sink rows as sorted (ts, k, med, cnt, window_start, window_end)."""
    rows = []
    for b in batches:
        rows.extend(zip(b.timestamp.tolist(),
                        *(b.columns[c].tolist() for c in C5_COLS)))
    return sorted(rows)


def c5_control(num_events):
    """config5 in numpy from the producer's events: each key lives in
    one burst block (its events 640 us apart, far inside the 1 s gap), so
    it has one session: first event, last event + gap, count, median."""
    keys, vals, ts = config5_events(num_events, 0, C5_SPACING)
    t = ts // 1000  # from_unixtime: ns -> us
    order = np.argsort(keys, kind="stable")
    k_s, v_s, t_s = keys[order], vals[order], t[order]
    uniq, first, counts = np.unique(k_s, return_index=True,
                                    return_counts=True)
    start = np.minimum.reduceat(t_s, first)
    end = np.maximum.reduceat(t_s, first) + GAP_MICROS
    med = [float(np.median(v_s[a:a + c])) for a, c in zip(first, counts)]
    return sorted(zip((end - 1).tolist(), uniq.tolist(), med,
                      counts.tolist(), start.tolist(), end.tolist()))


def run_c5(num_events, broker, sink, device):
    """config5 through LocalRunner with 1 s checkpoints; returns (wall s,
    sorted rows, sink batches, fully completed checkpoint epochs)."""
    clear_sink(sink)
    runner = LocalRunner(config5_program(num_events, C5_BATCH, sink,
                                         broker=broker), device=device)
    t0 = time.perf_counter()
    resps = runner.run(checkpoint_interval_secs=1.0)
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    done = collections.Counter(r.subtask_metadata.epoch for r in resps
                               if r.kind == "checkpoint_completed")
    epochs = sorted(e for e, c in done.items()
                    if c == len(runner.engine.subtasks))
    batches = sink_output(sink)
    rows = c5_table(batches)
    clear_sink(sink)
    return dt, rows, len(batches), epochs


def c5_phase():
    t0 = time.perf_counter()
    config5_produce("c5-big", C5_EVENTS, 0, C5_SPACING)
    produce_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    control = c5_control(C5_EVENTS)
    control_s = time.perf_counter() - t0
    perf.reset()
    reset_launches()
    dt, rows, fires, epochs = run_c5(C5_EVENTS, "c5-big", "c5-cuda", None)
    launches = read_launches()
    counters = {k: perf.counter(k) for k in C5_COUNTERS}
    state = aggregate_session_registry(
        perf.get_note("session_state_registry"))
    check(len(rows) > 0, "config5 emitted no rows on the card")
    check(rows == control, f"config5 rows differ from the numpy control "
          f"({len(rows)} vs {len(control)})")
    check(launches["session_union"] > 0 and launches["segment_agg"] > 0,
          f"config5 main path did not launch both kernels: {launches}")
    check(counters["session_device_merge_rows"] > 0,
          "config5 merged no interval rows on the device")
    check(len(epochs) > 0, "config5 completed no checkpoint epoch")
    os.environ["ARROYO_TIMING"] = "1"
    perf.reset()
    try:
        dt_timed, rows_timed, _, _ = run_c5(C5_EVENTS, "c5-big", "c5-timed",
                                            None)
    finally:
        del os.environ["ARROYO_TIMING"]
    device_s = perf.counter("device_ns") / 1e9
    check(rows_timed == rows, "config5 rows differ under ARROYO_TIMING")
    config5_produce("c5-small", C5_SMALL, 0, C5_SPACING)
    dt_small, small, _, _ = run_c5(C5_SMALL, "c5-small", "c5-small-cuda",
                                   None)
    dt_small_cpu, small_cpu, _, _ = run_c5(C5_SMALL, "c5-small",
                                           "c5-small-cpu", "cpu")
    check(len(small) > 0 and small == small_cpu,
          "config5 rows at 200k events differ between card and cpu")
    print("config5 main path: " + json.dumps({
        "events": C5_EVENTS, "batch": C5_BATCH, "wall_s": dt,
        "events_per_s": C5_EVENTS / dt, "sessions": len(rows),
        "fire_batches": fires, "control_sessions": len(control),
        "produce_s": produce_s, "control_s": control_s,
        "checkpoint_epochs": len(epochs), "launches": launches,
        "counters": counters, "session_state": state,
        "timed_wall_s": dt_timed, "timed_device_s": device_s,
        "device_share": device_s / dt_timed,
        "small_events": C5_SMALL, "small_sessions": len(small),
        "small_wall_s": dt_small, "small_cpu_wall_s": dt_small_cpu}))
    return launches


# -- phase 8: join-stress ---------------------------------------------------------------

JS_COUNTERS = ("join_state_promotions", "join_state_demotions",
               "join_state_device_merges", "join_state_ring_regrows",
               "join_state_compactions", "join_device_gather_rows",
               "join_host_gather_rows", "join_ring_probes",
               "join_probe_readbacks", "kernel_dispatches")


def js_codes(v0, v1):
    """One int64 per (left counter, right counter) pair; v1 = -1 (a NULL
    right side) codes as 0.  Counters stay below 2^21."""
    return (np.asarray(v0, np.int64) << 21) | (np.asarray(v1, np.int64) + 1)


def js_pairs(n, window):
    """Codes of every key-equal (left, right) counter pair with |c0 - c1|
    <= window (None: any distance), sorted; counters are event times in
    ms, as the impulse sources stamp them."""
    c = np.arange(n, dtype=np.int64)
    kl, kr = join_stress_keys(c, 0), join_stress_keys(c, 1)
    span = 4 * n + 4  # codes (key, counter) far enough apart per key
    rcode = np.sort(kr * span + c)  # right rows sorted by (key, counter)
    base = kl * span + c
    w = n if window is None else window
    lo = np.searchsorted(rcode, base - w, side="left")
    hi = np.searchsorted(rcode, base + w, side="right")
    counts = hi - lo
    li = np.repeat(c, counts)
    ri = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts,
                                                  counts)
    rc = rcode[np.repeat(lo, counts) + ri] % span
    codes = js_codes(li, rc)
    if window is None:  # LEFT: the unmatched left rows, NULL-padded
        codes = np.concatenate([codes, js_codes(c[counts == 0], -1)])
    return np.sort(codes)


def js_output(batches):
    """(codes of CREATE rows, codes of DELETE rows), each sorted, after
    checking every row is key-equal (k, and r_k where matched, equal to
    the keys the two counters get)."""
    creates, deletes = [], []
    for b in batches:
        n = len(b)
        v0 = b.columns["v0"].astype(np.int64)
        v1f = np.asarray(b.columns["v1"], np.float64)
        matched = ~np.isnan(v1f)
        v1 = np.where(matched, v1f, -1).astype(np.int64)
        k = np.asarray(b.columns["k"], np.int64)
        check(np.array_equal(k, join_stress_keys(v0, 0)),
              "join-stress: k is not the left counter's key")
        rk = np.asarray(b.columns["r_k"], np.float64)[matched]
        check(np.array_equal(rk.astype(np.int64), k[matched])
              and np.array_equal(join_stress_keys(v1[matched], 1),
                                 k[matched]),
              "join-stress: a joined row is not key-equal")
        op = b.columns.get("__op", np.zeros(n, np.int8))
        codes = js_codes(v0, v1)
        creates.append(codes[op == 0])
        deletes.append(codes[op == 2])
    cat = lambda xs: np.sort(np.concatenate(xs)) if xs else np.zeros(0, np.int64)  # noqa: E731
    return cat(creates), cat(deletes)


def run_js(n, how, ttl, sink, device):
    """Join-stress through LocalRunner; returns (wall s, create codes,
    delete codes, folded join-state registry)."""
    clear_sink(sink)
    perf.note("join_state_registry", {})
    runner = LocalRunner(join_stress_program(n, how, ttl, sink, JS_BATCH),
                         device=device)
    t0 = time.perf_counter()
    runner.run()
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    creates, deletes = js_output(sink_output(sink))
    clear_sink(sink)
    return dt, creates, deletes, aggregate_stats_registry(
        perf.get_note("join_state_registry"))


def js_variant(what, n, how, ttl, gate):
    """One variant on the card, launches and counters counted, then once
    more under ARROYO_TIMING=1; ``gate(creates, deletes)`` checks each
    run's rows.  Returns (result, launches, the first run's state)."""
    perf.reset()
    reset_launches()
    dt, creates, deletes, state = run_js(n, how, ttl, f"js-{what}", None)
    launches = read_launches()
    counters = {k: perf.counter(k) for k in JS_COUNTERS}
    res = {"events_per_side": n, "batch": JS_BATCH, "ttl_micros": ttl,
           "join": how.value, "wall_s": dt, "events_per_s": 2 * n / dt,
           "rows_created": len(creates), "rows_deleted": len(deletes),
           **gate(creates, deletes), "launches": launches,
           "counters": counters, "state": state,
           "readbacks_per_hot_probe": counters["join_probe_readbacks"]
           / max(counters["join_ring_probes"], 1)}
    os.environ["ARROYO_TIMING"] = "1"
    perf.reset()
    try:
        dt_timed, creates, deletes, _ = run_js(n, how, ttl, f"js-{what}-t",
                                               None)
    finally:
        del os.environ["ARROYO_TIMING"]
    gate(creates, deletes)
    device_s = perf.counter("device_ns") / 1e9
    res.update(timed_wall_s=dt_timed, timed_device_s=device_s,
               device_share=device_s / dt_timed)
    return res, launches, state


def js_phase():
    t0 = time.perf_counter()
    certain = js_pairs(JS_INNER, TTL_MICROS // INTERVAL_MICROS)
    left_join = js_pairs(JS_LEFT, None)
    control_s = time.perf_counter() - t0

    def gate_inner(creates, deletes):
        # a row's partner at most one TTL earlier is still live when the
        # row arrives: the join's watermark (the min over both sides) is
        # below the arriving batch's own times, so eviction at watermark
        # - TTL keeps it; pairs further apart may or may not be emitted
        check(len(deletes) == 0, "join-stress inner emitted DELETE rows")
        check(len(np.unique(creates)) == len(creates),
              "join-stress inner emitted a pair twice")
        missing = int((~np.isin(certain, creates)).sum())
        check(missing == 0, f"join-stress inner misses {missing} of "
              f"{len(certain)} certain pairs")
        return {"certain_pairs": len(certain),
                "beyond_ttl_rows": len(creates) - len(certain)}

    def gate_left(creates, deletes):
        uniq, cnt = np.unique(creates, return_counts=True)
        d_uniq, d_cnt = np.unique(deletes, return_counts=True)
        at = np.minimum(np.searchsorted(uniq, d_uniq), max(len(uniq) - 1, 0))
        check(np.array_equal(uniq[at], d_uniq),
              "join-stress left deleted a row it never created")
        cnt[at] -= d_cnt
        check(bool(np.all(cnt >= 0)), "join-stress left deleted a row twice")
        net = np.repeat(uniq, cnt)
        check(np.array_equal(net, left_join), f"join-stress left net rows "
              f"differ from the numpy LEFT JOIN ({len(net)} vs "
              f"{len(left_join)})")
        return {"net_rows": len(net), "control_rows": len(left_join)}

    res_a, la, state = js_variant("inner", JS_INNER, JoinType.INNER,
                                  TTL_MICROS, gate_inner)
    check(state_bounded(state, TTL_MICROS),
          f"join-stress inner state not bounded: {state}")
    res_a["state_bounded"] = True
    check(all(la[k] > 0 for k in ("join_probe", "expand_gather",
                                  "ring_merge")),
          f"join-stress inner did not launch its kernels: {la}")
    # a hot probe reads back its pair total, then the expansion's buffer
    probes = res_a["counters"]["join_ring_probes"]
    check(probes > 0 and res_a["counters"]["join_probe_readbacks"]
          <= 2 * probes, "join-stress inner made more than two "
          f"device-to-host copies a hot probe: {res_a['counters']}")
    res_b, lb, _ = js_variant("left", JS_LEFT, JoinType.LEFT,
                              PLANNER_TTL_MICROS, gate_left)
    check(all(lb[k] > 0 for k in ("join_probe", "expand_gather",
                                  "join_expand", "ring_merge",
                                  "ring_gather")),
          f"join-stress left did not launch its kernels: {lb}")
    print("join-stress path: " + json.dumps({
        "control_s": control_s, "inner": res_a, "left": res_b}))
    return la, lb


# -- phase 9: hot items -----------------------------------------------------------------


def hot_control(num_events):
    """Hot items in numpy from the port's generator: bids per (auction,
    window) of HOP(2 s, 10 s) for every window that holds a bid, as
    {window end: dense bid counts indexed by auction}."""
    cfg = NexmarkConfig(num_events=num_events, rate_limited=False,
                        event_rate=1_000_000.0, batch_size=BATCH,
                        projection=["bid_auction", "event_type"])
    first, n, num = make_splits(cfg, 0, 1)[0]
    gen = NexmarkGenerator(cfg, 0, first, n, num, seed=0)
    gen.set_rate(cfg.event_rate, 1)
    auctions, bins = [], []
    while gen.has_next:
        b, _ = gen.next_batch(BATCH)
        bid = b.columns["event_type"] == EVENT_BID
        auctions.append(b.columns["bid_auction"][bid])
        bins.append(b.timestamp[bid] // HOT_SLIDE)
    auctions, bins = np.concatenate(auctions), np.concatenate(bins)
    order = np.argsort(bins, kind="stable")
    auctions, bins = auctions[order], bins[order]
    n_auctions = int(auctions.max()) + 1
    lo, hi = int(bins[0]), int(bins[-1])
    per_bin = []
    for b in range(lo, hi + 1):
        a, z = np.searchsorted(bins, [b, b + 1])
        per_bin.append(np.bincount(auctions[a:z], minlength=n_auctions))
    w = HOT_WIDTH // HOT_SLIDE
    windows = {}
    for p in range(lo, hi + w):
        window = sum(per_bin[b - lo] for b in range(max(p - w + 1, lo),
                                                      min(p, hi) + 1))
        windows[(p + 1) * HOT_SLIDE] = window
    return windows


def hot_table(batches):
    """Sink rows as an int64 [n, 5] array (ts, auction, num,
    window_start, window_end), sorted."""
    cols = ("auction", "num", "window_start", "window_end")
    t = np.stack([np.concatenate([b.timestamp for b in batches])]
                 + [np.concatenate([b.columns[c] for b in batches])
                    for c in cols], axis=1).astype(np.int64)
    return t[np.lexsort(t.T[::-1])]


def hot_gate(rows, control):
    """At most TOP_K rows per window; each row's count is the control's;
    each window's counts are the control's top TOP_K, as a multiset."""
    check(np.array_equal(rows[:, 0], rows[:, 4] - 1)
          and np.array_equal(rows[:, 3], rows[:, 4] - HOT_WIDTH),
          "hot items: window columns or timestamps wrong")
    ends, starts = np.unique(rows[:, 4], return_index=True)
    check(set(ends.tolist()) == set(control),
          f"hot items: {len(ends)} windows emitted, the control has "
          f"{len(control)}")
    bounds = np.append(starts, len(rows))
    for i, e in enumerate(ends.tolist()):
        r = rows[bounds[i]:bounds[i + 1]]
        window = control[e]
        check(len(r) <= TOP_K, f"hot items: {len(r)} rows in window {e}")
        check(np.array_equal(r[:, 2], window[r[:, 1]]),
              f"hot items: a count in window {e} is not the control's")
        top = np.sort(np.partition(window, -TOP_K)[-TOP_K:])
        check(np.array_equal(np.sort(r[:, 2]), top[top > 0]),
              f"hot items: window {e} is not the control's top {TOP_K}")
    return len(ends)


def run_hot(num_events, sink, device):
    """Hot items through LocalRunner; returns (wall s, sorted rows, the
    fused aggregate's state)."""
    clear_sink(sink)
    runner = LocalRunner(hot_items_program(num_events, BATCH, sink=sink,
                                           base_time_micros=0),
                         device=device)
    t0 = time.perf_counter()
    runner.run()
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    state = {}
    for h in runner.engine.subtasks.values():
        st = getattr(h.runner.operator, "state", None)
        if st is not None:
            state = {"C": st.C, "B": st.B, "keys": st.next_slot,
                     "counts_bytes": st.counts.numel()
                     * st.counts.element_size(),
                     "values_bytes": st.values.numel() * 8,
                     "last_fire_density": st._fire_density}
    rows = hot_table(sink_output(sink))
    clear_sink(sink)
    return dt, rows, state


def hot_phase():
    t0 = time.perf_counter()
    control = hot_control(HOT_EVENTS)
    control_s = time.perf_counter() - t0
    perf.reset()
    reset_launches()
    dt, rows, state = run_hot(HOT_EVENTS, "hot-cuda", None)  # the card
    launches = read_launches()
    windows = hot_gate(rows, control)
    fires = launches["pane_emit"] + launches["emit_count"]
    check(launches["segment_top_k"] == fires > 0,
          f"hot items: segment_top_k launched {launches['segment_top_k']} "
          f"times over {fires} fires")
    check(all(launches[k] > 0 for k in ("bin_update", "bin_evict",
                                         "emit_count", "emit_gather")),
          f"hot items main path did not launch every kernel: {launches}")
    os.environ["ARROYO_TIMING"] = "1"
    perf.reset()
    try:
        dt_timed, rows_timed, _ = run_hot(HOT_EVENTS, "hot-timed", None)
    finally:
        del os.environ["ARROYO_TIMING"]
    device_s = perf.counter("device_ns") / 1e9
    check(np.array_equal(rows_timed, rows), "hot items rows differ under "
          "ARROYO_TIMING")
    dt_small, small, _ = run_hot(HOT_SMALL, "hot-small-cuda", None)
    dt_small_cpu, small_cpu, _ = run_hot(HOT_SMALL, "hot-small-cpu", "cpu")
    check(len(small) > 0 and np.array_equal(small, small_cpu),
          "hot items rows at 2M events differ between card and cpu")
    os.environ["ARROYO_EMIT_COMPACT"] = "on"
    compact_before = emit_count.launches
    try:
        _, small_on, _ = run_hot(HOT_SMALL, "hot-small-on", None)
    finally:
        del os.environ["ARROYO_EMIT_COMPACT"]
    check(emit_count.launches > compact_before
          and np.array_equal(small_on, small),
          "hot items rows at 2M events differ under ARROYO_EMIT_COMPACT=on")
    print("hot-items path: " + json.dumps({
        "events": HOT_EVENTS, "batch": BATCH, "wall_s": dt,
        "events_per_s": HOT_EVENTS / dt, "rows": len(rows),
        "windows": windows, "fires": fires, "control_s": control_s,
        "launches": launches, "state": state,
        "timed_wall_s": dt_timed, "timed_device_s": device_s,
        "device_share": device_s / dt_timed,
        "small_events": HOT_SMALL, "small_rows": len(small),
        "small_wall_s": dt_small, "small_cpu_wall_s": dt_small_cpu}))
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--parent", help="a directory holding a git archive of the parent "
        "commit: phase 3 also times its pane_emit, bin_evict, segment_agg "
        "and expand_gather in turns with this tree's")
    opts = parser.parse_args()
    smi = environment()
    parent = None
    if opts.parent:
        parent = parent_kernels(opts.parent)
        print(f"parent kernels from {opts.parent}: build "
              f"{parent.build_s:.3f} s")
    kernels = kernel_phase(parent)
    state_phase()
    launches = dict(zip(PATHS, (main_path(), q8_phase(), c5_phase())))
    launches["join_inner"], launches["join_left"] = js_phase()
    launches["hot_items"] = hot_phase()
    for r in kernels:
        for path in PATHS:
            r[f"launches_{path}"] = launches[path][r["name"]]
        r["launches"] = sum(r[f"launches_{p}"] for p in PATHS)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
