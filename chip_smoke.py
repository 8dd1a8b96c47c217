"""Smoke test of the PyTorch/CUDA port (arroyo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. environment: torch/CUDA versions, the card, its power limit;
2. build: the CUDA kernels from arroyo_tpu_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes nexmark q5 and q8 give it, timed with CUDA events beside
   its plain version, a PyTorch yardstick (one call per plane) where one
   exists, and its least possible time on an H100 (bytes / 3.35 TB/s);
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
   2,000,000 events on the card and on the CPU with identical rows.

Launch counts are set to 0 just before each main-path run (q5, q8) and
read just after it.  It prints a ``{"kernels": [...]}`` line, the card's name and power limit
as nvidia-smi gives them, and, last, ``{"ok": true, "device": ...}``.
It needs one card and exits non-zero without one."""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script "
          "needs an NVIDIA card", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output  # noqa: E402
from arroyo_tpu_torch.connectors.nexmark import (  # noqa: E402
    EVENT_AUCTION, EVENT_BID, EVENT_PERSON, NexmarkConfig, NexmarkGenerator,
    make_splits)
from arroyo_tpu_torch.engine.engine import LocalRunner  # noqa: E402
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec  # noqa: E402
from arroyo_tpu_torch.kernels import build  # noqa: E402
from arroyo_tpu_torch.kernels.argmax_fire import (  # noqa: E402
    argmax_fire, argmax_fire_reference)
from arroyo_tpu_torch.kernels.bin_evict import (  # noqa: E402
    bin_evict, bin_evict_reference)
from arroyo_tpu_torch.kernels.bin_update import (  # noqa: E402
    bin_update, bin_update_reference, channel_identity)
from arroyo_tpu_torch.kernels.pane_emit import (  # noqa: E402
    pane_emit, pane_emit_reference)
from arroyo_tpu_torch.kernels.ring_gather import (  # noqa: E402
    ring_gather, ring_gather_reference)
from arroyo_tpu_torch.kernels.ring_merge import (  # noqa: E402
    ring_merge, ring_merge_reference)
from arroyo_tpu_torch.obs import perf  # noqa: E402
from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState  # noqa: E402
from arroyo_tpu_torch.q5 import SLIDE_MICROS, WIDTH_MICROS, q5_program  # noqa: E402
from arroyo_tpu_torch.q8 import WIDTH_MICROS as Q8_WIDTH  # noqa: E402
from arroyo_tpu_torch.q8 import q8_program  # noqa: E402
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

KERNELS = (bin_update, argmax_fire, pane_emit, bin_evict, ring_merge,
           ring_gather)


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


def k3_case(rng, dev, kinds, xfer, C, B, W, k, c_slice, cdt, shape):
    values, counts = bin_planes(rng, dev, kinds, C, B, cdt)
    ring_np = ((np.arange(k)[:, None] + np.arange(W)[None, :])
               % B).astype(np.int32)
    ok_np = np.ones((k, W), dtype=bool)
    if W > 1:
        ok_np[0, :2] = False  # the oldest bins of the first pane evicted
    ring = torch.tensor(ring_np, device=dev)
    ok = torch.tensor(ok_np, device=dev)
    args = (values, counts, ring, ok, kinds, xfer, c_slice)
    got, want = pane_emit(*args), pane_emit_reference(*args)
    torch.cuda.synchronize()
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
    ms = cuda_ms(lambda: pane_emit(*args))
    plain = cuda_ms(lambda: pane_emit_reference(*args))
    library = None
    if W == 1:  # one index_select per plane reads the pane's one column
        col = ring[0].long()
        planes = [counts[:c_slice]] + [values[j, :c_slice] for j in xfer]
        library = cuda_ms(lambda: [p.index_select(1, col) for p in planes])
    per = counts.element_size() + 8 * len(xfer)
    cols_read = len(np.unique(ring_np[ok_np]))
    nbytes = c_slice * (cols_read + k) * per + ring_np.nbytes + ok_np.nbytes
    ops = c_slice * int(ok_np.sum()) * (1 + len(xfer))
    return row("pane_emit", K3_SOURCE, K3_REPLACES, shape, err, ms, plain,
               nbytes, ops, library, "index_select per plane")


def k4_case(rng, dev, kinds, C, B, cols_np, cdt, shape):
    values, counts = bin_planes(rng, dev, kinds, C, B, cdt)
    cols = torch.tensor(cols_np.astype(np.int32), device=dev)
    v_k, c_k = values.clone(), counts.clone()
    bin_evict(v_k, c_k, cols, kinds)
    bin_evict_reference(values, counts, cols, kinds)
    torch.cuda.synchronize()
    check(torch.equal(c_k, counts) and torch.equal(v_k, values),
          f"bin_evict differs ({shape})")
    ms = cuda_ms(lambda: bin_evict(v_k, c_k, cols, kinds))
    plain = cuda_ms(lambda: bin_evict_reference(values, counts, cols, kinds))
    col64 = cols.long()

    def library():  # one index_fill_ per plane
        counts.index_fill_(1, col64, 0)
        for j, k in enumerate(kinds):
            values[j].index_fill_(1, col64, channel_identity(k))

    lib = cuda_ms(library)
    e = len(np.unique(cols_np))
    nbytes = C * e * (counts.element_size() + 8 * len(kinds)) + cols_np.nbytes
    return row("bin_evict", K4_SOURCE, K4_REPLACES, shape, 0.0, ms, plain,
               nbytes, 0, lib, "index_fill_ per plane")


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


def k6_case(rng, dev, cap, nf, ni, m, shape):
    f = torch.tensor(rng.normal(size=(nf, cap)), device=dev)
    i = torch.tensor(rng.integers(-2**62, 2**62, (ni, cap)), device=dev)
    idx = torch.tensor(np.sort(rng.integers(0, cap, m)), device=dev)
    got, want = ring_gather(idx, f, i), ring_gather_reference(idx, f, i)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"ring_gather differs ({shape})")
    ms = cuda_ms(lambda: ring_gather(idx, f, i))
    plain = cuda_ms(lambda: ring_gather_reference(idx, f, i))
    lib = cuda_ms(lambda: (f.index_select(1, idx), i.index_select(1, idx)))
    nbytes = m * 8 + 2 * m * 8 * (nf + ni)
    return row("ring_gather", K6_SOURCE, K6_REPLACES, shape, 0.0, ms, plain,
               nbytes, 0, lib, "index_select per stack")


def kernel_phase():
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
    for cdt in (torch.int32, torch.int64):
        rows.append(k3_case(rng, dev, ("count",), (), C_Q8, B_Q8, 1, 1,
                            C_SLICE_Q8, cdt,
                            f"q8 COUNT(*) C={C_Q8} B={B_Q8} W=1 k=1 "
                            f"c_slice={C_SLICE_Q8} {cdt}"))
        rows.append(k3_case(rng, dev, mixed, tuple(range(1, 8)), C_Q5, B_Q5,
                            5, 8, C_Q5, cdt,
                            f"mixed sum/avg/count/min/max C={C_Q5} B={B_Q5} "
                            f"W=5 k=8 {cdt}"))
    rows.append(k4_case(rng, dev, ("count",), C_Q8, B_Q8, np.array([3]),
                        torch.int32, f"q8 COUNT(*) C={C_Q8} B={B_Q8} "
                        "1 column int32"))
    rows.append(k4_case(rng, dev, ("count",), C_Q5, B_Q5,
                        np.array([2, 3, 4, 5]), torch.int32,
                        f"q5 COUNT(*) C={C_Q5} B={B_Q5} 4 columns int32"))
    for cap in (16_384, RING_CAP):
        rows.append(k5_case(rng, dev, cap, 0, 0, f"keys only cap={cap}"))
        rows.append(k5_case(rng, dev, cap, 2, 6,
                            f"q8 payload nf=2 ni=6 cap={cap}"))
    rows.append(k6_case(rng, dev, RING_CAP, 2, 6, 5_000,
                        f"q8 payload nf=2 ni=6 cap={RING_CAP} m=5000"))
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
               "join_host_gather_rows", "kernel_dispatches")


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


def main():
    smi = environment()
    kernels = kernel_phase()
    state_phase()
    q5_launches = main_path()
    q8_launches = q8_phase()
    for r in kernels:
        r["launches_q5"] = q5_launches[r["name"]]
        r["launches_q8"] = q8_launches[r["name"]]
        r["launches"] = r["launches_q5"] + r["launches_q8"]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
