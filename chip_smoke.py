"""Smoke test of the PyTorch/CUDA port (arroyo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. environment: torch/CUDA versions, the card, its power limit;
2. build: the CUDA kernels from arroyo_tpu_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes nexmark q5 gives it, timed with CUDA events beside its
   plain version, a one-call PyTorch yardstick where one exists, and its
   least possible time on an H100 (bytes / 3.35 TB/s);
4. state: the port's KeyedBinState (q5 aggregates, local argmax) over
   2,000,000 nexmark events on the card and on the CPU — every fire and
   the final snapshot identical, and a card snapshot restored into a
   fresh card state fires identically;
5. main path: nexmark q5 through ``LocalRunner`` at bench.py's size
   (2,000,000 events, batches of 131,072) on the card and on the CPU —
   identical sink rows, both kernels launched during the card run, and
   the share of wall time spent in synchronized kernel calls
   (``ARROYO_TIMING=1``, a separate run).

It prints a ``{"kernels": [...]}`` line, the card's name and power limit
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
    EVENT_BID, NexmarkConfig, NexmarkGenerator, make_splits)
from arroyo_tpu_torch.engine.engine import LocalRunner  # noqa: E402
from arroyo_tpu_torch.graph.logical import AggKind, AggSpec  # noqa: E402
from arroyo_tpu_torch.kernels import build  # noqa: E402
from arroyo_tpu_torch.kernels.argmax_fire import (  # noqa: E402
    argmax_fire, argmax_fire_reference)
from arroyo_tpu_torch.kernels.bin_update import (  # noqa: E402
    bin_update, bin_update_reference)
from arroyo_tpu_torch.obs import perf  # noqa: E402
from arroyo_tpu_torch.ops.keyed_bins import KeyedBinState  # noqa: E402
from arroyo_tpu_torch.q5 import SLIDE_MICROS, WIDTH_MICROS, q5_program  # noqa: E402
from arroyo_tpu_torch.types import hash_columns  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F64_OPS_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores, data sheet
NUM_EVENTS = 2_000_000  # bench.py:35
BATCH = 131_072  # bench.py:38
C_Q5, B_Q5 = 131_072, 16  # q5's key capacity and ring at that size

K1_SOURCE = "arroyo_tpu_torch/csrc/bin_update.cu"
K1_REPLACES = ("arroyo_tpu/ops/keyed_bins.py:62 _update_kernel; "
               "arroyo_tpu/ops/pallas_kernels.py:77 _scatter_kernel")
K2_SOURCE = "arroyo_tpu_torch/csrc/argmax_fire.cu"
K2_REPLACES = ("arroyo_tpu/ops/keyed_bins.py:157 _argmax_nnz_kernel + "
               ":180 _argmax_gather_kernel")


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
            "bound_ms": bms, "bound_by": by, "library_ms": library}


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
            "bound_ms": bms, "bound_by": by, "library_ms": None}


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
    bin_update.launches = argmax_fire.launches = 0
    dt, rows = run_q5("smoke-cuda", None)  # device=None: the card
    launches = {"bin_update": bin_update.launches,
                "argmax_fire": argmax_fire.launches}
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
    check(all(v > 0 for v in launches.values()),
          f"main path did not launch every kernel: {launches}")
    print("q5 main path: " + json.dumps({
        "events": NUM_EVENTS, "batch": BATCH, "wall_s": dt,
        "events_per_s": NUM_EVENTS / dt, "rows": len(rows),
        "launches": launches, "cpu_wall_s": dt_cpu,
        "timed_wall_s": dt_timed, "timed_device_s": device_s,
        "device_share": device_s / dt_timed,
        "kernel_dispatches": perf.counter("kernel_dispatches")}))
    return launches


def main():
    smi = environment()
    kernels = kernel_phase()
    state_phase()
    launches = main_path()
    for row in kernels:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
