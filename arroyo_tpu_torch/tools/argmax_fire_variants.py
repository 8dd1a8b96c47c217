"""Measure the argmax fire (``csrc/argmax_fire.cu``: one cooperative
launch of the blocks the card holds at once, one grid barrier) against
designs it does not use (``argmax_fire_variants.cu``): the same kernel on
at most 1, 2 or 4 blocks a SM ("sm1", "sm2", "sm4": longer chunks, fewer
blocks at each barrier; skipped where the card holds fewer), and two
ordinary launches, the extremum first, then the selection with a
decoupled look-back ("two_launches").

At q5's real fire (119,938 occupied slots of C = 131,072, B = 16, one
live bin in five of eight panes, i32, max), at two of chip_smoke.py's
phase-3 shapes (all 131,072 slots, kpad 8 max i32 and kpad 1 min i64),
at 2^21 slots with kpad 8 (the port's blocks read their chunks again
after the barrier) and at one occupied slot (one block: the floor of a
call), each variant's buffer is checked equal to the port's, then
torch.profiler's device microseconds of one call (its
launches summed) are read, warm and after a 64 MiB write (cold), for
every design in turn, over ``--rounds`` rounds.  Prints one JSON line
per fire and, last, the card's name and power limit.

    python3 -m arroyo_tpu_torch.tools.argmax_fire_variants [--rounds 3]

Needs one CUDA card and nvcc; builds into build/arroyo_tpu_torch/."""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
B, W = 16, 5
# q5's one argmax fire at bench.py's 2,000,000 events (a CPU run of its
# path): 119,938 occupied slots of 131,072, one live ring bin (column 0)
# in each of the first five of eight panes
Q5_ROWS = 119_938
Q5_RING = [[12, 13, 14, 15, 0], [13, 14, 15, 0, 1], [14, 15, 0, 1, 2],
           [15, 0, 1, 2, 3], [0, 1, 2, 3, 4]] + [[0] * 5] * 3
Q5_OK = [[w == 4 - p for w in range(5)] if p < 5 else [False] * 5
         for p in range(8)]
# (name, C, occupied rows, kpad or None for q5's panes, mode, dtype)
FIRES = [("q5 fire", 131_072, Q5_ROWS, None, "max", "int32"),
         ("full kpad 8", 131_072, 131_072, 8, "max", "int32"),
         ("full kpad 1 min", 131_072, 131_072, 1, "min", "int64"),
         ("2^21 kpad 8", 1 << 21, 1 << 21, 8, "max", "int32"),
         ("one slot", 131_072, 1, 1, "max", "int32")]
VARIANTS = [("sm1", 1), ("sm2", 2), ("sm4", 4), ("two_launches", 0)]


def build_variants():
    from arroyo_tpu_torch.kernels import build
    out = build.BUILD_DIR / "argmax_fire_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(HERE / "argmax_fire_variants.cu"), "-o", str(out)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).argmax_fire_variant
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = [i, p, i, p, p, i, i, i, i, i, p, i, p, u, i, p, p]
    fn.restype = i
    return fn


def device_us(torch, fn, before=None, reps=20):
    """Mean device microseconds of one ``fn`` call, its argmax launches
    summed (torch.profiler), ``before`` run ahead of each call."""
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
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(n in e.name for n in ("argmax_kernel", "ext_kernel",
                                           "select_kernel"))]
    return sum(times) / reps if times else None


def main():
    import numpy as np
    import torch

    from arroyo_tpu_torch.kernels import argmax_fire as af
    from arroyo_tpu_torch.kernels import build

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    variant = build_variants()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    panes = af.WORKSPACE_PANES
    words = af._c_fns()[1](panes)
    for name, C, rows, kpad, minmax, cdt in FIRES:
        cdt = getattr(torch, cdt)
        if kpad is None:
            ring_np, ok_np = np.array(Q5_RING, np.int32), np.array(Q5_OK)
        else:
            ring_np = ((np.arange(kpad)[:, None] + np.arange(W)[None, :])
                       % B).astype(np.int32)
            ok_np = np.ones((kpad, W), dtype=bool)
            ok_np[0, :2] = False
        cells = rng.poisson(2.0, (C, B))
        cells[rows:] = 0
        counts = torch.tensor(cells, dtype=cdt, device=dev)
        ring = torch.tensor(ring_np, device=dev)
        ok = torch.tensor(ok_np, device=dev)
        total = af.argmax_fire_reference(counts, ring, ok, minmax)[0].shape[1]
        cap = max(1024, 2 * total)
        want = af.argmax_views(
            af.argmax_fire_buffer(counts, ring, ok, rows, minmax, cap),
            total, cap, cdt)
        calls = {"port": lambda: af.argmax_fire_buffer(
            counts, ring, ok, rows, minmax, cap)}
        for vname, per_sm in VARIANTS:
            ws = torch.zeros(words, dtype=torch.int64, device=dev)
            status = torch.zeros(rows * ring_np.shape[0] // 256 + 2,
                                 dtype=torch.int64, device=dev)
            state = {"calls": 0}

            def call(per_sm=per_sm, ws=ws, status=status, state=state):
                buf = torch.empty(af.argmax_layout(cap, counts.element_size())
                                  [1], dtype=torch.int32, device=dev)
                state["calls"] += 1
                build.launch("argmax_fire_variant", variant, dev, per_sm,
                             counts.data_ptr(), int(cdt == torch.int64),
                             ring.data_ptr(), ok.data_ptr(), B, W,
                             ring_np.shape[0], rows, int(minmax == "max"),
                             ws.data_ptr(), panes, status.data_ptr(),
                             state["calls"], cap,
                             buf.data_ptr())
                return buf

            try:
                call()
            except RuntimeError as e:  # more blocks than the card holds
                print(f"{vname} ({name}): {e}", flush=True)
                continue
            for _ in range(3):  # the workspace each call leaves zero
                got = call()
                torch.cuda.synchronize()
                if int(got[0]) != total or not all(torch.equal(x, y) for x, y
                                                   in zip(af.argmax_views(
                                                       got, total, cap, cdt),
                                                       want)):
                    raise AssertionError(f"{vname} differs from the port "
                                         f"({name})")
            calls[vname] = call
        res = {v: {"warm_us": [], "cold_us": []} for v in calls}
        for _ in range(opts.rounds):
            for v, call in calls.items():
                res[v]["warm_us"].append(device_us(torch, call))
                res[v]["cold_us"].append(
                    device_us(torch, call, before=flush.zero_))
        # a profile that recorded no device activity gives None
        summary = {v: {f"{k[:-3]}_median_us": statistics.median(
            [t for t in r[k] if t is not None] or [float("nan")])
            for k in ("warm_us", "cold_us")} for v, r in res.items()}
        print(json.dumps({"fire": name, "C": C, "rows": rows,
                          "kpad": int(ring_np.shape[0]),
                          "live_bins": int(ok_np.sum()), "minmax": minmax,
                          "dtype": str(cdt), "candidates": total,
                          "summary": summary, **res}), flush=True)
        del counts
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
