"""Measure the port's long-window pane fire (``csrc/ring_emit.cu``: a warp
per (plane, slot), the panes in groups that share a middle, the middle a
lane-strided reduction and a butterfly, scans only over the heads and
tails) against a design it does not use (``ring_emit_variants.cu``: a
block stages a tile of 256 rows in shared memory, 32 span positions at
a time with double-buffered cp.async copies, a thread walking a row
sequentially; "tile").

At the fires chip_smoke.py's phase 3 holds ring_emit to — phase 19's
median fire (10,004 rows, 201 live positions of a W = 300 span) and
262,144 rows with every position live at k = 1 and k = 64 — each
design's buffer is checked bit-equal to the other's on integer-valued
planes (COUNT, SUM, MAX and the counts, as phase 19's state holds them),
then torch.profiler's device microseconds of one launch are read, warm
and after a 64 MiB write (cold), for the two designs in turn, over
``--rounds`` rounds.  Prints one JSON line per fire and, last, the card's
name and power limit.

    python3 -m arroyo_tpu_torch.tools.ring_emit_variants [--rounds 3]

Needs one CUDA card and nvcc; builds into build/arroyo_tpu_torch/."""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
KINDS = ("count", "sum", "max", "sum", "sum")
XFER = (1, 2, 3, 4)
W = 300
BIG = 1_024 * 7 + 900
# (name, C, B, rows, (first_bin, lo, hi), k)
FIRES = [
    ("median fire", 16_384, 1_024, 10_004, (-99, 0, 201), 1),
    ("262,144 rows k=1", 262_144, 1_024, 262_144, (BIG, BIG, BIG + W - 1),
     1),
    ("262,144 rows k=64", 262_144, 1_024, 262_144,
     (BIG, BIG, BIG + W + 62), 64),
]


def build_variant():
    from arroyo_tpu_torch.kernels import build
    out = build.BUILD_DIR / "ring_emit_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(HERE / "ring_emit_variants.cu"), "-o", str(out)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).ring_emit_variant
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, i, p, i, i, q, q, q, i, i, i, p, p]
    fn.restype = i
    return fn


def planes(torch, dev, C, B):
    """Integer prices in 3 of 4 cells, each channel's identity elsewhere;
    counts Poisson(2) (a seeded generator on the card)."""
    from arroyo_tpu_torch.kernels.bin_update import channel_identity
    gen = torch.Generator(device=dev).manual_seed(C + B)
    values = torch.empty((len(KINDS), C, B), dtype=torch.float64, device=dev)
    for j, kind in enumerate(KINDS):
        torch.randint(100, 100_000, (C, B), generator=gen, device=dev,
                      dtype=torch.float64, out=values[j])
        dead = torch.rand((C, B), generator=gen, device=dev) < 0.25
        values[j].masked_fill_(dead, channel_identity(kind))
    counts = torch.poisson(torch.full((C, B), 2.0, device=dev),
                           generator=gen).to(torch.int32)
    return values, counts


def device_us(torch, fn, before=None, reps=20):
    """Mean device microseconds of the fire kernel of one ``fn`` call
    (torch.profiler), ``before`` run ahead of each call."""
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
             and "ring_emit" in e.name]
    return statistics.fmean(times) if times else None


def main():
    import torch

    from arroyo_tpu_torch.kernels import build
    from arroyo_tpu_torch.kernels.ring_emit import _check, ring_emit

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    variant = build_variant()
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    for name, C, B, rows, (first_bin, lo, hi), k in FIRES:
        values, counts = planes(torch, dev, C, B)
        args = (values, counts, first_bin, lo, hi, W, k, KINDS, XFER, rows)
        port = ring_emit(*args)
        spec = _check(values, counts, W, k, KINDS, XFER, rows)
        buf = torch.empty_like(port)

        def tile(buf=buf, spec=spec, args=args):
            build.launch("ring_emit_variant", variant, dev,
                         values.data_ptr(), counts.data_ptr(), 0, spec, C,
                         B, first_bin, lo, hi, W, k, rows, buf.data_ptr())

        tile()
        torch.cuda.synchronize()
        if not torch.equal(buf, port):
            raise AssertionError(f"tile differs from the port ({name})")
        calls = {"port": lambda args=args: ring_emit(*args), "tile": tile}
        res = {what: {"warm_us": [], "cold_us": []} for what in calls}
        for _ in range(opts.rounds):
            for what, call in calls.items():
                res[what]["warm_us"].append(device_us(torch, call))
                res[what]["cold_us"].append(
                    device_us(torch, call, before=flush.zero_))
        print(json.dumps({"fire": name, "C": C, "B": B, "rows": rows,
                          "k": k, "W": W, **res}), flush=True)
        del values, counts, port, buf
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
