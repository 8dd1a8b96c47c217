"""Measure the port's dense pane fire (``csrc/pane_emit.cu``: one thread
per (slot, pane) over every plane) against three designs it does not use
(``pane_emit_variants.cu``), each with a grid row a plane: one thread per
(slot, plane) folding every pane from its row's live 16-byte chunks held
in registers ("registers"); the same from a shared-memory tile that the
block loads with neighbouring threads on neighbouring chunks ("tile");
and the port's thread per (slot, pane) for one plane ("pane_per_plane").

At the fires chip_smoke.py's phase 3 holds pane_emit to — q8's W=1 k=1
fire at i32 and i64 counts, the mixed W=5 k=8 fire at both, hot items'
W=5 k=1 fire — each variant's buffer is checked bit-equal to the port's,
then torch.profiler's device microseconds of one launch are read, warm
and after a 64 MiB write (cold), for the four designs in turn, over
``--rounds`` rounds.  Prints one JSON line per fire and, last, the card's
name and power limit.

    python3 -m arroyo_tpu_torch.tools.pane_emit_variants [--rounds 3]

Needs one CUDA card and nvcc; builds into build/arroyo_tpu_torch/."""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
# (name, kinds, xfer, C, B, W, k, c_slice, counts dtype, (first_bin, lo, hi))
MIXED = ("count", "sum", "sum", "count", "min", "max", "sum", "sum")
Q8_BIN, HOT_BIN = 8 * 5_000 + 3, 16 * 50 + 6
FIRES = [
    ("q8 W=1 k=1", ("count",), (), 1_048_576, 8, 1, 1, 800_768, "int32",
     (Q8_BIN,) * 3),
    ("q8 W=1 k=1", ("count",), (), 1_048_576, 8, 1, 1, 800_768, "int64",
     (Q8_BIN,) * 3),
    ("mixed W=5 k=8", MIXED, tuple(range(1, 8)), 131_072, 16, 5, 8,
     131_072, "int32", (16 * 9 - 4, 16 * 9 - 2, 16 * 9 + 7)),
    ("mixed W=5 k=8", MIXED, tuple(range(1, 8)), 131_072, 16, 5, 8,
     131_072, "int64", (16 * 9 - 4, 16 * 9 - 2, 16 * 9 + 7)),
    ("hot items W=5 k=1", ("count",), (), 4_194_304, 16, 5, 1, 2_400_256,
     "int32", (HOT_BIN, HOT_BIN, HOT_BIN + 4)),
]


def build_variants():
    from arroyo_tpu_torch.kernels import build
    out = build.BUILD_DIR / "pane_emit_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(HERE / "pane_emit_variants.cu"), "-o", str(out)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).pane_emit_variant
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [i, p, p, i, p, i, i, q, q, q, i, i, i, p, p]
    fn.restype = i
    return fn


def planes(torch, rng, dev, kinds, C, B, cdt):
    """Bin-ring planes as chip_smoke.py's phase 3 makes them: data in 3 of
    4 cells, each channel's identity elsewhere."""
    from arroyo_tpu_torch.kernels.bin_update import channel_identity
    values = torch.empty((len(kinds), C, B), dtype=torch.float64, device=dev)
    for j, kind in enumerate(kinds):
        values[j] = torch.tensor(rng.normal(size=(C, B)) * 100, device=dev)
        values[j][torch.tensor(rng.random((C, B)) < 0.25, device=dev)] = \
            channel_identity(kind)
    counts = torch.tensor(rng.poisson(2.0, (C, B)), dtype=cdt, device=dev)
    return values, counts


def device_us(torch, fn, before=None, reps=20):
    """Mean device microseconds of the pane-fire kernel of one ``fn``
    call (torch.profiler), ``before`` run ahead of each call."""
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
             and ("pane_emit" in e.name or "variant" in e.name)]
    return statistics.fmean(times) if times else None


def main():
    import numpy as np
    import torch

    from arroyo_tpu_torch.kernels import build
    from arroyo_tpu_torch.kernels import pane_emit as pm

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    variant = build_variants()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    for name, kinds, xfer, C, B, W, k, c_slice, cdt, geometry in FIRES:
        cdt = getattr(torch, cdt)
        values, counts = planes(torch, rng, dev, kinds, C, B, cdt)
        args = (values, counts, *geometry, W, k, kinds, xfer, c_slice)
        port = pm.pane_emit(*args)
        spec = pm._check(values, counts, W, k, kinds, xfer, c_slice)
        calls = {"port": lambda: pm.pane_emit(*args)}
        for code, what in ((1, "registers"), (2, "tile"),
                           (3, "pane_per_plane")):
            buf = torch.empty_like(port)

            def call(code=code, buf=buf):
                build.launch("pane_emit_variant", variant, dev, code,
                             values.data_ptr(), counts.data_ptr(),
                             int(cdt == torch.int64), spec, C, B,
                             *geometry, W, k, c_slice, buf.data_ptr())

            call()
            torch.cuda.synchronize()
            if not torch.equal(buf, port):
                raise AssertionError(f"{what} differs from the port ({name})")
            calls[what] = call
        res = {what: {"warm_us": [], "cold_us": []} for what in calls}
        for _ in range(opts.rounds):
            for what, call in calls.items():
                res[what]["warm_us"].append(device_us(torch, call))
                res[what]["cold_us"].append(
                    device_us(torch, call, before=flush.zero_))
        print(json.dumps({"fire": f"{name} {cdt}", "C": C, "B": B,
                          "c_slice": c_slice, **res}), flush=True)
        del values, counts, port
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
