"""Measure the compact fire's count call (``csrc/emit_compact.cu``
``emit_count``: a block four 256-cell groups, storing its cells' counts
after it counts itself in at its superblock of 64 groups, the last block
of a superblock to arrive scanning them, a look-back a superblock)
against designs it does not use (``emit_count_variants.cu``): one group
a block with a look-back for every group ("cell"), the same with its
groups handed out by a ticket counter ("cell_ticket"), tiles of up to
1,024 slots whose read columns a block first stages in shared memory
("stage"), a grid of the blocks the card holds at once, each a chunk of
whole 256-slot runs with one look-back ("chunk"), and the port's kernel
with one group a block ("g1") or with the counts stored before the
block's arrival ("g4").  All write the same cnt and offsets in one
launch with a decoupled look-back.

At hot items' compact fires as chip_smoke.py's phase 3 makes them
(3,000,000 occupied slots of C = 4,194,304, B = 16, W = 5, a quarter of
the pane cells live; k = 1 and k = 5, i32 counts, and k = 5 at i64),
each variant's cnt and offsets are checked equal to the port's, then
torch.profiler's device microseconds of one launch are read, warm and
after a 64 MiB write (cold), for every design in turn, over ``--rounds``
rounds.  Prints one JSON line per fire and, last, the card's name and
power limit.

    python3 -m arroyo_tpu_torch.tools.emit_count_variants [--rounds 3]

Needs one CUDA card and nvcc; builds into build/arroyo_tpu_torch/."""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
C, B, W, ROWS, DENSITY = 4_194_304, 16, 5, 3_000_000, 0.25
FIRES = [(1, "int32"), (5, "int32"), (5, "int64")]
# (code, name, workspace words a group, ticket word)
VARIANTS = [(1, "cell", 1, 0), (2, "stage", 1, 0), (3, "cell_ticket", 1, 1),
            (4, "chunk", 1, 0), (5, "g1", 2, 0), (6, "g4", 2, 0)]


def build_variants():
    from arroyo_tpu_torch.kernels import build
    out = build.BUILD_DIR / "emit_count_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(HERE / "emit_count_variants.cu"), "-o", str(out)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).emit_count_variant
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, i, p, p, i, i, i, i, p, p, p, ctypes.c_uint, p]
    fn.restype = i
    return fn


def device_us(torch, fn, before=None, reps=20):
    """Mean device microseconds of the count kernel of one ``fn`` call
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
             and any(n in e.name for n in ("count_", "stage_kernel",
                                           "chunk_kernel", "super_kernel"))]
    return statistics.fmean(times) if times else None


def main():
    import numpy as np
    import torch

    from arroyo_tpu_torch.kernels import build
    from arroyo_tpu_torch.kernels import emit_compact as ec
    from arroyo_tpu_torch.kernels.pane_emit import fire_geometry

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    variant = build_variants()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    q = 1 - (1 - DENSITY) ** (1 / W)  # a bin holds rows
    cells = np.where(rng.random((ROWS, B)) < q,
                     rng.integers(1, 9, (ROWS, B)), 0)
    for k, cdt in FIRES:
        cdt = getattr(torch, cdt)
        counts = torch.zeros((C, B), dtype=cdt, device=dev)
        counts[:ROWS] = torch.tensor(cells, device=dev).to(cdt)
        ring_np, ok_np = fire_geometry(3, 3, 3 + k + W - 2, W, k, B)
        ring = torch.tensor(ring_np, device=dev)
        ok = torch.tensor(ok_np, device=dev)
        want = ec.emit_count(counts, ring, ok, ROWS)
        calls = {"port": lambda: ec.emit_count(counts, ring, ok, ROWS)}
        groups = -(-ROWS * k // ec.THREADS)
        for code, name, words, ticket in VARIANTS:
            cnt = torch.empty_like(want[0])
            offsets = torch.empty_like(want[1])
            # status words (and the superblock variants' arrival counters)
            ws = torch.zeros(ticket + words * groups, dtype=torch.int64,
                             device=dev)
            epoch = [0]

            def call(code=code, cnt=cnt, offsets=offsets, ws=ws, epoch=epoch):
                epoch[0] += 1
                build.launch("emit_count_variant", variant, dev, code,
                             counts.data_ptr(), int(cdt == torch.int64),
                             ring.data_ptr(), ok.data_ptr(), B, W, k, ROWS,
                             cnt.data_ptr(), offsets.data_ptr(),
                             ws.data_ptr(), epoch[0])

            for _ in range(2):  # a fresh workspace, then a later epoch
                call()
                torch.cuda.synchronize()
                if not (torch.equal(cnt, want[0])
                        and torch.equal(offsets, want[1])):
                    raise AssertionError(f"{name} differs from the port "
                                         f"(k={k} {cdt})")
            calls[name] = call
        res = {name: {"warm_us": [], "cold_us": []} for name in calls}
        for _ in range(opts.rounds):
            for name, call in calls.items():
                res[name]["warm_us"].append(device_us(torch, call))
                res[name]["cold_us"].append(
                    device_us(torch, call, before=flush.zero_))
        print(json.dumps({"fire": f"hot items k={k} {cdt}", "rows": ROWS,
                          "C": C, "B": B, "W": W, **res}), flush=True)
        del counts
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
