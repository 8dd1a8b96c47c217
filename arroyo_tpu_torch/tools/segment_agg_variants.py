"""Measure the port's segment reduce (``csrc/segment_agg.cu``) against
variants of the same source that differ in one constant each: the cap on
blocks per SM that its ``__launch_bounds__`` asks for (4 in the port: at
most 64 registers, so the 512 tiles of 2^20 rows run in one wave; 3 and
2 let the compiler use more registers and run two waves), and the rows a
thread folds (8 in the port; 4 halves the tile to 1,024 rows).

At the two 2^20-row shapes chip_smoke.py's phase 3 holds segment_agg to
— 65,536 segments and one skewed segment, seven channels of which six
reduce values — each variant's counts, min and max are checked equal to
the port's and its sums within rtol 1e-12 of them (a tile of other size
adds in another order), then torch.profiler's device microseconds of
one launch are read, warm and after a 64 MiB write (cold), for every
variant in turn, over ``--rounds`` rounds.  Prints one JSON line per
shape and, last, the card's name and power limit.

    python3 -m arroyo_tpu_torch.tools.segment_agg_variants [--rounds 3]

Needs one CUDA card and nvcc; builds into build/arroyo_tpu_torch/."""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

# (name, blocks per SM cap, rows a thread folds)
VARIANTS = [("port", 4, 8), ("cap3", 3, 8), ("cap2", 2, 8), ("rows4", 4, 4)]
MIXED7 = ("sum", "min", "max", "count", "sum", "min", "max")
SHAPES = [("mixed k=7 n=1048576 n_seg=65536", 1 << 20, 65_536, MIXED7),
          ("one skewed segment k=7 n=1048576", 1 << 20, 1, MIXED7)]


def variant_source(text: str, cap: int, per: int) -> str:
    for old, new in (
            ("constexpr int kPer = 8;", f"constexpr int kPer = {per};"),
            ("constexpr int kBlocksPerSm = 4;",
             f"constexpr int kBlocksPerSm = {cap};")):
        if old not in text:
            raise RuntimeError(f"csrc/segment_agg.cu no longer has {old!r}")
        text = text.replace(old, new)
    return text


def build_variants():
    """{name: (C launcher, rows a tile)}, each variant compiled from the
    port's source into its own library, all nvcc processes at once."""
    from arroyo_tpu_torch.kernels import build
    out_dir = build.BUILD_DIR / "segment_agg_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "segment_agg.cu").read_text()
    procs = []
    for name, cap, per in VARIANTS:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, cap, per))
        so = out_dir / f"{name}.so"
        procs.append((name, per, so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC_DIR}",
             "-shared", str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, per, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {regs}")
        fn = ctypes.CDLL(str(so)).arroyo_segment_agg
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, q, p, i, p, i, p, q, p]
        fn.restype = i
        fns[name] = (fn, 256 * per)
    return fns


def device_us(fn, flush=None, reps=20):
    """Mean device microseconds of the segment_agg_kernel launch of one
    ``fn()`` call (torch.profiler), ``flush`` run before each call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "segment_agg_kernel" in e.name]
    return statistics.fmean(times) if times else None


def main():
    import numpy as np
    import torch
    from arroyo_tpu_torch.kernels.segment_agg import KIND_CODES

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("segment_agg_variants needs a CUDA card")
    fns = build_variants()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for label, n, n_seg, kinds in SHAPES:
        cuts = np.sort(rng.choice(np.arange(1, n), n_seg - 1, replace=False))
        offsets = torch.tensor(np.concatenate([[0], cuts, [n]]), device=dev)
        k, k_r = len(kinds), sum(x != "count" for x in kinds)
        values = torch.tensor(rng.normal(size=(k_r, n)) * 1e3, device=dev)
        codes = np.asarray([KIND_CODES[x] for x in kinds], dtype=np.int32)
        calls, bufs = {}, {}
        for name, (fn, tile) in fns.items():
            tiles = -(-n // tile)
            scratch = 2 * (k_r + 1) * tiles if tiles > 1 else 0
            buf = torch.empty((k + 1) * n_seg + scratch, dtype=torch.int64,
                              device=dev)

            def call(fn=fn, buf=buf, scratch=scratch):
                rc = fn(values.data_ptr(), n, offsets.data_ptr(), n_seg,
                        codes.ctypes.data, k, buf.data_ptr(), scratch,
                        stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc} at launch")
            call()
            calls[name] = call
            bufs[name] = buf[:(k + 1) * n_seg].view(k + 1, n_seg)
        torch.cuda.synchronize()
        port = bufs["port"]
        for name, got in bufs.items():
            same = torch.equal(got[0], port[0])
            for c, kind in enumerate(kinds):
                g, w = (t[1 + c].view(torch.float64) for t in (got, port))
                same &= (torch.allclose(g, w, rtol=1e-12, atol=1e-9)
                         if kind == "sum" else torch.equal(g, w))
            if not same:
                raise AssertionError(f"{name} differs from the port ({label})")
        rounds = {name: {"warm": [], "cold": []} for name in calls}
        for _ in range(opts.rounds):
            for name, call in calls.items():
                rounds[name]["warm"].append(device_us(call))
                rounds[name]["cold"].append(device_us(call, flush.zero_))
        print(json.dumps({"shape": label, "device_us": {
            name: {mode: statistics.fmean(v) for mode, v in r.items()}
            for name, r in rounds.items()}, "rounds": rounds}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
