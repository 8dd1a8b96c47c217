"""Where ``join_sort``'s time goes on the card, and designs it does not
use: ``join_sort_variants.cu`` (``csrc/join_sort.cu`` with build-time
knobs) built with ``-DARROYO_SORT_TRACE`` (thread 0 of each block records
clock64 at the phase boundaries of each pass and %globaltimer at its
start and end), with ``-DARROYO_SORT_MATCH_ANY`` (a round's equal digits
found by ``__match_any_sync``), with ``-DARROYO_SORT_BALLOTS`` (found by
nine ballots where more than two digit bits differ in the warp, instead
of a shared atomic), with ``-DARROYO_SORT_SMALL_MAX=4096`` (a lower
limit for the one-block path, whose kernel sorts up to 8,192 keys: the
onesweep path above it), and with ``-DARROYO_SORT_G1_MAX=0`` and
``=4096`` (the one-block path in blocks of 256 threads up to no keys or
to 4,096 keys, of 1,024 above; the port takes 256 up to 2,048).

For each size (the one-block path's 512-8,192, the onesweep
path's 16,384, 32,768, 65,536, 524,288 and 2^20) and key kind (hash-like; one
varying byte of 256 values), a seventh SENTINEL padding: every build's
outputs are checked equal to the package's ``join_sort``; the package's
kernel and each variant are timed in turns by torch.profiler's device
microseconds a call (launches summed), ``--rounds`` rounds of (package,
variant, variant, package); then one traced call gives, for each pass
that runs, the medians over its tiles of the phases' SM cycles (one
block: gather, rank, offsets, scatter; onesweep: load and rank,
offsets, reorder, look-back, write) and those of its tile that ended
last, the package kernel's device microseconds by kernel name, the
pass's wall microseconds
from its first tile's start to its last tile's end, and how far apart
the tiles started.  Prints one JSON line a case and, last, the card's
name and power limit.

    python3 -m arroyo_tpu_torch.tools.join_sort_variants [--rounds 3]

Needs one CUDA card and nvcc; builds into build/arroyo_tpu_torch/."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np

SIZES = (512, 1_024, 2_048, 4_096, 8_192, 16_384, 32_768, 65_536, 524_288, 1 << 20)
KINDS = ("hash", "few")
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
TRACE_TILES = 4096  # join_sort_variants.cu kTraceTiles
SMALL = ("gather", "rank", "offsets", "scatter")
SWEEP = ("load_rank", "offsets", "reorder", "look_back", "write")
VARIANTS = {"match_any": "ARROYO_SORT_MATCH_ANY",
            "ballots": "ARROYO_SORT_BALLOTS",
            "one_block_4096": "ARROYO_SORT_SMALL_MAX=4096",
            "one_block_g4": "ARROYO_SORT_G1_MAX=0",
            "one_block_g1_4096": "ARROYO_SORT_G1_MAX=4096"}
HERE = Path(__file__).resolve().parent


def _keys(rng, n, kind):
    m = n - n // 7
    k = np.full(n, SENTINEL, np.uint64)
    if kind == "hash":
        k[:m] = rng.integers(0, 2**64 - 1, m, dtype=np.uint64)
    else:
        k[:m] = ((rng.integers(0, 256, m).astype(np.uint64) << np.uint64(40))
                 | np.uint64(7))
    return k


def _build(flag):
    from ..kernels import build
    name = re.sub(r"\W", "_", flag.lower())
    out = build.BUILD_DIR / f"join_sort_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, f"-D{flag}",
                    "-shared", str(HERE / "join_sort_variants.cu"), "-o",
                    str(out)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.join_sort_variant.argtypes = [p, ll, p, p]
    lib.join_sort_variant_words.argtypes = [ll]
    lib.join_sort_variant_words.restype = ll
    return lib


def _caller(lib, kt):
    """A call of ``lib``'s join_sort on ``kt`` into a buffer of its own."""
    import torch
    n = kt.shape[0]
    buf = torch.empty(lib.join_sort_variant_words(n), dtype=torch.int64,
                      device=kt.device)

    def call():
        rc = lib.join_sort_variant(kt.data_ptr(), n, buf.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"join_sort variant: CUDA error {rc}")
        return buf[:n], buf[n:2 * n]
    return call


def _by_kernel(fn, reps=20):
    """{kernel name: mean device microseconds of one ``fn`` call}, from
    torch.profiler's device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # now and then a profile records no device activity
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events()):
            break
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"([A-Za-z_]\w*)(?:<[^()]*>)?\(", e.name)
            name = m.group(1) if m else e.name[:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return out


def _device_us(fn, reps=20):
    """Mean device microseconds of one ``fn`` call, launches summed."""
    return sum(_by_kernel(fn, reps).values())


def _trace(lib, kt, n):
    """Per pass that ran: phase cycles (medians over tiles), wall µs and
    the spread of the tiles' starts, from one traced call."""
    import torch

    from ..kernels.join_sort import ONE_BLOCK_MAX
    one_block = n <= ONE_BLOCK_MAX
    tiles = 1 if one_block else -(-n // 4096)
    trace = torch.zeros(8 * TRACE_TILES * 8, dtype=torch.int64,
                        device=kt.device)
    call = _caller(lib, kt)
    call()
    torch.cuda.synchronize()
    lib.join_sort_variant_trace(ctypes.c_void_p(trace.data_ptr()))
    call()
    torch.cuda.synchronize()
    lib.join_sort_variant_trace(ctypes.c_void_p(0))
    t = trace.view(8, TRACE_TILES, 8)[:, :tiles].cpu().numpy()
    names = SMALL if one_block else SWEEP
    out = {}
    for d in range(8):
        if not t[d, :, 6].any():
            continue
        phases = {name: float(np.median(t[d, :, i + 1] - t[d, :, i]))
                  for i, name in enumerate(names)}
        last = int(np.argmax(t[d, :, 7]))
        out[f"pass {d}"] = {
            "cycles": phases,
            "last_tile": {"tile": last, **{
                name: int(t[d, last, i + 1] - t[d, last, i])
                for i, name in enumerate(names)}},
            "wall_us": float(t[d, :, 7].max() - t[d, :, 6].min()) / 1e3,
            "tile_start_spread_us":
                float(t[d, :, 6].max() - t[d, :, 6].min()) / 1e3}
    return out


def main() -> None:
    import torch

    from ..kernels.join_sort import join_sort

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    traced = _build("ARROYO_SORT_TRACE")
    traced.join_sort_variant_trace.argtypes = [ctypes.c_void_p]
    libs = {name: _build(flag) for name, flag in VARIANTS.items()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n in SIZES:
        for kind in KINDS:
            kt = torch.tensor(_keys(rng, n, kind).view(np.int64), device=dev)
            want = join_sort(kt)
            row = {"n": n, "kind": kind}
            for name, lib in [("trace", traced), *libs.items()]:
                got = _caller(lib, kt)()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise SystemExit(f"{name} differs at n={n} {kind}")

            def mine():
                return join_sort(kt)
            for name, lib in libs.items():
                other, seq = _caller(lib, kt), []
                for _ in range(opts.rounds):
                    seq += [_device_us(mine), _device_us(other),
                            _device_us(other), _device_us(mine)]
                row[name] = {
                    "device_us": statistics.fmean(seq[0::4] + seq[3::4]),
                    "variant_device_us": statistics.fmean(seq[1::4]
                                                          + seq[2::4]),
                    "turns_us": seq}
            row["by_kernel"] = _by_kernel(mine)
            row["trace"] = _trace(traced, kt, n)
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(re.sub(r"\s+", " ", smi))


if __name__ == "__main__":
    main()
