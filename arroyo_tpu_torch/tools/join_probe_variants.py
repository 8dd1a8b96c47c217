"""Measure the u64 ``join_probe`` kernel (``csrc/join_probe.cu``
``probe_u64``) two ways, from builds of its own source with compile-time
switches (the port's library is not touched):

* ``tiles``: the two dense tiles, 1,024 queries a block (256 threads,
  four each) and 2,048 (eight each), each forced on every dense probe by
  ``-DARROYO_PROBE_TILE``, at chip_smoke.py's ``SORT_BUCKETS`` probes
  (the sorted left bucket of n, an eighth SENTINEL, against a right
  bucket of n drawn from its keys, a fifth SENTINEL, a third absent).
  Each build's outputs are held bit-equal to the plain version; then the
  two are timed in turns (A B B A, ``--rounds`` times) by CUDA events
  around 20 queued calls (each a memset and the launch), and the median
  microseconds a call printed beside the tiles each takes.  The port
  takes 1,024 up to 32 tiles (32,768 queries) and 2,048 above.
* ``timeline``: ``-DARROYO_PROBE_STAMPS`` makes each block's first thread
  write a globaltimer stamp at each of the kernel's marks (start, tile
  ticket, window found, window staged, queries merged, carry looked back,
  end); at 2^20 (the bucket above) and at 2^20 padding queries, which
  search nothing, prints the span from the first block's start to the
  last block's end and each phase's length over the blocks (median, 90th
  percentile, largest).

Prints one JSON line per probe and, last, the card's name and power
limit.

    python3 -m arroyo_tpu_torch.tools.join_probe_variants [--rounds 5]
        [--what tiles timeline]

Needs one CUDA card and nvcc; builds into build/arroyo_tpu_torch/."""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "csrc" / "join_probe.cu"
BUCKETS = (512, 8_192, 32_768, 524_288, 1_048_576)  # chip_smoke.py
PHASES = ("ticket", "window", "staged", "merged", "looked back", "end")
MAX_BLOCKS = 1 << 16  # csrc/join_probe.cu kMaxStampedBlocks


def build_variant(name: str, defines):
    """join_probe.cu built alone with ``defines`` into its own library."""
    from arroyo_tpu_torch.kernels import build
    out = build.BUILD_DIR / f"join_probe_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS,
                    *[f"-D{d}" for d in defines], "-shared", str(SRC),
                    "-o", str(out)], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(out))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.arroyo_join_probe_u64.argtypes = [p, ll, p, ll, ll, ll, p, p, p, p, p]
    lib.arroyo_join_probe_u64.restype = ctypes.c_int
    if "ARROYO_PROBE_STAMPS" in defines:
        lib.arroyo_probe_stamps.argtypes = [p]
        lib.arroyo_probe_stamps.restype = ctypes.c_int
    return lib


def bucket_probe(np, torch, dev, n):
    """chip_smoke.py's ``k9_u64_case`` inputs at ``n``: (name, queries,
    plane, m, n_valid)."""
    rng = np.random.default_rng(n)
    m, n_valid = n - n // 8, n - n // 5
    sentinel = np.uint64(2**64 - 1)
    pool = rng.integers(0, 2**64 - 1, max(m // 2, 1), dtype=np.uint64)
    lk = np.full(n, sentinel, np.uint64)
    rk = np.full(n, sentinel, np.uint64)
    lk[:m] = np.sort(rng.choice(pool, m))
    rk[:n_valid] = np.sort(np.concatenate([
        rng.choice(pool, n_valid - n_valid // 3),
        rng.integers(0, 2**64 - 1, n_valid // 3, dtype=np.uint64)]))
    return (f"u64 legacy probe n={n} m={m} n_valid={n_valid}",
            torch.tensor(lk.view(np.int64), device=dev),
            torch.tensor(rk.view(np.int64), device=dev), m, n_valid)


class Probe:
    """One probe's outputs and scratch (sized for the smallest tile) and
    a call of a build's kernel on them."""

    def __init__(self, torch, q, h, m, n_valid):
        mq = q.shape[0]
        self.args = (q, h, m, n_valid)
        self.buf = torch.empty(2 * mq + 2 + mq // 1_024, dtype=torch.int64,
                               device=q.device)
        keys = self.buf[mq:2 * mq].view(torch.int32)
        self.outs = (keys[:mq], keys[mq:], self.buf[:mq])
        self.stream = torch.cuda.current_stream(q.device).cuda_stream

    def __call__(self, lib):
        q, h, m, n_valid = self.args
        mq = q.shape[0]
        start, counts, cum = self.outs
        rc = lib.arroyo_join_probe_u64(
            q.data_ptr(), mq, h.data_ptr(), h.shape[0], m, n_valid,
            start.data_ptr(), counts.data_ptr(), cum.data_ptr(),
            self.buf[2 * mq:].data_ptr(), self.stream)
        if rc:
            raise RuntimeError(f"probe_u64: CUDA error {rc}")
        return self.outs


def held(torch, probe, lib, name):
    from arroyo_tpu_torch.kernels.join_probe import join_probe_reference
    got = probe(lib)
    torch.cuda.synchronize()
    want = join_probe_reference(*probe.args)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"the variant differs ({name})")


def events_us(torch, probe, lib, calls=20):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(calls):
        probe(lib)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / calls


def tiles(np, torch, dev, rounds):
    libs = {t: build_variant(f"tile{t}", [f"ARROYO_PROBE_TILE={t}"])
            for t in (1_024, 2_048)}
    for n in BUCKETS:
        name, q, h, m, n_valid = bucket_probe(np, torch, dev, n)
        probe = Probe(torch, q, h, m, n_valid)
        for t, lib in libs.items():
            held(torch, probe, lib, f"{name} tile {t}")
            events_us(torch, probe, lib)  # warm
        times = {t: [] for t in libs}
        for _ in range(rounds):
            for t in (1_024, 2_048, 2_048, 1_024):
                times[t].append(events_us(torch, probe, libs[t]))
        print(json.dumps({"probe": name, **{
            f"tile_{t}": {"tiles": -(-n // t),
                          "us_median": float(np.median(v)),
                          "us_turns": v} for t, v in times.items()}}),
              flush=True)


def timeline(np, torch, dev, rounds):
    from arroyo_tpu_torch.kernels.join_probe import u64_tile
    lib = build_variant("stamps", ["ARROYO_PROBE_STAMPS"])
    name, q, h, m, n_valid = bucket_probe(np, torch, dev, 1 << 20)
    pad = torch.full_like(q, -1)
    for what, qq, mm in ((name, q, m),
                         (f"u64 all padding mq={q.shape[0]} m=0 "
                          f"n_valid={n_valid}", pad, 0)):
        mq = qq.shape[0]
        n_tiles = -(-mq // u64_tile(mq, n_valid))
        probe = Probe(torch, qq, h, mm, n_valid)
        held(torch, probe, lib, what)
        spans, phases = [], {p: [] for p in PHASES}
        for _ in range(rounds):
            probe(lib)
            torch.cuda.synchronize()
            st = np.zeros(MAX_BLOCKS * 8, np.uint64)
            if lib.arroyo_probe_stamps(st.ctypes.data):
                raise RuntimeError("arroyo_probe_stamps failed")
            st = st.reshape(-1, 8)[:n_tiles, :7].astype(np.int64)
            rel = (st - st[:, 0].min()) / 1e3
            spans.append(float(rel[:, -1].max()))
            for j, phase in enumerate(PHASES, start=1):
                phases[phase].append(rel[:, j] - rel[:, j - 1])
        out = {"probe": what, "tiles": n_tiles, "span_us": spans}
        for phase, runs in phases.items():
            d = np.concatenate(runs)
            out[f"{phase}_us"] = {"p50": float(np.median(d)),
                                  "p90": float(np.percentile(d, 90)),
                                  "max": float(d.max())}
        print(json.dumps(out), flush=True)


def main():
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--what", nargs="+", default=["tiles", "timeline"],
                        choices=["tiles", "timeline"])
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    for what in opts.what:
        {"tiles": tiles, "timeline": timeline}[what](np, torch, dev,
                                                     opts.rounds)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
