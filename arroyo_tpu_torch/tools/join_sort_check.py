"""Check ``join_sort`` and the u64 ``join_probe`` on the card and time
``join_sort`` beside ``torch.sort(stable=True)``: for each of the legacy
join's buckets (512, 8,192, 32,768, 524,288, 1,048,576) and each key
kind (hash-like, one varying byte of 256 values, 30 distinct keys, all
equal; a seventh SENTINEL padding), the order must equal the plain
version's and numpy's stable argsort of the u64 keys, and the probe of
the sorted keys against a sorted resample must equal its plain version.
Prints one line a case (milliseconds from CUDA events, the mean of 20
calls after 3 warm-up calls, ``torch.sort`` on the keys' unsigned-order
view) and, last, the card's name and power limit.

    python3 -m arroyo_tpu_torch.tools.join_sort_check

Needs one CUDA card; chip_smoke.py's phase 3 makes the full
measurement."""

from __future__ import annotations

import subprocess

import numpy as np

BUCKETS = (512, 8_192, 32_768, 524_288, 1 << 20)
KINDS = ("hash", "few", "dups", "equal")
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _keys(rng, n, kind):
    m = n - n // 7
    k = np.full(n, SENTINEL, np.uint64)
    if kind == "hash":
        k[:m] = rng.integers(0, 2**64 - 1, m, dtype=np.uint64)
    elif kind == "few":
        k[:m] = ((rng.integers(0, 256, m).astype(np.uint64) << np.uint64(40))
                 | np.uint64(7))
    elif kind == "dups":
        k[:m] = rng.choice(rng.integers(0, 2**64 - 1, 30, dtype=np.uint64),
                           m)
    else:
        k[:] = np.uint64(12345)
    return k, m


def _mean_ms(fn, reps=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    import torch

    from ..kernels.join_probe import join_probe, join_probe_reference
    from ..kernels.join_sort import (join_sort, join_sort_reference,
                                     unsigned_order)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n in BUCKETS:
        for kind in KINDS:
            k, m = _keys(rng, n, kind)
            kt = torch.tensor(k.view(np.int64), device=dev)
            order, keys = join_sort(kt)
            want = join_sort_reference(kt)
            sorted_ok = (torch.equal(order, want[0])
                         and torch.equal(keys, want[1])
                         and np.array_equal(order.cpu().numpy(),
                                            np.argsort(k, kind="stable")))
            r = np.full(n, SENTINEL, np.uint64)
            mr = n - n // 5
            r[:mr] = rng.choice(k[:max(m, 1)], mr)
            _o, rs = join_sort(torch.tensor(r.view(np.int64), device=dev))
            probe_ok = all(torch.equal(a, b) for a, b in zip(
                join_probe(keys, rs, m, mr),
                join_probe_reference(keys, rs, m, mr)))
            ku = unsigned_order(kt)
            ms = _mean_ms(lambda: join_sort(kt))
            lib = _mean_ms(lambda: torch.sort(ku, stable=True))
            print(n, kind, sorted_ok, probe_ok,
                  f"join_sort {ms:.4f} ms torch.sort {lib:.4f} ms",
                  flush=True)
            if not (sorted_ok and probe_ok):
                raise SystemExit(f"mismatch at n={n} {kind}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())


if __name__ == "__main__":
    main()
