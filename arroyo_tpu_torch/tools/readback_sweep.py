"""Time one device-to-host copy of a buffer, by size: ``.cpu()`` into
fresh pageable memory against a copy into pinned memory from PyTorch's
caching host allocator (``arroyo_tpu_torch.device.to_host`` takes the
second from ``PINNED_READ_BYTES`` up).  Pageable buffers beyond glibc's
largest mmap threshold (32 MiB) come fresh from mmap and fault in every
page during the copy.

For each size, ``--rounds`` rounds of (pageable, pinned, pinned,
pageable), each a median of CUDA-event milliseconds over 20 calls after
3 warm-up calls.  Prints one JSON line per size and, last, the card's
name and power limit.

    python3 -m arroyo_tpu_torch.tools.readback_sweep [--rounds 3]

Needs one CUDA card."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

SIZES_KIB = (16, 64, 256, 1024, 4096, 16384, 31744, 33792, 65536)


def cuda_ms(fn, reps=20, warm=3):
    import torch
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


def main():
    import torch
    from arroyo_tpu_torch.device import PINNED_READ_BYTES

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("readback_sweep needs a CUDA card")
    for kib in SIZES_KIB:
        buf = torch.ones(kib * 128, dtype=torch.int64, device="cuda")

        def pageable():
            return buf.cpu().numpy()

        def pinned():
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf)
            return host.numpy()

        seq = []
        for _ in range(opts.rounds):
            seq += [cuda_ms(pageable), cuda_ms(pinned), cuda_ms(pinned),
                    cuda_ms(pageable)]
        rounds = [seq[i:i + 4] for i in range(0, len(seq), 4)]
        print(json.dumps({
            "kib": kib, "to_host_takes": ("pinned"
                                          if kib * 1024 >= PINNED_READ_BYTES
                                          else "pageable"),
            "pageable_ms": statistics.fmean(r[0] + r[3] for r in rounds) / 2,
            "pinned_ms": statistics.fmean(r[1] + r[2] for r in rounds) / 2,
            "pageable_over_pinned_each_round": [(r[0] + r[3]) / (r[1] + r[2])
                                                for r in rounds]}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
