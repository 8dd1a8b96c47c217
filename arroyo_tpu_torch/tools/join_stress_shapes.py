"""The hot join rings' merge and probe shapes of join-stress (8a: INNER,
30 s TTL, 1,000,000 events a side; 8b: LEFT, 1 h TTL, 400,000 a side;
batches of 8,192), as ``chip_smoke.py`` phase 8 runs it, recorded on the
CPU.  ``ARROYO_DEVICE_JOIN=on`` puts the hot partitions in rings there
too, and the choice of hot partitions depends only on the data, so the
merges and probes are the card's.

Prints one JSON line: the number of merges and probes, the field-by-field
median (lower median) of each — merge (ring capacity, resident rows,
delta rows, f64 and i64 stack rows), probe (ring capacity, live rows,
padded and real queries) — the ring capacities seen, the median and
largest pair total of a probe and the expansions that overflowed their
capacity.

    python3 -m arroyo_tpu_torch.tools.join_stress_shapes 8b

Runs on the CPU (8a ~15 s, 8b ~10 s)."""

from __future__ import annotations

import argparse
import json
import os
import statistics


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variant", choices=("8a", "8b"))
    opts = parser.parse_args()
    os.environ["ARROYO_DEVICE_JOIN"] = "on"
    from ..connectors.memory import clear_sink
    from ..engine.engine import LocalRunner
    from ..graph.logical import JoinType
    from ..join_stress import (PLANNER_TTL_MICROS, TTL_MICROS,
                               join_stress_program)
    from ..obs import perf
    from ..ops import join as dj

    merges, probes, totals = [], [], []
    ring_merge, join_probe, expand = dj.ring_merge, dj.join_probe, dj._expand

    def merge(hi, lo, fstack, istack, n_res, d_hi, *rest):
        merges.append((hi.shape[0], n_res, d_hi.shape[0],
                       0 if fstack is None else fstack.shape[0],
                       0 if istack is None else istack.shape[0]))
        return ring_merge(hi, lo, fstack, istack, n_res, d_hi, *rest)

    def probe(q_hi, hi, m, n_valid):
        probes.append((hi.shape[0], n_valid, q_hi.shape[0], m))
        return join_probe(q_hi, hi, m, n_valid)

    def expansion(ring, kernel, head, tail, capacity):
        out = expand(ring, kernel, head, tail, capacity)
        totals.append(out[1])
        return out

    dj.ring_merge, dj.join_probe, dj._expand = merge, probe, expansion
    n, how, ttl = {"8a": (1_000_000, JoinType.INNER, TTL_MICROS),
                   "8b": (400_000, JoinType.LEFT, PLANNER_TTL_MICROS)}[
        opts.variant]
    perf.reset()
    LocalRunner(join_stress_program(n, how, ttl, "shapes", 8_192),
                device="cpu").run()
    clear_sink("shapes")

    def medians(rows, names):
        return {k: statistics.median_low(r[i] for r in rows)
                for i, k in enumerate(names)} if rows else None

    print(json.dumps({
        "variant": opts.variant, "merges": len(merges),
        "probes": len(probes),
        "merge_median": medians(merges, ("cap", "n_res", "m", "nf", "ni")),
        "probe_median": medians(probes, ("cap", "n_valid", "mq", "m")),
        "merge_caps": sorted({r[0] for r in merges}),
        "probe_caps": sorted({r[0] for r in probes}),
        "pairs_median": statistics.median_low(totals) if totals else None,
        "pairs_max": max(totals, default=None),
        "overflows": perf.counter("join_probe_overflows")}))


if __name__ == "__main__":
    main()
