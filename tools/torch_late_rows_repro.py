"""q7's late-rows shape in the JAX package and in the PyTorch port, on
the CPU, repeated: tests/test_torch_buffered_window.py's ``late_rows``
case (the self-join of table ``lb`` with its keyless tumbling maximum,
``ARROYO_ARGMAX=0``) run RUNS times in each package at the coalescing
linger LINGER (microseconds; the engines' default is 2,000).  A run
counts as split when the two packages' sink rows differ; the row that
moves is the late (3, 9.0), which a TTL join stamps with the latest time
of whichever input probes: 13,000,000 when the late rows reach the join
after the maximum, 9,999,999 when before.  Prints one JSON line.

    JAX_PLATFORMS=cpu python3 tools/torch_late_rows_repro.py [RUNS] [LINGER]

With the default linger some runs split when several copies load the
CPU together (``for i in $(seq 8); do ... & done; wait``), more under
heavier load; with LINGER 0, the test's pin, none do, and both packages
stamp the late row 13,000,000 every time."""

import json
import os
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from arroyo_tpu.config import reset_config as jax_reset_config  # noqa: E402
from arroyo_tpu_torch.config import reset_config  # noqa: E402
import test_torch_buffered_window as t  # noqa: E402


def main():
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    linger = sys.argv[2] if len(sys.argv) > 2 else "2000"
    os.environ["COALESCE_LINGER_MICROS"] = linger
    os.environ["ARROYO_ARGMAX"] = "0"
    reset_config(), jax_reset_config()
    tables, sql = t.RAW_Q7["late_rows"]
    split, stamps = 0, Counter()
    for _ in range(runs):
        jp, pp = t._et_providers(tables())
        t.jax_clear_sink("results")
        t.JaxLocalRunner(t.JaxPlanner(jp).plan(sql)).run()
        t.clear_sink("results")
        t.LocalRunner(t.Planner(pp).plan(sql), device="cpu").run()
        got = t._rows(t.sink_output("results"))[0]
        want = t._rows(t.jax_sink_output("results"))[0]
        split += got != want
        for pkg, rows in (("port", got), ("jax", want)):
            stamps.update(f"{pkg} {ts}" for ts, a, _v in rows if a == 3)
    print(json.dumps({"runs": runs, "linger_micros": int(linger),
                      "split_runs": split,
                      "late_row_stamps": dict(sorted(stamps.items()))}))


if __name__ == "__main__":
    main()
