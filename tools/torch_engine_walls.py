"""End-to-end walls of q5, q8 and config5 through ``LocalRunner``, for this
tree's ``arroyo_tpu_torch`` and a parent commit's, in turns (parent, this
tree, this tree, parent, a round), with every engine service disarmed:
what the hooks that stay in the hot path when nothing is armed cost.

    python3 tools/torch_engine_walls.py PARENT_DIR [--rounds 5]
        [--q5-events 2000000] [--q8-events 40000000]
        [--c5-events 2000000] [--device cuda]

PARENT_DIR holds ``git archive <parent> arroyo_tpu_torch`` unpacked; its
package is imported as ``parent_torch`` and builds its kernels from its
own csrc/ into its own build/ (under PARENT_DIR).  The cells are
chip_smoke.py's phases 5, 6 and 7: q5 and q8 in batches of 131,072 and
config5 in batches of 4,096 with 1 s checkpoints, chained and coalesced;
each cell starts with a run of each tree that is not counted.
Prints the card's name and power limit, then one JSON line a cell: the
walls in run order with their tree, each tree's median and the ratio of
the medians (this tree over the parent).  Exits 1 if any run's sorted
sink rows differ from the cell's first run's.  ``--device cpu`` runs it
on the CPU at small sizes to try it out."""

import argparse
import gc
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

# every service disarmed, as a user runs the engine by default
for _name in ("ARROYO_SANITIZE", "ARROYO_PROFILE", "ARROYO_TIMING",
              "ARROYO_LATENCY_SAMPLE_N"):
    os.environ.pop(_name, None)

import arroyo_tpu_torch  # noqa: E402,F401

BATCH = 131_072  # bench.py's q5 / q8 batch
C5_BATCH = 4_096  # bench.py's CONFIG5_SQL batch_size
C5_SPACING = 10  # microseconds between config5 events


def load_parent(parent):
    """The parent's ``arroyo_tpu_torch`` as the package ``parent_torch``."""
    pkg = os.path.join(os.path.abspath(parent), "arroyo_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_torch"] = mod
    spec.loader.exec_module(mod)
    return mod


def sub(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def programs(pkg, sizes):
    """cell -> (make(sink) -> program, checkpoint interval s) for the
    package named ``pkg``."""
    q5, q8, c5 = sub(pkg, "q5"), sub(pkg, "q8"), sub(pkg, "config5")
    return {
        "q5": (lambda sink: q5.q5_program(sizes["q5"], BATCH, sink,
                                          base_time_micros=0), None),
        "q8": (lambda sink: q8.q8_program(sizes["q8"], BATCH, sink,
                                          base_time_micros=0), None),
        "config5": (lambda sink: c5.config5_program(
            sizes["config5"], C5_BATCH, sink, broker=f"walls-{pkg}"), 1.0),
    }


def sorted_rows(batches):
    rows = []
    for b in batches:
        names = sorted(b.columns)
        rows.extend(zip(b.timestamp.tolist(),
                        *(b.columns[n].tolist() for n in names)))
    return sorted(rows, key=repr)


def run_once(pkg, make, ckpt, device):
    """One run of the package ``pkg``: (wall s, sorted sink rows)."""
    memory = sub(pkg, "connectors.memory")
    runner_cls = sub(pkg, "engine.engine").LocalRunner
    sink = f"walls-{pkg}"
    memory.clear_sink(sink)
    program = make(sink)
    gc.collect()
    runner = runner_cls(program, device=device)
    t0 = time.perf_counter()
    runner.run(checkpoint_interval_secs=ckpt)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sorted_rows(memory.sink_output(sink))
    memory.clear_sink(sink)
    return wall, rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--q5-events", type=int, default=2_000_000)
    parser.add_argument("--q8-events", type=int, default=40_000_000)
    parser.add_argument("--c5-events", type=int, default=2_000_000)
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args()
    if opts.device != "cpu":
        if not torch.cuda.is_available():
            sys.exit("no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    load_parent(opts.parent)
    sizes = {"q5": opts.q5_events, "q8": opts.q8_events,
             "config5": opts.c5_events}
    trees = {"parent": "parent_torch", "this": "arroyo_tpu_torch"}
    for pkg in trees.values():
        if opts.device != "cpu":
            sub(pkg, "kernels.build").load()
        sub(pkg, "config5").config5_produce(f"walls-{pkg}", sizes["config5"],
                                            0, C5_SPACING)
    cells = {tree: programs(pkg, sizes) for tree, pkg in trees.items()}
    failed = False
    for cell in ("q5", "q8", "config5"):
        runs, first = [], None
        for tree in trees:  # a warm-up run of each tree, not counted
            run_once(trees[tree], *cells[tree][cell], opts.device)
        for _ in range(opts.rounds):
            for tree in ("parent", "this", "this", "parent"):
                make, ckpt = cells[tree][cell]
                wall, rows = run_once(trees[tree], make, ckpt, opts.device)
                if first is None:
                    first = rows
                elif rows != first:
                    failed = True
                    print(f"{cell}: the {tree} run's {len(rows)} rows differ "
                          f"from the first run's {len(first)}")
                runs.append((tree, wall))
        med = {t: statistics.median(w for r, w in runs if r == t)
               for t in trees}
        print(json.dumps({"cell": cell, "events": sizes[cell],
                          "rows": len(first), "walls": runs,
                          "median_s": med,
                          "this_over_parent": med["this"] / med["parent"]}))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
