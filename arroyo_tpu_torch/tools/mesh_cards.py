"""The keyed mesh over distinct cards: nexmark q5 (bench.py's size, 2M
events in batches of 131,072) with its window state sharded over every
visible card, against the same query on one card.

Checks, each raising on failure:

* q5 with ``device`` the visible cards (one key shard a card; the buckets
  cross cards by peer copies): the single-card rows, overflow counters
  (0, 0), no reshard, every shard's tensors on its own card.  Both runs
  are warmed once, then timed in turns (one card, the cards, ROUNDS
  times); ``ARROYO_MESH=auto``, the default, makes the second of them
  the path of ``device=None`` on such a host;
* q5 planned at parallelism 2 over those cards with the device shuffle
  on and off (``ARROYO_SHUFFLE_DEVICE``; the sanitizer armed): equal
  rows, the device route replacing every host route;
* q5 at 100,000 events/s (windows fire before the cut) over the cards,
  checkpointed at its 8th batch and restored on one card: rows on both
  sides of the cut, together the same program's straight run's on one
  card, each once;
* a partitioned join buffer over the cards (``ARROYO_DEVICE_JOIN=on``):
  hot rings on several cards, probes equal to the host probe.

Prints one JSON line (walls, rows, counters, launches, the card's name
and power limit) and, last, ``{"ok": true, ...}``.

    python3 -m arroyo_tpu_torch.tools.mesh_cards

Needs at least two cards; with one it exits non-zero."""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time

ROUNDS = 3  # turns of (one card, the cards) timed after the warm runs
CUT_RATE = 100_000.0  # the cut's event rate: 2M events over 20 s


def _rows(sink):
    from ..connectors.memory import sink_output

    return sorted((int(b.timestamp[i]), int(b.columns["auction"][i]),
                   int(b.columns["num"][i]))
                  for b in sink_output(sink) for i in range(len(b)))


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main() -> None:
    import numpy as np
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"mesh_cards: {cards} visible cards; needs at least two",
              file=sys.stderr)
        sys.exit(2)
    from ..connectors.memory import clear_sink
    from ..engine.drills import hold_sources
    from ..engine.engine import Engine, LocalRunner
    from ..kernels.mesh_merge import mesh_merge
    from ..kernels.mesh_remap import mesh_remap
    from ..kernels.mesh_route import mesh_route
    from ..obs import perf
    from ..parallel.mesh_window import MeshKeyedBinState
    from ..q5 import q5_program
    from ..queries import QUERIES
    from ..sql import plan_sql
    from ..state.join_state import PartitionedJoinBuffer
    from ..types import Batch, hash_columns

    nk = 1
    while nk * 2 <= cards:
        nk *= 2
    mesh = tuple(f"cuda:{i}" for i in range(nk))
    kernels = (mesh_route, mesh_merge, mesh_remap)
    counters = ("reshard_transfers", "shuffle_collectives",
                "shuffle_host_routes", "mesh_ingest_transfers")
    out = {"cards": cards, "shards": nk}

    def run(program, device, sink):
        clear_sink(sink)
        perf.reset()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        runner = LocalRunner(program, device=device)
        runner.run()
        torch.cuda.synchronize()
        states = [op.state for op, _c in runner.engine.members.values()
                  if isinstance(getattr(op, "state", None),
                                MeshKeyedBinState)]
        return (time.perf_counter() - t0, _rows(sink), states,
                {k: perf.counter(k) for k in counters},
                {k.__name__: k.launches for k in kernels})

    def q5(rate=1_000_000.0):
        return q5_program(2_000_000, 131_072, "cards", event_rate=rate,
                          base_time_micros=0)

    def one_card(program):
        os.environ["ARROYO_MESH"] = "off"
        try:
            return run(program, "cuda:0", "cards")
        finally:
            del os.environ["ARROYO_MESH"]

    # warm both (peer access, allocator, kernel loading), then in turns
    one_card(q5())
    run(q5(), mesh, "cards")
    walls_one, walls_mesh = [], []
    for _ in range(ROUNDS):
        dt1, single, _s, _c, _l = one_card(q5())
        walls_one.append(dt1)
        dt, rows, states, cnt, launches = run(q5(), mesh, "cards")
        walls_mesh.append(dt)
    st = states[0]
    on_cards = sorted({str(t.device) for ts in (st.d_keys, st.d_bins,
                                                st.d_counts) for t in ts})
    _check(rows and rows == single, f"q5 over {mesh}: {len(rows)} rows, "
           f"one card {len(single)}")
    _check(st.overflow_counters() == (0, 0) and cnt["reshard_transfers"]
           == 0 and on_cards == list(mesh) and all(launches.values()),
           f"q5 over {mesh}: {st.overflow_counters()}, {cnt}, {on_cards}, "
           f"{launches}")
    out["q5"] = {"wall_s": walls_mesh, "one_card_wall_s": walls_one,
                 "wall_s_median": sorted(walls_mesh)[ROUNDS // 2],
                 "one_card_wall_s_median": sorted(walls_one)[ROUNDS // 2],
                 "rows": len(rows),
                 "shard_keys": st.shard_counts.tolist(), "counters": cnt,
                 "launches": launches}

    text = QUERIES["q5"].format(n=2_000_000, b=131_072).replace(
        "batch_size = '131072'",
        "batch_size = '131072', base_time_micros = '0'")
    par = {}
    for mode in ("on", "off"):
        program = plan_sql(text, parallelism=2)
        for node in program.nodes():
            if node.operator.kind.name == "CONNECTOR_SINK":
                node.operator.spec.config["name"] = "cards-p2"
        os.environ.update(ARROYO_SHUFFLE_DEVICE=mode, ARROYO_SANITIZE="1")
        try:
            par[mode] = run(program, mesh, "cards-p2")
        finally:
            del os.environ["ARROYO_SHUFFLE_DEVICE"]
            del os.environ["ARROYO_SANITIZE"]
    _check(par["on"][1] and par["on"][1] == par["off"][1]
           and par["on"][3]["shuffle_host_routes"] == 0
           and par["off"][3]["shuffle_host_routes"] > 0
           and par["on"][3]["reshard_transfers"] == 0,
           f"parallelism 2 over {mesh}: on {par['on'][3]}, "
           f"off {par['off'][3]}")
    out["parallelism_2"] = {"wall_s_on": par["on"][0],
                            "wall_s_off": par["off"][0],
                            "rows": len(par["on"][1]),
                            "counters_on": par["on"][3],
                            "counters_off": par["off"][3]}

    _t, straight, _s, _c, _l = one_card(q5(CUT_RATE))

    async def cut():
        engine = Engine.for_local(q5(CUT_RATE), "cards-cut", device=mesh)
        running = engine.start()
        held, = hold_sources(engine, (8,))
        await held.wait()
        await running.checkpoint(1, then_stop=True)
        await running.join()

    clear_sink("cards")
    asyncio.run(cut())
    before = _rows("cards")
    clear_sink("cards")
    os.environ["ARROYO_MESH"] = "off"
    try:
        LocalRunner(q5(CUT_RATE), job_id="cards-cut", device="cuda:0",
                    restore_epoch=1).run()
    finally:
        del os.environ["ARROYO_MESH"]
    after = _rows("cards")
    every = before + after
    _check(before and after and sorted(every) == straight
           and len(set(every)) == len(every),
           f"restore on one card: {len(before)} + {len(after)} rows, "
           f"{len(straight)} straight")
    out["restore"] = {"rows_straight": len(straight),
                      "rows_before_cut": len(before),
                      "rows_after_restore": len(after)}

    os.environ.update(ARROYO_DEVICE_JOIN="on", ARROYO_JOIN_HOT_MIN_ROWS="1",
                      ARROYO_JOIN_HOT_PARTITIONS="8")
    rng = np.random.default_rng(0)
    n = 20_000
    keys = rng.integers(0, 5000, n).astype(np.int64)
    kh = hash_columns([keys])
    batch = Batch(np.sort(rng.integers(0, 30_000_000, n)).astype(np.int64),
                  {"k": keys, "v": rng.integers(0, 99, n)}, kh, ("k",))
    buf = PartitionedJoinBuffer(n_partitions=8, device="cuda:0",
                                mesh=[torch.device(d) for d in mesh])
    for lo in range(0, n, 4096):
        buf.append(batch.select(np.arange(lo, min(lo + 4096, n))))
    probe = np.sort(rng.choice(kh, 500, replace=False))
    q_dev, g_dev = buf.probe_positions(probe)
    os.environ["ARROYO_DEVICE_JOIN"] = "off"
    host = PartitionedJoinBuffer(n_partitions=8, device="cuda:0")
    host.append(batch)
    q_h, g_h = host.probe_positions(probe)
    ring_devices = buf.stats()["ring_devices"]
    _check(ring_devices >= 2 and sorted(zip(q_dev.tolist(), g_dev.tolist()))
           == sorted(zip(q_h.tolist(), g_h.tolist())),
           f"join rings over {mesh}: {ring_devices} devices")
    out["join_rings"] = {"ring_devices": ring_devices,
                         "pairs": len(q_dev)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out["card"] = smi
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cards}}))


if __name__ == "__main__":
    main()
