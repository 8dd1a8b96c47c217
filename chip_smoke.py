"""Smoke test of the PyTorch/CUDA port (arroyo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. environment: torch/CUDA versions, the card, its power limit, and the
   host library (arroyo_tpu_torch/native/host_ops.cpp, built by g++ at
   first import): ``HAVE_NATIVE`` and its path, failing unless it loaded;
2. build: the CUDA kernels from arroyo_tpu_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes nexmark q5, q8, config5, join-stress and hot items give it
   (and, for the session kernels, at larger and skewed shapes; for
   bin_update at q5's and hot items' flush sizes and with duplicate
   cells and MIN/MAX inputs of both signs and +/-0.0), timed with CUDA
   events beside its plain version, a PyTorch yardstick (one call per
   plane) where one exists, and its least possible time on an H100
   (bytes / 3.35 TB/s; pane_emit and bin_evict count the 32-byte
   sectors their rows' columns touch); segment_top_k, ring_gather,
   pane_emit, bin_evict, segment_agg, expand_gather, ring_merge,
   join_probe, join_expand, bin_update, emit_count and emit_gather are
   timed in turns with their yardstick (three rounds of library, kernel,
   kernel, library); those, argmax_fire (at eight full-state shapes and
   q5's real fire) and session_union print their launches, host syncs
   and allocations per call (as PyTorch's sync debug mode and caching
   allocator see them) and torch.profiler's device time per launch, warm
   and cold;
   session_union's two forms are held to their plain versions at config5's
   192-row merge and six larger or skewed shapes; segment_agg's sums are
   held to math.fsum and to themselves over two calls, and an empty
   segment's MIN/MAX to +/-inf; ring_gather's and expand_gather's launch
   paths are split into their host steps.  With ``--parent DIR`` (a ``git
   archive`` of the parent commit unpacked at DIR) the parent's
   pane_emit, bin_evict, segment_agg, expand_gather, ring_merge,
   join_probe (both forms), session_union, join_expand, bin_update,
   argmax_fire, join_sort, ring_emit, emit_count and emit_gather are
   built from DIR and timed in turns with
   this tree's at the same shapes (the parent's ring_merge given its own
   resident positions), and so are the callers: the reads the segment
   reduce and the join's emission make, ``ops/join.merge_ring``,
   ``probe_ring`` + ``expand_gather`` at join-stress's probes,
   ``probe_ring`` + ``expand_hit`` at 8b's,
   ``ops/session.union_sorted_intervals`` at config5's merge, and
   ``KeyedBinState.flush_updates`` at q5's and hot items' flushes,
   ``KeyedBinState._emit_argmax`` at q5's fire and
   ``KeyedBinState._emit_compact`` at hot items' compact fires,
   ``ops/join.join_pairs`` at 8a's and 8b's pairings,
   ``ops/keyed_bins.directory_insert`` and ``KeyedBinState.snapshot`` at
   hot items' and q8's states after 40,000,000 events; and the legacy
   join layout's kernels at its buckets (512, 8,192, 32,768, 524,288,
   1,048,576): join_sort on hash-like keys, keys with two varying digits
   and keys with heavy duplicates, an eighth SENTINEL padding — its
   order bit-equal to the plain version's and to numpy's stable argsort
   of the u64 keys, one device launch up to 8,192 keys and at most a
   memset and 9 above — timed in turns with ``torch.sort(stable=True)``
   (and the parent's), with its device µs by kernel name (one block;
   upfront histograms, digit passes), and the u64 form of join_probe
   timed in turns with ``searchsorted`` x2 + ``cumsum``, both with
   device µs warm and cold, launches, syncs and allocations a call;
4. state: the port's KeyedBinState (q5 aggregates, local argmax) over
   2,000,000 nexmark events on the card and on the CPU — every fire and
   the final snapshot identical, and a card snapshot restored into a
   fresh card state fires identically;
5. main path: nexmark q5 through ``LocalRunner`` at bench.py's size
   (2,000,000 events, batches of 131,072) on the card and on the CPU —
   identical sink rows, also on the card under ``ARROYO_CHAIN=0
   ARROYO_COALESCE=0`` (one runner per operator, no input coalescing;
   every other run in this script is chained and coalesced, as the JAX
   package runs by default), both kernels launched during the card run, one
   upload a keyed-bin flush and none of them blocking (the cells of each
   flush printed), one upload, none blocking, and one readback an argmax
   fire, and the share of wall time spent in synchronized kernel calls
   (``ARROYO_TIMING=1``, a separate run);
6. q8 path: nexmark q8 through ``LocalRunner`` at 40,000,000 events
   (batches of 131,072, 1,000,000 events/s, so four 10 s windows) on the
   card — sink rows equal to a numpy control computed here from the same
   generator, the q8 kernels (bin_update, pane_emit, bin_evict,
   ring_merge, ring_gather) all launched, hot join partitions promoted
   and rows gathered from their rings, the device share in a separate
   ``ARROYO_TIMING=1`` run, the same rows from the CPU — and q8 at
   2,000,000 events on the card and on the CPU with identical rows;
7. config5 path: session windows + median UDAF over the Kafka source
   through ``LocalRunner.run(checkpoint_interval_secs=1.0)`` at 2,000,000
   events (bench.py's producer, batches of 4,096, 1 s gap and lateness,
   checkpoints every second into InMemoryBackend) on the card — sink rows
   equal to a numpy control computed here from the same producer (one
   session per key), session_union and segment_agg launched, interval
   rows merged on the device, one upload, one readback and no blocking
   upload a union call (the rows of each call printed), at least one
   checkpoint epoch completed (the completed epochs printed);
   the device share in a separate ``ARROYO_TIMING=1`` run; and config5 at
   200,000 events on the card and on the CPU with identical rows;
8. join-stress path: bench.py's join with expiration (two impulse streams
   at 1 event/ms, the left side Zipf-keyed over 100,000 keys, the right
   uniform, batches of 8,192) through ``LocalRunner`` on the card, twice:
   8a INNER with bench.py's 30 s TTL over 1,000,000 events a side — every
   key-equal pair at most one TTL apart (a numpy control from the
   counters) present, every row key-equal, no pair twice, bench.py's
   ``state_bounded`` true; 8b LEFT with the planner's 1 h TTL over
   400,000 events a side — the net rows (CREATE minus DELETE) equal a
   numpy LEFT JOIN of the two streams; in both, at most one
   device-to-host copy a hot probe beyond the probes whose pair total
   overflowed the expansion's capacity (``join_probe_overflows``), and no
   blocking upload on the join paths (``join_blocking_uploads``); each
   once more under ``ARROYO_TIMING=1`` for the device share;
9. hot-items path: Nexmark hot items, top 10 per window (the ROW_NUMBER
   form of q5: a HOP(2 s, 10 s) COUNT(*) fused with a per-window TopN,
   then a global TopN stage) through ``LocalRunner`` at 40,000,000 events
   (batches of 131,072, 1,000,000 events/s) on the card — at most 10
   rows per window, each row's count and each window's multiset of counts
   equal to a numpy control from the same generator, segment_top_k
   launched on every fire and the compact fire (emit_count + emit_gather)
   taken under ``ARROYO_EMIT_COMPACT=auto``, one upload a flush and a
   compact fire and none of them blocking, the state's bytes, the device
   share in a separate ``ARROYO_TIMING=1`` run — and at 2,000,000 events
   the card's rows equal to the CPU's, also under
   ``ARROYO_EMIT_COMPACT=on``;
10. q1 path: nexmark q1 (every bid, its price * 0.908) through
    ``LocalRunner`` at bench.py's size (2,000,000 events, batches of
    131,072, 1,000,000 events/s) on the card — sink rows equal to a numpy
    control from the same generator (every column, ``price_dol`` in f64)
    and to the CPU run and an ``ARROYO_CHAIN=0`` run; events/s and the
    runners chained and unchained printed;
11. q7 path: nexmark q7 (the bids at their 10 s tumbling window's max
    price, ties included: a raw-mode window argmax) through
    ``LocalRunner`` at 2,000,000 events (one window) and 40,000,000 (four
    windows) on the card — sink rows equal to a numpy control from the
    same generator at both sizes and to the CPU run at 2,000,000; the
    rows that took the late path (``window_argmax_late_rows`` and the
    ones that matched a released maximum, ``window_argmax_late_hits``)
    printed;
12. SQL front end: bench.py's Q1, Q5, Q7, Q8 and CONFIG5_SQL and the
    hot-items SQL planned by ``arroyo_tpu_torch.sql.plan_sql`` (median
    registered as a UDAF) and run on the card at the sizes of the
    hand-built runs of phases 5-7 and 9-11 (q1, q5, q7, q8 and hot items
    2,000,000 events, config5 200,000) — each plan node for node the
    hand-built program, its sink rows and its kernel launches those of
    the hand-built run, its parse-and-plan host ms and its wall printed;
    then q5 planned from SQL once more under ``ARROYO_CHAIN=0
    ARROYO_COALESCE=0 ARROYO_TIMING=1``, where its filters and
    projections run as torch ops on the card (``CompiledExpr``): the
    same rows, the device expression calls, their synchronized ms, and
    the bytes they move against 3.35 TB/s;
13. the reference's plans, the buffered window and UNION ALL, each
    planned by ``plan_sql`` and run on the card at 2,000,000 events:
    bench.py's Q5 under ``ARROYO_ARGMAX=0`` (a window join of the HOP
    count with its per-window maximum, a non-windowed aggregate released
    by the watermark) — rows equal to a numpy control, to phase 5's fused
    rows and to the CPU run, its aggregate's flushes printed; Q7 under
    ``ARROYO_ARGMAX=0`` (a TTL join of the bids with a keyless tumbling
    maximum) — rows equal to the numpy control and phase 11's, any row
    beyond them a float32 tie of its window's maximum (the join key is
    float32), also in the CPU run; Nexmark q16's channel statistics
    (``queries.Q16``, COUNT(DISTINCT) on the buffered window) — rows equal
    to a numpy control and the CPU run, ``segment_agg`` launched; and q1
    as a UNION ALL of two price ranges (``queries.Q1_UNION``) — rows equal
    to phase 10's q1 rows;
14. the rest of the join layer on the card: under
    ``ARROYO_JOIN_STATE=legacy`` (each fire or arrival re-sorts both
    sides and pairs them with join_sort, the u64 join_probe and
    join_expand) q8 at 40,000,000 events — rows equal to phase 6's
    control and rows — and join-stress 8a and 8b at phase 8's sizes —
    8b's rows equal to phase 8's partitioned run's, 8a's pairs within
    the TTL too (the pairs further apart follow the arrival of
    watermarks and are counted) — each run launching all three kernels,
    its pairing buckets, device and host pairings printed; the semi join
    (``queries.SEMI_Q3``: the bids on auctions of q3's category) at
    2,000,000 events — every matching bid once, equal to a numpy control
    and to the CPU run, the pending left rows at each watermark printed;
    the windowed multi-way join (``queries.MW_BIDDERS``: q8 extended by
    each person's bids) at 40,000,000 events — one node, rows equal to a
    numpy control and to the ``ARROYO_MULTIWAY=0`` plan's, and at
    2,000,000 to the CPU run's; and its TTL mode (``queries.MW_TTL``) at
    500,000 events (2,000,000 halved twice to stay under 20,000,000
    output rows) with the hot-partition floor at 1,024 rows — its row
    count the generator's, its rows the pairwise plan's, join_probe and
    join_expand launched on the rings;
15. correlated windows: bench.py's ``run_correlated_windows`` SQL
    (:1862-1879: the nexmark source at 1,000,000 events/s in batches of
    8,192, K HOP windows with a 2 s slide and widths from [10, 4, 20,
    6, 16, 8, 30, 14] s, ``count(*)`` and ``sum(bid.price)`` by auction)
    planned by ``plan_sql``: at 2,000,000 events for K = 2, 4, 8 the
    factored plan (``ARROYO_FACTOR_WINDOWS=auto``: one shared 2 s pane
    ring, K derived windows) and the unfactored plan (``=0``) on the
    card and the factored plan on the CPU, every member's rows equal to a
    numpy control (per auction and window end the count and the integer
    sum of prices); at 8,000,000 events for K = 8 the factored plan on
    the card, every member equal to its control, and once more under
    config5's 1 s checkpoint ticker, its rows those of the run without
    checkpoints and its barrier drains shipping rows; each run's
    wall, events/s, ``pane_update_rows`` per event (gated: factored
    below unfactored at K = 8), flushes, kernel launches, drains and the
    factor decision printed.
16. the engine services: q5 (NUM_EVENTS), config5 (C5_EVENTS, 1 s
    checkpoints, uncoalesced so its launches do not follow arrival
    times) and 8a (JS_INNER a side) each run four times in turns —
    disarmed, armed, armed, disarmed, where armed is ``ARROYO_SANITIZE=1``,
    ``ARROYO_LATENCY_SAMPLE_N=32`` and the phase profiler — and q5 once
    more under ``ARROYO_TIMING=1`` with the profiler: every run's rows
    equal the numpy controls of phases 13, 7 and 8 (8a: its certain
    pairs) and each other, its launches the cell's first run's; armed,
    the sanitizer records events and no violation, the profiler's work
    phases on the event loop sum to 0.85-1.5 of the wall (q5's to at most
    1.5, and to at least 0.85 with the time the loop idles in its
    selector, timed beside the profiler, while it waits on the
    generator's prefetch thread), q5's generator phase to at most the
    wall, with
    ``source_decode``, ``proc``, ``dispatch`` and ``watermark`` each above
    0, q5's and 8a's every sink has a p99, ``critical_path()`` has the JAX
    package's keys,
    ``device_state_tables()`` sums to the run's state tensors' bytes
    (at most ``torch.cuda.memory_allocated()``) and the metrics
    exposition names the reference's record and queue instruments for
    every task; timed, q5's bin operator has ``device_execute``; no
    thread is left alive after any run; then q5 armed once more at 2,000
    events/s in batches of 8,192 (its rows the numpy control's at that
    rate), where the window fires after nearly every batch, so its sink
    has at least 100 samples (q5 at bench.py's rate fires once: one
    sample a run); each run's phase table, sink p50/p99, sampled records,
    ledger and span count printed, with the armed/disarmed wall ratio a
    round.  Before each run the script collects the earlier runs'
    garbage and freezes its own heap, so no full collection of either
    falls in a run's wall; each run's seconds in the garbage collector
    are printed, and named when the work-share gate fails.
17. the host library: q5 (2,000,000 events in batches of 131,072, key
    capacity 131,072) and hot items (2,000,000 events) with the library
    (key directory, cell pre-aggregation, bin assignment, hashing) and
    with it switched off (the numpy versions), in turns (library, numpy,
    numpy, library) under the phase profiler — every run's rows equal to
    its numpy control, the path's kernels launched in every run, each
    run's wall and ``proc`` seconds printed with the numpy / library
    ratios.
18. exactly-once sinks: bench.py's ``CONFIG5_SQL`` over phase 7's
    C5_EVENTS (batch 4,096, 1 s gap and lateness, median UDAF) with the
    sink of a deployed pipeline in place of the memory sink, 1 s
    checkpoints committed by the runner: ``fs c5`` writes JSON part
    files through the filesystem sink, whose promoted rows equal phase
    7's memory-sink rows and its numpy control with no part left under
    ``.staging/``; the same plan cut (``engine/drills.py``: epochs 1 and
    2 sealed and committed, epoch 3 sealed, an IMMEDIATE stop before its
    commit with its part staged) and restored from epoch 3 holds every
    row once; ``kafka c5`` reads the first KAFKA_C5_EVENTS of those events
    produced as Avro with the record schema the planner synthesizes from
    the source's DDL (the produce outside the timed run) and writes JSON
    rows through the transactional Kafka sink, whose ``read_committed``
    rows equal the numpy control's and, for the key blocks the cut leaves
    whole, fs c5's, and before the last commit the committed (and, on the
    in-process broker, the uncommitted) read lacks exactly that
    transaction's rows; each run's wall, epochs, parts staged and
    promoted, commit seconds (the sinks' own commit counters,
    ``obs.metrics.sink_commit_counters``) and launches printed,
    ``session_union`` and ``segment_agg`` launched in both.
19. long windows: ``queries.HOP_CHANNELS`` (per channel, HOP(1 s, 300 s)
    count, sum and maximum of the bid prices; the nexmark source at
    10,000 events/s in batches of 8,192) planned by ``plan_sql`` with
    W = 300 bins, at 4,000,000 events (400 s of event time: eviction
    after the first 300 s) on the card under ``ARROYO_RING=on``, ``off``,
    ``off``, ``on`` (each run under ``ARROYO_TIMING=1`` for its device
    ms a kernel) — every run's rows equal to each other and to a numpy
    control from the bids the generator made in the first run (per
    channel and window end the count, the integer sum of prices and the
    maximum), the ring runs launching ``ring_emit`` once a fire and no
    ``pane_emit``, ``emit_count``, ``emit_gather`` or ``argmax_fire``,
    the off runs no ``ring_emit``; at 200,000 events the card's ring rows
    equal to the CPU's; and q5 (phase 5's size) under ``ARROYO_RING=on``,
    its ring fires feeding the argmax stage, its rows phase 13's control's
    and phase 5's; each run's wall, fires, launches and device ms
    printed.  Phase 3 holds ``ring_emit`` to its plain version and to a
    PyTorch composition (an index gather, ``cumsum`` differences,
    ``max_pool1d``) at phase 19's median fire and at 262,144 rows, W =
    300, k = 1 and 64, timed in turns with the composition; and at its
    edge fires (a span wrapping the ring with dead positions at both
    ends, W = 37, MIN/MAX over NaN and +/-0.0 with k > W, q5's ring
    fire), bit for bit; one device launch, one allocation and no host
    sync a call.  The u64 join_probe is held to its plain version at
    every legacy bucket and at one key over half of a 2^20 plane, 8b's
    8,192 queries against 400,000 rows, all padding, and tiles of one key
    or one real query whose window is the whole plane, with at most two
    device launches (a memset and the probe), one allocation and no host
    sync a call.
20. the keyed mesh: bench.py's q5 (NUM_EVENTS, batches of 131,072)
    through ``LocalRunner`` over four key shards of the card
    (``device=("cuda:0",) * 4``: ``MeshKeyedBinState``, whose update
    routes, exchanges, sorts, merges, re-lays and scatters each batch's
    cells and whose fire is a dense ``pane_emit`` a shard) — rows equal to
    phase 5's single-device rows and phase 13's numpy control, overflow
    counters (0, 0), no reshard, ``mesh_route``, ``mesh_merge``,
    ``mesh_remap``, ``bin_update`` and ``pane_emit`` launched (with more
    than one visible card the run is repeated over distinct cards, else
    the phase says the shards were logical shards of one card); q5
    planned at parallelism 2 on that mesh with the device shuffle on and
    off (``ARROYO_SHUFFLE_DEVICE``, the sanitizer armed) — equal rows, the
    device route replacing every host route of the edge, route shift 1 in
    both subtasks; and q5 at 100,000 events/s (so that windows fire
    before the cut) on four shards, checkpointed and stopped at its 8th
    batch, restored from that epoch on one device (``KeyedBinState``) —
    rows on both sides of the cut, the two runs' rows together the same
    program's straight run's on one device, each once, and the restored
    state's ``next_slot`` and summed count planes those of the mesh
    state's snapshot.  Phase 3
    holds the three mesh kernels to their plain versions (bit for bit),
    timed in turns with a PyTorch composition, at q5's mesh shapes (a
    slice of N = 2,048, a shard's merge of R = 8,192 routed rows into C =
    65,536, its re-layout and roll), at 2^20 rows, and on every row to one
    shard, both route rules' boundary hashes, all padding and a merge
    that fills C; one launch (after memsets), one allocation and no host
    sync a call.

Launch counts are set to 0 just before each main-path run (q5, q8,
config5, 8a, 8b, hot items, q1, q7, each SQL-planned run of phase 12,
each card run of phase 13, the legacy q8, 8a and 8b, the semi join and
the two multi-way joins of phase 14, each card run of phases 15, 16 and
17, fs c5's straight run and kafka c5's run, each card run of phase 19,
phase 20's q5 on the mesh and its device-shuffle run) and read just
after it; q1, q7 and the union launch no kernel.  It prints a
``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and, last, ``{"ok": true, "device": ...}``.
It needs one card and exits non-zero without one.

    python3 chip_smoke.py --parent DIR   # phase 3 also times the parent's"""

import argparse
import asyncio
import collections
import functools
import gc
import json
import math
import os
import re
import selectors
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script "
          "needs an NVIDIA card", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from arroyo_tpu_torch.config5 import (  # noqa: E402
    BURST, GAP_MICROS, KEYS_PER_BLOCK, config5_events, config5_produce,
    config5_program, config5_sql)
from arroyo_tpu_torch.connectors.kafka import InMemoryKafkaBroker  # noqa: E402
from arroyo_tpu_torch.connectors.memory import clear_sink, sink_output  # noqa: E402
from arroyo_tpu_torch.connectors.nexmark import (  # noqa: E402
    CHANNELS_NUMBER, EVENT_AUCTION, EVENT_BID, EVENT_PERSON, HOT_CHANNELS,
    NexmarkConfig, NexmarkGenerator, make_splits)
from arroyo_tpu_torch.device import to_device, to_host  # noqa: E402
from arroyo_tpu_torch.engine.drills import (  # noqa: E402
    cut_before_commit, hold_sources)
from arroyo_tpu_torch.engine.engine import Engine, LocalRunner  # noqa: E402
from arroyo_tpu_torch.formats import make_format  # noqa: E402
from arroyo_tpu_torch.graph.logical import (  # noqa: E402
    AggKind, AggSpec, JoinType, OpKind)
from arroyo_tpu_torch.hot_items import SLIDE_MICROS as HOT_SLIDE  # noqa: E402
from arroyo_tpu_torch.hot_items import WIDTH_MICROS as HOT_WIDTH  # noqa: E402
from arroyo_tpu_torch.hot_items import (  # noqa: E402
    TOP_K, hot_items_program, hot_items_sql)
from arroyo_tpu_torch.join_stress import (  # noqa: E402
    BASE_TIME_MICROS, INTERVAL_MICROS, PLANNER_TTL_MICROS, TTL_MICROS,
    join_stress_keys, join_stress_program, state_bounded)
from arroyo_tpu_torch.kernels import build  # noqa: E402
from arroyo_tpu_torch.kernels.argmax_fire import (  # noqa: E402
    argmax_fire, argmax_fire_buffer, argmax_fire_buffer_reference,
    argmax_fire_reference, argmax_views)
from arroyo_tpu_torch.kernels.bin_evict import (  # noqa: E402
    bin_evict, bin_evict_reference)
from arroyo_tpu_torch.kernels.bin_update import (  # noqa: E402
    bin_update, bin_update_reference, channel_identity, channel_plan,
    pack_cells)
from arroyo_tpu_torch.kernels.emit_compact import THREADS as EMIT_GROUP  # noqa: E402
from arroyo_tpu_torch.kernels.emit_compact import (  # noqa: E402
    compact_views, emit_count, emit_count_reference, emit_gather,
    emit_gather_buffer, emit_gather_buffer_reference, emit_gather_reference)
from arroyo_tpu_torch.kernels import expand_gather as expand_gather_mod  # noqa: E402
from arroyo_tpu_torch.kernels.expand_gather import (  # noqa: E402
    expand_gather, expand_gather_buffer, expand_gather_reference,
    expand_views)
from arroyo_tpu_torch.kernels.join_expand import (  # noqa: E402
    join_expand, join_expand_buffer, join_expand_reference, pair_views)
from arroyo_tpu_torch.kernels.join_probe import (  # noqa: E402
    join_probe, join_probe_reference, u64_tile)
from arroyo_tpu_torch.kernels.join_sort import (  # noqa: E402
    ONE_BLOCK_MAX, join_sort, join_sort_reference, unsigned_order)
from arroyo_tpu_torch.kernels.pane_emit import (  # noqa: E402
    fire_geometry, pane_emit, pane_emit_reference, pane_views)
from arroyo_tpu_torch.kernels.mesh_merge import (  # noqa: E402
    merge_views, mesh_merge, mesh_merge_reference)
from arroyo_tpu_torch.kernels.mesh_remap import (  # noqa: E402
    mesh_remap, mesh_remap_reference)
from arroyo_tpu_torch.kernels.mesh_route import (  # noqa: E402
    RULE_MESH, RULE_SHUFFLE, destinations, mesh_route, mesh_route_reference,
    route_views)
from arroyo_tpu_torch.kernels import pane_emit as pane_emit_mod  # noqa: E402
from arroyo_tpu_torch.kernels.ring_emit import (  # noqa: E402
    ring_emit, ring_emit_reference)
from arroyo_tpu_torch.kernels import ring_gather as ring_gather_mod  # noqa: E402
from arroyo_tpu_torch.kernels.ring_gather import (  # noqa: E402
    ring_gather, ring_gather_reference)
from arroyo_tpu_torch.kernels.ring_merge import (  # noqa: E402
    ring_merge, ring_merge_reference)
from arroyo_tpu_torch.kernels.segment_agg import (  # noqa: E402
    segment_agg, segment_agg_buffer, segment_agg_reference)
from arroyo_tpu_torch.kernels.segment_top_k import (  # noqa: E402
    _round_grid_cap, order_keys, segment_top_k, segment_top_k_reference)
from arroyo_tpu_torch.kernels.session_union import (  # noqa: E402
    session_union, session_union_buffer, session_union_buffer_reference,
    session_union_reference, union_views)
from arroyo_tpu_torch.obs import perf  # noqa: E402
from arroyo_tpu_torch.ops import join as join_ops  # noqa: E402
from arroyo_tpu_torch.ops.keyed_bins import (  # noqa: E402
    ARGMAX_MIN_CAP, KeyedBinState, preaggregate)
from arroyo_tpu_torch.parallel.mesh_window import (  # noqa: E402
    MeshKeyedBinState)
from arroyo_tpu_torch import native  # noqa: E402
from arroyo_tpu_torch.ops.segment import _reduce as segment_reduce  # noqa: E402
from arroyo_tpu_torch.ops import session as session_ops  # noqa: E402
from arroyo_tpu_torch.q1 import q1_program  # noqa: E402
from arroyo_tpu_torch.q5 import SLIDE_MICROS, WIDTH_MICROS, q5_program  # noqa: E402
from arroyo_tpu_torch.q7 import WIDTH_MICROS as Q7_WIDTH  # noqa: E402
from arroyo_tpu_torch.q7 import q7_program  # noqa: E402
from arroyo_tpu_torch.q8 import WIDTH_MICROS as Q8_WIDTH  # noqa: E402
from arroyo_tpu_torch.q8 import q8_program  # noqa: E402
from arroyo_tpu_torch import queries  # noqa: E402
from arroyo_tpu_torch.sql import (  # noqa: E402
    plan_sql, register_udaf, unregister_udfs)
from arroyo_tpu_torch.state.join_state import (  # noqa: E402
    aggregate_stats_registry)
from arroyo_tpu_torch.state.session_state import (  # noqa: E402
    aggregate_session_registry)
from arroyo_tpu_torch.types import StopMode, hash_columns  # noqa: E402
from arroyo_tpu_torch.analysis import sanitizer  # noqa: E402
from arroyo_tpu_torch.config import reset_config  # noqa: E402
from arroyo_tpu_torch.engine.operators_window import (  # noqa: E402
    BinAggOperator, JoinWithExpirationOperator)
from arroyo_tpu_torch.obs import latency, metrics, profiler, tracing  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F64_OPS_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores, data sheet
NUM_EVENTS = 2_000_000  # bench.py:35
BATCH = 131_072  # bench.py:38
C_Q5, B_Q5 = 131_072, 16  # q5's key capacity and ring at that size
Q5_RING_ROWS = 119_938  # q5's occupied slots at its ring fire (phase 19)
Q8_EVENTS = 40_000_000  # four 10 s windows at bench.py's rate
Q7_EVENTS = 40_000_000  # four 10 s windows, as q8 and hot items use
Q8_SMALL = 2_000_000
C_Q8, B_Q8 = 1_048_576, 8  # q8's person-side state at Q8_EVENTS
C_SLICE_Q8 = 800_768  # its occupied slots, rounded as a dense fire reads
RING_CAP = 65_536  # the largest hot join ring q8 stages
C5_EVENTS = 2_000_000  # 20 s of event time at bench.py's 10 us spacing
C5_SMALL = 200_000  # bench.py's BENCH_C5_EVENTS default
C5_BATCH = 4_096  # bench.py's CONFIG5_SQL batch_size
C5_SPACING = 10
JS_INNER = 1_000_000  # 8a: events per side, 2.5x bench.py's 400,000
JS_LEFT = 400_000  # 8b: bench.py's events per side
JS_BATCH = 8_192  # bench.py's join-stress batch
# 8a's median hot-partition probe (4,378 probes of a CPU run of phase 8):
# ring capacity and rows, padded and real queries; 100,000 keys over 16
# join partitions leave 6,250 keys a partition
JS_RING_CAP, JS_RING_ROWS, JS_MQ, JS_M = 8_192, 5_905, 1_024, 520
# 8a's merges take that ring and a delta of JS_M rows.  8b's median hot
# merge and probe, field by field over the 431 merges and 936 probes of a
# CPU run of phase 8b (python3 -m arroyo_tpu_torch.tools.join_stress_shapes
# 8b: ARROYO_DEVICE_JOIN=on makes the card's ring decisions on the CPU):
# ring capacity, resident rows and delta rows; ring capacity and rows,
# padded and real queries
JS_B_MERGE_CAP, JS_B_MERGE_ROWS, JS_B_MERGE_M = 32_768, 16_480, 540
JS_B_RING_CAP, JS_B_RING_ROWS, JS_B_MQ, JS_B_M = 16_384, 15_956, 512, 499
JS_KEYS = 6_250
HOT_EVENTS = 40_000_000  # the size at which hot items' fires turn sparse
HOT_SMALL = 2_000_000
# hot items at HOT_EVENTS (a CPU run of the JAX package): TopN input rows
# of a steady-state fire (one window) and of the final flush (5 windows);
# the key directory's capacity and ring; fire density when compact
TOPK_STEADY, TOPK_FLUSH = 599_800, 1_410_844
C_HOT, B_HOT, W_HOT = 4_194_304, 16, 5
HOT_DENSITY = 0.25
# its occupied slots (the auctions of a 40M-event run) and the dense
# fire's c_slice for them (rounded up to 2,048)
HOT_ROWS, C_SLICE_HOT = 2_398_860, 2_400_256
# cells of a flush (``KeyedBinState._dispatch_cells``), the largest of
# q5's at NUM_EVENTS (2 flushes: 70,738 and 49,289) and of hot items' at
# HOT_EVENTS (40 flushes of 47,319-70,836), as phases 5 and 9 print them
Q5_FLUSH, HOT_FLUSH = 70_738, 70_836
SECTOR = 32  # bytes of the card's memory transaction
ATOM = 64  # bytes HBM3 reads or writes at a time

K1_SOURCE = "arroyo_tpu_torch/csrc/bin_update.cu"
K1_REPLACES = ("arroyo_tpu/ops/keyed_bins.py:62 _update_kernel; "
               "arroyo_tpu/ops/pallas_kernels.py:77 _scatter_kernel")
# q5's one argmax fire at NUM_EVENTS (a CPU run of its path): 119,938
# occupied slots of C_Q5, one live ring bin (column 0) in each of the
# first five of eight panes
Q5_ARGMAX_ROWS = 119_938
Q5_ARGMAX_RING = [[12, 13, 14, 15, 0], [13, 14, 15, 0, 1], [14, 15, 0, 1, 2],
                  [15, 0, 1, 2, 3], [0, 1, 2, 3, 4]] + [[0] * 5] * 3
Q5_ARGMAX_OK = [[w == 4 - p for w in range(5)] if p < 5 else [False] * 5
                for p in range(8)]
K2_SOURCE = "arroyo_tpu_torch/csrc/argmax_fire.cu"
K2_REPLACES = ("arroyo_tpu/ops/keyed_bins.py:157 _argmax_nnz_kernel + "
               ":180 _argmax_gather_kernel")
K3_SOURCE = "arroyo_tpu_torch/csrc/pane_emit.cu"
K3_REPLACES = ("arroyo_tpu/ops/keyed_bins.py:123 _emit_kernel + "
               ":109 _pane_reduce")
K4_SOURCE = "arroyo_tpu_torch/csrc/bin_evict.cu"
K4_REPLACES = "arroyo_tpu/ops/keyed_bins.py:262 _evict_kernel"
K5_SOURCE = "arroyo_tpu_torch/csrc/ring_merge.cu"
K5_REPLACES = "arroyo_tpu/ops/join.py:372 _merge32_kernel"
K6_SOURCE = "arroyo_tpu_torch/csrc/ring_gather.cu"
K6_REPLACES = "arroyo_tpu/ops/join.py:535 _gather32_kernel"
K7_SOURCE = "arroyo_tpu_torch/csrc/session_union.cu"
K7_REPLACES = "arroyo_tpu/ops/session.py:75 _union_kernel"
K8_SOURCE = "arroyo_tpu_torch/csrc/segment_agg.cu"
K8_REPLACES = "arroyo_tpu/ops/segment.py:30 _segment_agg_kernel"
K9_SOURCE = "arroyo_tpu_torch/csrc/join_probe.cu"
K9_REPLACES = "arroyo_tpu/ops/join.py:76 _probe_kernel"
K10_SOURCE = "arroyo_tpu_torch/csrc/join_expand.cu"
K10_REPLACES = "arroyo_tpu/ops/join.py:121 _expand_kernel"
K11_SOURCE = "arroyo_tpu_torch/csrc/expand_gather.cu"
K11_REPLACES = "arroyo_tpu/ops/join.py:487 _expand_gather_kernel"
K12_SOURCE = "arroyo_tpu_torch/csrc/segment_top_k.cu"
K12_REPLACES = "arroyo_tpu/ops/topk.py:25 _topk_kernel"
K15_SOURCE = "arroyo_tpu_torch/csrc/join_sort.cu"
K15_REPLACES = "arroyo_tpu/ops/join.py:66 _sort_kernel"
K13_SOURCE = K14_SOURCE = "arroyo_tpu_torch/csrc/emit_compact.cu"
K13_REPLACES = "arroyo_tpu/ops/keyed_bins.py:198 _emit_count_kernel"
K14_REPLACES = "arroyo_tpu/ops/keyed_bins.py:213 _emit_compact_kernel"
K16_SOURCE = "arroyo_tpu_torch/csrc/ring_emit.cu"
K16_REPLACES = ("arroyo_tpu/ops/keyed_bins.py:242 _linearize_kernel + "
                "arroyo_tpu/parallel/ring_panes.py:106 _ring_step_2d "
                "(:39 _ring_step)")
# phase 19's state: COUNT(*) (the counts plane), SUM(price), MAX(price)
# and their validity counts; its key capacity and ring
HOP_KINDS = ("count", "sum", "max", "sum", "sum")
HOP_XFER = (1, 2, 3, 4)
HOP_W = 300  # HOP(1 s, 300 s): bins a window
C_HOP, B_HOP = 16_384, 1_024
# its median ring fire at HOP_EVENTS (a CPU run: 400 fires, 399 of one
# pane, the final flush of 300): 10,004 occupied slots, pane 200 of the
# bins -99 .. 200, live 0 .. 201; (first_bin, lo, hi, k)
HOP_ROWS, HOP_FIRE = 10_004, (-99, 0, 201, 1)
C_RING_BIG = 262_144

KERNELS = (bin_update, argmax_fire, pane_emit, bin_evict, ring_merge,
           ring_gather, session_union, segment_agg, join_probe, join_expand,
           expand_gather, segment_top_k, emit_count, emit_gather, join_sort,
           ring_emit, mesh_route, mesh_merge, mesh_remap)
# phase 12 compares each SQL-planned run with the hand-built run of the
# same query at the same size that an earlier phase made: query -> (rows,
# launches, wall s)
HAND = {}
# phase 14 holds its legacy runs to phases 6's and 8's controls and rows:
# "q8", "q8_rows", "inner", "left" (creates, deletes), "gate_inner",
# "gate_left"
CONTROLS = {}
SQL_QUERIES = ("q1", "q5", "q7", "q8", "hot_items", "config5")
PATHS = ("q5", "q8", "config5", "join_inner", "join_left", "hot_items",
         "q1", "q7", "sql", "q5_ref", "q7_ref", "q16", "union", "q8_legacy",
         "join_inner_legacy", "join_left_legacy", "semi", "mw", "mw_ttl",
         "cw_2m_fact", "cw_2m_unfact", "cw_8m_fact", "cw_8m_ckpt",
         "services_q5", "services_config5", "services_8a", "native_q5",
         "native_hot", "fs_c5", "kafka_c5", "hop_on_1", "hop_off_1",
         "hop_off_2", "hop_on_2", "hop_small", "q5_ring", "mesh_q5",
         "mesh_shuffle")


def reset_launches():
    for k in KERNELS:
        k.launches = 0
    join_probe.u64_launches = 0


def read_launches():
    """Launches a kernel; ``join_probe_u64`` the u64 form's share of
    ``join_probe``'s."""
    out = {k.__name__: k.launches for k in KERNELS}
    out["join_probe_u64"] = join_probe.u64_launches
    return out


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps=20, warm=3):
    """Median milliseconds of one call, CUDA events around each call."""
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


def in_turns(kernel, other, pairs=3, **reps):
    """``kernel`` and ``other`` (a library call, or another version) timed
    in turns, ``pairs`` rounds of (other, kernel, kernel, other), each a
    cuda_ms median (``reps``: its reps and warm calls): (kernel ms, other
    ms, the medians in order), the ms the means of each side's medians."""
    seq = []
    for _ in range(pairs):
        seq += [cuda_ms(other, **reps), cuda_ms(kernel, **reps),
                cuda_ms(kernel, **reps), cuda_ms(other, **reps)]
    mine = [t for i, t in enumerate(seq) if i % 4 in (1, 2)]
    theirs = [t for i, t in enumerate(seq) if i % 4 in (0, 3)]
    return statistics.fmean(mine), statistics.fmean(theirs), seq


def turn_factors(seq):
    """What in_turns' medians say of the two sides: the other's time over
    the kernel's in each round (above 1: the kernel is faster), and each
    side's spread (its slowest median over its fastest) within the call."""
    rounds = [seq[i:i + 4] for i in range(0, len(seq), 4)]
    mine = [t for r in rounds for t in r[1:3]]
    theirs = [t for r in rounds for t in (r[0], r[3])]
    return {"factor_each_round": [(r[0] + r[3]) / (r[1] + r[2])
                                  for r in rounds],
            "kernel_spread": max(mine) / min(mine),
            "other_spread": max(theirs) / min(theirs)}


def host_us(fn, reps=2000):
    """Mean host microseconds of one call (no synchronization inside the
    loop; launches queue on the card)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    dt = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return dt / reps / 1e3


def per_call(fn):
    """(allocations, host syncs) of one warm call of ``fn``: the caching
    allocator's allocation requests (``memory_stats``) and the
    synchronizing operations PyTorch reports while
    ``set_sync_debug_mode`` is "warn"."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    torch.cuda.synchronize()
    # the mode's first use also warns that it is a prototype: not a sync
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    return allocs, syncs


def profile_kernels(fn, reps=20, before=None):
    """Device microseconds of each kernel launch of one ``fn`` call, in
    launch order (``name[i]`` for the i-th launch of a kernel launched
    more than once), means over ``reps`` calls from torch.profiler's CUDA
    activity; empty when the profiler records no device activity.
    ``before`` (an L2 flush) runs ahead of each call; its own launches
    are listed too."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # now and then a profile records no device activity, or loses some
    # launches (a kernel's count is then no multiple of reps): take it
    # again, up to three times; a profile with no device activity three
    # times in a row, up to three times more, a second apart
    runs = {}
    for attempt in range(6):
        if attempt >= 3:
            if runs:
                break
            time.sleep(1.0)
            fn()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        runs = collections.defaultdict(list)
        for ev in sorted((e for e in prof.events()
                          if e.device_type
                          == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start):
            m = re.search(r"([A-Za-z_]\w*)(?:<[^()]*>)?\(", ev.name)
            runs[m.group(1) if m else ev.name[:40]].append(
                ev.time_range.elapsed_us())
        if runs and all(len(t) % reps == 0 for t in runs.values()):
            break
    per = {}
    for name, times in runs.items():
        n = max(1, len(times) // reps)
        for i in range(n):
            per[f"{name}[{i}]" if n > 1 else name] = (
                statistics.fmean(times[i::n]))
    return per


def searched(plane_bytes, n, searches):
    """Bytes of a sorted plane of ``n`` entries that ``searches`` binary
    searches must read: a 32-byte sector per step, ceil(log2(n + 1))
    steps each, and never more than the whole plane."""
    return min(plane_bytes, 32 * math.ceil(math.log2(n + 1)) * searches)


def bound(nbytes, ops, op_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 + 2 ------------------------------------------------------------------


def environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"host library: HAVE_NATIVE {native.HAVE_NATIVE} "
          f"{native.LIBRARY}")
    check(native.HAVE_NATIVE, "the host library (arroyo_tpu_torch/native/"
          "host_ops.cpp) did not build or load")
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    print(f"build {time.perf_counter() - t0:.3f} s -> {path.name}")
    return smi


# -- phase 3: kernels ---------------------------------------------------------------


# MIN/MAX inputs a single integer atomic on the f64 bits must order right
SIGNED = np.array([0.0, -0.0, 1.5, -1.5, 1e-300, -1e-300, 1e300, -1e300,
                   3.0, -3.0])


def flush_callers(cells, C, cdt, parent, dev):
    """``KeyedBinState.flush_updates`` of one buffered COUNT(*) cell run
    (q5's and hot items' aggregate) on a state of C slots: this tree's
    (one pinned non-blocking upload, one launch) against the parent's (two
    blocking uploads), the same planes after one flush each, then in
    turns, with allocations, host syncs and uploads a flush."""
    aggs = (AggSpec(AggKind.COUNT, None, "n"),)
    p_aggs = (parent.logical.AggSpec(parent.logical.AggKind.COUNT, None,
                                     "n"),)
    states = []
    for cls, a in ((KeyedBinState, aggs), (parent.keyed_bins.KeyedBinState,
                                           p_aggs)):
        st = cls(a, SLIDE_MICROS, WIDTH_MICROS, capacity=8, device=dev)
        st.C = C
        st.values = torch.zeros((1, C, st.B), dtype=torch.float64,
                                device=dev)
        st.counts = torch.zeros((C, st.B), dtype=cdt, device=dev)
        states.append(st)
    m = len(cells[0])

    def flusher(st):
        def flush():
            st._pending = [cells]
            st._pending_cells = m
            st.flush_updates()
        return flush

    flush, parent_flush = flusher(states[0]), flusher(states[1])
    perf.reset()
    flush()
    uploads = (perf.counter("bin_flush_uploads"),
               perf.counter("bin_flush_blocking_uploads"))
    parent_flush()
    torch.cuda.synchronize()
    check(uploads == (1, 0), f"a flush made {uploads} (uploads, blocking "
          "uploads)")
    check(torch.equal(states[0].counts, states[1].counts)
          and torch.equal(states[0].values, states[1].values),
          "flush_updates differs from the parent's")
    ms, p_ms, turns = in_turns(flush, parent_flush)
    return {"ms": ms, "parent_ms": p_ms, "turns_ms": turns,
            **turn_factors(turns), "uploads_blocking": uploads,
            "allocations_syncs": per_call(flush),
            "parent_allocations_syncs": per_call(parent_flush),
            "host_us": host_us(flush, reps=200),
            "parent_host_us": host_us(parent_flush, reps=200)}


# the keyed-bin states that phases 9 and 6 print after 40M events: hot
# items' HOP(2 s, 10 s) COUNT(*) and q8's 10 s tumbling person state
# (keys, slot capacity, live bins), batches of 131,072
DIRECTORY_SHAPES = {"hot items": (2_398_860, 4_194_304, 6),
                    "q8": (800_000, 1_048_576, 2)}
DIRECTORY_BATCHES = 305  # 40M events in batches of 131,072


def directory_callers(parent, dev):
    """The keyed-bin state's host directory and snapshot against the
    parent's, in turns, at DIRECTORY_SHAPES: ``directory_insert`` of one
    batch of 131,072 key hashes into a directory of that many keys (the
    batch: its share of new keys, keys / DIRECTORY_BATCHES; half of it 8
    hot keys; the rest drawn from the newest 100,000 keys), each call a
    fresh batch, both sides fed the same batches into their own
    directories; and ``KeyedBinState.snapshot`` of a COUNT(*) state of
    that capacity on hot items' ring (B = 16) with every key occupied and the live bins filled.  This
    tree's directory is the host library's (NativeDir, slots in first-seen
    order), the parent's the sorted arrays (slots in ascending hash
    order): this tree's slots are held equal to a numpy first-seen control,
    both sides' sorted keys to each other and each side's slots to its own
    keys; the snapshots are held equal first.  Then the cell
    pre-aggregation of one q5 batch (AGG_ROWS Zipf rows over AGG_KEYS
    slots and 16 bins, no transferred channel): this tree's ``agg_cells``
    against the parent's ``preaggregate``, the same cells first, then in
    turns."""
    from types import SimpleNamespace
    from arroyo_tpu_torch.ops.keyed_bins import directory_insert
    out = {}
    for shape, (n_keys, cap, live) in DIRECTORY_SHAPES.items():
        rng = np.random.default_rng(19)
        keys = np.unique(rng.integers(1, 2**63, int(n_keys * 1.01),
                                      dtype=np.uint64))[:n_keys]
        rng.shuffle(keys)  # slot order: arrival order
        n_new = n_keys // DIRECTORY_BATCHES
        batch = 131_072
        newest = keys[-100_000:]
        hot = keys[-8:]
        batches = []
        for _ in range(60):
            fresh = rng.integers(2**63, 2**64 - 1, n_new, dtype=np.uint64)
            rest = batch - n_new
            kh = np.concatenate([fresh, rng.choice(hot, rest // 2),
                                 rng.choice(newest, rest - rest // 2)])
            rng.shuffle(kh)
            batches.append(kh)

        def directory():
            order = np.argsort(keys, kind="stable")
            st = SimpleNamespace(
                key_sorted=keys[order], slot_of_sorted=order.astype(np.int64),
                next_slot=n_keys, slot_to_key=np.zeros(cap, dtype=np.uint64))
            st.slot_to_key[:n_keys] = keys

            def ensure(total, _new):
                if total > len(st.slot_to_key):
                    st.slot_to_key = np.concatenate([st.slot_to_key, np.zeros(
                        total - len(st.slot_to_key), dtype=np.uint64)])
            return st, ensure

        sides = []
        for insert in (directory_insert, parent.keyed_bins.directory_insert):
            st, ensure = directory()
            if insert is directory_insert:
                st._ndir = native.NativeDir.create(cap)
                st._ndir.load(keys, np.arange(n_keys, dtype=np.int64))
            it = iter(batches)
            sides.append((st, lambda st=st, ensure=ensure, it=it,
                          insert=insert: insert(st, next(it), ensure)))
        control = first_seen_slots(np.sort(keys), np.argsort(keys,
                                                             kind="stable"),
                                   batches[0], n_keys)
        first = [call() for _st, call in sides]
        check(np.array_equal(first[0], control)
              and np.array_equal(sides[0][0].key_sorted,
                                 sides[1][0].key_sorted)
              and all(np.array_equal(st.slot_to_key[got], batches[0])
                      for (st, _c), got in zip(sides, first)),
              f"directory_insert: slots against the first-seen control or "
              f"keys against the parent's ({shape})")
        ins_ms, p_ins_ms, ins_turns = in_turns(
            sides[0][1], sides[1][1], pairs=2, reps=5, warm=1)

        states = []
        for cls, lg in ((KeyedBinState, None), (parent.keyed_bins.KeyedBinState,
                                                parent.logical)):
            spec = (AggSpec(AggKind.COUNT, None, "n") if lg is None
                    else lg.AggSpec(lg.AggKind.COUNT, None, "n"))
            st = cls((spec,), SLIDE_MICROS, WIDTH_MICROS, capacity=cap,
                     device=dev)
            st.key_sorted = np.sort(keys)
            st.slot_of_sorted = np.argsort(keys, kind="stable")
            st.slot_to_key[:n_keys] = keys
            st.next_slot = n_keys
            st.min_bin, st.max_bin = 100, 100 + live - 1
            cols = torch.arange(100, 100 + live, device=dev) % st.B
            gen = torch.Generator(device=dev).manual_seed(19)
            cnt = torch.randint(1, 50, (n_keys, live), device=dev,
                                generator=gen, dtype=torch.int32)
            st.counts[:n_keys, cols] = cnt
            st.values[0, :n_keys, cols] = cnt.double()
            states.append(st)
        snaps = [st.snapshot() for st in states]
        check(snaps[0].keys() == snaps[1].keys() and all(
            np.array_equal(snaps[0][k], snaps[1][k]) for k in snaps[0]),
            f"snapshot differs from the parent's ({shape})")
        snap_bytes = sum(a.nbytes for a in snaps[0].values())
        del snaps
        snap_ms, p_snap_ms, snap_turns = in_turns(
            states[0].snapshot, states[1].snapshot, pairs=2, reps=5, warm=1)
        del states
        torch.cuda.empty_cache()
        out[shape] = {
            "keys": n_keys, "capacity": cap, "live_bins": live,
            "new_keys_a_batch": n_new,
            "directory_insert_ms": ins_ms, "parent_directory_insert_ms":
            p_ins_ms, "directory_insert_turns_ms": ins_turns,
            **{f"directory_insert_{k}": v
               for k, v in turn_factors(ins_turns).items()},
            "snapshot_ms": snap_ms, "parent_snapshot_ms": p_snap_ms,
            "snapshot_turns_ms": snap_turns, "snapshot_bytes": snap_bytes,
            **{f"snapshot_{k}": v
               for k, v in turn_factors(snap_turns).items()}}
    out["agg_cells"] = agg_callers(parent)
    return out


def first_seen_slots(key_sorted, slot_of_sorted, kh, next_slot):
    """numpy control of the host library's directory: known keys keep
    their slots, new keys take ``next_slot``, ``next_slot + 1``, ... in
    the order they first appear in ``kh``."""
    uniq, first, inv = np.unique(kh, return_index=True, return_inverse=True)
    pos = np.minimum(np.searchsorted(key_sorted, uniq), len(key_sorted) - 1)
    known = key_sorted[pos] == uniq
    slots = np.where(known, slot_of_sorted[pos], -1)
    new = (~known).nonzero()[0]
    slots[new[np.argsort(first[new])]] = next_slot + np.arange(len(new))
    return slots[inv.reshape(-1)]


AGG_ROWS, AGG_KEYS = 131_072, 20_000  # one q5 batch; Zipf auction slots


def agg_callers(parent):
    """One q5 batch's (slot, bin) cells: ``agg_cells`` (the host
    library, first-appearance order) against the parent's
    ``preaggregate`` (sorted), the same cells sorted, then in turns."""
    rng = np.random.default_rng(21)
    slots = (rng.zipf(1.3, AGG_ROWS) % AGG_KEYS).astype(np.int64)
    bins = rng.integers(0, 16, AGG_ROWS).astype(np.int32)
    vals = np.empty((0, AGG_ROWS))
    got = native.agg_cells(slots, bins, None, 16, vals, ())
    want = parent.keyed_bins.preaggregate(slots, bins, (), vals)
    order = np.lexsort((got[1], got[0]))
    check(all(np.array_equal(g[..., order], w) for g, w in zip(got, want)),
          "agg_cells differs from the parent's preaggregate")
    ms, p_ms, turns = in_turns(
        lambda: native.agg_cells(slots, bins, None, 16, vals, ()),
        lambda: parent.keyed_bins.preaggregate(slots, bins, (), vals),
        pairs=2, reps=5, warm=1)
    return {"rows": AGG_ROWS, "cells": len(got[0]), "agg_cells_ms": ms,
            "parent_preaggregate_ms": p_ms, "turns_ms": turns,
            **turn_factors(turns)}


def k1_case(rng, dev, kinds, dup, m, cdt, unique, shape, C=C_Q5,
            parent=None, caller=False):
    """K1 on one flush of ``m`` cells into C x B_Q5 planes: unique cells
    sorted by (slot, bin), as the state sends them, or duplicates (runs of
    one cell across warp boundaries) with padding rows and MIN/MAX inputs
    of both signs and +/-0.0.  Counts and MIN/MAX bit-equal to the plain
    version, sums too on unique cells, rtol 1e-12 on duplicates; one
    launch, no allocation and no host sync a call.  With ``parent``: the
    parent's kernel (its idx/packed arguments) in turns, and with
    ``caller`` ``flush_updates`` in turns with the parent's."""
    plan = channel_plan(kinds, dup)
    n_ch, n_xfer = len(kinds), plan.n_xfer
    if unique:
        cells = np.sort(rng.choice(C * B_Q5, m, replace=False))
        slots, bins = cells // B_Q5, cells % B_Q5
    else:
        slots = rng.integers(0, C, m)
        bins = rng.integers(0, B_Q5, m)
        for lo in range(28, m - 8, 32):  # one cell over a warp boundary
            slots[lo:lo + 8], bins[lo:lo + 8] = slots[lo], bins[lo]
    rowcnt = rng.integers(1, 40, m).astype(np.float64)
    if not unique:
        rowcnt[rng.random(m) < 0.1] = 0.0
    vals = rng.normal(size=(n_xfer, m)) * 1e3
    xfer_kinds = [k for j, k in enumerate(kinds) if j not in dup]
    for r, k in enumerate(xfer_kinds):
        if k in ("min", "max") and not unique:
            vals[r] = rng.choice(SIGNED, m)
    cells_t = torch.tensor(pack_cells(slots, bins, rowcnt, vals), device=dev)
    values = torch.zeros((n_ch, C, B_Q5), dtype=torch.float64, device=dev)
    for j, k in enumerate(kinds):
        if k in ("min", "max"):
            values[j] = channel_identity(k)
            if not unique:
                live = torch.rand((C, B_Q5), device=dev) < 0.3
                values[j][live] = torch.tensor(
                    rng.choice(SIGNED, int(live.sum())), device=dev)
    counts = torch.zeros((C, B_Q5), dtype=cdt, device=dev)
    v_k, c_k = values.clone(), counts.clone()
    v_r, c_r = values.clone(), counts.clone()
    before = bin_update.launches
    bin_update(v_k, c_k, cells_t, plan)
    launches = bin_update.launches - before
    bin_update_reference(v_r, c_r, cells_t, plan)
    torch.cuda.synchronize()
    check(launches == 1, f"bin_update made {launches} launches ({shape})")
    check(torch.equal(c_k, c_r), f"bin_update counts differ ({shape})")
    err = 0.0
    for j, k in enumerate(kinds):
        if k in ("min", "max") or unique:
            check(torch.equal(v_k[j].view(torch.int64),
                              v_r[j].view(torch.int64)),
                  f"bin_update channel {j} ({k}) not bit-equal ({shape})")
        else:  # f64 sums of duplicate cells: atomics change the order
            torch.testing.assert_close(v_k[j], v_r[j], rtol=1e-12, atol=1e-9)
            err = max(err, float((v_k[j] - v_r[j]).abs().max()))
    del v_r, c_r

    def kernel():
        bin_update(v_k, c_k, cells_t, plan)

    plain = cuda_ms(lambda: bin_update_reference(values, counts, cells_t,
                                                 plan))
    meas = measured(kernel, "bin_update")
    check(meas["allocations_per_call"] == 0 and meas["syncs_per_call"] == 0,
          f"bin_update made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    library = turns = None
    if kinds == ("count",) and dup == (0,):  # q5's and hot items' COUNT(*)
        s_l, b_l = cells_t[0].view(torch.int32).long().view(2, m)
        rc = cells_t[1].view(torch.float64)

        def lib():  # the counts plane and the COUNT(*) channel
            c_k.index_put_((s_l, b_l), rc.to(cdt), accumulate=True)
            v_k[0].index_put_((s_l, b_l), rc, accumulate=True)

        ms, library, turns = in_turns(kernel, lib)
    else:
        ms = cuda_ms(kernel)
    valid = rowcnt > 0.5
    touched = len(np.unique((slots * B_Q5 + bins)[valid]))
    itemsize = counts.element_size()
    nbytes = 8 * m * (2 + n_xfer) + touched * (16 * n_ch + 2 * itemsize)
    r = row("bin_update", K1_SOURCE, K1_REPLACES, shape, err, ms, plain,
            nbytes, int(valid.sum()) * n_ch, library,
            "index_put_ x2 (counts, COUNT(*))")
    r.update(launches_per_call=launches, bound_bytes=nbytes,
             device_us_sum=device_sum(meas), **meas)
    if turns is not None:
        r.update(turns_ms=turns, library_turns=turn_factors(turns))
    if parent is not None:
        pu = parent.bin_update
        p_plan = parent.channel_plan(kinds, dup)
        p_v, p_c = values.clone(), counts.clone()
        pu(p_v, p_c, cells_t, p_plan)
        mine_v, mine_c = values.clone(), counts.clone()
        bin_update(mine_v, mine_c, cells_t, plan)
        torch.cuda.synchronize()
        # MIN/MAX bit-equal; sums of duplicate cells land in atomic order
        check(torch.equal(p_c, mine_c) and (
            torch.equal(p_v, mine_v) if unique else
            all(torch.equal(p_v[j].view(torch.int64),
                            mine_v[j].view(torch.int64))
                for j, k in enumerate(kinds) if k in ("min", "max"))),
              f"bin_update differs from the parent's ({shape})")
        del p_v, p_c, mine_v, mine_c

        def parent_call():
            pu(v_k, c_k, cells_t, p_plan)

        c_ms, p_ms, p_turns = in_turns(kernel, parent_call)
        p_meas = measured(parent_call, "bin_update")
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       "device_us_sum": device_sum(p_meas), **p_meas}
        if caller:
            r["parent"]["caller"] = flush_callers(
                (slots, bins, rowcnt, vals), C, cdt, parent, dev)
    print(f"bin_update {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "library_turns",
                                 "plain_ms", "bound_ms", "launches_per_call",
                                 "host_us_per_call", "device_us_per_call",
                                 "device_us_cold", "device_us_sum",
                                 "allocations_per_call", "syncs_per_call",
                                 "parent") if key in r}))
    return r


def argmax_callers(counts, rows, ring_np, ok_np, parent):
    """``KeyedBinState._emit_argmax`` at q5's fire (a COUNT(*) state of
    ``rows`` occupied slots of ``counts``): this tree's (the panes in one
    pinned upload, one launch, one readback) against the parent's (two
    blocking uploads, four launches, three syncs more), the same rows,
    then in turns, with allocations, host syncs, uploads and readbacks a
    fire."""
    aggs = (AggSpec(AggKind.COUNT, None, "n"),)
    p_aggs = (parent.logical.AggSpec(parent.logical.AggKind.COUNT, None,
                                     "n"),)
    C, B = counts.shape
    fires = []
    for cls, a in ((KeyedBinState, aggs), (parent.keyed_bins.KeyedBinState,
                                           p_aggs)):
        st = cls(a, SLIDE_MICROS, WIDTH_MICROS, capacity=8,
                 device=counts.device)
        st.C, st.B, st.next_slot, st.counts = C, B, rows, counts
        st.values = torch.zeros((1, C, B), dtype=torch.float64,
                                device=counts.device)
        st.set_argmax_local("n", "max")
        fires.append(functools.partial(st._emit_argmax, ring_np, ok_np))
    fire, parent_fire = fires
    perf.reset()
    got = fire()
    names = ("bin_argmax_fire_uploads", "bin_argmax_fire_blocking_uploads",
             "bin_argmax_fire_readbacks", "bin_argmax_fire_overflows")
    counters = tuple(perf.counter(x) for x in names)
    want = parent_fire()
    check(counters == (1, 0, 1, 0), f"an argmax fire made {counters} "
          "(uploads, blocking uploads, readbacks, overflows)")
    check(all(np.array_equal(x, y) for x, y in zip(got, want)),
          "_emit_argmax differs from the parent's")
    ms, p_ms, turns = in_turns(fire, parent_fire)
    return {"ms": ms, "parent_ms": p_ms, "turns_ms": turns,
            **turn_factors(turns), "counters": dict(zip(names, counters)),
            "allocations_syncs": per_call(fire),
            "parent_allocations_syncs": per_call(parent_fire),
            "host_us": host_us(fire, reps=100),
            "parent_host_us": host_us(parent_fire, reps=100)}


def k2_case(rng, dev, kpad, minmax, cdt, parent=None, q5=False):
    """K2 on C_Q5 x B_Q5 counts: all slots occupied and panes over
    consecutive ring columns, or (``q5``) q5's real fire — Q5_ARGMAX_ROWS
    occupied slots, zeros past them, one live bin in five of eight panes.
    The buffer form (the caller's) equal to the plain version over all
    slots, in one launch, one allocation and no host sync; with
    ``parent`` the parent's four-launch, one-sync call in turns and, at
    q5's fire, the caller ``_emit_argmax`` in turns with the parent's."""
    W = WIDTH_MICROS // SLIDE_MICROS
    if q5:
        kpad, rows = len(Q5_ARGMAX_RING), Q5_ARGMAX_ROWS
        ring_np = np.array(Q5_ARGMAX_RING, dtype=np.int32)
        ok_np = np.array(Q5_ARGMAX_OK)
    else:
        rows = C_Q5
        ring_np = ((np.arange(kpad)[:, None] + np.arange(W)[None, :])
                   % B_Q5).astype(np.int32)
        ok_np = np.ones((kpad, W), dtype=bool)
        ok_np[0, :2] = False  # the oldest bins of the first pane evicted
    cells = rng.poisson(2.0, (C_Q5, B_Q5))
    cells[rows:] = 0  # the slots past next_slot
    counts = torch.tensor(cells, dtype=cdt, device=dev)
    ring = torch.tensor(ring_np, device=dev)
    ok = torch.tensor(ok_np, device=dev)
    want = argmax_fire_reference(counts, ring, ok, minmax)  # all C slots
    # the caller's capacity after a fire of this many candidates
    cap = max(ARGMAX_MIN_CAP, 2 * want[0].shape[1])

    def kernel():  # the call the argmax fire makes: one buffer
        return argmax_fire_buffer(counts, ring, ok, rows, minmax, cap)

    before = argmax_fire.launches
    buf = kernel()
    launches = argmax_fire.launches - before
    total = int(buf[0])
    shape = (f"{'q5 fire ' if q5 else ''}C={C_Q5} rows={rows} B={B_Q5} "
             f"W={W} kpad={kpad} live_bins={int(ok_np.sum())} {minmax} "
             f"{cdt} nnz={total}")
    check(launches == 1, f"argmax_fire made {launches} launches ({shape})")
    check(total == want[0].shape[1] <= cap
          and all(torch.equal(x, y) for x, y in zip(
              argmax_views(buf, total, cap, cdt),
              (want[0][0], want[0][1], want[1]))),
          f"argmax_fire differs ({shape})")
    got = argmax_fire(counts, ring, ok, minmax)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"argmax_fire's tuple form differs ({shape})")
    meas = measured(kernel, "argmax_kernel")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"argmax_fire made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    itemsize = counts.element_size()
    cols = np.unique(ring_np[ok_np])
    out_bytes = 4 + total * (8 + itemsize)
    r = row("argmax_fire", K2_SOURCE, K2_REPLACES, shape, 0.0,
            cuda_ms(kernel),
            cuda_ms(lambda: argmax_fire_buffer_reference(
                counts, ring, ok, rows, minmax, cap)),
            rows * len(cols) * itemsize + out_bytes, rows * int(ok_np.sum()),
            None, None)
    # the least time IF memory moves whole 64-byte atoms: a row's live
    # columns cost its atoms
    r.update(launches_per_call=launches,
             atom_bound_ms=atom_bound_ms(
                 rows * row_atoms(itemsize, B_Q5, cols), 0, out_bytes),
             device_us_sum=device_sum(meas), **meas)
    if parent is not None:
        pa = parent.argmax_fire
        p_got = pa(counts, ring, ok, minmax)
        torch.cuda.synchronize()
        check(torch.equal(p_got[0], want[0]) and torch.equal(p_got[1],
                                                             want[1]),
              f"the parent's argmax_fire differs ({shape})")

        def parent_call():
            return pa(counts, ring, ok, minmax)

        c_ms, p_ms, p_turns = in_turns(kernel, parent_call)
        p_meas = measured(parent_call, (
            "pane_counts", "select_count", "exclusive_scan", "gather_kernel",
            "elementwise"))
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       "device_us_sum": device_sum(p_meas), **p_meas}
        if q5:
            r["parent"]["caller"] = argmax_callers(counts, rows, ring_np,
                                                   ok_np, parent)
    print(f"argmax_fire {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                 "atom_bound_ms", "launches_per_call",
                                 "host_us_per_call", "device_us_per_call",
                                 "device_us_cold", "device_us_sum",
                                 "allocations_per_call", "syncs_per_call",
                                 "parent") if key in r}))
    return r


# (name, C, occupied rows, kpad, B, W, live panes) of argmax fires past
# q5's: more than 256 live panes (pane tiles), 2,048 panes staged past
# 48 KiB, a 120-bin window's final fire, and panes too wide for shared
# memory (read from global memory) in one and in eight tiles
K2_BRANCHES = (("tiles", 20_000, 19_000, 512, 16, 3, 300),
               ("panes_2048", 4096, 4000, 2048, 16, 5, 2048),
               ("final_w120", 8_192, 8_000, 128, 128, 120, 122),
               ("unstaged", 2_048, 2_000, 128, 512, 500, 128),
               ("unstaged_tiles", 1_024, 1_000, 2048, 64, 40, 2048))


def k2_branches(rng, dev):
    """argmax_fire's buffer form at K2_BRANCHES, max and min, i32 and
    i64: one launch each, every candidate equal to the plain version's
    (no timing)."""
    cap = 1 << 17  # above every total here
    for name, C, rows, kpad, B, W, live in K2_BRANCHES:
        ring = torch.tensor(((np.arange(kpad)[:, None] + np.arange(W)[None, :])
                             % B).astype(np.int32), device=dev)
        ok_np = np.ones((kpad, W), dtype=bool)
        if name == "final_w120":  # pane p holds bins p .. p + 119 of 0 .. 124
            ok_np = (np.arange(kpad)[:, None] + np.arange(W)[None, :]) <= 124
        ok_np[0, :2] = False
        ok_np[live:] = False
        ok = torch.tensor(ok_np, device=dev)
        cells = rng.poisson(2.0, (C, B))
        cells[rows:] = 0
        totals = []
        for cdt in (torch.int32, torch.int64):
            counts = torch.tensor(cells, dtype=cdt, device=dev)
            for minmax in ("max", "min"):
                want = argmax_fire_buffer_reference(counts, ring, ok, rows,
                                                    minmax, cap)
                before = argmax_fire.launches
                got = argmax_fire_buffer(counts, ring, ok, rows, minmax, cap)
                total = int(want[0])
                check(argmax_fire.launches == before + 1
                      and int(got[0]) == total <= cap
                      and all(torch.equal(x, y) for x, y in zip(
                          argmax_views(got, total, cap, cdt),
                          argmax_views(want, total, cap, cdt))),
                      f"argmax_fire differs at {name} ({minmax} {cdt})")
                totals.append(total)
            del counts
        print(f"argmax_fire {name}: C={C} rows={rows} kpad={kpad} B={B} "
              f"W={W} live panes={live}: equal to the plain version, max "
              f"and min, int32 and int64, candidates {totals}")


def row(name, source, replaces, shape, err, ms, plain, nbytes, ops,
        library, library_call):
    bms, by = bound(nbytes, ops, F64_OPS_PER_S)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": library,
            "library_call": library_call if library is not None else None}


def bin_planes(rng, dev, kinds, C, B, cdt):
    """Bin-ring planes: data in 3 of 4 cells, identities elsewhere."""
    values = torch.empty((len(kinds), C, B), dtype=torch.float64, device=dev)
    for j, k in enumerate(kinds):
        values[j] = torch.tensor(rng.normal(size=(C, B)) * 100, device=dev)
        values[j][torch.tensor(rng.random((C, B)) < 0.25, device=dev)] = \
            channel_identity(k)
    counts = torch.tensor(rng.poisson(2.0, (C, B)), dtype=cdt, device=dev)
    return values, counts


def row_sectors(itemsize, B, cols):
    """32-byte sectors of one B-cell row that the ring columns ``cols``
    touch (rows start on a sector: B * itemsize is a multiple of 32)."""
    check(B * itemsize % SECTOR == 0, f"rows of {B * itemsize} bytes")
    return len({c * itemsize // SECTOR for c in cols})


def run_sectors(nbytes):
    """Bytes of the 32-byte sectors a contiguous run of ``nbytes`` fills."""
    return -(-nbytes // SECTOR) * SECTOR


def row_atoms(itemsize, B, cols):
    """HBM3's 64-byte access atoms that the ring columns ``cols`` of one
    B-cell row touch, as a fraction of an atom when rows are shorter
    (rows start on an atom or share one whole)."""
    row = B * itemsize
    if row < ATOM:
        return row / ATOM
    return len({c * itemsize // ATOM for c in cols})


def atom_bound_ms(read_atoms, partial_atoms, full_bytes):
    """The least time IF memory moves whole 64-byte atoms (a model, not
    measured here): atoms read, atoms partly written (read, then written
    back whole), and bytes written in whole atoms."""
    return ((read_atoms + 2 * partial_atoms) * ATOM + full_bytes) \
        / HBM_BYTES_PER_S * 1e3


def parent_kernels(parent):
    """The parent commit's package, from a ``git archive`` of it unpacked
    at ``parent``: its ``arroyo_tpu_torch`` imported as the package
    ``parent_torch``, its kernels built from its own csrc/ into its own
    build/ directory.  Returns a namespace of its pane_emit, bin_evict,
    segment_agg, expand_gather, join_probe, ring_merge, session_union,
    join_expand, bin_update, argmax_fire, join_sort, ring_emit, emit_count
    and emit_gather, its ``ops.join``, ``ops.session`` and
    ``ops.keyed_bins`` modules (the callers), its ``graph.logical``
    (their aggregate specs) and the build seconds."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(parent), "arroyo_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_torch"] = mod
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    importlib.import_module("parent_torch.kernels.build").load()
    secs = time.perf_counter() - t0
    names = ("pane_emit", "bin_evict", "segment_agg", "expand_gather",
             "join_probe", "ring_merge", "session_union", "join_expand",
             "bin_update", "argmax_fire", "join_sort", "ring_emit")
    return argparse.Namespace(
        build_s=secs, join=importlib.import_module("parent_torch.ops.join"),
        session=importlib.import_module("parent_torch.ops.session"),
        keyed_bins=importlib.import_module("parent_torch.ops.keyed_bins"),
        logical=importlib.import_module("parent_torch.graph.logical"),
        emit_count=importlib.import_module(
            "parent_torch.kernels.emit_compact").emit_count,
        emit_gather=importlib.import_module(
            "parent_torch.kernels.emit_compact").emit_gather,
        channel_plan=importlib.import_module(
            "parent_torch.kernels.bin_update").channel_plan,
        join_expand_buffer=importlib.import_module(
            "parent_torch.kernels.join_expand").join_expand_buffer,
        **{name: getattr(importlib.import_module(
            f"parent_torch.kernels.{name}"), name) for name in names})


def measured(fn, kernel):
    """What a row reports of one wrapper: host microseconds a call (200
    calls queued, no sync between them), torch.profiler's device
    microseconds of each launch — warm, and cold: after writing 64 MiB,
    more than the H100's 50 MB L2 holds, as a fire finds the planes after
    a stretch of other work (the launches whose names hold ``kernel``, a
    name or a tuple of names) — and allocations and host syncs a call."""
    allocs, syncs = per_call(fn)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    cold = profile_kernels(fn, before=flush.zero_)
    names = (kernel,) if isinstance(kernel, str) else kernel
    return {"host_us_per_call": host_us(fn, reps=200),
            "device_us_per_call": profile_kernels(fn),
            "device_us_cold": {n: us for n, us in cold.items()
                               if any(k in n for k in names)},
            "allocations_per_call": allocs, "syncs_per_call": syncs}


def pane_emit_split(args, library):
    """Where a pane_emit call's host time goes: microseconds of its
    argument checks, its one allocation, the launch alone (ctypes,
    cudaLaunchKernel) into a buffer made beforehand, the whole wrapper,
    and the library call."""
    values, counts, first_bin, lo, hi, W, k, kinds, xfer, c_slice = args
    dev = values.device
    nbytes = (8 * len(xfer) + counts.element_size()) * c_slice * k
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    spec = pane_emit_mod._check(values, counts, W, k, kinds, xfer, c_slice)
    return {
        "check_us": host_us(lambda: pane_emit_mod._check(
            values, counts, W, k, kinds, xfer, c_slice)),
        "alloc_us": host_us(lambda: torch.empty(nbytes, dtype=torch.uint8,
                                                device=dev)),
        "launch_us": host_us(lambda: pane_emit_mod._launch(
            values, counts, spec, first_bin, lo, hi, W, k, c_slice, buf)),
        "wrapper_us": host_us(lambda: pane_emit(*args)),
        "library_us": host_us(library)}


def k3_case(rng, dev, kinds, xfer, C, B, W, k, c_slice, cdt, geometry,
            shape, parent=None):
    """K3 on one fire: ``geometry`` (first_bin, lo, hi) as fire_panes
    passes it.  Exact against the plain version (f64 sums rtol 1e-12),
    one launch, one allocation and no host sync a call; timed in turns
    with its library call where one exists and, with ``parent``, with the
    parent commit's kernel."""
    values, counts = bin_planes(rng, dev, kinds, C, B, cdt)
    first_bin, lo, hi = geometry
    args = (values, counts, first_bin, lo, hi, W, k, kinds, xfer, c_slice)
    before = pane_emit.launches
    got = pane_views(pane_emit(*args), len(xfer), c_slice, k, cdt)
    launches = pane_emit.launches - before
    want = pane_emit_reference(*args)
    torch.cuda.synchronize()
    check(launches == 1, f"pane_emit made {launches} launches ({shape})")
    check(torch.equal(got[1], want[1]), f"pane_emit counts differ ({shape})")
    err = 0.0
    for r, j in enumerate(xfer):
        if kinds[j] in ("min", "max"):
            check(torch.equal(got[0][r], want[0][r]),
                  f"pane_emit channel {j} ({kinds[j]}) not exact ({shape})")
        else:  # f64 sums over W bins: rtol 1e-12 (summation order)
            torch.testing.assert_close(got[0][r], want[0][r], rtol=1e-12,
                                       atol=1e-9)
            err = max(err, float((got[0][r] - want[0][r]).abs().max()))
    ring_np, ok_np = fire_geometry(first_bin, lo, hi, W, k, B)
    live = np.unique(ring_np[ok_np])

    def kernel():
        return pane_emit(*args)

    library, library_call = None, None
    planes = [counts[:c_slice]] + [values[j, :c_slice] for j in xfer]
    cols = torch.tensor(live, device=dev)
    if W == 1:  # one index_select per plane reads the pane's one column
        def library():
            return [p.index_select(1, cols) for p in planes]
        library_call = "index_select per plane"
    elif k == 1 and not xfer:  # the pane's W columns of counts, summed
        def library():
            return counts[:c_slice].index_select(1, cols).sum(1)
        library_call = "counts[:c_slice].index_select(1, cols).sum(1)"
    if library is not None:
        ms, lib, turns = in_turns(kernel, library)
    else:
        ms, lib, turns = cuda_ms(kernel), None, None
    plain = cuda_ms(lambda: pane_emit_reference(*args))
    meas = measured(kernel, "pane_emit")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"pane_emit made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    item = counts.element_size()
    n_read = (row_sectors(item, B, live)
              + len(xfer) * row_sectors(8, B, live)) * SECTOR * c_slice
    n_write = (run_sectors(8 * len(xfer) * c_slice * k)
               + run_sectors(item * c_slice * k))
    ops = c_slice * int(ok_np.sum()) * (1 + len(xfer))
    r = row("pane_emit", K3_SOURCE, K3_REPLACES, shape, err, ms, plain,
            n_read + n_write, ops, lib, library_call)
    atoms = c_slice * (row_atoms(item, B, live)
                       + len(xfer) * row_atoms(8, B, live))
    r.update(turns_ms=turns, launches_per_call=launches,
             bound_bytes=n_read + n_write,
             atom_bound_ms=atom_bound_ms(atoms, 0, n_write), **meas)
    if library is not None:
        r["library_device_us"] = profile_kernels(library)
        r["library_turns"] = turn_factors(turns)
    if W == 1:
        r["host_split"] = pane_emit_split(args, library)
    if parent is not None:  # the same kernel: the A/A noise of a turn
        pe = parent.pane_emit
        p_out = pane_views(pe(*args), len(xfer), c_slice, k, cdt)
        torch.cuda.synchronize()
        check(torch.equal(p_out[1], got[1]) and torch.equal(p_out[0], got[0]),
              f"pane_emit differs from the parent's ({shape})")
        c_ms, p_ms, p_turns = in_turns(kernel, lambda: pe(*args))
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       **measured(lambda: pe(*args), "pane_emit")}
    print(f"pane_emit {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms", "bound_bytes",
                                 "atom_bound_ms", "library_device_us",
                                 "host_us_per_call", "device_us_per_call",
                                 "device_us_cold", "allocations_per_call",
                                 "syncs_per_call", "host_split", "parent")
                  if key in r}))
    return r


def ring_library(values, counts, span, W, k, kinds, xfer, rows):
    """The PyTorch composition of ring_emit's function: per plane an index
    gather of the span's ring columns (dead positions then set to the
    identity), a ``torch.cumsum`` difference for the additive planes and
    the counts, ``F.max_pool1d`` for MAX (for MIN on the negation)."""
    cols, ok = span
    outs = []
    for j in xfer:
        g = values[j, :rows].index_select(1, cols)
        if ok is not None:
            g = torch.where(ok, g, channel_identity(kinds[j]))
        if kinds[j] == "max":
            outs.append(F.max_pool1d(g.unsqueeze(1), W, 1).squeeze(1))
        elif kinds[j] == "min":
            outs.append(-F.max_pool1d(-g.unsqueeze(1), W, 1).squeeze(1))
        else:
            c = torch.cumsum(g, 1)
            outs.append(c[:, W - 1:] - F.pad(c[:, :k - 1], (1, 0)))
    g = counts[:rows].index_select(1, cols)
    if ok is not None:
        g = torch.where(ok, g, 0)
    c = torch.cumsum(g, 1)
    return outs, c[:, W - 1:] - F.pad(c[:, :k - 1], (1, 0))


def ring_planes(dev, kinds, C, B, cdt):
    """Bin-ring planes made on the card (a seeded generator): integer
    prices in 3 of 4 cells, identities elsewhere; counts Poisson(2)."""
    gen = torch.Generator(device=dev).manual_seed(C + B)
    values = torch.empty((len(kinds), C, B), dtype=torch.float64, device=dev)
    for j, kind in enumerate(kinds):
        torch.randint(100, 100_000, (C, B), generator=gen, device=dev,
                      dtype=torch.float64, out=values[j])
        dead = torch.rand((C, B), generator=gen, device=dev) < 0.25
        values[j].masked_fill_(dead, channel_identity(kind))
    counts = torch.poisson(torch.full((C, B), 2.0, device=dev),
                           generator=gen).to(cdt)
    return values, counts


def k16_case(dev, C, B, rows, geometry, cdt, shape, parent=None):
    """K16 on one fire: ``geometry`` (first_bin, lo, hi, W, k) as
    fire_panes passes it.  Exact against the plain version and the
    library composition (integer-valued planes), one launch (one on the
    device), one allocation and no host sync a call; timed in turns with
    the library composition and, with ``parent``, with the parent
    commit's kernel; device µs warm and cold."""
    values, counts = ring_planes(dev, HOP_KINDS, C, B, cdt)
    first_bin, lo, hi, W, k = geometry
    args = (values, counts, first_bin, lo, hi, W, k, HOP_KINDS, HOP_XFER,
            rows)
    before = ring_emit.launches
    got = pane_views(ring_emit(*args), len(HOP_XFER), rows, k, cdt)
    launches = ring_emit.launches - before
    want = ring_emit_reference(*args)
    L = k + W - 1
    bins = first_bin + torch.arange(L, device=dev)
    ok = (bins >= lo) & (bins <= hi)
    span = (bins % B, None if bool(ok.all()) else ok)
    lib = ring_library(values, counts, span, W, k, HOP_KINDS, HOP_XFER,
                       rows)
    torch.cuda.synchronize()
    check(launches == 1, f"ring_emit made {launches} launches ({shape})")
    check(torch.equal(got[1], want[1]) and torch.equal(got[1], lib[1].to(
        cdt)), f"ring_emit counts differ ({shape})")
    for r in range(len(HOP_XFER)):
        check(torch.equal(got[0][r], want[0][r])
              and torch.equal(got[0][r], lib[0][r]),
              f"ring_emit channel {HOP_XFER[r]} ({HOP_KINDS[HOP_XFER[r]]}) "
              f"differs ({shape})")

    def kernel():
        return ring_emit(*args)

    def library():
        return ring_library(values, counts, span, W, k, HOP_KINDS, HOP_XFER,
                            rows)

    ms, lib_ms, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: ring_emit_reference(*args), reps=5, warm=1)
    meas = measured(kernel, "ring_emit")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"ring_emit made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    check(len(meas["device_us_per_call"]) == 1,
          f"ring_emit made {len(meas['device_us_per_call'])} device "
          f"launches ({shape}); 0: torch.profiler recorded no device "
          "activity")
    live = int(ok.sum())
    item = counts.element_size()
    n_read = rows * (len(HOP_XFER) * run_sectors(8 * live)
                     + run_sectors(item * live))
    n_write = (run_sectors(8 * len(HOP_XFER) * rows * k)
               + run_sectors(item * rows * k))
    ops = rows * L * (1 + len(HOP_XFER))
    r = row("ring_emit", K16_SOURCE, K16_REPLACES, shape, 0.0, ms, plain,
            n_read + n_write, ops, lib_ms, "index_select + torch.where + "
            "cumsum difference a sum plane, max_pool1d a max plane")
    r.update(turns_ms=turns, launches_per_call=launches,
             bound_bytes=n_read + n_write, live_positions=live,
             library_device_us=profile_kernels(library),
             library_turns=turn_factors(turns), **meas)
    if parent is not None:
        r["parent"] = ring_emit_parent(args, kernel, parent, shape)
    print(f"ring_emit {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "plain_ms", "turns_ms",
                                 "library_turns", "bound_ms", "bound_bytes",
                                 "live_positions", "library_device_us",
                                 "host_us_per_call", "device_us_per_call",
                                 "device_us_cold", "allocations_per_call",
                                 "syncs_per_call", "parent")
         if key in r}))
    return r


def ring_emit_parent(args, kernel, parent, shape):
    """The parent commit's ring_emit on the same fire: bit-equal (the
    same association), timed in turns with this tree's, device µs warm
    and cold."""
    pr = parent.ring_emit
    check(torch.equal(pr(*args), kernel()),
          f"ring_emit differs from the parent's ({shape})")
    c_ms, p_ms, p_turns = in_turns(kernel, lambda: pr(*args))
    p_meas = measured(lambda: pr(*args), "ring_emit")
    return {"ms": p_ms, "kernel_ms_beside_it": c_ms, "turns_ms": p_turns,
            "turns": turn_factors(p_turns),
            "device_us_per_call": p_meas["device_us_per_call"],
            "device_us_cold": p_meas["device_us_cold"],
            "host_us_per_call": p_meas["host_us_per_call"]}


def edge_planes(rng, dev, kinds, C, B, cdt, signed=False):
    """Bin-ring planes for ring_emit's edge fires: integer values in 3 of
    4 cells, each channel's identity elsewhere; with ``signed``, the
    MIN/MAX channels hold +/-0.0, +/-inf, +/-1 and 1% NaN."""
    values = np.empty((len(kinds), C, B))
    for j, kind in enumerate(kinds):
        if signed and kind in ("min", "max"):
            values[j] = rng.choice([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf],
                                   (C, B))
            values[j][rng.random((C, B)) < 0.01] = np.nan
        else:
            values[j] = rng.integers(-1_000, 100_000, (C, B))
        values[j][rng.random((C, B)) < 0.25] = channel_identity(kind)
    counts = rng.poisson(2.0, (C, B))
    return (torch.tensor(values, device=dev),
            torch.tensor(counts, dtype=cdt, device=dev))


# ring_emit's edge fires: (what, kinds, xfer, C, B, rows, (first_bin, lo,
# hi, W, k), signed values); rows of 10,004 as phase 19's median fire
EDGE_MIXED = ("count", "sum", "min", "max", "sum")
K16_EDGES = (
    ("span wrapping the ring, dead at both ends", HOP_KINDS, HOP_XFER,
     C_HOP, B_HOP, HOP_ROWS, (1_024 * 5 + 900, 1_024 * 5 + 905,
                              1_024 * 5 + 900 + 352, HOP_W, 64), False),
    ("W=37 k=5", HOP_KINDS, HOP_XFER, C_HOP, B_HOP, HOP_ROWS,
     (1_024 * 3 + 20, 1_024 * 3 + 22, 1_024 * 3 + 58, 37, 5), False),
    ("NaN and +/-0.0 MIN/MAX, W=33 k=70", EDGE_MIXED, (1, 2, 3, 4), C_HOP,
     B_HOP, HOP_ROWS, (1_024 * 2 + 1_000, 1_024 * 2 + 1_003,
                       1_024 * 2 + 1_000 + 100, 33, 70), True),
    # phase 19's q5 on the ring: its one fire, COUNT(*) alone
    ("q5's ring fire", ("count",), (), C_Q5, B_Q5, Q5_RING_ROWS,
     (-4, 0, 0, 5, 5), False),
)


def k16_edges(rng, dev, parent=None):
    """K16 at its edge fires (K16_EDGES): exact against the plain version
    (counts and integer sums; MIN/MAX bit for bit, NaN and signed zeros
    included), one launch (one on the device), one allocation and no
    host sync a call; timed beside its plain version and, with
    ``parent``, in turns with the parent commit's kernel."""
    rows = []
    for what, kinds, xfer, C, B, n_rows, geometry, signed in K16_EDGES:
        values, counts = edge_planes(rng, dev, kinds, C, B, torch.int32,
                                     signed)
        first_bin, lo, hi, W, k = geometry
        shape = (f"{what} C={C} B={B} W={W} k={k} rows={n_rows} "
                 f"first_bin={first_bin} lo={lo} hi={hi} int32")
        args = (values, counts, first_bin, lo, hi, W, k, kinds, xfer,
                n_rows)
        before = ring_emit.launches
        got = pane_views(ring_emit(*args), len(xfer), n_rows, k,
                         torch.int32)
        launches = ring_emit.launches - before
        want = ring_emit_reference(*args)
        torch.cuda.synchronize()
        check(launches == 1, f"ring_emit made {launches} launches ({shape})")
        check(torch.equal(got[1], want[1]),
              f"ring_emit counts differ ({shape})")
        for r, j in enumerate(xfer):
            a, b = got[0][r], want[0][r]
            if kinds[j] in ("min", "max"):  # bit for bit: NaN, signed zeros
                a, b = a.view(torch.int64), b.view(torch.int64)
            check(torch.equal(a, b),
                  f"ring_emit channel {j} ({kinds[j]}) differs ({shape})")

        def kernel(args=args):
            return ring_emit(*args)

        ms = cuda_ms(kernel)
        plain = cuda_ms(lambda: ring_emit_reference(*args), reps=5, warm=1)
        meas = measured(kernel, "ring_emit")
        check(meas["allocations_per_call"] == 1
              and meas["syncs_per_call"] == 0
              and len(meas["device_us_per_call"]) == 1,
              f"ring_emit made {meas['allocations_per_call']} allocations, "
              f"{meas['syncs_per_call']} host syncs and "
              f"{len(meas['device_us_per_call'])} device launches ({shape})")
        L = k + W - 1
        live = max(0, min(hi - first_bin, L - 1) - max(lo - first_bin, 0) + 1)
        nbytes = n_rows * (len(xfer) * run_sectors(8 * live)
                           + run_sectors(4 * live)) \
            + run_sectors(8 * len(xfer) * n_rows * k) \
            + run_sectors(4 * n_rows * k)
        r = row("ring_emit", K16_SOURCE, K16_REPLACES, shape, 0.0, ms, plain,
                nbytes, n_rows * L * (1 + len(xfer)), None, None)
        r.update(launches_per_call=launches, bound_bytes=nbytes,
                 live_positions=live, **meas)
        if parent is not None:
            r["parent"] = ring_emit_parent(args, kernel, parent, shape)
        print(f"ring_emit {shape}: " + json.dumps(
            {key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                     "device_us_per_call", "device_us_cold",
                                     "host_us_per_call", "parent")
             if key in r}))
        rows.append(r)
        del values, counts
    return rows


def k4_case(rng, dev, kinds, C, B, first_bin, n_bins, rows, cdt, shape,
            parent=None):
    """K4 on one eviction of the bins first_bin .. first_bin + n_bins - 1
    over the first ``rows`` slots: exact against the plain version, the
    rows past ``rows`` untouched, one launch, no allocation and no host
    sync a call; timed in turns with ``index_fill_`` per plane over the
    same rows and, with ``parent``, with the parent commit's kernel."""
    values, counts = bin_planes(rng, dev, kinds, C, B, cdt)
    tail_v, tail_c = values[:, rows:].clone(), counts[rows:].clone()
    v_r, c_r = values.clone(), counts.clone()
    before = bin_evict.launches
    bin_evict(values, counts, first_bin, n_bins, rows, kinds)
    launches = bin_evict.launches - before
    bin_evict_reference(v_r, c_r, first_bin, n_bins, rows, kinds)
    torch.cuda.synchronize()
    check(launches == 1, f"bin_evict made {launches} launches ({shape})")
    check(torch.equal(counts, c_r) and torch.equal(values, v_r),
          f"bin_evict differs ({shape})")
    check(torch.equal(values[:, rows:], tail_v)
          and torch.equal(counts[rows:], tail_c),
          f"bin_evict wrote past its {rows} rows ({shape})")
    del v_r, c_r, tail_v, tail_c
    cols = sorted({(first_bin + i) % B for i in range(min(n_bins, B))})
    col64 = torch.tensor(cols, device=dev)

    def kernel():
        bin_evict(values, counts, first_bin, n_bins, rows, kinds)

    def library():  # one index_fill_ per plane, over the same rows
        counts[:rows].index_fill_(1, col64, 0)
        for j, kind in enumerate(kinds):
            values[j, :rows].index_fill_(1, col64, channel_identity(kind))

    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: bin_evict_reference(values, counts, first_bin,
                                                n_bins, rows, kinds))
    meas = measured(kernel, "bin_evict")
    check(meas["allocations_per_call"] == 0 and meas["syncs_per_call"] == 0,
          f"bin_evict made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    # stores only; a sector partly written counts as one 32-byte sector
    nbytes = rows * SECTOR * (row_sectors(counts.element_size(), B, cols)
                              + len(kinds) * row_sectors(8, B, cols))
    r = row("bin_evict", K4_SOURCE, K4_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "index_fill_ per plane")
    atoms = rows * (row_atoms(counts.element_size(), B, cols)
                    + len(kinds) * row_atoms(8, B, cols))
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches, bound_bytes=nbytes,
             atom_bound_ms=atom_bound_ms(0, atoms, 0),
             library_device_us=profile_kernels(library), **meas)
    if parent is not None:  # the same kernel: the A/A noise of a turn
        be = parent.bin_evict
        p_v, p_c = values.clone(), counts.clone()
        be(p_v, p_c, first_bin, n_bins, rows, kinds)
        torch.cuda.synchronize()
        check(torch.equal(p_v, values) and torch.equal(p_c, counts),
              f"bin_evict differs from the parent's ({shape})")
        del p_v, p_c

        def parent_call():
            be(values, counts, first_bin, n_bins, rows, kinds)

        c_ms, p_ms, p_turns = in_turns(kernel, parent_call)
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       **measured(parent_call, "bin_evict")}
    print(f"bin_evict {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms", "bound_bytes",
                                 "atom_bound_ms", "library_device_us",
                                 "host_us_per_call", "device_us_per_call",
                                 "device_us_cold", "allocations_per_call",
                                 "syncs_per_call", "parent") if key in r}))
    return r


def ring_keys(rng, n):
    """n distinct sorted u64 join-key hashes whose top 32 bits stay off
    the ring's sentinel."""
    keys = np.unique(rng.integers(0, 2**63, n + n // 8 + 8, dtype=np.uint64))
    return np.sort(rng.choice(keys, n, replace=False))


def ring_columns(rng, nf, ni, n):
    """Payload columns that ride a ring as nf f64 rows and ni i64 rows
    (i-stack row 0 is the event time), or None for a keys-only ring."""
    if not (nf or ni):
        return None
    cols = {f"f{k}": rng.normal(size=n) for k in range(nf)}
    cols.update({f"i{k}": rng.integers(-2**62, 2**62, n)
                 for k in range(1, ni)})
    return cols


def k5_case(rng, dev, cap, n_res, m, nf, ni, shape, parent=None):
    """K5 on one merge as the join state makes it: a resident run of
    ``n_res`` entries and a delta of ``m`` at insert positions spread
    over the run.  Bit-equal to the plain version, one launch, the planes
    views of one buffer, 1 allocation and 0 host syncs a call; timed in
    turns with ``index_copy_`` per plane (given the residents' positions,
    which the kernel does not take) and, with ``parent``, with the
    parent commit's kernel on the same arguments, and the caller
    ``ops/join.merge_ring`` with the parent's."""
    dpos = np.sort(rng.choice(n_res + m, m, replace=False))
    keep = np.ones(n_res + m, dtype=bool)
    keep[dpos] = False
    rpos = np.nonzero(keep)[0]
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    i32 = lambda n: rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)  # noqa: E731
    hi_np, lo_np = i32(cap), i32(cap)
    hi_np[n_res:], lo_np[n_res:] = 0x7FFFFFFF, -1
    d_hi_np, d_lo_np = i32(m), i32(m)
    payload = bool(nf or ni)
    st = ((rng.normal(size=(nf, cap)), rng.integers(-2**62, 2**62, (ni, cap)),
           rng.normal(size=(nf, m)), rng.integers(-2**62, 2**62, (ni, m)))
          if payload else None)
    stacks = tuple(t(x) for x in st) if payload else (None,) * 4
    dp = t(dpos.astype(np.int64))
    args = (t(hi_np), t(lo_np), stacks[0], stacks[1], n_res, t(d_hi_np),
            t(d_lo_np), stacks[2], stacks[3], dp)
    before = ring_merge.launches
    got = ring_merge(*args)
    launches = ring_merge.launches - before
    want = ring_merge_reference(*args)
    torch.cuda.synchronize()
    check(launches == 1, f"ring_merge made {launches} launches ({shape})")
    for g, w in zip(got, want):
        check((g is None and w is None) or torch.equal(g, w),
              f"ring_merge differs ({shape})")
    check(len({g.untyped_storage().data_ptr() for g in got
               if g is not None}) == 1,
          "ring_merge's planes are not views of one buffer")

    def kernel():
        return ring_merge(*args)

    rp = t(rpos)
    outs = [g.clone() for g in got if g is not None]
    srcs = [(args[0], args[5]), (args[1], args[6])]
    if payload:
        srcs += [(args[2], args[7]), (args[3], args[8])]

    def library():  # index_copy_ per plane: resident, then delta
        for out, (res, delta) in zip(outs, srcs):
            dim = out.dim() - 1
            out.index_copy_(dim, rp, res[..., :n_res])
            out.index_copy_(dim, dp, delta)

    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: ring_merge_reference(*args))
    meas = measured(kernel, "merge_kernel")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"ring_merge made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    width = 8 + 8 * (nf + ni)  # hi + lo + one 8-byte word per stack row
    nbytes = n_res * width + m * (width + 8) + cap * width
    r = row("ring_merge", K5_SOURCE, K5_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "index_copy_ per plane, resident then delta")
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches, bound_bytes=nbytes,
             library_device_us=profile_kernels(library), **meas)
    if parent is not None:
        pm = parent.ring_merge
        p_out = pm(*args)
        torch.cuda.synchronize()
        check(all((g is None and w is None) or torch.equal(g, w)
                  for g, w in zip(p_out, got)),
              f"ring_merge differs from the parent's ({shape})")
        c_ms, p_ms, p_turns = in_turns(kernel, lambda: pm(*args))
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       **measured(lambda: pm(*args), "_kernel"),
                       "caller": merge_callers(rng, dev, cap, n_res, m, nf,
                                               ni, dpos, rpos, parent,
                                               shape)}
    print(f"ring_merge {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms",
                                 "library_device_us", "host_us_per_call",
                                 "device_us_per_call", "device_us_cold",
                                 "allocations_per_call", "syncs_per_call",
                                 "parent") if key in r}))
    return r


def merge_callers(rng, dev, cap, n_res, m, nf, ni, dpos, rpos, parent,
                  shape):
    """``ops/join.merge_ring`` (the delta and its positions in one upload
    from pinned memory, one launch) against the parent's on rings staged
    from the same sorted keys: equal planes, then in turns, with
    allocations and host syncs a call."""
    keys = ring_keys(rng, n_res + m)
    cols = ring_columns(rng, nf, ni, n_res + m)
    ts = rng.integers(0, 2**50, n_res + m)
    part = lambda ix: (None if cols is None else  # noqa: E731
                       {c: v[ix] for c, v in cols.items()})
    pj, pp = join_ops, parent.join
    rings = [mod.stage_ring(keys[rpos], dev, sorted_ts=ts[rpos],
                            sorted_cols=part(rpos)) for mod in (pj, pp)]
    check(rings[0].cap == rings[1].cap == cap,
          f"staged rings of {rings[0].cap} / {rings[1].cap}, not {cap}")

    def merge():
        return pj.merge_ring(rings[0], n_res, keys[dpos], dpos,
                             delta_ts=ts[dpos], delta_cols=part(dpos))

    def parent_merge():
        return pp.merge_ring(rings[1], n_res, keys[dpos], dpos,
                             delta_ts=ts[dpos], delta_cols=part(dpos))

    a, b = merge(), parent_merge()
    torch.cuda.synchronize()
    check(all(torch.equal(getattr(a, k), getattr(b, k)) for k in
              ("hi", "lo") + (("fstack", "istack") if cols else ())),
          f"merge_ring differs from the parent's ({shape})")
    ms, p_ms, turns = in_turns(merge, parent_merge)
    return {"ms": ms, "parent_ms": p_ms, "turns_ms": turns,
            **turn_factors(turns),
            "allocations_syncs": per_call(merge),
            "parent_allocations_syncs": per_call(parent_merge)}


def launch_split(idx, f, i):
    """Where a ring_gather call's time goes: host microseconds of each
    step of the wrapper, the whole wrapper and the bare ctypes call; the
    kernel's device time from torch.profiler; and CUDA-event ms of the
    wrapper and the bare call."""
    m, nf, ni, cap = idx.shape[0], f.shape[0], i.shape[0], f.shape[1]
    dev = idx.device
    fn = ring_gather_mod._c_fn()
    rows = torch.empty((nf + ni, m), dtype=torch.int64, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (idx.data_ptr(), m, f.data_ptr(), i.data_ptr(), nf, ni, cap,
            rows.data_ptr(), stream)

    def bare():
        return fn(*args)

    return {
        "check_us": host_us(lambda: ring_gather_mod._check(idx, f, i)),
        "alloc_us": host_us(lambda: torch.empty(
            (nf + ni, m), dtype=torch.int64, device=dev)),
        "device_and_stream_us": host_us(lambda: (
            torch._C._cuda_getDevice(),
            torch._C._cuda_getCurrentRawStream(dev.index))),
        "ctypes_launch_us": host_us(bare),
        "views_us": host_us(lambda: (rows[:nf].view(torch.float64),
                                     rows[nf:])),
        "wrapper_us": host_us(lambda: ring_gather(idx, f, i)),
        "index_select_pair_us": host_us(
            lambda: (f.index_select(1, idx), i.index_select(1, idx))),
        "device_us": profile_kernels(lambda: ring_gather(idx, f, i)),
        "wrapper_event_ms": cuda_ms(lambda: ring_gather(idx, f, i)),
        "bare_event_ms": cuda_ms(bare),
    }


def k6_case(rng, dev, cap, nf, ni, m, shape):
    f = torch.tensor(rng.normal(size=(nf, cap)), device=dev)
    i = torch.tensor(rng.integers(-2**62, 2**62, (ni, cap)), device=dev)
    idx = torch.tensor(np.sort(rng.integers(0, cap, m)), device=dev)
    before = ring_gather.launches
    got, want = ring_gather(idx, f, i), ring_gather_reference(idx, f, i)
    torch.cuda.synchronize()
    launches = ring_gather.launches - before
    check(launches == 1, f"ring_gather made {launches} launches")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"ring_gather differs ({shape})")
    check(got[0].untyped_storage().data_ptr()
          == got[1].untyped_storage().data_ptr()
          and got[1].data_ptr() == got[0].data_ptr() + nf * m * 8,
          "ring_gather's outputs are not views of one buffer")
    allocs, syncs = per_call(lambda: ring_gather(idx, f, i))
    check(allocs == 1 and syncs == 0,
          f"ring_gather made {allocs} allocations and {syncs} host syncs")
    ms, lib, turns = in_turns(
        lambda: ring_gather(idx, f, i),
        lambda: (f.index_select(1, idx), i.index_select(1, idx)))
    plain = cuda_ms(lambda: ring_gather_reference(idx, f, i))
    split = launch_split(idx, f, i)
    print("ring_gather launch path: " + json.dumps(split))
    nbytes = m * 8 + 2 * m * 8 * (nf + ni)
    r = row("ring_gather", K6_SOURCE, K6_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "index_select per stack")
    r.update(turns_ms=turns, launches_per_call=launches,
             syncs_per_call=syncs, allocations_per_call=allocs,
             launch_split=split)
    return r


def union_rows(rng, n, n_keys, config5=False):
    """Interval rows sorted by (key, start) with u64-hash keys (as int64
    bit views), micros starts, ends a gap past them.  Random keys: a tenth
    of the starts touch their predecessor's end.  ``config5``: the mix of
    config5's merges (n // 1.5 keys, half of them a resident session and
    a delta interval inside it, the rest one interval: 192 rows, 128 keys,
    128 sessions; a CPU run of phase 7's config5 at 200,000 events)."""
    if config5:
        k2 = n - 2 * (n // 3)  # keys with two rows
        keys = np.sort(rng.integers(-2**63, 2**63 - 1, n - k2,
                                    dtype=np.int64))
        kh = np.concatenate([np.repeat(keys[:k2], 2), keys[k2:]])
        st = rng.integers(1_700_000_000_000_000, 1_700_000_100_000_000, n)
        en = st + GAP_MICROS + rng.integers(0, 640, n)
        twin = np.arange(1, 2 * k2, 2)  # the delta: inside the session
        st[twin] = st[twin - 1] + rng.integers(0, GAP_MICROS, k2)
    else:
        keys = rng.integers(-2**63, 2**63 - 1, n_keys, dtype=np.int64)
        kh = np.sort(rng.choice(keys, n))
        st = rng.integers(1_700_000_000_000_000, 1_700_000_100_000_000, n)
        o = np.lexsort((st, kh))
        kh, st = kh[o], st[o]
        en = st + rng.integers(1, 2 * GAP_MICROS, n)
        touch = np.nonzero(rng.random(n - 1) < 0.1)[0] + 1
        st[touch] = en[touch - 1]
    o = np.lexsort((st, kh))
    return kh[o], st[o], en[o]


def union_callers(kh, st, en, dev, parent):
    """``ops/session.union_sorted_intervals`` (the three columns in one
    upload from pinned memory, one launch of the buffer form, one
    readback) against the parent's (three blocking uploads, three
    launches, a readback of the flags, the sessions reduced on the host)
    on the same rows: the same five arrays, then in turns, with
    allocations and host syncs a call."""
    kh = kh.view(np.uint64)

    def union():
        return session_ops.union_sorted_intervals(kh, st, en, dev)

    def parent_union():
        return parent.session.union_sorted_intervals(kh, st, en, dev)

    a, b = union(), parent_union()
    check(all(x.dtype == y.dtype and np.array_equal(x, y)
              for x, y in zip(a, b)),
          "union_sorted_intervals differs from the parent's")
    ms, p_ms, turns = in_turns(union, parent_union)
    return {"ms": ms, "parent_ms": p_ms, "turns_ms": turns,
            **turn_factors(turns),
            "allocations_syncs": per_call(union),
            "parent_allocations_syncs": per_call(parent_union),
            "host_us": host_us(union, reps=500),
            "parent_host_us": host_us(parent_union, reps=500)}


def device_sum(meas):
    """Device microseconds a call, warm and cold, summed over launches."""
    return (sum(meas["device_us_per_call"].values()),
            sum(meas["device_us_cold"].values()))


def k7_case(rng, dev, n, n_keys, shape, parent=None, config5=False):
    """K7 on one union: both forms bit-equal to their plain versions, one
    kernel launch a call (and, above one 1,024-row tile, one zero-fill,
    counted); up to one tile 0 host syncs and at most 2 allocations a
    call.  The buffer form (the caller's) is the row's time and bound
    (24n bytes read, 8 + 16S written); the (new, run_en) form's beside it
    (33n).  With ``parent``: the (new, run_en) form in turns with the
    parent commit's three-launch kernel, whose device time is summed over
    its launches, and at config5's shape the caller
    ``union_sorted_intervals`` in turns with the parent's."""
    kh_np, st_np, en_np = union_rows(rng, n, n_keys, config5)
    kh, st, en = (torch.tensor(a, device=dev) for a in (kh_np, st_np, en_np))
    before = session_union.launches
    got = session_union(kh, st, en)
    flags_launches = session_union.last_launches
    buf = session_union_buffer(kh, st, en)
    buf_launches = session_union.last_launches
    kernels = session_union.launches - before
    want = session_union_reference(kh, st, en)
    want_buf = session_union_buffer_reference(kh, st, en)
    torch.cuda.synchronize()
    check(kernels == 2, f"session_union made {kernels} kernel launches in "
          f"two calls ({shape})")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"session_union differs ({shape})")
    s, first, m_en = union_views(buf, n)
    want_s, want_first, want_en = union_views(want_buf, n)
    check(s == want_s and torch.equal(first, want_first)
          and torch.equal(m_en, want_en),
          f"session_union_buffer differs ({shape})")

    def kernel():  # the call the session union makes: one buffer
        return session_union_buffer(kh, st, en)

    def flags():
        return session_union(kh, st, en)

    ms = cuda_ms(kernel)
    plain = cuda_ms(lambda: session_union_buffer_reference(kh, st, en))
    meas = measured(kernel, "union")
    flags_meas = measured(flags, "union")
    if n <= 1024:
        for form, m_ in (("buffer", meas), ("flags", flags_meas)):
            check(m_["allocations_per_call"] <= 2
                  and m_["syncs_per_call"] == 0,
                  f"session_union {form} form made "
                  f"{m_['allocations_per_call']} allocations and "
                  f"{m_['syncs_per_call']} host syncs ({shape})")
        check(buf_launches == flags_launches == 1,
              f"session_union made {buf_launches} / {flags_launches} "
              f"launches on one tile ({shape})")
    nbytes = 24 * n + 8 + 16 * s
    r = row("session_union", K7_SOURCE, K7_REPLACES,
            shape + f" sessions={s}", 0.0, ms, plain, nbytes, 0, None, None)
    r.update(launches_per_call=buf_launches,
             zero_fills_per_call=buf_launches - 1, bound_bytes=nbytes,
             device_us_sum=device_sum(meas), **meas)
    r["flags_form"] = {"ms": cuda_ms(flags),
                       "plain_ms": cuda_ms(lambda: session_union_reference(
                           kh, st, en)),
                       "bound_ms": bound(33 * n, 0, F64_OPS_PER_S)[0],
                       "launches_per_call": flags_launches,
                       "device_us_sum": device_sum(flags_meas), **flags_meas}
    if parent is not None:
        pu = parent.session_union
        p_out = pu(kh, st, en)
        torch.cuda.synchronize()
        check(torch.equal(p_out[0], got[0]) and torch.equal(p_out[1], got[1]),
              f"session_union differs from the parent's ({shape})")
        c_ms, p_ms, p_turns = in_turns(flags, lambda: pu(kh, st, en))
        p_meas = measured(lambda: pu(kh, st, en), "union")
        r["parent"] = {"ms": p_ms, "flags_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       "device_us_sum": device_sum(p_meas), **p_meas}
        if config5:
            r["parent"]["caller"] = union_callers(kh_np, st_np, en_np, dev,
                                                  parent)
    print(f"session_union {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "bound_ms", "launches_per_call",
                                 "host_us_per_call", "device_us_per_call",
                                 "device_us_cold", "device_us_sum",
                                 "allocations_per_call", "syncs_per_call",
                                 "flags_form", "parent") if key in r}))
    return r


def k8_case(rng, dev, n, n_seg, kinds, shape, parent=None):
    """K8 on one reduce: counts, min and max exact against the plain
    version, sums within rtol 1e-12 of math.fsum and bit-equal across two
    calls, one launch, one allocation and no host sync a call; timed in
    turns with its library call and, with ``parent``, with the parent
    commit's kernel and the parent's reduce as its caller made it (two
    uploads, the kernel, two readbacks) against this one (one upload, the
    kernel, one readback)."""
    cuts = np.sort(rng.choice(np.arange(1, n), n_seg - 1, replace=False))
    offsets_np = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    offsets = torch.tensor(offsets_np, device=dev)
    reduced = [c for c, k in enumerate(kinds) if k != "count"]
    # one value row per channel that is not a count (count reads none)
    values_np = rng.normal(size=(len(reduced), n)) * 1e3
    values = torch.tensor(values_np, device=dev).reshape(len(reduced), n)
    before = segment_agg.launches
    got = segment_agg(values, offsets, kinds)
    launches = segment_agg.launches - before
    again = segment_agg(values, offsets, kinds)
    want = segment_agg_reference(values, offsets, kinds)
    torch.cuda.synchronize()
    check(launches == 1, f"segment_agg made {launches} launches ({shape})")
    check(torch.equal(got[1], want[1]), f"segment_agg counts differ "
          f"({shape})")
    check(torch.equal(got[0], again[0]), f"segment_agg is not bit-equal "
          f"across two calls ({shape})")
    err = 0.0
    for c, k in enumerate(kinds):
        if k == "sum":
            # f64 sums in the kernel's fixed order against the correctly
            # rounded sums (math.fsum): rtol 1e-12, stable from run to
            # run.  The plain version's index_add_ adds in another order
            # on every run (atomics); an order change moves a sum by ulps
            # of the segment's sum of |x|, ~1,000x its |sum| at 2^20
            # zero-mean rows, so against it: 1e-12 of sum |x| + 1e-9
            r = reduced.index(c)
            exact = torch.tensor([math.fsum(values_np[r, a:b]) for a, b in zip(
                offsets_np[:-1], offsets_np[1:])], dtype=torch.float64,
                device=dev)
            torch.testing.assert_close(got[0][c], exact, rtol=1e-12,
                                       atol=1e-9)
            l1 = segment_agg_reference(values[r:r + 1].abs(), offsets,
                                       ("sum",))[0][0]
            diff = (got[0][c] - want[0][c]).abs()
            check(bool((diff <= 1e-9 + 1e-12 * l1).all()),
                  f"segment_agg channel {c} (sum) differs by "
                  f"{float(diff.max())} ({shape})")
            err = max(err, float(diff.max()))
        else:
            check(torch.equal(got[0][c], want[0][c]),
                  f"segment_agg channel {c} ({k}) not exact ({shape})")

    def kernel():  # the call the segment reduce makes: one buffer
        return segment_agg_buffer(values, offsets, kinds)

    check(torch.equal(kernel()[0], got[1]) and torch.equal(
        kernel()[1:].view(torch.float64), got[0]),
        f"segment_agg_buffer differs from segment_agg ({shape})")
    if not reduced:  # every channel counts rows: the lengths, as f64
        def library():
            return torch.diff(offsets).double()
        library_call = "torch.diff(offsets).double()"
    else:
        lengths = offsets[1:] - offsets[:-1]

        def library():
            return [torch.segment_reduce(values[r], kinds[c], lengths=lengths)
                    for r, c in enumerate(reduced)]
        library_call = "segment_reduce per sum/min/max channel"
    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: segment_agg_reference(values, offsets, kinds))
    meas = measured(kernel, "segment_")
    public = per_call(lambda: segment_agg(values, offsets, kinds))
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0
          and public == (1, 0),
          f"segment_agg made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs, the (out, counts) form "
          f"{public} ({shape})")
    meas["tuple_form_host_us"] = host_us(
        lambda: segment_agg(values, offsets, kinds), reps=200)
    nbytes = (len(reduced) * n * 8 + offsets_np.nbytes
              + len(kinds) * n_seg * 8 + n_seg * 8)
    r = row("segment_agg", K8_SOURCE, K8_REPLACES, shape, err, ms, plain,
            nbytes, len(reduced) * n, lib, library_call)
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches,
             library_device_us=profile_kernels(library), **meas)
    if parent is not None:
        pa = parent.segment_agg
        p_out = pa(values, offsets, kinds)
        torch.cuda.synchronize()
        check(torch.equal(p_out[1], got[1]) and all(
            torch.equal(p_out[0][c], got[0][c]) for c, k in enumerate(kinds)
            if k != "sum"), f"segment_agg differs from the parent's ({shape})")
        c_ms, p_ms, p_turns = in_turns(kernel, lambda: pa(values, offsets,
                                                          kinds))
        rows_np = [values_np[i] for i in range(len(reduced))]
        seg_start = offsets_np[:-1]

        def parent_reduce():  # the parent's ops/segment._reduce
            vals = np.empty((len(rows_np), n), dtype=np.float64)
            for i, row_np in enumerate(rows_np):
                vals[i] = row_np
            offs = np.append(seg_start, n).astype(np.int64)
            o, c = pa(torch.tensor(vals, device=dev),
                      torch.tensor(offs, device=dev), tuple(kinds))
            return o.cpu().numpy(), c.cpu().numpy()

        def reduce():  # this ops/segment._reduce
            return segment_reduce(list(kinds), rows_np, seg_start, n, dev)

        red_ms, p_red_ms, red_turns = in_turns(reduce, parent_reduce)
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       "reduce_ms": p_red_ms, "change_reduce_ms": red_ms,
                       "reduce_turns_ms": red_turns,
                       "reduce_factors": turn_factors(red_turns),
                       **measured(lambda: pa(values, offsets, kinds),
                                  "segment_agg")}
    print(f"segment_agg {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms",
                                 "library_device_us", "host_us_per_call",
                                 "device_us_per_call", "device_us_cold",
                                 "allocations_per_call", "syncs_per_call",
                                 "tuple_form_host_us", "parent")
                  if key in r}))
    return r


def empty_segments(dev):
    """segment_agg over segments with no row, on the card: count 0, SUM 0,
    MIN +inf and MAX -inf (XLA's segment_min/segment_max of no rows, as
    the JAX kernel gives them), the other segments their rows'."""
    kinds = ("min", "max", "sum", "count")
    offsets = torch.tensor([0, 0, 3, 3, 5, 5], device=dev)
    values = torch.arange(15, dtype=torch.float64, device=dev).reshape(3, 5)
    out, counts = segment_agg(values, offsets, kinds)
    want = segment_agg_reference(values, offsets, kinds)
    torch.cuda.synchronize()
    inf = float("inf")
    check(counts.tolist() == [0, 3, 0, 2, 0]
          and out[:, 0].tolist() == out[:, 2].tolist() == out[:, 4].tolist()
          == [inf, -inf, 0.0, 0.0]
          and out[:, 1].tolist() == [0.0, 7.0, 33.0, 3.0]
          and torch.equal(out, want[0]),
          f"segment_agg over empty segments: {out.tolist()}")


def join_cases(rng, dev, cap, n_valid, mq, m, span, ni, shape,
               parent=None, callers=False, hit_caller=False):
    """K9-K11 on one ring probe: a sorted ring of ``n_valid`` keys drawn
    from ``span`` values (repeats), sorted queries from the same values
    (a fifth of them absent), a third sharing a ring row's lo.  With
    ``callers`` (and ``parent``) the join's probe path with its fused
    emission is timed too, with ``hit_caller`` its keys-only probe path."""
    sent = 0x7FFFFFFF
    hi_np = np.full(cap, sent, np.int32)
    hi_np[:n_valid] = np.sort(rng.integers(0, span, n_valid) * 2)
    lo_np = rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)
    q_np = np.full(mq, sent, np.int32)
    miss = (rng.random(m) < 0.2) & (span > 1)
    q_np[:m] = np.sort(rng.integers(0, span, m) * 2 + miss)
    ql_np = rng.integers(-2**31, 2**31 - 1, mq).astype(np.int32)
    pick = np.minimum(np.searchsorted(hi_np[:n_valid], q_np), n_valid - 1)
    own = rng.random(mq) < 0.33
    ql_np[own] = lo_np[pick[own]]
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    hi, lo, q_hi, q_lo = t(hi_np), t(lo_np), t(q_np), t(ql_np)
    ist = t(rng.integers(-2**62, 2**62, (ni, cap)))
    fst = torch.zeros((0, cap), dtype=torch.float64, device=dev)
    want = join_probe_reference(q_hi, hi, m, n_valid)
    start, counts, cum = want
    total = int(cum[-1])
    check(total > 0, f"join case has no candidate pair ({shape})")
    n_q = int(torch.unique(q_hi).numel())  # distinct searched values
    shape = f"{shape} total={total}"
    rows = [k9_case(q_hi, hi, m, n_valid, want, shape,
                    4 * mq + searched(4 * cap, cap, 2 * n_q) + 16 * mq,
                    parent)]
    eg_args = (start, cum, total, hi, lo, q_hi, q_lo, fst, ist)
    want = expand_gather_reference(*eg_args)
    distinct = int(torch.unique(want[1]).numel())
    used = int(torch.unique(want[0]).numel())  # queries with a pair
    c64 = counts.long()

    def lib_expand():
        lidx = torch.repeat_interleave(c64, output_size=total)
        j = torch.arange(total, device=dev)
        return lidx, start[lidx] + j - (cum - c64)[lidx]

    def lib_gather():
        lidx, ridx = lib_expand()
        ridx = ridx.clamp(0, cap - 1)
        ok = (hi[ridx] == q_hi[lidx]) & (lo[ridx] == q_lo[lidx])
        return ok, fst.index_select(1, ridx), ist.index_select(1, ridx)

    rows.append(k10_case(start, cum, total, lib_expand, shape,
                         4 * used + searched(8 * mq, mq, used) + 16 * total,
                         parent))
    rows.append(k11_case(eg_args, want, lib_gather, shape,
                         12 * used + searched(8 * mq, mq, used)
                         + distinct * (8 + 8 * ni) + total * (17 + 8 * ni),
                         parent))
    if callers and parent is not None:
        rows[0]["parent"]["caller"] = probe_callers(
            hi_np, lo_np, q_np, ql_np, n_valid, m, ni, ist, dev, parent,
            shape)
        print(f"probe callers {shape}: "
              + json.dumps(rows[0]["parent"]["caller"]))
    if hit_caller and parent is not None:
        rows[1]["parent"]["caller"] = probe_callers(
            hi_np, lo_np, q_np, ql_np, n_valid, m, ni, ist, dev, parent,
            shape, "expand_hit")
        print(f"keys-only probe callers {shape}: "
              + json.dumps(rows[1]["parent"]["caller"]))
    return rows


def k10_case(start, cum, total, library, shape, nbytes, parent=None):
    """K10 on one probe's keys-only expansion, in the buffer form the
    join's ``expand_hit`` launches (here at capacity = the total): bit-
    equal to the plain version, the total in its header, one launch, one
    allocation and no host sync a call; timed in turns with
    ``repeat_interleave`` + ``arange`` and, with ``parent``, with the
    parent commit's kernel."""
    want = join_expand_reference(start, cum, total)
    before = join_expand.launches
    buf = join_expand_buffer(start, cum, total)
    launches = join_expand.launches - before
    torch.cuda.synchronize()
    check(launches == 1, f"join_expand made {launches} launches ({shape})")
    check(int(buf[0]) == total and all(
        torch.equal(g, w) for g, w in zip(pair_views(buf, total), want)),
        f"join_expand_buffer differs ({shape})")
    check(all(torch.equal(g, w) for g, w in zip(
        join_expand(start, cum, total), want)), f"join_expand differs "
        f"({shape})")

    def kernel():  # the call the join makes: one buffer
        return join_expand_buffer(start, cum, total)

    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: join_expand_reference(start, cum, total))
    meas = measured(kernel, "join_expand")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"join_expand made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    r = row("join_expand", K10_SOURCE, K10_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "repeat_interleave + arange")
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches, bound_bytes=nbytes,
             library_device_us=profile_kernels(library), **meas)
    if parent is not None:
        pe = parent.join_expand_buffer
        check(torch.equal(pe(start, cum, total), buf),
              f"join_expand differs from the parent's ({shape})")
        c_ms, p_ms, p_turns = in_turns(kernel, lambda: pe(start, cum, total))
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       **measured(lambda: pe(start, cum, total),
                                  "join_expand")}
    print(f"join_expand {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms", "bound_bytes",
                                 "library_device_us", "host_us_per_call",
                                 "device_us_per_call", "device_us_cold",
                                 "allocations_per_call", "syncs_per_call",
                                 "parent") if key in r}))
    return r


def k9_case(q_hi, hi, m, n_valid, want, shape, nbytes, parent=None):
    """K9 on one probe: its three outputs bit-equal to the plain version
    as views of one buffer, 1 allocation and 0 host syncs a call; timed
    in turns with ``searchsorted`` x2 + ``cumsum`` and, with ``parent``,
    with the parent commit's kernel."""
    before = join_probe.launches
    got = join_probe(q_hi, hi, m, n_valid)
    launches = join_probe.launches - before
    torch.cuda.synchronize()
    check(launches == 1, f"join_probe made {launches} launches ({shape})")
    check(all(g.dtype == w.dtype and torch.equal(g, w)
              for g, w in zip(got, want)), f"join_probe differs ({shape})")
    check(len({g.untyped_storage().data_ptr() for g in got}) == 1,
          "join_probe's outputs are not views of one buffer")

    def kernel():
        return join_probe(q_hi, hi, m, n_valid)

    def library():
        s_ = torch.searchsorted(hi, q_hi)
        e_ = torch.searchsorted(hi, q_hi, right=True)
        return torch.cumsum(e_ - s_, 0)

    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: join_probe_reference(q_hi, hi, m, n_valid))
    meas = measured(kernel, "probe_tile")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"join_probe made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    r = row("join_probe", K9_SOURCE, K9_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "searchsorted x2 + cumsum")
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches, bound_bytes=nbytes,
             library_device_us=profile_kernels(library), **meas)
    if parent is not None:
        pp = parent.join_probe
        check(all(torch.equal(g, w) for g, w in zip(
            pp(q_hi, hi, m, n_valid), got)),
            f"join_probe differs from the parent's ({shape})")
        c_ms, p_ms, p_turns = in_turns(kernel,
                                       lambda: pp(q_hi, hi, m, n_valid))
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       **measured(lambda: pp(q_hi, hi, m, n_valid),
                                  "probe_tile")}
    print(f"join_probe {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms",
                                 "library_device_us", "host_us_per_call",
                                 "device_us_per_call", "device_us_cold",
                                 "allocations_per_call", "syncs_per_call",
                                 "parent") if key in r}))
    return r


SENTINEL64 = np.uint64(0xFFFFFFFFFFFFFFFF)
# the legacy join's buckets: a q8 fire at Q8_EVENTS pads ~200,000 persons
# to 262,144 and up to ~600,000 sellers to 1,048,576 (phase 14 prints the
# buckets its runs used); 512 the floor, 8,192 and 32,768 join-stress's
SORT_BUCKETS = (512, 8_192, 32_768, 524_288, 1_048_576)
SORT_KINDS = ("hash", "few digits", "duplicates")


def u64_keys(rng, n, kind, pad):
    """u64 join keys of one kind, the last ``pad`` SENTINEL: hash-like
    (half at or above 2^63), two varying digits, or 30 distinct keys."""
    m = n - pad
    k = np.full(n, SENTINEL64, np.uint64)
    if kind == "hash":
        k[:m] = rng.integers(0, 2**64 - 1, m, dtype=np.uint64)
    elif kind == "few digits":
        k[:m] = ((rng.integers(0, 1 << 16, m).astype(np.uint64)
                  << np.uint64(24)) | np.uint64(0xC0FFEE))
    else:
        k[:m] = rng.choice(rng.integers(0, 2**64 - 1, 30, dtype=np.uint64),
                           m)
    return k


def by_kernel(device_us):
    """Device µs a call summed by kernel name (``sort_pass[3]`` counts as
    ``sort_pass``)."""
    out = collections.defaultdict(float)
    for name, us in device_us.items():
        out[re.sub(r"\[\d+\]$", "", name)] += us
    return dict(out)


def k15_case(rng, dev, n, kind, parent=None):
    """K15 on one padded bucket: order and sorted keys bit-equal to the
    plain version and to numpy's stable argsort of the u64 keys, views of
    one buffer, one allocation and no host sync a call, one device launch
    up to ONE_BLOCK_MAX keys and a memset and 9 above; timed in
    turns with ``torch.sort(stable=True)`` of the keys' unsigned-order i64
    view (made once, outside the timed call), warm and cold, device µs by
    kernel name.  With ``parent``: the parent commit's kernel (25 launches
    and a memset) in turns with this one, its output bit-equal."""
    pad = n // 8
    shape = f"n={n} {kind} keys, {pad} SENTINEL"
    k = u64_keys(rng, n, kind, pad)
    kt = torch.tensor(k.view(np.int64), device=dev)
    before = join_sort.launches
    got = join_sort(kt)
    launches = join_sort.launches - before
    torch.cuda.synchronize()
    want = join_sort_reference(kt)
    check(launches == 1, f"join_sort made {launches} launches ({shape})")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"join_sort differs from its plain version ({shape})")
    check(np.array_equal(got[0].cpu().numpy(), np.argsort(k, kind="stable")),
          f"join_sort is not numpy's stable argsort ({shape})")
    check(got[0].untyped_storage().data_ptr()
          == got[1].untyped_storage().data_ptr(),
          "join_sort's outputs are not views of one buffer")
    ku = unsigned_order(kt)

    def kernel():
        return join_sort(kt)

    def library():
        return torch.sort(ku, stable=True)

    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: join_sort_reference(kt), reps=5)
    meas = measured(kernel, "sort_")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"join_sort made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    device_launches = len(meas["device_us_per_call"])
    check(device_launches == (1 if n <= ONE_BLOCK_MAX else 10),
          f"join_sort made {device_launches} device launches ({shape}); "
          "0: torch.profiler recorded no device activity")
    nbytes = 24 * n
    r = row("join_sort", K15_SOURCE, K15_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "torch.sort(stable=True)")
    dev_warm, dev_cold = device_sum(meas)
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches,
             device_launches_per_call=device_launches,
             device_us_by_kernel=by_kernel(meas["device_us_per_call"]),
             bound_bytes=nbytes,
             device_us_warm_total=dev_warm, device_us_cold_total=dev_cold,
             library_device_us=profile_kernels(library), **meas)
    if parent is not None:
        pj = parent.join_sort
        p_got = pj(kt)
        check(torch.equal(p_got[0], got[0]) and torch.equal(p_got[1], got[1]),
              f"join_sort differs from the parent's ({shape})")

        def parent_call():
            return pj(kt)

        c_ms, p_ms, p_turns = in_turns(kernel, parent_call)
        p_meas = measured(parent_call, "sort_")
        p_warm, p_cold = device_sum(p_meas)
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, "turns": turn_factors(p_turns),
                       "device_us_warm_total": p_warm,
                       "device_us_cold_total": p_cold,
                       "device_launches_per_call":
                           len(p_meas["device_us_per_call"]),
                       "host_us_per_call": p_meas["host_us_per_call"]}
    print(f"join_sort {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "plain_ms", "turns_ms",
                                 "library_turns", "bound_ms",
                                 "device_us_warm_total",
                                 "device_us_cold_total",
                                 "device_us_by_kernel",
                                 "device_launches_per_call",
                                 "library_device_us", "host_us_per_call",
                                 "allocations_per_call", "syncs_per_call",
                                 "parent") if key in r}))
    return r


def k9_u64_case(rng, dev, n, parent=None):
    """The u64 form of K9 on one legacy probe: the sorted left bucket of
    ``n`` (an eighth SENTINEL) against a sorted right bucket of ``n`` keys
    drawn from the left's (a fifth SENTINEL, a third of them absent from
    the left)."""
    m, n_valid = n - n // 8, n - n // 5
    pool = rng.integers(0, 2**64 - 1, max(m // 2, 1), dtype=np.uint64)
    lk = np.full(n, SENTINEL64, np.uint64)
    rk = np.full(n, SENTINEL64, np.uint64)
    lk[:m] = np.sort(rng.choice(pool, m))
    rk[:n_valid] = np.sort(np.concatenate([
        rng.choice(pool, n_valid - n_valid // 3),
        rng.integers(0, 2**64 - 1, n_valid // 3, dtype=np.uint64)]))
    return k9_u64_run(lk, rk, m, n_valid, dev,
                      f"u64 legacy probe n={n} m={m} n_valid={n_valid}",
                      parent)


# (m, n_valid, what): u64 probes whose tiles hold one key (or one real
# query) while the window is the whole plane, which fits the staging
# budget: the smallest device join_pairs (1 row against 2,047), a tail
# tile of one query, a small batch of one hot key
ONE_KEY_WHOLE_PLANE = ((1, 2_047, "one query against 2,047 rows"),
                       (1_025, 1_023, "1,025 queries against 1,023 rows"),
                       (100, 3_000, "100 equal keys against 3,000 rows"))


def k9_u64_adversarial(rng, dev, parent=None):
    """The u64 probe where its windows are not a tile's share of the
    plane: one key over half of a 2^20 plane (a 2,048-query tile's window
    is 524,288 rows: sampled), 8b's probe (8,192 queries against 524,288
    rows: sampled windows of ~64 rows a query), all padding (no search at
    all), and tiles of one key or one real query whose window is the
    whole plane (ONE_KEY_WHOLE_PLANE)."""
    n = 1 << 20
    hot = rng.integers(0, 2**64 - 1, dtype=np.uint64)
    rk = np.full(n, SENTINEL64, np.uint64)
    rk[:n - n // 5] = np.sort(np.concatenate([
        np.full(n // 2, hot, np.uint64),
        rng.integers(0, 2**64 - 1, n - n // 5 - n // 2, dtype=np.uint64)]))
    lk = np.full(n, SENTINEL64, np.uint64)
    m = n - n // 8
    lk[:m] = np.sort(np.concatenate([
        np.full(m // 4, hot, np.uint64), rng.choice(rk[:n - n // 5],
                                                    m - m // 4)]))
    rows = [k9_u64_run(lk, rk, m, n - n // 5, dev,
                       f"u64 hot key over half the plane n={n} m={m}",
                       parent)]
    nl, nr = 8_192, 400_000  # 8b's batch against its side (PAIR_CASES)
    rk = np.full(524_288, SENTINEL64, np.uint64)
    rk[:nr] = np.sort(rng.integers(0, 2**64 - 1, nr, dtype=np.uint64))
    lk = np.full(nl, SENTINEL64, np.uint64)
    lk[:8_000] = np.sort(rng.choice(rk[:nr], 8_000))
    rows.append(k9_u64_run(lk, rk, 8_000, nr, dev,
                           f"u64 8b probe mq={nl} m=8000 cap=524288 "
                           f"n_valid={nr}", parent))
    lk = np.full(n, SENTINEL64, np.uint64)
    rows.append(k9_u64_run(lk, rk, 0, nr, dev,
                           f"u64 all padding mq={n} m=0 n_valid={nr}",
                           parent))
    for m, nr, what in ONE_KEY_WHOLE_PLANE:
        key = rng.integers(0, 2**64 - 1, dtype=np.uint64)
        rk = np.full(1 << (nr - 1).bit_length(), SENTINEL64, np.uint64)
        rk[:nr] = np.sort(np.concatenate([
            np.full(3, key, np.uint64),
            rng.integers(0, 2**64 - 1, nr - 3, dtype=np.uint64)]))
        lk = (np.full(m, key, np.uint64) if m in (1, 100)
              else np.sort(rng.choice(rk[:nr], m)))
        rows.append(k9_u64_run(lk, rk, m, nr, dev,
                               f"u64 {what} mq={m} cap={len(rk)}", parent))
    return rows


def k9_u64_run(lk, rk, m, n_valid, dev, shape, parent=None):
    """The u64 form of K9 on sorted u64 keys: outputs bit-equal to the
    plain version, one buffer, 1 allocation, no host sync and at most two
    device launches (a memset and the probe) a call; timed in turns with
    ``searchsorted`` x2 + ``cumsum`` on the unsigned-order views and, with
    ``parent``, with the parent commit's kernel."""
    q = torch.tensor(lk.view(np.int64), device=dev)
    r_ = torch.tensor(rk.view(np.int64), device=dev)
    before = join_probe.u64_launches
    got = join_probe(q, r_, m, n_valid)
    launches = join_probe.u64_launches - before
    torch.cuda.synchronize()
    want = join_probe_reference(q, r_, m, n_valid)
    check(launches == 1, f"join_probe u64 made {launches} launches")
    check(all(g.dtype == w.dtype and torch.equal(g, w)
              for g, w in zip(got, want)),
          f"join_probe u64 differs from its plain version ({shape})")
    check(len({g.untyped_storage().data_ptr() for g in got}) == 1,
          "join_probe's outputs are not views of one buffer")
    qu, ru = unsigned_order(q), unsigned_order(r_)

    def kernel():
        return join_probe(q, r_, m, n_valid)

    def library():
        s_ = torch.searchsorted(ru, qu)
        e_ = torch.searchsorted(ru, qu, right=True)
        return torch.cumsum(e_ - s_, 0)

    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: join_probe_reference(q, r_, m, n_valid), reps=5)
    meas = measured(kernel, ("probe_", "emset"))
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"join_probe u64 made {meas['allocations_per_call']} allocations "
          f"and {meas['syncs_per_call']} host syncs ({shape})")
    device_launches = len(meas["device_us_per_call"])
    n_tiles = -(-len(lk) // u64_tile(len(lk), n_valid))
    check(device_launches == (1 if n_tiles == 1 else 2),
          f"join_probe u64 made {device_launches} device launches "
          f"({shape}); 0: torch.profiler recorded no device activity")
    n_q = int(torch.unique(q).numel())
    nbytes = 8 * len(lk) + searched(8 * len(rk), n_valid, 2 * n_q) \
        + 16 * len(lk)
    r = row("join_probe", K9_SOURCE, K9_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "searchsorted x2 + cumsum")
    dev_warm, dev_cold = device_sum(meas)
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches,
             device_launches_per_call=device_launches, bound_bytes=nbytes,
             device_us_warm_total=dev_warm, device_us_cold_total=dev_cold,
             library_device_us=profile_kernels(library), **meas)
    if parent is not None:
        pp = parent.join_probe
        check(all(torch.equal(g, w) for g, w in zip(
            pp(q, r_, m, n_valid), got)),
            f"join_probe u64 differs from the parent's ({shape})")

        def parent_call():
            return pp(q, r_, m, n_valid)

        c_ms, p_ms, p_turns = in_turns(kernel, parent_call)
        p_meas = measured(parent_call, ("probe_",))
        p_warm, p_cold = device_sum(p_meas)
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, "turns": turn_factors(p_turns),
                       "device_us_warm_total": p_warm,
                       "device_us_cold_total": p_cold,
                       "device_us_per_call": p_meas["device_us_per_call"],
                       "host_us_per_call": p_meas["host_us_per_call"]}
    print(f"join_probe {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "plain_ms", "turns_ms",
                                 "library_turns", "bound_ms",
                                 "device_us_warm_total",
                                 "device_us_cold_total",
                                 "device_launches_per_call",
                                 "library_device_us", "host_us_per_call",
                                 "allocations_per_call", "syncs_per_call",
                                 "parent") if key in r}))
    return r


# join_pairs at 8a's and 8b's pairings (phase 14): a batch of 8a's
# (7,000 rows) against the other side's 8,192- and 65,536-row buckets,
# and 8b's batch against its 400,000-row side (524,288), keys from 100,000
PAIR_CASES = ((7_000, 7_000, "8a 8,192 + 8,192"),
              (7_000, 60_000, "8a 8,192 + 65,536"),
              (8_000, 400_000, "8b 8,192 + 524,288"))


def pairs_callers(rng, dev, parent):
    """The legacy layout's caller ``ops/join.join_pairs`` (one upload, two
    ``join_sort`` calls, the u64 probe, the expansion, one sync) against
    the parent's on the same keys: all five outputs equal, timed in turns
    (CUDA events around each call, which ends in its sync)."""
    pool = rng.integers(0, 2**64 - 1, 100_000, dtype=np.uint64)
    for nl, nr, what in PAIR_CASES:
        lk, rk = rng.choice(pool, nl), rng.choice(pool, nr)

        def pairs():
            return join_ops.join_pairs(lk, rk, dev)

        def parent_pairs():
            return parent.join.join_pairs(lk, rk, dev)

        a, b = pairs(), parent_pairs()
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"join_pairs differs from the parent's ({what})")
        ms, p_ms, turns = in_turns(pairs, parent_pairs)
        r = {"case": what, "nl": nl, "nr": nr, "pairs": len(a[2]),
             "ms": ms, "parent_ms": p_ms, "turns_ms": turns,
             "turns": turn_factors(turns)}
        print("join_pairs caller: " + json.dumps(r))


def legacy_kernel_cases(rng, dev, parent=None):
    """Phase 3's cases of the legacy join layout: join_sort at every
    bucket and key kind (with ``parent``, in turns with the parent's, and
    the caller join_pairs with the parent's), the u64 probe at every
    bucket and at its adversarial windows (with ``parent``, in turns with
    the parent's)."""
    rows = [k15_case(rng, dev, n, kind, parent) for n in SORT_BUCKETS
            for kind in SORT_KINDS]
    if parent is not None:
        pairs_callers(rng, dev, parent)
    rows += [k9_u64_case(rng, dev, n, parent) for n in SORT_BUCKETS]
    rows += k9_u64_adversarial(rng, dev, parent)
    return rows


def probe_callers(hi_np, lo_np, q_np, ql_np, n_valid, m, ni, ist, dev,
                  parent, shape, expand="expand_gather"):
    """The join's hot probe, ``probe_ring`` + ``expand`` (``expand_gather``
    or the keys-only ``expand_hit``: one upload from pinned memory, the
    probe and the expansion launched back to back, one readback), against
    the parent's, on rings holding the same planes: the same arrays, then
    in turns, with allocations and host syncs a call (and, for
    ``expand_gather``, the host split of a probe)."""
    to_key = lambda h, l: ((h.view(np.uint32) ^ np.uint32(0x80000000))  # noqa: E731
                           .astype(np.uint64) << np.uint64(32)) | \
        l.view(np.uint32).astype(np.uint64)
    q = to_key(q_np[:m], ql_np[:m])
    cap = len(hi_np)
    nf = 0
    hi, lo = torch.tensor(hi_np, device=dev), torch.tensor(lo_np, device=dev)
    fst = torch.zeros((nf, cap), dtype=torch.float64, device=dev)
    pj, pp = join_ops, parent.join
    plan = pj.payload_plan({f"i{k}": np.dtype(np.int64)
                            for k in range(1, ni)})
    ring = pj.SplitRing(hi, lo, cap, fst, ist, plan, nf, ni, dev)
    pring = pp.SplitRing(hi, lo, cap, fst, ist, plan, nf, ni, dev)

    def probe():
        return getattr(pj, expand)(ring, pj.probe_ring(ring, q, n_valid))

    def parent_probe():
        return getattr(pp, expand)(pring, pp.probe_ring(pring, q, n_valid))

    a, b = probe(), parent_probe()  # the first sizes the ring's capacity
    check(all(np.array_equal(x, y) for x, y in zip(a, b)),
          f"probe_ring + {expand} differs from the parent's ({shape})")
    ms, p_ms, turns = in_turns(probe, parent_probe)
    out = {"ms": ms, "parent_ms": p_ms, "turns_ms": turns,
           **turn_factors(turns), "pair_cap": ring.pair_cap,
           "allocations_syncs": per_call(probe),
           "parent_allocations_syncs": per_call(parent_probe)}
    if expand == "expand_gather":
        out["host_split"] = probe_split(ring, q, n_valid, probe)
    return out


def probe_split(ring, q, n_valid, probe):
    """Where the join's hot probe spends its host time: microseconds of
    each step alone — the queries' i32 planes, their upload, the probe's
    launch, the expansion's launch (these three queue on the card), the
    readback of a finished buffer and its split — and of the whole
    probe."""
    m = len(q)
    mq = join_ops._bucket(m)

    def queries():
        qp = np.empty((2, mq), np.int32)
        qp[0], qp[1] = 0x7FFFFFFF, -1
        qp[0, :m] = join_ops.split_hi32(q)
        qp[1, :m] = join_ops.split_lo32(q)
        return qp

    qp = queries()
    q_d = to_device(qp, ring.device)
    start, _counts, cum = join_probe(q_d[0], ring.hi, m, n_valid)
    cap = ring.pair_cap
    args = (start, cum, cap, ring.hi, ring.lo, q_d[0], q_d[1], ring.fstack,
            ring.istack)
    buf = expand_gather_buffer(*args)
    host = to_host(buf)
    total = int(host[0])
    return {"queries_us": host_us(queries, reps=500),
            "upload_us": host_us(lambda: to_device(qp, ring.device),
                                 reps=500),
            "probe_launch_us": host_us(
                lambda: join_probe(q_d[0], ring.hi, m, n_valid), reps=500),
            "expand_launch_us": host_us(lambda: expand_gather_buffer(*args),
                                        reps=500),
            "readback_us": host_us(lambda: to_host(buf), reps=500),
            "readback_bytes": buf.numel() * 8,
            "views_us": host_us(lambda: expand_views(
                host, total, ring.nf, ring.ni, cap), reps=500),
            "probe_us": host_us(probe, reps=200)}


def expand_gather_split(args):
    """Where an expand_gather call's host time goes: microseconds of its
    argument checks, its one allocation, the launch alone into a buffer
    made beforehand (ctypes and cudaLaunchKernel), the whole wrapper and
    the five views of the tuple form."""
    start, cum, total, hi, lo, q_hi, q_lo, fstack, istack = args
    mq, cap, nf, ni = expand_gather_mod._check(*args)
    words = expand_gather_mod.buffer_words(total, nf, ni)
    buf = torch.empty(words, dtype=torch.int64, device=start.device)
    return {
        "check_us": host_us(lambda: expand_gather_mod._check(*args)),
        "alloc_us": host_us(lambda: torch.empty(words, dtype=torch.int64,
                                                device=start.device)),
        "launch_us": host_us(lambda: expand_gather_mod._launch(
            start, cum, mq, total, hi, lo, cap, q_hi, q_lo, fstack, nf,
            istack, ni, buf)),
        "wrapper_us": host_us(lambda: expand_gather_buffer(*args)),
        "views_us": host_us(lambda: expand_views(buf, total, nf, ni))}


def k11_case(args, want, library, shape, nbytes, parent=None):
    """K11 on one probe's expansion: all five outputs bit-equal to the
    plain version as views of one buffer, one launch, one allocation and
    no host sync a call; timed in turns with its library calls and, with
    ``parent``, with the parent commit's kernel and the parent's caller
    (the kernel, five readbacks) against this one (the kernel into one
    buffer, one readback); its host split."""
    start, cum, total, hi, lo, q_hi, q_lo, fstack, istack = args
    nf, ni = fstack.shape[0], istack.shape[0]
    before = expand_gather.launches
    got = expand_gather(*args)
    launches = expand_gather.launches - before
    torch.cuda.synchronize()
    check(launches == 1, f"expand_gather made {launches} launches ({shape})")
    check(all(g.dtype == w.dtype and torch.equal(g, w)
              for g, w in zip(got, want)),
          f"expand_gather differs ({shape})")
    check(len({g.untyped_storage().data_ptr() for g in got}) == 1,
          "expand_gather's outputs are not views of one buffer")

    def kernel():  # the call the join makes: one buffer
        return expand_gather_buffer(*args)

    check(all(torch.equal(v, w) for v, w in zip(
        expand_views(kernel(), total, nf, ni), want)),
        f"expand_gather_buffer's views differ ({shape})")
    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: expand_gather_reference(*args))
    meas = measured(kernel, "expand_gather")
    public = per_call(lambda: expand_gather(*args))
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0
          and public == (1, 0),
          f"expand_gather made {meas['allocations_per_call']} allocations "
          f"and {meas['syncs_per_call']} host syncs, the five-view form "
          f"{public} ({shape})")
    meas["tuple_form_host_us"] = host_us(lambda: expand_gather(*args),
                                         reps=200)
    r = row("expand_gather", K11_SOURCE, K11_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib,
            "repeat_interleave + arange + index_select per stack")
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             launches_per_call=launches, bound_bytes=nbytes,
             library_device_us=profile_kernels(library), **meas,
             host_split=expand_gather_split(args))
    if parent is not None:
        pe = parent.expand_gather
        p_out = pe(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(p_out, got)),
              f"expand_gather differs from the parent's ({shape})")
        c_ms, p_ms, p_turns = in_turns(kernel, lambda: pe(*args))

        def parent_read():  # the parent's ops/join.expand_gather
            return tuple(x.cpu().numpy() for x in pe(*args))

        def read():  # this ops/join.expand_gather
            return expand_views(to_host(expand_gather_buffer(*args)), total,
                                nf, ni)

        read_ms, p_read_ms, read_turns = in_turns(read, parent_read)
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       "read_ms": p_read_ms, "change_read_ms": read_ms,
                       "read_turns_ms": read_turns,
                       "read_factors": turn_factors(read_turns),
                       **measured(lambda: pe(*args), "expand_gather")}
    print(f"expand_gather {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "turns_ms",
                                 "library_turns", "bound_ms", "bound_bytes",
                                 "library_device_us", "host_us_per_call",
                                 "device_us_per_call", "device_us_cold",
                                 "allocations_per_call", "syncs_per_call",
                                 "tuple_form_host_us", "host_split",
                                 "parent") if key in r}))
    return r


def bid_counts(rng, n):
    """TopN input values as a hot-items fire gives them: bids per auction
    in a window — mostly a few, some hot auctions far more, heavy ties."""
    v = rng.geometric(0.35, n).astype(np.float64)
    hot = rng.random(n) < 0.002
    v[hot] = rng.integers(50, 900, int(hot.sum()))
    return v


def topk_case(rng, dev, n, n_seg, shape):
    """K12 at a hot-items fire's size: ``n`` rows over ``n_seg`` windows,
    k = 10; exact against the plain version."""
    seg = torch.tensor(rng.integers(0, n_seg, n).astype(np.int32),
                       device=dev)
    val = torch.tensor(bid_counts(rng, n), device=dev)
    got = segment_top_k(seg, val, TOP_K)
    tally = (segment_top_k.last_launches, segment_top_k.last_syncs)
    want = segment_top_k_reference(seg, val, TOP_K)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"segment_top_k differs ({shape})")
    check(tally[0] <= 6 and tally[1] == 1,
          f"segment_top_k's prefilter path took {tally[0]} launches and "
          f"{tally[1]} host syncs ({shape})")
    allocs, syncs = per_call(lambda: segment_top_k(seg, val, TOP_K))
    check(syncs == tally[1],
          f"segment_top_k counted {tally[1]} host syncs, PyTorch saw "
          f"{syncs} ({shape})")
    keys = order_keys(val)

    def library():  # two stable sorts give the kept rows' order
        by_val = torch.sort(keys, stable=True).indices
        return torch.sort(seg[by_val], stable=True)

    ms, lib, turns = in_turns(lambda: segment_top_k(seg, val, TOP_K),
                              library)
    plain = cuda_ms(lambda: segment_top_k_reference(seg, val, TOP_K))
    device = profile_kernels(lambda: segment_top_k(seg, val, TOP_K))
    host = host_us(lambda: segment_top_k(seg, val, TOP_K), reps=200)
    grid = _round_grid_cap(dev.index)
    print(f"segment_top_k {shape}: {tally[0]} launches, {syncs} host "
          f"syncs, {allocs} allocations per call, round grid <= {grid} "
          f"blocks; kernel {ms:.4f} ms, two "
          f"sorts {lib:.4f} ms; host us per call {host:.1f}; device us per "
          "call " + json.dumps(device))
    # an i32 segment id and an f64 value read a row, an i32 index written
    # a kept row; the compares have no published peak rate
    r = row("segment_top_k", K12_SOURCE, K12_REPLACES,
            f"{shape} kept={got.numel()}", 0.0, ms, plain,
            12 * n + 4 * got.numel(), 0, lib, "two stable torch.sort")
    r.update(turns_ms=turns, launches_per_call=tally[0],
             syncs_per_call=syncs, allocations_per_call=allocs,
             host_us_per_call=host, device_us_per_call=device,
             round_grid_blocks=grid)
    return r


def compact_callers(counts, rows, ring_np, ok_np, parent):
    """``KeyedBinState._emit_compact`` at a hot-items fire (COUNT(*),
    ``rows`` occupied slots of ``counts``): this tree's (the panes in one
    pinned upload, one count launch, the live total, the gather into one
    buffer and its one readback: two syncs) against the parent's (the
    gather's three outputs read back: four syncs), the same rows, then in
    turns, with allocations, host syncs and uploads a fire."""
    aggs = (AggSpec(AggKind.COUNT, None, "n"),)
    p_aggs = (parent.logical.AggSpec(parent.logical.AggKind.COUNT, None,
                                     "n"),)
    C, B = counts.shape
    fires = []
    for cls, a in ((KeyedBinState, aggs), (parent.keyed_bins.KeyedBinState,
                                           p_aggs)):
        st = cls(a, HOT_SLIDE, HOT_WIDTH, capacity=8, device=counts.device)
        st.C, st.B, st.next_slot, st.counts = C, B, rows, counts
        st.values = torch.zeros((1, C, B), dtype=torch.float64,
                                device=counts.device)
        fires.append(functools.partial(st._emit_compact, ring_np, ok_np))
    fire, parent_fire = fires
    perf.reset()
    got = fire()
    uploads = (perf.counter("bin_compact_fire_uploads"),
               perf.counter("bin_compact_fire_blocking_uploads"))
    want = parent_fire()
    check(uploads == (1, 0), f"a compact fire made {uploads} (uploads, "
          "blocking uploads)")
    check(all(np.array_equal(x, y) for x, y in zip(got, want)),
          "_emit_compact differs from the parent's")
    ms, p_ms, turns = in_turns(fire, parent_fire)
    return {"ms": ms, "parent_ms": p_ms, "turns_ms": turns,
            **turn_factors(turns), "uploads_blocking": uploads,
            "allocations_syncs": per_call(fire),
            "parent_allocations_syncs": per_call(parent_fire),
            "host_us": host_us(fire, reps=100),
            "parent_host_us": host_us(parent_fire, reps=100),
            "steps_ms": compact_split(fire.func.__self__, ring_np, ok_np)}


def synced_ms(fn, reps=10):
    """Median host milliseconds of ``fn`` followed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def compact_split(st, ring_np, ok_np):
    """Where ``st._emit_compact`` spends its time, each step synchronized
    on its own: the panes' one upload, emit_count, the live total's
    readback, the gather into one buffer, and that buffer's one readback
    through pinned memory (``device.to_host``) and through ``.cpu()``,
    pageable."""
    from arroyo_tpu_torch.kernels.emit_compact import pack_panes, panes_views
    dev = st.counts.device
    ring_t, ok_t = panes_views(to_device(pack_panes(ring_np, ok_np), dev),
                               *ring_np.shape)
    cnt, offsets = emit_count(st.counts, ring_t, ok_t, st.next_slot)
    nnz = int(offsets[-1].item())
    buf = emit_gather_buffer(st.values, cnt, ring_t, ok_t, st._plan, offsets,
                             nnz)
    return {
        "upload": synced_ms(lambda: panes_views(
            to_device(pack_panes(ring_np, ok_np), dev), *ring_np.shape)),
        "emit_count": synced_ms(lambda: emit_count(st.counts, ring_t, ok_t,
                                                   st.next_slot)),
        "live_total": synced_ms(lambda: int(offsets[-1].item())),
        "emit_gather": synced_ms(lambda: emit_gather_buffer(
            st.values, cnt, ring_t, ok_t, st._plan, offsets, nnz)),
        "readback_pinned": synced_ms(lambda: to_host(buf)),
        "readback_pageable": synced_ms(lambda: buf.cpu().numpy()),
        "rows": nnz}


def compact_cases(rng, dev, k, rows, shape, parent=None):
    """K13/K14 at hot items' compact fires: C_HOT slots, the first
    ``rows`` occupied, a COUNT(*) counts plane whose pane cells are live
    with probability HOT_DENSITY.  Exact against the plain versions and
    against the dense fire (pane_emit) at the live cells; emit_count and
    emit_gather each one launch, one allocation and no host sync a call,
    each timed in turns with its library call and, with ``parent``, with
    the parent's (emit_count: two launches; emit_gather: three outputs)
    and their caller ``_emit_compact``."""
    q = 1 - (1 - HOT_DENSITY) ** (1 / W_HOT)  # a bin holds rows
    cells = np.where(rng.random((rows, B_HOT)) < q,
                     rng.integers(1, 9, (rows, B_HOT)), 0)
    counts = torch.zeros((C_HOT, B_HOT), dtype=torch.int32, device=dev)
    counts[:rows] = torch.tensor(cells.astype(np.int32), device=dev)
    values = torch.zeros((1, C_HOT, B_HOT), dtype=torch.float64, device=dev)
    # panes p < k over the absolute bins 3 + p + w, all live
    geometry = (3, 3, 3 + k + W_HOT - 2)
    ring_np, ok_np = fire_geometry(*geometry, W_HOT, k, B_HOT)
    check(ok_np.all(), "hot compact fire: a bin is not live")
    ring = torch.tensor(ring_np, device=dev)
    ok = torch.tensor(ok_np, device=dev)
    kinds, xfer = ("count",), ()
    before = emit_count.launches
    cnt, offsets = emit_count(counts, ring, ok, rows)
    launches = emit_count.launches - before
    cnt_r, offsets_r = emit_count_reference(counts, ring, ok, rows)
    torch.cuda.synchronize()
    check(launches == 1, f"emit_count made {launches} launches ({shape})")
    check(torch.equal(cnt, cnt_r) and torch.equal(offsets, offsets_r),
          f"emit_count differs ({shape})")
    nnz = int(offsets[-1])
    g_args = (values, cnt, ring, ok, kinds, xfer, offsets, nnz)
    got, want = emit_gather(*g_args), emit_gather_reference(*g_args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"emit_gather differs ({shape})")
    _outs, dense = pane_views(
        pane_emit(values, counts, *geometry, W_HOT, k, kinds, xfer, rows),
        len(xfer), rows, k, counts.dtype)
    check(torch.equal(got[1], dense[got[0][0].long(), got[0][1].long()]),
          f"emit_gather's counts differ from pane_emit's ({shape})")
    shape = f"{shape} density={nnz / (rows * k):.4f} nnz={nnz}"
    ring_l = ring.long()

    def count():
        return emit_count(counts, ring, ok, rows)

    def lib_count():  # the masked gather-sum of the pane counts
        return torch.where(ok[None], counts[:rows][:, ring_l], 0).sum(-1)

    def lib_gather():  # nonzero + one index_select per plane
        flat = torch.nonzero(cnt.reshape(-1) > 0).squeeze(1)
        return flat, cnt.reshape(-1).index_select(0, flat)

    ms, lib, turns = in_turns(count, lib_count)
    meas = measured(count, "count_kernel")
    check(meas["allocations_per_call"] <= 1 and meas["syncs_per_call"] == 0,
          f"emit_count made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    item = counts.element_size()
    nb = offsets.numel()
    cols = len(np.unique(ring_np))
    r = row("emit_count", K13_SOURCE, K13_REPLACES, shape, 0.0, ms,
            cuda_ms(lambda: emit_count_reference(counts, ring, ok, rows)),
            rows * cols * item + rows * k * item + 4 * nb,
            rows * k * W_HOT, lib, "counts[:, ring] masked sum")
    # the least time IF memory moves whole 64-byte atoms: each row's live
    # columns cost its atoms, the pane counts and offsets stream out
    r.update(launches_per_call=launches, turns_ms=turns,
             library_turns=turn_factors(turns),
             atom_bound_ms=atom_bound_ms(
                 rows * row_atoms(item, B_HOT, np.unique(ring_np)), 0,
                 rows * k * item + 4 * nb),
             device_us_sum=device_sum(meas), **meas)
    if parent is not None:
        pc = parent.emit_count
        p_cnt, p_off = pc(counts, ring, ok, rows)
        torch.cuda.synchronize()
        check(torch.equal(p_cnt, cnt) and torch.equal(p_off, offsets),
              f"emit_count differs from the parent's ({shape})")

        def parent_count():
            return pc(counts, ring, ok, rows)

        c_ms, p_ms, p_turns = in_turns(count, parent_count)
        p_meas = measured(parent_count, ("count_kernel", "exclusive_scan"))
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       "device_us_sum": device_sum(p_meas), **p_meas,
                       "caller": compact_callers(counts, rows, ring_np,
                                                 ok_np, parent)}
    print(f"emit_count {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "library_turns",
                                 "plain_ms", "bound_ms", "atom_bound_ms",
                                 "launches_per_call",
                                 "host_us_per_call", "device_us_per_call",
                                 "device_us_cold", "device_us_sum",
                                 "allocations_per_call", "syncs_per_call",
                                 "parent") if key in r}))
    return [r, gather_case(values, cnt, ring, ok, offsets, nnz, lib_gather,
                           shape, parent)]


def gather_case(values, cnt, ring, ok, offsets, nnz, lib_gather, shape,
                parent):
    """K14 at a hot-items compact fire (COUNT(*): no transferred channel):
    the buffer form (the caller's) equal to the plain version, one launch,
    one allocation and no host sync a call, timed in turns with the
    library call and, with ``parent``, with the parent's gather (its
    three outputs, two numpy arrays and a 516-byte spec a call)."""
    kinds, xfer = ("count",), ()
    plan = channel_plan(kinds, (0,))
    g_args = (values, cnt, ring, ok, plan, offsets, nnz)

    def gather():  # the call the compact fire makes: one buffer
        return emit_gather_buffer(*g_args)

    before = emit_gather.launches
    got = compact_views(gather(), nnz, 0, cnt.dtype)
    launches = emit_gather.launches - before
    want = compact_views(emit_gather_buffer_reference(*g_args), nnz, 0,
                         cnt.dtype)
    torch.cuda.synchronize()
    check(launches == 1 and all(torch.equal(a, b)
                                for a, b in zip(got, want)),
          f"emit_gather's buffer differs ({shape}), {launches} launches")
    meas = measured(gather, "gather_kernel")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"emit_gather made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    ms, lib, turns = in_turns(gather, lib_gather)
    rows, k = cnt.shape
    item = cnt.element_size()
    nb = offsets.numel()
    # the groups with a live cell read their counts; all read offsets
    live_groups = int((offsets[1:] > offsets[:-1]).sum())
    read = min(rows * k, live_groups * EMIT_GROUP) * item + 4 * nb
    r = row("emit_gather", K14_SOURCE, K14_REPLACES, shape, 0.0, ms,
            cuda_ms(lambda: emit_gather_buffer_reference(*g_args)),
            read + nnz * (8 + item), 0, lib, "nonzero + index_select")
    r.update(launches_per_call=launches, turns_ms=turns,
             library_turns=turn_factors(turns), live_groups=live_groups,
             device_us_sum=device_sum(meas), **meas)
    if parent is not None:
        pg = parent.emit_gather
        p_args = (values, cnt, ring, ok, kinds, xfer, offsets, nnz)
        p_got = pg(*p_args)
        torch.cuda.synchronize()
        check(torch.equal(p_got[0][0], got[0]) and torch.equal(
            p_got[0][1], got[1]) and torch.equal(p_got[1], got[2]),
              f"emit_gather differs from the parent's ({shape})")

        def parent_gather():
            return pg(*p_args)

        c_ms, p_ms, p_turns = in_turns(gather, parent_gather)
        p_meas = measured(parent_gather, "gather_kernel")
        r["parent"] = {"ms": p_ms, "kernel_ms_beside_it": c_ms,
                       "turns_ms": p_turns, **turn_factors(p_turns),
                       "device_us_sum": device_sum(p_meas), **p_meas}
    print(f"emit_gather {shape}: " + json.dumps(
        {key: r[key] for key in ("ms", "library_ms", "library_turns",
                                 "plain_ms", "bound_ms", "launches_per_call",
                                 "host_us_per_call", "device_us_per_call",
                                 "device_us_cold", "device_us_sum",
                                 "allocations_per_call", "syncs_per_call",
                                 "parent") if key in r}))
    return r


# -- phase 3: the keyed mesh's kernels -------------------------------------------------

KA_SOURCE = "arroyo_tpu_torch/csrc/mesh_route.cu"
KA_REPLACES = ("arroyo_tpu/parallel/mesh_window.py:119 _update_step (route "
               "half); arroyo_tpu/parallel/shuffle.py:193 _route_step")
KB_SOURCE = "arroyo_tpu_torch/csrc/mesh_merge.cu"
KB_REPLACES = "arroyo_tpu/parallel/mesh_window.py:119 _update_step (merge half)"
KC_SOURCE = "arroyo_tpu_torch/csrc/mesh_remap.cu"
KC_REPLACES = ("arroyo_tpu/parallel/mesh_window.py:376 _roll_step; :119 "
               "_update_step (re-layout half)")
# q5's mesh steps at NUM_EVENTS over four shards (a CPU run of phase 20's
# path): ~7,946 cells a batch, slices of N = 2,048, so R = 8,192 routed
# rows a shard; per-shard capacity 65,536 at the last steps, ~29,500 keys
# a shard before them and ~1,990 new ones a step; B = 16; COUNT(*) is one
# channel, so a routed row is F = 5 words
MESH_NK, MESH_N, MESH_CELLS = 4, 2_048, 7_946
MESH_C, MESH_KEYS, MESH_NEW, MESH_B = 65_536, 29_500, 1_990, 16
MESH_F = 5
U64_TOP = (1 << 64) - 1


def mesh_boundary_keys(nk):
    """Keys at both route rules' range edges: k * (U64_MAX // nk) and
    k * 2**(64 - lg), each -1, 0, +1."""
    lg = nk.bit_length() - 1
    out = []
    for k in range(nk + 1):
        for base in (k * (U64_TOP // nk), k << (64 - lg)):
            out += [(base + d) & U64_TOP for d in (-1, 0, 1)]
    return np.array(out, dtype=np.uint64)


def mesh_route_rows(rng, N, m, nk, case):
    """A source slice [MESH_F, N]: key bits, validity, bin, row count, one
    channel; ``case`` hash keys, "one shard" (top bits fixed), "boundary"
    (the rules' edges) or "padding" (no valid row)."""
    keys = rng.integers(0, 2**64 - 1, N, dtype=np.uint64)
    if case == "one shard":
        keys = (keys >> np.uint64(4)) | np.uint64(0xF << 60)
    elif case == "boundary":
        b = mesh_boundary_keys(nk)
        keys = b[rng.integers(0, len(b), N)]
    keys[keys == np.uint64(U64_TOP)] = np.uint64(U64_TOP - 1)
    rows = np.zeros((MESH_F, N), np.int64)
    rows[0] = -1
    if m:
        rows[0, :m] = keys[:m].view(np.int64)
        rows[1, :m] = 1
        rows[2, :m] = rng.integers(0, MESH_B, m)
        rows[3:, :m] = rng.integers(1, 30, (MESH_F - 3, m)).astype(
            np.float64).view(np.int64)
    return rows


def mesh_route_case(rng, dev, N, m, case, rule=RULE_MESH):
    """K-a on one source slice: buckets and drop counter bit-equal to the
    plain version, one launch, one allocation and no host sync a call;
    timed in turns with ``argsort(stable)`` + ``index_select`` of the same
    rows by their destinations (computed once, outside the call)."""
    nk = MESH_NK
    shape = (f"{case} keys, {'mesh' if rule == RULE_MESH else 'shuffle'} "
             f"rule, nk={nk} N={N} m={m} F={MESH_F}")
    rows = torch.tensor(mesh_route_rows(rng, N, m, nk, case), device=dev)
    before = mesh_route.launches
    buf = mesh_route(rows, nk, rule)
    torch.cuda.synchronize()
    check(mesh_route.launches == before + 1, f"mesh_route launches ({shape})")
    got, drop = route_views(buf, MESH_F, nk, N)
    want, dropped = mesh_route_reference(rows, nk, rule)
    check(torch.equal(got, want) and int(drop.item()) == dropped == 0,
          f"mesh_route differs from its plain version ({shape})")
    dest = torch.where(rows[1] != 0, destinations(rows[0], nk, rule), nk)

    def kernel():
        return mesh_route(rows, nk, rule)

    def library():
        return rows.index_select(1, torch.argsort(dest, stable=True))

    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: mesh_route_reference(rows, nk, rule), reps=5)
    meas = measured(kernel, "mesh_route")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"mesh_route made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    nbytes = (1 + nk) * MESH_F * N * 8
    r = row("mesh_route", KA_SOURCE, KA_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "argsort(dest, stable) + index_select")
    dev_warm, dev_cold = device_sum(meas)
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             bound_bytes=nbytes, device_us_warm_total=dev_warm,
             device_us_cold_total=dev_cold,
             library_device_us=profile_kernels(library), **meas)
    print(f"mesh_route {shape}: " + json.dumps(
        {k: r[k] for k in ("ms", "library_ms", "plain_ms", "bound_ms",
                           "device_us_warm_total", "device_us_cold_total",
                           "device_us_per_call", "host_us_per_call",
                           "allocations_per_call", "syncs_per_call")}))
    return r


def mesh_merge_inputs(rng, dev, C, n_old, R, n_new, n_ch=1):
    """A shard's table of ``n_old`` sorted keys and R routed rows (a fifth
    padding) drawing from its keys and ``n_new`` new ones, sorted by
    join_sort as the path sorts them."""
    pool = np.unique(rng.integers(0, 2**64 - 2, n_old + n_new,
                                  dtype=np.uint64))
    rng.shuffle(pool)
    old = np.full(C, U64_TOP, np.uint64)
    old[:n_old] = np.sort(pool[:n_old])
    m = R - R // 5
    inc = np.zeros((4 + n_ch, R), np.int64)
    inc[0] = -1
    inc[0, :m] = rng.choice(pool, m).view(np.int64)
    inc[1, :m] = 1
    inc[2, :m] = rng.integers(0, MESH_B, m)
    inc[3:, :m] = rng.integers(1, 30, (1 + n_ch, m)).astype(
        np.float64).view(np.int64)
    t_old = torch.tensor(old.view(np.int64), device=dev)
    t_inc = torch.tensor(inc, device=dev)
    order, keys = join_sort(t_inc[0])
    return t_old, keys.clone(), order.clone(), t_inc, m


def mesh_merge_case(rng, dev, C, n_old, R, n_new, what):
    """K-b on one shard: merged table, source map and cells bit-equal to
    the plain version, the key-drop count equal, one launch, one
    allocation and no host sync a call; timed in turns with ``cat`` +
    ``sort`` + ``unique_consecutive`` + ``searchsorted`` of the
    top-bit-flipped keys (flipped once, outside the call)."""
    shape = f"{what} C={C} n_old={n_old} R={R} new={n_new} n_ch=1"
    old, keys, order, inc, _ = mesh_merge_inputs(rng, dev, C, n_old, R,
                                                 n_new)
    before = mesh_merge.launches
    buf = mesh_merge(old, keys, order, inc)
    torch.cuda.synchronize()
    check(mesh_merge.launches == before + 1, f"mesh_merge launches ({shape})")
    got = merge_views(buf, C, R, 1)
    want = mesh_merge_reference(old, keys, order, inc)
    check(all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))
          and int(got[3].item()) == want[3],
          f"mesh_merge differs from its plain version ({shape})")
    u_old, u_in = unsigned_order(old), unsigned_order(keys)

    def kernel():
        return mesh_merge(old, keys, order, inc)

    def library():
        u = torch.unique_consecutive(torch.sort(torch.cat([u_old, u_in]))
                                     .values)
        return torch.searchsorted(u, u_in)

    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: mesh_merge_reference(old, keys, order, inc),
                    reps=5)
    meas = measured(kernel, "mesh_merge")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"mesh_merge made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    # reads, once each: the table, the sorted keys and rows, the gathered
    # routed words (bin, row count, channel); writes: the merged table and
    # map, the cells. A merge of two sorted sequences reads each once; the
    # kernel's binary searches are its own design and add nothing here.
    nbytes = 8 * (C + 2 * R + 3 * R) + 8 * (2 * C + 3 * R)
    r = row("mesh_merge", KB_SOURCE, KB_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, "cat + sort + unique_consecutive + searchsorted "
            "(top-bit-flipped keys)")
    dev_warm, dev_cold = device_sum(meas)
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             bound_bytes=nbytes, device_us_warm_total=dev_warm,
             device_us_cold_total=dev_cold, keys_dropped=want[3],
             library_device_us=profile_kernels(library), **meas)
    print(f"mesh_merge {shape}: " + json.dumps(
        {k: r[k] for k in ("ms", "library_ms", "plain_ms", "bound_ms",
                           "device_us_warm_total", "device_us_cold_total",
                           "device_us_per_call", "host_us_per_call",
                           "allocations_per_call", "syncs_per_call",
                           "keys_dropped")}))
    return r


def mesh_remap_case(rng, dev, C, B, what, label, cdt=torch.int32):
    """K-c on one shard's planes (COUNT(*): one channel): the update's
    re-layout through a merge's map (``what`` "update": old rows moved
    down by the new keys below them, a new key's row empty) or the roll
    (``what`` "roll": the columns shifted left by 4), bit-equal to the
    plain version, one launch, one allocation and no host sync a call;
    timed in turns with ``index_select`` + ``where`` (update) or
    ``narrow`` + ``cat`` (roll) of both planes."""
    kinds = ("count",)
    shape = f"{label} {what} C={C} B={B} n_ch=1 {cdt}"
    values = torch.tensor(rng.integers(0, 30, (1, C, B)).astype(np.float64),
                          device=dev)
    counts = values[0].to(cdt).contiguous()
    src, shift, n_src = None, 0, C
    if what == "update":
        n_src = int(C * 0.45)
        keep = np.sort(rng.choice(int(C * 0.48), n_src, replace=False))
        src_np = np.full(C, -1, np.int64)
        src_np[keep] = np.arange(n_src)
        src = torch.tensor(src_np, device=dev)
    else:
        shift = 4
    before = mesh_remap.launches
    v, c = mesh_remap(values, counts, src, shift, C, B, kinds)
    torch.cuda.synchronize()
    check(mesh_remap.launches == before + 1, f"mesh_remap launches ({shape})")
    wv, wc = mesh_remap_reference(values, counts, src, shift, C, B, kinds)
    check(torch.equal(v, wv) and torch.equal(c, wc),
          f"mesh_remap differs from its plain version ({shape})")
    if src is not None:
        idx, ok = src.clamp(min=0), (src >= 0)[:, None]

        def library():
            return (torch.where(ok, values[0].index_select(0, idx), 0.0),
                    torch.where(ok, counts.index_select(0, idx), 0))
        call = "index_select + where (both planes)"
    else:
        def library():
            return (torch.cat([values[0].narrow(1, shift, B - shift),
                               torch.zeros((C, shift), dtype=torch.float64,
                                           device=dev)], 1),
                    torch.cat([counts.narrow(1, shift, B - shift),
                               torch.zeros((C, shift), dtype=cdt,
                                           device=dev)], 1))
        call = "narrow + cat (both planes)"

    def kernel():
        return mesh_remap(values, counts, src, shift, C, B, kinds)

    ms, lib, turns = in_turns(kernel, library)
    plain = cuda_ms(lambda: mesh_remap_reference(values, counts, src, shift,
                                                 C, B, kinds), reps=5)
    meas = measured(kernel, "mesh_remap")
    check(meas["allocations_per_call"] == 1 and meas["syncs_per_call"] == 0,
          f"mesh_remap made {meas['allocations_per_call']} allocations and "
          f"{meas['syncs_per_call']} host syncs ({shape})")
    cell = 8 + counts.element_size()
    read_cells = n_src * B if src is not None else C * (B - shift)
    nbytes = cell * (read_cells + C * B) + (8 * C if src is not None else 0)
    r = row("mesh_remap", KC_SOURCE, KC_REPLACES, shape, 0.0, ms, plain,
            nbytes, 0, lib, call)
    dev_warm, dev_cold = device_sum(meas)
    r.update(turns_ms=turns, library_turns=turn_factors(turns),
             bound_bytes=nbytes, device_us_warm_total=dev_warm,
             device_us_cold_total=dev_cold,
             library_device_us=profile_kernels(library), **meas)
    print(f"mesh_remap {shape}: " + json.dumps(
        {k: r[k] for k in ("ms", "library_ms", "plain_ms", "bound_ms",
                           "device_us_warm_total", "device_us_cold_total",
                           "device_us_per_call", "host_us_per_call",
                           "allocations_per_call", "syncs_per_call")}))
    return r


def mesh_cases(rng, dev):
    """The three mesh kernels at q5's mesh shapes, at 2^20 rows, and on
    the adversarial inputs: every row to one shard, the route rules'
    boundary hashes (both rules), all padding, a merge that fills C."""
    rows = [mesh_route_case(rng, dev, MESH_N, MESH_CELLS // MESH_NK,
                            "q5 hash")]
    for case, rule in (("one shard", RULE_MESH), ("boundary", RULE_MESH),
                       ("boundary", RULE_SHUFFLE), ("padding", RULE_MESH)):
        rows.append(mesh_route_case(rng, dev, MESH_N,
                                    0 if case == "padding" else MESH_N - 48,
                                    case, rule))
    rows.append(mesh_route_case(rng, dev, 1 << 20, (1 << 20) - (1 << 14),
                                "2^20 hash"))
    R = MESH_NK * MESH_N
    rows.append(mesh_merge_case(rng, dev, MESH_C, MESH_KEYS, R, MESH_NEW,
                                "q5 step"))
    rows.append(mesh_merge_case(rng, dev, 4_096, 3_600, R, MESH_NEW,
                                "fills C"))
    rows.append(mesh_merge_case(rng, dev, 1 << 20, 1 << 19, 1 << 20,
                                1 << 17, "2^20 rows"))
    for what in ("update", "roll"):
        rows.append(mesh_remap_case(rng, dev, MESH_C, MESH_B, what, "q5"))
    rows.append(mesh_remap_case(rng, dev, 1 << 20, MESH_B, "update",
                                "2^20 rows", torch.int64))
    return rows


def kernel_phase(parent=None):
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    rows = []
    for m, cdt in ((4096, torch.int32), (65536, torch.int32),
                   (65536, torch.int64)):
        rows.append(k1_case(rng, dev, ("count",), (0,), m, cdt, True,
                            f"q5 COUNT(*) C={C_Q5} B={B_Q5} m={m} "
                            f"unique {cdt}", parent=parent))
    for C, m, what in ((C_Q5, Q5_FLUSH, "q5 flush"),
                       (C_HOT, HOT_FLUSH, "hot items flush")):
        rows.append(k1_case(rng, dev, ("count",), (0,), m, torch.int32,
                            True, f"{what} COUNT(*) C={C} B={B_Q5} m={m} "
                            "unique int32", C=C, parent=parent,
                            caller=parent is not None))
    mixed = ("count", "sum", "sum", "count", "min", "max", "sum", "sum")
    rows.append(k1_case(rng, dev, mixed, (0,), 65536, torch.int32, False,
                        f"mixed sum/avg/count/min/max C={C_Q5} B={B_Q5} "
                        "m=65536 duplicates+padding +/-0.0 int32",
                        parent=parent))
    for kpad in (1, 8):
        for minmax in ("max", "min"):
            for cdt in (torch.int32, torch.int64):
                rows.append(k2_case(rng, dev, kpad, minmax, cdt, parent))
    rows.append(k2_case(rng, dev, 8, "max", torch.int32, parent, q5=True))
    k2_branches(rng, dev)
    # q8's tumbling fire: one live bin; the mixed fire: panes wrapping
    # the ring, bins 0 and 1 evicted; hot items' sliding fire: 5 live bins
    q8_bin = 8 * 5_000 + 3
    for cdt in (torch.int32, torch.int64):
        rows.append(k3_case(rng, dev, ("count",), (), C_Q8, B_Q8, 1, 1,
                            C_SLICE_Q8, cdt, (q8_bin, q8_bin, q8_bin),
                            f"q8 COUNT(*) C={C_Q8} B={B_Q8} W=1 k=1 "
                            f"c_slice={C_SLICE_Q8} {cdt}", parent))
        rows.append(k3_case(rng, dev, mixed, tuple(range(1, 8)), C_Q5, B_Q5,
                            5, 8, C_Q5, cdt,
                            (16 * 9 - 4, 16 * 9 - 2, 16 * 9 + 7),
                            f"mixed sum/avg/count/min/max C={C_Q5} B={B_Q5} "
                            f"W=5 k=8 {cdt}", parent))
    hot_bin = 16 * 50 + 6
    rows.append(k3_case(rng, dev, ("count",), (), C_HOT, B_HOT, W_HOT, 1,
                        C_SLICE_HOT, torch.int32,
                        (hot_bin, hot_bin, hot_bin + W_HOT - 1),
                        f"hot items COUNT(*) C={C_HOT} B={B_HOT} W={W_HOT} "
                        f"k=1 c_slice={C_SLICE_HOT} int32", parent))
    first_bin, lo, hi, k = HOP_FIRE
    rows.append(k16_case(dev, C_HOP, B_HOP, HOP_ROWS,
                         (first_bin, lo, hi, HOP_W, k), torch.int32,
                         f"long windows median fire C={C_HOP} B={B_HOP} "
                         f"W={HOP_W} k={k} rows={HOP_ROWS} int32", parent))
    for k in (1, 64):  # every span position live
        base = 1_024 * 7 + 900
        rows.append(k16_case(dev, C_RING_BIG, B_HOP, C_RING_BIG,
                             (base, base, base + k + HOP_W - 2, HOP_W, k),
                             torch.int32,
                             f"C={C_RING_BIG} B={B_HOP} W={HOP_W} k={k} "
                             f"rows={C_RING_BIG} int32", parent))
    rows += k16_edges(rng, dev, parent)
    rows.append(k4_case(rng, dev, ("count",), C_Q8, B_Q8, 8 * 5_000 + 3, 1,
                        C_SLICE_Q8, torch.int32,
                        f"q8 COUNT(*) C={C_Q8} B={B_Q8} 1 column "
                        f"rows={C_SLICE_Q8} int32", parent))
    rows.append(k4_case(rng, dev, ("count",), C_Q5, B_Q5, 16 * 9 + 2, 4,
                        C_Q5, torch.int32,
                        f"q5 COUNT(*) C={C_Q5} B={B_Q5} 4 columns "
                        f"rows={C_Q5} int32", parent))
    rows.append(k4_case(rng, dev, ("count",), C_HOT, B_HOT, 16 * 50 + 6, 1,
                        HOT_ROWS, torch.int32,
                        f"hot items COUNT(*) C={C_HOT} B={B_HOT} 1 column "
                        f"rows={HOT_ROWS} int32", parent))
    for cap in (16_384, RING_CAP):  # q8's rings, 60% resident, 20% delta
        n_res, m = int(cap * 0.6), int(cap * 0.2)
        for nf, ni, what in ((0, 0, "keys only"),
                             (2, 6, "q8 payload nf=2 ni=6")):
            rows.append(k5_case(rng, dev, cap, n_res, m, nf, ni,
                                f"{what} cap={cap} n_res={n_res} m={m}",
                                parent))
    for cap, n_res, m, what in (
            (JS_RING_CAP, JS_RING_ROWS, JS_M, "join-stress 8a merge"),
            (JS_B_MERGE_CAP, JS_B_MERGE_ROWS, JS_B_MERGE_M,
             "join-stress 8b merge")):
        rows.append(k5_case(rng, dev, cap, n_res, m, 0, 3,
                            f"{what} cap={cap} n_res={n_res} m={m} nf=0 "
                            "ni=3", parent))
    rows.append(k6_case(rng, dev, RING_CAP, 2, 6, 5_000,
                        f"q8 payload nf=2 ni=6 cap={RING_CAP} m=5000"))
    rows.append(k7_case(rng, dev, 192, 128, "n=192 keys=128 (config5 "
                        "merge)", parent, config5=True))
    for n, n_keys in ((256, 64), (256, 1), (65_536, 4_096), (65_536, 1),
                      (1_048_576, 65_536), (1_048_576, 1)):
        rows.append(k7_case(rng, dev, n, n_keys, f"n={n} keys={n_keys}",
                            parent))
    mixed7 = ("sum", "min", "max", "count", "sum", "min", "max")
    for n, n_seg, kinds, what in (
            (8_192, 256, ("count",), "config5 fire COUNT(*)"),
            (200_000, 2_048, ("count",), "config5 final flush COUNT(*)"),
            (1_048_576, 65_536, mixed7, "mixed sum/min/max/count k=7"),
            (1_048_576, 1, mixed7, "one skewed segment k=7")):
        rows.append(k8_case(rng, dev, n, n_seg, kinds,
                            f"{what} n={n} n_seg={n_seg}", parent))
    empty_segments(dev)
    for cap, n_valid, mq, m, span, what in (
            (JS_RING_CAP, JS_RING_ROWS, JS_MQ, JS_M, JS_KEYS,
             "join-stress 8a partition probe"),
            (JS_B_RING_CAP, JS_B_RING_ROWS, JS_B_MQ, JS_B_M, JS_KEYS,
             "join-stress 8b partition probe"),
            (1 << 20, 1 << 20, 512, 1, 1, "one query spanning 2^20 rows")):
        rows += join_cases(rng, dev, cap, n_valid, mq, m, span, 3,
                           f"{what} cap={cap} n_valid={n_valid} mq={mq} "
                           f"m={m} ni=3", parent,
                           callers=what.startswith("join-stress"),
                           hit_caller=what.startswith("join-stress 8b"))
    for n, n_seg, what in ((TOPK_STEADY, 1, "hot items steady fire"),
                           (TOPK_FLUSH, 5, "hot items final flush")):
        rows.append(topk_case(rng, dev, n, n_seg,
                              f"{what} n={n} n_seg={n_seg} k={TOP_K}"))
    for k in (1, 5):
        rows += compact_cases(rng, dev, k, 3_000_000,
                              f"hot items COUNT(*) C={C_HOT} B={B_HOT} "
                              f"W={W_HOT} k={k} rows=3000000 int32", parent)
    rows += legacy_kernel_cases(rng, dev, parent)
    rows += mesh_cases(rng, dev)
    return rows


# -- phase 4: KeyedBinState over the nexmark stream ------------------------------------


def q5_batches(event_rate):
    """(key hashes, timestamps, watermark) per batch of bids, as q5's
    ingest path feeds its sliding aggregate."""
    cfg = NexmarkConfig(num_events=NUM_EVENTS, rate_limited=False,
                        event_rate=event_rate, batch_size=BATCH,
                        projection=["bid_auction", "bid_datetime",
                                    "event_type"])
    first, n, num = make_splits(cfg, 0, 1)[0]
    gen = NexmarkGenerator(cfg, 0, first, n, num, seed=0)
    gen.set_rate(cfg.event_rate, 1)
    max_ts = None
    while gen.has_next:
        b, _ = gen.next_batch(BATCH)
        bid = b.columns["event_type"] == EVENT_BID
        ts = b.timestamp[bid]
        max_ts = int(ts.max()) if max_ts is None else max(max_ts,
                                                          int(ts.max()))
        yield (hash_columns([b.columns["bid_auction"][bid]]), ts,
               max_ts - 1_000)


def new_state(device):
    st = KeyedBinState((AggSpec(AggKind.COUNT, None, "__agg0"),),
                       SLIDE_MICROS, WIDTH_MICROS, device=device)
    st.set_argmax_local("__agg0", "max")
    return st


def same_fire(a, b, what):
    if a is None or b is None:
        check(a is None and b is None, f"{what}: one side fired nothing")
        return 0
    for x, y, name in zip(a, b, ("keys", "cols", "window_end", "counts")):
        if name == "cols":
            check(x.keys() == y.keys(), f"{what}: columns differ")
            for k in x:
                check(np.array_equal(x[k], y[k]), f"{what}: {k} differs")
        else:
            check(np.array_equal(x, y), f"{what}: {name} differs")
    return len(a[0])


def state_phase():
    # 100k events/s spreads the 2M events over 20 s of event time, so
    # panes fire all along the stream, not only at the final flush
    batches = list(q5_batches(event_rate=100_000.0))
    bin_update.launches = argmax_fire.launches = 0
    t0 = time.perf_counter()
    gpu, cpu = new_state("cuda"), new_state("cpu")
    restored = None
    fired = 0
    half = len(batches) // 2
    for i, (kh, ts, wm) in enumerate(batches):
        if i == half:
            snap = gpu.snapshot()
            restored = new_state("cuda")
            restored.restore(snap)
        for st in (gpu, cpu) + ((restored,) if restored else ()):
            st.update(kh, ts, {})
        fires = [st.fire_panes(wm) for st in (gpu, cpu)
                 + ((restored,) if restored else ())]
        fired += same_fire(fires[0], fires[1], f"batch {i} card vs cpu")
        if restored is not None:
            same_fire(fires[0], fires[2], f"batch {i} card vs restored")
    snaps = [gpu.snapshot(), cpu.snapshot(), restored.snapshot()]
    for other in snaps[1:]:
        check(snaps[0].keys() == other.keys(), "snapshot keys differ")
        for k in snaps[0]:
            check(np.array_equal(snaps[0][k], other[k]),
                  f"snapshot array {k} differs")
    finals = [st.fire_panes(0, final=True) for st in (gpu, cpu, restored)]
    fired += same_fire(finals[0], finals[1], "final card vs cpu")
    same_fire(finals[0], finals[2], "final card vs restored")
    check(bin_update.launches > 0 and argmax_fire.launches > 0,
          "state phase did not launch both kernels")
    print(f"state: {len(batches)} batches, C={gpu.C} B={gpu.B} "
          f"keys={gpu.next_slot}, {fired} rows fired, identical on card, "
          f"cpu and card-restored; launches bin_update={bin_update.launches}"
          f" argmax_fire={argmax_fire.launches}; "
          f"{time.perf_counter() - t0:.2f} s")


# -- phase 5: main path --------------------------------------------------------------


def flushing(run, *args):
    """``run(*args)`` with the cells of every keyed-bin flush recorded and
    the perf counters reset first: (its result, the flush sizes, the
    flushes' uploads and blocking uploads, the compact fires' uploads and
    blocking uploads, the argmax fires' uploads, blocking uploads,
    readbacks and overflows)."""
    sizes = []
    dispatch = KeyedBinState._dispatch_cells

    def recorded(self, slots_c, *rest):
        sizes.append(len(slots_c))
        return dispatch(self, slots_c, *rest)

    KeyedBinState._dispatch_cells = recorded
    perf.reset()
    try:
        out = run(*args)
    finally:
        KeyedBinState._dispatch_cells = dispatch
    counts = {k: perf.counter(k) for k in (
        "pane_update_dispatches", "bin_flush_uploads",
        "bin_flush_blocking_uploads", "bin_compact_fire_uploads",
        "bin_compact_fire_blocking_uploads", "bin_argmax_fire_uploads",
        "bin_argmax_fire_blocking_uploads", "bin_argmax_fire_readbacks",
        "bin_argmax_fire_overflows")}
    check(len(sizes) == counts["pane_update_dispatches"]
          == counts["bin_flush_uploads"]
          and counts["bin_flush_blocking_uploads"] == 0
          and counts["bin_compact_fire_blocking_uploads"] == 0
          and counts["bin_argmax_fire_blocking_uploads"] == 0,
          f"keyed-bin flushes: {len(sizes)} recorded, {counts}")
    return out, sizes, counts


def flush_summary(sizes, counts):
    return {"flushes": len(sizes), "cells_min": min(sizes, default=0),
            "cells_median": statistics.median(sizes) if sizes else 0,
            "cells_max": max(sizes, default=0), "cells": sizes, **counts}


def operators(runner):
    """(operator id, operator) of every operator a run built, chained or
    not."""
    return [(op_id, op) for (op_id, _idx), (op, _ctx)
            in runner.engine.members.items()]


def _pin(text, batch):
    """``text`` with the nexmark event-time origin pinned to 0, as the
    hand-built programs are run."""
    return text.replace(f"batch_size = '{batch}'",
                        f"batch_size = '{batch}', base_time_micros = '0'")


def sql_text(query, num_events, broker="bench5"):
    """The SQL of ``query`` at ``num_events`` (queries.py, bench.py's)."""
    if query == "config5":
        return queries.CONFIG5_SQL.format(n=num_events, b=C5_BATCH).replace(
            "memory://bench5", f"memory://{broker}")
    if query == "hot_items":
        return _pin(hot_items_sql(num_events, BATCH), BATCH)
    return _pin(queries.QUERIES[query].format(n=num_events, b=BATCH), BATCH)


PLAN_MS = {}  # query -> parse + plan host ms of its last SQL plan


def program_for(query, num_events, sink, sql=False, broker=None):
    """The hand-built program of ``query`` or (``sql``) the port's plan of
    its SQL, writing to the memory sink ``sink``."""
    if not sql:
        return {
            "q1": lambda: q1_program(num_events, BATCH, sink,
                                     base_time_micros=0),
            "q5": lambda: q5_program(num_events, BATCH, sink,
                                     base_time_micros=0),
            "q7": lambda: q7_program(num_events, BATCH, sink,
                                     base_time_micros=0),
            "q8": lambda: q8_program(num_events, BATCH, sink,
                                     base_time_micros=0),
            "hot_items": lambda: hot_items_program(
                num_events, BATCH, sink=sink, base_time_micros=0),
            "config5": lambda: config5_program(num_events, C5_BATCH, sink,
                                               broker=broker),
        }[query]()
    text = sql_text(query, num_events, broker)
    t0 = time.perf_counter()
    program = plan_sql(text)
    PLAN_MS[query] = (time.perf_counter() - t0) * 1e3
    for node in program.nodes():
        if node.operator.kind == OpKind.CONNECTOR_SINK:
            node.operator.spec.config["name"] = sink
    return program


def plan_signature(program):
    """The nodes in topological order — name, kind, key columns,
    parallelism, spec, expression return type, inputs by position — so a
    hand-built program compares with a planned one whatever their ids."""
    order = program.topo_order()
    pos = {nid: i for i, nid in enumerate(order)}
    out = []
    for nid in order:
        node = program.node(nid)
        op = node.operator
        ins = sorted((pos[s], e.typ.value, e.key_schema)
                     for s, _, e in program.graph.in_edges(nid))
        spec = op.spec
        if op.kind in (OpKind.CONNECTOR_SOURCE, OpKind.CONNECTOR_SINK):
            # a CREATE TABLE sink also carries its (unused) format
            spec = (spec.connector, {k: v for k, v in spec.config.items()
                                     if k != "format"
                                     or op.kind == OpKind.CONNECTOR_SOURCE})
        out.append((op.name, op.kind.value, op.key_cols, node.parallelism,
                    node.max_parallelism, repr(spec),
                    op.expr.return_type.value if op.expr else None, ins))
    return out


def run_program(program, device):
    """``program`` through LocalRunner; (wall s, the runner)."""
    runner = LocalRunner(program, device=device)
    t0 = time.perf_counter()
    runner.run()
    if device != "cpu":
        torch.cuda.synchronize()
    return time.perf_counter() - t0, runner


def run_q5(sink, device, sql=False):
    """q5, hand-built or (``sql``) planned from bench.py's text; (wall s,
    sorted rows, number of runners)."""
    clear_sink(sink)
    dt, runner = run_program(program_for("q5", NUM_EVENTS, sink, sql),
                             device)
    rows = sorted(
        (int(b.timestamp[i]), int(b.columns["auction"][i]),
         int(b.columns["num"][i]))
        for b in sink_output(sink) for i in range(len(b)))
    return dt, rows, len(runner.engine.subtasks)


def main_path():
    run_q5("smoke-warm", None)  # CUDA context, allocator, library load
    reset_launches()
    (dt, rows, tasks), sizes, counts = flushing(run_q5, "smoke-cuda",
                                                None)  # the card
    launches = read_launches()
    HAND["q5"] = (rows, launches, dt)
    check(counts["pane_update_dispatches"] == launches["bin_update"],
          f"q5: {counts} against {launches['bin_update']} launches")
    # an argmax fire: one pinned upload, one launch, one readback (and
    # one of each more when its candidates overflow the buffer)
    fires = counts["bin_argmax_fire_uploads"]
    over = counts["bin_argmax_fire_overflows"]
    check(fires > 0 and launches["argmax_fire"] == fires + over
          and counts["bin_argmax_fire_readbacks"] == fires + over
          and counts["bin_argmax_fire_blocking_uploads"] == 0,
          f"q5 argmax fires: {counts} against {launches['argmax_fire']} "
          "launches")
    # device-time share: the same run with every kernel call synchronized
    # (ARROYO_TIMING=1 serializes dispatch, so it is timed apart)
    os.environ["ARROYO_TIMING"] = "1"
    perf.reset()
    try:
        dt_timed, rows_timed, _ = run_q5("smoke-timed", None)
    finally:
        del os.environ["ARROYO_TIMING"]
    device_s = perf.counter("device_ns") / 1e9
    check(rows_timed == rows, "q5 rows differ under ARROYO_TIMING")
    dt_cpu, rows_cpu, _ = run_q5("smoke-cpu", "cpu")
    check(rows, "q5 emitted no rows on the card")
    check(rows == rows_cpu, "q5 rows differ between card and cpu")
    # the JAX package's escape hatches: one runner per operator, no input
    # coalescing
    os.environ.update(ARROYO_CHAIN="0", ARROYO_COALESCE="0")
    try:
        dt_unchained, rows_unchained, tasks_unchained = run_q5(
            "smoke-unchained", None)
    finally:
        del os.environ["ARROYO_CHAIN"], os.environ["ARROYO_COALESCE"]
    check(rows_unchained == rows, "q5 rows differ between the chained, "
          "coalesced run and ARROYO_CHAIN=0 ARROYO_COALESCE=0")
    check(all(launches[k] > 0 for k in ("bin_update", "argmax_fire",
                                         "bin_evict")),
          f"q5 main path did not launch every kernel: {launches}")
    print("q5 main path: " + json.dumps({
        "events": NUM_EVENTS, "batch": BATCH, "wall_s": dt,
        "events_per_s": NUM_EVENTS / dt, "rows": len(rows),
        "launches": launches, "cpu_wall_s": dt_cpu,
        "timed_wall_s": dt_timed, "timed_device_s": device_s,
        "device_share": device_s / dt_timed,
        "kernel_dispatches": perf.counter("kernel_dispatches"),
        "tasks": tasks, "unchained_tasks": tasks_unchained,
        "unchained_wall_s": dt_unchained,
        "unchained_events_per_s": NUM_EVENTS / dt_unchained,
        "flush": flush_summary(sizes, counts)}))
    return launches


# -- phase 6: q8 ---------------------------------------------------------------------


def q8_table(batches, cols=("id", "np", "na")):
    """Sink rows as an int64 [n, 1 + len(cols)] array (ts, cols), sorted."""
    if not batches:
        return np.zeros((0, 1 + len(cols)), dtype=np.int64)
    t = np.stack([np.concatenate([b.timestamp for b in batches])]
                 + [np.concatenate([b.columns[c] for b in batches])
                    for c in cols], axis=1).astype(np.int64)
    return t[np.lexsort(t.T[::-1])]


# the sides of q8 (persons by id, auctions by seller) and of MW_BIDDERS
# (those and bids by bidder): event type, key column
WINDOW_SIDES = ((EVENT_PERSON, "person_id"),
                (EVENT_AUCTION, "auction_seller"), (EVENT_BID, "bid_bidder"))


def q8_control(num_events, n_sides=2):
    """q8 (``n_sides`` 2) or MW_BIDDERS (3) in numpy from the port's
    generator: per-(key, 10 s window) counts of each side, inner-joined on
    (window, key), one row (window end - 1, key, the counts) a match."""
    sides = WINDOW_SIDES[:n_sides]
    cfg = NexmarkConfig(num_events=num_events, rate_limited=False,
                        event_rate=1_000_000.0, batch_size=BATCH,
                        projection=sorted([c for _e, c in sides]
                                          + ["event_type"]))
    first, n, num = make_splits(cfg, 0, 1)[0]
    gen = NexmarkGenerator(cfg, 0, first, n, num, seed=0)
    gen.set_rate(cfg.event_rate, 1)
    codes = {etype: [] for etype, _c in sides}
    while gen.has_next:
        b, _ = gen.next_batch(BATCH)
        et = b.columns["event_type"]
        for etype, col in sides:
            sel = et == etype
            # (window, key) as window * 2^40 + key: ids stay below 2^40
            codes[etype].append((b.timestamp[sel] // Q8_WIDTH << 40)
                                + b.columns[col][sel].astype(np.int64))
    (pk, pc), *rest = (np.unique(np.concatenate(codes[e]),
                                 return_counts=True) for e, _c in sides)
    hit = np.ones(len(pk), dtype=bool)
    at = []
    for k, _c in rest:
        i = np.minimum(np.searchsorted(k, pk), len(k) - 1)
        hit &= k[i] == pk
        at.append(i)
    t = np.stack([((pk[hit] >> 40) + 1) * Q8_WIDTH - 1,
                  pk[hit] & ((1 << 40) - 1), pc[hit]]
                 + [c[i[hit]] for (_k, c), i in zip(rest, at)],
                 axis=1).astype(np.int64)
    return t[np.lexsort(t.T[::-1])]


def run_q8(num_events, sink, device, sql=False):
    """q8 through LocalRunner; returns (wall s, sorted rows, state shape)."""
    clear_sink(sink)
    dt, runner = run_program(program_for("q8", num_events, sink, sql),
                             device)
    shape = {}
    for op_id, op in operators(runner):
        st = getattr(op, "state", None)
        if st is not None:
            shape[op_id] = {
                "C": st.C, "B": st.B, "keys": st.next_slot,
                "counts_bytes": st.counts.numel() * st.counts.element_size(),
                "values_bytes": st.values.numel() * 8}
        if hasattr(getattr(op, "left", None), "stats"):  # partitioned
            shape[op_id] = {"left": op.left.stats(),
                            "right": op.right.stats()}
    rows = q8_table(sink_output(sink))
    clear_sink(sink)
    return dt, rows, shape


Q8_COUNTERS = ("join_state_promotions", "join_state_device_merges",
               "join_state_ring_regrows", "join_device_gather_rows",
               "join_host_gather_rows", "join_ring_probes",
               "join_probe_readbacks", "join_probe_overflows",
               "join_blocking_uploads", "kernel_dispatches")


def q8_phase():
    t0 = time.perf_counter()
    control = q8_control(Q8_EVENTS)
    control_s = time.perf_counter() - t0
    CONTROLS["q8"] = control
    perf.reset()
    reset_launches()
    dt, rows, shape = run_q8(Q8_EVENTS, "q8-cuda", None)  # the card
    launches = read_launches()
    counters = {k: perf.counter(k) for k in Q8_COUNTERS}
    check(len(rows) > 0, "q8 emitted no rows on the card")
    check(rows.shape == control.shape and np.array_equal(rows, control),
          f"q8 rows differ from the numpy control ({len(rows)} vs "
          f"{len(control)})")
    CONTROLS["q8_rows"] = rows
    check(all(launches[k] > 0 for k in ("bin_update", "pane_emit",
                                         "bin_evict", "ring_merge",
                                         "ring_gather")),
          f"q8 main path did not launch every kernel: {launches}")
    hot = sum(side["hot_partitions"] for st in shape.values()
              for side in (st.get("left"), st.get("right")) if side)
    check(counters["join_state_promotions"] > 0 and hot > 0,
          "q8 ended with no hot join partition")
    check(counters["join_device_gather_rows"] > 0,
          "q8 gathered no rows from a device ring")
    os.environ["ARROYO_TIMING"] = "1"
    perf.reset()
    try:
        dt_timed, rows_timed, _ = run_q8(Q8_EVENTS, "q8-timed", None)
    finally:
        del os.environ["ARROYO_TIMING"]
    device_s = perf.counter("device_ns") / 1e9
    check(np.array_equal(rows_timed, rows), "q8 rows differ under "
          "ARROYO_TIMING")
    dt_cpu, rows_cpu, _ = run_q8(Q8_EVENTS, "q8-cpu", "cpu")
    check(np.array_equal(rows_cpu, rows), "q8 rows differ between card "
          "and cpu")
    reset_launches()
    dt_small, small, _ = run_q8(Q8_SMALL, "q8-small-cuda", None)
    HAND["q8"] = (small, read_launches(), dt_small)
    dt_small_cpu, small_cpu, _ = run_q8(Q8_SMALL, "q8-small-cpu", "cpu")
    check(len(small) > 0 and np.array_equal(small, small_cpu),
          "q8 rows at 2M events differ between card and cpu")
    print("q8 main path: " + json.dumps({
        "events": Q8_EVENTS, "batch": BATCH, "wall_s": dt,
        "events_per_s": Q8_EVENTS / dt, "rows": len(rows),
        "control_rows": len(control), "control_s": control_s,
        "launches": launches, "counters": counters, "state": shape,
        "cpu_wall_s": dt_cpu,
        "timed_wall_s": dt_timed, "timed_device_s": device_s,
        "device_share": device_s / dt_timed,
        "small_events": Q8_SMALL, "small_rows": len(small),
        "small_wall_s": dt_small, "small_cpu_wall_s": dt_small_cpu}))
    return launches


# -- phase 7: config5 -----------------------------------------------------------------

C5_COLS = ("k", "med", "cnt", "window_start", "window_end")
C5_COUNTERS = ("session_merge_dispatches", "session_merge_device_dispatches",
               "session_device_merge_rows", "session_host_merge_rows",
               "udaf_channel_rows", "kernel_dispatches",
               "session_union_uploads", "session_union_readbacks",
               "session_union_blocking_uploads")


def c5_table(batches):
    """Sink rows as sorted (ts, k, med, cnt, window_start, window_end)."""
    rows = []
    for b in batches:
        rows.extend(zip(b.timestamp.tolist(),
                        *(b.columns[c].tolist() for c in C5_COLS)))
    return sorted(rows)


def c5_control(num_events):
    """config5 in numpy from the producer's events: each key lives in
    one burst block (its events 640 us apart, far inside the 1 s gap), so
    it has one session: first event, last event + gap, count, median."""
    keys, vals, ts = config5_events(num_events, 0, C5_SPACING)
    t = ts // 1000  # from_unixtime: ns -> us
    order = np.argsort(keys, kind="stable")
    k_s, v_s, t_s = keys[order], vals[order], t[order]
    uniq, first, counts = np.unique(k_s, return_index=True,
                                    return_counts=True)
    start = np.minimum.reduceat(t_s, first)
    end = np.maximum.reduceat(t_s, first) + GAP_MICROS
    med = [float(np.median(v_s[a:a + c])) for a, c in zip(first, counts)]
    return sorted(zip((end - 1).tolist(), uniq.tolist(), med,
                      counts.tolist(), start.tolist(), end.tolist()))


def run_c5(num_events, broker, sink, device, sql=False):
    """config5 through LocalRunner with 1 s checkpoints; returns (wall s,
    sorted rows, sink batches, fully completed checkpoint epochs)."""
    clear_sink(sink)
    runner = LocalRunner(program_for("config5", num_events, sink, sql,
                                     broker=broker), device=device)
    t0 = time.perf_counter()
    resps = runner.run(checkpoint_interval_secs=1.0)
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # an epoch is complete when every operator (every chain member)
    # reported it
    done = collections.Counter(r.subtask_metadata.epoch for r in resps
                               if r.kind == "checkpoint_completed")
    epochs = sorted(e for e, c in done.items()
                    if c == len(runner.engine.members))
    batches = sink_output(sink)
    rows = c5_table(batches)
    clear_sink(sink)
    return dt, rows, len(batches), epochs


def c5_phase():
    t0 = time.perf_counter()
    config5_produce("c5-big", C5_EVENTS, 0, C5_SPACING)
    produce_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    control = c5_control(C5_EVENTS)
    control_s = time.perf_counter() - t0
    CONTROLS["config5"] = control  # phase 16's config5 control
    sizes = []  # rows of each union call
    union = session_ops.session_union_buffer

    @functools.wraps(union)
    def recorded(kh, st, en):
        sizes.append(kh.shape[0])
        return union(kh, st, en)

    session_ops.session_union_buffer = recorded
    try:
        perf.reset()
        reset_launches()
        dt, rows, fires, epochs = run_c5(C5_EVENTS, "c5-big", "c5-cuda",
                                         None)
        launches = read_launches()
    finally:
        session_ops.session_union_buffer = union
    counters = {k: perf.counter(k) for k in C5_COUNTERS}
    state = aggregate_session_registry(
        perf.get_note("session_state_registry"))
    check(len(rows) > 0, "config5 emitted no rows on the card")
    check(rows == control, f"config5 rows differ from the numpy control "
          f"({len(rows)} vs {len(control)})")
    CONTROLS["config5_rows"] = rows  # phase 18's memory-sink rows
    check(launches["session_union"] > 0 and launches["segment_agg"] > 0,
          f"config5 main path did not launch both kernels: {launches}")
    check(counters["session_device_merge_rows"] > 0,
          "config5 merged no interval rows on the device")
    check(len(epochs) > 0, "config5 completed no checkpoint epoch")
    calls = launches["session_union"]
    check(len(sizes) == calls == counters["session_union_uploads"]
          == counters["session_union_readbacks"]
          and counters["session_union_blocking_uploads"] == 0,
          f"config5's unions: {len(sizes)} calls, {calls} launches, "
          f"{counters['session_union_uploads']} uploads, "
          f"{counters['session_union_readbacks']} readbacks, "
          f"{counters['session_union_blocking_uploads']} blocking uploads")
    union_n = {"calls": len(sizes), "rows": int(sum(sizes)),
               "min": min(sizes), "median": statistics.median(sizes),
               "max": max(sizes),
               "histogram": sorted(collections.Counter(sizes).items())}
    os.environ["ARROYO_TIMING"] = "1"
    perf.reset()
    try:
        dt_timed, rows_timed, _, _ = run_c5(C5_EVENTS, "c5-big", "c5-timed",
                                            None)
    finally:
        del os.environ["ARROYO_TIMING"]
    device_s = perf.counter("device_ns") / 1e9
    check(rows_timed == rows, "config5 rows differ under ARROYO_TIMING")
    config5_produce("c5-small", C5_SMALL, 0, C5_SPACING)
    reset_launches()
    dt_small, small, _, _ = run_c5(C5_SMALL, "c5-small", "c5-small-cuda",
                                   None)
    HAND["config5"] = (small, read_launches(), dt_small)
    dt_small_cpu, small_cpu, _, _ = run_c5(C5_SMALL, "c5-small",
                                           "c5-small-cpu", "cpu")
    check(len(small) > 0 and small == small_cpu,
          "config5 rows at 200k events differ between card and cpu")
    print("config5 main path: " + json.dumps({
        "events": C5_EVENTS, "batch": C5_BATCH, "wall_s": dt,
        "events_per_s": C5_EVENTS / dt, "sessions": len(rows),
        "fire_batches": fires, "control_sessions": len(control),
        "produce_s": produce_s, "control_s": control_s,
        "checkpoint_epochs": len(epochs), "completed_epochs": epochs,
        "launches": launches,
        "union_n": union_n,
        "counters": counters, "session_state": state,
        "timed_wall_s": dt_timed, "timed_device_s": device_s,
        "device_share": device_s / dt_timed,
        "small_events": C5_SMALL, "small_sessions": len(small),
        "small_wall_s": dt_small, "small_cpu_wall_s": dt_small_cpu}))
    return launches


# -- phase 8: join-stress ---------------------------------------------------------------

JS_COUNTERS = ("join_state_promotions", "join_state_demotions",
               "join_state_device_merges", "join_state_ring_regrows",
               "join_state_compactions", "join_device_gather_rows",
               "join_host_gather_rows", "join_ring_probes",
               "join_probe_readbacks", "join_probe_overflows",
               "join_blocking_uploads", "kernel_dispatches")


def js_codes(v0, v1):
    """One int64 per (left counter, right counter) pair; v1 = -1 (a NULL
    right side) codes as 0.  Counters stay below 2^21."""
    return (np.asarray(v0, np.int64) << 21) | (np.asarray(v1, np.int64) + 1)


def js_pairs(n, window):
    """Codes of every key-equal (left, right) counter pair with |c0 - c1|
    <= window (None: any distance), sorted; counters are event times in
    ms, as the impulse sources stamp them."""
    c = np.arange(n, dtype=np.int64)
    kl, kr = join_stress_keys(c, 0), join_stress_keys(c, 1)
    span = 4 * n + 4  # codes (key, counter) far enough apart per key
    rcode = np.sort(kr * span + c)  # right rows sorted by (key, counter)
    base = kl * span + c
    w = n if window is None else window
    lo = np.searchsorted(rcode, base - w, side="left")
    hi = np.searchsorted(rcode, base + w, side="right")
    counts = hi - lo
    li = np.repeat(c, counts)
    ri = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts,
                                                  counts)
    rc = rcode[np.repeat(lo, counts) + ri] % span
    codes = js_codes(li, rc)
    if window is None:  # LEFT: the unmatched left rows, NULL-padded
        codes = np.concatenate([codes, js_codes(c[counts == 0], -1)])
    return np.sort(codes)


def js_output(batches):
    """(codes of CREATE rows, codes of DELETE rows), each sorted, after
    checking every row is key-equal (k, and r_k where matched, equal to
    the keys the two counters get)."""
    creates, deletes = [], []
    for b in batches:
        n = len(b)
        v0 = b.columns["v0"].astype(np.int64)
        v1f = np.asarray(b.columns["v1"], np.float64)
        matched = ~np.isnan(v1f)
        v1 = np.where(matched, v1f, -1).astype(np.int64)
        k = np.asarray(b.columns["k"], np.int64)
        check(np.array_equal(k, join_stress_keys(v0, 0)),
              "join-stress: k is not the left counter's key")
        rk = np.asarray(b.columns["r_k"], np.float64)[matched]
        check(np.array_equal(rk.astype(np.int64), k[matched])
              and np.array_equal(join_stress_keys(v1[matched], 1),
                                 k[matched]),
              "join-stress: a joined row is not key-equal")
        op = b.columns.get("__op", np.zeros(n, np.int8))
        codes = js_codes(v0, v1)
        creates.append(codes[op == 0])
        deletes.append(codes[op == 2])
    cat = lambda xs: np.sort(np.concatenate(xs)) if xs else np.zeros(0, np.int64)  # noqa: E731
    return cat(creates), cat(deletes)


def run_js(n, how, ttl, sink, device):
    """Join-stress through LocalRunner; returns (wall s, create codes,
    delete codes, folded join-state registry)."""
    clear_sink(sink)
    perf.note("join_state_registry", {})
    runner = LocalRunner(join_stress_program(n, how, ttl, sink, JS_BATCH),
                         device=device)
    t0 = time.perf_counter()
    runner.run()
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    creates, deletes = js_output(sink_output(sink))
    clear_sink(sink)
    return dt, creates, deletes, aggregate_stats_registry(
        perf.get_note("join_state_registry"))


def js_variant(what, n, how, ttl, gate):
    """One variant on the card, launches and counters counted, then once
    more under ARROYO_TIMING=1; ``gate(creates, deletes)`` checks each
    run's rows.  Returns (result, launches, the first run's state); the
    first run's (creates, deletes) go to ``CONTROLS[what]``."""
    perf.reset()
    reset_launches()
    dt, creates, deletes, state = run_js(n, how, ttl, f"js-{what}", None)
    launches = read_launches()
    counters = {k: perf.counter(k) for k in JS_COUNTERS}
    CONTROLS[what] = (creates, deletes)
    res = {"events_per_side": n, "batch": JS_BATCH, "ttl_micros": ttl,
           "join": how.value, "wall_s": dt, "events_per_s": 2 * n / dt,
           "rows_created": len(creates), "rows_deleted": len(deletes),
           **gate(creates, deletes), "launches": launches,
           "counters": counters, "state": state,
           "readbacks_per_hot_probe": counters["join_probe_readbacks"]
           / max(counters["join_ring_probes"], 1)}
    os.environ["ARROYO_TIMING"] = "1"
    perf.reset()
    try:
        dt_timed, creates, deletes, _ = run_js(n, how, ttl, f"js-{what}-t",
                                               None)
    finally:
        del os.environ["ARROYO_TIMING"]
    gate(creates, deletes)
    device_s = perf.counter("device_ns") / 1e9
    res.update(timed_wall_s=dt_timed, timed_device_s=device_s,
               device_share=device_s / dt_timed,
               device_s_by_call={k.split(":", 1)[1]: v / 1e9 for k, v in
                                 perf.counters("device_ns:").items()})
    return res, launches, state


def js_phase():
    t0 = time.perf_counter()
    certain = js_pairs(JS_INNER, TTL_MICROS // INTERVAL_MICROS)
    left_join = js_pairs(JS_LEFT, None)
    control_s = time.perf_counter() - t0

    def gate_inner(creates, deletes):
        # a row's partner at most one TTL earlier is still live when the
        # row arrives: the join's watermark (the min over both sides) is
        # below the arriving batch's own times, so eviction at watermark
        # - TTL keeps it; pairs further apart may or may not be emitted
        check(len(deletes) == 0, "join-stress inner emitted DELETE rows")
        check(len(np.unique(creates)) == len(creates),
              "join-stress inner emitted a pair twice")
        missing = int((~np.isin(certain, creates)).sum())
        check(missing == 0, f"join-stress inner misses {missing} of "
              f"{len(certain)} certain pairs")
        return {"certain_pairs": len(certain),
                "beyond_ttl_rows": len(creates) - len(certain)}

    def gate_left(creates, deletes):
        uniq, cnt = np.unique(creates, return_counts=True)
        d_uniq, d_cnt = np.unique(deletes, return_counts=True)
        at = np.minimum(np.searchsorted(uniq, d_uniq), max(len(uniq) - 1, 0))
        check(np.array_equal(uniq[at], d_uniq),
              "join-stress left deleted a row it never created")
        cnt[at] -= d_cnt
        check(bool(np.all(cnt >= 0)), "join-stress left deleted a row twice")
        net = np.repeat(uniq, cnt)
        check(np.array_equal(net, left_join), f"join-stress left net rows "
              f"differ from the numpy LEFT JOIN ({len(net)} vs "
              f"{len(left_join)})")
        return {"net_rows": len(net), "control_rows": len(left_join)}

    CONTROLS["gate_inner"], CONTROLS["gate_left"] = gate_inner, gate_left
    res_a, la, state = js_variant("inner", JS_INNER, JoinType.INNER,
                                  TTL_MICROS, gate_inner)
    check(state_bounded(state, TTL_MICROS),
          f"join-stress inner state not bounded: {state}")
    res_a["state_bounded"] = True
    check(all(la[k] > 0 for k in ("join_probe", "expand_gather",
                                  "ring_merge")),
          f"join-stress inner did not launch its kernels: {la}")
    res_b, lb, _ = js_variant("left", JS_LEFT, JoinType.LEFT,
                              PLANNER_TTL_MICROS, gate_left)
    check(all(lb[k] > 0 for k in ("join_probe", "expand_gather",
                                  "join_expand", "ring_merge",
                                  "ring_gather")),
          f"join-stress left did not launch its kernels: {lb}")
    for what, res in (("inner", res_a), ("left", res_b)):
        # a hot probe reads back its expansion's buffer once, twice when
        # its pair total overflowed the capacity; no upload blocks
        c = res["counters"]
        check(c["join_ring_probes"] > 0 and c["join_probe_readbacks"]
              <= c["join_ring_probes"] + c["join_probe_overflows"],
              f"join-stress {what} made more than one device-to-host copy "
              f"a hot probe beyond its overflows: {c}")
        check(c["join_blocking_uploads"] == 0,
              f"join-stress {what} made blocking uploads: {c}")
        res["overflows_per_hot_probe"] = (c["join_probe_overflows"]
                                          / c["join_ring_probes"])
    print("join-stress path: " + json.dumps({
        "control_s": control_s, "inner": res_a, "left": res_b}))
    return la, lb


# -- phase 9: hot items -----------------------------------------------------------------


def hot_control(num_events):
    """Hot items in numpy from the port's generator: bids per (auction,
    window) of HOP(2 s, 10 s) for every window that holds a bid, as
    {window end: dense bid counts indexed by auction}."""
    cfg = NexmarkConfig(num_events=num_events, rate_limited=False,
                        event_rate=1_000_000.0, batch_size=BATCH,
                        projection=["bid_auction", "event_type"])
    first, n, num = make_splits(cfg, 0, 1)[0]
    gen = NexmarkGenerator(cfg, 0, first, n, num, seed=0)
    gen.set_rate(cfg.event_rate, 1)
    auctions, bins = [], []
    while gen.has_next:
        b, _ = gen.next_batch(BATCH)
        bid = b.columns["event_type"] == EVENT_BID
        auctions.append(b.columns["bid_auction"][bid])
        bins.append(b.timestamp[bid] // HOT_SLIDE)
    auctions, bins = np.concatenate(auctions), np.concatenate(bins)
    order = np.argsort(bins, kind="stable")
    auctions, bins = auctions[order], bins[order]
    n_auctions = int(auctions.max()) + 1
    lo, hi = int(bins[0]), int(bins[-1])
    per_bin = []
    for b in range(lo, hi + 1):
        a, z = np.searchsorted(bins, [b, b + 1])
        per_bin.append(np.bincount(auctions[a:z], minlength=n_auctions))
    w = HOT_WIDTH // HOT_SLIDE
    windows = {}
    for p in range(lo, hi + w):
        window = sum(per_bin[b - lo] for b in range(max(p - w + 1, lo),
                                                      min(p, hi) + 1))
        windows[(p + 1) * HOT_SLIDE] = window
    return windows


def hot_table(batches):
    """Sink rows as an int64 [n, 5] array (ts, auction, num,
    window_start, window_end), sorted."""
    cols = ("auction", "num", "window_start", "window_end")
    t = np.stack([np.concatenate([b.timestamp for b in batches])]
                 + [np.concatenate([b.columns[c] for b in batches])
                    for c in cols], axis=1).astype(np.int64)
    return t[np.lexsort(t.T[::-1])]


def hot_gate(rows, control):
    """At most TOP_K rows per window; each row's count is the control's;
    each window's counts are the control's top TOP_K, as a multiset."""
    check(np.array_equal(rows[:, 0], rows[:, 4] - 1)
          and np.array_equal(rows[:, 3], rows[:, 4] - HOT_WIDTH),
          "hot items: window columns or timestamps wrong")
    ends, starts = np.unique(rows[:, 4], return_index=True)
    check(set(ends.tolist()) == set(control),
          f"hot items: {len(ends)} windows emitted, the control has "
          f"{len(control)}")
    bounds = np.append(starts, len(rows))
    for i, e in enumerate(ends.tolist()):
        r = rows[bounds[i]:bounds[i + 1]]
        window = control[e]
        check(len(r) <= TOP_K, f"hot items: {len(r)} rows in window {e}")
        check(np.array_equal(r[:, 2], window[r[:, 1]]),
              f"hot items: a count in window {e} is not the control's")
        top = np.sort(np.partition(window, -TOP_K)[-TOP_K:])
        check(np.array_equal(np.sort(r[:, 2]), top[top > 0]),
              f"hot items: window {e} is not the control's top {TOP_K}")
    return len(ends)


def run_hot(num_events, sink, device, sql=False):
    """Hot items through LocalRunner; returns (wall s, sorted rows, the
    fused aggregate's state)."""
    clear_sink(sink)
    dt, runner = run_program(program_for("hot_items", num_events, sink, sql),
                             device)
    state = {}
    for _op_id, op in operators(runner):
        st = getattr(op, "state", None)
        if st is not None:
            state = {"C": st.C, "B": st.B, "keys": st.next_slot,
                     "counts_bytes": st.counts.numel()
                     * st.counts.element_size(),
                     "values_bytes": st.values.numel() * 8,
                     "last_fire_density": st._fire_density}
    rows = hot_table(sink_output(sink))
    clear_sink(sink)
    return dt, rows, state


def hot_phase():
    t0 = time.perf_counter()
    control = hot_control(HOT_EVENTS)
    control_s = time.perf_counter() - t0
    reset_launches()
    (dt, rows, state), sizes, counts = flushing(run_hot, HOT_EVENTS,
                                                "hot-cuda", None)  # the card
    launches = read_launches()
    check(counts["pane_update_dispatches"] == launches["bin_update"]
          and counts["bin_compact_fire_uploads"] == launches["emit_count"],
          f"hot items: flushes and compact fires {counts} against "
          f"launches {launches}")
    windows = hot_gate(rows, control)
    fires = launches["pane_emit"] + launches["emit_count"]
    check(launches["segment_top_k"] == fires > 0,
          f"hot items: segment_top_k launched {launches['segment_top_k']} "
          f"times over {fires} fires")
    check(all(launches[k] > 0 for k in ("bin_update", "bin_evict",
                                         "emit_count", "emit_gather")),
          f"hot items main path did not launch every kernel: {launches}")
    os.environ["ARROYO_TIMING"] = "1"
    perf.reset()
    try:
        dt_timed, rows_timed, _ = run_hot(HOT_EVENTS, "hot-timed", None)
    finally:
        del os.environ["ARROYO_TIMING"]
    device_s = perf.counter("device_ns") / 1e9
    check(np.array_equal(rows_timed, rows), "hot items rows differ under "
          "ARROYO_TIMING")
    reset_launches()
    dt_small, small, _ = run_hot(HOT_SMALL, "hot-small-cuda", None)
    HAND["hot_items"] = (small, read_launches(), dt_small)
    dt_small_cpu, small_cpu, _ = run_hot(HOT_SMALL, "hot-small-cpu", "cpu")
    check(len(small) > 0 and np.array_equal(small, small_cpu),
          "hot items rows at 2M events differ between card and cpu")
    os.environ["ARROYO_EMIT_COMPACT"] = "on"
    compact_before = emit_count.launches
    try:
        _, small_on, _ = run_hot(HOT_SMALL, "hot-small-on", None)
    finally:
        del os.environ["ARROYO_EMIT_COMPACT"]
    check(emit_count.launches > compact_before
          and np.array_equal(small_on, small),
          "hot items rows at 2M events differ under ARROYO_EMIT_COMPACT=on")
    print("hot-items path: " + json.dumps({
        "events": HOT_EVENTS, "batch": BATCH, "wall_s": dt,
        "events_per_s": HOT_EVENTS / dt, "rows": len(rows),
        "windows": windows, "fires": fires, "control_s": control_s,
        "launches": launches, "state": state,
        "flush": flush_summary(sizes, counts),
        "timed_wall_s": dt_timed, "timed_device_s": device_s,
        "device_share": device_s / dt_timed,
        "small_events": HOT_SMALL, "small_rows": len(small),
        "small_wall_s": dt_small, "small_cpu_wall_s": dt_small_cpu}))
    return launches


# -- phases 10 and 11: q1 and q7 ----------------------------------------------------------

Q7_COUNTERS = ("window_argmax_late_rows", "window_argmax_late_hits")


def nexmark_bids(num_events, extra=(), event_rate=1_000_000.0, batch=BATCH):
    """The bids of the port's generator (at bench.py's rate and batch
    unless told), as the q1 and q7 programs read them, and the ``extra``
    bid columns: {column: array}."""
    names = ["bid_auction", "bid_bidder", "bid_datetime", "bid_price",
             *extra]
    cfg = NexmarkConfig(num_events=num_events, rate_limited=False,
                        event_rate=event_rate, batch_size=batch,
                        projection=names + ["event_type"])
    first, n, num = make_splits(cfg, 0, 1)[0]
    gen = NexmarkGenerator(cfg, 0, first, n, num, seed=0)
    gen.set_rate(cfg.event_rate, 1)
    parts = collections.defaultdict(list)
    while gen.has_next:
        b, _ = gen.next_batch(batch)
        bid = b.columns["event_type"] == EVENT_BID
        parts["ts"].append(b.timestamp[bid])
        for c in names:
            parts[c].append(b.columns[c][bid])
    return {c: np.concatenate(v) for c, v in parts.items()}


def sorted_columns(cols, order_by):
    """``cols`` ({name: array}) sorted by the ``order_by`` names, the
    first the primary key."""
    order = np.lexsort([cols[c] for c in reversed(order_by)])
    return {c: v[order] for c, v in cols.items()}


def same_columns(a, b):
    return a.keys() == b.keys() and all(
        a[c].shape == b[c].shape and np.array_equal(a[c], b[c]) for c in a)


def sink_columns(sink, names):
    batches = sink_output(sink)
    cols = {"ts": np.concatenate([b.timestamp for b in batches])}
    for c in names:
        cols[c] = np.concatenate([b.columns[c] for b in batches])
    clear_sink(sink)
    return cols


Q1_COLS = ("auction", "bidder", "price_dol", "datetime")


def q1_control(num_events):
    """bench.py's control_q1 as rows: every bid, its price * 0.908."""
    bids = nexmark_bids(num_events)
    return sorted_columns({
        "ts": bids["ts"], "auction": bids["bid_auction"],
        "bidder": bids["bid_bidder"],
        "price_dol": bids["bid_price"] * 0.908,
        "datetime": bids["bid_datetime"]}, ("ts",) + Q1_COLS)


def run_q1(num_events, sink, device, sql=False):
    """q1; (wall s, sorted sink columns, number of runners)."""
    clear_sink(sink)
    dt, runner = run_program(program_for("q1", num_events, sink, sql),
                             device)
    return (dt, sorted_columns(sink_columns(sink, Q1_COLS),
                               ("ts",) + Q1_COLS),
            len(runner.engine.subtasks))


def q1_phase():
    t0 = time.perf_counter()
    control = q1_control(NUM_EVENTS)
    control_s = time.perf_counter() - t0
    reset_launches()
    dt, cols, tasks = run_q1(NUM_EVENTS, "q1-cuda", None)  # the card
    launches = read_launches()
    HAND["q1"] = (cols, launches, dt)
    check(len(cols["ts"]) > 0 and same_columns(cols, control),
          f"q1 rows differ from the numpy control ({len(cols['ts'])} vs "
          f"{len(control['ts'])})")
    dt_cpu, cols_cpu, _ = run_q1(NUM_EVENTS, "q1-cpu", "cpu")
    check(same_columns(cols_cpu, cols), "q1 rows differ between card and "
          "cpu")
    os.environ["ARROYO_CHAIN"] = "0"
    try:
        dt_unchained, cols_unchained, tasks_unchained = run_q1(
            NUM_EVENTS, "q1-unchained", None)
    finally:
        del os.environ["ARROYO_CHAIN"]
    check(same_columns(cols_unchained, cols), "q1 rows differ under "
          "ARROYO_CHAIN=0")
    print("q1 path: " + json.dumps({
        "events": NUM_EVENTS, "batch": BATCH, "wall_s": dt,
        "events_per_s": NUM_EVENTS / dt, "rows": len(cols["ts"]),
        "control_s": control_s, "launches": launches, "tasks": tasks,
        "cpu_wall_s": dt_cpu, "unchained_tasks": tasks_unchained,
        "unchained_wall_s": dt_unchained,
        "unchained_events_per_s": NUM_EVENTS / dt_unchained}))
    return launches


Q7_COLS = ("auction", "price", "bidder")


def q7_control(num_events):
    """bench.py's control_q7 as rows: every bid whose price equals its
    10 s tumbling window's max, stamped window end - 1."""
    bids = nexmark_bids(num_events)
    price = bids["bid_price"]
    wend = (bids["ts"] // Q7_WIDTH + 1) * Q7_WIDTH
    ends, inv = np.unique(wend, return_inverse=True)
    best = np.full(len(ends), np.iinfo(np.int64).min, dtype=np.int64)
    np.maximum.at(best, inv, price)
    hit = price == best[inv]
    return sorted_columns({
        "ts": wend[hit] - 1, "auction": bids["bid_auction"][hit],
        "price": price[hit], "bidder": bids["bid_bidder"][hit]},
        ("ts",) + Q7_COLS)


def run_q7(num_events, sink, device, sql=False):
    """q7; (wall s, sorted sink columns, number of runners)."""
    clear_sink(sink)
    dt, runner = run_program(program_for("q7", num_events, sink, sql),
                             device)
    return (dt, sorted_columns(sink_columns(sink, Q7_COLS),
                               ("ts",) + Q7_COLS),
            len(runner.engine.subtasks))


def q7_phase():
    out = {}
    launches = None
    for n in (NUM_EVENTS, Q7_EVENTS):
        t0 = time.perf_counter()
        control = q7_control(n)
        control_s = time.perf_counter() - t0
        perf.reset()
        reset_launches()
        dt, cols, tasks = run_q7(n, f"q7-cuda-{n}", None)  # the card
        got = read_launches()
        if n == NUM_EVENTS:
            HAND["q7"] = (cols, got, dt)
        launches = (got if launches is None
                    else {k: launches[k] + v for k, v in got.items()})
        counters = {k: perf.counter(k) for k in Q7_COUNTERS}
        windows = len(np.unique(cols["ts"]))
        check(len(cols["ts"]) > 0 and same_columns(cols, control),
              f"q7 at {n} events: rows differ from the numpy control "
              f"({len(cols['ts'])} vs {len(control['ts'])}; late path "
              f"{counters})")
        entry = {"events": n, "wall_s": dt, "events_per_s": n / dt,
                 "rows": len(cols["ts"]), "windows": windows,
                 "control_s": control_s, "tasks": tasks, **counters}
        if n == NUM_EVENTS:
            dt_cpu, cols_cpu, _ = run_q7(n, "q7-cpu", "cpu")
            check(same_columns(cols_cpu, cols), "q7 rows differ between "
                  "card and cpu")
            entry["cpu_wall_s"] = dt_cpu
        out[str(n)] = entry
    check(out[str(Q7_EVENTS)]["windows"] == 4,
          f"q7 at {Q7_EVENTS} events: {out[str(Q7_EVENTS)]['windows']} "
          "windows, expected 4")
    print("q7 path: " + json.dumps({"batch": BATCH, "launches": launches,
                                    "runs": out}))
    return launches


# -- phase 12: the SQL front end ----------------------------------------------------------


def sql_run(query, sink, device, sql=True):
    """``query`` at phase 12's size; (wall s, rows as its phase compares
    them)."""
    if query == "q5":
        dt, rows, _ = run_q5(sink, device, sql)
    elif query == "q8":
        dt, rows, _ = run_q8(Q8_SMALL, sink, device, sql)
    elif query == "config5":
        dt, rows, _, _ = run_c5(C5_SMALL, "c5-small", sink, device, sql)
    elif query == "hot_items":
        dt, rows, _ = run_hot(HOT_SMALL, sink, device, sql)
    elif query == "q1":
        dt, rows, _ = run_q1(NUM_EVENTS, sink, device, sql)
    else:
        dt, rows, _ = run_q7(NUM_EVENTS, sink, device, sql)
    return dt, rows


def same_rows(a, b):
    if isinstance(a, dict):
        return same_columns(a, b)
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    return a == b


def n_rows(rows):
    return len(rows["ts"]) if isinstance(rows, dict) else len(rows)


SQL_SIZES = {"q1": NUM_EVENTS, "q5": NUM_EVENTS, "q7": NUM_EVENTS,
             "q8": Q8_SMALL, "hot_items": HOT_SMALL, "config5": C5_SMALL}


def uncoalesced_launches(query):
    """(SQL-planned, hand-built) kernel launches of ``query`` at phase
    12's size under ``ARROYO_COALESCE=0``."""
    os.environ["ARROYO_COALESCE"] = "0"
    try:
        out = []
        for sql in (True, False):
            reset_launches()
            sql_run(query, f"sql-{query}-uncoalesced", None, sql)
            out.append(read_launches())
    finally:
        del os.environ["ARROYO_COALESCE"]
    return out


def sql_phase():
    """bench.py's Q1, Q5, Q7, Q8, CONFIG5_SQL and the hot-items SQL planned
    by ``arroyo_tpu_torch.sql.plan_sql`` and run on the card: node for
    node the hand-built program, the rows and kernel launches of the
    hand-built run an earlier phase made at the same size; then q5
    unchained, its SQL expressions on the card."""
    unregister_udfs()
    register_udaf("median", np.median)
    config5_produce("c5-small", C5_SMALL, 0, C5_SPACING)
    out, launches = {}, None
    for query in SQL_QUERIES:
        n = SQL_SIZES[query]
        hand_sig = plan_signature(program_for(query, n, "sql-" + query,
                                              broker="c5-small"))
        planned_sig = plan_signature(program_for(query, n, "sql-" + query,
                                                 True, broker="c5-small"))
        check(planned_sig == hand_sig, f"{query}: the planned node sequence "
              "differs from the hand-built program's")
        reset_launches()
        perf.reset()
        dt, rows = sql_run(query, f"sql-{query}-cuda", None)
        got = read_launches()
        # chained, the ingest spine evaluates every SQL expression on the
        # host, as the JAX package's spine does
        chained_calls = perf.counter("expr_device_calls")
        check(chained_calls == 0, f"{query}: {chained_calls} SQL expression "
              "calls on the card in a chained run")
        hand_rows, hand_launches, hand_dt = HAND[query]
        check(n_rows(rows) > 0 and same_rows(rows, hand_rows),
              f"{query}: SQL-planned rows differ from the hand-built run's "
              f"({n_rows(rows)} vs {n_rows(hand_rows)})")
        if query == "config5":
            # the session operator unions once an input batch, and which
            # batches the coalescer merges depends on when they arrive:
            # the counts are held equal with one union a source batch
            got_u, hand_u = uncoalesced_launches(query)
            check(got_u == hand_u, f"{query}: SQL-planned launches {got_u} "
                  f"against the hand-built run's {hand_u} under "
                  "ARROYO_COALESCE=0")
        else:
            check(got == hand_launches, f"{query}: SQL-planned launches "
                  f"{got} against the hand-built run's {hand_launches}")
        launches = (got if launches is None
                    else {k: launches[k] + v for k, v in got.items()})
        out[query] = {"events": n, "plan_ms": PLAN_MS[query], "wall_s": dt,
                      "hand_wall_s": hand_dt, "rows": n_rows(rows),
                      "nodes": len(planned_sig), "launches": got,
                      "expr_device_calls": chained_calls}
        if query == "config5":
            out[query].update(hand_launches=hand_launches,
                              uncoalesced_launches=got_u)
    # q5 with one runner per operator: the post-aggregate projections and
    # the filters run as torch ops on the card (ARROYO_TIMING=1 times each
    # call synchronized, upload and readback included)
    os.environ.update(ARROYO_CHAIN="0", ARROYO_COALESCE="0",
                      ARROYO_TIMING="1")
    perf.reset()
    try:
        dt_u, rows_u, tasks_u = run_q5("sql-q5-unchained", None, True)
    finally:
        for k in ("ARROYO_CHAIN", "ARROYO_COALESCE", "ARROYO_TIMING"):
            del os.environ[k]
    calls = perf.counter("expr_device_calls")
    nbytes = perf.counter("expr_device_bytes")
    check(rows_u == HAND["q5"][0], "q5 SQL rows differ under ARROYO_CHAIN=0 "
          "ARROYO_COALESCE=0")
    check(calls > 0, "q5 unchained ran no SQL expression on the card")
    expr_ms = perf.counter("expr_device_ns") / 1e6
    out["q5_unchained"] = {
        "wall_s": dt_u, "tasks": tasks_u, "expr_device_calls": calls,
        "expr_device_ms": expr_ms, "expr_ms_per_call": expr_ms / max(calls, 1),
        "expr_rows": perf.counter("expr_device_rows"),
        "expr_bytes": nbytes,
        "expr_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    unregister_udfs()
    print("sql path: " + json.dumps(out))
    return launches


# -- phase 13: the reference's plans, the buffered window, UNION ALL ------------------

REF_COUNTERS = ("nonwindow_flushes", "nonwindow_flush_rows")
Q16_COLS = ("channel", "total_bids", "total_bidders", "total_auctions",
            "window_start", "window_end")
Q16_WIDTH = 10_000_000  # TUMBLE(INTERVAL '10' SECOND)


def ref_run(text, sink, device, reference=False):
    """``text`` (queries.py, at NUM_EVENTS, event time pinned) planned by
    ``plan_sql``, under ``ARROYO_ARGMAX=0`` when ``reference``, and run on
    ``device``; (wall s, the sink's batches, node kinds)."""
    dt, _runner, program = sql_cell(
        text, NUM_EVENTS, sink, device,
        {"ARROYO_ARGMAX": "0"} if reference else None)
    kinds = sorted({node.operator.kind.value for node in program.nodes()})
    return dt, sink_output(sink), kinds


def q5_rows(batches):
    return sorted((int(b.timestamp[i]), int(b.columns["auction"][i]),
                   int(b.columns["num"][i]))
                  for b in batches for i in range(len(b)))


def q5_control(num_events, event_rate=1_000_000.0, batch=BATCH):
    """Q5 from the generator's bids: per auction and HOP(2 s, 10 s)
    window the bids, per window the largest count, and the (window end -
    1, auction, count) rows that reach it."""
    bids = nexmark_bids(num_events, event_rate=event_rate, batch=batch)
    first = bids["ts"] // SLIDE_MICROS + 1  # the first window's end, in slides
    panes = WIDTH_MICROS // SLIDE_MICROS
    auction = bids["bid_auction"].astype(np.int64)
    check(auction.min() >= 0 and auction.max() < 2**32, "q5 control: "
          "auction ids past 32 bits")
    # one int64 a (window end in slides, auction) cell
    cells, counts = np.unique(np.concatenate(
        [((first + i) << 32) | auction for i in range(panes)]),
        return_counts=True)
    windows, inv = np.unique(cells >> 32, return_inverse=True)
    best = np.zeros(len(windows), dtype=np.int64)
    np.maximum.at(best, inv, counts)
    hit = counts == best[inv]
    ends = (cells[hit] >> 32) * SLIDE_MICROS
    return sorted(zip((ends - 1).tolist(),
                      (cells[hit] & 0xFFFFFFFF).tolist(),
                      counts[hit].tolist()))


def q16_rows(batches):
    cols = {c: np.concatenate([b.columns[c] for b in batches])
            for c in Q16_COLS}
    return sorted(zip(*(cols[c].tolist() for c in Q16_COLS)))


def q16_control(num_events):
    """Q16 from the generator's bids: per channel and 10 s window the
    bids, their distinct bidders and distinct auctions."""
    bids = nexmark_bids(num_events, extra=("bid_channel",))
    channels, ch = np.unique(bids["bid_channel"].astype(str),
                             return_inverse=True)
    ends, w = np.unique((bids["ts"] // Q16_WIDTH + 1) * Q16_WIDTH,
                        return_inverse=True)
    group = ch.astype(np.int64) * len(ends) + w
    n_groups = len(channels) * len(ends)

    def distinct(col):
        """Distinct values of ``col`` a group."""
        pairs = np.unique((group << 32) | col.astype(np.int64))
        return np.bincount(pairs >> 32, minlength=n_groups)

    bids_n = np.bincount(group, minlength=n_groups)
    bidders, auctions = distinct(bids["bid_bidder"]), distinct(
        bids["bid_auction"])
    return sorted((str(channels[g // len(ends)]), int(bids_n[g]),
                   int(bidders[g]), int(auctions[g]),
                   int(ends[g % len(ends)]) - Q16_WIDTH,
                   int(ends[g % len(ends)]))
                  for g in np.nonzero(bids_n)[0].tolist())


def q7_ref_check(cols, control, cols_cpu):
    """q7 as the reference plans it joins each bid with its window's
    maximum on ``price`` as a float32 key (ROADMAP C4): a bid whose price
    differs from the maximum but rounds to the same float32 also joins.
    Every control row must be there, and any other row must be such a
    bid, also in the CPU run; returns the number of those rows."""
    if same_columns(cols, control):
        return 0
    got = collections.Counter(zip(*(cols[c].tolist()
                                     for c in ("ts",) + Q7_COLS)))
    want = collections.Counter(zip(*(control[c].tolist()
                                      for c in ("ts",) + Q7_COLS)))
    extra, missing = got - want, want - got
    check(not missing, f"q7 (reference plan): {sum(missing.values())} "
          "control rows missing")
    best = {ts: price for ts, _a, price, _b in want}
    check(all(np.float32(price) == np.float32(best.get(ts, np.nan))
              for ts, _a, price, _b in extra),
          f"q7 (reference plan): rows beyond the control that are not "
          f"float32 ties of their window's maximum: {list(extra)[:5]}")
    check(same_columns(cols_cpu, cols), "q7 (reference plan): rows differ "
          "between card and cpu")
    return sum(extra.values())


def reference_phase():
    """Nexmark q5 and q7 as the reference plans them (``ARROYO_ARGMAX=0``:
    q5 a window join of its HOP count with the per-window maximum, a
    ``flush_key`` non-windowed aggregate; q7 a TTL join of the bids with
    a keyless tumbling maximum), q16's channel statistics on the buffered
    window and q1 as a UNION ALL of two price ranges, each at NUM_EVENTS
    on the card against numpy controls, earlier phases' rows and the CPU
    run; kernel launches a run."""
    out, launches = {}, {}
    perf.reset()
    reset_launches()
    dt, batches, kinds = ref_run(queries.Q5, "ref-q5", None, True)
    launches["q5_ref"] = read_launches()
    counters = {k: perf.counter(k) for k in REF_COUNTERS}
    rows = q5_rows(batches)
    t0 = time.perf_counter()
    control = q5_control(NUM_EVENTS)
    control_s = time.perf_counter() - t0
    CONTROLS["q5"] = control  # phase 16's q5 control
    check(rows and rows == control, f"q5 (reference plan): {len(rows)} rows "
          f"against the numpy control's {len(control)}")
    check(rows == HAND["q5"][0], "q5 (reference plan): rows differ from "
          "phase 5's fused rows")
    dt_cpu, batches_cpu, _ = ref_run(queries.Q5, "ref-q5-cpu", "cpu", True)
    check(q5_rows(batches_cpu) == rows, "q5 (reference plan): rows differ "
          "between card and cpu")
    check(counters["nonwindow_flushes"] > 0 and "non_window_aggregator"
          in kinds and "window_argmax" not in kinds,
          f"q5 (reference plan): plan {kinds}, {counters}")
    out["q5"] = {"events": NUM_EVENTS, "wall_s": dt,
                 "events_per_s": NUM_EVENTS / dt, "rows": len(rows),
                 "control_s": control_s, "cpu_wall_s": dt_cpu,
                 "launches": launches["q5_ref"], **counters}

    reset_launches()
    dt, batches, kinds = ref_run(queries.Q7, "ref-q7", None, True)
    launches["q7_ref"] = read_launches()
    cols = sorted_columns(sink_columns("ref-q7", Q7_COLS), ("ts",) + Q7_COLS)
    dt_cpu, _, _ = ref_run(queries.Q7, "ref-q7-cpu", "cpu", True)
    cols_cpu = sorted_columns(sink_columns("ref-q7-cpu", Q7_COLS),
                              ("ts",) + Q7_COLS)
    control = q7_control(NUM_EVENTS)
    check("global_key" in kinds and "join_with_expiration" in kinds,
          f"q7 (reference plan): plan {kinds}")
    extra = q7_ref_check(cols, control, cols_cpu)
    check(extra or same_columns(cols, HAND["q7"][0]), "q7 (reference plan): "
          "rows differ from phase 11's")
    out["q7"] = {"events": NUM_EVENTS, "wall_s": dt,
                 "events_per_s": NUM_EVENTS / dt, "rows": len(cols["ts"]),
                 "float32_tie_rows": extra, "cpu_wall_s": dt_cpu,
                 "launches": launches["q7_ref"]}

    reset_launches()
    dt, batches, kinds = ref_run(queries.Q16, "ref-q16", None)
    launches["q16"] = read_launches()
    rows = q16_rows(batches)
    t0 = time.perf_counter()
    control = q16_control(NUM_EVENTS)
    control_s = time.perf_counter() - t0
    check(rows and rows == control, f"q16: {len(rows)} rows against the "
          f"numpy control's {len(control)}")
    dt_cpu, batches_cpu, _ = ref_run(queries.Q16, "ref-q16-cpu", "cpu")
    check(q16_rows(batches_cpu) == rows, "q16: rows differ between card "
          "and cpu")
    check("window" in kinds and launches["q16"]["segment_agg"] > 0,
          f"q16: plan {kinds}, launches {launches['q16']}")
    out["q16"] = {"events": NUM_EVENTS, "wall_s": dt,
                  "events_per_s": NUM_EVENTS / dt, "rows": len(rows),
                  "control_s": control_s, "cpu_wall_s": dt_cpu,
                  "launches": launches["q16"]}

    reset_launches()
    dt, _, kinds = ref_run(queries.Q1_UNION, "ref-union", None)
    launches["union"] = read_launches()
    cols = sorted_columns(sink_columns("ref-union", Q1_COLS),
                          ("ts",) + Q1_COLS)
    check("union" in kinds and len(cols["ts"]) > 0
          and same_columns(cols, HAND["q1"][0]),
          "UNION ALL of q1's price ranges: rows differ from phase 10's q1 "
          f"rows ({len(cols['ts'])} vs {len(HAND['q1'][0]['ts'])})")
    out["union"] = {"events": NUM_EVENTS, "wall_s": dt,
                    "events_per_s": NUM_EVENTS / dt,
                    "rows": len(cols["ts"]), "q1_wall_s": HAND["q1"][2],
                    "launches": launches["union"]}
    print("reference plans: " + json.dumps(out))
    return launches


# -- phase 14: the legacy join layout, the semi join, the multi-way join ---

LEGACY_COUNTERS = ("join_pairs_device", "join_pairs_host",
                   "join_pairs_readbacks", "join_pairs_overflows",
                   "join_state_resorts", "join_blocking_uploads")
SEMI_COLS = ("auction", "price", "bidder")
MW_COLS = ("id", "np", "na", "nb")
MW_TTL_COLS = ("a1", "p2", "b3")
# MW_TTL's output grows with the cube of an auction's bids: 75,767,511
# rows at 2,000,000 events, 37,744,120 at 1,000,000, 18,655,922 at
# 500,000 (numpy counts from the generator): halved twice to stay under
# MW_TTL_MAX_ROWS
MW_TTL_EVENTS = 500_000
MW_TTL_MAX_ROWS = 20_000_000
# a batch of 131,072 events holds ~6,000 bids above MW_TTL's price, ~380
# a join partition: an EWMA of ~3,800 rows, under the default 4,096-row
# hot floor, so this cell lowers the floor to run its probes on the rings
MW_TTL_HOT_MIN_ROWS = "1024"


def legacy_state():
    """Counters and bucket sizes of the legacy join's pairings since the
    last ``perf.reset``."""
    return {"counters": {k: perf.counter(k) for k in LEGACY_COUNTERS},
            "buckets": {int(k.split(":", 1)[1]): v for k, v in
                        perf.counters("join_pairs_bucket:").items()}}


def legacy_launched(what, launches):
    check(launches["join_sort"] > 0 and launches["join_probe_u64"] > 0
          and launches["join_expand"] > 0,
          f"{what} under ARROYO_JOIN_STATE=legacy did not launch join_sort, "
          f"the u64 join_probe and join_expand: {launches}")


def legacy_phase():
    """q8 at Q8_EVENTS and join-stress 8a / 8b under the legacy layout
    (both sides re-sorted at each fire or arrival, paired on the card):
    rows equal to phases 6's and 8's controls and partitioned runs
    (8a: the pairs at most one TTL apart; the ones further apart follow
    the arrival of watermarks, as in phase 8, and are counted)."""
    os.environ["ARROYO_JOIN_STATE"] = "legacy"
    out, launches = {}, {}
    try:
        perf.reset()
        reset_launches()
        dt, rows, _ = run_q8(Q8_EVENTS, "q8-legacy", None)
        launches["q8_legacy"] = read_launches()
        check(np.array_equal(rows, CONTROLS["q8"])
              and np.array_equal(rows, CONTROLS["q8_rows"]),
              f"q8 legacy rows differ from the control and phase 6's rows "
              f"({len(rows)} vs {len(CONTROLS['q8'])})")
        legacy_launched("q8", launches["q8_legacy"])
        out["q8"] = {"events": Q8_EVENTS, "wall_s": dt,
                     "events_per_s": Q8_EVENTS / dt, "rows": len(rows),
                     "launches": launches["q8_legacy"], **legacy_state()}
        for what, n, how, ttl in (
                ("inner", JS_INNER, JoinType.INNER, TTL_MICROS),
                ("left", JS_LEFT, JoinType.LEFT, PLANNER_TTL_MICROS)):
            perf.reset()
            reset_launches()
            dt, creates, deletes, _ = run_js(n, how, ttl,
                                             f"js-{what}-legacy", None)
            key = f"join_{what}_legacy"
            launches[key] = read_launches()
            res = CONTROLS[f"gate_{what}"](creates, deletes)
            p_creates, p_deletes = CONTROLS[what]
            same = (np.array_equal(creates, p_creates)
                    and np.array_equal(deletes, p_deletes))
            if what == "left":  # 1 h TTL: nothing expires, every row fixed
                check(same, "join-stress left legacy rows differ from the "
                      "partitioned run's")
            else:  # the rows that differ lie beyond the TTL
                differ = np.setxor1d(creates, p_creates)
                check(not np.isin(differ, js_pairs(
                    JS_INNER, TTL_MICROS // INTERVAL_MICROS)).any(),
                      "join-stress inner legacy rows within the TTL differ "
                      "from the partitioned run's")
                res["rows_not_in_partitioned_run"] = int(
                    (~np.isin(creates, p_creates)).sum())
                res["partitioned_rows_not_here"] = int(
                    (~np.isin(p_creates, creates)).sum())
            legacy_launched(f"join-stress {what}", launches[key])
            out[what] = {"events_per_side": n, "wall_s": dt,
                         "events_per_s": 2 * n / dt,
                         "rows_created": len(creates),
                         "rows_deleted": len(deletes),
                         "equal_to_partitioned": bool(same), **res,
                         "launches": launches[key], **legacy_state()}
    finally:
        del os.environ["ARROYO_JOIN_STATE"]
    print("legacy join layout: " + json.dumps(out))
    return launches


def sql_cell(text, num_events, sink, device, env=None, batch=BATCH):
    """``text`` (queries.py) at ``num_events`` in batches of ``batch``,
    event time pinned, planned by ``plan_sql`` and run on ``device`` with
    the environment ``env`` set; (wall s, the runner, the program).  The
    sink's batches stay in ``sink``."""
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        program = plan_sql(_pin(text.format(n=num_events, b=batch), batch))
        for node in program.nodes():
            if node.operator.kind == OpKind.CONNECTOR_SINK:
                node.operator.spec.config["name"] = sink
        clear_sink(sink)
        dt, runner = run_program(program, device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dt, runner, program


def join_kinds(program):
    return sorted(node.operator.kind.value for node in program.nodes()
                  if "join" in node.operator.kind.value)


def sorted_sink(sink, cols, ts=True):
    """The sink's columns (``ts`` first unless ``ts`` is False), sorted
    on every column, the sink cleared."""
    c = sink_columns(sink, cols)
    if not ts:
        del c["ts"]
    return sorted_columns(c, tuple(c))


def semi_control(num_events):
    """The bids on auctions of category 10 (every auction id it ever
    names: the semi join's TTL outlasts the stream): columns ts, auction,
    price, bidder, sorted."""
    names = ["auction_id", "auction_category", "bid_auction", "bid_price",
             "bid_bidder", "event_type"]
    cfg = NexmarkConfig(num_events=num_events, rate_limited=False,
                        event_rate=1_000_000.0, batch_size=BATCH,
                        projection=names)
    first, n, num = make_splits(cfg, 0, 1)[0]
    gen = NexmarkGenerator(cfg, 0, first, n, num, seed=0)
    gen.set_rate(cfg.event_rate, 1)
    ids, bids = [], collections.defaultdict(list)
    while gen.has_next:
        b, _ = gen.next_batch(BATCH)
        et = b.columns["event_type"]
        ids.append(b.columns["auction_id"][
            (et == EVENT_AUCTION) & (b.columns["auction_category"] == 10)])
        bid = et == EVENT_BID
        bids["ts"].append(b.timestamp[bid])
        for c, src in zip(SEMI_COLS, ("bid_auction", "bid_price",
                                      "bid_bidder")):
            bids[c].append(b.columns[src][bid])
    cols = {c: np.concatenate(v) for c, v in bids.items()}
    keep = np.isin(cols["auction"], np.concatenate(ids))
    return sorted_columns({c: v[keep] for c, v in cols.items()},
                          ("ts",) + SEMI_COLS)


def mw_ttl_rows_expected(num_events):
    """MW_TTL's row count from the generator: the cube of each auction's
    bids above the price (every row stays within the 1 h TTL)."""
    bids = nexmark_bids(num_events)
    a = bids["bid_auction"][bids["bid_price"] > 50_000_000]
    _, c = np.unique(a, return_counts=True)
    return int((c.astype(np.int64) ** 3).sum())


def find_ops(runner, cls_name):
    return [op for _id, op in operators(runner)
            if type(op).__name__ == cls_name]


class semi_pending:
    """Records the semi join's pending left rows (``len(op.left)``) as
    each watermark reaches it, before that watermark expires any: the last
    entry is the backlog the end of the stream finds."""

    def __init__(self):
        from arroyo_tpu_torch.engine import operators_window as ow
        self.cls, self.orig, self.rows = (ow.SemiJoinOperator,
                                          ow.SemiJoinOperator.handle_watermark,
                                          [])
        orig, rows = self.orig, self.rows

        async def handle_watermark(op, watermark, ctx):
            rows.append(len(op.left))
            await orig(op, watermark, ctx)

        self.cls.handle_watermark = handle_watermark

    def close(self):
        self.cls.handle_watermark = self.orig


def semi_mw_phase():
    """The semi join (SEMI_Q3), the windowed multi-way join (MW_BIDDERS)
    and its TTL mode (MW_TTL), each planned from SQL and run on the card,
    chained and coalesced."""
    out, launches = {}, {}
    # the semi join
    t0 = time.perf_counter()
    control = semi_control(NUM_EVENTS)
    control_s = time.perf_counter() - t0
    reset_launches()
    pending = semi_pending()
    try:
        dt, runner, program = sql_cell(queries.SEMI_Q3, NUM_EVENTS,
                                       "semi-cuda", None)
    finally:
        pending.close()
    launches["semi"] = read_launches()
    rows = sorted_sink("semi-cuda", SEMI_COLS)
    semi = find_ops(runner, "SemiJoinOperator")
    check(join_kinds(program) == ["join_with_expiration"] and len(semi) == 1,
          f"SEMI_Q3 did not plan one semi join: {join_kinds(program)}")
    check(len(rows["ts"]) > 0 and same_columns(rows, control),
          f"semi join rows differ from the numpy control ({len(rows['ts'])} "
          f"vs {len(control['ts'])})")
    dt_cpu, _r, _p = sql_cell(queries.SEMI_Q3, NUM_EVENTS, "semi-cpu", "cpu")
    check(same_columns(sorted_sink("semi-cpu", SEMI_COLS), rows),
          "semi join rows differ between card and cpu")
    out["semi"] = {"events": NUM_EVENTS, "batch": BATCH, "wall_s": dt,
                   "events_per_s": NUM_EVENTS / dt, "rows": len(rows["ts"]),
                   "control_s": control_s, "cpu_wall_s": dt_cpu,
                   "pending_left_rows_at_watermarks": pending.rows,
                   "pending_left_rows_at_end": len(semi[0].left),
                   "right_keys_at_end": len(semi[0].rkeys),
                   "launches": launches["semi"]}
    # the windowed multi-way join
    t0 = time.perf_counter()
    control = q8_control(Q8_EVENTS, 3)
    control_s = time.perf_counter() - t0
    perf.reset()
    reset_launches()
    dt, runner, program = sql_cell(queries.MW_BIDDERS, Q8_EVENTS, "mw-cuda",
                                   None)
    launches["mw"] = read_launches()
    counters = {k: perf.counter(k) for k in Q8_COUNTERS}
    rows = q8_table(sink_output("mw-cuda"), MW_COLS)
    check(join_kinds(program) == ["multi_way_join"],
          f"MW_BIDDERS planned {join_kinds(program)}")
    check(len(rows) > 0 and np.array_equal(rows, control),
          f"multi-way join rows differ from the numpy control ({len(rows)} "
          f"vs {len(control)})")
    dt_pair, _r, pairwise = sql_cell(queries.MW_BIDDERS, Q8_EVENTS,
                                     "mw-pairwise", None,
                                     {"ARROYO_MULTIWAY": "0"})
    check(join_kinds(pairwise) == ["window_join", "window_join"]
          and np.array_equal(q8_table(sink_output("mw-pairwise"), MW_COLS),
                             rows),
          "multi-way join rows differ from the pairwise plan's")
    dt_small, _r, _p = sql_cell(queries.MW_BIDDERS, Q8_SMALL, "mw-small",
                                None)
    small = q8_table(sink_output("mw-small"), MW_COLS)
    dt_small_cpu, _r, _p = sql_cell(queries.MW_BIDDERS, Q8_SMALL,
                                    "mw-small-cpu", "cpu")
    check(len(small) > 0 and np.array_equal(
        q8_table(sink_output("mw-small-cpu"), MW_COLS), small),
        "multi-way join rows at 2M events differ between card and cpu")
    for sink in ("mw-cuda", "mw-pairwise", "mw-small", "mw-small-cpu"):
        clear_sink(sink)
    out["mw"] = {"events": Q8_EVENTS, "wall_s": dt,
                 "events_per_s": Q8_EVENTS / dt, "rows": len(rows),
                 "control_s": control_s, "pairwise_wall_s": dt_pair,
                 "small_events": Q8_SMALL, "small_rows": len(small),
                 "small_wall_s": dt_small, "small_cpu_wall_s": dt_small_cpu,
                 "launches": launches["mw"], "counters": counters}
    # the multi-way join's TTL mode
    t0 = time.perf_counter()
    expect = mw_ttl_rows_expected(MW_TTL_EVENTS)
    control_s = time.perf_counter() - t0
    check(expect <= MW_TTL_MAX_ROWS, f"MW_TTL at {MW_TTL_EVENTS} events "
          f"gives {expect} rows, above {MW_TTL_MAX_ROWS}: halve the events")
    env = {"ARROYO_JOIN_HOT_MIN_ROWS": MW_TTL_HOT_MIN_ROWS}
    perf.reset()
    reset_launches()
    dt, runner, program = sql_cell(queries.MW_TTL, MW_TTL_EVENTS,
                                   "mwt-cuda", None, env)
    launches["mw_ttl"] = read_launches()
    counters = {k: perf.counter(k) for k in JS_COUNTERS}
    # a TTL join stamps a row with its arriving batch's time, which
    # differs between the multi-way and the pairwise plan: rows compare
    # without it, as the JAX package's tests compare them
    rows = sorted_sink("mwt-cuda", MW_TTL_COLS, ts=False)
    check(join_kinds(program) == ["multi_way_join"],
          f"MW_TTL planned {join_kinds(program)}")
    check(len(rows["a1"]) == expect, f"MW_TTL emitted {len(rows['a1'])} "
          f"rows, the generator's auctions give {expect}")
    env["ARROYO_MULTIWAY"] = "0"
    dt_pair, _r, pairwise = sql_cell(queries.MW_TTL, MW_TTL_EVENTS,
                                     "mwt-pairwise", None, env)
    check(join_kinds(pairwise) == ["join_with_expiration",
                                   "join_with_expiration"]
          and same_columns(sorted_sink("mwt-pairwise", MW_TTL_COLS,
                                       ts=False), rows),
          "MW_TTL rows differ from the pairwise plan's")
    check(launches["mw_ttl"]["join_probe"] > 0
          and launches["mw_ttl"]["join_expand"] > 0,
          f"MW_TTL's probes launched no ring kernel: {launches['mw_ttl']}")
    out["mw_ttl"] = {"events": MW_TTL_EVENTS, "cut_from": NUM_EVENTS,
                     "wall_s": dt, "events_per_s": MW_TTL_EVENTS / dt,
                     "rows": len(rows["a1"]),
                     "rows_per_s": len(rows["a1"]) / dt,
                     "control_s": control_s, "pairwise_wall_s": dt_pair,
                     "hot_min_rows": int(MW_TTL_HOT_MIN_ROWS),
                     "launches": launches["mw_ttl"], "counters": counters}
    print("semi and multi-way joins: " + json.dumps(out))
    return launches


# -- phase 15: correlated windows (the factor-window rewrite) -----------------------

CW_WIDTHS = (10, 4, 20, 6, 16, 8, 30, 14)  # bench.py:1863, seconds
CW_SLIDE = 2_000_000  # every member's slide: HOP(INTERVAL '2' SECOND, ...)
CW_BATCH = 8_192  # bench.py:1868: panes must fire mid-stream
CW_SMALL = 2_000_000
# K = 8 factored and under 1 s checkpoints: cut from bench.py's and q8's
# 40,000,000 events to keep the script inside its time limit (the factored
# plan ran 106-156 s there and its control 50-53 s on an H100 80GB HBM3,
# 700 W; the unfactored plan 511 s, and the checkpointed one outgrew its
# host's 96 GiB: InMemoryBackend keeps every epoch)
CW_MID = 8_000_000
CW_KS = (2, 4, 8)
CW_COLS = ("auction", "window_end", "num", "tot")
CW_COUNTERS = ("pane_update_rows", "pane_update_dispatches", "factor_drains",
               "factor_drain_rows")
CW_KERNELS = ("bin_update", "pane_emit", "bin_evict", "emit_count",
              "emit_gather")


def cw_sql(k, num_events):
    """bench.py's ``run_correlated_windows`` SQL (:1862-1879) for ``k``
    members, event time pinned to 0."""
    parts = [_pin(queries.SRC.format(n=num_events, b=CW_BATCH), CW_BATCH)]
    for i in range(k):
        parts.append(
            f"CREATE TABLE cw{i} (auction BIGINT, window_end BIGINT,"
            f" num BIGINT, tot BIGINT) WITH (connector = 'memory',"
            f" name = 'cw{i}', type = 'sink');")
        parts.append(
            f"INSERT INTO cw{i}\n"
            f"SELECT bid.auction as auction,\n"
            f"  HOP(INTERVAL '2' SECOND, INTERVAL '{CW_WIDTHS[i]}'"
            f" SECOND) as window,\n"
            f"  count(*) AS num, sum(bid.price) AS tot\n"
            f"FROM nexmark WHERE bid is not null GROUP BY 1, 2;")
    return "\n".join(parts)


def cw_cells(num_events):
    """The bids of the generator at CW_BATCH as dense per-auction grids
    of 2 s bins: (auctions ascending, first bin, bids [auction, bin],
    summed price [auction, bin]), int64."""
    names = ["bid_auction", "bid_price", "event_type"]
    cfg = NexmarkConfig(num_events=num_events, rate_limited=False,
                        event_rate=1_000_000.0, batch_size=CW_BATCH,
                        projection=names)
    first, n, num = make_splits(cfg, 0, 1)[0]
    gen = NexmarkGenerator(cfg, 0, first, n, num, seed=0)
    gen.set_rate(cfg.event_rate, 1)
    parts = collections.defaultdict(list)
    while gen.has_next:
        b, _ = gen.next_batch(CW_BATCH)
        bid = b.columns["event_type"] == EVENT_BID
        parts["bin"].append(b.timestamp[bid] // CW_SLIDE)
        parts["a"].append(b.columns["bid_auction"][bid])
        parts["p"].append(b.columns["bid_price"][bid])
    a, bins, price = (np.concatenate(parts[c]) for c in ("a", "bin", "p"))
    auctions, ai = np.unique(a, return_inverse=True)
    b0 = int(bins.min())
    nb = int(bins.max()) - b0 + 1
    flat = ai.astype(np.int64) * nb + (bins - b0)
    size = len(auctions) * nb
    count = np.bincount(flat, minlength=size).reshape(len(auctions), nb)
    # f64 sums of integer prices stay exact below 2^53
    total = np.bincount(flat, weights=price.astype(np.float64),
                        minlength=size).reshape(len(auctions), nb)
    return auctions, b0, count, total.astype(np.int64)


def cw_control(cells, width_s):
    """Member ``HOP(2 s, width_s)``'s rows from the grids: the window
    ending at bin e sums bins e - W + 1 .. e (windows end up to W - 1
    bins past the last bid's bin); columns ts, auction, window_end, num,
    tot sorted by (window_end, auction)."""
    auctions, b0, count, total = cells
    w = width_s * 1_000_000 // CW_SLIDE
    pad = np.zeros((len(auctions), w - 1), np.int64)
    sums = []
    for grid in (count, total):
        cs = np.cumsum(np.concatenate([grid, pad], axis=1), axis=1)
        cs[:, w:] -= cs[:, :-w].copy()
        sums.append(cs)
    end_idx, ai = np.nonzero(sums[0].T)  # (window end, auction) order
    check(len(ai) == 0 or auctions[-1] < 2**32, "auction ids past 2^32")
    end = (b0 + end_idx + 1) * CW_SLIDE
    return {"ts": end - 1, "auction": auctions[ai], "window_end": end,
            "num": sums[0][ai, end_idx], "tot": sums[1][ai, end_idx]}


def cw_rows(k):
    """Each member's sink as int64 columns sorted by (window_end,
    auction); the sinks cleared."""
    out = []
    for i in range(k):
        batches = sink_output(f"cw{i}")
        cols = {"ts": np.concatenate([b.timestamp for b in batches])}
        for c in CW_COLS:
            v = np.concatenate([b.columns[c] for b in batches])
            check(np.all(v == np.round(v)), f"cw{i}.{c} is not integral")
            cols[c] = v.astype(np.int64)
        out.append(cw_sorted(cols))
        clear_sink(f"cw{i}")
    return out


def cw_sorted(cols):
    """``cols`` sorted by (window_end, auction), one key a row sorted on
    the card (tens of millions of rows at CW_MID)."""
    a, e = cols["auction"], cols["window_end"] // CW_SLIDE
    check(len(a) == 0 or (a.min() >= 0 and a.max() < 2**32
                          and e.min() >= 0 and e.max() < 2**31),
          "cw rows' auction or window out of the sort key's range")
    key = torch.from_numpy((e << 32) | a).cuda()
    order = torch.argsort(key, stable=True).cpu().numpy()
    return {c: v[order] for c, v in cols.items()}


def cw_run(k, num_events, factor, device, ckpt=None):
    """bench.py's correlated windows for ``k`` members under
    ``ARROYO_FACTOR_WINDOWS=factor`` on ``device`` (1 s checkpoints with
    ``ckpt``), its launches counted from 0: (rows a member, summary)."""
    # the Engine applies the rewrite again (Stream-API programs): the
    # knob stays set through the run, as bench.py sets it
    os.environ["ARROYO_FACTOR_WINDOWS"] = factor
    try:
        t0 = time.perf_counter()
        program = plan_sql(cw_sql(k, num_events))
        plan_ms = (time.perf_counter() - t0) * 1e3
        for i in range(k):
            clear_sink(f"cw{i}")
        perf.reset()
        reset_launches()
        runner = LocalRunner(program, device=device)
        t0 = time.perf_counter()
        resps = runner.run(checkpoint_interval_secs=ckpt)
        if device != "cpu":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
    finally:
        del os.environ["ARROYO_FACTOR_WINDOWS"]
    shared = [d.to_json() for d in runner.engine.factor_decisions
              if d.shared]
    counters = {c: perf.counter(c) for c in CW_COUNTERS}
    done = collections.Counter(r.subtask_metadata.epoch for r in resps
                               if r.kind == "checkpoint_completed")
    rows = cw_rows(k)
    return rows, {
        "k": k, "events": num_events, "factor": factor,
        "device": "cpu" if device == "cpu" else "cuda",
        "checkpoint_interval_s": ckpt, "plan_ms": plan_ms, "wall_s": dt,
        "events_per_s": num_events / dt,
        "rows": int(sum(len(r["ts"]) for r in rows)),
        "pane_update_rows_per_event":
            counters["pane_update_rows"] / num_events,
        **counters,
        "epochs": sorted(e for e, c in done.items()
                         if c == len(runner.engine.members)),
        "decision": {"shared_panes": len(shared),
                     "derived_windows": sum(len(d["members"])
                                            for d in shared),
                     "pane_micros": shared[0]["pane_micros"]
                     if shared else None},
        "launches": {n: launches[n] for n in CW_KERNELS}}, launches


def cw_gate_factored(run, k):
    d = run["decision"]
    check(d["shared_panes"] == 1 and d["derived_windows"] == k
          and d["pane_micros"] == CW_SLIDE,
          f"K={k}: the factor decision is {d}, not one shared 2 s pane "
          f"ring with {k} derived windows")
    check(run["launches"]["bin_update"] > 0
          and run["launches"]["bin_evict"] > 0
          and run["launches"]["pane_emit"]
          + run["launches"]["emit_count"] > 0,
          f"K={k} factored launched too few kernels: {run['launches']}")


def cw_same(a, b):
    return all(same_columns(x, y) for x, y in zip(a, b)) and len(a) == len(b)


def cw_controls_equal(rows, cells, what):
    """Every member's rows equal its numpy control, one member at a
    time (a control at CW_MID holds tens of millions of rows)."""
    for i, got in enumerate(rows):
        want = cw_control(cells, CW_WIDTHS[i])
        check(len(want["ts"]) > 0 and same_columns(got, want),
              f"{what}: cw{i} rows differ from the numpy control "
              f"({len(got['ts'])} vs {len(want['ts'])})")


def cw_phase():
    """bench.py's correlated-windows family on the card, every member's
    rows held to a numpy control: K = 2, 4, 8 at CW_SMALL events,
    factored and unfactored on the card and factored on the CPU; K = 8
    at CW_MID, factored and factored under config5's 1 s checkpoint
    ticker (its barrier drains ship rows)."""
    t0 = time.perf_counter()
    cells = cw_cells(CW_SMALL)
    control_s = time.perf_counter() - t0
    small = {"auto": collections.Counter(), "0": collections.Counter()}
    runs = []
    for k in CW_KS:
        fact, f_sum, f_l = cw_run(k, CW_SMALL, "auto", None)
        unf, u_sum, u_l = cw_run(k, CW_SMALL, "0", None)
        cpu, c_sum, _ = cw_run(k, CW_SMALL, "auto", "cpu")
        small["auto"].update(f_l)
        small["0"].update(u_l)
        cw_gate_factored(f_sum, k)
        check(u_sum["decision"]["shared_panes"] == 0,
              f"K={k} under ARROYO_FACTOR_WINDOWS=0 factored")
        cw_controls_equal(fact, cells, f"K={k} factored at {CW_SMALL}")
        check(cw_same(unf, fact), f"K={k} unfactored rows differ from the "
              "factored rows")
        check(cw_same(cpu, fact), f"K={k} factored rows differ between "
              "card and cpu")
        runs += [f_sum, u_sum, c_sum]
    launches = {"cw_2m_fact": dict(small["auto"]),
                "cw_2m_unfact": dict(small["0"])}
    k = CW_KS[-1]
    check(runs[-3]["pane_update_rows"] < runs[-2]["pane_update_rows"],
          f"K={k} at {CW_SMALL} events: factored pane_update_rows "
          f"{runs[-3]['pane_update_rows']} not below unfactored "
          f"{runs[-2]['pane_update_rows']}")
    # K = 8 at CW_MID: factored, checkpointed
    t0 = time.perf_counter()
    cells = cw_cells(CW_MID)
    mid_control_s = time.perf_counter() - t0
    fact, f_sum, launches["cw_8m_fact"] = cw_run(k, CW_MID, "auto", None)
    cw_gate_factored(f_sum, k)
    cw_controls_equal(fact, cells, f"K={k} factored at {CW_MID}")
    del cells
    ck, c_sum, launches["cw_8m_ckpt"] = cw_run(k, CW_MID, "auto", None,
                                               ckpt=1.0)
    cw_gate_factored(c_sum, k)
    check(cw_same(ck, fact), f"K={k} at {CW_MID} events: the checkpointed "
          "factored rows differ from the run without checkpoints")
    check(c_sum["epochs"] and c_sum["factor_drains"] > 0
          and c_sum["factor_drain_rows"] > 0,
          f"K={k} at {CW_MID} events with 1 s checkpoints: epochs "
          f"{c_sum['epochs']}, {c_sum['factor_drains']} drains of "
          f"{c_sum['factor_drain_rows']} rows")
    del ck, fact
    runs += [f_sum, c_sum]
    for r in runs:
        print(f"correlated windows K={r['k']} {r['events']} "
              f"factor={r['factor']} {r['device']}: " + json.dumps(r))
    print("correlated windows: " + json.dumps({
        "control_s": control_s, "mid_control_s": mid_control_s,
        "launches_2m_fact": launches["cw_2m_fact"],
        "launches_2m_unfact": launches["cw_2m_unfact"]}))
    return launches


# -- phase 16: the engine services -------------------------------------------------

# "armed": the runtime sanitizer and 1-in-32 latency sampling from the
# environment, the phase profiler armed by the script
SERVICE_ENV = {"ARROYO_SANITIZE": "1", "ARROYO_LATENCY_SAMPLE_N": "32"}
# the JAX package's critical-path stages (arroyo_tpu/obs/latency.py)
CRITICAL_STAGES = ("source_linger", "queue_wait", "barrier_align",
                   "watermark_hold", "fire", "emit", "compute")
CRITICAL_KEYS = {"stages", "total_secs", "dominant", "dominant_share"}
# the reference's per-task record and queue instruments
TASK_METRICS = ("arroyo_worker_messages_recv_total",
                "arroyo_worker_messages_sent_total",
                "arroyo_worker_bytes_recv_total",
                "arroyo_worker_bytes_sent_total",
                "arroyo_worker_tx_queue_size", "arroyo_worker_tx_queue_rem")
WORK_SHARE = (0.85, 1.5)  # work phases over wall (the JAX bound)
# phases a cell's source records on its prefetch thread, beside the event
# loop (the nexmark generator): they stay under the wall, the loop's own
# work phases under the JAX upper bound, and those plus the time the loop
# idles in its selector, waiting on that thread, over the JAX lower bound
# (with the host library q5's loop waits on the generator, whose wall
# sets q5's; both spans are wall-clock, so they may overlap)
OFF_LOOP = {"q5": ("source_decode",), "q5_tail": ("source_decode",)}
# q5's tail: 2M events at 2,000 events/s in batches of 8,192, so each
# batch spans 4.1 s of event time and the window fires after nearly every
# batch (at bench.py's rate and batch, q5 fires once, at the end): one
# sink sample a fire, at least Q5_TAIL_SAMPLES of them
Q5_TAIL_RATE, Q5_TAIL_BATCH, Q5_TAIL_SAMPLES = 2_000.0, 8_192, 100
SERVICE_RUNS = collections.Counter()  # cell -> runs so far (job ids)


def state_tensor_bytes(runner):
    """Bytes of the CUDA tensors the run's keyed-bin planes and join rings
    hold, read off their storages (one count a storage)."""
    storages = {}
    for op, _ctx in runner.engine.members.values():
        tensors = []
        if isinstance(op, BinAggOperator):
            tensors = [op.state.values, op.state.counts]
        elif isinstance(op, JoinWithExpirationOperator) and op._partitioned:
            tensors = [part.dev.hi for buf in (op.left, op.right)
                       for part in buf.parts if part.dev is not None]
        for t in tensors:
            if t.is_cuda:
                st = t.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
    return int(sum(storages.values()))


def exposition_gaps(runner, job):
    """(operator, metric) pairs of the run's tasks missing from the
    metrics exposition."""
    lines = metrics.render_metrics().decode().splitlines()
    have = set()
    for line in lines:
        if line.startswith("#") or f'job_id="{job}"' not in line:
            continue
        name = line.split("{", 1)[0]
        op = re.search(r'operator_id="([^"]*)"', line)
        if op:
            have.add((op.group(1), name))
    return [(op, m) for op, _idx in runner.engine.members
            for m in TASK_METRICS if (op, m) not in have]


class loop_idle:
    """Seconds the event loop run on the calling thread spends blocked in
    its selector (waiting on I/O, a timer or another thread's future):
    the loop's idle time, read beside the profiler, not by it."""

    def __enter__(self):
        cls = selectors.DefaultSelector
        self.saved = cls.__dict__.get("select")
        orig, me = cls.select, threading.get_ident()
        self.secs = 0.0

        def select(sel, timeout=None):
            if threading.get_ident() != me:
                return orig(sel, timeout)
            t0 = time.perf_counter()
            try:
                return orig(sel, timeout)
            finally:
                self.secs += time.perf_counter() - t0

        cls.select = select
        return self

    def __exit__(self, *exc):
        if self.saved is None:
            del selectors.DefaultSelector.select
        else:
            selectors.DefaultSelector.select = self.saved


class gc_pauses:
    """Seconds the garbage collector runs while the block runs (on any
    thread), read beside the profiler."""

    def __enter__(self):
        self.secs, self._t0 = 0.0, None
        gc.callbacks.append(self._tick)
        return self

    def _tick(self, phase, _info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.secs += time.perf_counter() - self._t0
            self._t0 = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._tick)


def svc_run(cell, make, rows_of, armed, ckpt=None, timing=False, env=None):
    """One run of ``cell`` on the card, launches counted from 0, with the
    services armed or not; returns (rows, summary, launches)."""
    SERVICE_RUNS[cell] += 1
    job = f"svc-{cell}-{SERVICE_RUNS[cell]}"
    env = {**(env or {}), **(SERVICE_ENV if armed else
                             {"ARROYO_SANITIZE": "0"})}
    if timing:
        env["ARROYO_TIMING"] = "1"
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    reset_config()
    profiler.disarm()
    latency.disarm()
    sanitizer._reset_ring()
    tracing.reset()
    program, sink = make()
    clear_sink(sink)
    perf.reset()
    threads = set(threading.enumerate())
    # the earlier runs' engines are freed, and the script's own heap (its
    # controls and results) frozen, before the wall starts: a full
    # collection inside the run then scans only what the run made
    gc.collect()
    gc.freeze()
    try:
        runner = LocalRunner(program, job_id=job)
        prof = profiler.arm(job) if armed or timing else None
        reset_launches()
        if prof is not None:
            prof.reset()
        t0 = time.perf_counter()
        with loop_idle() as idle, gc_pauses() as pauses:
            resps = runner.run(checkpoint_interval_secs=ckpt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        rows = rows_of(sink_output(sink))
        clear_sink(sink)
        lat = latency.active()
        san = runner.engine.sanitizer
        out = {"job": job, "armed": armed, "timing": timing, "wall_s": wall,
               "gc_s": pauses.secs,
               "epochs": len({r.subtask_metadata.epoch for r in resps
                              if r.kind == "checkpoint_completed"})}
        late = [t.name for t in set(threading.enumerate()) - threads]
        check(not late, f"{job}: threads alive after the run: {late}")
        if not (armed or timing):
            check(san is None and lat is None and prof is None,
                  f"{job}: a service is armed in the disarmed run")
            return rows, out, launches
        snap = prof.snapshot()
        work = sum(snap["phases"].values())
        beside = sum(snap["phases"].get(p, 0.0)
                     for p in OFF_LOOP.get(cell, ()))
        out.update(phases=snap["phases"], waits=snap["waits"],
                   work_share=work / wall,
                   loop_share=(work - beside) / wall,
                   thread_share=beside / wall,
                   idle_share=idle.secs / wall,
                   counts=len(snap["counts"]))
        if timing:
            return rows, out, launches, prof.work_snapshot(), runner
        check(san is not None and lat is not None,
              f"{job}: the sanitizer or the latency observatory is off")
        events = len(sanitizer.recent_events(256))
        check(events > 0 and san.violations == 0,
              f"{job}: {events} sanitizer events, {san.violations} "
              "violations")
        lo, hi = WORK_SHARE
        covered = out["loop_share"] + (out["idle_share"] if cell in OFF_LOOP
                                       else 0.0)
        check(lo <= covered and out["loop_share"] <= hi
              and out["thread_share"] <= 1.0,
              f"{job}: work phases {work - beside:.3f} s on the loop, "
              f"{idle.secs:.3f} s idle and {beside:.3f} s beside it over a "
              f"{wall:.3f} s wall ({out['loop_share']:.3f}, "
              f"{out['idle_share']:.3f}, {out['thread_share']:.3f}), "
              f"{pauses.secs:.3f} s in the garbage collector: "
              f"{snap['phases']}")
        for phase in ("source_decode", "proc", "dispatch", "watermark"):
            check(snap["phases"].get(phase, 0.0) > 0.0,
                  f"{job}: no {phase} phase: {snap['phases']}")
        cp = lat.critical_path()
        check(set(cp) == CRITICAL_KEYS
              and tuple(cp["stages"]) == CRITICAL_STAGES,
              f"{job}: critical path {cp}")
        tables = latency.device_state_tables()
        device = sum(v for k, v in tables.items() if not k.endswith("_host"))
        tensors = state_tensor_bytes(runner)
        allocated = torch.cuda.memory_allocated()
        check(device == tensors <= allocated,
              f"{job}: device_state_tables {tables} against {tensors} "
              f"state tensor bytes, {allocated} allocated")
        gaps = exposition_gaps(runner, job)
        check(not gaps, f"{job}: the exposition lacks {gaps[:5]}")
        trace = tracing.chrome_trace()
        out.update(sanitizer_events=events,
                   records_sampled=lat.snapshot()["records_sampled"],
                   sinks=lat.sink_quantiles(), critical_path=cp,
                   device_state_tables=tables, state_tensor_bytes=tensors,
                   memory_allocated=allocated,
                   trace_spans=len(tracing.spans()),
                   trace_events=len(trace["traceEvents"]))
        return rows, out, launches
    finally:
        gc.unfreeze()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_config()
        profiler.disarm()
        latency.disarm()


def svc_cell(cell, make, rows_of, gate, ckpt=None, env=None):
    """``cell`` four times in turns (disarmed, armed, armed, disarmed):
    each run's rows through ``gate``, equal rows and launches across the
    four; every sink of an armed run with a p99.  Returns (runs, summed
    launches)."""
    runs, total = [], collections.Counter()
    first = None
    for armed in (False, True, True, False):
        rows, res, launches = svc_run(cell, make, rows_of, armed, ckpt,
                                      env=env)
        gate(rows)
        if first is None:
            first = (rows, launches)
        else:
            check(svc_same(rows, first[0]), f"{res['job']}: rows differ from "
                  f"the first {cell} run's")
            check(launches == first[1], f"{res['job']}: launches {launches} "
                  f"against the first {cell} run's {first[1]}")
        res["launches"] = launches
        runs.append(res)
        total.update(launches)
    return runs, total


def svc_same(a, b):
    if isinstance(a, tuple):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return a == b


def svc_sinks(runs, program, what):
    sinks = {n.operator_id for n in program.sinks()}
    for r in runs:
        if r["armed"]:
            check(set(r["sinks"]) == sinks and all(
                q["p99_ms"] > 0 for q in r["sinks"].values()),
                f"{what} {r['job']}: sink latency {r['sinks']} for sinks "
                f"{sorted(sinks)}")


def services_phase():
    """The engine services on q5, config5 and 8a (phase 16)."""
    out, launches = {}, {}

    def q5():
        return program_for("q5", NUM_EVENTS, "svc-q5"), "svc-q5"

    def q5_gate(rows):
        check(rows and rows == CONTROLS["q5"] and rows == HAND["q5"][0],
              f"services q5: {len(rows)} rows against the numpy control's "
              f"{len(CONTROLS['q5'])}")

    runs, launches["services_q5"] = svc_cell("q5", q5, q5_rows, q5_gate)
    svc_sinks(runs, q5()[0], "services q5")
    check(all(launches["services_q5"][k] > 0
              for k in ("bin_update", "argmax_fire", "bin_evict")),
          f"services q5 launched too few kernels: {launches['services_q5']}")
    rows, timed, tl, work, runner = svc_run("q5", q5, q5_rows, False,
                                            timing=True)
    q5_gate(rows)
    check(tl == runs[0]["launches"], f"services q5 under ARROYO_TIMING: "
          f"launches {tl} against {runs[0]['launches']}")
    bin_ops = [op_id for (op_id, _i), (op, _c) in runner.engine.members.items()
               if isinstance(op, BinAggOperator)]
    check(bin_ops and all(work.get((o, "device_execute"), 0.0) > 0
                          for o in bin_ops),
          f"services q5 under ARROYO_TIMING: no device_execute for {bin_ops}:"
          f" {sorted(work)}")
    launches["services_q5"].update(tl)
    out["q5"] = runs + [timed]

    def q5_tail():
        return (q5_program(NUM_EVENTS, Q5_TAIL_BATCH, "svc-q5-tail",
                           event_rate=Q5_TAIL_RATE, base_time_micros=0),
                "svc-q5-tail")

    control = q5_control(NUM_EVENTS, Q5_TAIL_RATE, Q5_TAIL_BATCH)
    rows, tail, tail_launches = svc_run("q5_tail", q5_tail, q5_rows, True)
    check(rows and rows == control, f"services q5 tail: {len(rows)} rows "
          f"against the numpy control's {len(control)}")
    svc_sinks([tail], q5_tail()[0], "services q5 tail")
    check(all(q["count"] >= Q5_TAIL_SAMPLES for q in tail["sinks"].values()),
          f"services q5 tail: sink samples {tail['sinks']}, fewer than "
          f"{Q5_TAIL_SAMPLES}")
    launches["services_q5"].update(tail_launches)
    out["q5"].append(tail)

    def c5():
        return (program_for("config5", C5_EVENTS, "svc-c5", broker="c5-big"),
                "svc-c5")

    def c5_gate(rows):
        check(rows and rows == CONTROLS["config5"], f"services config5: "
              f"{len(rows)} rows against the numpy control's "
              f"{len(CONTROLS['config5'])}")

    # uncoalesced: coalesced merges, and so launches, follow arrival times
    # and the 1 s barriers (ROADMAP C6)
    runs, launches["services_config5"] = svc_cell(
        "config5", c5, c5_table, c5_gate, ckpt=1.0,
        env={"ARROYO_COALESCE": "0"})
    check(all(r["epochs"] > 0 for r in runs),
          f"services config5: epochs {[r['epochs'] for r in runs]}")
    check(all(launches["services_config5"][k] > 0
              for k in ("session_union", "segment_agg")),
          f"services config5 launched too few kernels: "
          f"{launches['services_config5']}")
    out["config5"] = runs

    def js():
        return (join_stress_program(JS_INNER, JoinType.INNER, TTL_MICROS,
                                    "svc-8a", JS_BATCH), "svc-8a")

    runs, launches["services_8a"] = svc_cell(
        "8a", js, js_output,
        lambda rows: CONTROLS["gate_inner"](*rows))
    svc_sinks(runs, js()[0], "services 8a")
    check(all(launches["services_8a"][k] > 0
              for k in ("join_probe", "expand_gather", "ring_merge")),
          f"services 8a launched too few kernels: {launches['services_8a']}")
    out["8a"] = runs
    for cell, rs in out.items():
        for r in rs:
            print(f"services {cell} {r['job']}: " + json.dumps(
                {k: v for k, v in r.items() if k != "job"}))
        walls = [r["wall_s"] for r in rs[:4]]
        print(f"services {cell}: armed/disarmed wall in turns "
              + json.dumps([walls[1] / walls[0], walls[2] / walls[3]]))
    return {k: dict(v) for k, v in launches.items()}


# -- phase 17: the host library ------------------------------------------------------


class numpy_host_path:
    """The port's host library switched off for a block: every binding
    runs its numpy version and new states keep the sorted directory."""

    def __enter__(self):
        self.saved = native._lib
        native._lib = None

    def __exit__(self, *exc):
        native._lib = self.saved


def native_run(cell, make, rows_of, library):
    """One run on the card, the host library on or off, the profiler
    armed: (rows, wall s, the phase table, launches)."""
    job = f"native-{cell}-{'lib' if library else 'numpy'}"
    program, sink = make()
    clear_sink(sink)
    profiler.disarm()
    runner = LocalRunner(program, job_id=job)
    prof = profiler.arm(job)
    prof.reset()
    reset_launches()
    t0 = time.perf_counter()
    try:
        if library:
            runner.run()
        else:
            with numpy_host_path():
                runner.run()
        torch.cuda.synchronize()
    finally:
        profiler.disarm()
    wall = time.perf_counter() - t0
    launches = read_launches()
    rows = rows_of(sink_output(sink))
    clear_sink(sink)
    return rows, wall, prof.snapshot()["phases"], launches


def native_phase():
    """q5 (NUM_EVENTS in batches of BATCH, C = C_Q5) and hot items
    (HOT_SMALL) with the host library and without it, in turns (library,
    numpy, numpy, library): every run's rows equal to its numpy control,
    each run's wall and the profiler's ``proc`` printed, the kernels of
    the path launched by every run."""
    controls = {"q5": q5_control(NUM_EVENTS), "hot": hot_control(HOT_SMALL)}
    cells = {
        "q5": (lambda: (q5_program(NUM_EVENTS, BATCH, "native-q5",
                                   base_time_micros=0), "native-q5"),
               q5_rows,
               lambda rows: check(rows == controls["q5"],
                                  f"phase 17 q5: {len(rows)} rows against "
                                  f"the control's {len(controls['q5'])}"),
               ("bin_update", "argmax_fire", "bin_evict")),
        "hot": (lambda: (hot_items_program(HOT_SMALL, BATCH,
                                           sink="native-hot",
                                           base_time_micros=0), "native-hot"),
                hot_table,
                lambda rows: hot_gate(rows, controls["hot"]),
                ("bin_update", "segment_top_k")),
    }
    launches, out = {}, {}
    for cell, (make, rows_of, gate, need) in cells.items():
        total = collections.Counter()
        runs = []
        for library in (True, False, False, True):
            rows, wall, phases, ln = native_run(cell, make, rows_of, library)
            gate(rows)
            check(all(ln[k] > 0 for k in need),
                  f"phase 17 {cell}: launches {ln}")
            total.update(ln)
            runs.append({"library": library, "wall_s": wall,
                         "proc_s": phases.get("proc", 0.0),
                         "source_decode_s": phases.get("source_decode", 0.0),
                         "phases": phases})
        lib = [r for r in runs if r["library"]]
        off = [r for r in runs if not r["library"]]
        out[cell] = {
            "runs": runs,
            "wall_numpy_over_library": statistics.fmean(
                r["wall_s"] for r in off) / statistics.fmean(
                r["wall_s"] for r in lib),
            "proc_numpy_over_library": statistics.fmean(
                r["proc_s"] for r in off) / statistics.fmean(
                r["proc_s"] for r in lib)}
        launches[f"native_{cell}"] = dict(total)
    print("host library: " + json.dumps(out))
    return launches


# -- phase 18: exactly-once sinks ---------------------------------------------------

SINK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_sinks")
CUT_POLLS = (100, 200, 300, 301)  # config5's 489 batches: epochs 1-3, stop
# kafka c5's events, cut from C5_EVENTS: at 2M the phase took 55.5-76.4 s
# on an NVIDIA H100 80GB HBM3 at 700.00 W (the host's pure-Python Avro
# encode and decode are the JAX package's design), against a 60 s budget
KAFKA_C5_EVENTS = 1_000_000


def fs_sink(root):
    return (f"CREATE TABLE out WITH (connector = 'filesystem', path = "
            f"'file://{root}', format = 'json', type = 'sink');")


def part_listing(root):
    """(final part names, staged part names) under ``root``."""
    final, staged = [], []
    for dirpath, _, names in os.walk(root):
        for n in names:
            (staged if ".staging" in dirpath else final).append(n)
    return sorted(final), sorted(staged)


def part_rows(root):
    """The promoted parts' rows as sorted (k, med, cnt, window_start,
    window_end) tuples."""
    rows = []
    for name in part_listing(root)[0]:
        with open(os.path.join(root, name)) as f:
            for line in f:
                r = json.loads(line)
                rows.append(tuple(r[c] for c in C5_COLS))
    return sorted(rows)


COMMIT_KEYS = {"commits": "sink_commits_total",
               "parts_promoted": "sink_precommits_committed_total",
               "commit_s": "sink_commit_seconds_total"}


def commit_totals(job_id):
    """The job's two-phase sink counters (``obs.metrics``'s
    ``sink_commit_counters``), summed over its sink subtasks: epochs
    committed, pre-commits finalized (parts for the filesystem sink,
    transactions for Kafka) and seconds in the commit phase."""
    out = dict.fromkeys(COMMIT_KEYS, 0.0)
    for op in metrics.job_operator_summary(job_id).values():
        for k, name in COMMIT_KEYS.items():
            out[k] += op.get(name, 0.0)
    return out


def commits_since(job_id, before):
    now = commit_totals(job_id)
    return {k: now[k] - before[k] for k in COMMIT_KEYS}


def sealed_epochs(resps, n_members):
    done = collections.Counter(r.subtask_metadata.epoch for r in resps
                               if r.kind == "checkpoint_completed")
    return sorted(e for e, c in done.items() if c == n_members)


def fs_straight(root):
    """config5 into the filesystem sink with 1 s checkpoints; (wall s,
    launches, sealed epochs, commit counters)."""
    runner = LocalRunner(plan_sql(config5_sql(
        C5_EVENTS, C5_BATCH, "c5-big", "json", fs_sink(root))),
        job_id="c5-fs", device="cuda")
    before = commit_totals("c5-fs")
    reset_launches()
    t0 = time.perf_counter()
    resps = runner.run(checkpoint_interval_secs=1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    return wall, launches, sealed_epochs(resps, len(runner.engine.members)), \
        commits_since("c5-fs", before)


def fs_cut(root):
    """Epochs 1 and 2 sealed and committed, epoch 3 sealed, an IMMEDIATE
    stop before its commit; a fresh engine restored from epoch 3 runs to
    the end with 1 s checkpoints.  Returns the cut's and the restore's
    figures."""
    sql = config5_sql(C5_EVENTS, C5_BATCH, "c5-big", "json", fs_sink(root))
    before = commit_totals("c5-cut")
    t0 = time.perf_counter()
    epoch = asyncio.run(cut_before_commit(
        lambda: Engine.for_local(plan_sql(sql), "c5-cut", device="cuda"),
        CUT_POLLS, StopMode.IMMEDIATE))
    torch.cuda.synchronize()
    cut_wall = time.perf_counter() - t0
    cut_commits = commits_since("c5-cut", before)
    at_cut = part_listing(root)
    runner = LocalRunner(plan_sql(sql), job_id="c5-cut", device="cuda",
                         restore_epoch=epoch)
    before = commit_totals("c5-cut")
    t0 = time.perf_counter()
    resps = runner.run(checkpoint_interval_secs=1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"cut_epoch": epoch, "cut_wall_s": cut_wall,
            "cut_final_parts": len(at_cut[0]),
            "cut_staged_parts": len(at_cut[1]),
            "cut_commits": cut_commits,
            "restore_wall_s": wall,
            "restore_epochs": sealed_epochs(resps,
                                            len(runner.engine.members)),
            "restore_commits": commits_since("c5-cut", before)}


class TxnTap:
    """Wraps this output broker's ``commit_txn``: the rows a
    ``read_committed`` and a ``read_uncommitted`` read see before each
    commit, and the rows ``read_committed`` sees after it."""

    def __init__(self, broker, topic):
        self.broker, self.topic = broker, topic
        self.before, self.after = [], []

    def count(self, committed):
        return len(self.broker.fetch_values(self.topic, 0, 0, 1 << 40,
                                            committed)[0])

    def __enter__(self):
        orig = self.broker.commit_txn

        def commit_txn(txn_id):
            self.before.append((self.count(True), self.count(False)))
            orig(txn_id)
            self.after.append(self.count(True))

        self.broker.commit_txn = commit_txn
        return self

    def __exit__(self, *exc):
        del self.broker.commit_txn


def kafka_c5(n):
    """config5 over ``n`` Avro events into the transactional Kafka sink
    (JSON rows) with 1 s checkpoints; the produce outside the timed run."""
    sink = ("CREATE TABLE out WITH (connector = 'kafka', bootstrap_servers "
            "= 'memory://c5-out', topic = 'c5', type = 'sink', "
            "format = 'json');")
    program = plan_sql(config5_sql(n, C5_BATCH, "c5-avro", "avro", sink))
    (source,) = [nd for nd in program.nodes()
                 if nd.operator.kind == OpKind.CONNECTOR_SOURCE]
    schema = source.operator.spec.config["format_options"]["schema"]
    t0 = time.perf_counter()
    config5_produce("c5-avro", n, 0, C5_SPACING, avro_schema=schema)
    produce_s = time.perf_counter() - t0
    InMemoryKafkaBroker.reset("c5-out")
    broker = InMemoryKafkaBroker.get("c5-out")
    runner = LocalRunner(program, job_id="c5-kafka", device="cuda")
    before = commit_totals("c5-kafka")
    reset_launches()
    with TxnTap(broker, "c5") as tap:
        t0 = time.perf_counter()
        resps = runner.run(checkpoint_interval_secs=1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    payloads, _ = broker.fetch_values("c5", 0, 0, 1 << 40, True)
    rows = sorted(tuple(r[c] for c in C5_COLS) for r in
                  make_format("json").deserialize(payloads))
    read_s = time.perf_counter() - t0
    return {"events": n, "schema": schema, "produce_s": produce_s,
            "wall_s": wall, "events_per_s": n / wall, "read_s": read_s,
            "epochs": sealed_epochs(resps, len(runner.engine.members)),
            **commits_since("c5-kafka", before),
            "commits_before": tap.before, "commits_after": tap.after}, \
        rows, launches


def sink_phase():
    """Phase 18: config5 as deployed, into the filesystem sink (straight,
    and cut after a sealed epoch and restored) and, over Avro events,
    into the transactional Kafka sink."""
    unregister_udfs()
    register_udaf("median", np.median)
    shutil.rmtree(SINK_DIR, ignore_errors=True)
    control = [r[1:] for r in CONTROLS["config5"]]
    memory = [r[1:] for r in CONTROLS["config5_rows"]]
    try:
        root = os.path.join(SINK_DIR, "straight")
        wall, fs_launches, epochs, commits = fs_straight(root)
        rows = part_rows(root)
        final, staged = part_listing(root)
        check(rows == sorted(memory) == sorted(control),
              f"fs c5: {len(rows)} promoted rows against phase 7's "
              f"{len(memory)} and the control's {len(control)}")
        check(not staged, f"fs c5 left staged parts: {staged}")
        check(len(epochs) > 0 and commits["parts_promoted"] > 0,
              f"fs c5 sealed {epochs} and committed {commits}")
        check(fs_launches["session_union"] > 0
              and fs_launches["segment_agg"] > 0,
              f"fs c5 did not launch both kernels: {fs_launches}")
        fs = {"events": C5_EVENTS, "wall_s": wall,
              "events_per_s": C5_EVENTS / wall, "rows": len(rows),
              "epochs": epochs, "parts": len(final),
              **commits, "launches": fs_launches}

        root = os.path.join(SINK_DIR, "cut")
        cut = fs_cut(root)
        cut_rows = part_rows(root)
        check(cut["cut_epoch"] == 3 and cut["cut_staged_parts"] > 0,
              f"fs c5 cut: {cut}")
        check(cut["restore_commits"]["parts_promoted"] >=
              cut["cut_staged_parts"], f"fs c5 restore: {cut}")
        check(cut_rows == rows and len(set(cut_rows)) == len(cut_rows),
              f"fs c5 cut and restored: {len(cut_rows)} rows "
              f"({len(set(cut_rows))} distinct) against {len(rows)}")
        check(not part_listing(root)[1], "fs c5 cut left staged parts")

        kafka, kafka_rows, kafka_launches = kafka_c5(KAFKA_C5_EVENTS)
        want = sorted(r[1:] for r in c5_control(KAFKA_C5_EVENTS))
        # a key's burst lies in one block: the blocks the cut leaves whole
        # have fs c5's sessions
        whole = KAFKA_C5_EVENTS // (KEYS_PER_BLOCK * BURST) * KEYS_PER_BLOCK
        same = [r for r in kafka_rows if r[0] < whole]
        check(kafka_rows == want and same == [r for r in rows
                                              if r[0] < whole],
              f"kafka c5: {len(kafka_rows)} read_committed rows against "
              f"the control's {len(want)}; {len(same)} of whole blocks")
        before, after = kafka.pop("commits_before"), kafka.pop(
            "commits_after")
        # the in-process broker holds a transaction's rows outside the log
        # until its commit: neither reader sees the open one before it
        check(len(before) > 1 and kafka["commits"] > 0
              and before[-1][0] < after[-1] == len(kafka_rows)
              and before[-1][1] == before[-1][0],
              f"kafka c5: before the last commit {before[-1:]}, after it "
              f"{after[-1:]} ({len(kafka_rows)} rows in all)")
        check(kafka_launches["session_union"] > 0
              and kafka_launches["segment_agg"] > 0,
              f"kafka c5 did not launch both kernels: {kafka_launches}")
        kafka.update(rows=len(kafka_rows), launches=kafka_launches,
                     transactions=len(before),
                     transactions_committed=kafka.pop("parts_promoted"),
                     last_commit={"read_committed_rows": before[-1][0],
                                  "read_uncommitted_rows": before[-1][1],
                                  "open_txn_rows": after[-1] - before[-1][0]})
    finally:
        shutil.rmtree(SINK_DIR, ignore_errors=True)
        unregister_udfs()
    print("exactly-once sinks: " + json.dumps(
        {"fs_c5": fs, "fs_c5_cut": cut, "kafka_c5": kafka}))
    return {"fs_c5": fs_launches, "kafka_c5": kafka_launches}


# -- phase 19: long windows ---------------------------------------------------

HOP_EVENTS = 4_000_000  # 400 s of event time at 10,000 events/s
HOP_SMALL = 200_000
HOP_BATCH = 8_192
HOP_COLS = ("channel", "num", "total", "top", "window_start", "window_end")
# every channel a bid can name: the 4 hot ones, then channel-0 ..
# channel-9999 (connectors/nexmark.py)
HOP_CHANNEL_ID = {name: i for i, name in enumerate(
    list(HOT_CHANNELS) + [f"channel-{i}" for i in range(CHANNELS_NUMBER)])}
FIRE_KERNELS = ("pane_emit", "emit_count", "emit_gather", "argmax_fire")


class recorded_bids:
    """Within the block, every batch the port's nexmark generator makes
    leaves its bids' channel, timestamp and price in ``parts``: the
    control reads the very events a run read."""

    def __enter__(self):
        self.parts = []
        self.orig = orig = NexmarkGenerator.next_batch
        parts = self.parts

        def next_batch(gen, size):
            b, nums = orig(gen, size)
            bid = b.columns["event_type"] == EVENT_BID
            parts.append((b.columns["bid_channel"][bid], b.timestamp[bid],
                          b.columns["bid_price"][bid]))
            return b, nums

        NexmarkGenerator.next_batch = next_batch
        return self

    def __exit__(self, *exc):
        NexmarkGenerator.next_batch = self.orig


def channel_ids(names):
    return np.fromiter(map(HOP_CHANNEL_ID.__getitem__, names), np.int64,
                       count=len(names))


def sliding_max(x, w):
    """Row j of the result: the column-wise maximum of rows j - w + 1 ..
    j of ``x`` (van Herk's blocks), for j >= w - 1."""
    n, m = x.shape
    nb = -(-n // w)
    pad = np.full((nb * w - n, m), x.min(initial=0) - 1, dtype=x.dtype)
    blocks = np.concatenate([x, pad]).reshape(nb, w, m)
    pre = np.maximum.accumulate(blocks, axis=1).reshape(-1, m)
    suf = np.maximum.accumulate(blocks[:, ::-1], axis=1)[:, ::-1].reshape(
        -1, m)
    j = np.arange(w - 1, n)
    return np.maximum(suf[j - w + 1], pre[j])


def hop_control(parts):
    """queries.HOP_CHANNELS from the generator's bids: per window end
    (in seconds) and channel the bids, the integer sum of their prices
    and the largest; grids [window ends, channels], count 0 where no
    bid."""
    ch = channel_ids(np.concatenate([p[0] for p in parts]))
    sec = np.concatenate([p[1] for p in parts]) // 1_000_000
    price = np.concatenate([p[2] for p in parts]).astype(np.int64)
    check(sec.min() >= 0, "long windows: negative event time")
    n_ch, n_s = len(HOP_CHANNEL_ID), int(sec.max()) + 1
    cell = sec * n_ch + ch
    size = n_s * n_ch
    cnt = np.bincount(cell, minlength=size).reshape(n_s, n_ch)
    tot = np.zeros(size, dtype=np.int64)
    np.add.at(tot, cell, price)
    top = np.full(size, -1, dtype=np.int64)
    np.maximum.at(top, cell, price)
    # window e covers the seconds e - W + 1 .. e, e < n_s + W - 1: with
    # W - 1 empty seconds before and after, padded rows e .. e + W - 1
    n_w = n_s + HOP_W - 1
    edge = np.zeros((HOP_W - 1, n_ch), dtype=np.int64)

    def trailing_sums(x):
        c = np.cumsum(np.concatenate([edge, x.reshape(n_s, n_ch), edge]),
                      axis=0)
        c = np.concatenate([np.zeros((1, n_ch), np.int64), c])
        return c[HOP_W:HOP_W + n_w] - c[:n_w]

    win_top = sliding_max(np.concatenate(
        [edge - 1, top.reshape(n_s, n_ch), edge - 1]), HOP_W)
    return trailing_sums(cnt), trailing_sums(tot), win_top


def hop_columns(sink):
    """The sink's rows as {column: array}, in the order they came; the
    sink cleared."""
    batches = sink_output(sink)
    cols = {c: np.concatenate([b.columns[c] for b in batches])
            for c in HOP_COLS}
    clear_sink(sink)
    return cols


def hop_grid(cols, shape):
    """Rows as grids like ``hop_control``'s: each (window end, channel) at
    most once, window_start its end less 300 s."""
    e = cols["window_end"] // 1_000_000 - 1
    check(np.array_equal(cols["window_end"] - cols["window_start"],
                         np.full(len(e), HOP_W * 1_000_000)),
          "long windows: a window that is not 300 s wide")
    check(len(e) == 0 or (e.min() >= 0 and e.max() < shape[0]),
          f"long windows: window ends outside the control's "
          f"{shape[0]} seconds")
    cell = e * shape[1] + channel_ids(cols["channel"])
    check(len(cell) == 0 or np.bincount(cell).max() == 1, "long windows: "
          "a (window, channel) emitted twice")
    grids = []
    for c, dtype in (("num", np.int64), ("total", np.float64),
                     ("top", np.float64)):
        g = np.zeros(shape[0] * shape[1], dtype=dtype)
        g[cell] = cols[c]
        grids.append(g.reshape(shape))
    return grids


def hop_same(grids, control, what):
    """Rows against the control: every (window, channel) with bids, its
    count, its sum of prices (exact in f64) and its largest price."""
    cnt, tot, top = grids
    want_cnt, want_tot, want_top = control
    live = want_cnt > 0
    check(np.array_equal(cnt, want_cnt)
          and np.array_equal(tot[live], want_tot[live].astype(np.float64))
          and np.array_equal(top[live], want_top[live].astype(np.float64)),
          f"long windows ({what}): rows differ from the numpy control")


def hop_run(num_events, sink, device, ring, timing=False):
    """queries.HOP_CHANNELS at ``num_events`` in batches of HOP_BATCH,
    event time pinned, under ARROYO_RING=``ring`` on ``device``; (wall s,
    launches, perf counters); the rows stay in ``sink``."""
    env = {"ARROYO_RING": ring}
    if timing:
        env["ARROYO_TIMING"] = "1"
    perf.reset()
    reset_launches()
    dt, runner, program = sql_cell(queries.HOP_CHANNELS, num_events, sink,
                                   device, env, batch=HOP_BATCH)
    launches = read_launches()
    aggs = [n.operator.spec for n in program.nodes()
            if n.operator.kind == OpKind.SLIDING_WINDOW_AGGREGATOR]
    check(len(aggs) == 1 and aggs[0].width_micros
          == HOP_W * aggs[0].slide_micros == HOP_W * 1_000_000,
          f"long windows: planned {aggs}")
    counters = {k: perf.counter(k) for k in (
        "bin_ring_fires", "kernel_dispatches", "device_ns",
        "device_ns:ring_emit", "device_ns:pane_emit",
        "device_ns:emit_count", "device_ns:emit_gather")}
    return dt, launches, counters


def hop_launched(launches, ring, fires, what):
    mine = launches["ring_emit"]
    others = sum(launches[k] for k in FIRE_KERNELS)
    if ring == "on":
        check(mine > 0 and mine == fires and others == 0,
              f"long windows ({what}): {mine} ring_emit launches for "
              f"{fires} ring fires, {others} other fire launches")
    else:
        check(mine == 0 and launches["pane_emit"] + launches["emit_count"]
              > 0, f"long windows ({what}): launches {launches}")
    check(launches["bin_update"] > 0 and launches["bin_evict"] > 0,
          f"long windows ({what}): launches {launches}")


def hop_phase():
    """Phase 19: the per-channel five-minute dashboard on the ring branch
    and on the dense/compact branches, in turns, against a numpy control;
    the CPU's ring rows; q5 with its fires on the ring."""
    out, launches = {}, {}
    control, first = None, None
    for name in ("hop_on_1", "hop_off_1", "hop_off_2", "hop_on_2"):
        ring = name.split("_")[1]
        if control is None:
            with recorded_bids() as rec:
                dt, l, counters = hop_run(HOP_EVENTS, "hop", None, ring,
                                          timing=True)
            t0 = time.perf_counter()
            control = hop_control(rec.parts)
            out["control_s"] = time.perf_counter() - t0
        else:
            dt, l, counters = hop_run(HOP_EVENTS, "hop", None, ring,
                                      timing=True)
        fires = counters["bin_ring_fires"]
        hop_launched(l, ring, fires, name)
        t0 = time.perf_counter()
        cols = hop_columns("hop")
        # rows in the first run's order are its rows; the first run and
        # any run in another order are held to the control
        in_order = first is not None and same_columns(cols, first)
        if not in_order:
            hop_same(hop_grid(cols, control[0].shape), control, name)
        if first is None:
            first = cols
        launches[name] = l
        fire_ms = {k.split(":")[1]: counters[k] / 1e6 for k in counters
                   if k.startswith("device_ns:") and counters[k]}
        out[name] = {"events": HOP_EVENTS, "wall_s": dt,
                     "events_per_s": HOP_EVENTS / dt,
                     "rows": len(cols["num"]), "ring_fires": fires,
                     "launches": {k: v for k, v in l.items() if v},
                     "device_ms_by_call": fire_ms,
                     "device_ms": counters["device_ns"] / 1e6,
                     "kernel_dispatches": counters["kernel_dispatches"],
                     "in_first_runs_order": in_order,
                     "compare_s": time.perf_counter() - t0}
    del first, cols
    out["windows_x_channels"] = list(control[0].shape)
    out["control_rows"] = int((control[0] > 0).sum())

    small = {}
    for device in (None, "cpu"):
        dt, l, counters = hop_run(HOP_SMALL, "hop-small", device, "on")
        small[device] = (hop_columns("hop-small"), dt, l,
                         counters["bin_ring_fires"])
    (card, dt_card, l_card, f_card), (cpu, dt_cpu, _l, f_cpu) = (
        small[None], small["cpu"])
    if not same_columns(card, cpu):  # another order: sort both
        card, cpu = (sorted_columns({**c, "channel": channel_ids(
            c["channel"])}, ("window_end", "channel")) for c in (card, cpu))
    check(len(card["num"]) > 0 and same_columns(card, cpu),
          f"long windows at {HOP_SMALL} events: rows differ between card "
          f"and cpu ({len(card['num'])} vs {len(cpu['num'])})")
    hop_launched(l_card, "on", f_card, "hop_small")
    launches["hop_small"] = l_card
    out["hop_small"] = {"events": HOP_SMALL, "wall_s": dt_card,
                        "cpu_wall_s": dt_cpu, "rows": len(card["num"]),
                        "ring_fires": f_card, "cpu_ring_fires": f_cpu}

    os.environ["ARROYO_RING"] = "on"
    perf.reset()
    reset_launches()
    try:
        dt, rows, _tasks = run_q5("q5-ring", None)
    finally:
        del os.environ["ARROYO_RING"]
    l = read_launches()
    check(rows and rows == CONTROLS["q5"] and rows == HAND["q5"][0],
          f"q5 on the ring: {len(rows)} rows against the control's "
          f"{len(CONTROLS['q5'])}")
    hop_launched(l, "on", perf.counter("bin_ring_fires"), "q5_ring")
    launches["q5_ring"] = l
    out["q5_ring"] = {"events": NUM_EVENTS, "wall_s": dt, "rows": len(rows),
                      "ring_fires": perf.counter("bin_ring_fires"),
                      "launches": {k: v for k, v in l.items() if v}}
    print("long windows: " + json.dumps(out))
    return launches


# -- phase 20: the keyed mesh ------------------------------------------------------

# four key shards of q5's aggregate on the one card (ROADMAP A.10: the
# smoke host has one card; distinct cards run the same code)
MESH_DEVICES = ("cuda:0",) * MESH_NK
MESH_SINGLE = "cuda:0"
MESH_COUNTERS = ("reshard_transfers", "shuffle_collectives",
                 "shuffle_collective_rows", "shuffle_host_routes",
                 "mesh_ingest_transfers", "pane_update_dispatches")
MESH_PATH_KERNELS = ("mesh_route", "mesh_merge", "mesh_remap", "bin_update",
                     "pane_emit")
MESH_CUT_POLL = 8  # q5's batches before the cut's barrier
# the cut's event rate: 2M events span 20 s of event time, so q5's
# windows ending at 2-10 s fire before the cut (at bench.py's 1M events/s
# every window fires at the end of the stream)
MESH_CUT_RATE = 100_000.0


def q5_sorted_rows(sink):
    return sorted((int(b.timestamp[i]), int(b.columns["auction"][i]),
                   int(b.columns["num"][i]))
                  for b in sink_output(sink) for i in range(len(b)))


def mesh_run(program, sink, device):
    """``program`` through LocalRunner on ``device`` with the launch and
    perf counts set to 0 first: (wall s, rows, launches, counters, the
    mesh states)."""
    clear_sink(sink)
    perf.reset()
    reset_launches()
    dt, runner = run_program(program, device)
    launches = read_launches()
    states = [op.state for _id, op in operators(runner)
              if isinstance(getattr(op, "state", None), MeshKeyedBinState)]
    return (dt, q5_sorted_rows(sink), launches,
            {k: perf.counter(k) for k in MESH_COUNTERS}, states)


def mesh_par2(mode):
    """q5 planned at parallelism 2 on the mesh, the device shuffle
    ``mode`` (on/off), the sanitizer armed."""
    program = plan_sql(sql_text("q5", NUM_EVENTS), parallelism=2)
    for node in program.nodes():
        if node.operator.kind == OpKind.CONNECTOR_SINK:
            node.operator.spec.config["name"] = "mesh-par2"
    os.environ.update(ARROYO_SHUFFLE_DEVICE=mode, ARROYO_SANITIZE="1")
    try:
        return mesh_run(program, "mesh-par2", MESH_DEVICES)
    finally:
        del os.environ["ARROYO_SHUFFLE_DEVICE"], os.environ["ARROYO_SANITIZE"]


def mesh_cut_program():
    return q5_program(NUM_EVENTS, BATCH, "mesh-cut", event_rate=MESH_CUT_RATE,
                      base_time_micros=0)


def record_bin_state(engine, method, into):
    """After each call of ``method`` on a bin state that the started
    ``engine`` built, append (state type, next_slot, count mass) to
    ``into``: the mass is the snapshot's ``bin_counts`` summed where the
    call returns a snapshot, else the state's count planes summed on the
    device."""
    for op, _ctx in engine.members.values():
        st = getattr(op, "state", None)
        if not hasattr(st, "total_rows"):
            continue

        def wrapped(*args, _st=st, _f=getattr(st, method), **kwargs):
            out = _f(*args, **kwargs)
            if isinstance(out, dict):
                mass = int(np.asarray(out["bin_counts"]).sum())
            else:
                planes = getattr(_st, "d_counts", None) or [_st.counts]
                mass = int(sum(int(c.sum()) for c in planes))
            into.append((type(_st).__name__, _st.next_slot, mass))
            return out

        setattr(st, method, wrapped)


async def mesh_cut(job, at_cut):
    """The cut's q5 on the mesh, checkpointed at MESH_CUT_POLL's barrier
    and stopped there (the checkpoint's then_stop); the epoch.  The mesh
    state's slots and count mass at its snapshot go into ``at_cut``."""
    engine = Engine.for_local(mesh_cut_program(), job, device=MESH_DEVICES)
    running = engine.start()
    record_bin_state(engine, "snapshot", at_cut)
    held, = hold_sources(engine, (MESH_CUT_POLL,))
    await held.wait()
    await running.checkpoint(1, then_stop=True)
    await running.join()
    return 1


async def mesh_resume(job, epoch, restored):
    """The cut's q5 restored from ``epoch`` on one device and run to its
    end; the restored state's slots and count mass go into
    ``restored``."""
    engine = Engine.for_local(mesh_cut_program(), job, restore_epoch=epoch,
                              device=MESH_SINGLE)
    running = engine.start()
    record_bin_state(engine, "restore", restored)
    await running.join()
    return engine


def mesh_restore():
    """A 4-shard epoch restored on one device: the cut run's rows plus the
    restored run's, each row once, against the same program's straight
    run on one device; the restored state's slots and count mass those of
    the mesh state's snapshot at the cut."""
    clear_sink("mesh-cut")
    _dt, _runner = run_program(mesh_cut_program(), MESH_SINGLE)
    straight = q5_sorted_rows("mesh-cut")
    clear_sink("mesh-cut")
    at_cut, restored = [], []
    t0 = time.perf_counter()
    epoch = asyncio.run(mesh_cut("mesh-cut", at_cut))
    if MESH_SINGLE != "cpu":
        torch.cuda.synchronize()
    cut_wall = time.perf_counter() - t0
    before = q5_sorted_rows("mesh-cut")
    clear_sink("mesh-cut")
    t0 = time.perf_counter()
    engine = asyncio.run(mesh_resume("mesh-cut", epoch, restored))
    if MESH_SINGLE != "cpu":
        torch.cuda.synchronize()
    after = q5_sorted_rows("mesh-cut")
    kinds = sorted({type(op.state).__name__
                    for op, _ctx in engine.members.values()
                    if hasattr(op, "state")})
    return before, after, straight, {
        "cut_epoch": epoch, "cut_wall_s": cut_wall,
        "restore_wall_s": time.perf_counter() - t0,
        "event_rate": MESH_CUT_RATE, "rows_straight": len(straight),
        "rows_before_cut": len(before), "rows_after_restore": len(after),
        "restored_states": kinds, "at_cut": at_cut, "restored": restored}


def mesh_phase():
    """Phase 20: q5 over four key shards of the card against the
    single-device rows and the control; the device shuffle at parallelism
    2 against the host route; a 4-shard epoch restored on one device."""
    out, launches = {}, {}
    control, single = CONTROLS["q5"], HAND["q5"][0]
    dt, rows, l, counters, states = mesh_run(
        program_for("q5", NUM_EVENTS, "mesh-q5"), "mesh-q5", MESH_DEVICES)
    check(rows and rows == control and rows == single,
          f"q5 on {MESH_NK} shards: {len(rows)} rows against the control's "
          f"{len(control)} and one device's {len(single)}")
    check(len(states) == 1 and states[0].nk == MESH_NK,
          f"q5 on the mesh built {states}")
    st = states[0]
    check(st.overflow_counters() == (0, 0) and counters["reshard_transfers"]
          == 0, f"q5 mesh: overflow {st.overflow_counters()}, {counters}")
    check(all(l[k] > 0 for k in MESH_PATH_KERNELS),
          f"q5 mesh did not launch every kernel of its path: {l}")
    launches["mesh_q5"] = l
    out["mesh_q5"] = {"events": NUM_EVENTS, "batch": BATCH, "wall_s": dt,
                      "events_per_s": NUM_EVENTS / dt, "rows": len(rows),
                      "shards": st.nk, "C": st.C, "B": st.B,
                      "shard_keys": st.shard_counts.tolist(),
                      "launches": {k: v for k, v in l.items() if v},
                      "counters": counters}
    cards = torch.cuda.device_count() if MESH_SINGLE != "cpu" else 1
    if cards > 1:
        devs = tuple(f"cuda:{i % cards}" for i in range(MESH_NK))
        dt2, rows2, _l, counters2, _s = mesh_run(
            program_for("q5", NUM_EVENTS, "mesh-q5"), "mesh-q5", devs)
        check(rows2 == rows and counters2["reshard_transfers"] == 0,
              f"q5 over {devs}: {len(rows2)} rows, {counters2}")
        out["mesh_q5_cards"] = {"devices": devs, "wall_s": dt2}
    else:
        print("mesh: one visible card; the shards ran as logical shards of "
              "cuda:0")

    runs = {}
    for mode in ("on", "off"):
        runs[mode] = mesh_par2(mode)
    (dt_on, rows_on, l_on, c_on, st_on), (dt_off, rows_off, _l, c_off,
                                          _st) = runs["on"], runs["off"]
    check(rows_on and rows_on == rows_off,
          f"q5 at parallelism 2: {len(rows_on)} rows with the device "
          f"shuffle, {len(rows_off)} with the host route")
    # the mesh states' routes count as collectives in both runs; the
    # device shuffle's exchanges replace every host route of the edge
    check(c_on["shuffle_collectives"] > c_off["shuffle_collectives"]
          and c_on["shuffle_host_routes"] == 0
          and c_off["shuffle_host_routes"] > 0
          and c_on["reshard_transfers"] == 0,
          f"q5 at parallelism 2: on {c_on}, off {c_off}")
    check(sorted(s.route_shift for s in st_on) == [1, 1],
          f"q5 at parallelism 2: route shifts "
          f"{[s.route_shift for s in st_on]}")
    launches["mesh_shuffle"] = l_on
    out["mesh_shuffle"] = {"wall_s_on": dt_on, "wall_s_off": dt_off,
                           "rows": len(rows_on), "equals_control":
                               rows_on == control,
                           "counters_on": c_on, "counters_off": c_off,
                           "launches_on": {k: v for k, v in l_on.items()
                                           if v}}

    before, after, straight, info = mesh_restore()
    every = before + after
    check(before and after and sorted(every) == straight
          and len(set(every)) == len(every),
          f"4 -> 1 restore: {len(before)} rows before the cut and "
          f"{len(after)} after, {len(straight)} in the straight run")
    check(cards > 1 or info["restored_states"] == ["KeyedBinState"],
          f"4 -> 1 restore built {info['restored_states']}")
    # one snapshot of the mesh state (the cut's checkpoint), one restore
    # of the single-device state: the same slots, and the snapshot's row
    # counts all on the card (a restore's total_rows is that mass too)
    cut, back = info["at_cut"], info["restored"]
    check(len(cut) == 1 and cut[0][0] == "MeshKeyedBinState"
          and len(back) == 1 and cut[0][1:] == back[0][1:]
          and cut[0][1] > 0,
          f"4 -> 1 restore: (state, next_slot, total_rows) {cut} at the "
          f"cut, {back} restored")
    out["mesh_restore"] = info
    print("mesh: " + json.dumps(out))
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--parent", help="a directory holding a git archive of the parent "
        "commit: phase 3 also times its pane_emit, bin_evict, segment_agg, "
        "expand_gather, ring_merge, join_probe, session_union, join_expand, "
        "bin_update, argmax_fire, join_sort, ring_emit, emit_count and "
        "emit_gather, "
        "and the join's (join_pairs too), the session union's and the "
        "keyed-bin state's callers (its key directory and snapshot too), "
        "in turns with this tree's")
    opts = parser.parse_args()
    smi = environment()
    parent = None
    if opts.parent:
        parent = parent_kernels(opts.parent)
        print(f"parent kernels from {opts.parent}: build "
              f"{parent.build_s:.3f} s")
        print("keyed-bin directory and snapshot against the parent: "
              + json.dumps(directory_callers(parent, "cuda")))
    seconds = {}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    kernels = timed("kernels", kernel_phase, parent)
    timed("state", state_phase)
    launches = {"q5": timed("q5", main_path), "q8": timed("q8", q8_phase),
                "config5": timed("config5", c5_phase)}
    launches["join_inner"], launches["join_left"] = timed("join_stress",
                                                          js_phase)
    launches["hot_items"] = timed("hot_items", hot_phase)
    launches["q1"] = timed("q1", q1_phase)
    launches["q7"] = timed("q7", q7_phase)
    launches["sql"] = timed("sql", sql_phase)
    launches.update(timed("reference", reference_phase))
    launches.update(timed("legacy", legacy_phase))
    launches.update(timed("semi_mw", semi_mw_phase))
    launches.update(timed("correlated_windows", cw_phase))
    launches.update(timed("services", services_phase))
    launches.update(timed("native", native_phase))
    launches.update(timed("sinks", sink_phase))
    launches.update(timed("long_windows", hop_phase))
    launches.update(timed("mesh", mesh_phase))
    print("phase seconds: " + json.dumps(seconds))
    for r in kernels:
        for path in PATHS:
            r[f"launches_{path}"] = launches[path][r["name"]]
        r["launches"] = sum(r[f"launches_{p}"] for p in PATHS)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
