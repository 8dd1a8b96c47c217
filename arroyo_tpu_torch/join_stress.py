"""bench.py's join-stress family as a Stream-API program: a skewed keyed
two-stream join with expiration.

``join_stress_program`` builds the node sequence of bench.py's
``run_join_stress``:

  impulse (1 ms of event time per event, batches of 8,192)
  -> watermark (no lateness) -> udf ``zl``: k = Zipf(s~1) rank over
     100,000 keys, v0 = counter -> key_by(k)              [left, build]
  impulse (same) -> watermark -> udf ``zr``: k = uniform over 100,000
     keys, v1 = counter -> key_by(k)                       [right, probe]
  -> join_with_expiration(TTL per side) -> memory sink

bench.py runs it as an INNER join with a 30 s TTL over 400,000 events a
side; ``join_type`` and ``ttl_micros`` also give the planner's shape of a
LEFT JOIN with its default 1 h TTL.  ``join_stress_keys`` recomputes the
keys a side's udf assigns, for controls that join the streams in numpy;
``state_bounded`` is bench.py's check that the join state tracked the
TTL horizon, not the stream."""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

from .graph.logical import JoinType, Program, Stream
from .types import hash_u64

N_KEYS = 100_000
BASE_TIME_MICROS = 1_700_000_000_000_000
INTERVAL_MICROS = 1_000  # 1 event/ms per side
BATCH = 8_192
TTL_MICROS = 30_000_000  # bench.py's 30 s
PLANNER_TTL_MICROS = 3_600_000_000  # sql/planner.py's DEFAULT_JOIN_TTL
# (name, kind) side schemas, as the planner passes them, so an outer
# join's pads carry the other side's columns before it has sent a batch
LEFT_COLS = (("k", "i"), ("v0", "i"))
RIGHT_COLS = (("k", "i"), ("v1", "i"))


def join_stress_keys(counter: np.ndarray, side: int) -> np.ndarray:
    """The join key (i64) bench.py's udf gives each counter of a side:
    side 0 Zipf(s~1) ranks in [1, 100,000) (the head keys take a constant
    share of the rows), side 1 uniform over [0, 100,000)."""
    c = np.asarray(counter, dtype=np.int64)
    if side == 1:
        return (hash_u64(c + 7_919) % np.uint64(N_KEYS)).astype(np.int64)
    u = (hash_u64(c) >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    u = np.maximum(u, 1e-12)
    return np.exp(u * np.log(float(N_KEYS))).astype(np.int64)


def zipf_map(side: int) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """bench.py's per-side udf: {k, v<side>} from the impulse counter."""
    def fn(cols: Dict[str, Any]) -> Dict[str, Any]:
        c = np.asarray(cols["counter"], dtype=np.int64)
        return {"k": join_stress_keys(c, side), f"v{side}": c}

    return fn


def join_stress_program(n_per_side: int, join_type: JoinType = JoinType.INNER,
                        ttl_micros: int = TTL_MICROS,
                        sink: str = "join_stress",
                        batch_size: int = BATCH) -> Program:
    """The join-stress pipeline over ``n_per_side`` events per side,
    writing to the memory sink named ``sink``."""
    cfg = {"event_rate": 1e9, "message_count": n_per_side,
           "event_time_interval_micros": INTERVAL_MICROS,
           "base_time_micros": BASE_TIME_MICROS, "batch_size": batch_size}
    left = (Stream.source("impulse", cfg)
            .watermark(max_lateness_micros=0)
            .udf(zipf_map(0), name="zl").key_by("k"))
    right = (Stream.source("impulse", cfg, program=left.program)
             .watermark(max_lateness_micros=0)
             .udf(zipf_map(1), name="zr").key_by("k"))
    return (left.join_with_expiration(right, ttl_micros, ttl_micros,
                                      join_type, LEFT_COLS, RIGHT_COLS,
                                      name="stress_join")
            .sink("memory", {"name": sink}))


def state_bounded(snap: Dict[str, Any], ttl_micros: int) -> bool:
    """bench.py's bound: resident rows of both sides (with the dead-row
    estimate's lag) under 6x, and the rings' summed capacity under 12x,
    the rows one TTL holds per side — state follows the TTL horizon, not
    the stream length.  ``snap`` is ``aggregate_stats_registry``'s
    fold."""
    per_side = ttl_micros // INTERVAL_MICROS
    rows = snap.get("rows")
    return (rows is not None and rows < 6 * per_side
            and snap.get("ring_cap_rows", 0) < 12 * per_side)
