"""Nexmark q7 (highest bid) as a Stream-API program.

``q7_program`` builds by hand the node sequence that
``arroyo_tpu_torch.sql.plan_sql(Q7)`` plans from bench.py's ``Q7`` (and
``arroyo_tpu.sql.plan_sql`` with it), names included;
tests/test_torch_sql_plan.py holds the two equal, node for node.  The
planner rewrites ``bids JOIN (SELECT max(price),
TUMBLE(10 s) ...) ON price = maxprice WHERE datetime in the window`` into
a raw-mode window argmax over the bids themselves:

  nexmark source -> watermark (1 ms lateness) -> where bid is not null
  -> project (auction, price, bidder, datetime)
  -> window assignment (window_start, window_end, timestamp = end - 1)
  -> key_by(window_end) -> raw window argmax(price, max), late TTL 1 h
  -> where datetime in [window_start, window_end) -> project
  (auction, price, bidder) -> sink"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .graph.logical import Program
from .q1 import nexmark_bids

WIDTH_MICROS = 10_000_000
LATE_TTL_MICROS = 3_600_000_000  # the planner's default join TTL


def _win_assign(cols: Dict[str, np.ndarray], _w: int = WIDTH_MICROS
                ) -> Dict[str, np.ndarray]:
    """Tumbling window columns from the row time; the row takes the
    aggregate-row timestamp ``window_end - 1`` the argmax stage buffers
    and fires by."""
    ts = np.asarray(cols["__timestamp"], dtype=np.int64)
    we = (ts // _w + 1) * _w
    out = dict(cols)
    out["window_start"] = we - _w
    out["window_end"] = we
    out["__timestamp"] = we - 1
    return out


def _in_window(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The query's WHERE as the planner's host filter: every column
    (the timestamp included) of the rows with window_start <= datetime <
    window_end."""
    mask = ((np.asarray(cols["datetime"]) >= np.asarray(cols["window_start"]))
            & (np.asarray(cols["datetime"]) < np.asarray(cols["window_end"])))
    return {k: np.asarray(v)[mask] for k, v in cols.items()}


def q7_program(num_events: int, batch_size: int, sink: str = "results",
               event_rate: float = 1_000_000.0,
               base_time_micros: Optional[int] = None) -> Program:
    """q7 over ``num_events`` nexmark events in batches of ``batch_size``,
    writing (auction, price, bidder) rows, one or more a 10 s window (ties
    included), to the memory sink named ``sink``.  ``base_time_micros``
    pins the event-time origin (None: wall clock)."""
    return (nexmark_bids(num_events, batch_size, event_rate,
                         base_time_micros)
            .udf(lambda c: {"auction": c["bid_auction"],
                            "price": c["bid_price"],
                            "bidder": c["bid_bidder"],
                            "datetime": c["bid_datetime"]},
                 name="project_2")
            .udf(_win_assign, name="win_assign_5")
            .key_by("window_end")
            .window_argmax("price", "max", (("maxprice", "price"),),
                           WIDTH_MICROS, name="window_argmax_6", raw=True,
                           late_ttl_micros=LATE_TTL_MICROS)
            .udf(_in_window, name="where_7")
            .map(lambda c: {"auction": c["auction"], "price": c["price"],
                            "bidder": c["bidder"]}, name="project_8")
            .sink("memory", {"name": sink}))
