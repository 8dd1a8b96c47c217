"""Nexmark hot items, top 10 per window: the ROW_NUMBER form of q5, which
Arroyo rewrites into a fused sliding TopN plus a global TopN stage.

``hot_items_program`` builds by hand the node sequence that
``arroyo_tpu_torch.sql.plan_sql(HOT_ITEMS_SQL)`` plans (and
``arroyo_tpu.sql.plan_sql`` with it); tests/test_torch_sql_plan.py holds
the two equal, node for node:

  nexmark source (bid_auction, event_type)
  -> watermark (1 ms lateness) -> where bid is not null -> agg input
  -> key_by(auction)
  -> HOP(2 s, 10 s) COUNT(*) fused with a top-10-per-window prune
  -> agg projection (window_start, window_end, auction, num)
  -> global TopN per window (10 rows, ROW_NUMBER() as ``rn``; one
     subtask, pinned) -> project (auction, num, window) -> sink

Every operator keeps the planner's name and emits the planner's columns,
so the rows are comparable one for one."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .connectors.nexmark import EVENT_BID
from .graph.logical import (AggKind, AggSpec, LogicalOperator, OpKind,
                            Program, Stream, TopNSpec)

SLIDE_MICROS = 2_000_000
WIDTH_MICROS = 10_000_000
LATENESS_MICROS = 1_000  # the nexmark table's default lateness
TOP_K = 10

HOT_ITEMS_SQL = """
CREATE TABLE nexmark WITH (connector = 'nexmark', event_rate = '{rate}',
  num_events = '{n}', rate_limited = 'false', batch_size = '{b}');
CREATE TABLE out WITH (connector = 'memory', name = 'results');
INSERT INTO out
SELECT auction, num, window FROM (
  SELECT bid.auction as auction, count(*) AS num,
         HOP(INTERVAL '2' SECOND, INTERVAL '10' SECOND) as window,
         ROW_NUMBER() OVER (PARTITION BY window ORDER BY num DESC) as rn
  FROM nexmark WHERE bid is not null GROUP BY 1, 3
) WHERE rn <= {k}
"""


def hot_items_sql(num_events: int, batch_size: int, k: int = TOP_K,
                  event_rate: float = 1_000_000.0) -> str:
    """``HOT_ITEMS_SQL`` with its sizes formatted in."""
    return HOT_ITEMS_SQL.format(n=num_events, b=batch_size, k=k,
                                rate=int(event_rate))


def hot_items_program(num_events: int, batch_size: int, k: int = TOP_K,
                      sink: str = "results",
                      event_rate: float = 1_000_000.0,
                      base_time_micros: Optional[int] = None) -> Program:
    """Hot items over ``num_events`` nexmark events in batches of
    ``batch_size``: the top ``k`` auctions by bids per sliding window,
    written as (auction, num, window_start, window_end) rows to the memory
    sink named ``sink``.  ``base_time_micros`` pins the event-time origin
    (None: wall clock)."""
    src = Stream.source("nexmark", {
        "event_rate": event_rate, "num_events": num_events,
        "rate_limited": False, "batch_size": batch_size,
        "base_time_micros": base_time_micros,
        "projection": ["bid_auction", "event_type"],
    })
    agg = (src.watermark(max_lateness_micros=LATENESS_MICROS,
                         name="nexmark_watermark")
           .filter(lambda c: c["event_type"] == EVENT_BID, name="where_1")
           .map(lambda c: {"auction": c["bid_auction"]}, name="agg_input_2")
           .key_by("auction")
           .sliding_aggregating_top_n(
               WIDTH_MICROS, SLIDE_MICROS,
               [AggSpec(AggKind.COUNT, None, "__agg0")], (), "__agg0", k,
               name="sliding_agg"))
    projected = agg.map(lambda c: {"window_start": c["window_start"],
                                   "window_end": c["window_end"],
                                   "auction": c["auction"],
                                   "num": c["__agg0"].astype(np.int64)},
                        name="agg_project_3")
    # the planner's global stage: one merging subtask, pinned across
    # rescales, ranking per window (1 us buckets of the rows' timestamps)
    top = projected._chain(LogicalOperator(
        OpKind.TUMBLING_TOP_N, "topn_4",
        spec=TopNSpec(1, k, "num", (), None, "rn")), parallelism=1)
    top.program.node(top.tail).max_parallelism = 1
    return (top.map(lambda c: {"auction": c["auction"], "num": c["num"],
                               "window_start": c["window_start"],
                               "window_end": c["window_end"]},
                    name="project_5")
            .sink("memory", {"name": sink}, name="out_sink"))
