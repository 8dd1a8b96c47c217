"""Nexmark q5 ("hot items") as a Stream-API program.

``q5_program`` builds by hand the node sequence that
``arroyo_tpu_torch.sql.plan_sql(Q5)`` plans from bench.py's text (and
``arroyo_tpu.sql.plan_sql`` with it); tests/test_torch_sql_plan.py holds
the two equal, node for node:

  nexmark source (bid_auction, bid_datetime, event_type)
  -> watermark (1 ms lateness) -> where bid is not null -> project
  -> agg input -> key_by(auction)
  -> HOP(2 s, 10 s) COUNT(*) with local argmax emission
  -> agg projection -> key_by(window_end) -> window argmax(num, max)
  -> project (auction, num) -> sink

Every operator keeps the planner's name and emits the planner's columns,
so the rows are comparable one for one."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .connectors.nexmark import EVENT_BID
from .graph.logical import AggKind, AggSpec, Program, Stream

SLIDE_MICROS = 2_000_000
WIDTH_MICROS = 10_000_000
LATENESS_MICROS = 1_000  # the nexmark table's default lateness


def q5_program(num_events: int, batch_size: int, sink: str = "results",
               event_rate: float = 1_000_000.0,
               base_time_micros: Optional[int] = None) -> Program:
    """q5 over ``num_events`` nexmark events in batches of ``batch_size``,
    writing (auction, num) rows to the memory sink named ``sink``.
    ``base_time_micros`` pins the event-time origin (None: wall clock)."""
    src = Stream.source("nexmark", {
        "event_rate": event_rate, "num_events": num_events,
        "rate_limited": False, "batch_size": batch_size,
        "base_time_micros": base_time_micros,
        "projection": ["bid_auction", "bid_datetime", "event_type"],
    })
    agg = (src.watermark(max_lateness_micros=LATENESS_MICROS,
                         name="nexmark_watermark")
           .filter(lambda c: c["event_type"] == EVENT_BID, name="where_1")
           .udf(lambda c: {"auction": c["bid_auction"],
                           "datetime": c["bid_datetime"]}, name="project_2")
           .map(lambda c: {"auction": c["auction"]}, name="agg_input_3")
           .key_by("auction")
           .sliding_aggregate(WIDTH_MICROS, SLIDE_MICROS,
                              [AggSpec(AggKind.COUNT, None, "__agg0")]))
    # the planner's argmax rewrite: the window-argmax stage is the sole
    # consumer, so emission may pre-filter to local per-pane candidates
    agg.program.node(agg.tail).operator.spec.argmax_local = ("__agg0", "max")
    return (agg.map(lambda c: {"auction": c["auction"],
                               "num": c["__agg0"].astype(np.int64),
                               "window_end": c["window_end"],
                               "window_start": c["window_start"]},
                    name="agg_project_4")
            .key_by("window_end")
            .window_argmax("num", "max",
                           (("r_window_start", "window_start"),
                            ("r_window_end", "window_end"),
                            ("maxn", "num")),
                           WIDTH_MICROS, name="window_argmax_9",
                           agg_out="__agg0")
            .map(lambda c: {"auction": c["auction"], "num": c["num"]},
                 name="project_10")
            .sink("memory", {"name": sink}))
