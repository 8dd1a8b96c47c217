"""Nexmark q1 (currency conversion) as a Stream-API program.

``q1_program`` builds by hand the node sequence that
``arroyo_tpu_torch.sql.plan_sql(Q1)`` plans from bench.py's ``Q1`` (and
``arroyo_tpu.sql.plan_sql`` with it), names included;
tests/test_torch_sql_plan.py holds the two equal, node for node:

  nexmark source (bid_auction, bid_bidder, bid_datetime, bid_price,
  event_type) -> watermark (1 ms lateness) -> where bid is not null
  -> project (auction, bidder, price_dol = price * 0.908, datetime) -> sink

It is stateless: with chaining on (the default) the watermark, the filter
and the projection run as one task between the source and the sink."""

from __future__ import annotations

from typing import Optional

from .connectors.nexmark import EVENT_BID
from .graph.logical import Program, Stream
from .q5 import LATENESS_MICROS

PROJECTION = ["bid_auction", "bid_bidder", "bid_datetime", "bid_price",
              "event_type"]


def nexmark_bids(num_events: int, batch_size: int, event_rate: float,
                 base_time_micros: Optional[int]) -> Stream:
    """The planner's head of q1 and q7 before the projection: the nexmark
    source, its watermark and ``where bid is not null``."""
    src = Stream.source("nexmark", {
        "event_rate": event_rate, "num_events": num_events,
        "rate_limited": False, "batch_size": batch_size,
        "base_time_micros": base_time_micros, "projection": PROJECTION,
    })
    return (src.watermark(max_lateness_micros=LATENESS_MICROS,
                          name="nexmark_watermark")
            .filter(lambda c: c["event_type"] == EVENT_BID, name="where_1"))


def q1_program(num_events: int, batch_size: int, sink: str = "results",
               event_rate: float = 1_000_000.0,
               base_time_micros: Optional[int] = None) -> Program:
    """q1 over ``num_events`` nexmark events in batches of ``batch_size``,
    writing (auction, bidder, price_dol, datetime) rows to the memory sink
    named ``sink``.  ``base_time_micros`` pins the event-time origin
    (None: wall clock)."""
    return (nexmark_bids(num_events, batch_size, event_rate,
                         base_time_micros)
            .udf(lambda c: {"auction": c["bid_auction"],
                            "bidder": c["bid_bidder"],
                            "price_dol": c["bid_price"] * 0.908,
                            "datetime": c["bid_datetime"]},
                 name="project_2")
            .sink("memory", {"name": sink}))
