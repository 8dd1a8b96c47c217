"""Nexmark q8 ("monitor new users") as a Stream-API program.

``q8_program`` builds by hand the node sequence that
``arroyo_tpu_torch.sql.plan_sql(Q8)`` plans from bench.py's text (and
``arroyo_tpu.sql.plan_sql`` with it); tests/test_torch_sql_plan.py holds
the two equal, node for node:

  nexmark source (auction_seller, event_type, person_id)
  -> watermark (1 ms lateness), then two branches:
     where person is not null -> agg input (id) -> key_by(id)
       -> TUMBLE(10 s) COUNT(*) -> agg projection (id, np, window)
       -> join-key map (__jk0 = id, __jk1 = window_end, __jknonce)
       -> key_by(__jk0, __jk1, __jknonce)
     where auction is not null -> agg input (seller) -> key_by(seller)
       -> TUMBLE(10 s) COUNT(*) -> agg projection (seller, na, window)
       -> join-key map -> key_by(__jk0, __jk1, __jknonce)
  -> window join (instant window, INNER; persons left, auctions right)
  -> project (id, np, na) -> sink

Every operator keeps the planner's name and emits the planner's columns
in the planner's order, so the rows are comparable one for one.  Join
keys are float32, as the planner casts them."""

from __future__ import annotations

from typing import Optional

from .connectors.nexmark import EVENT_AUCTION, EVENT_PERSON
from .graph.logical import (AggKind, AggSpec, InstantWindow, JoinType,
                            Program, Stream)
from .ops.expr import join_key_fn, normalize_join_key

WIDTH_MICROS = 10_000_000
LATENESS_MICROS = 1_000  # the nexmark table's default lateness
JOIN_KEYS = ("__jk0", "__jk1", "__jknonce")
LEFT_COLS = (("window_start", "t"), ("window_end", "t"), ("id", "i"),
             ("np", "i"))
RIGHT_COLS = (("window_start", "t"), ("window_end", "t"), ("seller", "i"),
              ("na", "i"))


def _side(wm: Stream, event_type: int, src_col: str, key: str, count: str,
          where: str, agg_input: str, agg_project: str, join_key: str,
          out_cols) -> Stream:
    """One join side: filter -> agg input -> key_by -> tumbling COUNT(*)
    -> agg projection -> join-key map -> key_by(join keys)."""
    agg = (wm.filter(lambda c: c["event_type"] == event_type, name=where)
           .map(lambda c: {key: c[src_col]}, name=agg_input)
           .key_by(key)
           .tumbling_aggregate(WIDTH_MICROS,
                               [AggSpec(AggKind.COUNT, None, "__agg0")]))
    projected = agg.map(lambda c: dict(sorted({
        key: c[key], count: c["__agg0"], "window_end": c["window_end"],
        "window_start": c["window_start"]}.items())), name=agg_project)

    def keys(c):
        out = {"__jk0": normalize_join_key(c[key]),
               "__jk1": normalize_join_key(c["window_end"])}
        out.update({name: c[name] for name, _kind in out_cols})
        return out

    return (projected.udf(join_key_fn(keys, ["__jk0", "__jk1"]),
                          name=join_key)
            .key_by(*JOIN_KEYS))


def q8_program(num_events: int, batch_size: int, sink: str = "results",
               event_rate: float = 1_000_000.0,
               base_time_micros: Optional[int] = None) -> Program:
    """q8 over ``num_events`` nexmark events in batches of ``batch_size``,
    writing (id, np, na) rows to the memory sink named ``sink``.
    ``base_time_micros`` pins the event-time origin (None: wall clock)."""
    wm = Stream.source("nexmark", {
        "event_rate": event_rate, "num_events": num_events,
        "rate_limited": False, "batch_size": batch_size,
        "base_time_micros": base_time_micros,
        "projection": ["auction_seller", "event_type", "person_id"],
    }).watermark(max_lateness_micros=LATENESS_MICROS,
                 name="nexmark_watermark")
    persons = _side(wm, EVENT_PERSON, "person_id", "id", "np", "where_1",
                    "agg_input_2", "agg_project_3", "join_lkey_7", LEFT_COLS)
    auctions = _side(wm, EVENT_AUCTION, "auction_seller", "seller", "na",
                     "where_4", "agg_input_5", "agg_project_6",
                     "join_rkey_8", RIGHT_COLS)
    return (persons.window_join(auctions, InstantWindow(), JoinType.INNER,
                                LEFT_COLS, RIGHT_COLS, name="window_join_9")
            .map(lambda c: {"id": c["id"], "np": c["np"], "na": c["na"]},
                 name="project_10")
            .sink("memory", {"name": sink}))
