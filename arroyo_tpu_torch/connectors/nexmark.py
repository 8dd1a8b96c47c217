"""Nexmark event generator — the port of ``arroyo_tpu.connectors.nexmark``.

``NexmarkGenerator`` and ``make_splits`` are copied verbatim: the same
proportions (person:auction:bid = 1:3:46), id spaces, hot-key ratios,
out-of-order event times and per-family numpy RNG streams, so a batch
generated here is bit-identical to the JAX package's for the same
config and seed (the port tests check it).  The config is a dataclass
with the same fields and defaults as the JAX package's pydantic model.
"""

from __future__ import annotations

import asyncio
import time as _time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..config import config
from ..engine.context import Context
from ..engine.operator import SourceFinishType, SourceOperator
from ..obs import profiler
from ..obs.latency import maybe_stamp
from ..state.tables import TableDescriptor, global_table
from ..types import Batch, StopMode, now_micros
from .registry import ConnectorMeta, register_connector

# Constants (mod.rs:27-44)
HOT_AUCTION_RATIO = 100
HOT_BIDDER_RATIO = 100
HOT_CHANNELS_RATIO = 2
CHANNELS_NUMBER = 10_000
HOT_SELLER_RATIO = 100
PERSON_ID_LEAD = 10
AUCTION_ID_LEAD = 10
FIRST_AUCTION_ID = 1000
FIRST_PERSON_ID = 1000
FIRST_CATEGORY_ID = 10
NUM_CATEGORIES = 5
MIN_STRING_LENGTH = 3

FIRST_NAMES = ["Peter", "Paul", "Luke", "John", "Saul", "Vicky", "Kate",
               "Julie", "Sarah", "Deiter", "Walter"]
LAST_NAMES = ["Shultz", "Abrams", "Spencer", "White", "Bartels", "Walton",
              "Smith", "Jones", "Noris"]
US_CITIES = ["Phoenix", "Los Angeles", "San Francisco", "Boise", "Portland",
             "Bend", "Redmond", "Seattle", "Kent", "Cheyenne"]
US_STATES = ["AZ", "CA", "ID", "OR", "WA", "WY"]
HOT_CHANNELS = ["Google", "Facebook", "Baidu", "Apple"]
HOT_URLS = [
    "https://www.nexmark.com/abo/eoci/cidro/item.htm?query=1",
    "https://www.nexmark.com/eoax/oad/cidro/item.htm?query=1",
    "https://www.nexmark.com/abo/jack/cidro/item.htm?query=1",
    "https://www.nexmark.com/abo/micah/cidro/item.htm?query=1",
]

EVENT_PERSON, EVENT_AUCTION, EVENT_BID = 0, 1, 2

# a bid's channel and url by channel number (hot: HOT_CHANNELS' index, cold:
# the number itself), made once: indexing them gives the strings the
# reference builds by concatenation
_HOT_CHANNELS = np.array(HOT_CHANNELS, dtype=object)
_HOT_URLS = np.array(HOT_URLS, dtype=object)
_COLD_CHANNELS = np.array([f"channel-{i}" for i in range(CHANNELS_NUMBER)],
                          dtype=object)
_COLD_URLS = np.array(
    ["https://www.nexmark.com/item.htm?query=1&channel_id=" + str(i)
     for i in range(CHANNELS_NUMBER)], dtype=object)

@dataclass
class NexmarkConfig:
    """NexmarkConfig defaults (the reference generator's)."""

    event_rate: float = 100_000.0
    runtime_secs: Optional[float] = None  # num_events = rate * runtime
    num_events: Optional[int] = None
    person_proportion: int = 1
    auction_proportion: int = 3
    bid_proportion: int = 46
    hot_seller_ratio: int = 4  # P(hot) = 1 - 1/ratio
    hot_auction_ratio: int = 2
    hot_bidders_ratio: int = 4
    num_inflight_auctions: int = 100
    num_active_people: int = 1000
    out_of_order_group_size: int = 50
    generate_strings: bool = True
    rate_limited: bool = True  # False: generate as fast as possible
    batch_size: Optional[int] = None
    base_time_micros: Optional[int] = None  # pin the event-time origin
    # physical columns the query reads; None = generate everything
    projection: Optional[List[str]] = None

    def __post_init__(self) -> None:
        # SQL's CREATE TABLE passes every option as a string
        self.event_rate = float(self.event_rate)
        if self.runtime_secs is not None:
            self.runtime_secs = float(self.runtime_secs)
        for name in ("num_events", "batch_size", "base_time_micros",
                     "person_proportion", "auction_proportion",
                     "bid_proportion", "hot_seller_ratio",
                     "hot_auction_ratio", "hot_bidders_ratio",
                     "num_inflight_auctions", "num_active_people",
                     "out_of_order_group_size"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, int(v))
        for name in ("generate_strings", "rate_limited"):
            v = getattr(self, name)
            if isinstance(v, str):
                if v.lower() not in ("true", "false", "1", "0"):
                    raise ValueError(f"{name} must be a bool, not {v!r}")
                setattr(self, name, v.lower() in ("true", "1"))


class NexmarkGenerator:
    """Deterministic batch generator for one split (GeneratorConfig,
    mod.rs:490-560).  All id computations are vectorized closed forms."""

    def __init__(self, cfg: NexmarkConfig, base_time_micros: int,
                 first_event_id: int, max_events: int, first_event_number: int,
                 seed: int):
        self.cfg = cfg
        self.base_time = int(base_time_micros)
        self.first_event_id = first_event_id
        self.max_events = max_events
        self.first_event_number = first_event_number
        self.total_prop = (cfg.person_proportion + cfg.auction_proportion
                           + cfg.bid_proportion)
        # projection pushdown: None = every column wanted
        self._want = (None if cfg.projection is None
                      else set(cfg.projection))
        # inter_event_delay covers the whole generator fleet (mod.rs:331-335):
        # delay = 1e6 / rate * n_generators
        self.rng = np.random.default_rng(seed)
        # independent per-family streams (the reference seeds per event id,
        # mod.rs:387-391, so families never share randomness): projection
        # pushdown can then skip a family without perturbing the others —
        # generation is exactly projection-invariant
        self._rngs = {fam: np.random.default_rng([seed, i])
                      for i, fam in enumerate(
                          ("auction", "bid", "person_s", "auction_s",
                           "bid_s"))}
        self.events_so_far = 0

    def set_rate(self, rate: float, n_generators: int) -> None:
        self.inter_event_delay = max(int(1_000_000.0 / rate * n_generators), 1)

    # -- RNG stream snapshot (exactly-once resume) -------------------------
    # The per-family streams advance as generation runs, so a resumed
    # generator must land every stream in the exact position the
    # delivered prefix left it — otherwise post-restore events differ
    # from the uninterrupted run.  Snapshotting the PCG64 states gives
    # O(1) restore (the alternative, replay-burning the prefix, is kept
    # as the fallback for checkpoints written before states were saved).

    def snapshot_rng_state(self) -> Dict[str, Any]:
        states = {fam: rng.bit_generator.state
                  for fam, rng in self._rngs.items()}
        states["__base"] = self.rng.bit_generator.state
        return states

    def restore_rng_state(self, states: Dict[str, Any]) -> None:
        for fam, rng in self._rngs.items():
            if fam in states:
                rng.bit_generator.state = states[fam]
        if "__base" in states:
            self.rng.bit_generator.state = states["__base"]

    @property
    def has_next(self) -> bool:
        return self.events_so_far < self.max_events

    # -- id arithmetic (vectorized ports of mod.rs:463-560) ----------------

    def _adjusted_event_number(self, num_events: np.ndarray) -> np.ndarray:
        n = self.cfg.out_of_order_group_size
        en = self.first_event_number + num_events
        base = (en // n) * n
        offset = (en * 953) % n
        return base + offset

    def _last_base0_person_id(self, event_id: np.ndarray) -> np.ndarray:
        pp, tp = self.cfg.person_proportion, self.total_prop
        epoch = event_id // tp
        offset = np.minimum(event_id % tp, pp - 1)
        return epoch * pp + offset

    def _last_base0_auction_id(self, event_id: np.ndarray) -> np.ndarray:
        pp, ap, tp = (self.cfg.person_proportion, self.cfg.auction_proportion,
                      self.total_prop)
        epoch = event_id // tp
        offset = event_id % tp
        about_person = offset < pp
        about_bid = offset >= pp + ap
        adj_epoch = np.where(about_person, epoch - 1, epoch)
        adj_offset = np.where(about_person | about_bid, ap - 1,
                              np.clip(offset - pp, 0, ap - 1))
        return adj_epoch * ap + adj_offset

    def _next_base0_person_id(self, event_id: np.ndarray,
                              num_people: Optional[np.ndarray] = None,
                              rng=None) -> np.ndarray:
        rng = rng or self.rng
        if num_people is None:
            num_people = self._last_base0_person_id(event_id)
        active = np.minimum(num_people, self.cfg.num_active_people)
        n = (rng.random(len(event_id)) * (active + PERSON_ID_LEAD)).astype(np.int64)
        return num_people - active + n

    def _next_base0_auction_id(self, event_id: np.ndarray,
                               max_a: Optional[np.ndarray] = None,
                               rng=None) -> np.ndarray:
        if max_a is None:
            max_a = self._last_base0_auction_id(event_id)
        rng = rng or self.rng
        min_a = np.maximum(max_a - self.cfg.num_inflight_auctions, 0)
        span = max_a + 1 + AUCTION_ID_LEAD - min_a
        return min_a + (rng.random(len(event_id)) * span).astype(np.int64)

    def _timestamp_for(self, event_number: np.ndarray) -> np.ndarray:
        return self.base_time + self.inter_event_delay * event_number

    def _next_price(self, n: int, rng=None) -> np.ndarray:
        rng = rng or self.rng
        return (np.power(10.0, rng.random(n) * 6.0) * 100.0).astype(np.int64)

    def _rand_strings(self, n: int, max_len: int, rng=None) -> np.ndarray:
        """Vectorized alphanumeric strings with the reference's U(3, max_len)
        length distribution (mod.rs:404-409)."""
        if n == 0:
            return np.zeros(0, dtype=object)
        rng = rng or self.rng
        lengths = rng.integers(MIN_STRING_LENGTH, max(max_len, MIN_STRING_LENGTH + 1), n)
        alphabet = np.frombuffer(
            b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789",
            dtype="S1")
        maxl = int(lengths.max())
        chars = alphabet[rng.integers(0, 62, (n, maxl))]
        # NUL past each string's length: the bytes dtype drops trailing
        # NULs, so each row reads as its first `length` characters
        chars[np.arange(maxl)[None, :] >= lengths[:, None]] = b""
        return chars.view(f"S{maxl}").reshape(n).astype(str).astype(object)

    # -- batch generation ---------------------------------------------------

    def next_batch(self, size: int) -> Tuple[Batch, np.ndarray]:
        """Generate the next ``size`` events; returns (batch, wallclock_event_numbers)."""
        n = min(size, self.max_events - self.events_so_far)
        i = np.arange(self.events_so_far, self.events_so_far + n, dtype=np.int64)
        self.events_so_far += n

        adj = self._adjusted_event_number(i)
        event_id = self.first_event_id + adj
        ts = self._timestamp_for(adj)  # event time (out of order)
        rem = event_id % self.total_prop

        pp, ap = self.cfg.person_proportion, self.cfg.auction_proportion
        is_person = rem < pp
        is_auction = (~is_person) & (rem < pp + ap)
        is_bid = ~(is_person | is_auction)

        etype = np.full(n, EVENT_BID, dtype=np.int8)
        etype[is_person] = EVENT_PERSON
        etype[is_auction] = EVENT_AUCTION

        cols: Dict[str, np.ndarray] = {"event_type": etype}
        # projection pushdown: skip whole column families the query never
        # reads (column order/rng draws stay deterministic per family for a
        # given projection, so exactly-once resume regenerates identically)
        want = self._want

        def w(*names: str) -> bool:
            return want is None or any(c in want for c in names)

        # shared closed forms computed once (the Rust generator recomputes
        # them per event; here per batch)
        last_person = self._last_base0_person_id(event_id)
        last_auction = self._last_base0_auction_id(event_id)

        # persons (next_person, mod.rs:545-587)
        if w("person_id"):
            cols["person_id"] = np.where(
                is_person, last_person + FIRST_PERSON_ID, 0)

        # auctions (next_auction, mod.rs:419-462)
        if w("auction_id", "auction_seller", "auction_category",
             "auction_initial_bid", "auction_reserve", "auction_expires",
             "auction_datetime"):
            rng_a = self._rngs["auction"]
            hot_seller = rng_a.random(n) * self.cfg.hot_seller_ratio >= 1.0
            seller = np.where(
                hot_seller,
                (last_person // HOT_SELLER_RATIO) * HOT_SELLER_RATIO,
                self._next_base0_person_id(event_id, last_person, rng=rng_a)
            ) + FIRST_PERSON_ID
            a_id = last_auction + FIRST_AUCTION_ID
            category = FIRST_CATEGORY_ID + rng_a.integers(
                0, NUM_CATEGORIES, n)
            initial_bid = self._next_price(n, rng=rng_a)
            reserve = initial_bid + self._next_price(n, rng=rng_a)
            # next_auction_length_ms (mod.rs:530-548)
            num_events_for_auctions = (
                self.cfg.num_inflight_auctions * self.total_prop) // ap
            horizon = self.inter_event_delay * num_events_for_auctions
            horizon_ms = max(horizon // 1000, 1)
            length_ms = 1 + np.maximum(
                (rng_a.random(n) * (horizon_ms * 2)).astype(np.int64), 1)
            expires = ts + length_ms * 1000
            cols["auction_id"] = np.where(is_auction, a_id, 0)
            cols["auction_seller"] = np.where(is_auction, seller, 0)
            cols["auction_category"] = np.where(is_auction, category, 0)
            cols["auction_initial_bid"] = np.where(is_auction, initial_bid, 0)
            cols["auction_reserve"] = np.where(is_auction, reserve, 0)
            cols["auction_expires"] = np.where(is_auction, expires, 0)
            cols["auction_datetime"] = np.where(is_auction, ts, 0)

        # bids (next_bid, mod.rs:588-631)
        if w("bid_auction", "bid_bidder", "bid_price", "bid_datetime"):
            rng_b = self._rngs["bid"]
            hot_auction = rng_b.random(n) * self.cfg.hot_auction_ratio >= 1.0
            bid_auction = np.where(
                hot_auction,
                (last_auction // HOT_AUCTION_RATIO) * HOT_AUCTION_RATIO,
                self._next_base0_auction_id(event_id, last_auction, rng=rng_b)
            ) + FIRST_AUCTION_ID
            hot_bidder = rng_b.random(n) * self.cfg.hot_bidders_ratio >= 1.0
            bidder = np.where(
                hot_bidder,
                (last_person // HOT_BIDDER_RATIO) * HOT_BIDDER_RATIO,
                self._next_base0_person_id(event_id, last_person, rng=rng_b)
            ) + FIRST_PERSON_ID
            bid_price = self._next_price(n, rng=rng_b)
            cols["bid_auction"] = np.where(is_bid, bid_auction, 0)
            cols["bid_bidder"] = np.where(is_bid, bidder, 0)
            cols["bid_price"] = np.where(is_bid, bid_price, 0)
            cols["bid_datetime"] = np.where(is_bid, ts, 0)

        if self.cfg.generate_strings and w(
                "person_name", "person_email", "person_city", "person_state",
                "person_extra"):
            np_idx = is_person.nonzero()[0]
            npn = len(np_idx)
            name = np.empty(n, dtype=object); name[:] = ""
            email = np.empty(n, dtype=object); email[:] = ""
            city = np.empty(n, dtype=object); city[:] = ""
            state = np.empty(n, dtype=object); state[:] = ""
            extra_p = np.empty(n, dtype=object); extra_p[:] = ""
            if npn:
                rng_ps = self._rngs["person_s"]
                fn = np.array(FIRST_NAMES, dtype=object)[rng_ps.integers(0, len(FIRST_NAMES), npn)]
                ln = np.array(LAST_NAMES, dtype=object)[rng_ps.integers(0, len(LAST_NAMES), npn)]
                name[np_idx] = fn + " " + ln
                email[np_idx] = (self._rand_strings(npn, 7, rng=rng_ps) + "@"
                                 + self._rand_strings(npn, 5, rng=rng_ps) + ".com")
                city[np_idx] = np.array(US_CITIES, dtype=object)[rng_ps.integers(0, len(US_CITIES), npn)]
                state[np_idx] = np.array(US_STATES, dtype=object)[rng_ps.integers(0, len(US_STATES), npn)]
                # padding to avg_person_byte_size=200 (next_extra_string,
                # mod.rs:406-416, 619-620); content is never queried
                extra_p[np_idx] = self._rand_strings(npn, 140, rng=rng_ps)
            cols["person_name"] = name
            cols["person_email"] = email
            cols["person_city"] = city
            cols["person_state"] = state
            cols["person_extra"] = extra_p

        if self.cfg.generate_strings and w(
                "auction_item_name", "auction_description", "auction_extra"):
            na_idx = is_auction.nonzero()[0]
            item_name = np.empty(n, dtype=object); item_name[:] = ""
            desc = np.empty(n, dtype=object); desc[:] = ""
            extra_a = np.empty(n, dtype=object); extra_a[:] = ""
            if len(na_idx):
                rng_as = self._rngs["auction_s"]
                item_name[na_idx] = self._rand_strings(len(na_idx), 20, rng=rng_as)
                desc[na_idx] = self._rand_strings(len(na_idx), 100, rng=rng_as)
                # padding to avg_auction_byte_size=500 (mod.rs:444-449)
                extra_a[na_idx] = self._rand_strings(len(na_idx), 330,
                                                     rng=rng_as)
            cols["auction_item_name"] = item_name
            cols["auction_description"] = desc
            cols["auction_extra"] = extra_a

        if self.cfg.generate_strings and w("bid_channel", "bid_url",
                                           "bid_extra"):
            nb_idx = is_bid.nonzero()[0]
            channel = np.empty(n, dtype=object); channel[:] = ""
            url = np.empty(n, dtype=object); url[:] = ""
            extra_b = np.empty(n, dtype=object); extra_b[:] = ""
            if len(nb_idx):
                nb = len(nb_idx)
                rng_bs = self._rngs["bid_s"]
                hot_ch = (rng_bs.random(nb) * HOT_CHANNELS_RATIO).astype(np.int64) > 0
                hidx = rng_bs.integers(0, 4, nb)
                cold_id = rng_bs.integers(0, CHANNELS_NUMBER, nb)
                ch = np.where(hot_ch, _HOT_CHANNELS[hidx],
                              _COLD_CHANNELS[cold_id])
                u = np.where(hot_ch, _HOT_URLS[hidx], _COLD_URLS[cold_id])
                channel[nb_idx] = ch
                url[nb_idx] = u
                # padding to avg_bid_byte_size=100 (mod.rs:571-575)
                extra_b[nb_idx] = self._rand_strings(nb, 20, rng=rng_bs)
            cols["bid_channel"] = channel
            cols["bid_url"] = url
            cols["bid_extra"] = extra_b

        return Batch(ts, cols), i


def make_splits(cfg: NexmarkConfig, base_time: int, parallelism: int
                ) -> List[Tuple[int, int, int]]:
    """GeneratorConfig::split (mod.rs:382-402): divide max_events among
    generators; returns (first_event_id, max_events, first_event_number)."""
    num_events = cfg.num_events
    if num_events is None and cfg.runtime_secs is not None:
        num_events = int(cfg.event_rate * cfg.runtime_secs)
    if num_events is None:
        num_events = 2**62
    if parallelism == 1:
        return [(1, num_events, 1)]
    sub = num_events // parallelism
    out = []
    first_id = 1
    for i in range(parallelism):
        me = num_events - sub * (parallelism - 1) if i == parallelism - 1 else sub
        out.append((first_id, me, 1))
        first_id += me
    return out


class NexmarkSource(SourceOperator):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("nexmark")
        self.cfg = NexmarkConfig(**cfg)

    def tables(self) -> List[TableDescriptor]:
        return [global_table("s", "nexmark source state")]

    async def run(self, ctx: Context) -> SourceFinishType:
        state = ctx.state.get_global_keyed_state("s")
        saved = state.get(ctx.task_info.task_index)
        par = ctx.task_info.parallelism
        rng_states = None
        if saved is not None:
            base_time, split, count, rng_states = saved
        else:
            base_time = (self.cfg.base_time_micros
                         if self.cfg.base_time_micros is not None
                         else now_micros())
            split = make_splits(self.cfg, base_time,
                                par)[ctx.task_info.task_index]
            count = 0

        gen = NexmarkGenerator(self.cfg, base_time, split[0], split[1],
                               split[2], seed=ctx.task_info.task_index)
        gen.set_rate(self.cfg.event_rate, par)
        if count:
            # exactly-once resume: every RNG stream lands where the
            # delivered prefix left it
            gen.restore_rng_state(rng_states)
            gen.events_so_far = count
        batch_size = self.cfg.batch_size or config().target_batch_size
        wall_base = _time.monotonic() - (gen.inter_event_delay * count) / 1e6
        prof = profiler.active()
        op_id = ctx.task_info.operator_id

        def gen_next():
            # executor thread: generation lands in the `source_decode`
            # phase directly (no nesting off the loop); it overlaps the
            # loop's own phases
            t0 = _time.perf_counter() if prof is not None else 0.0
            b, nums = gen.next_batch(batch_size)
            # RNG states are captured WITH the count, so a barrier between
            # emit and prefetch checkpoints a consistent pair
            out = b, nums, gen.events_so_far, gen.snapshot_rng_state()
            if prof is not None:
                prof.add(op_id, "source_decode", _time.perf_counter() - t0)
            return out

        # prefetch: batch N+1 is generated on a worker thread while batch
        # N flows through the pipeline
        loop = asyncio.get_running_loop()
        fut = loop.run_in_executor(None, gen_next) if gen.has_next else None
        while fut is not None:
            batch, nums, count_after, rng_snap = await fut
            fut = (loop.run_in_executor(None, gen_next)
                   if gen.has_next else None)
            maybe_stamp(op_id, batch)
            await ctx.collect(batch)
            state.insert(ctx.task_info.task_index,
                         (base_time, split, count_after, rng_snap))
            cm = await ctx._runner.poll_source_control()
            if cm is not None and cm.kind == "stop":
                if fut is not None:
                    await fut  # leave no generation thread running
                return (SourceFinishType.GRACEFUL
                        if cm.stop_mode != StopMode.IMMEDIATE
                        else SourceFinishType.IMMEDIATE)
            if self.cfg.rate_limited and len(nums):
                target = (wall_base + (gen.inter_event_delay
                                       * int(nums[-1] + 1)) / 1e6)
                await asyncio.sleep(max(target - _time.monotonic(), 0))
            else:
                await asyncio.sleep(0)
        return SourceFinishType.FINAL


register_connector(ConnectorMeta(
    name="nexmark",
    description="Nexmark benchmark event generator",
    source_factory=NexmarkSource,
    config_model=NexmarkConfig,
))
