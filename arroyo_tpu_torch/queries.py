"""The SQL texts of bench.py's queries, as the port plans them with
``arroyo_tpu_torch.sql.plan_sql``: ``SRC`` (the nexmark table, formatted
with ``n`` events in batches of ``b``), Nexmark ``Q1``, ``Q5``, ``Q7`` and
``Q8``, and config5's session-window median (``CONFIG5_SQL``, which needs
``median`` registered as a UDAF).  The package may not import bench.py;
tests/test_torch_sql_parse.py holds these strings equal to bench.py's.
Hot items' text is ``hot_items.HOT_ITEMS_SQL``.

Two texts are not bench.py's: ``Q16``, the channel statistics of the
Flink Nexmark suite's q16 (per channel: bids, distinct bidders, distinct
auctions) over a 10 s tumbling window in place of its day, which runs on
the buffered window (COUNT(DISTINCT)); and ``Q1_UNION``, q1's bids split
on price into two branches under one UNION ALL."""

from .hot_items import HOT_ITEMS_SQL  # noqa: F401


SRC = """
CREATE TABLE nexmark WITH (
  connector = 'nexmark', event_rate = '1000000',
  num_events = '{n}', rate_limited = 'false', batch_size = '{b}'
);
"""

Q1 = SRC + """
SELECT bid.auction as auction, bid.bidder as bidder,
       bid.price * 0.908 as price_dol, bid.datetime as datetime
FROM nexmark WHERE bid is not null
"""

Q5 = SRC + """
WITH bids as (SELECT bid.auction as auction, bid.datetime as datetime
    FROM nexmark where bid is not null)
SELECT AuctionBids.auction as auction, AuctionBids.num as num
FROM (
  SELECT B1.auction, HOP(INTERVAL '2' SECOND, INTERVAL '10' SECOND)
         as window, count(*) AS num
  FROM bids B1 GROUP BY 1, 2
) AS AuctionBids
JOIN (
  SELECT max(num) AS maxn, window
  FROM (
    SELECT count(*) AS num,
           HOP(INTERVAL '2' SECOND, INTERVAL '10' SECOND) AS window
    FROM bids B2 GROUP BY B2.auction, 2
  ) AS CountBids
  GROUP BY 2
) AS MaxBids
ON AuctionBids.num = MaxBids.maxn and AuctionBids.window = MaxBids.window
"""

Q7 = SRC + """
WITH bids as (SELECT bid.auction as auction, bid.price as price,
                     bid.bidder as bidder, bid.datetime as datetime
    FROM nexmark where bid is not null)
SELECT B.auction as auction, B.price as price, B.bidder as bidder
FROM bids B
JOIN (
  SELECT max(price) AS maxprice, TUMBLE(INTERVAL '10' SECOND) as window
  FROM bids GROUP BY 2
) AS M
ON B.price = M.maxprice
WHERE B.datetime >= M.window_start AND B.datetime < M.window_end
"""

Q8 = SRC + """
SELECT P.id as id, P.np as np, A.na as na
FROM (
  SELECT person.id as id, TUMBLE(INTERVAL '10' SECOND) as window,
         count(*) as np
  FROM nexmark WHERE person is not null GROUP BY 1, 2
) AS P
JOIN (
  SELECT auction.seller as seller, TUMBLE(INTERVAL '10' SECOND) as window,
         count(*) as na
  FROM nexmark WHERE auction is not null GROUP BY 1, 2
) AS A
ON P.id = A.seller and P.window = A.window
"""

QUERIES = {"q1": Q1, "q5": Q5, "q7": Q7, "q8": Q8}

Q16 = SRC + """
SELECT bid.channel AS channel, TUMBLE(INTERVAL '10' SECOND) AS window,
       count(*) AS total_bids, count(DISTINCT bid.bidder) AS total_bidders,
       count(DISTINCT bid.auction) AS total_auctions
FROM nexmark WHERE bid is not null GROUP BY 1, 2
"""

Q1_UNION = SRC + """
SELECT bid.auction as auction, bid.bidder as bidder,
       bid.price * 0.908 as price_dol, bid.datetime as datetime
FROM nexmark WHERE bid is not null AND bid.price < 10000
UNION ALL
SELECT bid.auction as auction, bid.bidder as bidder,
       bid.price * 0.908 as price_dol, bid.datetime as datetime
FROM nexmark WHERE bid is not null AND bid.price >= 10000
"""

CONFIG5_SQL = """
CREATE TABLE ev (
  k BIGINT, v DOUBLE, ts BIGINT,
  event_time TIMESTAMP GENERATED ALWAYS AS
    (CAST(from_unixtime(ts) as TIMESTAMP))
) WITH (
  connector = 'kafka', bootstrap_servers = 'memory://bench5',
  topic = 'sess', type = 'source', format = 'json',
  event_time_field = 'event_time', batch_size = '{b}',
  max_messages = '{n}'
);
CREATE TABLE out WITH (connector = 'memory', name = 'results');
INSERT INTO out
SELECT k, median(v) as med, count(*) as cnt,
       session(INTERVAL '1' SECOND) as window
FROM ev GROUP BY 1, 4
"""
