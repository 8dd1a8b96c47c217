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
on price into two branches under one UNION ALL.

Three texts run the join layer's last operators: ``SEMI_Q3``, the bids
on the auctions of Nexmark q3's category (10) as an ``IN (SELECT ...)``
semi join; ``MW_BIDDERS``, q8 extended by each person's bids as bidder
(persons, sellers and bidders per 10 s tumble: three INNER joins on one
key, planned as one multi-way join); and ``MW_TTL``, a three-way
self-join of the bids above 50,000,000 on the auction with TTL state (the
multi-way join's TTL mode).  The last two are tests/test_join_state.py's
``MW_SQL`` and ``MW_TTL_SQL`` over ``SRC``."""

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

SEMI_Q3 = SRC + """
SELECT bid.auction AS auction, bid.price AS price, bid.bidder AS bidder
FROM nexmark
WHERE bid IS NOT NULL AND bid.auction IN
  (SELECT auction.id FROM nexmark WHERE auction.category = 10)
"""

MW_BIDDERS = SRC + """
SELECT P.id AS id, P.np AS np, A.na AS na, B.nb AS nb
FROM (
  SELECT person.id AS id, TUMBLE(INTERVAL '10' SECOND) AS window,
         count(*) AS np FROM nexmark WHERE person is not null GROUP BY 1, 2
) AS P
JOIN (
  SELECT auction.seller AS seller, TUMBLE(INTERVAL '10' SECOND) AS window,
         count(*) AS na FROM nexmark WHERE auction is not null GROUP BY 1, 2
) AS A ON P.id = A.seller AND P.window = A.window
JOIN (
  SELECT bid.bidder AS bidder, TUMBLE(INTERVAL '10' SECOND) AS window,
         count(*) AS nb FROM nexmark WHERE bid is not null GROUP BY 1, 2
) AS B ON P.id = B.bidder AND P.window = B.window
"""

MW_TTL = SRC + """
WITH b AS (SELECT bid.auction AS auction, bid.price AS price,
                  bid.bidder AS bidder FROM nexmark
           WHERE bid is not null AND bid.price > 50000000)
SELECT X.auction AS a1, Y.price AS p2, Z.bidder AS b3
FROM b X
JOIN b Y ON X.auction = Y.auction
JOIN b Z ON X.auction = Z.auction
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
