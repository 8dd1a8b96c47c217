"""Logical dataflow graph: window types, aggregate specs, operator
taxonomy, ``Program`` and the fluent ``Stream`` builder — the part of
``arroyo_tpu.graph.logical`` that the port's operators execute: every
operator kind but the factor windows and the multi-way join, and every
join type but the semi join.

Operators carry Python callables over columnar batches (dicts of numpy
columns).  The graph is a small adjacency structure of its own (the JAX
package uses networkx, which the port does not need for a DAG this
size)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

# -- window types ---------------------------------------------------------------


@dataclass(frozen=True)
class TumblingWindow:
    width_micros: int


@dataclass(frozen=True)
class SlidingWindow:
    width_micros: int
    slide_micros: int


@dataclass(frozen=True)
class InstantWindow:
    """Rows of one event-time instant (a window join over aggregate rows
    that already carry their window, stamped at window end - 1)."""


@dataclass(frozen=True)
class SessionWindow:
    """Per-key sessions: events closer than ``gap_micros`` share one."""

    gap_micros: int


WindowType = Any  # union of the four window dataclasses above


def window_label(w: WindowType) -> str:
    if isinstance(w, TumblingWindow):
        return f"tumbling({w.width_micros}us)"
    if isinstance(w, SlidingWindow):
        return f"sliding({w.width_micros}us,{w.slide_micros}us)"
    if isinstance(w, InstantWindow):
        return "instant"
    if isinstance(w, SessionWindow):
        return f"session({w.gap_micros}us)"
    raise TypeError(w)


# -- aggregates & expressions -----------------------------------------------------


class AggKind(Enum):
    COUNT = "count"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    AVG = "avg"
    COUNT_DISTINCT = "count_distinct"
    UDAF = "udaf"  # user aggregate fn(values) -> scalar; buffered paths only


@dataclass(frozen=True)
class AggSpec:
    """One aggregate: kind + input column (None for COUNT(*)) + output.
    ``fn`` carries the Python callable of a UDAF."""

    kind: AggKind
    column: Optional[str]
    output: str
    fn: Optional[Any] = None


class ExprReturnType(Enum):
    PREDICATE = "predicate"
    RECORD = "record"
    # a record whose bool '__valid' column drops the rows it is false on
    OPTIONAL_RECORD = "optional_record"


@dataclass
class ColumnExpr:
    """A columnar expression ``fn(cols: dict[str, array]) -> dict | array``.

    Stream-API functions run on host numpy columns; functions the SQL
    planner compiles run on torch tensors (ops/expr.py).
    ``output_schema`` ({col -> kind char}) is plan-time metadata the
    planner attaches; ``sql`` is the planner's structural text of the
    expression, which common-subplan elimination compares."""

    name: str
    fn: Callable[[Dict[str, Any]], Any]
    return_type: ExprReturnType = ExprReturnType.RECORD
    output_schema: Optional[Dict[str, Any]] = None
    sql: str = ""

    def hash_token(self) -> str:
        return self.sql or self.name


# -- operator taxonomy ------------------------------------------------------------


class OpKind(Enum):
    CONNECTOR_SOURCE = "connector_source"
    CONNECTOR_SINK = "connector_sink"
    EXPRESSION = "expression"  # map / filter / option-map
    FLAT_MAP = "flat_map"
    FLATTEN = "flatten"
    UDF = "udf"  # python function over the raw batch
    WATERMARK = "watermark"
    KEY_BY = "key_by"
    GLOBAL_KEY = "global_key"  # every row to one key
    WINDOW = "window"  # buffered keyed window (tumbling, sliding, session)
    COUNT = "count"  # running count a key
    AGGREGATE = "aggregate"  # running MAX/MIN/SUM a key
    SLIDING_WINDOW_AGGREGATOR = "sliding_window_aggregator"
    TUMBLING_WINDOW_AGGREGATOR = "tumbling_window_aggregator"
    WINDOW_ARGMAX = "window_argmax"  # fused self-join-on-window-max
    WINDOW_JOIN = "window_join"  # windowed stream-stream equi-join
    JOIN_WITH_EXPIRATION = "join_with_expiration"  # unwindowed TTL join
    TUMBLING_TOP_N = "tumbling_top_n"
    SLIDING_AGGREGATING_TOP_N = "sliding_aggregating_top_n"
    UPDATING = "updating"  # an option-map over an updating stream
    NON_WINDOW_AGGREGATOR = "non_window_aggregator"  # updating GROUP BY
    UPDATING_KEY = "updating_key"  # key_by over an updating stream
    UNION = "union"  # UNION ALL: the streams' batches merged unchanged
    MULTI_WAY_JOIN = "multi_way_join"  # N-ary shared-key INNER equi-join


class JoinType(Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    SEMI = "semi"  # IN (SELECT ...): left rows emit once on first match


@dataclass
class PeriodicWatermarkSpec:
    """Fixed-lateness or expression watermark with idle detection."""

    max_lateness_micros: int = 0
    idle_time_micros: Optional[int] = None
    expression: Optional[ColumnExpr] = None  # row -> watermark timestamp


@dataclass
class WindowSpec:
    """A buffered keyed window: rows are kept until the window fires,
    then aggregated (or emitted flat)."""

    typ: WindowType
    aggs: Tuple[AggSpec, ...] = ()
    flatten: bool = False
    # post-aggregate projection over {key cols + agg outputs + bounds}
    projection: Optional[ColumnExpr] = None


@dataclass
class SlidingAggregatorSpec:
    """Two-phase bin-merged sliding aggregate."""

    width_micros: int
    slide_micros: int
    aggs: Tuple[AggSpec, ...] = ()
    projection: Optional[ColumnExpr] = None
    # (agg output, 'max'|'min') when emission may pre-filter to local
    # per-pane argmax candidates (the sole consumer is a WindowArgmax
    # stage, which settles the global answer)
    argmax_local: Optional[Tuple[str, str]] = None


@dataclass
class TumblingAggregatorSpec:
    width_micros: int
    aggs: Tuple[AggSpec, ...] = ()
    projection: Optional[ColumnExpr] = None
    argmax_local: Optional[Tuple[str, str]] = None


@dataclass
class WindowArgmaxSpec:
    """Fusion of ``A JOIN (SELECT max(x), window FROM A GROUP BY window)
    ON x = mx`` (nexmark q5's hot-items shape): buffer A's rows per
    window, emit the rows achieving the window's max (ties included) and
    synthesize the pruned side's columns (``synth_cols``: (out, src)).

    ``raw`` is q7's shape (bids JOIN per-window max ON price = mx with a
    window-range WHERE): rows are raw rows, not aggregate outputs, so the
    operator drops rows below the window's running extremum before
    buffering and matches late rows against the released window's final
    extremum, kept for ``late_ttl_micros`` (the TTL of the join this
    fusion replaces)."""

    value_col: str
    minmax: str
    synth_cols: Tuple[Tuple[str, str], ...]
    width_micros: int  # buffer retention: one window span
    agg_out: str = ""
    raw: bool = False
    late_ttl_micros: int = 0


@dataclass
class WindowJoinSpec:
    """Windowed stream-stream hash join; outer kinds null-pad the
    unmatched side per fired window.  ``left_cols``/``right_cols`` are
    (name, kind) schemas for pads before a side has seen a batch."""

    typ: Any  # TumblingWindow | SlidingWindow | InstantWindow
    join_type: JoinType = JoinType.INNER
    left_cols: Tuple[Tuple[str, str], ...] = ()
    right_cols: Tuple[Tuple[str, str], ...] = ()


@dataclass
class JoinWithExpirationSpec:
    """Unwindowed stream-stream equi-join whose state expires after a TTL
    per side; outer kinds emit updating (``__op``) rows.
    ``left_cols``/``right_cols`` are (name, kind) schemas for pads before
    a side has seen a batch."""

    left_expiration_micros: int
    right_expiration_micros: int
    join_type: JoinType = JoinType.INNER
    left_cols: Tuple[Tuple[str, str], ...] = ()
    right_cols: Tuple[Tuple[str, str], ...] = ()


@dataclass
class MultiWayJoinSpec:
    """One N-ary INNER equi-join over sides keyed by the same columns
    (the planner's rewrite of a cascade of joins on one key): per fire
    (``typ`` a window) or per arriving batch (``typ`` None, state kept
    for ``ttl_micros``) the per-key cross product of every side expands
    directly, with no pairwise intermediate.  ``side_cols`` has one
    (name, kind) schema a side and records the side count."""

    typ: Optional[Any] = None
    ttl_micros: int = 0
    side_cols: Tuple[Tuple[Tuple[str, str], ...], ...] = ()


@dataclass
class TopNSpec:
    """A per-window TopN stage (TumblingTopN).

    ``max_elements=None`` ranks without pruning; ``rank_column`` emits
    the 1-based per-partition rank (a materialized ROW_NUMBER())."""

    width_micros: int
    max_elements: Optional[int]
    # the sort column; descending order
    sort_column: str = ""
    partition_cols: Tuple[str, ...] = ()
    projection: Optional[ColumnExpr] = None
    rank_column: Optional[str] = None


@dataclass
class SlidingAggregatingTopNSpec:
    """A sliding aggregate fused with a TopN: each pane emission keeps
    only the top ``max_elements`` rows by ``sort_column`` per window (and
    partition)."""

    width_micros: int
    slide_micros: int
    aggs: Tuple[AggSpec, ...] = ()
    partition_cols: Tuple[str, ...] = ()
    sort_column: str = ""
    max_elements: int = 10
    projection: Optional[ColumnExpr] = None


@dataclass
class NonWindowAggregatorSpec:
    """The JAX package's updating aggregate with a TTL; ``flush_key``
    names the key column holding an event-time bound whose passing
    releases each key's final row."""

    expiration_micros: int
    aggs: Tuple[AggSpec, ...] = ()
    projection: Optional[ColumnExpr] = None
    flush_key: Optional[str] = None


@dataclass
class ConnectorOpSpec:
    connector: str  # registry name, e.g. 'nexmark', 'memory'
    config: Dict[str, Any] = field(default_factory=dict)


@dataclass
class LogicalOperator:
    kind: OpKind
    name: str
    spec: Any = None
    expr: Optional[ColumnExpr] = None
    key_cols: Tuple[str, ...] = ()

    def hash_token(self) -> str:
        """Structural identity of the operator for common-subplan
        elimination."""
        tok: Dict[str, Any] = {"kind": self.kind.value, "name": self.name}
        if self.expr is not None:
            tok["expr"] = self.expr.hash_token()
            if self.expr.sql:
                # the sql token describes the computation; a generated
                # display name (agg_input_<n>) must not break equality
                # between duplicated subplans
                del tok["name"]
        if self.key_cols:
            tok["key"] = list(self.key_cols)
        if self.spec is not None:
            tok["spec"] = repr(self.spec)
        return json.dumps(tok, sort_keys=True)


# -- graph ------------------------------------------------------------------------


class EdgeType(Enum):
    FORWARD = "forward"
    SHUFFLE = "shuffle"
    SHUFFLE_JOIN_LEFT = "shuffle_join_0"
    SHUFFLE_JOIN_RIGHT = "shuffle_join_1"
    # the further sides of a multi-way join
    SHUFFLE_JOIN_2 = "shuffle_join_2"
    SHUFFLE_JOIN_3 = "shuffle_join_3"
    SHUFFLE_JOIN_4 = "shuffle_join_4"
    SHUFFLE_JOIN_5 = "shuffle_join_5"
    SHUFFLE_JOIN_6 = "shuffle_join_6"
    SHUFFLE_JOIN_7 = "shuffle_join_7"

    @property
    def join_side(self) -> Optional[int]:
        """Input-side index carried by shuffle_join_N edges, else None."""
        if self.value.startswith("shuffle_join_"):
            return int(self.value.rsplit("_", 1)[1])
        return None


def join_side_edge(i: int) -> EdgeType:
    """The shuffle_join edge type of join side ``i`` (0-based)."""
    return EdgeType(f"shuffle_join_{i}")


@dataclass
class StreamNode:
    """``max_parallelism`` pins operators whose semantics need a bounded
    subtask count (a global TopN merge stage stays at 1) across rescales;
    the port runs every node at parallelism 1."""

    operator_id: str
    operator: LogicalOperator
    parallelism: int = 1
    max_parallelism: Optional[int] = None


@dataclass
class StreamEdge:
    typ: EdgeType
    key_schema: str = "()"


class _Graph:
    """Insertion-ordered DAG with per-edge data — the few operations of
    a networkx DiGraph that Program and the engine use."""

    def __init__(self) -> None:
        self._nodes: Dict[str, StreamNode] = {}
        self._succ: Dict[str, Dict[str, StreamEdge]] = {}
        self._pred: Dict[str, Dict[str, StreamEdge]] = {}

    def add_node(self, node: StreamNode) -> None:
        self._nodes[node.operator_id] = node
        self._succ[node.operator_id] = {}
        self._pred[node.operator_id] = {}

    def add_edge(self, src: str, dst: str, edge: StreamEdge) -> None:
        self._succ[src][dst] = edge
        self._pred[dst][src] = edge

    def node_ids(self) -> Iterator[str]:
        return iter(self._nodes)

    def out_edges(self, op_id: str) -> List[Tuple[str, str, StreamEdge]]:
        return [(op_id, d, e) for d, e in self._succ[op_id].items()]

    def in_edges(self, op_id: str) -> List[Tuple[str, str, StreamEdge]]:
        return [(s, op_id, e) for s, e in self._pred[op_id].items()]

    def predecessors(self, op_id: str) -> List[str]:
        return list(self._pred[op_id])

    def out_degree(self, op_id: str) -> int:
        return len(self._succ[op_id])

    def in_degree(self, op_id: str) -> int:
        return len(self._pred[op_id])

    def has_edge(self, src: str, dst: str) -> bool:
        return dst in self._succ.get(src, {})

    def remove_node(self, op_id: str) -> None:
        for d in self._succ.pop(op_id):
            del self._pred[d][op_id]
        for s in self._pred.pop(op_id):
            del self._succ[s][op_id]
        del self._nodes[op_id]

    def topo_order(self) -> List[str]:
        indeg = {n: len(p) for n, p in self._pred.items()}
        ready = [n for n in self._nodes if indeg[n] == 0]
        out: List[str] = []
        while ready:
            n = ready.pop(0)
            out.append(n)
            for d in self._succ[n]:
                indeg[d] -= 1
                if indeg[d] == 0:
                    ready.append(d)
        if len(out) != len(self._nodes):
            raise ValueError("program graph has a cycle")
        return out

    def ancestors(self, op_id: str) -> set:
        seen: set = set()
        stack = list(self._pred[op_id])
        while stack:
            n = stack.pop()
            if n not in seen:
                seen.add(n)
                stack.extend(self._pred[n])
        return seen


class Program:
    def __init__(self, name: str = "pipeline"):
        self.name = name
        self.graph = _Graph()
        self._counter = 0

    def add_node(self, op: LogicalOperator, parallelism: int = 1) -> str:
        op_id = f"{self._counter}_{op.kind.value}"
        self._counter += 1
        self.graph.add_node(StreamNode(op_id, op, parallelism))
        return op_id

    def add_edge(self, src: str, dst: str, typ: EdgeType,
                 key_schema: str = "()") -> None:
        self.graph.add_edge(src, dst, StreamEdge(typ, key_schema))

    def node(self, op_id: str) -> StreamNode:
        return self.graph._nodes[op_id]

    def nodes(self) -> List[StreamNode]:
        return [self.node(n) for n in self.graph.node_ids()]

    def sinks(self) -> List[StreamNode]:
        return [self.node(n) for n in self.graph.node_ids()
                if not self.graph.out_edges(n)]

    def topo_order(self) -> List[str]:
        return self.graph.topo_order()

    WINDOWED_KINDS = {
        OpKind.WINDOW,
        OpKind.SLIDING_WINDOW_AGGREGATOR,
        OpKind.TUMBLING_WINDOW_AGGREGATOR,
        OpKind.WINDOW_JOIN,
        OpKind.TUMBLING_TOP_N,
        OpKind.SLIDING_AGGREGATING_TOP_N,
    }

    def validate(self) -> List[str]:
        """Window operators require a watermark generator upstream."""
        errors: List[str] = []
        for op_id in self.graph.node_ids():
            node = self.node(op_id)
            if node.operator.kind in self.WINDOWED_KINDS and not any(
                    self.node(a).operator.kind == OpKind.WATERMARK
                    for a in self.graph.ancestors(op_id)):
                errors.append(
                    f"{op_id} ({node.operator.kind.value}) requires a "
                    "watermark-assigning operator upstream")
        return errors

    # -- common-subplan elimination (the JAX package's, same rules) ----------

    # sources whose output is a deterministic function of a config that
    # compares faithfully by repr: two scans of one definition may merge
    _REPLAYABLE_SOURCES = frozenset({"nexmark", "impulse", "memory"})

    def eliminate_common_subplans(self) -> int:
        """Merge operators that compute the same thing over the same
        inputs (equal ``hash_token``, parallelism and predecessor set with
        equal edge types), moving the duplicate's out-edges to the kept
        node.  Merges q5's double HOP aggregate and q8's double nexmark
        scan (the kept scan's projection becomes the union).  Sinks never
        merge; sources only when replayable; a merge that would make a
        parallel edge is skipped.  Returns the number of nodes removed."""
        removed = 0
        changed = True
        while changed:
            changed = False
            by_sig: Dict[tuple, str] = {}
            for op_id in self.topo_order():
                node = self.node(op_id)
                preds = tuple(sorted(
                    (s, e.typ.value, e.key_schema)
                    for s, _, e in self.graph.in_edges(op_id)))
                if node.operator.kind == OpKind.CONNECTOR_SINK:
                    continue
                if node.operator.kind == OpKind.CONNECTOR_SOURCE:
                    spec = node.operator.spec
                    if spec.connector not in self._REPLAYABLE_SOURCES:
                        continue
                    cfg = {k: v for k, v in spec.config.items()
                           if k != "projection"}
                    sig = ("src", spec.connector,
                           repr(sorted(cfg.items(), key=lambda kv: kv[0])),
                           node.parallelism, node.max_parallelism)
                else:
                    sig = (node.operator.hash_token(), node.parallelism,
                           node.max_parallelism, preds)
                keep = by_sig.get(sig)
                if keep is None:
                    by_sig[sig] = op_id
                    continue
                # a name-only expression token proves nothing about the
                # function: merge only the very same function object
                expr = node.operator.expr
                if expr is not None and not expr.sql:
                    kept_expr = self.node(keep).operator.expr
                    if kept_expr is None or kept_expr.fn is not expr.fn:
                        continue
                outs = self.graph.out_edges(op_id)
                if any(self.graph.has_edge(keep, dst) for _, dst, _ in outs):
                    continue
                if node.operator.kind == OpKind.CONNECTOR_SOURCE:
                    kcfg = self.node(keep).operator.spec.config
                    pa = kcfg.get("projection")
                    pb = node.operator.spec.config.get("projection")
                    if pa and pb:
                        kcfg["projection"] = sorted(set(pa) | set(pb))
                    else:
                        kcfg.pop("projection", None)
                for _, dst, edge in outs:
                    self.graph.add_edge(keep, dst, edge)
                self.graph.remove_node(op_id)
                removed += 1
                changed = True
                break
        return removed

    def subplan_equal(self, a: str, b: str) -> bool:
        """True when the subplans ending at ``a`` and ``b`` provably
        compute the same stream: equal tokens and recursively equal
        inputs (false negatives only cost an optimization)."""
        if a == b:
            return True
        na, nb = self.node(a), self.node(b)
        if (na.operator.hash_token() != nb.operator.hash_token()
                or na.parallelism != nb.parallelism):
            return False
        if (na.operator.kind == OpKind.CONNECTOR_SOURCE
                and na.operator.spec.connector
                not in self._REPLAYABLE_SOURCES):
            return False
        ea_, eb_ = na.operator.expr, nb.operator.expr
        if ea_ is not None and not ea_.sql and ea_.fn is not (
                eb_.fn if eb_ is not None else None):
            return False
        key = lambda e: (e[2].typ.value, e[2].key_schema)  # noqa: E731
        pa = sorted(self.graph.in_edges(a), key=key)
        pb = sorted(self.graph.in_edges(b), key=key)
        if [key(e) for e in pa] != [key(e) for e in pb]:
            return False
        return all(self.subplan_equal(sa, sb)
                   for (sa, _, _), (sb, _, _) in zip(pa, pb))

    def prune_dead(self) -> int:
        """Remove operators whose output reaches no sink (subplans the
        optimizer bypassed, e.g. the pruned max side of an argmax
        fusion).  Returns the number of nodes removed."""
        removed = 0
        changed = True
        while changed:
            changed = False
            for nid in list(self.graph.node_ids()):
                if self.node(nid).operator.kind == OpKind.CONNECTOR_SINK:
                    continue
                if self.graph.out_degree(nid) == 0:
                    self.graph.remove_node(nid)
                    removed += 1
                    changed = True
        return removed


# -- fluent builder ---------------------------------------------------------------


class Stream:
    """``Stream.source(...).map(...).key_by(...).sliding_aggregate(...).sink(...)``"""

    def __init__(self, program: Program, tail: str,
                 keyed: Tuple[str, ...] = ()):
        self.program = program
        self.tail = tail
        self.keyed = keyed

    @staticmethod
    def source(connector: str, config: Optional[Dict[str, Any]] = None,
               parallelism: int = 1, program: Optional[Program] = None,
               name: Optional[str] = None) -> "Stream":
        from ..connectors.registry import get_connector, validate_config

        if not get_connector(connector).supports_source:
            raise ValueError(f"connector {connector!r} does not support sources")
        cfg = validate_config(connector, config or {})
        p = program or Program()
        op = LogicalOperator(OpKind.CONNECTOR_SOURCE,
                             name or f"{connector}_source",
                             spec=ConnectorOpSpec(connector, cfg))
        return Stream(p, p.add_node(op, parallelism))

    def _chain(self, op: LogicalOperator, parallelism: Optional[int] = None,
               edge: EdgeType = EdgeType.FORWARD,
               keyed: Optional[Tuple[str, ...]] = None) -> "Stream":
        par = (parallelism if parallelism is not None
               else self.program.node(self.tail).parallelism)
        nid = self.program.add_node(op, par)
        key_schema = ",".join(self.keyed) if self.keyed else "()"
        self.program.add_edge(self.tail, nid, edge, key_schema=key_schema)
        return Stream(self.program, nid, self.keyed if keyed is None else keyed)

    # -- element-wise ----------------------------------------------------------

    def map(self, fn: Callable, name: str = "map", sql: str = "",
            output_schema: Optional[Dict[str, Any]] = None) -> "Stream":
        expr = ColumnExpr(name, fn, ExprReturnType.RECORD, output_schema,
                          sql=sql)
        return self._chain(LogicalOperator(OpKind.EXPRESSION, name, expr=expr))

    def filter(self, fn: Callable, name: str = "filter") -> "Stream":
        expr = ColumnExpr(name, fn, ExprReturnType.PREDICATE)
        return self._chain(LogicalOperator(OpKind.EXPRESSION, name, expr=expr))

    def option_map(self, fn: Callable, name: str = "option_map") -> "Stream":
        expr = ColumnExpr(name, fn, ExprReturnType.OPTIONAL_RECORD)
        return self._chain(LogicalOperator(OpKind.EXPRESSION, name, expr=expr))

    def flat_map(self, fn: Callable, name: str = "flat_map") -> "Stream":
        """``fn`` returns a record whose list column ``__flatten`` is
        expanded into one row a list element."""
        expr = ColumnExpr(name, fn, ExprReturnType.RECORD)
        return self._chain(LogicalOperator(OpKind.FLAT_MAP, name, expr=expr))

    def flatten(self, name: str = "flatten") -> "Stream":
        return self._chain(LogicalOperator(OpKind.FLATTEN, name))

    def udf(self, fn: Callable, name: str = "udf", sql: str = "",
            output_schema: Optional[Dict[str, Any]] = None) -> "Stream":
        expr = ColumnExpr(name, fn, ExprReturnType.RECORD, output_schema,
                          sql=sql)
        return self._chain(LogicalOperator(OpKind.UDF, name, expr=expr))

    # -- time ------------------------------------------------------------------

    def watermark(self, max_lateness_micros: int = 0,
                  idle_time_micros: Optional[int] = None,
                  expression: Optional[Callable] = None,
                  name: str = "watermark") -> "Stream":
        expr = None
        if expression is not None:
            expr = ColumnExpr(f"{name}_expr", expression)
        spec = PeriodicWatermarkSpec(max_lateness_micros, idle_time_micros,
                                     expr)
        return self._chain(LogicalOperator(OpKind.WATERMARK, name, spec=spec))

    # -- keying ----------------------------------------------------------------

    def key_by(self, *cols: str, name: str = "key_by") -> "Stream":
        op = LogicalOperator(OpKind.KEY_BY, name, key_cols=tuple(cols))
        return self._chain(op, keyed=tuple(cols))

    def global_key(self, name: str = "global_key") -> "Stream":
        op = LogicalOperator(OpKind.GLOBAL_KEY, name)
        return self._chain(op, keyed=("__global",))

    def non_window_aggregate(self, expiration_micros: int,
                             aggs: Sequence[AggSpec],
                             projection: Optional[Callable] = None,
                             name: str = "updating_agg",
                             flush_key: Optional[str] = None) -> "Stream":
        proj = ColumnExpr(f"{name}_proj", projection) if projection else None
        spec = NonWindowAggregatorSpec(expiration_micros, tuple(aggs), proj,
                                       flush_key)
        op = LogicalOperator(OpKind.NON_WINDOW_AGGREGATOR, name, spec=spec)
        return self._chain(op, edge=EdgeType.SHUFFLE)

    def count(self, name: str = "count") -> "Stream":
        """A running count a key, one row a key a batch."""
        return self._chain(LogicalOperator(OpKind.COUNT, name),
                           edge=EdgeType.SHUFFLE)

    def aggregate(self, agg: AggSpec, name: str = "aggregate") -> "Stream":
        """A running MAX, MIN or SUM a key, one row a key a batch."""
        op = LogicalOperator(OpKind.AGGREGATE, name, spec=agg)
        return self._chain(op, edge=EdgeType.SHUFFLE)

    # -- updating streams --------------------------------------------------------

    def updating(self, fn: Callable, name: str = "updating") -> "Stream":
        expr = ColumnExpr(name, fn, ExprReturnType.OPTIONAL_RECORD)
        return self._chain(LogicalOperator(OpKind.UPDATING, name, expr=expr))

    def updating_key(self, *cols: str, name: str = "updating_key"
                     ) -> "Stream":
        op = LogicalOperator(OpKind.UPDATING_KEY, name, key_cols=tuple(cols))
        return self._chain(op, keyed=tuple(cols))

    def union(self, other: "Stream", name: str = "union",
              parallelism: Optional[int] = None) -> "Stream":
        """UNION ALL: batches from both streams flow through unchanged;
        the watermark is the minimum over the inputs."""
        if self.program is not other.program:
            raise ValueError("union streams must share a Program")
        if other.tail == self.tail:
            # a self-union would be one edge twice, which the graph keeps
            # once: one side goes through a pass-through node
            dup = LogicalOperator(OpKind.UNION, f"{name}_dup")
            dup_id = self.program.add_node(
                dup, self.program.node(other.tail).parallelism)
            self.program.add_edge(other.tail, dup_id, EdgeType.FORWARD,
                                  key_schema="()")
            other = Stream(self.program, dup_id)
        op = LogicalOperator(OpKind.UNION, name)
        par = parallelism or self.program.node(self.tail).parallelism
        nid = self.program.add_node(op, par)
        self.program.add_edge(self.tail, nid, EdgeType.SHUFFLE,
                              key_schema="()")
        self.program.add_edge(other.tail, nid, EdgeType.SHUFFLE,
                              key_schema="()")
        return Stream(self.program, nid)

    # -- windows (keyed) -------------------------------------------------------

    def window(self, typ: WindowType, aggs: Sequence[AggSpec] = (),
               flatten: bool = False, projection: Optional[Callable] = None,
               name: Optional[str] = None,
               parallelism: Optional[int] = None) -> "Stream":
        label = name or f"window_{window_label(typ)}"
        proj = ColumnExpr(f"{label}_proj", projection) if projection else None
        spec = WindowSpec(typ, tuple(aggs), flatten, proj)
        op = LogicalOperator(OpKind.WINDOW, label, spec=spec)
        return self._chain(op, parallelism, EdgeType.SHUFFLE)

    def sliding_aggregate(self, width_micros: int, slide_micros: int,
                          aggs: Sequence[AggSpec],
                          projection: Optional[Callable] = None,
                          name: str = "sliding_agg",
                          parallelism: Optional[int] = None) -> "Stream":
        proj = ColumnExpr(f"{name}_proj", projection) if projection else None
        spec = SlidingAggregatorSpec(width_micros, slide_micros, tuple(aggs),
                                     proj)
        op = LogicalOperator(OpKind.SLIDING_WINDOW_AGGREGATOR, name, spec=spec)
        return self._chain(op, parallelism, EdgeType.SHUFFLE)

    def tumbling_aggregate(self, width_micros: int, aggs: Sequence[AggSpec],
                           projection: Optional[Callable] = None,
                           name: str = "tumbling_agg",
                           parallelism: Optional[int] = None) -> "Stream":
        proj = ColumnExpr(f"{name}_proj", projection) if projection else None
        spec = TumblingAggregatorSpec(width_micros, tuple(aggs), proj)
        op = LogicalOperator(OpKind.TUMBLING_WINDOW_AGGREGATOR, name, spec=spec)
        return self._chain(op, parallelism, EdgeType.SHUFFLE)

    def tumbling_top_n(self, width_micros: int, max_elements: Optional[int],
                       sort_column: str, partition_cols: Sequence[str] = (),
                       projection: Optional[Callable] = None,
                       name: str = "tumbling_top_n",
                       parallelism: Optional[int] = None) -> "Stream":
        """Per ``width_micros`` window, keep the top ``max_elements`` rows
        by ``sort_column`` (descending) per partition."""
        proj = ColumnExpr(f"{name}_proj", projection) if projection else None
        spec = TopNSpec(width_micros, max_elements, sort_column,
                        tuple(partition_cols), proj)
        op = LogicalOperator(OpKind.TUMBLING_TOP_N, name, spec=spec)
        return self._chain(op, parallelism, EdgeType.SHUFFLE)

    def sliding_aggregating_top_n(self, width_micros: int, slide_micros: int,
                                  aggs: Sequence[AggSpec],
                                  partition_cols: Sequence[str],
                                  sort_column: str, max_elements: int,
                                  projection: Optional[Callable] = None,
                                  name: str = "sliding_topn",
                                  parallelism: Optional[int] = None
                                  ) -> "Stream":
        """A sliding aggregate whose pane emission keeps only the top
        ``max_elements`` rows by ``sort_column`` per window."""
        proj = ColumnExpr(f"{name}_proj", projection) if projection else None
        spec = SlidingAggregatingTopNSpec(
            width_micros, slide_micros, tuple(aggs), tuple(partition_cols),
            sort_column, max_elements, proj)
        op = LogicalOperator(OpKind.SLIDING_AGGREGATING_TOP_N, name,
                             spec=spec)
        return self._chain(op, parallelism, EdgeType.SHUFFLE)

    def window_argmax(self, value_col: str, minmax: str,
                      synth_cols: Tuple[Tuple[str, str], ...],
                      width_micros: int, name: str = "window_argmax",
                      parallelism: Optional[int] = None,
                      agg_out: str = "", raw: bool = False,
                      late_ttl_micros: int = 0) -> "Stream":
        """Per-window argmax/argmin filter (see WindowArgmaxSpec).  The
        stream must be keyed by the window column so every row of one
        window lands on one subtask."""
        spec = WindowArgmaxSpec(value_col, minmax, tuple(synth_cols),
                                width_micros, agg_out, raw, late_ttl_micros)
        op = LogicalOperator(OpKind.WINDOW_ARGMAX, name, spec=spec)
        return self._chain(op, parallelism, EdgeType.SHUFFLE)

    # -- joins -------------------------------------------------------------------

    def window_join(self, other: "Stream", window: Any,
                    join_type: JoinType = JoinType.INNER,
                    left_cols: Tuple[Tuple[str, str], ...] = (),
                    right_cols: Tuple[Tuple[str, str], ...] = (),
                    name: str = "window_join",
                    parallelism: Optional[int] = None) -> "Stream":
        """Join this stream (left, side 0) with ``other`` (right, side 1)
        per window; both must be keyed by the join key."""
        spec = WindowJoinSpec(window, join_type, tuple(left_cols),
                              tuple(right_cols))
        return self._join(other, OpKind.WINDOW_JOIN, spec, name, parallelism)

    def join_with_expiration(self, other: "Stream",
                             left_expiration_micros: int,
                             right_expiration_micros: int,
                             join_type: JoinType = JoinType.INNER,
                             left_cols: Tuple[Tuple[str, str], ...] = (),
                             right_cols: Tuple[Tuple[str, str], ...] = (),
                             name: str = "join",
                             parallelism: Optional[int] = None) -> "Stream":
        """Join this stream (left, side 0) with ``other`` (right, side 1)
        without windows: each side's rows stay joinable until the
        watermark passes their time plus that side's TTL."""
        spec = JoinWithExpirationSpec(left_expiration_micros,
                                      right_expiration_micros, join_type,
                                      tuple(left_cols), tuple(right_cols))
        return self._join(other, OpKind.JOIN_WITH_EXPIRATION, spec, name,
                          parallelism)

    def multi_way_join(self, others: Sequence["Stream"],
                       typ: Optional[Any] = None, ttl_micros: int = 0,
                       side_cols: Tuple[Tuple[Tuple[str, str], ...],
                                        ...] = (),
                       name: str = "multi_way_join",
                       parallelism: Optional[int] = None) -> "Stream":
        """N-ary INNER equi-join of this stream (side 0) and ``others``
        (sides 1..), all keyed by the same columns; see
        :class:`MultiWayJoinSpec`."""
        sides = [self] + list(others)
        if not 2 <= len(sides) <= 8:
            raise ValueError("a multi-way join has 2 to 8 sides")
        if len({s.tail for s in sides}) != len(sides):
            raise ValueError("multi-way join sides must be distinct nodes")
        if any(s.program is not self.program for s in sides):
            raise ValueError("join streams must share a Program")
        if not side_cols:
            side_cols = tuple(() for _ in sides)
        if len(side_cols) != len(sides):
            raise ValueError("side_cols needs one entry a join side")
        spec = MultiWayJoinSpec(typ, ttl_micros, tuple(side_cols))
        op = LogicalOperator(OpKind.MULTI_WAY_JOIN, name, spec=spec)
        par = parallelism or self.program.node(self.tail).parallelism
        nid = self.program.add_node(op, par)
        ks = ",".join(self.keyed) if self.keyed else "()"
        for i, s in enumerate(sides):
            self.program.add_edge(s.tail, nid, join_side_edge(i),
                                  key_schema=ks)
        return Stream(self.program, nid, self.keyed)

    def _join(self, other: "Stream", kind: OpKind, spec: Any, name: str,
              parallelism: Optional[int]) -> "Stream":
        if self.program is not other.program:
            raise ValueError("join streams must share a Program")
        op = LogicalOperator(kind, name, spec=spec)
        par = parallelism or self.program.node(self.tail).parallelism
        nid = self.program.add_node(op, par)
        ks = ",".join(self.keyed) if self.keyed else "()"
        self.program.add_edge(self.tail, nid, EdgeType.SHUFFLE_JOIN_LEFT,
                              key_schema=ks)
        self.program.add_edge(other.tail, nid, EdgeType.SHUFFLE_JOIN_RIGHT,
                              key_schema=ks)
        return Stream(self.program, nid, self.keyed)

    # -- sinks -----------------------------------------------------------------

    def sink(self, connector: str, config: Optional[Dict[str, Any]] = None,
             parallelism: Optional[int] = None,
             name: Optional[str] = None,
             max_parallelism: Optional[int] = None) -> Program:
        from ..connectors.registry import get_connector, validate_config

        if not get_connector(connector).supports_sink:
            raise ValueError(f"connector {connector!r} does not support sinks")
        cfg = validate_config(connector, config or {})
        op = LogicalOperator(OpKind.CONNECTOR_SINK, name or f"{connector}_sink",
                             spec=ConnectorOpSpec(connector, cfg))
        tail = self._chain(op, parallelism)
        if max_parallelism is not None:
            self.program.node(tail.tail).max_parallelism = max_parallelism
        return self.program
