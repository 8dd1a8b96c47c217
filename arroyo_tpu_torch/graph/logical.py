"""Logical dataflow graph: window types, aggregate specs, operator
taxonomy, ``Program`` and the fluent ``Stream`` builder — the subset of
``arroyo_tpu.graph.logical`` that the port's operators execute.

Operators carry Python callables over columnar batches (dicts of numpy
columns).  The graph is a small adjacency structure of its own (the JAX
package uses networkx, which the port does not need for a DAG this
size)."""

from __future__ import annotations

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


@dataclass
class ColumnExpr:
    """A columnar expression ``fn(cols: dict[str, ndarray]) -> dict | ndarray``
    evaluated eagerly on host numpy columns."""

    name: str
    fn: Callable[[Dict[str, Any]], Any]
    return_type: ExprReturnType = ExprReturnType.RECORD


# -- operator taxonomy ------------------------------------------------------------


class OpKind(Enum):
    CONNECTOR_SOURCE = "connector_source"
    CONNECTOR_SINK = "connector_sink"
    EXPRESSION = "expression"  # map / filter
    UDF = "udf"  # python function over the raw batch
    WATERMARK = "watermark"
    KEY_BY = "key_by"
    SLIDING_WINDOW_AGGREGATOR = "sliding_window_aggregator"
    TUMBLING_WINDOW_AGGREGATOR = "tumbling_window_aggregator"
    WINDOW_ARGMAX = "window_argmax"  # fused self-join-on-window-max
    WINDOW_JOIN = "window_join"  # windowed stream-stream equi-join
    WINDOW = "window"  # buffered keyed window (session windows)
    JOIN_WITH_EXPIRATION = "join_with_expiration"  # unwindowed TTL join


class JoinType(Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"


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
    synthesize the pruned side's columns (``synth_cols``: (out, src))."""

    value_col: str
    minmax: str
    synth_cols: Tuple[Tuple[str, str], ...]
    width_micros: int  # buffer retention: one window span
    agg_out: str = ""


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


# -- graph ------------------------------------------------------------------------


class EdgeType(Enum):
    FORWARD = "forward"
    SHUFFLE = "shuffle"
    SHUFFLE_JOIN_LEFT = "shuffle_join_0"
    SHUFFLE_JOIN_RIGHT = "shuffle_join_1"

    @property
    def join_side(self) -> Optional[int]:
        """Input-side index carried by shuffle_join_N edges, else None."""
        if self.value.startswith("shuffle_join_"):
            return int(self.value.rsplit("_", 1)[1])
        return None


@dataclass
class StreamNode:
    operator_id: str
    operator: LogicalOperator
    parallelism: int = 1


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

    def map(self, fn: Callable, name: str = "map") -> "Stream":
        expr = ColumnExpr(name, fn, ExprReturnType.RECORD)
        return self._chain(LogicalOperator(OpKind.EXPRESSION, name, expr=expr))

    def filter(self, fn: Callable, name: str = "filter") -> "Stream":
        expr = ColumnExpr(name, fn, ExprReturnType.PREDICATE)
        return self._chain(LogicalOperator(OpKind.EXPRESSION, name, expr=expr))

    def udf(self, fn: Callable, name: str = "udf") -> "Stream":
        expr = ColumnExpr(name, fn, ExprReturnType.RECORD)
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

    def window_argmax(self, value_col: str, minmax: str,
                      synth_cols: Tuple[Tuple[str, str], ...],
                      width_micros: int, name: str = "window_argmax",
                      parallelism: Optional[int] = None,
                      agg_out: str = "") -> "Stream":
        """Per-window argmax/argmin filter (see WindowArgmaxSpec).  The
        stream must be keyed by the window column so every row of one
        window lands on one subtask."""
        spec = WindowArgmaxSpec(value_col, minmax, tuple(synth_cols),
                                width_micros, agg_out)
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
             name: Optional[str] = None) -> Program:
        from ..connectors.registry import get_connector, validate_config

        if not get_connector(connector).supports_sink:
            raise ValueError(f"connector {connector!r} does not support sinks")
        cfg = validate_config(connector, config or {})
        op = LogicalOperator(OpKind.CONNECTOR_SINK, name or f"{connector}_sink",
                             spec=ConnectorOpSpec(connector, cfg))
        self._chain(op, parallelism)
        return self.program
