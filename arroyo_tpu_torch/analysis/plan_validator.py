"""Plan-time validation of logical Programs — the graph-level half of
``arroyo_tpu.analysis.plan_validator``, with the same codes, severities,
messages and order of diagnostics.

``Engine`` runs it through ``engine/build.validate_before_build`` before
any operator is built: error diagnostics reject the plan, warnings do not.

Codes:

- ``cycle`` — the operator graph must be a DAG;
- ``dangling-node`` — a non-source node with no input (a dropped edge);
- ``dead-end`` — warning: a non-sink node whose output reaches nothing;
- ``keyed-not-shuffled`` — an operator with key-partitioned state fed by
  a FORWARD edge sees a slice of each key's rows (a derived window's
  FORWARD edge from its factor is co-partitioned by construction; an
  operator pinned to one subtask is exempt);
- ``factor-shape`` — a derived window is fed by exactly one factor whose
  pane matches its spec, divides its slide and width and runs at its
  parallelism; a factor feeds derived windows only;
- ``join-sides`` / ``key-schema-mismatch`` — a join needs one input a
  side, all shuffled on keys of one arity;
- ``window-no-watermark`` — a window never fires without an upstream
  watermark;
- ``window-spec`` — non-positive width, slide, gap or factor pane;
- ``slide-width`` — warning: a slide that does not divide the width.

The JAX package's ``plan_report`` adds shardcheck (its mesh sharding and
transfer verifier), which the port does not have before multi-GPU state
(ROADMAP A.10)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..graph.logical import (
    EdgeType,
    OpKind,
    Program,
    SessionWindow,
    SlidingAggregatingTopNSpec,
    SlidingAggregatorSpec,
    SlidingWindow,
    TumblingAggregatorSpec,
    TumblingWindow,
    WindowSpec,
)


@dataclass
class PlanDiagnostic:
    code: str
    severity: str  # 'error' | 'warning'
    message: str
    node: Optional[str] = None

    def to_json(self) -> Dict:
        return {"code": self.code, "severity": self.severity,
                "node": self.node, "message": self.message}

    def render(self) -> str:
        where = f" [{self.node}]" if self.node else ""
        return f"{self.severity}: {self.code}{where}: {self.message}"


class PlanValidationError(ValueError):
    def __init__(self, diagnostics: List[PlanDiagnostic]):
        self.diagnostics = diagnostics
        super().__init__("; ".join(d.render() for d in diagnostics))


KEYED_STATE_KINDS = frozenset({
    OpKind.WINDOW, OpKind.SLIDING_WINDOW_AGGREGATOR,
    OpKind.TUMBLING_WINDOW_AGGREGATOR, OpKind.TUMBLING_TOP_N,
    OpKind.SLIDING_AGGREGATING_TOP_N, OpKind.WINDOW_JOIN,
    OpKind.JOIN_WITH_EXPIRATION, OpKind.NON_WINDOW_AGGREGATOR,
    OpKind.COUNT, OpKind.AGGREGATE, OpKind.WINDOW_ARGMAX,
    OpKind.MULTI_WAY_JOIN, OpKind.WINDOW_FACTOR, OpKind.DERIVED_WINDOW,
})
_JOIN_KINDS = (OpKind.WINDOW_JOIN, OpKind.JOIN_WITH_EXPIRATION)


def _key_arity(key_schema: str) -> int:
    ks = (key_schema or "").strip()
    if ks in ("", "()"):
        return 0
    return len([c for c in ks.split(",") if c.strip()])


def _is_dag(program: Program) -> bool:
    try:
        program.topo_order()
    except ValueError:
        return False
    return True


def _factor_diagnostics(program: Program, op_id: str, in_edges
                        ) -> List[PlanDiagnostic]:
    """``factor-shape`` (and a factor's ``window-spec``) of one node."""
    out: List[PlanDiagnostic] = []
    node = program.node(op_id)
    kind = node.operator.kind
    spec = node.operator.spec
    if kind is OpKind.DERIVED_WINDOW:
        srcs = [s for s, _, _ in in_edges]
        fsrcs = [s for s in srcs if program.node(s).operator.kind
                 is OpKind.WINDOW_FACTOR]
        if len(in_edges) != 1 or len(fsrcs) != 1:
            out.append(PlanDiagnostic(
                "factor-shape", "error",
                f"{node.operator.name} (derived_window) must be fed by "
                f"exactly one window_factor node (inputs: {srcs})",
                node=op_id))
            return out
        fnode = program.node(fsrcs[0])
        pane = fnode.operator.spec.pane_micros
        if (spec.pane_micros != pane
                or spec.slide_micros % max(pane, 1) != 0
                or spec.width_micros % max(pane, 1) != 0):
            out.append(PlanDiagnostic(
                "factor-shape", "error",
                f"{node.operator.name}: factor pane {pane}us must match "
                f"the spec ({spec.pane_micros}us) and divide slide "
                f"{spec.slide_micros}us / width {spec.width_micros}us",
                node=op_id))
        if fnode.parallelism != node.parallelism:
            out.append(PlanDiagnostic(
                "factor-shape", "error",
                f"{node.operator.name}: factor parallelism "
                f"{fnode.parallelism} != derived parallelism "
                f"{node.parallelism}; the FORWARD pane edge would "
                "rebalance and break keyed routing", node=op_id))
    elif kind is OpKind.WINDOW_FACTOR:
        if spec.pane_micros <= 0:
            out.append(PlanDiagnostic(
                "window-spec", "error",
                f"{node.operator.name}: factor pane must be positive "
                f"(got {spec.pane_micros})", node=op_id))
        non_derived = [
            dst for _, dst, _e in program.graph.out_edges(op_id)
            if program.node(dst).operator.kind is not OpKind.DERIVED_WINDOW]
        if non_derived:
            out.append(PlanDiagnostic(
                "factor-shape", "error",
                f"{node.operator.name} (window_factor) emits "
                "partial-aggregate pane columns that only derived_window "
                f"consumers understand (non-derived consumers: "
                f"{non_derived})", node=op_id))
    return out


def _join_diagnostics(program: Program, op_id: str, in_edges
                      ) -> List[PlanDiagnostic]:
    out: List[PlanDiagnostic] = []
    node = program.node(op_id)
    name = node.operator.name
    if node.operator.kind in _JOIN_KINDS:
        left = [e for _, _, e in in_edges
                if e.typ is EdgeType.SHUFFLE_JOIN_LEFT]
        right = [e for _, _, e in in_edges
                 if e.typ is EdgeType.SHUFFLE_JOIN_RIGHT]
        if len(left) != 1 or len(right) != 1:
            out.append(PlanDiagnostic(
                "join-sides", "error",
                f"{name} needs exactly one left and one right input (got "
                f"{len(left)} left, {len(right)} right)", node=op_id))
        elif _key_arity(left[0].key_schema) != _key_arity(
                right[0].key_schema):
            out.append(PlanDiagnostic(
                "key-schema-mismatch", "error",
                f"{name} joins streams shuffled on different key arities "
                f"({left[0].key_schema!r} vs {right[0].key_schema!r}); "
                "rows for the same join key would land on different "
                "subtasks", node=op_id))
    elif node.operator.kind is OpKind.MULTI_WAY_JOIN:
        n_sides = len(getattr(node.operator.spec, "side_cols", ()) or ())
        by_side: Dict[int, List[Any]] = {}
        for _, _, e in in_edges:
            s = e.typ.join_side
            if s is None:
                out.append(PlanDiagnostic(
                    "join-sides", "error",
                    f"{name} has a non-join input edge ({e.typ.value})",
                    node=op_id))
            else:
                by_side.setdefault(s, []).append(e)
        if n_sides and (sorted(by_side) != list(range(n_sides))
                        or any(len(v) != 1 for v in by_side.values())):
            out.append(PlanDiagnostic(
                "join-sides", "error",
                f"{name} declares {n_sides} sides but has inputs for "
                f"sides {sorted(by_side)}", node=op_id))
        if len({_key_arity(es[0].key_schema)
                for es in by_side.values()}) > 1:
            out.append(PlanDiagnostic(
                "key-schema-mismatch", "error",
                f"{name} joins sides shuffled on different key arities; "
                "rows for the same join key would land on different "
                "subtasks", node=op_id))
    return out


def _window_params(kind: OpKind, spec: Any, name: str, op_id: str,
                   out: List[PlanDiagnostic]):
    """(width, slide) of a window spec, either None where it has none; a
    session gap's ``window-spec`` error goes to ``out``."""
    if kind is OpKind.DERIVED_WINDOW:
        return spec.width_micros, spec.slide_micros
    if isinstance(spec, (SlidingAggregatorSpec, SlidingAggregatingTopNSpec)):
        return spec.width_micros, spec.slide_micros
    if isinstance(spec, TumblingAggregatorSpec):
        return spec.width_micros, None
    if isinstance(spec, WindowSpec):
        if isinstance(spec.typ, TumblingWindow):
            return spec.typ.width_micros, None
        if isinstance(spec.typ, SlidingWindow):
            return spec.typ.width_micros, spec.typ.slide_micros
        if isinstance(spec.typ, SessionWindow) and spec.typ.gap_micros <= 0:
            out.append(PlanDiagnostic(
                "window-spec", "error",
                f"{name}: session gap must be positive", node=op_id))
    return None, None


def validate_program(program: Program) -> List[PlanDiagnostic]:
    diags: List[PlanDiagnostic] = []
    g = program.graph
    if not _is_dag(program):
        diags.append(PlanDiagnostic(
            "cycle", "error",
            "operator graph contains a cycle; streaming plans must be "
            "DAGs"))
        return diags  # the checks below assume a DAG

    for op_id in g.node_ids():
        node = program.node(op_id)
        kind = node.operator.kind
        name = node.operator.name
        in_edges = g.in_edges(op_id)

        if not in_edges and kind != OpKind.CONNECTOR_SOURCE:
            diags.append(PlanDiagnostic(
                "dangling-node", "error",
                f"{name} ({kind.value}) has no inputs but is not a source "
                "— a dropped edge or dead subplan", node=op_id))
        if g.out_degree(op_id) == 0 and kind != OpKind.CONNECTOR_SINK:
            diags.append(PlanDiagnostic(
                "dead-end", "warning",
                f"{name} ({kind.value}) output reaches no sink",
                node=op_id))

        if (kind in KEYED_STATE_KINDS and in_edges
                and node.max_parallelism != 1):
            forwards = [s for s, _, e in in_edges
                        if e.typ is EdgeType.FORWARD]
            if kind is OpKind.DERIVED_WINDOW:
                # the FORWARD edge from the factor is co-partitioned by
                # construction: only other forwards are unrouted
                forwards = [s for s in forwards
                            if program.node(s).operator.kind
                            is not OpKind.WINDOW_FACTOR]
            if forwards:
                diags.append(PlanDiagnostic(
                    "keyed-not-shuffled", "error",
                    f"{name} ({kind.value}) holds key-partitioned state but "
                    f"is fed by FORWARD edge(s) from {forwards}; each "
                    "subtask would see only a slice of each key's rows",
                    node=op_id))

        diags.extend(_factor_diagnostics(program, op_id, in_edges))
        diags.extend(_join_diagnostics(program, op_id, in_edges))

        if kind in program.WINDOWED_KINDS and not any(
                program.node(a).operator.kind == OpKind.WATERMARK
                for a in g.ancestors(op_id)):
            diags.append(PlanDiagnostic(
                "window-no-watermark", "error",
                f"{name} ({kind.value}) requires a watermark-assigning "
                "operator upstream; without one its windows never fire",
                node=op_id))

        width, slide = _window_params(kind, node.operator.spec, name, op_id,
                                      diags)
        if width is not None and width <= 0:
            diags.append(PlanDiagnostic(
                "window-spec", "error",
                f"{name}: window width must be positive (got {width})",
                node=op_id))
        if slide is not None:
            if slide <= 0:
                diags.append(PlanDiagnostic(
                    "window-spec", "error",
                    f"{name}: slide must be positive (got {slide})",
                    node=op_id))
            elif width and width % slide != 0:
                diags.append(PlanDiagnostic(
                    "slide-width", "warning",
                    f"{name}: slide {slide} does not divide width {width}; "
                    "panes fall off the bin-merged fast path", node=op_id))
    return diags


def check_program(program: Program) -> List[PlanDiagnostic]:
    """Validate and raise :class:`PlanValidationError` on any error
    diagnostic; return every diagnostic (warnings too) otherwise."""
    diags = validate_program(program)
    errs = [d for d in diags if d.severity == "error"]
    if errs:
        raise PlanValidationError(errs)
    return diags
