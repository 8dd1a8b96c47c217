"""Factor-window sharing, the decision only — the port of the analysis
half of ``arroyo_tpu.graph.factor_windows``.

The JAX package rewrites correlated window aggregates (same upstream
input and keying, bin-mergeable aggregates, different widths or slides)
onto one shared pane ring of ``gcd(widths ∪ slides)`` micros with a
derived window a member, when ``min(slides) / pane <= 64`` (the JAX
package's default ``ARROYO_FACTOR_MAX_RATIO``).  The port has neither the
factor-pane nor the derived-window operator (ROADMAP A.8), so its
planner computes the same decision and refuses a plan the JAX package
would rewrite, rather than run a different topology.
``ARROYO_FACTOR_WINDOWS=0`` turns the pass off in both packages."""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .logical import (
    AggKind,
    EdgeType,
    ExprReturnType,
    OpKind,
    Program,
    TumblingAggregatorSpec,
)

# the bin-mergeable aggregate set (what ops/keyed_bins maintains)
MERGEABLE = frozenset({AggKind.COUNT, AggKind.SUM, AggKind.MIN,
                       AggKind.MAX, AggKind.AVG})

_MEMBER_KINDS = (OpKind.SLIDING_WINDOW_AGGREGATOR,
                 OpKind.TUMBLING_WINDOW_AGGREGATOR)


def factor_windows_enabled() -> bool:
    """``ARROYO_FACTOR_WINDOWS=0`` disables the pass (read per call;
    ``auto`` and ``1`` both mean the cost model decides)."""
    return os.environ.get("ARROYO_FACTOR_WINDOWS", "auto") not in (
        "0", "off", "false")


# largest acceptable ``min(slide) / pane``: above it the shared ring
# would fire that many times more often than the finest member
MAX_PANE_RATIO = 64


@dataclass
class FactorDecision:
    """One cost-model evaluation over a correlated-window group."""

    members: List[str]
    pane_micros: int
    shared: bool


def _member_params(spec) -> Tuple[int, int]:
    """(width, slide) micros of a member aggregator spec."""
    if isinstance(spec, TumblingAggregatorSpec):
        return spec.width_micros, spec.width_micros
    return spec.width_micros, spec.slide_micros


def _aggin_parts(sql: str) -> Optional[Tuple[str, List[str]]]:
    """Split an ``aggin:`` structural token into (key-exprs part, list of
    canonical aggregate tokens) — None when not an aggin token."""
    if not sql.startswith("aggin:") or "|" not in sql:
        return None
    keys_part, aggs_part = sql[len("aggin:"):].split("|", 1)
    try:
        import ast

        toks = ast.literal_eval(aggs_part)
    except (ValueError, SyntaxError):
        return None
    if not isinstance(toks, list):
        return None
    return keys_part, [str(t) for t in toks]


def _candidate(program: Program, op_id: str
               ) -> Optional[Tuple[str, int, str]]:
    """(anchor, private tail length, key token) of an eligible member,
    walking up through a private [agg_input projection ->] key_by tail
    when present; None when the node cannot be a member."""
    g = program.graph
    node = program.node(op_id)
    if node.operator.kind not in _MEMBER_KINDS:
        return None
    spec = node.operator.spec
    if getattr(spec, "argmax_local", None) is not None:
        return None  # emission is coupled to a WindowArgmax consumer
    width, slide = _member_params(spec)
    if width <= 0 or slide <= 0 or width % slide != 0:
        return None
    for a in spec.aggs:
        if a.kind not in MERGEABLE or a.fn is not None:
            return None
        if a.output.startswith("__f"):
            return None
    in_edges = g.in_edges(op_id)
    if len(in_edges) != 1:
        return None
    src, _, edge = in_edges[0]
    if edge.typ is not EdgeType.SHUFFLE:
        return None
    direct = (src, 0, f"node:{src}:{edge.key_schema}")
    up = program.node(src)
    if not (up.operator.kind is OpKind.KEY_BY and g.out_degree(src) == 1
            and g.in_degree(src) == 1):
        return direct
    kb_src, _, kb_edge = g.in_edges(src)[0]
    if kb_edge.typ is not EdgeType.FORWARD:
        return direct
    proj = program.node(kb_src)
    parts = (_aggin_parts(proj.operator.expr.sql)
             if proj.operator.kind in (OpKind.EXPRESSION, OpKind.UDF)
             and proj.operator.expr is not None else None)
    if (parts is not None and g.out_degree(kb_src) == 1
            and g.in_degree(kb_src) == 1
            and proj.operator.expr.return_type is ExprReturnType.RECORD):
        traced = sum(1 for j, a in enumerate(spec.aggs)
                     if a.column is not None and j < len(parts[1]))
        if traced != sum(1 for a in spec.aggs if a.column is not None):
            return direct
        return (g.predecessors(kb_src)[0], 2, f"aggin:{parts[0]}")
    return (kb_src, 1, f"keyby:{up.operator.key_cols}:{edge.key_schema}")


def plan_factor_windows(program: Program) -> List[FactorDecision]:
    """Group correlated members and run the JAX package's cost model.
    Returns every evaluated decision, shared and refused; empty when the
    pass is disabled."""
    if not factor_windows_enabled():
        return []
    groups: Dict[Tuple, List[str]] = {}
    for op_id in program.topo_order():
        cand = _candidate(program, op_id)
        if cand is None:
            continue
        node = program.node(op_id)
        sig = cand + (node.parallelism, node.max_parallelism)
        groups.setdefault(sig, []).append(op_id)
    out: List[FactorDecision] = []
    for members in groups.values():
        if len(members) < 2:
            continue
        params = [_member_params(program.node(m).operator.spec)
                  for m in members]
        widths = [w for w, _ in params]
        slides = [s for _, s in params]
        g = math.gcd(*(widths + slides))
        shared = min(slides) // max(g, 1) <= MAX_PANE_RATIO
        out.append(FactorDecision(members, g, shared))
    return out
