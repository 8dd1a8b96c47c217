"""Factor-window sharing — the port of ``arroyo_tpu.graph.factor_windows``:
a cost-based rewrite of correlated window aggregates onto one shared
pane ring ("Factor Windows", PAPERS.md: arXiv:2008.12379).

Correlated window aggregates (same upstream input and keying,
bin-mergeable aggregates, different widths or slides) would each keep a
private bin ring, so K overlapping windows pay K times the per-event
update.  The rewrite gives ONE **factor** operator a tumbling pane ring
of ``gcd(widths ∪ slides)`` micros, and turns each member into a
**derived window** that rolls the fired factor panes into its own
(width, slide) output, on the same bin-ring kernels (merge-input mode of
``ops/keyed_bins.py``).

Two correlated shapes are recognized, as in the JAX package:

* **direct** — members fan out from one shared upstream node (the
  Stream-API shape: two window aggregates off one keyed stream);
* **private-tail** — the SQL planner gives every query its own
  ``agg_input_*`` projection and ``key_by`` below a common ancestor;
  members whose tails hang off one ancestor with structurally equal key
  expressions (the ``aggin:`` token) group, and the rewrite replaces
  their tails with ONE union projection (each member's projection, its
  private ``__ain*`` inputs renamed to token-keyed shared names) and one
  ``key_by``.

A member is a sliding or tumbling aggregator fed by one SHUFFLE edge,
with bin-mergeable aggregates only (COUNT, SUM, MIN, MAX, AVG; no UDAF),
no ``argmax_local`` emission coupling, and ``width % slide == 0``.
A group shares when ``min(slides) / pane <= MAX_PANE_RATIO`` (64);
every decision, shared or refused, is recorded on
``program.factor_decisions``.

Checkpoint interchange: each derived node keeps its member's operator id
and channel layout, and the factor drains its pending panes downstream at
every checkpoint barrier, so a factored checkpoint restores into an
unfactored plan and back, epoch for epoch.  ``ARROYO_FACTOR_WINDOWS=0``
turns the pass off and plans the unfactored topology.

The JAX package's ``expand_overrides`` (a factor group rescales as one
unit) serves only the controller's rescale, which the port does not have
yet; it waits for ROADMAP A.11."""

from __future__ import annotations

import ast
import hashlib
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .logical import (
    AggKind,
    AggSpec,
    ColumnExpr,
    DerivedWindowSpec,
    EdgeType,
    ExprReturnType,
    FactorPaneSpec,
    LogicalOperator,
    OpKind,
    Program,
    TumblingAggregatorSpec,
)

# the bin-mergeable aggregate set (what ops/keyed_bins maintains)
MERGEABLE = frozenset({AggKind.COUNT, AggKind.SUM, AggKind.MIN,
                       AggKind.MAX, AggKind.AVG})

# the factor's per-pane row mass: COUNT(*) over the pane, read from the
# counts plane, and the derived ring's per-cell row count, so COUNT(*)
# members stay exact
ROWS_COLUMN = "__f_rows"

_MEMBER_KINDS = (OpKind.SLIDING_WINDOW_AGGREGATOR,
                 OpKind.TUMBLING_WINDOW_AGGREGATOR)


def factor_windows_enabled() -> bool:
    """``ARROYO_FACTOR_WINDOWS=0`` disables the pass (read per call;
    ``auto`` and ``1`` both mean the cost model decides)."""
    return os.environ.get("ARROYO_FACTOR_WINDOWS", "auto") not in (
        "0", "off", "false")


# largest acceptable ``min(slide) / pane`` before sharing loses to
# per-query panes
MAX_PANE_RATIO = 64


@dataclass
class FactorDecision:
    """One cost-model evaluation over a correlated-window group."""

    upstream: str  # the anchor node the shared input hangs off
    members: List[str]
    pane_micros: int
    shared: bool
    reason: str  # 'shared' | refusal cause
    inputs: Dict[str, object] = field(default_factory=dict)
    factor_node: Optional[str] = None  # set once the rewrite applied

    def to_json(self) -> Dict[str, object]:
        return {
            "upstream": self.upstream, "members": list(self.members),
            "pane_micros": self.pane_micros, "shared": self.shared,
            "reason": self.reason, "inputs": dict(self.inputs),
            "factor_node": self.factor_node,
        }


@dataclass
class _Candidate:
    """One eligible member and its (possibly private) input tail."""

    member: str
    anchor: str  # node the shared factor input will hang off
    tail: Tuple[str, ...]  # private nodes anchor -> member, removed
    key_schema: str  # the member's in-edge key schema
    key_token: str  # structural identity of the keying (groups members)
    rename: Dict[str, str] = field(default_factory=dict)  # agg inputs


def _member_params(spec) -> Tuple[int, int]:
    """(width, slide) micros of a member aggregator spec."""
    if isinstance(spec, TumblingAggregatorSpec):
        return spec.width_micros, spec.width_micros
    return spec.width_micros, spec.slide_micros


def _aggin_parts(sql: str) -> Optional[Tuple[str, List[str]]]:
    """Split an ``aggin:`` structural token into (key-exprs part, list of
    canonical aggregate tokens); None when not an aggin token."""
    if not sql.startswith("aggin:") or "|" not in sql:
        return None
    keys_part, aggs_part = sql[len("aggin:"):].split("|", 1)
    try:
        toks = ast.literal_eval(aggs_part)
    except (ValueError, SyntaxError):
        return None
    if not isinstance(toks, list):
        return None
    return keys_part, [str(t) for t in toks]


def _shared_input_name(fc_token: str) -> str:
    """The shared name of a member aggregate's input column, keyed by the
    planner's canonical FunctionCall token: two queries aggregating the
    same expression share one column and one factor partial.  AVG and SUM
    normalize together (their inputs are the same 0.0-filled operand)."""
    t = fc_token.replace("FunctionCall(name='avg'",
                         "FunctionCall(name='sum'", 1)
    return "__fin_" + hashlib.sha1(t.encode()).hexdigest()[:10]


def _candidate(program: Program, op_id: str) -> Optional[_Candidate]:
    """The member's candidate record, walking up through a private
    [agg_input projection ->] key_by tail when there is one."""
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
            return None  # not bin-mergeable (UDAF, COUNT DISTINCT)
        if a.output.startswith("__f"):
            return None  # would collide with the factor partials' names
    in_edges = g.in_edges(op_id)
    if len(in_edges) != 1:
        return None
    src, _, edge = in_edges[0]
    if edge.typ is not EdgeType.SHUFFLE:
        return None  # join sides and forwards never qualify
    direct = _Candidate(op_id, src, (), edge.key_schema,
                        f"node:{src}:{edge.key_schema}")
    up = program.node(src)
    if not (up.operator.kind is OpKind.KEY_BY and g.out_degree(src) == 1
            and g.in_degree(src) == 1):
        return direct  # members share this upstream node, whatever it is
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
        anchor = g.predecessors(kb_src)[0]
        # aggregate inputs rename to token-keyed shared names, so the
        # members' private __ain indices can never collide
        rename: Dict[str, str] = {}
        for j, a in enumerate(spec.aggs):
            if a.column is not None and j < len(parts[1]):
                rename[a.column] = _shared_input_name(parts[1][j])
        if any(a.column is not None and a.column not in rename
               for a in spec.aggs):
            # inputs not traceable to aggin tokens: renaming would be
            # unsound, so members must share a node
            return direct
        return _Candidate(op_id, anchor, (kb_src, src), edge.key_schema,
                          f"aggin:{parts[0]}", rename)
    # a private key_by without a recognizable projection: members on the
    # key_by's own upstream with the same key columns can still group
    return _Candidate(op_id, kb_src, (src,), edge.key_schema,
                      f"keyby:{up.operator.key_cols}:{edge.key_schema}")


def plan_factor_windows(program: Program) -> List[FactorDecision]:
    """Group correlated members and run the cost model: every evaluated
    decision, shared and refused; empty when the pass is off."""
    return [d for d, _ in _plan(program)]


def _plan(program: Program) -> List[Tuple[FactorDecision,
                                          List[_Candidate]]]:
    if not factor_windows_enabled():
        return []
    groups: Dict[Tuple, List[_Candidate]] = {}
    for op_id in program.topo_order():
        cand = _candidate(program, op_id)
        if cand is None:
            continue
        node = program.node(op_id)
        sig = (cand.anchor, len(cand.tail), cand.key_token,
               node.parallelism, node.max_parallelism)
        groups.setdefault(sig, []).append(cand)

    out: List[Tuple[FactorDecision, List[_Candidate]]] = []
    for (anchor, _tl, key_token, par, _mp), cands in groups.items():
        if len(cands) < 2:
            continue  # nothing to share
        members = [c.member for c in cands]
        params = [_member_params(program.node(m).operator.spec)
                  for m in members]
        widths = [w for w, _ in params]
        slides = [s for _, s in params]
        g = math.gcd(*(widths + slides))
        ratio = min(slides) // max(g, 1)
        inputs = {"k": len(members), "widths_micros": widths,
                  "slides_micros": slides, "pane_micros": g,
                  "pane_ratio": ratio,
                  "max_pane_ratio": MAX_PANE_RATIO,
                  "key_token": key_token, "parallelism": par}
        if ratio > MAX_PANE_RATIO:
            # a pathological gcd (coprime slides: 1 us panes) would fire
            # the factor ring `ratio` times as often as the finest member
            out.append((FactorDecision(
                anchor, members, g, False, "pane_ratio_exceeded",
                inputs), cands))
            continue
        out.append((FactorDecision(anchor, members, g, True, "shared",
                                   inputs), cands))
    return out


def factor_aggs_for(member_aggs: List[Tuple[AggSpec, ...]]
                    ) -> Tuple[AggSpec, ...]:
    """The factor's aggregates: the deduplicated union of the members'
    per-pane partials (two members aggregating one column share one
    partial channel).  Per member aggregate:

      COUNT(*)        -> the row-mass COUNT(*) partial (always present)
      SUM(c)/AVG(c)   -> __f_sum_<c>
      MIN(c)/MAX(c)   -> __f_min_<c> / __f_max_<c>
      any column read -> __f_cnt_<c> (the pane's non-null count: COUNT(c)
                         and every null-skipping aggregate's validity)
    """
    out: Dict[str, AggSpec] = {
        ROWS_COLUMN: AggSpec(AggKind.COUNT, None, ROWS_COLUMN)}
    for aggs in member_aggs:
        for a in aggs:
            if a.column is None:
                continue  # COUNT(*): carried by ROWS_COLUMN
            c = a.column
            if a.kind in (AggKind.SUM, AggKind.AVG):
                out.setdefault(f"__f_sum_{c}",
                               AggSpec(AggKind.SUM, c, f"__f_sum_{c}"))
            elif a.kind == AggKind.MIN:
                out.setdefault(f"__f_min_{c}",
                               AggSpec(AggKind.MIN, c, f"__f_min_{c}"))
            elif a.kind == AggKind.MAX:
                out.setdefault(f"__f_max_{c}",
                               AggSpec(AggKind.MAX, c, f"__f_max_{c}"))
            out.setdefault(f"__f_cnt_{c}",
                           AggSpec(AggKind.COUNT, c, f"__f_cnt_{c}"))
    return tuple(out.values())


def partial_column(a: AggSpec) -> str:
    """The factor partial a member aggregate's visible channel reads in
    merge-input mode."""
    if a.column is None:
        return ROWS_COLUMN  # COUNT(*): the pane's row mass
    if a.kind in (AggKind.SUM, AggKind.AVG):
        return f"__f_sum_{a.column}"
    if a.kind == AggKind.MIN:
        return f"__f_min_{a.column}"
    if a.kind == AggKind.MAX:
        return f"__f_max_{a.column}"
    return f"__f_cnt_{a.column}"  # COUNT(c)


def derived_channel_cols(aggs: Tuple[AggSpec, ...]) -> Dict[int, str]:
    """Channel index -> factor partial column for a derived ring whose
    channels are ``build_channels(aggs)`` (the member's own layout, so
    checkpoints interchange with unfactored plans); a hidden validity
    channel reads its column's non-null-count partial."""
    from ..ops.keyed_bins import build_channels

    _, valid_ch = build_channels(aggs)
    cols: Dict[int, str] = {i: partial_column(a) for i, a in enumerate(aggs)}
    for src, j in valid_ch.items():
        cols[j] = f"__f_cnt_{aggs[src].column}"
    return cols


def _union_projection(program: Program,
                      cands: List[_Candidate]) -> LogicalOperator:
    """ONE projection running every member's private ``agg_input``
    function over the shared anchor batch, each member's ``__ain*``
    outputs renamed to their shared names.  Grouping requires equal
    ``aggin`` key tokens, so the members' key columns are equal and the
    first writer wins.  The union keeps the members' column footprint
    (``used_cols``) and, when they are planner-compiled, their contract
    (``sql_expr``): the ingest spine evaluates it on the host as it would
    have evaluated each member."""
    plans: List[Tuple[Callable, Dict[str, str]]] = []
    kinds: List[OpKind] = []
    used: Optional[set] = set()
    sql_exprs = True
    for c in cands:
        proj = program.node(c.tail[0]).operator
        plans.append((proj.expr.fn, dict(c.rename)))
        kinds.append(proj.kind)
        sql_exprs = sql_exprs and bool(getattr(proj.expr.fn, "sql_expr",
                                               False))
        u = getattr(proj.expr.fn, "used_cols", None)
        if used is not None and u is not None:
            used |= set(u)
        else:
            used = None

    def union_fn(cols, _plans=tuple(plans)):
        out: Dict[str, Any] = {}
        for fn, ren in _plans:
            o = dict(fn(cols))
            o.pop("__timestamp", None)  # aggin projections never set it
            for k, v in o.items():
                out.setdefault(ren.get(k, k), v)
        return out

    if used is not None:
        union_fn.used_cols = frozenset(used)
    if sql_exprs:
        union_fn.sql_expr = True
    sqls = sorted(program.node(c.tail[0]).operator.expr.sql for c in cands)
    expr = ColumnExpr("factor_input", union_fn, ExprReturnType.RECORD,
                      sql="aggin-union:" + repr(sqls))
    kind = OpKind.UDF if OpKind.UDF in kinds else OpKind.EXPRESSION
    return LogicalOperator(kind, "factor_input", expr=expr)


def apply_factor_windows(program: Program) -> List[FactorDecision]:
    """Run the cost model and rewrite every shared group in place: ONE
    new WINDOW_FACTOR node a group (fed through the group's shared,
    possibly synthesized, projection and keying) and each member swapped
    (same operator id, same out-edges) for a DERIVED_WINDOW reading the
    factor's panes over a FORWARD edge (1:1 subtask pairing keeps the
    co-partitioning).  Idempotent: a rewritten plan has no eligible
    group left.  Records the decisions on ``program.factor_decisions``."""
    planned = _plan(program)
    decisions = [d for d, _ in planned]
    g = program.graph
    for d, cands in planned:
        if not d.shared:
            continue
        members = [program.node(c.member) for c in cands]
        par = members[0].parallelism
        mp = members[0].max_parallelism
        key_schema = cands[0].key_schema

        # the shared input chain up to the factor's SHUFFLE edge
        tail_len = len(cands[0].tail)
        if tail_len == 0:
            feed = d.upstream  # the members already shared this node
        elif tail_len == 1:
            # private key_bys off a common anchor: ONE key_by suffices
            kb_old = program.node(cands[0].tail[0]).operator
            kb = program.add_node(
                LogicalOperator(OpKind.KEY_BY, kb_old.name,
                                key_cols=kb_old.key_cols), par)
            program.node(kb).max_parallelism = mp
            program.add_edge(d.upstream, kb, EdgeType.FORWARD)
            feed = kb
        else:
            # private [agg_input -> key_by] tails: a union projection and
            # one key_by replace them
            proj_op = _union_projection(program, cands)
            anchor_edge = program.edge(d.upstream, cands[0].tail[0])
            proj = program.add_node(proj_op, par)
            program.node(proj).max_parallelism = mp
            program.add_edge(d.upstream, proj, EdgeType.FORWARD,
                             key_schema=anchor_edge.key_schema)
            kb_old = program.node(cands[0].tail[1]).operator
            kb = program.add_node(
                LogicalOperator(OpKind.KEY_BY, kb_old.name,
                                key_cols=kb_old.key_cols), par)
            program.node(kb).max_parallelism = mp
            program.add_edge(proj, kb, EdgeType.FORWARD)
            feed = kb

        f_aggs = factor_aggs_for(
            [tuple(AggSpec(a.kind, c.rename.get(a.column, a.column)
                           if a.column is not None else None, a.output)
                   for a in program.node(c.member).operator.spec.aggs)
             for c in cands])
        f_op = LogicalOperator(
            OpKind.WINDOW_FACTOR, f"factor_panes_{d.pane_micros}us",
            spec=FactorPaneSpec(d.pane_micros, f_aggs))
        fid = program.add_node(f_op, par)
        program.node(fid).max_parallelism = mp
        program.add_edge(feed, fid, EdgeType.SHUFFLE, key_schema=key_schema)
        d.factor_node = fid

        for c in cands:
            m = program.node(c.member)
            spec = m.operator.spec
            width, slide = _member_params(spec)
            aggs = tuple(
                AggSpec(a.kind,
                        c.rename.get(a.column, a.column)
                        if a.column is not None else None,
                        a.output)
                for a in spec.aggs)
            m.operator = LogicalOperator(
                OpKind.DERIVED_WINDOW, m.operator.name,
                spec=DerivedWindowSpec(width, slide, d.pane_micros,
                                       aggs, spec.projection))
            # drop the member's private tail (and with it its upstream
            # edge), then feed it the factor's panes 1:1
            for t in c.tail:
                g.remove_node(t)
            if g.has_edge(d.upstream, c.member):
                g.remove_edge(d.upstream, c.member)
            program.add_edge(fid, c.member, EdgeType.FORWARD,
                             key_schema=key_schema)
    # an idempotent re-application (the Engine after the planner) finds
    # refused groups again but not rewritten ones: keep the earlier shared
    # records whose factor nodes are still in the graph
    kept = [d for d in getattr(program, "factor_decisions", []) or []
            if d.shared and d.factor_node is not None
            and g.has_node(d.factor_node)]
    decisions = kept + decisions
    program.factor_decisions = decisions
    return decisions

