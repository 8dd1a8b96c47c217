"""Operator chaining (port of ``arroyo_tpu.graph.chaining``): the pass
that finds the maximal linear runs of operators the engine executes
inside one task, as one :class:`~arroyo_tpu_torch.engine.chained.
ChainedOperator`, over the logical graph, which it never mutates.

* every edge inside a chain is FORWARD with equal parallelism on both
  ends, or a SHUFFLE between two parallelism-1 operators (every row goes
  to the one downstream subtask in order, as over a FORWARD edge;
  ``ARROYO_CHAIN_SHUFFLE1=0`` breaks chains there), which lets the
  ingest spine source -> project -> key_by -> window fuse into one task;
* interior connectivity is linear: no fan-out above, no fan-in below;
* sources and sinks never chain.

Chain identity is per member: each member keeps its operator id, state
tables and checkpoint metadata, so a checkpoint taken chained restores
unchained and the reverse.  ``ARROYO_CHAIN=0`` gives an empty plan and
the one-task-per-operator topology."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .logical import EdgeType, OpKind, Program, StreamEdge

_UNCHAINABLE = (OpKind.CONNECTOR_SOURCE, OpKind.CONNECTOR_SINK)
_OFF = ("0", "off", "false")


def chaining_enabled() -> bool:
    """``ARROYO_CHAIN=0`` turns chaining off (read per call)."""
    return os.environ.get("ARROYO_CHAIN", "1") not in _OFF


def shuffle1_chaining_enabled() -> bool:
    """``ARROYO_CHAIN_SHUFFLE1=0`` stops chains at parallelism-1 shuffle
    edges."""
    return os.environ.get("ARROYO_CHAIN_SHUFFLE1", "1") not in _OFF


@dataclass
class ChainPlan:
    """``groups`` holds the multi-member chains (head first, heads in
    topological order); ``head_of`` maps each of their members to its
    head and ``members_of`` each head to its members.
    ``shuffle_edges`` lists the chain-interior parallelism-1 SHUFFLE
    edges."""

    groups: List[List[str]] = field(default_factory=list)
    head_of: Dict[str, str] = field(default_factory=dict)
    members_of: Dict[str, List[str]] = field(default_factory=dict)
    shuffle_edges: List[Tuple[str, str]] = field(default_factory=list)

    def group_for(self, op_id: str) -> Optional[List[str]]:
        head = self.head_of.get(op_id)
        return self.members_of.get(head) if head is not None else None


def _edge(program: Program, u: str, v: str) -> Optional[StreamEdge]:
    for _, dst, edge in program.graph.out_edges(u):
        if dst == v:
            return edge
    return None


def _chainable_node(program: Program, op_id: str) -> bool:
    return program.node(op_id).operator.kind not in _UNCHAINABLE


def _chainable_edge(program: Program, u: str, v: str) -> bool:
    g = program.graph
    typ = _edge(program, u, v).typ
    if typ is not EdgeType.FORWARD:
        # join-side shuffles never qualify (their side tag carries
        # meaning, and their fan-in blocks them below anyway)
        if not (typ is EdgeType.SHUFFLE and shuffle1_chaining_enabled()
                and program.node(u).parallelism == 1
                and program.node(v).parallelism == 1):
            return False
    if not (_chainable_node(program, u) and _chainable_node(program, v)):
        return False
    if program.node(u).parallelism != program.node(v).parallelism:
        return False
    return len(g.out_edges(u)) == 1 and len(g.in_edges(v)) == 1


def plan_chains(program: Program) -> ChainPlan:
    """The maximal linear chains of ``program``; an empty plan when
    chaining is off."""
    plan = ChainPlan()
    if not chaining_enabled():
        return plan
    nxt: Dict[str, str] = {}
    prev: Dict[str, str] = {}
    for u in program.graph.node_ids():
        for _, v, _edge_data in program.graph.out_edges(u):
            if _chainable_edge(program, u, v):
                nxt[u] = v
                prev[v] = u
    for op_id in program.topo_order():
        if op_id in prev or op_id not in nxt:
            continue  # an interior member, or unchained
        run = [op_id]
        while run[-1] in nxt:
            run.append(nxt[run[-1]])
        plan.groups.append(run)
        plan.members_of[op_id] = run
        for m in run:
            plan.head_of[m] = op_id
        for u, v in zip(run, run[1:]):
            if _edge(program, u, v).typ is not EdgeType.FORWARD:
                plan.shuffle_edges.append((u, v))
    return plan


def validate_chain_plan(program: Program, plan: ChainPlan) -> None:
    """Re-check every chain against the graph; ``ValueError`` on any
    violation, before the engine builds a task from it."""
    problems: List[str] = []
    for grp in plan.groups:
        if len(grp) < 2:
            problems.append(f"degenerate chain {grp}")
            continue
        for m in grp:
            if not _chainable_node(program, m):
                problems.append(f"{m}: sources/sinks cannot chain")
        for u, v in zip(grp, grp[1:]):
            if _edge(program, u, v) is None:
                problems.append(f"chain edge {u}->{v} missing from graph")
            elif not _chainable_edge(program, u, v):
                problems.append(
                    f"chain edge {u}->{v} is not chainable (shuffle, "
                    "parallelism change, or fan-in/fan-out)")
    if problems:
        raise ValueError("invalid chain plan: " + "; ".join(problems))
