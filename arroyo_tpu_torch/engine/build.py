"""Logical operator -> physical operator construction (port of
``arroyo_tpu.engine.build``).  Builders take the resolved device so
device-state operators place their tensors there; the bin aggregates'
builders (``register_builder(kind, mesh=True)``) also take the runner's
key mesh, the devices their state may shard over."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Set

import torch

from ..connectors.registry import make_sink, make_source
from ..device import DeviceLike, resolve_device
from ..graph.logical import LogicalOperator, OpKind
from .operator import Operator
from .operators_basic import (
    AggregateOperator,
    CountOperator,
    ExpressionOperator,
    FlatMapOperator,
    FlattenOperator,
    GlobalKeyOperator,
    KeyByOperator,
    UdfOperator,
    UnionOperator,
    WatermarkOperator,
)

Builder = Callable[[LogicalOperator, DeviceLike], Operator]


def validate_before_build(program) -> None:
    """The plan-time gate run before any operator is built: graph-level
    invariants (keyed state behind shuffles, windows behind a watermark,
    join sides and key arities, the factor-window shape, no dangling
    node) rejected with diagnostics (analysis/plan_validator.py) instead
    of wrong rows or a hung pipeline."""
    from ..analysis.plan_validator import check_program

    check_program(program)  # raises PlanValidationError on an error


_BUILDERS: Dict[OpKind, Builder] = {}
# kinds whose builder also takes the key mesh (``mesh=`` keyword)
_MESH_KINDS: Set[OpKind] = set()


def register_builder(kind: OpKind, mesh: bool = False):
    def deco(fn: Builder) -> Builder:
        _BUILDERS[kind] = fn
        if mesh:
            _MESH_KINDS.add(kind)
        return fn
    return deco


def build_operator(op: LogicalOperator, device: DeviceLike,
                   mesh: Optional[Sequence[torch.device]] = None
                   ) -> Operator:
    """The physical operator of ``op`` on ``device``; a bin aggregate's
    state may shard over ``mesh`` (None: the device's visible devices)."""
    from . import operators_window  # noqa: F401  (registers its builders)

    builder = _BUILDERS.get(op.kind)
    if builder is None:
        raise NotImplementedError(f"no physical operator for {op.kind}")
    if op.kind in _MESH_KINDS:
        return builder(op, device, mesh=mesh)
    return builder(op, device)


_BUILDERS[OpKind.CONNECTOR_SOURCE] = lambda op, dev: make_source(
    op.spec.connector, op.spec.config)
_BUILDERS[OpKind.CONNECTOR_SINK] = lambda op, dev: make_sink(
    op.spec.connector, op.spec.config)
_BUILDERS[OpKind.EXPRESSION] = lambda op, dev: ExpressionOperator(
    op.name, op.expr, resolve_device(dev))
_BUILDERS[OpKind.UDF] = lambda op, dev: UdfOperator(op.name, op.expr)
_BUILDERS[OpKind.FLAT_MAP] = lambda op, dev: FlatMapOperator(op.name,
                                                             op.expr)
_BUILDERS[OpKind.FLATTEN] = lambda op, dev: FlattenOperator(op.name)
_BUILDERS[OpKind.UNION] = lambda op, dev: UnionOperator(op.name)
_BUILDERS[OpKind.WATERMARK] = lambda op, dev: WatermarkOperator(op.name,
                                                                op.spec)
_BUILDERS[OpKind.KEY_BY] = lambda op, dev: KeyByOperator(op.name,
                                                         op.key_cols)
_BUILDERS[OpKind.GLOBAL_KEY] = lambda op, dev: GlobalKeyOperator(op.name)
_BUILDERS[OpKind.COUNT] = lambda op, dev: CountOperator(op.name)
_BUILDERS[OpKind.AGGREGATE] = lambda op, dev: AggregateOperator(op.name,
                                                                op.spec)
# updating-stream variants: the expression and the keying with the __op
# column flowing through
_BUILDERS[OpKind.UPDATING] = lambda op, dev: ExpressionOperator(
    op.name, op.expr, resolve_device(dev))
_BUILDERS[OpKind.UPDATING_KEY] = lambda op, dev: KeyByOperator(op.name,
                                                               op.key_cols)
