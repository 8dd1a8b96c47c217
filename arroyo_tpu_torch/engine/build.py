"""Logical operator -> physical operator construction (port of
``arroyo_tpu.engine.build``).  Builders take the resolved device so
device-state operators place their tensors there."""

from __future__ import annotations

from typing import Callable, Dict

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
_BUILDERS: Dict[OpKind, Builder] = {}


def register_builder(kind: OpKind):
    def deco(fn: Builder) -> Builder:
        _BUILDERS[kind] = fn
        return fn
    return deco


def build_operator(op: LogicalOperator, device: DeviceLike) -> Operator:
    from . import operators_window  # noqa: F401  (registers its builders)

    builder = _BUILDERS.get(op.kind)
    if builder is None:
        raise NotImplementedError(f"no physical operator for {op.kind}")
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
