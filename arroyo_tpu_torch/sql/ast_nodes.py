"""SQL AST — the analog of the expression/statement trees the reference gets
from sqlparser + DataFusion (arroyo-sql/src/expressions.rs operator taxonomy)."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, List, Optional, Tuple


# -- expressions -------------------------------------------------------------


@dataclass
class Expr:
    pass


@dataclass
class Literal(Expr):
    value: Any  # int | float | str | bool | None
    type: str = ""  # 'int'|'float'|'string'|'bool'|'null'


@dataclass
class IntervalLit(Expr):
    micros: int


@dataclass
class ColumnRef(Expr):
    name: str
    qualifier: Optional[str] = None  # table alias or struct column

    @property
    def display(self) -> str:
        return f"{self.qualifier}.{self.name}" if self.qualifier else self.name


@dataclass
class Star(Expr):
    qualifier: Optional[str] = None


@dataclass
class BinaryOp(Expr):
    op: str  # + - * / % = <> < <= > >= and or || like
    left: Expr
    right: Expr


@dataclass
class UnaryOp(Expr):
    op: str  # - not
    operand: Expr


@dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    operand: Expr
    items: List[Expr]
    negated: bool = False


@dataclass
class InSubquery(Expr):
    """``x IN (SELECT c FROM ...)`` — planned as a streaming semi-join."""

    operand: Expr
    query: "Select"
    negated: bool = False


@dataclass
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class Case(Expr):
    operand: Optional[Expr]
    whens: List[Tuple[Expr, Expr]]
    else_: Optional[Expr]


@dataclass
class Cast(Expr):
    operand: Expr
    target_type: str  # normalized lowercase type name


@dataclass
class OverClause:
    """OVER (PARTITION BY ... ORDER BY ...) for SQL window functions
    (ROW_NUMBER — the streaming planner rewrites it into TopN)."""

    partition_by: List[Expr]
    order_by: List["OrderItem"]


@dataclass
class FunctionCall(Expr):
    name: str  # lowercase
    args: List[Expr]
    distinct: bool = False
    over: Optional[OverClause] = None

    @property
    def is_window_fn(self) -> bool:
        return self.name in ("hop", "tumble", "session")


AGG_FUNCTIONS = {"count", "sum", "min", "max", "avg"}


# -- statements --------------------------------------------------------------


def map_children(e: "Expr", fn) -> "Expr":
    """Rebuild ``e`` with ``fn`` applied to each direct child expression —
    THE single structural traversal every expression rewriter must use,
    so node-type coverage is a one-place fix (three hand-rolled switch
    ladders had already drifted on Case/InList/Between)."""
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, fn(e.left), fn(e.right))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, fn(e.operand))
    if isinstance(e, IsNull):
        return IsNull(fn(e.operand), e.negated)
    if isinstance(e, InList):
        return InList(fn(e.operand), [fn(x) for x in e.items], e.negated)
    if isinstance(e, Between):
        return Between(fn(e.operand), fn(e.low), fn(e.high), e.negated)
    if isinstance(e, Case):
        return Case(fn(e.operand) if e.operand is not None else None,
                    [(fn(c), fn(v)) for c, v in e.whens],
                    fn(e.else_) if e.else_ is not None else None)
    if isinstance(e, Cast):
        return Cast(fn(e.operand), e.target_type)
    if isinstance(e, InSubquery):
        # the subquery plans separately; only the operand is a child expr
        return InSubquery(fn(e.operand), e.query, e.negated)
    if isinstance(e, FunctionCall):
        return FunctionCall(e.name, [fn(a) for a in e.args], e.distinct,
                            e.over)
    return e


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


class JoinKind(Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"


@dataclass
class TableRef:
    pass


@dataclass
class NamedTable(TableRef):
    name: str
    alias: Optional[str] = None


@dataclass
class DerivedTable(TableRef):
    query: "Select"
    alias: Optional[str] = None


@dataclass
class Join(TableRef):
    left: TableRef
    right: TableRef
    kind: JoinKind
    on: Optional[Expr]


@dataclass
class OrderItem:
    expr: Expr
    desc: bool = False


@dataclass
class Select:
    items: List[SelectItem]
    from_: Optional[TableRef] = None
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    distinct: bool = False
    ctes: List[Tuple[str, "Select"]] = field(default_factory=list)
    # UNION ALL chain (the reference bails on unions, pipeline.rs:393 —
    # supporting them is deliberate over-parity)
    union_all: Optional["Select"] = None


@dataclass
class Explain:
    """EXPLAIN <select> — emits the planned operator DAG as rows (the
    reference bails on EXPLAIN, pipeline.rs:432)."""

    query: "Select"


@dataclass
class ColumnDef:
    name: str
    type: str
    not_null: bool = False
    generated_as: Optional[Expr] = None


@dataclass
class CreateTable:
    name: str
    columns: List[ColumnDef]
    with_options: dict = field(default_factory=dict)


@dataclass
class Insert:
    table: str
    query: Select


Statement = Any  # CreateTable | Insert | Select
