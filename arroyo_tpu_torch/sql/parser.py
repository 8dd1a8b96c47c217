"""Recursive-descent SQL parser for the dialect subset the reference engine
plans (arroyo-sql: Postgres dialect via sqlparser + the planner's supported
shapes — SELECT/CTE/JOIN/GROUP BY with hop/tumble/session, CREATE TABLE with
connector options and generated columns, INSERT INTO)."""

from __future__ import annotations

from typing import List, Optional, Tuple

from .ast_nodes import (
    Explain,
    Between,
    BinaryOp,
    Case,
    Cast,
    ColumnDef,
    ColumnRef,
    CreateTable,
    DerivedTable,
    Expr,
    FunctionCall,
    InList,
    InSubquery,
    Insert,
    IntervalLit,
    IsNull,
    Join,
    JoinKind,
    Literal,
    NamedTable,
    OrderItem,
    OverClause,
    Select,
    SelectItem,
    Star,
    TableRef,
    UnaryOp,
)
from .lexer import Token, tokenize

MICROS = {
    "microsecond": 1, "microseconds": 1,
    "millisecond": 1_000, "milliseconds": 1_000,
    "second": 1_000_000, "seconds": 1_000_000,
    "minute": 60_000_000, "minutes": 60_000_000,
    "hour": 3_600_000_000, "hours": 3_600_000_000,
    "day": 86_400_000_000, "days": 86_400_000_000,
}


def duration_text_micros(text: str) -> int:
    """'3 second' / '1 day 2 hours' / '30 seconds' -> micros.  The single
    shared duration parser: INTERVAL literals and the reference-style bare
    duration strings (session('30 seconds')) both route here."""
    parts = text.strip().split()
    if len(parts) < 2 or len(parts) % 2:
        raise SqlParseError(f"cannot parse duration {text!r}")
    micros = 0
    for i in range(0, len(parts), 2):
        unit = parts[i + 1].lower()
        if unit not in MICROS:
            raise SqlParseError(f"unknown interval unit {parts[i + 1]!r}")
        try:
            qty = float(parts[i])
        except ValueError:
            raise SqlParseError(f"cannot parse duration {text!r}")
        micros += int(qty * MICROS[unit])
    return micros


class SqlParseError(ValueError):
    pass


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0

    # -- plumbing ----------------------------------------------------------

    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.i + offset, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise SqlParseError(f"expected {kw.upper()} at {self.peek()!r}")

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise SqlParseError(f"expected {op!r} at {self.peek()!r}")

    def expect_ident(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            return self.next().value
        # many keywords are valid identifiers in practice (e.g. "window")
        if t.kind == "kw" and t.value not in ("select", "from", "where"):
            return self.next().value
        raise SqlParseError(f"expected identifier at {t!r}")

    # -- entry -------------------------------------------------------------

    def parse_statements(self) -> List:
        stmts = []
        while self.peek().kind != "eof":
            if self.eat_op(";"):
                continue
            stmts.append(self.parse_statement())
        return stmts

    def parse_statement(self):
        if self.at_kw("explain"):
            self.next()
            return Explain(self.parse_select())
        if self.at_kw("create"):
            return self.parse_create_table()
        if self.at_kw("insert"):
            return self.parse_insert()
        if self.at_kw("select", "with"):
            return self.parse_select()
        raise SqlParseError(f"unexpected token {self.peek()!r}")

    # -- CREATE TABLE ------------------------------------------------------

    def parse_create_table(self) -> CreateTable:
        self.expect_kw("create")
        self.expect_kw("table")
        self.eat_kw("if")  # IF NOT EXISTS
        self.eat_kw("not")
        self.eat_kw("exists")
        name = self.expect_ident()
        cols: List[ColumnDef] = []
        if self.eat_op("("):
            while not self.at_op(")"):
                cols.append(self.parse_column_def())
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        options = {}
        if self.eat_kw("with"):
            self.expect_op("(")
            while not self.at_op(")"):
                key = self.expect_ident()
                self.expect_op("=")
                t = self.next()
                options[key.lower()] = t.value
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        return CreateTable(name, cols, options)

    def parse_column_def(self) -> ColumnDef:
        name = self.expect_ident()
        type_ = self.parse_type_name()
        not_null = False
        generated = None
        while True:
            if self.eat_kw("not"):
                self.expect_kw("null")
                not_null = True
            elif self.eat_kw("generated"):
                self.expect_kw("always")
                if self.peek().kind == "ident" and self.peek().value.lower() == "as":
                    self.next()
                else:
                    self.expect_kw("as")
                self.expect_op("(")
                generated = self.parse_expr()
                self.expect_op(")")
                self.eat_kw("virtual", "stored")
            elif self.eat_kw("primary"):
                self.expect_kw("key")
            else:
                break
        return ColumnDef(name, type_, not_null, generated)

    def parse_type_name(self) -> str:
        t = self.next()
        name = t.value.lower()
        if name in ("double", "character"):  # DOUBLE PRECISION, CHARACTER VARYING
            nxt = self.peek()
            if nxt.kind == "ident" and nxt.value.lower() in ("precision", "varying"):
                self.next()
        if self.eat_op("("):
            while not self.eat_op(")"):
                self.next()
        return name

    # -- INSERT ------------------------------------------------------------

    def parse_insert(self) -> Insert:
        self.expect_kw("insert")
        self.expect_kw("into")
        name = self.expect_ident()
        if self.eat_op("("):  # column list ignored: projection must match
            while not self.eat_op(")"):
                self.next()
        return Insert(name, self.parse_select())

    # -- SELECT ------------------------------------------------------------

    def parse_select(self) -> Select:
        ctes: List[Tuple[str, Select]] = []
        if self.eat_kw("with"):
            while True:
                cname = self.expect_ident()
                self.expect_kw("as")
                self.expect_op("(")
                ctes.append((cname, self.parse_select()))
                self.expect_op(")")
                if not self.eat_op(","):
                    break
        sel = self.parse_select_body()
        sel.ctes = ctes + sel.ctes
        cur = sel
        while self.eat_kw("union"):
            if not self.eat_kw("all"):
                raise SqlParseError(
                    "UNION (distinct) over streams is unbounded-state; "
                    "use UNION ALL")
            cur.union_all = self.parse_select_body()
            cur = cur.union_all
        return sel

    def parse_select_body(self) -> Select:
        self.expect_kw("select")
        distinct = self.eat_kw("distinct")
        self.eat_kw("all")
        items = [self.parse_select_item()]
        while self.eat_op(","):
            items.append(self.parse_select_item())

        from_ = None
        if self.eat_kw("from"):
            from_ = self.parse_table_ref()
        where = self.parse_expr() if self.eat_kw("where") else None
        group_by: List[Expr] = []
        if self.eat_kw("group"):
            self.expect_kw("by")
            group_by.append(self.parse_expr())
            while self.eat_op(","):
                group_by.append(self.parse_expr())
        having = self.parse_expr() if self.eat_kw("having") else None
        order_by: List[OrderItem] = []
        if self.eat_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                desc = False
                if self.eat_kw("desc"):
                    desc = True
                else:
                    self.eat_kw("asc")
                order_by.append(OrderItem(e, desc))
                if not self.eat_op(","):
                    break
        limit = None
        if self.eat_kw("limit"):
            t = self.next()
            limit = int(t.value)
        return Select(items, from_, where, group_by, having, order_by, limit,
                      distinct)

    def parse_select_item(self) -> SelectItem:
        if self.at_op("*"):
            self.next()
            return SelectItem(Star())
        # qualified star: ident.*
        if (self.peek().kind == "ident" and self.peek(1).kind == "op"
                and self.peek(1).value == "." and self.peek(2).value == "*"):
            q = self.next().value
            self.next()
            self.next()
            return SelectItem(Star(qualifier=q))
        expr = self.parse_expr()
        alias = None
        if self.eat_kw("as"):
            alias = self.expect_ident()
        elif self.peek().kind == "ident":
            alias = self.next().value
        return SelectItem(expr, alias)

    # -- FROM / JOIN -------------------------------------------------------

    def parse_table_ref(self) -> TableRef:
        left = self.parse_table_factor()
        while True:
            kind = None
            if self.eat_kw("join") or self.eat_kw("inner"):
                if self.peek(-1).value == "inner":
                    self.expect_kw("join")
                kind = JoinKind.INNER
            elif self.at_kw("left", "right", "full"):
                kw = self.next().value
                self.eat_kw("outer")
                self.expect_kw("join")
                kind = JoinKind[kw.upper()]
            elif self.eat_kw("cross"):
                self.expect_kw("join")
                right = self.parse_table_factor()
                left = Join(left, right, JoinKind.INNER, None)
                continue
            else:
                break
            right = self.parse_table_factor()
            on = None
            if self.eat_kw("on"):
                on = self.parse_expr()
            left = Join(left, right, kind, on)
        return left

    def parse_table_factor(self) -> TableRef:
        if self.eat_op("("):
            if self.at_kw("select", "with"):
                q = self.parse_select()
                self.expect_op(")")
                alias = self._maybe_alias()
                return DerivedTable(q, alias)
            inner = self.parse_table_ref()
            self.expect_op(")")
            return inner
        name = self.expect_ident()
        alias = self._maybe_alias()
        return NamedTable(name, alias)

    def _maybe_alias(self) -> Optional[str]:
        if self.eat_kw("as"):
            return self.expect_ident()
        if self.peek().kind == "ident":
            return self.next().value
        return None

    # -- expressions (precedence climbing) ---------------------------------

    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.eat_kw("or"):
            left = BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.eat_kw("and"):
            left = BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> Expr:
        if self.eat_kw("not"):
            return UnaryOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        left = self.parse_additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                if op == "!=":
                    op = "<>"
                left = BinaryOp(op, left, self.parse_additive())
            elif self.at_kw("is"):
                self.next()
                negated = self.eat_kw("not")
                self.expect_kw("null")
                left = IsNull(left, negated)
            elif self.at_kw("in"):
                self.next()
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.parse_select()
                    self.expect_op(")")
                    left = InSubquery(left, q)
                    continue
                items = [self.parse_expr()]
                while self.eat_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                left = InList(left, items)
            elif self.at_kw("between"):
                self.next()
                low = self.parse_additive()
                self.expect_kw("and")
                high = self.parse_additive()
                left = Between(left, low, high)
            elif self.at_kw("like"):
                self.next()
                left = BinaryOp("like", left, self.parse_additive())
            elif self.at_kw("not") and self.peek(1).value in ("in", "like", "between"):
                self.next()
                if self.eat_kw("in"):
                    self.expect_op("(")
                    if self.at_kw("select", "with"):
                        q = self.parse_select()
                        self.expect_op(")")
                        left = InSubquery(left, q, negated=True)
                        continue
                    items = [self.parse_expr()]
                    while self.eat_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    left = InList(left, items, negated=True)
                elif self.eat_kw("like"):
                    left = UnaryOp("not", BinaryOp("like", left, self.parse_additive()))
                else:
                    self.expect_kw("between")
                    low = self.parse_additive()
                    self.expect_kw("and")
                    high = self.parse_additive()
                    left = Between(left, low, high, negated=True)
            else:
                return left

    def parse_additive(self) -> Expr:
        left = self.parse_multiplicative()
        while self.at_op("+", "-", "||"):
            op = self.next().value
            left = BinaryOp(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self) -> Expr:
        left = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = BinaryOp(op, left, self.parse_unary())
        return left

    def parse_unary(self) -> Expr:
        if self.eat_op("-"):
            return UnaryOp("-", self.parse_unary())
        if self.eat_op("+"):
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> Expr:
        e = self.parse_primary()
        while True:
            if self.at_op("."):
                # struct / qualifier access: a.b(.c)
                self.next()
                field = self.expect_ident()
                if isinstance(e, ColumnRef) and e.qualifier is None:
                    e = ColumnRef(field, qualifier=e.name)
                elif isinstance(e, ColumnRef):
                    # a.b.c: treat a.b as qualifier chain
                    e = ColumnRef(field, qualifier=f"{e.qualifier}.{e.name}")
                else:
                    raise SqlParseError("field access on non-column")
            elif self.at_op("::"):
                self.next()
                e = Cast(e, self.parse_type_name())
            else:
                return e

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            if any(c in t.value for c in ".eE"):
                return Literal(float(t.value), "float")
            return Literal(int(t.value), "int")
        if t.kind == "string":
            self.next()
            return Literal(t.value, "string")
        if self.eat_kw("null"):
            return Literal(None, "null")
        if self.eat_kw("true"):
            return Literal(True, "bool")
        if self.eat_kw("false"):
            return Literal(False, "bool")
        if self.eat_kw("interval"):
            return self.parse_interval()
        if self.eat_kw("case"):
            return self.parse_case()
        if self.eat_kw("cast"):
            self.expect_op("(")
            inner = self.parse_expr()
            self.expect_kw("as")
            typ = self.parse_type_name()
            self.expect_op(")")
            return Cast(inner, typ)
        if self.eat_op("("):
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if self.at_op("*"):
            self.next()
            return Star()
        if t.kind in ("ident", "kw"):
            name = self.expect_ident()
            if self.at_op("("):
                return self.parse_function(name)
            return ColumnRef(name)
        raise SqlParseError(f"unexpected token {t!r} in expression")

    def parse_interval(self) -> IntervalLit:
        t = self.next()
        if t.kind != "string":
            raise SqlParseError(f"expected interval string at {t!r}")
        text = t.value.strip()
        # forms: '2' SECOND | '3 second' | '1 day 2 hours'
        parts = text.split()
        if len(parts) == 1:
            unit_tok = self.peek()
            if unit_tok.kind not in ("ident", "kw"):
                raise SqlParseError("interval missing unit")
            unit = self.next().value.lower()
            return IntervalLit(duration_text_micros(f"{parts[0]} {unit}"))
        return IntervalLit(duration_text_micros(text))

    def parse_case(self) -> Case:
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        whens = []
        while self.eat_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            val = self.parse_expr()
            whens.append((cond, val))
        else_ = None
        if self.eat_kw("else"):
            else_ = self.parse_expr()
        self.expect_kw("end")
        return Case(operand, whens, else_)

    def parse_function(self, name: str) -> FunctionCall:
        self.expect_op("(")
        if name.lower() == "extract" and self.peek().kind != "string":
            # standard SQL EXTRACT(field FROM expr): the field is a bare
            # keyword, normalized to the two-arg call form
            # extract('field', expr) the compiler already handles (a
            # leading string literal means the two-arg form — fall
            # through to generic arg parsing)
            field = self.expect_ident()
            self.expect_kw("from")
            operand = self.parse_expr()
            self.expect_op(")")
            return FunctionCall("extract",
                                [Literal(field.lower(), "string"),
                                 operand], False, None)
        distinct = self.eat_kw("distinct")
        args: List[Expr] = []
        if not self.at_op(")"):
            args.append(self.parse_expr())
            while self.eat_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        over = None
        if self.eat_kw("over"):
            self.expect_op("(")
            partition: List[Expr] = []
            if self.eat_kw("partition"):
                self.expect_kw("by")
                partition.append(self.parse_expr())
                while self.eat_op(","):
                    partition.append(self.parse_expr())
            order: List[OrderItem] = []
            if self.eat_kw("order"):
                self.expect_kw("by")
                while True:
                    e = self.parse_expr()
                    desc = False
                    if self.eat_kw("desc"):
                        desc = True
                    else:
                        self.eat_kw("asc")
                    order.append(OrderItem(e, desc))
                    if not self.eat_op(","):
                        break
            self.expect_op(")")
            over = OverClause(partition, order)
        return FunctionCall(name.lower(), args, distinct, over)


def parse_sql(sql: str) -> List:
    return Parser(sql).parse_statements()
