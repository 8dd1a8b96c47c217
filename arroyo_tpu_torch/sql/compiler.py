"""SQL expression -> columnar closure compiler (the port of
``arroyo_tpu.sql.compiler``).

The analog of the reference's expression compiler (arroyo-sql/src/
expressions.rs + code_gen.rs, 4.3k LoC of Rust-source emission): instead of
emitting Rust strings for rustc, each AST node compiles to a Python closure
over the column environment.  The JAX package's closures call ``jnp`` and
run jitted; these call torch where those call ``jnp`` and run eagerly,
on the expression device's tensors or on host numpy columns, with JAX's
x64 dtype rules (ops/colmath.py): integer division truncates and is NULL
on a zero divisor, float ``%`` is ``fmod``, and a float literal with an
integer column gives float64.

Values flow as ``(array, mask)`` pairs — mask is the SQL validity (None =
all valid), which keeps three-valued logic cheap: masks are just bool arrays
AND-ed along the way.  Struct columns (nexmark's person/bid/auction) resolve
to flattened physical columns plus a presence mask from the schema.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..ops import colmath as cm
from .ast_nodes import (
    Between,
    BinaryOp,
    Case,
    Cast,
    ColumnRef,
    Expr,
    FunctionCall,
    InList,
    InSubquery,
    IntervalLit,
    IsNull,
    Literal,
    Star,
    UnaryOp,
)
from .functions import DEVICE_FUNCTIONS, HOST_FUNCTIONS

MV = Tuple[Any, Optional[Any]]


class SqlCompileError(ValueError):
    pass


@dataclass
class StructDef:
    """A struct-typed column flattened into physical columns, with a presence
    test (nexmark Event{person,bid,auction}: presence = event_type == k)."""

    name: str
    fields: Dict[str, str]  # field name -> physical column
    presence_col: Optional[str] = None
    presence_val: Optional[int] = None

    def presence_mask(self, env):
        if self.presence_col is None:
            return None
        return env[self.presence_col] == self.presence_val


@dataclass
class Schema:
    """Logical schema of one dataflow edge for SQL resolution."""

    columns: Dict[str, str] = field(default_factory=dict)  # name -> kind i/f/s/b/t
    structs: Dict[str, StructDef] = field(default_factory=dict)
    aliases: Set[str] = field(default_factory=set)
    window: bool = False  # window_start/window_end present
    window_names: Set[str] = field(default_factory=set)  # aliases of the window
    event_time_col: str = "__timestamp"
    # projection pushdown: source schemas carry a SHARED mutable set that
    # resolve() records physical-column accesses into (clones alias it, so
    # every reference to the table accumulates here); the planner hands the
    # final set to the source connector so it can skip generating/decoding
    # untouched columns — the DataFusion-planner pushdown analog
    source_used: Optional[Set[str]] = None
    # qualified-name overrides from joins: (alias_lower, col_lower) ->
    # physical column, so `r.id` resolves to the collision-renamed `r_id`
    # instead of falling back to the left side's `id`
    qualified: Dict[Tuple[str, str], str] = field(default_factory=dict)
    # structs whose presence a preceding `WHERE s IS NOT NULL` filter
    # guarantees: field loads skip the presence mask (and projections skip
    # NULL materialization — the hot-path case for nexmark struct fields)
    presence_guaranteed: Set[str] = field(default_factory=set)
    # event-time provenance: physical columns whose every NON-NULL value
    # provably equals the stream's __timestamp (declared by the source —
    # event_time_field, or connector-known fields like nexmark's
    # bid.datetime — and propagated through pass-through projections and
    # filters; joins and aggregates drop it, since their output rows get
    # fresh timestamps).  The optimizer's raw-stream argmax fusion uses
    # this to prove a post-join window-range WHERE pins each row to its
    # own event-time window (planner._try_raw_argmax_fusion).
    event_time_cols: Set[str] = field(default_factory=set)

    def clone(self) -> "Schema":
        return Schema(dict(self.columns), dict(self.structs),
                      set(self.aliases), self.window, set(self.window_names),
                      self.event_time_col, self.source_used,
                      dict(self.qualified), set(self.presence_guaranteed),
                      set(self.event_time_cols))

    def is_string(self, col: str) -> bool:
        return self.columns.get(col) == "s"

    def _use(self, col: str, record: bool = True) -> Tuple[str, str]:
        if record and self.source_used is not None:
            self.source_used.add(col)
        return ("col", col)

    def _use_struct(self, sd: "StructDef", presence_only: bool = False,
                    record: bool = True) -> Tuple[str, "StructDef"]:
        if record and self.source_used is not None:
            # a bare struct reference (SELECT bid, struct passthrough)
            # keeps the WHOLE struct live: presence column and every field
            # column (the projection operator passes fields through,
            # planner._plan_projection).  ``presence_only`` is for
            # `struct IS [NOT] NULL`, which reads just the presence column.
            if sd.presence_col is not None:
                self.source_used.add(sd.presence_col)
            if not presence_only:
                for phys in sd.fields.values():
                    self.source_used.add(phys)
        return ("struct", sd)

    def resolve(self, ref: ColumnRef, presence_only: bool = False,
                record: bool = True) -> Tuple[str, Any]:
        """Resolve to ('col', phys) | ('struct', StructDef) | ('window', part).

        ``record=False`` makes this a pure PROBE (planner shape checks)
        that must not mark columns as used for projection pushdown."""
        q, n = ref.qualifier, ref.name
        nl = n.lower()
        if q is None:
            if nl in self.window_names or (nl == "window" and self.window):
                return ("window", None)
            if n in self.columns:
                return self._use(n, record)
            if nl in self.columns:
                return self._use(nl, record)
            if n in self.structs:
                return self._use_struct(self.structs[n], presence_only,
                                        record)
            if nl in self.structs:
                return self._use_struct(self.structs[nl], presence_only,
                                        record)
            # case-insensitive fallback
            for c in self.columns:
                if c.lower() == nl:
                    return self._use(c, record)
            raise SqlCompileError(f"unknown column {ref.display!r} "
                                  f"(have {sorted(self.columns)[:20]})")
        ql = q.lower()
        if ql in self.structs or q in self.structs:
            sd = self.structs.get(q) or self.structs[ql]
            if nl in sd.fields:
                return self._use(sd.fields[nl], record)
            raise SqlCompileError(f"struct {q} has no field {n}")
        if ql in self.window_names:
            if nl in ("start", "end"):
                return self._use(f"window_{nl}", record)
            raise SqlCompileError(f"window has no field {n}")
        if (ql, nl) in self.qualified:
            return self._use(self.qualified[(ql, nl)], record)
        if ql in {a.lower() for a in self.aliases}:
            return self.resolve(ColumnRef(n), presence_only, record)
        # qualifier might be a struct accessed through an alias chain a.b.c
        if "." in ql:
            parts = ql.split(".")
            if parts[-1] in self.structs:
                return self.resolve(ColumnRef(n, parts[-1]),
                                    presence_only, record)
            if parts[0] in {a.lower() for a in self.aliases}:
                return self.resolve(ColumnRef(n, ".".join(parts[1:])),
                                    presence_only, record)
        raise SqlCompileError(f"cannot resolve qualifier {q!r} for column {n!r}")


@dataclass
class Compiled:
    fn: Callable[[Dict[str, Any]], MV]
    needs_host: bool = False
    sql: str = ""
    # physical columns the expression reads (from the compile-time AST):
    # lets the executor skip coercing/padding untouched columns
    used_cols: Optional[frozenset] = None


from ..formats import nan_validity  # noqa: F401  (re-export: SQL layers
# import the shared null-modality definition from here)


def _mask_and(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return cm.and_(a, b)


def _host_args(pairs):
    """(value, mask) pairs for a host function: tensors (results of the
    compiled torch ops) read back as numpy, as the JAX package's host
    functions read its jax arrays."""
    return [(cm.to_numpy(v), cm.to_numpy(m)) for v, m in pairs]


LIKE_CACHE: Dict[str, Any] = {}


def _coerce_object_col(v: np.ndarray):
    from ..formats import coerce_object_col

    return coerce_object_col(v)


# the timestamp forms a string column may take: pandas' ``to_datetime``
# infers one of these strptime formats from a column's first non-null
# value (ISO 8601 dates and date-times, 'T' or space between them,
# fractional seconds, 'Z' or a numeric offset; YYYY/MM/DD), and a cell
# that does not fit the inferred format is NULL
_TS_FIELDS = {
    "%Y": r"(?P<Y>\d{4})", "%m": r"(?P<m>1[0-2]|0[1-9]|[1-9])",
    "%d": r"(?P<d>3[01]|[12]\d|0[1-9]|[1-9])",
    "%H": r"(?P<H>2[0-3]|[01]\d|\d)", "%M": r"(?P<M>[0-5]\d|\d)",
    "%S": r"(?P<S>6[01]|[0-5]\d|\d)", "%f": r"(?P<f>\d+)",
    "%z": r"(?P<z>Z|[+-]\d\d(?::?[0-5]\d)?)",
}
_TS_FORMATS = [
    date + (sep + clock + zone if clock else "")
    for date in ("%Y-%m-%d", "%Y/%m/%d")
    for sep, clock, zone in [("", "", "")] + [
        (sep, clock, zone) for sep in ("T", " ")
        for clock in ("%H:%M", "%H:%M:%S", "%H:%M:%S.%f")
        for zone in ("", "%z")]
] + ["%Y-%m"]
_TS_REGEX = {f: re.compile(re.sub("%[YmdHMSfz]",
                                  lambda m: _TS_FIELDS[m.group(0)],
                                  re.escape(f)) + "$")
             for f in _TS_FORMATS}
# NULL-like strings pandas skips when it looks for the first value
_TS_NULLS = {"", "NaT", "nat", "NAT", "nan", "NaN", "NAN"}


def _timestamp_micros(x: str, fmt: str, leap: bool) -> Optional[int]:
    """Epoch micros of ``x`` read with ``fmt`` (UTC unless it carries an
    offset), or None where it does not fit or names no real date.  A
    leap second fits only when ``leap`` (an inferred format): :60, and
    :61 in a YYYY/MM/DD form."""
    import datetime as _dt

    m = _TS_REGEX[fmt].match(x)
    if m is None:
        return None
    g = m.groupdict()
    if g.get("S") in ("60", "61") and not (
            leap and (g["S"] == "60" or "/" in fmt)):
        return None
    try:
        day = _dt.date(int(g["Y"]), int(g["m"]), int(g.get("d") or 1))
    except ValueError:
        return None
    # a leap second rolls over into the next minute
    secs = ((day - _dt.date(1970, 1, 1)).days * 86_400
            + int(g.get("H") or 0) * 3_600 + int(g.get("M") or 0) * 60
            + int(g.get("S") or 0))
    z = g.get("z")
    if z and z != "Z":
        sign = -1 if z[0] == "-" else 1
        secs -= sign * (int(z[1:3]) * 3_600 + int(z[3:].lstrip(":") or 0)
                        * 60)
    # fractions past nanoseconds are cut, then nanoseconds floor to micros
    ns = secs * 1_000_000_000 + int((g.get("f") or "0")[:9].ljust(9, "0"))
    return ns // 1_000


def _parse_timestamps(arr: np.ndarray):
    """(int64 epoch micros, validity) of a column of timestamp strings,
    as ``pd.to_datetime(list(arr), errors="coerce", utc=True)`` reads
    them: one format inferred from the first non-null value, and a cell
    that does not fit it NULL; where no format fits the first value,
    each cell is read by the first format it fits."""
    vals = np.zeros(len(arr), dtype=np.int64)
    ok = np.zeros(len(arr), dtype=bool)
    cells = [None if x is None else str(x) for x in arr]
    first = next((x for x in cells if x is not None
                  and x not in _TS_NULLS), None)
    # pandas infers no format from a year below 1000 (its guess must
    # print back as the value, and strftime drops the year's zeros)
    fmt = (next((f for f in _TS_FORMATS
                 if _timestamp_micros(first, f, False) is not None), None)
           if first is not None and not first.startswith("0") else None)
    for i, x in enumerate(cells):
        if x is None:
            continue
        for f in ([fmt] if fmt is not None else _TS_FORMATS):
            us = _timestamp_micros(x, f, fmt is not None)
            if us is not None:
                vals[i], ok[i] = us, True
                break
    return vals, ok


def _like_to_regex(pattern: str):
    if pattern not in LIKE_CACHE:
        rx = "^" + re.escape(pattern).replace("%", ".*").replace("_", ".") + "$"
        LIKE_CACHE[pattern] = re.compile(rx)
    return LIKE_CACHE[pattern]


class ExprCompiler:
    def __init__(self, schema: Schema):
        self.schema = schema
        self.needs_host = False
        self.used_cols: set = set()

    # -- main dispatch ----------------------------------------------------

    def compile(self, e: Expr) -> Callable[[Dict[str, Any]], MV]:
        if isinstance(e, Literal):
            if e.value is None:
                return lambda env: (np.int64(0), np.bool_(False))
            v = e.value
            return lambda env: (v, None)
        if isinstance(e, IntervalLit):
            us = e.micros
            return lambda env: (us, None)
        if isinstance(e, ColumnRef):
            # niladic SQL keywords (no parens in the grammar) arrive as
            # bare column refs: CURRENT_DATE / CURRENT_TIME / CURRENT_TIMESTAMP
            if (e.qualifier is None
                    and e.name.lower() in ("current_date", "current_time",
                                           "current_timestamp")
                    and e.name.lower() not in self.schema.columns):
                return self._compile_function(FunctionCall(e.name.lower(), []))
            kind, target = self.schema.resolve(e)
            if kind == "col":
                self.used_cols.add(target)
                if self.schema.is_string(target):
                    self.needs_host = True
                # temporal columns are int64 epoch micros: jit (x64 off)
                # would truncate them to int32, so they force the host path
                if (self.schema.columns.get(target) == "t"
                        or target == "__timestamp"):
                    self.needs_host = True
                # struct-field presence mask applies when the physical column
                # came from a struct
                sd = self._struct_of_field(target)
                pcpv = ((sd.presence_col, sd.presence_val)
                        if sd is not None and sd.presence_col is not None
                        and sd.name.lower() not in
                        self.schema.presence_guaranteed
                        else None)
                if pcpv is not None:
                    self.used_cols.add(pcpv[0])
                is_str = self.schema.is_string(target)

                def load(env, _t=target, _p=pcpv, _s=is_str):
                    v = env[_t]
                    # in jit envs, object columns were pre-coerced by
                    # CompiledExpr with their validity under __mask_<col>;
                    # on host paths the raw object array is coerced here
                    m = env.get("__mask_" + _t)
                    if (not _s and isinstance(v, np.ndarray)
                            and v.dtype == object):
                        v, m2 = _coerce_object_col(v)
                        m = m2 if m is None else (
                            m if m2 is None else cm.and_(m, m2))
                    elif (_s and isinstance(v, np.ndarray)
                            and v.dtype == object):
                        # string NULLs (None cells) must carry validity:
                        # without a mask, None == None compared TRUE and
                        # `WHERE s = s` kept NULL rows (SQL: NULL = NULL
                        # is NULL, never true).  All-valid columns skip
                        # the mask so plain projections stay zero-copy.
                        nn = np.asarray(nan_validity(v, None))
                        if not nn.all():
                            m = nn if m is None else cm.and_(m, nn)
                    if _p is not None:
                        pm = env[_p[0]] == _p[1]
                        m = pm if m is None else cm.and_(m, pm)
                    return v, m

                return load
            if kind == "struct":
                sd = target
                if sd.presence_col is None:
                    raise SqlCompileError(
                        f"struct {sd.name} has no presence column; "
                        "use its fields")
                pc, pv = sd.presence_col, sd.presence_val
                self.used_cols.add(pc)
                # a struct used as a value: expose its presence (IS NULL etc.)
                return lambda env: (env[pc] == pv, None)
            raise SqlCompileError(
                "window column can only be projected as `window` or compared "
                "for equality in a join")
        if isinstance(e, BinaryOp):
            return self._compile_binary(e)
        if isinstance(e, UnaryOp):
            inner = self.compile(e.operand)
            if e.op == "-":
                return lambda env: ((lambda v, m: (-v, m))(*inner(env)))
            if e.op == "not":
                def notf(env):
                    v, m = inner(env)
                    return cm.invert(v), m
                return notf
            raise SqlCompileError(f"unary {e.op}")
        if isinstance(e, IsNull):
            inner_e = e.operand
            # `struct IS NOT NULL` -> presence mask directly (and only the
            # presence column counts as used for pushdown)
            if isinstance(inner_e, ColumnRef):
                kind, target = self.schema.resolve(inner_e,
                                                   presence_only=True)
                if kind == "struct":
                    pc, pv = target.presence_col, target.presence_val
                    self.used_cols.add(pc)
                    if e.negated:
                        return lambda env: (env[pc] == pv, None)
                    return lambda env: (env[pc] != pv, None)
            inner = self.compile(inner_e)

            def isnull(env):
                v, m = inner(env)
                valid = nan_validity(v, m)
                if valid is None:
                    is_valid = torch.ones(
                        cm.shape(v) or (1,), dtype=torch.bool,
                        device=cm.device_of(v) or torch.device("cpu")) \
                        if hasattr(v, "shape") else True
                    res = is_valid if e.negated else ~is_valid \
                        if hasattr(is_valid, "__invert__") else not is_valid
                    return res, None
                return (valid if e.negated else ~valid), None
            return isnull
        if isinstance(e, InList):
            inner = self.compile(e.operand)
            items = [self.compile(x) for x in e.items]

            def inlist(env):
                v, m = inner(env)
                acc = None
                for it in items:
                    iv, im = it(env)
                    eq = cm.eq(v, iv)
                    acc = eq if acc is None else cm.or_(acc, eq)
                    m = _mask_and(m, im)
                if e.negated:
                    acc = ~acc
                return acc, m
            return inlist
        if isinstance(e, Between):
            inner = self.compile(e.operand)
            lo = self.compile(e.low)
            hi = self.compile(e.high)

            def between(env):
                v, m = inner(env)
                lv, lm = lo(env)
                hv, hm = hi(env)
                res = cm.and_(cm.ge(v, lv), cm.le(v, hv))
                if e.negated:
                    res = ~res
                return res, _mask_and(m, _mask_and(lm, hm))
            return between
        if isinstance(e, Case):
            return self._compile_case(e)
        if isinstance(e, Cast):
            return self._compile_cast(e)
        if isinstance(e, FunctionCall):
            return self._compile_function(e)
        if isinstance(e, Star):
            raise SqlCompileError("* is only valid as a projection item")
        raise SqlCompileError(f"unsupported expression {e!r}")

    def _struct_of_field(self, phys_col: str) -> Optional[StructDef]:
        for sd in self.schema.structs.values():
            if phys_col in sd.fields.values():
                return sd
        return None

    # -- pieces ------------------------------------------------------------

    def _compile_binary(self, e: BinaryOp):
        left = self.compile(e.left)
        right = self.compile(e.right)
        op = e.op

        if op == "like":
            self.needs_host = True

            def like(env):
                v, m = left(env)
                pv, pm = right(env)
                pattern = pv if isinstance(pv, str) else str(np.asarray(pv).reshape(-1)[0])
                rx = _like_to_regex(pattern)
                res = np.array([bool(s is not None and rx.match(s)) for s in v])
                return res, _mask_and(m, pm)
            return like

        if op in ("and", "or"):
            def boolop(env):
                lv, lm = left(env)
                rv, rm = right(env)
                if lm is not None:
                    lv = cm.and_(lv, lm)
                if rm is not None:
                    rv = cm.and_(rv, rm)
                return (cm.and_(lv, rv) if op == "and"
                        else cm.or_(lv, rv)), None
            return boolop

        ops = {"+": cm.add, "-": cm.sub, "*": cm.mul,
               "=": cm.eq, "<>": cm.ne, "<": cm.lt,
               "<=": cm.le, ">": cm.gt, ">=": cm.ge}

        def _is_int(v):
            if isinstance(v, (bool, np.bool_)):
                return False
            if isinstance(v, (int, np.integer)):
                return True
            if cm.is_tensor(v):
                return not (v.is_floating_point() or v.is_complex()
                            or v.dtype == torch.bool)
            if hasattr(v, "dtype"):
                return np.issubdtype(np.asarray(v).dtype, np.integer)
            return False

        def _trunc_divmod(lv, rv):
            """(quotient, remainder, zero_mask) with SQL TRUNCATION
            semantics (-7/2 = -3, -7%2 = -1 — python floor-divides) and
            a divisor==0 mask for NULL results.  Pure arithmetic only,
            so numpy inputs stay on host and tracers stay traced."""
            zero = cm.eq(rv, 0)
            if isinstance(zero, bool):  # python scalar divisor
                zero = np.bool_(zero)
            # divisor 0 -> 1 (never used: row masked NULL), so no zero
            # divisor reaches the division (torch raises on one on the
            # CPU and leaves the result undefined on the card)
            sr = cm.add(rv, zero)
            q0 = cm.floordiv(lv, sr)
            rem = cm.sub(lv, cm.mul(q0, sr))
            q = cm.add(q0, cm.and_(cm.ne(rem, 0),
                                   cm.xor(cm.lt(lv, 0), cm.lt(sr, 0))))
            return q, cm.sub(lv, cm.mul(q, sr)), zero

        if op == "||":
            self.needs_host = True

            def concat(env):
                lv, lm = left(env)
                rv, rm = right(env)
                n = len(lv) if hasattr(lv, "__len__") else len(rv)
                lvb = np.broadcast_to(np.asarray(lv, dtype=object), (n,))
                rvb = np.broadcast_to(np.asarray(rv, dtype=object), (n,))
                return (np.asarray([str(a) + str(b) for a, b in zip(lvb, rvb)],
                                   dtype=object), _mask_and(lm, rm))
            return concat

        if op == "/":
            def div(env):
                lv, lm = left(env)
                rv, rm = right(env)
                m = _mask_and(lm, rm)
                # SQL integer division stays integral, TRUNCATES toward
                # zero, and yields NULL on a zero divisor
                if _is_int(lv) and _is_int(rv):
                    q, _, zero = _trunc_divmod(lv, rv)
                    return q, _mask_and(m, ~zero)
                return cm.truediv(lv, rv), m
            return div

        if op == "%":
            def mod(env):
                lv, lm = left(env)
                rv, rm = right(env)
                m = _mask_and(lm, rm)
                if _is_int(lv) and _is_int(rv):
                    # SQL % carries the DIVIDEND's sign (-7 % 2 = -1;
                    # python floors to 1) and is NULL on a zero divisor
                    _, rem, zero = _trunc_divmod(lv, rv)
                    return rem, _mask_and(m, ~zero)
                # float %: IEEE fmod matches SQL (np.mod floors);
                # fmod(x, 0) is NaN, i.e. SQL NULL, natively
                if cm.is_tensor(lv) or cm.is_tensor(rv):
                    a, b = cm.tensors(lv, rv)
                    return torch.fmod(a, b), m
                return np.fmod(lv, rv), m
            return mod

        fn = ops[op]

        def binop(env):
            lv, lm = left(env)
            rv, rm = right(env)
            return fn(lv, rv), _mask_and(lm, rm)
        return binop

    def _compile_case(self, e: Case):
        operand = self.compile(e.operand) if e.operand is not None else None
        whens = [(self.compile(c), self.compile(v)) for c, v in e.whens]
        else_ = self.compile(e.else_) if e.else_ is not None else None

        def case(env):
            ov = operand(env) if operand else None
            # start from ELSE (or null)
            if else_ is not None:
                out_v, out_m = else_(env)
            else:
                out_v, out_m = np.int64(0), np.bool_(False)
            decided = None
            for cond_c, val_c in whens:
                cv, cmask = cond_c(env)
                if ov is not None:
                    cv = cm.eq(ov[0], cv)
                    cmask = _mask_and(ov[1], cmask)
                if cmask is not None:
                    cv = cm.and_(cv, cmask)
                take = cv if decided is None else cm.and_(cv, ~decided)
                vv, vm = val_c(env)
                out_v = cm.where(take, vv, out_v)
                if vm is None and out_m is None:
                    pass
                else:
                    vm_full = vm if vm is not None else True
                    om_full = out_m if out_m is not None else True
                    out_m = cm.where(take, vm_full, om_full)
                decided = cv if decided is None else cm.or_(decided, cv)
            return out_v, out_m
        return case

    def _compile_cast(self, e: Cast):
        inner = self.compile(e.operand)
        t = e.target_type

        if t in ("int", "integer", "bigint", "smallint", "tinyint"):
            def toint(env):
                # float NaN is the in-band NULL; an int64 cast cannot
                # carry it, so it moves into the validity mask (it used
                # to cast to 0 silently).  A float source ALWAYS yields
                # a masked (nullable) int on both host and jit paths —
                # the engine-wide nullable-int-as-f64 convention — so
                # the two modalities cannot disagree on output dtype.
                # Null detection routes through nan_validity, THE single
                # null definition.
                v, m = inner(env)
                if isinstance(v, np.ndarray) and v.dtype == object:
                    nn = np.asarray(nan_validity(v, None))
                    vals = np.asarray(
                        [int(float(x)) if ok else 0
                         for x, ok in zip(v, nn)], dtype=np.int64)
                    return vals, (nn if m is None else cm.and_(m, nn))
                is_np = isinstance(v, np.ndarray) or not hasattr(v, "dtype")
                if is_np:
                    arr = np.asarray(v)
                    if arr.dtype.kind == "f":
                        nn = nan_validity(arr, None)
                        arr = np.where(nn, arr, 0.0)
                        m = nn if m is None else cm.and_(m, nn)
                    return arr.astype(np.int64), m
                if isinstance(v, np.generic) and v.dtype.kind != "f":
                    return v.astype(np.int64), m  # a numpy scalar stays one
                arr = cm.as_tensor(v)
                if arr.is_floating_point():
                    nn = nan_validity(arr, None)
                    arr = cm.where(nn, arr, 0.0)
                    m = nn if m is None else cm.and_(m, nn)
                return arr.to(torch.int64), m
            return toint
        if t in ("float", "double", "real", "decimal", "numeric"):
            def tofloat(env):
                v, m = inner(env)
                if isinstance(v, np.ndarray) and v.dtype == object:
                    return np.asarray([float(x) for x in v],
                                      dtype=np.float32), m
                return cm.astype(v, torch.float32), m
            return tofloat
        if t in ("bool", "boolean"):
            return lambda env: ((lambda v, m: (cm.astype(v, torch.bool), m))
                                (*inner(env)))
        if t in ("text", "varchar", "string", "char"):
            self.needs_host = True

            def tostr(env):
                v, m = inner(env)
                arr = np.asarray(cm.to_numpy(v))
                return np.asarray([str(x) for x in arr.tolist()],
                                  dtype=object), m
            return tostr
        if t in ("timestamp", "datetime", "timestamptz", "date"):
            def tots(env):
                v, m = inner(env)
                arr = np.asarray(v) if not hasattr(v, "dtype") or \
                    isinstance(v, np.ndarray) else v
                if isinstance(arr, np.ndarray) and arr.dtype == object:
                    vals, ok = _parse_timestamps(arr)
                    return vals, _mask_and(m, ok)
                return cm.astype(v, torch.int64), m
            if isinstance(e.operand, ColumnRef):
                kind, target = self.schema.resolve(e.operand)
                if kind == "col" and self.schema.is_string(target):
                    self.needs_host = True
            return tots
        raise SqlCompileError(f"unsupported cast target {t}")

    def _compile_function(self, e: FunctionCall):
        name = e.name
        if e.over is not None:
            raise SqlCompileError(
                f"window function {name}() OVER (...) is only supported "
                "as the ROW_NUMBER TopN shape")
        if name in ("hop", "tumble", "session"):
            raise SqlCompileError(
                f"{name}() is only valid in GROUP BY (window assignment)")
        if name in ("count", "sum", "min", "max", "avg"):
            raise SqlCompileError(
                f"aggregate {name}() outside of aggregation context")
        if name == "date_trunc":
            from .functions import CAL_TRUNC_PRECISIONS

            precision = e.args[0]
            if not isinstance(precision, Literal):
                raise SqlCompileError("date_trunc precision must be a literal")
            inner = self.compile(e.args[1])
            p = str(precision.value).lower()
            if p in CAL_TRUNC_PRECISIONS:
                # calendar arithmetic (variable month lengths): host path
                self.needs_host = True
                fn = HOST_FUNCTIONS["__date_trunc_host"]
            else:
                fn = DEVICE_FUNCTIONS["__date_trunc"]
                return lambda env: fn(inner(env), p)
            return lambda env: fn(_host_args([inner(env)])[0], p)
        if name == "date_part" or name == "extract":
            from .functions import CAL_EXTRACT_FIELDS

            fld = e.args[0]
            if not isinstance(fld, Literal):
                raise SqlCompileError("date_part field must be a literal")
            inner = self.compile(e.args[1])
            f = str(fld.value).lower()
            if f in CAL_EXTRACT_FIELDS:
                self.needs_host = True
                fn = HOST_FUNCTIONS["__extract_host"]
            else:
                fn = DEVICE_FUNCTIONS["__extract"]
                return lambda env: fn(inner(env), f)
            return lambda env: fn(_host_args([inner(env)])[0], f)
        args = [self.compile(a) for a in e.args]
        if name in DEVICE_FUNCTIONS:
            fn = DEVICE_FUNCTIONS[name]
            return lambda env: fn([a(env) for a in args])
        if name in HOST_FUNCTIONS:
            self.needs_host = True
            fn = HOST_FUNCTIONS[name]
            if getattr(fn, "needs_env", False):
                # per-row zero-arg fns (uuid, random) need the batch length
                return lambda env: fn(_host_args([a(env) for a in args]),
                                      env)
            return lambda env: fn(_host_args([a(env) for a in args]))
        from .functions import SCALAR_UDFS

        if name in SCALAR_UDFS:
            self.needs_host = True
            udf = SCALAR_UDFS[name]

            def call_udf(env):
                pairs = _host_args([a(env) for a in args])
                vals = [np.asarray(v) for v, _m in pairs]
                out = np.asarray(udf(*vals))
                mask = None
                for _v, m in pairs:
                    if m is not None:
                        mask = np.asarray(m) if mask is None \
                            else (mask & np.asarray(m))
                return out, mask

            return call_udf
        raise SqlCompileError(f"unknown function {name}()")


def compile_scalar(e: Expr, schema: Schema, sql: str = "") -> Compiled:
    c = ExprCompiler(schema)
    fn = c.compile(e)
    return Compiled(fn, c.needs_host, sql, frozenset(c.used_cols))
