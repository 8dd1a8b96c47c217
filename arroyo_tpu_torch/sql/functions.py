"""SQL scalar function library — the port of ``arroyo_tpu.sql.functions``
(the reference's function set, arroyo-worker/src/operators/functions/*.rs:
datetime, strings, regexp, hash, json + math built-ins from the expression
compiler).

Each function takes/returns `(value, mask)` pairs (mask None = all valid).
``DEVICE_FUNCTIONS`` are torch ops with JAX's x64 dtypes (ops/colmath.py):
they run on the expression device, or on the host's CPU tensors; the
JAX package's are ``jnp``.  ``HOST_FUNCTIONS`` (strings, regex, JSON,
hashes, calendar arithmetic) are numpy-object ops, copied from the JAX
package, and force the expression onto the host path.  The registries and
the UDF/UDAF registry below are this package's own, separate from the JAX
package's.
"""

from __future__ import annotations

import hashlib
import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import colmath as cm

MV = Tuple[Any, Optional[Any]]  # (value array, validity mask)

SECONDS = 1_000_000
DEVICE_FUNCTIONS: Dict[str, Callable] = {}
HOST_FUNCTIONS: Dict[str, Callable] = {}

# datetime precisions/fields that need calendar arithmetic (host path).
# 'week' is calendar too: Postgres truncates to the ISO Monday, not to
# 7-day buckets from the (Thursday) epoch.
CAL_TRUNC_PRECISIONS = {"week", "month", "quarter", "year", "decade",
                        "century"}
CAL_EXTRACT_FIELDS = {"year", "month", "day", "doy", "quarter", "week",
                      "isodow", "millennium", "century", "decade"}


def device_fn(name):
    def deco(f):
        DEVICE_FUNCTIONS[name] = f
        return f
    return deco


def host_fn(name):
    def deco(f):
        HOST_FUNCTIONS[name] = f
        return f
    return deco


# -- user-defined functions ---------------------------------------------------
#
# The analog of the reference's UDF registration into the planner
# (arroyo-sql/src/lib.rs:196-290) and worker-side execution
# (operators/mod.rs:347-494, wasmtime there — plain host Python here, the
# jit-or-callback policy SURVEY #20 prescribes).

SCALAR_UDFS: Dict[str, Callable] = {}
UDAFS: Dict[str, Callable] = {}


# names handled specially by the expression compiler / planner, never
# present in the function registries but still not shadowable
_RESERVED_FN_NAMES = {
    "count", "sum", "min", "max", "avg",  # built-in aggregates
    "hop", "tumble", "session",  # window assignment markers
    "date_trunc", "date_part", "extract",  # compiler special cases
}


def _check_udf_name(name: str) -> str:
    n = name.lower()
    if (n in DEVICE_FUNCTIONS or n in HOST_FUNCTIONS
            or n in _RESERVED_FN_NAMES or n in SCALAR_UDFS or n in UDAFS):
        raise ValueError(f"cannot shadow existing function {name!r}")
    return n


def register_udf(name: str, fn: Callable) -> None:
    """Register a scalar UDF: ``fn(*cols: np.ndarray) -> np.ndarray``,
    vectorized over the batch; runs on the host expression path."""
    SCALAR_UDFS[_check_udf_name(name)] = fn


def register_udaf(name: str, fn: Callable) -> None:
    """Register a user aggregate: ``fn(values: np.ndarray) -> scalar``,
    applied per group over the non-null input rows.  UDAFs are not
    mergeable and therefore plan onto buffered window operators only
    (the reference's two-phase rewrite likewise excludes UDAFs,
    operators.rs:165-167)."""
    UDAFS[_check_udf_name(name)] = fn


def unregister_udfs() -> None:
    """Testing hook: clear all user-registered functions."""
    SCALAR_UDFS.clear()
    UDAFS.clear()


def _all_valid_mask(masks):
    ms = [m for m in masks if m is not None]
    if not ms:
        return None
    out = ms[0]
    for m in ms[1:]:
        out = cm.and_(out, m)
    return out


# -- math (device) -----------------------------------------------------------

def _unary_math(fn):
    def impl(args: List[MV]) -> MV:
        (v, m), = args
        return fn(v), m
    return impl


def _exact(fn):
    """A ``jnp`` function that keeps integer dtypes (abs, ceil, ...)."""
    return lambda v: fn(cm.as_tensor(v))


def _register_math():
    ie = cm.unary_inexact
    for name, fn in [
        ("abs", _exact(torch.abs)), ("ceil", _exact(torch.ceil)),
        ("floor", _exact(torch.floor)), ("round", _exact(torch.round)),
        ("sqrt", ie(torch.sqrt)), ("exp", ie(torch.exp)),
        ("ln", ie(torch.log)), ("log10", ie(torch.log10)),
        ("log2", ie(torch.log2)),
        ("sin", ie(torch.sin)), ("cos", ie(torch.cos)), ("tan", ie(torch.tan)),
        ("asin", ie(torch.asin)), ("acos", ie(torch.acos)),
        ("atan", ie(torch.atan)),
        ("signum", cm.sign), ("trunc", _exact(torch.trunc)),
    ]:
        DEVICE_FUNCTIONS[name] = _unary_math(fn)

    def power(args):
        (a, ma), (b, mb) = args
        a, b = cm.tensors(a, b)
        return torch.pow(a, b), _all_valid_mask([ma, mb])

    DEVICE_FUNCTIONS["power"] = power
    DEVICE_FUNCTIONS["pow"] = power

    def nullif(args):
        (a, ma), (b, mb) = args
        eq = cm.eq(a, b)
        if isinstance(eq, bool):  # scalar literals: ~True is -2, not False
            eq = np.bool_(eq)
        mask = ~eq if ma is None else cm.and_(ma, ~eq)
        return a, mask

    DEVICE_FUNCTIONS["nullif"] = nullif

    def coalesce(args):
        from ..formats import nan_validity

        # NULL-ness must include the implicit encodings (NaN floats in
        # unmasked columns), not just explicit masks — else a NaN first
        # argument short-circuits and never falls through
        out_v, out_m = args[0]
        out_m = nan_validity(out_v, out_m)
        for v, m in args[1:]:
            if out_m is None:
                break
            m = nan_validity(v, m)
            # object (string) columns can't enter jnp.where — select on
            # host (nan_validity returns a mask for object arrays even
            # when every row is valid)
            obj = ((isinstance(out_v, np.ndarray) and out_v.dtype == object)
                   or (isinstance(v, np.ndarray) and v.dtype == object))
            out_v = (np.where(np.asarray(cm.to_numpy(out_m)), out_v, v)
                     if obj else cm.where(out_m, out_v, v))
            # symmetric | broadcast: out_m may be scalar (literal first
            # arg) while m is row-shaped, or vice versa
            out_m = None if m is None else cm.or_(out_m, m)
        return out_v, out_m

    DEVICE_FUNCTIONS["coalesce"] = coalesce


_register_math()


# -- datetime (device; timestamps are int64 micros) --------------------------

def _astype_int64(v):
    """``v.astype(jnp.int64)``: a numpy array stays numpy (numpy takes
    jnp's dtype objects), anything else becomes an int64 tensor."""
    if isinstance(v, np.ndarray):
        return v.astype(np.int64)
    return cm.astype(v, torch.int64, cm.device_of(v))


def _iso_week(D: np.ndarray) -> np.ndarray:
    """ISO 8601 week numbers of day numbers since the epoch: the week of
    a day is the week of its Thursday, counted from that Thursday's
    year's first Thursday."""
    dow_mon0 = (D.astype(np.int64) + 3) % 7
    thu = D - dow_mon0 + 3
    jan1 = thu.astype("datetime64[Y]").astype("datetime64[D]")
    return ((thu - jan1).astype(np.int64) // 7 + 1).astype(np.int64)


def _register_datetime():
    TRUNC = {
        "second": SECONDS,
        "minute": 60 * SECONDS,
        "hour": 3600 * SECONDS,
        "day": 86400 * SECONDS,
        # no 'week' here: ISO weeks start Monday, the epoch was a Thursday
        # -> calendar (host) path
    }

    def date_trunc_factory(unit_micros):
        def impl(args):
            v, m = args[-1]
            return (v // unit_micros) * unit_micros, m
        return impl

    def date_trunc(args, precision: str):
        p = precision.lower()
        if p in TRUNC:
            v, m = args
            return (v // TRUNC[p]) * TRUNC[p], m
        raise ValueError(f"date_trunc precision {p} requires host path")

    DEVICE_FUNCTIONS["__date_trunc"] = date_trunc  # special-cased in compiler

    # calendar-aware precisions (month lengths vary): vectorized host
    # numpy datetime64 arithmetic; the compiler routes these precisions to
    # the host path (datetime.rs month/quarter/year parity)

    def date_trunc_host(args, precision: str):
        v, m = args
        dt = np.asarray(v, dtype=np.int64).astype("datetime64[us]")
        p = precision.lower()
        if p == "week":  # ISO week starts Monday; epoch day 0 was Thursday
            D = dt.astype("datetime64[D]")
            dow_mon0 = (D.astype(np.int64) + 3) % 7
            t = D - dow_mon0
        elif p == "month":
            t = dt.astype("datetime64[M]")
        elif p == "quarter":
            mo = dt.astype("datetime64[M]").astype(np.int64)
            t = ((mo // 3) * 3).astype("datetime64[M]")
        elif p == "year":
            t = dt.astype("datetime64[Y]")
        elif p == "decade":
            y = dt.astype("datetime64[Y]").astype(np.int64) + 1970
            t = ((y // 10) * 10 - 1970).astype("datetime64[Y]")
        elif p == "century":
            y = dt.astype("datetime64[Y]").astype(np.int64) + 1970
            t = (((y - 1) // 100) * 100 + 1 - 1970).astype("datetime64[Y]")
        else:
            raise ValueError(f"unsupported date_trunc precision {p}")
        return t.astype("datetime64[us]").astype(np.int64), m

    HOST_FUNCTIONS["__date_trunc_host"] = date_trunc_host

    def extract(args, field: str):
        v, m = args
        f = field.lower()
        if f == "second":
            return (v // SECONDS) % 60, m
        if f == "minute":
            return (v // (60 * SECONDS)) % 60, m
        if f == "hour":
            return (v // (3600 * SECONDS)) % 24, m
        if f in ("epoch",):
            return v // SECONDS, m
        if f in ("dow",):
            return ((v // (86400 * SECONDS)) + 4) % 7, m  # 1970-01-01 = Thursday
        raise ValueError(f"extract field {f} requires host path")

    DEVICE_FUNCTIONS["__extract"] = extract

    def extract_host(args, field: str):
        v, m = args
        dt = np.asarray(v, dtype=np.int64).astype("datetime64[us]")
        f = field.lower()
        Y = dt.astype("datetime64[Y]")
        year = Y.astype(np.int64) + 1970
        if f == "year":
            return year, m
        mo = dt.astype("datetime64[M]").astype(np.int64)
        month = mo % 12 + 1
        if f == "month":
            return month, m
        if f == "quarter":
            return (month - 1) // 3 + 1, m
        D = dt.astype("datetime64[D]")
        if f == "day":
            return ((D - dt.astype("datetime64[M]").astype("datetime64[D]"))
                    .astype(np.int64) + 1), m
        if f == "doy":
            return (D - Y.astype("datetime64[D]")).astype(np.int64) + 1, m
        if f == "isodow":  # Monday=1..Sunday=7
            return (D.astype(np.int64) + 3) % 7 + 1, m
        if f == "week":  # ISO 8601 week number
            return _iso_week(D), m
        if f == "decade":
            return year // 10, m
        if f == "century":
            return (year - 1) // 100 + 1, m
        if f == "millennium":
            return (year - 1) // 1000 + 1, m
        raise ValueError(f"unsupported extract field {f}")

    HOST_FUNCTIONS["__extract_host"] = extract_host

    def from_unixtime(args):
        # nanoseconds -> micros timestamp (reference from_unixtime takes ns)
        (v, m), = args
        return v // 1000, m

    DEVICE_FUNCTIONS["from_unixtime"] = from_unixtime

    def to_timestamp(args):
        (v, m), = args
        return _astype_int64(v), m

    DEVICE_FUNCTIONS["to_timestamp"] = to_timestamp

    def unix_timestamp(args):
        (v, m), = args
        return v // SECONDS, m

    DEVICE_FUNCTIONS["unix_timestamp"] = unix_timestamp


_register_datetime()


# -- strings (host) ----------------------------------------------------------

def _obj(v):
    return np.asarray(v, dtype=object)


def _row_get(v, i):
    """Row i of a column, or the value itself for scalar literals."""
    if isinstance(v, str) or np.ndim(v) == 0:
        return v.item() if isinstance(v, np.ndarray) else v
    return v[i]


def _n_rows(args) -> int:
    for a, _m in args:
        if not isinstance(a, str) and np.ndim(a) > 0:
            return len(a)
    return 1


def _row_is_valid(a, i) -> bool:
    """Row i of a (value, mask) pair is non-NULL: the value is not a host
    None AND its validity mask (device-side NULLs) allows it."""
    v, m = a
    if _row_get(v, i) is None:
        return False
    if m is None:
        return True
    mm = np.asarray(m)
    return bool(mm.reshape(-1)[i] if mm.ndim and mm.shape[0] > 1 else
                mm.reshape(-1)[0] if mm.ndim else mm)


@host_fn("upper")
def _upper(args):
    (v, m), = args
    return _obj([s.upper() if s is not None else None for s in v]), m


@host_fn("lower")
def _lower(args):
    (v, m), = args
    return _obj([s.lower() if s is not None else None for s in v]), m


@host_fn("length")
def _length(args):
    (v, m), = args
    return np.array([len(s) if s is not None else 0 for s in v],
                    dtype=np.int64), m


@host_fn("char_length")
def _char_length(args):
    return _length(args)


@host_fn("concat")
def _concat(args):
    n = _n_rows(args)
    out = ["".join(str(_row_get(a[0], i)) for a in args
                   if _row_get(a[0], i) is not None)
           for i in range(n)]
    return _obj(out), _all_valid_mask([m for _, m in args])


@host_fn("substr")
def _substr(args):
    v, m = args[0]
    start = np.asarray(args[1][0]).astype(int)
    if len(args) > 2:
        ln = np.asarray(args[2][0]).astype(int)
        out = [s[st - 1:st - 1 + l] if s is not None else None
               for s, st, l in zip(v, np.broadcast_to(start, (len(v),)),
                                   np.broadcast_to(ln, (len(v),)))]
    else:
        out = [s[st - 1:] if s is not None else None
               for s, st in zip(v, np.broadcast_to(start, (len(v),)))]
    return _obj(out), m


@host_fn("substring")
def _substring(args):
    return _substr(args)


@host_fn("trim")
def _trim(args):
    (v, m), = args
    return _obj([s.strip() if s is not None else None for s in v]), m


@host_fn("ltrim")
def _ltrim(args):
    (v, m), = args
    return _obj([s.lstrip() if s is not None else None for s in v]), m


@host_fn("rtrim")
def _rtrim(args):
    (v, m), = args
    return _obj([s.rstrip() if s is not None else None for s in v]), m


@host_fn("replace")
def _replace(args):
    v, m = args[0]
    old = args[1][0]
    new = args[2][0]
    out = [s.replace(o, nw) if s is not None else None
           for s, o, nw in zip(v, np.broadcast_to(old, (len(v),)),
                               np.broadcast_to(new, (len(v),)))]
    return _obj(out), m


@host_fn("split_part")
def _split_part(args):
    v, m = args[0]
    delim = args[1][0]
    idx = np.asarray(args[2][0]).astype(int)
    out = []
    for s, d, i in zip(v, np.broadcast_to(delim, (len(v),)),
                       np.broadcast_to(idx, (len(v),))):
        if s is None:
            out.append(None)
            continue
        parts = s.split(d)
        out.append(parts[i - 1] if 0 < i <= len(parts) else "")
    return _obj(out), m


@host_fn("starts_with")
def _starts_with(args):
    v, m = args[0]
    prefix = args[1][0]
    return np.array([bool(s and s.startswith(p)) for s, p in
                     zip(v, np.broadcast_to(prefix, (len(v),)))]), m


@host_fn("regexp_match")
def _regexp_match(args):
    v, m = args[0]
    pattern = str(np.asarray(args[1][0]).reshape(-1)[0])
    rx = re.compile(pattern)
    return np.array([bool(s is not None and rx.search(s)) for s in v]), m


@host_fn("regexp_replace")
def _regexp_replace(args):
    v, m = args[0]
    pattern = str(np.asarray(args[1][0]).reshape(-1)[0])
    repl = str(np.asarray(args[2][0]).reshape(-1)[0])
    rx = re.compile(pattern)
    return _obj([rx.sub(repl, s) if s is not None else None for s in v]), m


@host_fn("md5")
def _md5(args):
    (v, m), = args
    return _obj([hashlib.md5(str(s).encode()).hexdigest()
                 if s is not None else None for s in v]), m


@host_fn("sha256")
def _sha256(args):
    (v, m), = args
    return _obj([hashlib.sha256(str(s).encode()).hexdigest()
                 if s is not None else None for s in v]), m



def _json_path_query(args):
    """Evaluate a $.a.b path over a JSON string column, returning per row
    the list of ALL matches (array nodes fan out over their elements, as
    jsonpath does) or None on a parse error
    (arroyo-worker/src/operators/functions/json.rs)."""
    import json as _json

    v, m = args[0]
    path = str(np.asarray(args[1][0]).reshape(-1)[0])
    # split into segments, expanding indexers: a[0].b -> ['a', 0, 'b'],
    # a[*].b -> ['a', '*', 'b'] (jsonpath subset the reference's json.rs
    # relies on).  Only the leading '$.'/'$' root marker is stripped —
    # keys may legitimately contain '$' ($ref, $schema).
    if path.startswith("$."):
        path = path[2:]
    elif path.startswith("$"):
        path = path[1:]
    keys: list = []
    bad_path = False
    for part in path.split("."):
        if not part:
            continue
        base, _, rest = part.partition("[")
        if base:
            keys.append(base)
        while rest:
            idx, _, rest = rest.partition("]")
            if idx == "*":
                keys.append("*")
            elif re.fullmatch(r"-?\d+", idx):
                keys.append(int(idx))
            else:
                # unsupported bracket form ($['k'], slices, '--1', '+1',
                # '1_0'): no matches, never a crashed pipeline
                bad_path = True
            rest = rest.lstrip("[")
    if bad_path:
        return [[] for _ in v], m
    rows = []
    for s in v:
        try:
            nodes = [_json.loads(s)]
        except Exception:
            rows.append(None)
            continue
        for k in keys:
            nxt = []
            if isinstance(k, int):  # explicit array index (arrays only:
                for nd in nodes:     # [0] on a string is NOT char access)
                    if isinstance(nd, list):
                        try:
                            nxt.append(nd[k])
                        except IndexError:
                            pass
            elif k == "*":  # explicit wildcard over array elements
                for nd in nodes:
                    if isinstance(nd, list):
                        nxt.extend(nd)
            else:
                for nd in nodes:
                    items = nd if isinstance(nd, list) else [nd]
                    for item in items:
                        try:
                            nxt.append(item[k])
                        except Exception:
                            pass
            nodes = nxt
        rows.append(nodes)
    return rows, m


def _json_path_walk(args, convert):
    """First-match walk; per-row null when the path matches nothing.
    ``convert`` maps the matched object to the output value."""
    rows, m = _json_path_query(args)
    out = [convert(r[0]) if r else None for r in rows]
    mask = np.array([o is not None for o in out])
    return _obj(out), mask if m is None else (m & mask)


@host_fn("get_json_objects")
def _get_json_objects(args):
    """ALL path matches, each JSON-encoded, as a list per row
    (json.rs get_json_objects returns Vec<String>)."""
    import json as _json

    rows, m = _json_path_query(args)
    out = [[_json.dumps(o) for o in r] if r is not None else None
           for r in rows]
    mask = np.array([o is not None for o in out])
    return _obj(out), mask if m is None else (m & mask)


@host_fn("hash")
def _hash(args):
    from ..types import hash_any_column

    (v, m), = args
    return hash_any_column(np.asarray(v)).astype(np.int64), m


# -- string parity additions (strings.rs full inventory) ---------------------

def _map_str(v, f):
    return _obj([f(s) if s is not None else None for s in v])


def _and_input_nulls(v, m):
    """Validity mask with None input rows marked null, even when the
    incoming mask is absent (object string columns skip coercion)."""
    ok = np.array([s is not None for s in v])
    return ok if m is None else (m & ok)


@host_fn("ascii")
def _ascii(args):
    (v, m), = args
    return (np.array([ord(s[0]) if s else 0 for s in v], dtype=np.int64),
            _and_input_nulls(v, m))


@host_fn("chr")
def _chr(args):
    (v, m), = args
    out, ok = [], []
    for x in np.asarray(v).reshape(-1):
        # per-row null on invalid codepoints, never a batch abort
        if x is None or not (0 <= int(x) <= 0x10FFFF):
            out.append(None)
            ok.append(False)
        else:
            out.append(chr(int(x)))
            ok.append(True)
    okm = np.asarray(ok)
    return _obj(out), okm if m is None else (m & okm)


@host_fn("initcap")
def _initcap(args):
    import re as _re

    (v, m), = args

    def cap(s: str) -> str:
        # SQL initcap: words are alphanumeric runs (unlike str.title,
        # which also breaks on digits and apostrophes)
        return _re.sub(r"[A-Za-z0-9]+",
                       lambda mt: mt.group(0)[0].upper()
                       + mt.group(0)[1:].lower(), s)

    return _map_str(v, cap), m


@host_fn("left")
def _left(args):
    v, m = args[0]
    n = np.broadcast_to(np.asarray(args[1][0]).astype(int), (len(v),))
    return _obj([s[:k] if s is not None else None
                 for s, k in zip(v, n)]), m


@host_fn("right")
def _right(args):
    v, m = args[0]
    n = np.broadcast_to(np.asarray(args[1][0]).astype(int), (len(v),))

    def take(s, k):
        if k == 0:
            return ""  # Postgres: right(s, 0) = '' (s[-0:] would be s)
        if k > 0:
            return s[-k:] if k < len(s) else s
        return s[-k:]  # negative: all but the first |k| chars (Postgres)

    return _obj([take(s, k) if s is not None else None
                 for s, k in zip(v, n)]), m


@host_fn("lpad")
def _lpad(args):
    v, m = args[0]
    n = np.broadcast_to(np.asarray(args[1][0]).astype(int), (len(v),))
    fill = str(np.asarray(args[2][0]).reshape(-1)[0]) if len(args) > 2 \
        else " "
    out = []
    for s, k in zip(v, n):
        if s is None:
            out.append(None)
        elif k <= 0:
            out.append("")  # Postgres: non-positive length pads to empty
        elif len(s) >= k:
            out.append(s[:k])
        else:
            pad = (fill * k)[:k - len(s)]
            out.append(pad + s)
    return _obj(out), m


@host_fn("rpad")
def _rpad(args):
    v, m = args[0]
    n = np.broadcast_to(np.asarray(args[1][0]).astype(int), (len(v),))
    fill = str(np.asarray(args[2][0]).reshape(-1)[0]) if len(args) > 2 \
        else " "
    out = []
    for s, k in zip(v, n):
        if s is None:
            out.append(None)
        elif k <= 0:
            out.append("")  # Postgres: non-positive length pads to empty
        elif len(s) >= k:
            out.append(s[:k])
        else:
            pad = (fill * k)[:k - len(s)]
            out.append(s + pad)
    return _obj(out), m


@host_fn("octet_length")
def _octet_length(args):
    (v, m), = args
    return (np.array([len(str(s).encode()) if s is not None else 0
                      for s in v], dtype=np.int64),
            _and_input_nulls(v, m))


@host_fn("bit_length")
def _bit_length(args):
    (v, m), = args
    return (np.array([len(str(s).encode()) * 8 if s is not None else 0
                      for s in v], dtype=np.int64),
            _and_input_nulls(v, m))


@host_fn("strpos")
def _strpos(args):
    v, m = args[0]
    needle = str(np.asarray(args[1][0]).reshape(-1)[0])
    return (np.array([(s.find(needle) + 1) if s is not None else 0
                      for s in v], dtype=np.int64),
            _and_input_nulls(v, m))


@host_fn("translate")
def _translate(args):
    v, m = args[0]
    frm = str(np.asarray(args[1][0]).reshape(-1)[0])
    to = str(np.asarray(args[2][0]).reshape(-1)[0])
    table = {ord(f): (to[i] if i < len(to) else None)
             for i, f in enumerate(frm)}
    return _map_str(v, lambda s: s.translate(table)), m


def _sha_fn(algo):
    def fn(args):
        (v, m), = args
        return _obj([getattr(hashlib, algo)(str(s).encode()).hexdigest()
                     if s is not None else None for s in v]), m

    return fn


HOST_FUNCTIONS["sha224"] = _sha_fn("sha224")
HOST_FUNCTIONS["sha384"] = _sha_fn("sha384")
HOST_FUNCTIONS["sha512"] = _sha_fn("sha512")


@host_fn("extract_json_string")
def _extract_json_string(args):
    """First match, and only if it is a JSON string — non-string matches
    are NULL (json.rs extract_json_string matches Value::String only)."""
    return _json_path_walk(
        args, lambda o: o if isinstance(o, str) else None)


@host_fn("get_first_json_object")
def _get_first_json_object(args):
    import json as _json

    return _json_path_walk(
        args, lambda o: _json.dumps(o) if isinstance(o, (dict, list))
        else o)


# -- extended math (device) ---------------------------------------------------
# hyperbolics / roots / angle conversion / integer math, completing the
# reference's BuiltinScalarFunction math coverage (expressions.rs)

def _register_math_ext():
    ie = cm.unary_inexact

    def cbrt(t):
        # jnp.cbrt keeps the sign: a real cube root of negatives
        return torch.sign(t) * torch.pow(torch.abs(t), 1.0 / 3.0)

    for name, fn in [
        ("sinh", ie(torch.sinh)), ("cosh", ie(torch.cosh)),
        ("tanh", ie(torch.tanh)),
        ("asinh", ie(torch.asinh)), ("acosh", ie(torch.acosh)),
        ("atanh", ie(torch.atanh)), ("cbrt", ie(cbrt)),
        ("degrees", ie(torch.rad2deg)), ("radians", ie(torch.deg2rad)),
    ]:
        DEVICE_FUNCTIONS[name] = _unary_math(fn)

    tan = ie(torch.tan)
    DEVICE_FUNCTIONS["cot"] = _unary_math(lambda v: cm.truediv(1.0, tan(v)))

    def atan2(args):
        (y, my), (x, mx) = args
        y, x = cm.tensors(y, x)
        dt = cm.inexact(y.dtype)
        return torch.atan2(y.to(dt), x.to(dt)), _all_valid_mask([my, mx])

    DEVICE_FUNCTIONS["atan2"] = atan2

    log10, ln = ie(torch.log10), ie(torch.log)

    def log(args):
        # Postgres: log(x) = log10; log(b, x) = log base b
        if len(args) == 1:
            (v, m), = args
            return log10(v), m
        (b, mb), (x, mx) = args
        return cm.truediv(ln(x), ln(b)), _all_valid_mask([mb, mx])

    DEVICE_FUNCTIONS["log"] = log

    def pi(args):
        return math.pi, None

    DEVICE_FUNCTIONS["pi"] = pi

    def factorial(args):
        (v, m), = args
        # exact in int64 up to 20!; n > 20 overflows int64, so those rows
        # become NULL (the reference's DataFusion int64 factorial errors
        # on overflow — a masked-out row is our non-aborting analog)
        n = cm.astype(v, torch.int64, cm.device_of(v))
        ok = n <= 20
        nc = torch.clamp(n, 0, 20)
        i = torch.arange(1, 21, dtype=torch.int64, device=n.device)
        terms = torch.where(i[None, :] <= nc[..., None], i[None, :],
                            torch.ones((), dtype=torch.int64,
                                       device=n.device))
        return (torch.prod(terms, dim=-1),
                (ok if m is None else cm.and_(m, ok)))

    DEVICE_FUNCTIONS["factorial"] = factorial

    def _abs64(a, b):
        dev = cm.device_of(a, b)
        return (torch.abs(cm.astype(a, torch.int64, dev)),
                torch.abs(cm.astype(b, torch.int64, dev)))

    def gcd(args):
        (a, ma), (b, mb) = args
        x, y = torch.broadcast_tensors(*_abs64(a, b))
        # exact Euclid over every lane (gcd(0, 0) = 0), as the JAX
        # package's while_loop computes it
        return torch.gcd(x, y), _all_valid_mask([ma, mb])

    DEVICE_FUNCTIONS["gcd"] = gcd

    def lcm(args):
        (a, ma), (b, mb) = args
        g, m = gcd(args)
        x, y = _abs64(a, b)
        v = torch.where(g != 0, x // torch.where(g == 0, 1, g) * y, 0)
        return v, m

    DEVICE_FUNCTIONS["lcm"] = lcm


_register_math_ext()


# -- extended strings / binary (host) ----------------------------------------


@host_fn("repeat")
def _repeat(args):
    (v, m), (n, mn) = args
    rows = _n_rows(args)
    out = []
    for i in range(rows):
        s, k = _row_get(v, i), _row_get(n, i)
        out.append(s * max(int(k), 0) if s is not None else None)
    return _obj(out), _all_valid_mask([m, mn])


@host_fn("reverse")
def _reverse(args):
    (v, m), = args
    rows = _n_rows(args)
    return _obj([(_row_get(v, i) or "")[::-1] if _row_get(v, i) is not None
                 else None for i in range(rows)]), m


@host_fn("btrim")
def _btrim(args):
    v, m = args[0]
    chars = None
    if len(args) > 1:
        cv = args[1][0]
        chars = cv if isinstance(cv, str) else str(np.asarray(cv).reshape(-1)[0])
    if isinstance(v, str) or np.ndim(v) == 0:
        sv = _row_get(v, 0)
        return np.asarray(sv.strip(chars) if sv is not None else None,
                          dtype=object), m
    return _obj([s.strip(chars) if s is not None else None for s in v]), m


@host_fn("to_hex")
def _to_hex(args):
    (v, m), = args

    def hx(x):
        # negatives render as 64-bit two's complement ('ffffffffffffffff'
        # for -1), matching Postgres/DataFusion — not '-<hex>'
        return format(int(x) & 0xFFFFFFFFFFFFFFFF, "x")

    vals = np.asarray(v)
    if vals.ndim == 0:  # scalar literal: 0-d result broadcasts downstream
        return np.asarray(hx(vals), dtype=object), m
    return _obj([hx(x) for x in vals.tolist()]), m


@host_fn("encode")
def _encode(args):
    import base64

    (v, m), (f, mf) = args
    fmt = f if isinstance(f, str) else str(np.asarray(f).reshape(-1)[0])
    fmt = fmt.lower()

    def enc(s):
        if s is None:
            return None
        raw = s.encode() if isinstance(s, str) else bytes(s)
        if fmt == "hex":
            return raw.hex()
        if fmt == "base64":
            return base64.b64encode(raw).decode()
        raise ValueError(f"encode: unknown format {fmt!r}")

    return _obj([enc(_row_get(v, i)) for i in range(_n_rows(args[:1]))]), \
        _all_valid_mask([m, mf])


@host_fn("decode")
def _decode(args):
    import base64

    (v, m), (f, mf) = args
    fmt = f if isinstance(f, str) else str(np.asarray(f).reshape(-1)[0])
    fmt = fmt.lower()

    def dec(s):
        if s is None:
            return None
        if fmt == "hex":
            raw = bytes.fromhex(s)
        elif fmt == "base64":
            raw = base64.b64decode(s)
        else:
            raise ValueError(f"decode: unknown format {fmt!r}")
        # valid UTF-8 round-trips as str; anything else stays raw bytes
        # rather than being mangled through replacement characters
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            return raw

    return _obj([dec(_row_get(v, i)) for i in range(_n_rows(args[:1]))]), \
        _all_valid_mask([m, mf])


@host_fn("concat_ws")
def _concat_ws(args):
    (sep_v, sep_m) = args[0]
    rest = args[1:]
    n = _n_rows(args)
    out = []
    valid = np.ones(n, dtype=bool)
    for i in range(n):
        # the separator is evaluated per row (it may be a column), and a
        # NULL separator yields a NULL result (Postgres/DataFusion) —
        # NULL value args, by contrast, are merely skipped
        sep = _row_get(sep_v, i)
        # broadcastable length-1 masks (scalar-literal separator) index
        # row 0 for every row, same as _row_is_valid
        sm = (None if sep_m is None else np.asarray(sep_m).reshape(-1))
        if sep is None or (sm is not None
                           and not bool(sm[i if sm.shape[0] > 1 else 0])):
            out.append(None)
            valid[i] = False
            continue
        out.append(str(sep).join(str(_row_get(a[0], i)) for a in rest
                                 if _row_is_valid(a, i)))
    return _obj(out), (None if valid.all() else valid)


def _uuid(args, env):
    import uuid as _u

    n = len(env["__timestamp"])
    return _obj([str(_u.uuid4()) for _ in range(n)]), None


_uuid.needs_env = True
HOST_FUNCTIONS["uuid"] = _uuid


def _random(args, env):
    n = len(env["__timestamp"])
    return np.random.random(n), None


_random.needs_env = True
HOST_FUNCTIONS["random"] = _random


@host_fn("digest")
def _digest(args):
    (v, m), (a, ma) = args
    algo = a if isinstance(a, str) else str(np.asarray(a).reshape(-1)[0])
    algo = algo.lower().replace("-", "")

    def d(s):
        if s is None:
            return None
        h = hashlib.new(algo)
        h.update(s.encode() if isinstance(s, str) else bytes(s))
        return h.hexdigest()

    return _obj([d(_row_get(v, i)) for i in range(_n_rows(args[:1]))]), \
        _all_valid_mask([m, ma])


# -- extended datetime (host wallclock + device conversions) ------------------


def _now(args, env):
    import time as _t

    return np.int64(int(_t.time() * 1e6)), None


_now.needs_env = True
HOST_FUNCTIONS["now"] = _now
HOST_FUNCTIONS["current_timestamp"] = _now


def _current_date(args, env):
    import time as _t

    micros = int(_t.time() * 1e6)
    return np.int64(micros - micros % (86_400 * SECONDS)), None


_current_date.needs_env = True
HOST_FUNCTIONS["current_date"] = _current_date


def _current_time(args, env):
    import time as _t

    micros = int(_t.time() * 1e6)
    return np.int64(micros % (86_400 * SECONDS)), None


_current_time.needs_env = True
HOST_FUNCTIONS["current_time"] = _current_time


def _register_datetime_ext():
    def i64(v):
        return cm.astype(v, torch.int64, cm.device_of(v))

    def to_ts_seconds(args):
        (v, m), = args
        return i64(v) * SECONDS, m

    def to_ts_millis(args):
        (v, m), = args
        return i64(v) * 1000, m

    def to_ts_micros(args):
        (v, m), = args
        return i64(v), m

    DEVICE_FUNCTIONS["to_timestamp_seconds"] = to_ts_seconds
    DEVICE_FUNCTIONS["to_timestamp_millis"] = to_ts_millis
    DEVICE_FUNCTIONS["to_timestamp_micros"] = to_ts_micros

    def date_bin(args):
        # date_bin(stride, ts, origin): floor ts into stride-sized bins
        # anchored at origin (DataFusion semantics)
        (stride, ms), (ts, mt) = args[0], args[1]
        origin = args[2][0] if len(args) > 2 else 0
        dev = cm.device_of(ts, stride, origin)
        t = cm.astype(ts, torch.int64, dev)
        s = cm.astype(stride, torch.int64, dev)
        o = cm.astype(origin, torch.int64, dev)
        return o + ((t - o) // s) * s, _all_valid_mask([ms, mt])

    DEVICE_FUNCTIONS["date_bin"] = date_bin


_register_datetime_ext()


# -- arrays (host; object columns of python lists) ---------------------------
# the reference exposes DataFusion's array family (expressions.rs
# ArrayAppend/Concat/..); arrays travel as object columns of lists here


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple, np.ndarray)) else [x]


@host_fn("make_array")
def _make_array(args):
    n = len(args[0][0]) if args and hasattr(args[0][0], "__len__") \
        and not isinstance(args[0][0], str) else 1
    out = []
    for i in range(n):
        out.append([a[0][i] if hasattr(a[0], "__len__")
                    and not isinstance(a[0], str) else a[0] for a in args])
    return _obj(out), _all_valid_mask([m for _, m in args])


@host_fn("array_append")
def _array_append(args):
    (v, m), (x, mx) = args
    xs = x if hasattr(x, "__len__") and not isinstance(x, str) \
        else [x] * len(v)
    return _obj([(_as_list(a) + [b]) if a is not None else None
                 for a, b in zip(v, xs)]), _all_valid_mask([m, mx])


@host_fn("array_prepend")
def _array_prepend(args):
    (x, mx), (v, m) = args
    xs = x if hasattr(x, "__len__") and not isinstance(x, str) \
        else [x] * len(v)
    return _obj([([b] + _as_list(a)) if a is not None else None
                 for a, b in zip(v, xs)]), _all_valid_mask([m, mx])


@host_fn("array_concat")
def _array_concat(args):
    n = len(args[0][0])
    out = []
    for i in range(n):
        row = []
        for a, _m in args:
            if a[i] is not None:
                row.extend(_as_list(a[i]))
        out.append(row)
    return _obj(out), _all_valid_mask([m for _, m in args])


@host_fn("array_contains")
def _array_contains(args):
    (v, m), (x, mx) = args
    xs = x if hasattr(x, "__len__") and not isinstance(x, str) \
        else [x] * len(v)
    return np.array([b in _as_list(a) if a is not None else False
                     for a, b in zip(v, xs)]), _all_valid_mask([m, mx])


@host_fn("array_length")
def _array_length(args):
    v, m = args[0]
    return np.array([len(_as_list(a)) if a is not None else 0
                     for a in v], dtype=np.int64), m


HOST_FUNCTIONS["cardinality"] = HOST_FUNCTIONS["array_length"]


@host_fn("array_position")
def _array_position(args):
    (v, m), (x, mx) = args
    xs = x if hasattr(x, "__len__") and not isinstance(x, str) \
        else [x] * len(v)

    def pos(a, b):
        if a is None:
            return 0
        lst = _as_list(a)
        return lst.index(b) + 1 if b in lst else 0  # 1-based; 0 = absent

    out = np.array([pos(a, b) for a, b in zip(v, xs)], dtype=np.int64)
    return out, _all_valid_mask([m, mx])


@host_fn("array_positions")
def _array_positions(args):
    (v, m), (x, mx) = args
    xs = x if hasattr(x, "__len__") and not isinstance(x, str) \
        else [x] * len(v)
    return _obj([[i + 1 for i, el in enumerate(_as_list(a)) if el == b]
                 if a is not None else None
                 for a, b in zip(v, xs)]), _all_valid_mask([m, mx])


@host_fn("array_remove")
def _array_remove(args):
    (v, m), (x, mx) = args
    xs = x if hasattr(x, "__len__") and not isinstance(x, str) \
        else [x] * len(v)
    return _obj([[el for el in _as_list(a) if el != b]
                 if a is not None else None
                 for a, b in zip(v, xs)]), _all_valid_mask([m, mx])


@host_fn("array_replace")
def _array_replace(args):
    (v, m), (x, mx), (y, my) = args
    n = len(v)
    xs = x if hasattr(x, "__len__") and not isinstance(x, str) else [x] * n
    ys = y if hasattr(y, "__len__") and not isinstance(y, str) else [y] * n
    return _obj([[c if el == b else el for el in _as_list(a)]
                 if a is not None else None
                 for a, b, c in zip(v, xs, ys)]), \
        _all_valid_mask([m, mx, my])


@host_fn("array_to_string")
def _array_to_string(args):
    (v, m), (s, ms) = args
    sep = s if isinstance(s, str) else str(np.asarray(s).reshape(-1)[0])
    return _obj([sep.join(str(el) for el in _as_list(a))
                 if a is not None else None
                 for a in v]), _all_valid_mask([m, ms])


@host_fn("trim_array")
def _trim_array(args):
    (v, m), (n, mn) = args
    nn = np.broadcast_to(np.asarray(n).astype(int), (len(v),))
    return _obj([_as_list(a)[:max(len(_as_list(a)) - int(k), 0)]
                 if a is not None else None
                 for a, k in zip(v, nn)]), _all_valid_mask([m, mn])


@host_fn("array_ndims")
def _array_ndims(args):
    v, m = args[0]

    def nd(a):
        d = 0
        while isinstance(a, (list, tuple)) and a:
            d += 1
            a = a[0]
        return d if d else (1 if isinstance(a, (list, tuple)) else 0)

    return np.array([nd(a) if a is not None else 0 for a in v],
                    dtype=np.int64), m


@host_fn("array_dims")
def _array_dims(args):
    v, m = args[0]

    def dims(a):
        out = []
        while isinstance(a, (list, tuple)):
            out.append(len(a))
            a = a[0] if a else None
        return out

    return _obj([dims(a) if a is not None else None for a in v]), m
