"""SQL lexer (Postgres-ish dialect, the subset Arroyo's sqlparser usage
covers — arroyo-sql/src/lib.rs:369-376)."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List, Optional

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "is", "null", "true", "false", "case",
    "when", "then", "else", "end", "cast", "interval", "join", "inner",
    "left", "right", "full", "outer", "cross", "on", "with", "create",
    "table", "insert", "into", "values", "distinct", "between", "like",
    "asc", "desc", "union", "all", "exists", "generated", "always",
    "explain",
    "virtual", "stored", "primary", "key", "if", "over", "partition",
}


@dataclass
class Token:
    kind: str  # 'kw' | 'ident' | 'number' | 'string' | 'op' | 'eof'
    value: str
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.value}"


TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*\n?|/\*.*?\*/)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><>|!=|<=|>=|\|\||::|[-+*/%(),.<>=;\[\]])
    """,
    re.VERBOSE | re.DOTALL,
)


class SqlLexError(ValueError):
    pass


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = TOKEN_RE.match(sql, pos)
        if m is None:
            raise SqlLexError(f"unexpected character {sql[pos]!r} at {pos}: "
                              f"...{sql[max(0, pos - 20):pos + 10]}...")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        if m.lastgroup == "number":
            out.append(Token("number", text, m.start()))
        elif m.lastgroup == "string":
            out.append(Token("string", text[1:-1].replace("''", "'"), m.start()))
        elif m.lastgroup == "qident":
            out.append(Token("ident", text[1:-1].replace('""', '"'), m.start()))
        elif m.lastgroup == "ident":
            low = text.lower()
            if low in KEYWORDS:
                out.append(Token("kw", low, m.start()))
            else:
                out.append(Token("ident", text, m.start()))
        else:
            out.append(Token("op", text, m.start()))
    out.append(Token("eof", "", n))
    return out
