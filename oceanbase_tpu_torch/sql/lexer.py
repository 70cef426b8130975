"""SQL tokenizer (MySQL dialect subset).

The port's own copy of ``oceanbase_tpu/sql/lexer.py``, kept line for line so
both packages parse and plan a statement alike.

Reference analog: the flex scanner (src/sql/parser/sql_parser_mysql_mode.l)
— reduced to the token classes the engine needs.  Parameterization for the
plan cache (replacing literals with ?) happens here too, mirroring the
reference's fast-parser parameterization before plan-cache lookup
(src/sql/plan_cache).
"""

from __future__ import annotations

from dataclasses import dataclass

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "join", "inner", "left", "right", "full", "outer", "on",
    "cross", "and", "or", "not", "in", "exists", "between", "like", "is",
    "null", "true", "false", "case", "when", "then", "else", "end", "cast",
    "date", "interval", "union", "all", "intersect", "except", "distinct",
    "with", "asc", "desc", "create", "table", "drop", "insert", "into",
    "values", "update", "set", "delete", "explain", "primary", "key",
    "index", "substring", "substr", "extract", "year", "month", "day",
    "any", "some", "if", "analyze", "show", "tables", "describe", "begin",
    "commit", "rollback", "using", "natural", "recursive", "for",
    "alter", "system", "global", "session", "tenant", "freeze", "major",
    "minor", "variables", "parameters", "over", "partition",
}

TWO_CHAR_OPS = {"<=", ">=", "<>", "!=", "||"}
ONE_CHAR_OPS = set("+-*/%(),.<>=;")


@dataclass
class Token:
    kind: str   # kw | ident | number | string | op | param | eof
    value: str
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.value}"


class LexError(ValueError):
    pass


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'" or c == '"':
            quote = c
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == quote:
                    if j + 1 < n and sql[j + 1] == quote:  # '' escape
                        buf.append(quote)
                        j += 2
                        continue
                    break
                if sql[j] == "\\" and j + 1 < n:
                    esc = sql[j + 1]
                    buf.append({"n": "\n", "t": "\t", "\\": "\\",
                                "'": "'", '"': '"'}.get(esc, esc))
                    j += 2
                    continue
                buf.append(sql[j])
                j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            toks.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_e = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_e and j > i:
                    if j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                        seen_e = True
                        j += 2 if sql[j + 1] in "+-" else 1
                    else:
                        break
                else:
                    break
            toks.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] in "_$"):
                j += 1
            word = sql[i:j]
            lw = word.lower()
            if lw in KEYWORDS:
                toks.append(Token("kw", lw, i))
            else:
                toks.append(Token("ident", lw, i))
            i = j
            continue
        if c == "`":
            j = sql.find("`", i + 1)
            if j < 0:
                raise LexError(f"unterminated identifier at {i}")
            toks.append(Token("ident", sql[i + 1: j].lower(), i))
            i = j + 1
            continue
        if c == "?":
            toks.append(Token("param", "?", i))
            i += 1
            continue
        if c == "@":
            j = i
            while j < n and sql[j] == "@":
                j += 1
            k = j
            while k < n and (sql[k].isalnum() or sql[k] in "_.$"):
                k += 1
            if k > j:
                toks.append(Token("sysvar", sql[i:k].lower(), i))
                i = k
                continue
            raise LexError(f"dangling '@' at {i}")
        if sql[i:i + 2] in TWO_CHAR_OPS:
            toks.append(Token("op", sql[i:i + 2], i))
            i += 2
            continue
        if c in ONE_CHAR_OPS:
            toks.append(Token("op", c, i))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at {i}")
    toks.append(Token("eof", "", n))
    return toks
