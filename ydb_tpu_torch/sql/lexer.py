"""SQL lexer (hand-rolled; analog of the generated ANTLR lexer for
`ydb/library/yql/sql/v1/SQLv1.g.in`)."""

from __future__ import annotations

from dataclasses import dataclass


class SqlError(Exception):
    pass


@dataclass(frozen=True)
class Token:
    kind: str          # kw | ident | number | string | op | eof
    value: str
    pos: int


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "is", "null", "like", "between",
    "case", "when", "then", "else", "end", "cast", "exists", "distinct",
    "join", "inner", "left", "right", "full", "outer", "cross", "on", "asc",
    "desc", "nulls", "first", "last", "date", "interval", "true", "false",
    "create", "table", "primary", "key", "drop", "insert", "upsert",
    "replace", "into", "values", "delete", "update", "set", "if", "with",
    "union", "all", "escape", "substring", "for", "partition", "store",
    "extract", "begin", "commit", "rollback", "transaction", "explain",
    "analyze", "over", "alter", "intersect", "except",
    "rows", "unbounded", "preceding", "following", "current", "row",
}

_OPS = ["<>", "!=", ">=", "<=", "||", "(", ")", ",", "+", "-", "*", "/", "%",
        "=", "<", ">", ".", ";"]


def tokenize(text: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and text[i + 1] == "-":   # line comment
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":   # block comment
            j = text.find("*/", i + 2)
            if j < 0:
                raise SqlError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n and (text[j].isdigit() or text[j] in ".eE+-"):
                if text[j] == ".":
                    if seen_dot:
                        break
                    seen_dot = True
                elif text[j] in "eE":
                    if seen_exp or j + 1 >= n or not (
                            text[j + 1].isdigit() or text[j + 1] in "+-"):
                        break
                    seen_exp = True
                elif text[j] in "+-" and text[j - 1] not in "eE":
                    break
                j += 1
            toks.append(Token("number", text[i:j], i))
            i = j
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if text[j] == "'":
                    if j + 1 < n and text[j + 1] == "'":   # '' escape
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(text[j])
                j += 1
            if j >= n:
                raise SqlError(f"unterminated string at {i}")
            toks.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == "`" or c == '"':   # quoted identifier
            j = text.find(c, i + 1)
            if j < 0:
                raise SqlError(f"unterminated identifier at {i}")
            toks.append(Token("ident", text[i + 1:j], i))
            i = j + 1
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            lw = word.lower()
            toks.append(Token("kw" if lw in KEYWORDS else "ident",
                              lw if lw in KEYWORDS else word, i))
            i = j
            continue
        for op in _OPS:
            if text.startswith(op, i):
                toks.append(Token("op", op, i))
                i += len(op)
                break
        else:
            raise SqlError(f"unexpected character {c!r} at {i}")
    toks.append(Token("eof", "", n))
    return toks
