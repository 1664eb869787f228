"""AST → SQL text renderer.

The inverse of `ydb_tpu/sql/parser.py` for the expression/SELECT subset —
what the reference's `yql/sql` layer does when distributed stages ship
rewritten query fragments to other nodes. The cluster router
(`ydb_tpu/cluster/router.py`) renders per-shard partial queries and the
merge query from rewritten ASTs; round-tripping through our own parser is
the compatibility contract (tested in tests/test_cluster.py).
"""

from __future__ import annotations

from ydb_tpu_torch.sql import ast


def _lit(v, hint=None) -> str:
    if v is None:
        return "NULL"
    if hint == "date":
        return f"date '{v}'"                 # parser keeps the ISO string
    if hint and hint.startswith("interval_"):
        return f"interval '{v}' {hint[len('interval_'):]}"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, str):
        s = v.replace("'", "''")
        return f"'{s}'"
    return repr(v)


def expr(e) -> str:                                   # noqa: C901
    if isinstance(e, ast.Name):
        return ".".join(e.parts)
    if isinstance(e, ast.Literal):
        return _lit(e.value, e.type_hint)
    if isinstance(e, ast.BinOp):
        return f"({expr(e.left)} {e.op} {expr(e.right)})"
    if isinstance(e, ast.UnaryOp):
        return f"({e.op} {expr(e.arg)})"
    if isinstance(e, ast.FuncCall):
        if e.star:
            return f"{e.name}(*)"
        inner = ", ".join(expr(a) for a in e.args)
        return f"{e.name}({'distinct ' if e.distinct else ''}{inner})"
    if isinstance(e, ast.Case):
        parts = ["CASE"]
        if e.operand is not None:
            parts.append(expr(e.operand))
        for (c, r) in e.whens:
            parts.append(f"WHEN {expr(c)} THEN {expr(r)}")
        if e.default is not None:
            parts.append(f"ELSE {expr(e.default)}")
        parts.append("END")
        return " ".join(parts)
    if isinstance(e, ast.Cast):
        return f"cast({expr(e.arg)} as {e.to})"
    if isinstance(e, ast.Between):
        neg = "not " if e.negated else ""
        return (f"({expr(e.arg)} {neg}between {expr(e.lo)} "
                f"and {expr(e.hi)})")
    if isinstance(e, ast.InList):
        neg = "not " if e.negated else ""
        items = ", ".join(expr(x) for x in e.items)
        return f"({expr(e.arg)} {neg}in ({items}))"
    if isinstance(e, ast.InSubquery):
        neg = "not " if e.negated else ""
        return f"({expr(e.arg)} {neg}in ({select(e.query)}))"
    if isinstance(e, ast.Exists):
        neg = "not " if e.negated else ""
        return f"({neg}exists ({select(e.query)}))"
    if isinstance(e, ast.ScalarSubquery):
        return f"({select(e.query)})"
    if isinstance(e, ast.Like):
        neg = "not " if e.negated else ""
        return f"({expr(e.arg)} {neg}like {_lit(e.pattern)})"
    if isinstance(e, ast.IsNull):
        return f"({expr(e.arg)} is {'not ' if e.negated else ''}null)"
    if isinstance(e, ast.Star):
        return f"{e.table}.*" if e.table else "*"
    if isinstance(e, ast.WindowFunc):
        inner = ", ".join(expr(a) for a in e.args)
        over = []
        if e.partition_by:
            over.append("partition by "
                        + ", ".join(expr(p) for p in e.partition_by))
        if e.order_by:
            over.append("order by " + ", ".join(_order(o)
                                                for o in e.order_by))
        if e.frame is not None:
            (_tag, lo, hi) = e.frame

            def bound(b):
                if isinstance(b, tuple):
                    return "unbounded preceding" if b[1] < 0 \
                        else "unbounded following"
                if b == 0:
                    return "current row"
                return f"{-b} preceding" if b < 0 else f"{b} following"
            over.append(f"rows between {bound(lo)} and {bound(hi)}")
        return f"{e.func}({inner}) over ({' '.join(over)})"
    raise TypeError(f"cannot render {type(e).__name__}")


def _order(o: ast.OrderItem) -> str:
    s = expr(o.expr) + ("" if o.ascending else " desc")
    if o.nulls_first is not None:
        s += " nulls first" if o.nulls_first else " nulls last"
    return s


def relation(r) -> str:
    if isinstance(r, ast.TableRef):
        return r.name + (f" {r.alias}" if r.alias else "")
    if isinstance(r, ast.SubqueryRef):
        return f"({select(r.query)}) {r.alias}"
    if isinstance(r, ast.Join):
        if r.kind == "cross":
            return f"{relation(r.left)}, {relation(r.right)}"
        on = f" on {expr(r.on)}" if r.on is not None else ""
        kw = {"inner": "join", "left": "left join",
              "right": "right join", "full": "full join"}[r.kind]
        return f"{relation(r.left)} {kw} {relation(r.right)}{on}"
    raise TypeError(f"cannot render relation {type(r).__name__}")


def select(s: ast.Select) -> str:
    parts = []
    if s.ctes:
        ctes = ", ".join(f"{name} as ({select(q)})" for (name, q) in s.ctes)
        parts.append(f"with {ctes}")
    items = ", ".join(
        expr(it.expr) + (f" as {it.alias}" if it.alias else "")
        for it in s.items)
    parts.append(f"select {'distinct ' if s.distinct else ''}{items}")
    if s.relation is not None:
        parts.append(f"from {relation(s.relation)}")
    if s.where is not None:
        parts.append(f"where {expr(s.where)}")
    if s.group_by:
        parts.append("group by " + ", ".join(expr(g) for g in s.group_by))
    if s.having is not None:
        parts.append(f"having {expr(s.having)}")
    if s.order_by:
        parts.append("order by " + ", ".join(_order(o) for o in s.order_by))
    if s.limit is not None:
        parts.append(f"limit {s.limit}")
    if s.offset:
        parts.append(f"offset {s.offset}")
    return " ".join(parts)
