"""Table/column statistics + predicate selectivity — the CBO's inputs.

The reference feeds its cost-based optimizer from a statistics service
(base statistics + column statistics aggregated from DataShards,
`ydb/core/statistics/`, consumed by `dq_opt_join_cost_based.cpp`). Here
the same inputs come from what storage already maintains: per-portion
min/max/null stats (`storage/portion.py`), table row counts, and string
dictionary cardinalities (exact NDV for dictionary-encoded columns).

Selectivity heuristics are the classic System-R family: equality 1/NDV,
ranges by min-max span fraction, LIKE 0.1, default 1/3 — enough to rank
join orders by effective (post-local-predicate) cardinality instead of
raw table size.
"""

from __future__ import annotations

import numpy as np

from ydb_tpu_torch.sql import ast

DEFAULT_SEL = 1.0 / 3.0
LIKE_SEL = 0.1


def table_rows(table) -> int:
    return max(int(getattr(table, "num_rows", 0)), 1)


def column_minmax(table, col: str):
    """(min, max) over the table's portions, or (None, None)."""
    lo = hi = None
    for shard in getattr(table, "shards", []):
        for p in getattr(shard, "portions", []):
            st = p.stats.get(col)
            if st is None or st.min is None:
                continue
            lo = st.min if lo is None else min(lo, st.min)
            hi = st.max if hi is None else max(hi, st.max)
    return lo, hi


def column_ndv(table, col: str) -> float:
    """Distinct-value estimate: exact for dictionary columns, span- and
    row-bounded for integers, sqrt(rows) fallback otherwise."""
    rows = table_rows(table)
    dic = getattr(table, "dictionaries", {}).get(col)
    if dic is not None and len(dic):
        return float(len(dic))
    if col in getattr(table, "key_columns", []):
        return float(rows)
    lo, hi = column_minmax(table, col)
    if lo is not None and hi is not None \
            and isinstance(lo, (int, np.integer)):
        return float(min(int(hi) - int(lo) + 1, rows))
    return float(max(rows ** 0.5, 1.0))


def _col_of(e, alias: str):
    """Column name if `e` is a bare/qualified reference to this alias."""
    if isinstance(e, ast.Name):
        if len(e.parts) == 1:
            return e.parts[0]
        if len(e.parts) == 2 and e.parts[0] == alias:
            return e.parts[1]
    return None


def _range_sel(table, col: str, op: str, v) -> float:
    lo, hi = column_minmax(table, col)
    try:
        if lo is None or hi is None or float(hi) <= float(lo):
            return DEFAULT_SEL
        span = float(hi) - float(lo)
        f = (float(v) - float(lo)) / span
        f = min(max(f, 0.0), 1.0)
        return f if op in ("<", "<=") else 1.0 - f
    except (TypeError, ValueError):
        return DEFAULT_SEL


def predicate_selectivity(pred, alias: str, table) -> float:
    """Estimated fraction of rows surviving one local predicate."""
    if isinstance(pred, ast.BinOp):
        col = _col_of(pred.left, alias)
        lit = pred.right if isinstance(pred.right, ast.Literal) else None
        if col is None:                          # literal <op> col
            col = _col_of(pred.right, alias)
            lit = pred.left if isinstance(pred.left, ast.Literal) else None
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
            op = flip.get(pred.op, pred.op)
        else:
            op = pred.op
        if col is None or not table.schema.has(col):
            return DEFAULT_SEL
        if op == "=":
            return 1.0 / column_ndv(table, col)
        if op == "<>":
            return 1.0 - 1.0 / column_ndv(table, col)
        if op in ("<", "<=", ">", ">=") and lit is not None \
                and lit.type_hint is None:
            return _range_sel(table, col, op, lit.value)
        return DEFAULT_SEL
    if isinstance(pred, ast.Between):
        col = _col_of(pred.arg, alias)
        if col is None or not table.schema.has(col):
            return DEFAULT_SEL
        if isinstance(pred.lo, ast.Literal) and isinstance(pred.hi,
                                                          ast.Literal) \
                and pred.lo.type_hint is None:
            a = _range_sel(table, col, ">=", pred.lo.value)
            b = _range_sel(table, col, "<=", pred.hi.value)
            s = max(a + b - 1.0, 1.0 / table_rows(table))
            return 1.0 - s if pred.negated else s
        return DEFAULT_SEL
    if isinstance(pred, ast.InList):
        col = _col_of(pred.arg, alias)
        if col is None or not table.schema.has(col):
            return DEFAULT_SEL
        s = min(len(pred.items) / column_ndv(table, col), 1.0)
        return 1.0 - s if pred.negated else s
    if isinstance(pred, ast.Like):
        return 1.0 - LIKE_SEL if pred.negated else LIKE_SEL
    if isinstance(pred, ast.IsNull):
        return DEFAULT_SEL
    return DEFAULT_SEL


def effective_rows(alias: str, table, local_preds: list) -> float:
    """Post-local-predicate cardinality estimate — the quantity join
    ordering ranks by (raw num_rows ranked r3's plans; a date_dim
    filtered to one month must become a build side, whatever its raw
    size relative to the probe)."""
    rows = float(table_rows(table))
    for p in local_preds:
        rows *= predicate_selectivity(p, alias, table)
    return max(rows, 1.0)
