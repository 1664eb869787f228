"""Window functions and set operations — engine-level evaluation.

The reference expands window functions in the logical optimizer
(`yql/core/common_opt/` window expansion) into partition-sorted traversals,
and UNION ALL into `Extend` callables. Here both evaluate over the result
of the core columnar engine: the inner query (scan/filter/join/aggregate)
runs on the device through the normal fused path; the window pass and the
set combine run host-side over the (usually post-aggregation, small)
result — the "host fallback lane" of SURVEY §7. Device-native segmented
window kernels can replace the host pass without changing the SQL surface.

Supported: ROW_NUMBER / RANK / DENSE_RANK (PARTITION BY + ORDER BY),
SUM/MIN/MAX/COUNT/AVG OVER (PARTITION BY [ORDER BY → running aggregates,
ROWS semantics]). Frames (ROWS BETWEEN ...) are not parsed yet.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ydb_tpu_torch.sql import ast

WINDOW_FUNCS = {"row_number", "rank", "dense_rank", "sum", "min", "max",
                "count", "avg", "lead", "lag"}


def _contains_window(e) -> bool:
    if isinstance(e, ast.WindowFunc):
        return True
    if not hasattr(e, "__dataclass_fields__"):
        return False

    def any_in(v):
        if isinstance(v, tuple):
            return any(any_in(x) for x in v)
        return hasattr(v, "__dataclass_fields__") and _contains_window(v)
    return any(any_in(getattr(e, f)) for f in e.__dataclass_fields__)


def has_window(sel: ast.Select) -> bool:
    return any(_contains_window(i.expr) for i in sel.items
               if not isinstance(i.expr, ast.Star))


def split_windowed(sel: ast.Select):
    """Split a windowed select into (inner select, outer plan, post).

    inner: every non-window item plus synthesized aliases for each window
    function's args / partition keys / order keys.
    outer: ordered [(kind, payload)] describing how to assemble the final
    frame — ("col", alias) or ("win", spec dict).
    post: None, or final SelectItems to evaluate over the computed frame
    when a window function appears INSIDE an expression (e.g. the q98
    ratio `rev * 100 / sum(rev) over (partition by class)`) — those
    expressions run as a second engine pass over the frame.
    """
    inner_items: list = []
    outer: list = []
    post_items: list = []
    any_nested = False

    def win_spec(e: ast.WindowFunc, alias: str, tag: str) -> dict:
        if e.func not in WINDOW_FUNCS:
            raise ValueError(f"unsupported window function {e.func}")
        if e.distinct:
            raise ValueError(
                "DISTINCT inside a window function is not supported")
        spec = {"func": e.func, "args": [], "part": [], "order": [],
                "asc": [], "alias": alias, "frame": e.frame}
        for j, a in enumerate(e.args):
            al = f"__{tag}a{j}"
            inner_items.append(ast.SelectItem(a, al))
            spec["args"].append(al)
        for j, p in enumerate(e.partition_by):
            al = f"__{tag}p{j}"
            inner_items.append(ast.SelectItem(p, al))
            spec["part"].append(al)
        for j, o in enumerate(e.order_by):
            al = f"__{tag}o{j}"
            inner_items.append(ast.SelectItem(o.expr, al))
            spec["order"].append(al)
            spec["asc"].append(o.ascending)
        return spec

    name_map: dict = {}
    agg_map: dict = {}
    wx_count = [0]

    def rewrite(e):
        """Replace nested WindowFuncs with frame-column refs, plain
        AGGREGATES with inner-select aliases (the inner select carries
        the GROUP BY — `sum(v) * 100 / sum(sum(v)) over ()` needs sum(v)
        computed there, not over the frame), and source Names with
        passthrough aliases (the frame is a temp table; the original
        scope is gone by the time the post pass runs)."""
        import dataclasses
        from ydb_tpu_torch.query.binder import AGG_NAMES
        if isinstance(e, ast.WindowFunc):
            alias = f"__wx{wx_count[0]}"
            wx_count[0] += 1
            outer.append(("win", win_spec(e, alias, alias.strip("_"))))
            return ast.Name((alias,))
        if isinstance(e, ast.FuncCall) and e.name in AGG_NAMES \
                and not _contains_window(e):
            key = repr(e)
            al = agg_map.get(key)
            if al is None:
                al = f"__wg{len(agg_map)}"
                agg_map[key] = al
                inner_items.append(ast.SelectItem(e, al))
                outer.append(("col", al))
            return ast.Name((al,))
        if isinstance(e, ast.Name):
            al = name_map.get(e.parts)
            if al is None:
                al = f"__wc{len(name_map)}"
                name_map[e.parts] = al
                inner_items.append(ast.SelectItem(e, al))
                outer.append(("col", al))
            return ast.Name((al,))
        if not hasattr(e, "__dataclass_fields__"):
            return e

        def rw(v):
            if isinstance(v, tuple):
                return tuple(rw(x) for x in v)
            if hasattr(v, "__dataclass_fields__"):
                return rewrite(v)
            return v
        return dataclasses.replace(
            e, **{f: rw(getattr(e, f)) for f in e.__dataclass_fields__})

    nested = [not isinstance(i.expr, ast.WindowFunc)
              and _contains_window(i.expr) for i in sel.items]
    any_nested = any(nested)

    for idx, item in enumerate(sel.items):
        e = item.expr
        if nested[idx]:
            alias = item.alias or f"column{idx}"
            post_items.append(ast.SelectItem(rewrite(e), alias))
            continue
        if isinstance(e, ast.WindowFunc):
            alias = item.alias or f"column{idx}"
            outer.append(("win", win_spec(e, alias, f"w{idx}")))
            if any_nested:
                post_items.append(ast.SelectItem(ast.Name((alias,)),
                                                 alias))
        else:
            alias = item.alias
            if alias is None and isinstance(e, ast.Name):
                alias = e.parts[-1]
            alias = alias or f"column{idx}"
            inner_items.append(ast.SelectItem(e, alias))
            outer.append(("col", alias))
            if any_nested:
                post_items.append(ast.SelectItem(ast.Name((alias,)),
                                                 alias))
    # SQL applies DISTINCT to the FINAL output, after window evaluation —
    # the engine dedups the computed frame, never the inner query
    inner = ast.Select(items=inner_items, relation=sel.relation,
                       where=sel.where, group_by=list(sel.group_by),
                       having=sel.having, distinct=False)
    inner.ctes = list(sel.ctes)
    return inner, outer, (post_items if any_nested else None)


def _constant_arg(s: pd.DataFrame, args: list, idx: int, fn: str,
                  what: str, default):
    """lead/lag offset/default arguments must be CONSTANT over the frame
    (SQL requires literal offsets); a per-row value would silently apply
    only its first row's value, so refuse instead."""
    if len(args) <= idx:
        return default
    col = s[args[idx]]
    if not len(col):
        return default
    first = col.iloc[0]
    if pd.isna(first):
        if col.isna().all():
            return None if what == "default" else default
        raise ValueError(f"{fn} {what} must be a constant")
    if col.nunique(dropna=False) > 1:
        raise ValueError(f"{fn} {what} must be a constant")
    return int(first) if what == "offset" else first


def _frame_agg_group(g: pd.Series, fn: str, frame: tuple) -> pd.Series:
    """One partition's ROWS-BETWEEN aggregate, vectorized: sums/counts/
    averages via prefix sums over the [i+lo, i+hi] row window; min/max
    via sliding windows (bounded frames) or running accumulation
    (UNBOUNDED PRECEDING .. CURRENT ROW)."""
    _tag, lo, hi = frame
    lo_unb = isinstance(lo, tuple)
    hi_unb = isinstance(hi, tuple)
    v = g.to_numpy(dtype=np.float64, na_value=np.nan)
    L = len(v)
    idx = np.arange(L)
    start = np.zeros(L, np.int64) if lo_unb \
        else np.clip(idx + lo, 0, L)
    end1 = np.full(L, L, np.int64) if hi_unb \
        else np.clip(idx + hi + 1, 0, L)
    if fn in ("sum", "count", "avg"):
        filled = np.nan_to_num(v)
        nn = (~np.isnan(v)).astype(np.int64)
        cs = np.concatenate([[0.0], np.cumsum(filled)])
        cc = np.concatenate([[0], np.cumsum(nn)])
        ssum = cs[end1] - cs[np.minimum(start, end1)]
        scnt = cc[end1] - cc[np.minimum(start, end1)]
        if fn == "count":
            out = scnt.astype(np.float64)
        elif fn == "sum":
            out = np.where(scnt > 0, ssum, np.nan)
        else:
            out = np.where(scnt > 0, ssum / np.maximum(scnt, 1), np.nan)
        return pd.Series(out, index=g.index)
    # min / max
    if lo_unb and not hi_unb and hi == 0:
        acc = (np.fmin.accumulate if fn == "min"
               else np.fmax.accumulate)(v)
        return pd.Series(acc, index=g.index)
    if not lo_unb and not hi_unb and hi >= lo:
        # out[i] = agg(v[i+lo : i+hi+1]): pad with NaN so every window
        # is the same width, then slide
        w = hi - lo + 1
        pad = np.concatenate([np.full(max(-lo, 0), np.nan), v,
                              np.full(max(hi, 0), np.nan)])
        sw = np.lib.stride_tricks.sliding_window_view(pad, w)
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # all-NaN windows
            out = (np.nanmin(sw, axis=1) if fn == "min"
                   else np.nanmax(sw, axis=1))
        out = out[idx + max(lo, 0)]
        empty = start >= end1                # frame fully out of range
        out = np.where(empty, np.nan, out)
        return pd.Series(out, index=g.index)
    raise ValueError(
        f"{fn} over this ROWS frame is not supported yet "
        "(supported: bounded frames, or UNBOUNDED PRECEDING .. "
        "CURRENT ROW)")


def compute_windows(df: pd.DataFrame, outer: list) -> pd.DataFrame:
    """Evaluate the window specs over the inner result, returning the
    final frame with columns in the original item order."""
    work = df.copy()
    work["__row"] = np.arange(len(work))
    cols = []
    for kind, payload in outer:
        if kind == "col":
            cols.append(payload)
            continue
        spec = payload
        out_name = spec["alias"]
        cols.append(out_name)
        part = spec["part"] or ["__const"]
        if "__const" in part and "__const" not in work.columns:
            work["__const"] = 0
        by = part + spec["order"]
        asc = [True] * len(part) + list(spec["asc"])
        s = work.sort_values(by, ascending=asc, kind="stable")
        grp = s.groupby(part, sort=False, dropna=False)
        fn = spec["func"]
        if fn == "row_number":
            vals = grp.cumcount() + 1
        elif fn in ("lead", "lag"):
            col = s[spec["args"][0]]
            off = _constant_arg(s, spec["args"], 1, fn, "offset", 1)
            keys = [s[c] for c in part]
            grp2 = col.groupby(keys, sort=False, dropna=False)
            vals = grp2.shift(off if fn == "lag" else -off)
            if len(spec["args"]) > 2:
                # 3-arg form: rows whose frame position falls outside
                # the partition get the DEFAULT, not NULL — and a NULL
                # value inside the partition stays NULL
                default = _constant_arg(s, spec["args"], 2, fn,
                                        "default", None)
                pos = s.groupby(part, sort=False, dropna=False).cumcount()
                size = pos.groupby([s[c] for c in part], sort=False,
                                   dropna=False).transform("size")
                oob = (pos < off) if fn == "lag" else (pos >= size - off)
                vals = vals.mask(oob, default)
        elif fn in ("rank", "dense_rank"):
            rn = grp.cumcount() + 1
            if spec["order"]:
                okeys = s[spec["order"]]
                newkey = okeys.ne(okeys.shift()).any(axis=1)
            else:
                newkey = pd.Series(False, index=s.index)
            first_of_part = rn == 1
            newkey = newkey | first_of_part
            if fn == "rank":
                vals = rn.where(newkey).groupby(
                    [s[c] for c in part], sort=False, dropna=False).ffill()
            else:
                vals = newkey.astype(np.int64).groupby(
                    [s[c] for c in part], sort=False, dropna=False).cumsum()
            vals = vals.astype(np.int64)
        elif spec.get("frame"):
            # explicit ROWS BETWEEN frame
            arg = spec["args"][0] if spec["args"] else None
            col = s[arg] if arg is not None \
                else pd.Series(1.0, index=s.index)
            keys = [s[c] for c in part]
            pieces = [_frame_agg_group(g, fn, spec["frame"])
                      for _k, g in col.groupby(keys, sort=False,
                                               dropna=False)]
            vals = pd.concat(pieces).reindex(s.index) if pieces \
                else pd.Series(np.nan, index=s.index)
        else:
            arg = spec["args"][0] if spec["args"] else None
            running = bool(spec["order"])
            if fn == "count" and arg is None:
                vals = (grp.cumcount() + 1 if running
                        else grp["__row"].transform("size"))
            else:
                col = s[arg]
                if col.dtype == object:
                    # NULL-bearing numerics round-trip to_pandas as
                    # object; grouped cumsum/cummin refuse object dtype.
                    # String-valued args (min/max/count over Utf8) must
                    # stay object — coerce only when everything parses.
                    try:
                        col = pd.to_numeric(col)
                    except (ValueError, TypeError):
                        pass
                keys = [s[c] for c in part]
                g = col.groupby(keys, sort=False, dropna=False)
                if running:       # SQL default frame with ORDER BY
                    # NULL rows don't contribute, but the running value
                    # at a NULL row still reflects the frame so far
                    nn = col.notna().groupby(keys, sort=False,
                                             dropna=False).cumsum()
                    filled = col.fillna(0).groupby(
                        keys, sort=False, dropna=False)
                    if fn == "sum":
                        vals = filled.cumsum().where(nn > 0)
                    elif fn == "count":
                        vals = nn
                    elif fn == "avg":
                        vals = (filled.cumsum() / nn).where(nn > 0)
                    else:          # min / max: patch NULL-row gaps
                        cm = g.cummin() if fn == "min" else g.cummax()
                        vals = cm.groupby(keys, sort=False,
                                          dropna=False).ffill().where(
                                              nn > 0)
                else:
                    vals = g.transform({"sum": "sum", "min": "min",
                                        "max": "max", "count": "count",
                                        "avg": "mean"}[fn])
        work.loc[s.index, out_name] = vals
        if spec["func"] in ("row_number", "rank", "dense_rank") or (
                spec["func"] == "count"):
            work[out_name] = work[out_name].astype(np.int64)
    out = work.sort_values("__row", kind="stable")
    return out[cols].reset_index(drop=True)


def apply_order_limit(df: pd.DataFrame, order_by, limit, offset):
    """Trailing ORDER BY/LIMIT over a host frame (set ops, window tails).
    Order expressions must reference output columns by name. NULL
    placement honors each key's nulls_first (default = YQL's
    NULL-is-smallest: first when ascending)."""
    if order_by:
        keys = []
        for o in order_by:
            if not isinstance(o.expr, ast.Name):
                raise ValueError(
                    "ORDER BY over a set/window result must reference "
                    "output columns by name")
            name = o.expr.parts[-1]
            if name not in df.columns:
                raise ValueError(f"unknown ORDER BY column {name!r}")
            nf = o.nulls_first
            if nf is None:
                nf = o.ascending
            keys.append((name, o.ascending, nf))
        # per-key NULL placement: stable sorts applied minor-key-first
        for name, asc, nf in reversed(keys):
            df = df.sort_values(name, ascending=asc, kind="stable",
                                na_position="first" if nf else "last")
    lo = offset or 0
    if limit is not None:
        df = df.iloc[lo:lo + limit]
    elif lo:
        df = df.iloc[lo:]
    return df.reset_index(drop=True)
