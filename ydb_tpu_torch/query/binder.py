"""Name resolution and expression binding: SQL AST → columnar op IR.

Combines the roles of the reference's type annotation
(`ydb/library/yql/core/type_ann/`) and the KQP OLAP lambda compiler
(`ydb/core/kqp/query_compiler/kqp_olap_compiler.cpp:33` — AST comparisons/
arithmetic → SSA assign/filter commands).

String predicates never reach the device as bytes: any pure function of a
single dictionary-encoded column compared against literals is folded into a
lookup-table Param evaluated over the dictionary host-side, and the device
program gathers through it (`take_lut`) — the TPU-native counterpart of the
reference's string UDF kernels (`ydb/library/yql/udfs/common/`,
hyperscan/re2) applied at `custom_registry.cpp:95`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ydb_tpu_torch.core import dtypes as dt
from ydb_tpu_torch.core.dictionary import Dictionary
from ydb_tpu_torch.ops import ir
from ydb_tpu_torch.sql import ast


class BindError(Exception):
    pass


AGG_NAMES = {"sum", "count", "min", "max", "avg", "some"}

_TYPE_MAP = {
    "int64": dt.Kind.INT64, "bigint": dt.Kind.INT64, "int": dt.Kind.INT32,
    "serial": dt.Kind.INT64, "bigserial": dt.Kind.INT64,
    "int32": dt.Kind.INT32, "integer": dt.Kind.INT32, "int16": dt.Kind.INT16,
    "int8": dt.Kind.INT8, "uint64": dt.Kind.UINT64, "uint32": dt.Kind.UINT32,
    "uint16": dt.Kind.UINT16, "uint8": dt.Kind.UINT8,
    "double": dt.Kind.FLOAT64, "float64": dt.Kind.FLOAT64,
    "float": dt.Kind.FLOAT32, "float32": dt.Kind.FLOAT32,
    "real": dt.Kind.FLOAT64, "decimal": dt.Kind.FLOAT64,
    "numeric": dt.Kind.FLOAT64,
    "bool": dt.Kind.BOOL, "boolean": dt.Kind.BOOL,
    "date": dt.Kind.DATE32, "date32": dt.Kind.DATE32,
    "timestamp": dt.Kind.TIMESTAMP, "datetime": dt.Kind.TIMESTAMP,
    "utf8": dt.Kind.STRING, "string": dt.Kind.STRING, "text": dt.Kind.STRING,
    "varchar": dt.Kind.STRING, "char": dt.Kind.STRING,
}


def sql_type_to_dtype(name: str, not_null: bool = False) -> dt.DType:
    kind = _TYPE_MAP.get(name.lower())
    if kind is None:
        raise BindError(f"unsupported type {name!r}")
    return dt.DType(kind, nullable=not not_null)


def parse_date_literal(s: str) -> int:
    m = re.fullmatch(r"(\d{4})-(\d{2})-(\d{2})", s.strip())
    if not m:
        raise BindError(f"bad date literal {s!r}")
    from ydb_tpu_torch.bench.tpch_gen import date32
    return date32(int(m.group(1)), int(m.group(2)), int(m.group(3)))


def _civil_from_days(days: int) -> tuple[int, int, int]:
    z = days + 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    return (y + 1 if m <= 2 else y, m, d)


def shift_date(days: int, qty: int, unit: str) -> int:
    from ydb_tpu_torch.bench.tpch_gen import date32
    if unit in ("day", "days"):
        return days + qty
    y, m, d = _civil_from_days(days)
    if unit in ("month", "months"):
        t = (y * 12 + (m - 1)) + qty
        y, m = divmod(t, 12)
        m += 1
    elif unit in ("year", "years"):
        y += qty
    else:
        raise BindError(f"unsupported interval unit {unit!r}")
    leap = (y % 4 == 0 and y % 100 != 0) or y % 400 == 0
    month_len = [31, 29 if leap else 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
    return date32(y, m, min(d, month_len[m - 1]))


def like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


@dataclass
class ColumnBinding:
    internal: str                  # internal column name in the pipeline
    dtype: dt.DType
    dictionary: Optional[Dictionary] = None


@dataclass
class Scope:
    """alias.column and unqualified-column resolution."""
    by_alias: dict = field(default_factory=dict)   # alias -> {col -> ColumnBinding}

    def add(self, alias: str, col: str, binding: ColumnBinding):
        self.by_alias.setdefault(alias, {})[col] = binding

    def resolve(self, parts: tuple) -> ColumnBinding:
        if len(parts) == 2:
            cols = self.by_alias.get(parts[0])
            if cols is None or parts[1] not in cols:
                raise BindError(f"unknown column {'.'.join(parts)}")
            return cols[parts[1]]
        name = parts[0]
        hits = [cols[name] for cols in self.by_alias.values() if name in cols]
        if not hits:
            raise BindError(f"unknown column {name}")
        if len(hits) > 1:
            raise BindError(f"ambiguous column {name}")
        return hits[0]

    def try_resolve(self, parts: tuple) -> Optional[ColumnBinding]:
        try:
            return self.resolve(parts)
        except BindError:
            return None

    def by_internal(self, internal: str) -> Optional[ColumnBinding]:
        for cols in self.by_alias.values():
            for b in cols.values():
                if b.internal == internal:
                    return b
        return None


class ParamPool:
    """Array/scalar runtime parameters collected during binding."""

    def __init__(self, prefix: str = "p"):
        self.values: dict = {}
        self._n = 0
        self._prefix = prefix
        # param name -> Dictionary for derived string columns (the LUT maps
        # source codes to codes of this new dictionary)
        self.param_dicts: dict = {}

    def add(self, value, dtype: dt.DType, is_array: bool = False) -> ir.Param:
        name = f"{self._prefix}{self._n}"
        self._n += 1
        self.values[name] = value
        return ir.Param(name, dtype, is_array)


# -- constant folding ------------------------------------------------------


@dataclass(frozen=True)
class _FoldedConst:
    value: object
    dtype: dt.DType
    hint: Optional[str] = None     # "date" | "interval_<unit>"


_INT_KINDS = (dt.Kind.INT8, dt.Kind.INT16, dt.Kind.INT32, dt.Kind.INT64,
              dt.Kind.UINT8, dt.Kind.UINT16, dt.Kind.UINT32, dt.Kind.UINT64,
              dt.Kind.TIMESTAMP)


def _coerce_text_literal(text: str, target: dt.DType):
    """Re-type a text literal into a non-string column's domain (PG text
    protocol: every bound parameter arrives as a string). None = the
    text does not parse as the target type."""
    k = target.kind
    try:
        if k in _INT_KINDS:
            if re.fullmatch(r"[+-]?\d+", text.strip()):
                return ast.Literal(int(text))
        elif k in (dt.Kind.FLOAT64, dt.Kind.FLOAT32):
            return ast.Literal(float(text))
        elif k is dt.Kind.BOOL:
            lv = text.strip().lower()
            if lv in ("t", "true", "1", "on", "y", "yes"):
                return ast.Literal(True)
            if lv in ("f", "false", "0", "off", "n", "no"):
                return ast.Literal(False)
        elif k is dt.Kind.DATE32:
            if re.fullmatch(r"\d{4}-\d{2}-\d{2}", text.strip()):
                return ast.Literal(text.strip(), type_hint="date")
    except ValueError:
        return None
    return None


def _numify_folded(f: "_FoldedConst") -> "_FoldedConst":
    """A folded STRING constant that parses as a number becomes that
    number (arithmetic context only — comparisons coerce by column)."""
    if not isinstance(f.value, str) or f.hint is not None:
        return f
    s = f.value.strip()
    if re.fullmatch(r"[+-]?\d+", s):
        return _FoldedConst(int(s), dt.DType(dt.Kind.INT64, False))
    if re.fullmatch(r"[+-]?\d*\.\d+([eE][+-]?\d+)?", s):
        return _FoldedConst(float(s), dt.DType(dt.Kind.FLOAT64, False))
    return f


def _try_fold(e: ast.Expr):
    """Literal / date / interval constant folding (host-side, bind time)."""
    if isinstance(e, ast.Literal):
        if e.type_hint == "date":
            return _FoldedConst(parse_date_literal(e.value),
                                dt.DType(dt.Kind.DATE32, False), "date")
        if e.type_hint and e.type_hint.startswith("interval_"):
            return _FoldedConst(e.value, dt.DType(dt.Kind.INT64, False),
                                e.type_hint)
        if isinstance(e.value, bool):
            return _FoldedConst(e.value, dt.DType(dt.Kind.BOOL, False))
        if isinstance(e.value, int):
            return _FoldedConst(e.value, dt.DType(dt.Kind.INT64, False))
        if isinstance(e.value, float):
            return _FoldedConst(e.value, dt.DType(dt.Kind.FLOAT64, False))
        if isinstance(e.value, str):
            return _FoldedConst(e.value, dt.DType(dt.Kind.STRING, False))
        return None
    if isinstance(e, ast.UnaryOp) and e.op == "-":
        f = _try_fold(e.arg)
        if f is not None and isinstance(f.value, (int, float)):
            return _FoldedConst(-f.value, f.dtype, f.hint)
        return None
    if isinstance(e, ast.Cast):
        f = _try_fold(e.arg)
        if f is None:
            return None
        if e.to == "date" and isinstance(f.value, str):
            return _FoldedConst(parse_date_literal(f.value),
                                dt.DType(dt.Kind.DATE32, False), "date")
        try:
            target = sql_type_to_dtype(e.to, not_null=True)
        except BindError:
            return None
        if target.is_numeric and isinstance(f.value, (int, float)):
            v = float(f.value) if target.is_float else int(f.value)
            return _FoldedConst(v, target)
        return None
    if isinstance(e, ast.BinOp) and e.op in ("+", "-", "*", "/"):
        lf, rf = _try_fold(e.left), _try_fold(e.right)
        if lf is None or rf is None:
            return None
        # date ± interval (interval + date only for '+')
        pairs = [(lf, rf)] + ([(rf, lf)] if e.op == "+" else [])
        for a, b in pairs:
            if a.hint == "date" and b.hint and b.hint.startswith("interval_"):
                unit = b.hint.split("_", 1)[1]
                qty = b.value if e.op == "+" else -b.value
                return _FoldedConst(shift_date(a.value, qty, unit),
                                    dt.DType(dt.Kind.DATE32, False), "date")
        # text-protocol parameter in arithmetic ('5' + 1): a numeric-
        # looking string operand participates as its number
        lf, rf = _numify_folded(lf), _numify_folded(rf)
        if isinstance(lf.value, (int, float)) and isinstance(rf.value, (int, float)) \
                and lf.hint is None and rf.hint is None:
            x, y = lf.value, rf.value
            v = (x + y if e.op == "+" else x - y if e.op == "-"
                 else x * y if e.op == "*" else x / y)
            kind = dt.Kind.FLOAT64 if isinstance(v, float) else dt.Kind.INT64
            return _FoldedConst(v, dt.DType(kind, False))
        return None
    return None


# -- string folding (dictionary LUTs) --------------------------------------


def _string_fn(e: ast.Expr, scope: Scope, udfs=None):
    """If `e` is a pure function of ONE dictionary-encoded column returning a
    python string, return (binding, fn: str|None -> str|None). `udfs`:
    optional UDF registry — string-returning UDFs compose with the
    builtins in EITHER direction (substring(url_host(x)) and
    url_host(substring(x)) both work)."""
    if isinstance(e, ast.Name):
        b = scope.try_resolve(e.parts)
        if b is not None and b.dtype.is_string and b.dictionary is not None:
            return b, (lambda s: s)
        return None
    if isinstance(e, ast.FuncCall) and e.name == "substring":
        inner = _string_fn(e.args[0], scope, udfs)
        if inner is None:
            return None
        b, f = inner
        start_f = _try_fold(e.args[1])
        if start_f is None:
            return None
        start = int(start_f.value) - 1  # SQL 1-based
        length = None
        if len(e.args) > 2:
            len_f = _try_fold(e.args[2])
            if len_f is None:
                return None
            length = int(len_f.value)

        def g(s, f=f, start=start, length=length):
            s = f(s)
            if s is None:
                return None
            return s[start:start + length] if length is not None else s[start:]
        return b, g
    if isinstance(e, ast.FuncCall) and e.name in _STR_UNARY \
            and len(e.args) == 1:
        inner = _string_fn(e.args[0], scope, udfs)
        if inner is None:
            return None
        b, f = inner
        g0 = _STR_UNARY[e.name]
        return b, (lambda s, f=f, g0=g0:
                   None if f(s) is None else g0(f(s)))
    if isinstance(e, ast.FuncCall) and e.name == "replace" \
            and len(e.args) == 3:
        inner = _string_fn(e.args[0], scope, udfs)
        old_f, new_f = _try_fold(e.args[1]), _try_fold(e.args[2])
        if inner is None or old_f is None or new_f is None:
            return None
        b, f = inner
        return b, (lambda s, f=f, o=str(old_f.value), n=str(new_f.value):
                   None if f(s) is None else f(s).replace(o, n))
    if isinstance(e, ast.FuncCall) and e.name == "regexp_replace" \
            and len(e.args) == 3:
        inner = _string_fn(e.args[0], scope, udfs)
        pat_f, rep_f = _try_fold(e.args[1]), _try_fold(e.args[2])
        if inner is None or pat_f is None or rep_f is None:
            return None
        b, f = inner
        rx = re.compile(str(pat_f.value))
        return b, (lambda s, f=f, rx=rx, r=str(rep_f.value):
                   None if f(s) is None else rx.sub(r, f(s)))
    if isinstance(e, ast.BinOp) and e.op == "||":
        lf = _try_fold(e.right)
        if lf is not None and isinstance(lf.value, str):
            inner = _string_fn(e.left, scope, udfs)
            if inner is not None:
                b, f = inner
                return b, (lambda s, f=f, suf=lf.value:
                           None if f(s) is None else f(s) + suf)
        rf = _try_fold(e.left)
        if rf is not None and isinstance(rf.value, str):
            inner = _string_fn(e.right, scope, udfs)
            if inner is not None:
                b, f = inner
                return b, (lambda s, f=f, pre=rf.value:
                           None if f(s) is None else pre + f(s))
        return None
    # string-returning UDFs compose like any builtin string transform
    if isinstance(e, ast.FuncCall) and udfs is not None and e.name in udfs:
        u = udfs.get(e.name)
        if u.returns != "string" or not e.args \
                or not (u.min_args <= len(e.args) <= u.max_args):
            if u.returns == "string" and e.args:
                raise BindError(f"udf {u.name} takes {u.min_args}"
                                f"..{u.max_args} arguments")
            return None
        inner = _string_fn(e.args[0], scope, udfs)
        if inner is None:
            return None
        b, f = inner
        lits = []
        for a in e.args[1:]:
            lf2 = _try_fold(a)
            if lf2 is None:
                return None
            lits.append(lf2.value)

        def g(s, f=f, fn=u.fn, lits=tuple(lits)):
            return fn(f(s) if s is not None else None, *lits)
        return b, g
    return None


# pure python string transforms usable inside the dictionary-LUT lane
# (the analog of the reference's String/Unicode UDF modules,
# ydb/library/yql/udfs/common/string)
_STR_UNARY: dict[str, Callable] = {
    "lower": str.lower,
    "upper": str.upper,
    "trim": str.strip,
    "ltrim": str.lstrip,
    "rtrim": str.rstrip,
}


def _lut_pred_vec(binding: ColumnBinding, series_pred: Callable,
                  pool: ParamPool) -> ir.Expr:
    """Vectorized bool-LUT over a RAW dictionary column: `series_pred`
    maps a pandas Series of the value set to a bool mask in one C-engine
    pass — the dictionary-degeneracy answer for URL-cardinality columns
    (reference: hyperscan/re2 UDFs, `ydb/library/yql/udfs/common/`)."""
    import pandas as pd
    d = binding.dictionary
    vals = d.values_array()
    if len(vals):
        m = series_pred(pd.Series(vals, dtype=object))
        lut = m.fillna(False).to_numpy(dtype=np.bool_)
    else:
        lut = np.zeros(1, dtype=np.bool_)
    p = pool.add(lut, dt.DType(dt.Kind.BOOL, False), is_array=True)
    return ir.call("take_lut", ir.Col(binding.internal), p)


def _lut_pred(binding: ColumnBinding, fn: Callable, pool: ParamPool) -> ir.Expr:
    """bool-LUT gather over a dictionary column."""
    d = binding.dictionary
    lut = np.zeros(max(len(d), 1), dtype=np.bool_)
    for i, v in enumerate(d.values_array()):
        lut[i] = bool(fn(v))
    p = pool.add(lut, dt.DType(dt.Kind.BOOL, False), is_array=True)
    return ir.call("take_lut", ir.Col(binding.internal), p)


def _lut_typed(binding: ColumnBinding, fn: Callable, pool: ParamPool,
               kind) -> ir.Expr:
    """Typed nullable LUT gather: value + validity LUTs over a
    dictionary column — fn returning None lands as SQL NULL (the int64/
    float64 UDF result path; `_lut_int` keeps its non-null contract for
    length() and friends)."""
    d = binding.dictionary
    n = max(len(d), 1)
    npdt = np.int64 if kind is dt.Kind.INT64 else np.float64
    vals = np.zeros(n, dtype=npdt)
    ok = np.zeros(n, dtype=np.bool_)
    for i, v in enumerate(d.values_array()):
        r = fn(v)
        if r is not None:
            vals[i] = r
            ok[i] = True
    pv = pool.add(vals, dt.DType(kind, False), is_array=True)
    pb = pool.add(ok, dt.DType(dt.Kind.BOOL, False), is_array=True)
    val_e = ir.call("take_lut", ir.Col(binding.internal), pv)
    ok_e = ir.call("take_lut", ir.Col(binding.internal), pb)
    return ir.call("if", ok_e, val_e, ir.call("typed_null", val_e))


def _lut_int(binding: ColumnBinding, fn: Callable, pool: ParamPool) -> ir.Expr:
    """int64-LUT gather over a dictionary column (length() and friends)."""
    d = binding.dictionary
    lut = np.zeros(max(len(d), 1), dtype=np.int64)
    for i, v in enumerate(d.values_array()):
        r = fn(v)
        lut[i] = 0 if r is None else int(r)
    p = pool.add(lut, dt.DType(dt.Kind.INT64, False), is_array=True)
    return ir.call("take_lut", ir.Col(binding.internal), p)


# -- the binder ------------------------------------------------------------


class ExprBinder:
    """Binds row-level AST expressions over a Scope into op-IR."""

    def __init__(self, scope: Scope, pool: ParamPool, udfs=None):
        self.scope = scope
        self.pool = pool
        # UDF registry (`query/udf.py`): unknown functions resolve here
        # last — scalar string functions evaluated per DISTINCT value
        # into LUTs the device gathers through
        self.udfs = udfs

    def bind(self, e: ast.Expr) -> ir.Expr:
        f = _try_fold(e)
        if f is not None:
            if isinstance(f.value, str):
                raise BindError("string literal outside a string comparison")
            return ir.Const(f.value, f.dtype)

        if isinstance(e, ast.Name):
            return ir.Col(self.scope.resolve(e.parts).internal)

        if isinstance(e, ast.BoundParam):
            p = ir.Param(e.name, e.dtype)
            if e.dtype.nullable:
                # scalar-subquery params can be NULL: the executor supplies
                # a `<name>__valid` companion and a typed zero placeholder,
                # so NULL propagates through ANY dtype (not just the old
                # NaN-coercion trick that only worked for float compares)
                valid = ir.Param(e.name + "__valid",
                                 dt.DType(dt.Kind.BOOL, False))
                return ir.call("if", valid, p, ir.call("typed_null", p))
            return p

        # string-VALUED expression (substring/concat of a dict column) used
        # as a value (group key / output): map source codes to a fresh
        # dictionary via an int32 LUT. (Names returned above.)
        sf = _string_fn(e, self.scope, self.udfs)
        if sf is not None:
            return self._derived_string(e, sf)

        if isinstance(e, ast.BinOp):
            return self._bin(e)

        if isinstance(e, ast.UnaryOp):
            if e.op == "not":
                return ir.call("not", self.bind(e.arg))
            if e.op == "-":
                return ir.call("neg", self.bind(e.arg))
            raise BindError(f"unary {e.op}")

        if isinstance(e, ast.Like):
            sf = _string_fn(e.arg, self.scope, self.udfs)
            if sf is None:
                raise BindError("LIKE on a non-string expression")
            b, fn = sf
            if isinstance(e.arg, ast.Name) and b.dictionary is not None:
                # identity transform: evaluate the pattern over the whole
                # dictionary VECTORIZED (pandas str engine) — the Python
                # per-value loop is minutes at URL-scale cardinality
                rx_s = like_to_regex(e.pattern)
                pred = _lut_pred_vec(
                    b, lambda s: s.str.fullmatch(rx_s, flags=re.DOTALL),
                    self.pool)
            else:
                rx = re.compile(like_to_regex(e.pattern), re.DOTALL)
                pred = _lut_pred(
                    b, lambda s: s is not None and fn(s) is not None
                    and rx.fullmatch(fn(s)) is not None, self.pool)
            return ir.call("not", pred) if e.negated else pred

        if isinstance(e, ast.Between):
            lo, hi = self._coerce_vs(e.arg, e.lo), self._coerce_vs(e.arg, e.hi)
            arg = self.bind(e.arg)
            lo, hi = self.bind(lo), self.bind(hi)
            expr = ir.call("and", ir.call("ge", arg, lo), ir.call("le", arg, hi))
            return ir.call("not", expr) if e.negated else expr

        if isinstance(e, ast.InList):
            from dataclasses import replace as _dc_replace
            e = _dc_replace(
                e, items=tuple(self._coerce_vs(e.arg, it) for it in e.items))
            sf = _string_fn(e.arg, self.scope, self.udfs)
            if sf is not None:
                b, fn = sf
                values = set()
                for item in e.items:
                    f2 = _try_fold(item)
                    if f2 is None or not isinstance(f2.value, str):
                        sf = None
                        break
                    values.add(f2.value)
                if sf is not None:
                    pred = _lut_pred(
                        b, lambda s: fn(s) in values if s is not None else False,
                        self.pool)
                    return ir.call("not", pred) if e.negated else pred
            arg = self.bind(e.arg)
            expr = None
            for item in e.items:
                term = ir.call("eq", arg, self.bind(item))
                expr = term if expr is None else ir.call("or", expr, term)
            if expr is None:
                expr = ir.Const(False, dt.DType(dt.Kind.BOOL, False))
            return ir.call("not", expr) if e.negated else expr

        if isinstance(e, ast.IsNull):
            arg = self.bind(e.arg)
            return ir.call("is_not_null" if e.negated else "is_null", arg)

        if isinstance(e, ast.Case):
            return self._case(e)

        if isinstance(e, ast.Cast):
            arg = self.bind(e.arg)
            target = sql_type_to_dtype(e.to)
            return ir.call("cast", arg, to=target.kind.value)

        if isinstance(e, ast.FuncCall):
            return self._func(e)

        raise BindError(f"unsupported expression {type(e).__name__}")

    # -- helpers -----------------------------------------------------------

    def _derived_string(self, e: ast.Expr, sf) -> ir.Expr:
        from ydb_tpu_torch.core.dictionary import Dictionary
        b, fn = sf
        # memoized on the AST: repeated bindings (group key vs SELECT item
        # vs ORDER BY) must yield the IDENTICAL expression, or group-key
        # matching would fail on the fresh param name
        cache = self.pool.__dict__.setdefault("_derived_cache", {})
        ckey = (repr(e), b.internal)
        hit = cache.get(ckey)
        if hit is not None:
            return hit
        new_dict = Dictionary()
        src = b.dictionary.values_array()
        lut = np.full(max(len(src), 1), -1, dtype=np.int32)
        for i, v in enumerate(src):
            r = fn(v)
            if r is not None:
                lut[i] = new_dict.encode([r])[0]
        p = self.pool.add(lut, dt.DType(dt.Kind.STRING, False), is_array=True)
        self.pool.param_dicts[p.name] = new_dict
        # null_neg: a -1 LUT entry means the transform produced NULL for
        # that (non-null) input — validity must reflect it
        out = ir.call("take_lut", ir.Col(b.internal), p, null_neg=True)
        cache[ckey] = out
        return out

    _BIN_KERNEL = {"+": "add", "-": "sub", "*": "mul", "/": "div", "%": "mod",
                   "=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt",
                   ">=": "ge", "and": "and", "or": "or"}

    def _bin(self, e: ast.BinOp) -> ir.Expr:
        # bare string column = literal → code comparison (prunable by stats)
        if e.op in ("=", "<>"):
            for a, bexp in ((e.left, e.right), (e.right, e.left)):
                if isinstance(a, ast.Name):
                    cb = self._maybe_string_col(a)
                    lit = _try_fold(bexp)
                    if cb is not None and cb.dictionary is not None \
                            and lit is not None and isinstance(lit.value, str):
                        code = cb.dictionary.encode_existing(lit.value)
                        kern = "eq" if e.op == "=" else "ne"
                        return ir.call(kern, ir.Col(cb.internal),
                                       ir.Const(code, dt.DType(dt.Kind.STRING, False)))
        # PG-driver literal coercion (ADVICE r4): text-protocol clients
        # bind EVERY parameter as text (pgwire oid 0), so '123' compared
        # against a numeric/date column means the value in the column's
        # domain, not the string — re-type the literal before string
        # binding sees it. Unparseable text against a non-string column
        # is a clear bind error instead of a silent string comparison.
        if e.op in ("=", "<>", "<", "<=", ">", ">="):
            left = self._coerce_vs(e.right, e.left)
            right = self._coerce_vs(e.left, e.right)
            if left is not e.left or right is not e.right:
                e = ast.BinOp(e.op, left, right)
        # string comparisons fold through the dictionary
        if e.op in ("=", "<>", "<", "<=", ">", ">="):
            for a, bexp, flip in ((e.left, e.right, False), (e.right, e.left, True)):
                sf = _string_fn(a, self.scope, self.udfs)
                lit = _try_fold(bexp)
                if sf is not None and lit is not None and isinstance(lit.value, str):
                    b, fn = sf
                    op = e.op
                    if flip:
                        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
                    tgt = lit.value
                    cmpf = {"=": lambda s: s == tgt, "<>": lambda s: s != tgt,
                            "<": lambda s: s < tgt, "<=": lambda s: s <= tgt,
                            ">": lambda s: s > tgt, ">=": lambda s: s >= tgt}[op]
                    return _lut_pred(
                        b, lambda s: s is not None and fn(s) is not None
                        and cmpf(fn(s)), self.pool)
            # string col = string col (shared dictionary only); any other
            # comparison touching a string-valued side must not fall
            # through to raw code comparison (codes from different
            # dictionaries are incomparable)
            lsf = _string_fn(e.left, self.scope, self.udfs)
            rsf = _string_fn(e.right, self.scope, self.udfs)
            if lsf is not None or rsf is not None:
                if e.op in ("=", "<>") and lsf is not None and rsf is not None:
                    lb, rb = lsf[0], rsf[0]
                    if isinstance(e.left, ast.Name) \
                            and isinstance(e.right, ast.Name) \
                            and lb.dictionary is rb.dictionary:
                        pass   # same-dictionary code equality is exact
                    else:
                        raise BindError(
                            "string comparison across different "
                            "dictionaries/expressions is not supported yet")
                else:
                    raise BindError(
                        "unsupported string comparison (fold it against a "
                        "literal, or compare same-dictionary columns)")
        kern = self._BIN_KERNEL.get(e.op)
        if kern is None:
            raise BindError(f"operator {e.op}")
        return ir.call(kern, self.bind(e.left), self.bind(e.right))

    def _coerce_vs(self, col_expr: ast.Expr, lit_expr: ast.Expr) -> ast.Expr:
        """Re-type a text literal compared against a non-string column
        (PG text protocol sends every parameter as text). Returns the
        rewritten literal, or `lit_expr` itself when no coercion applies."""
        if not isinstance(col_expr, ast.Name):
            return lit_expr
        cb = self.scope.try_resolve(col_expr.parts)
        lit = _try_fold(lit_expr)
        if cb is None or cb.dtype.is_string or lit is None \
                or not isinstance(lit.value, str) or lit.hint is not None:
            return lit_expr
        new = _coerce_text_literal(lit.value, cb.dtype)
        if new is None:
            raise BindError(
                f"cannot compare column {col_expr.parts[-1]!r} "
                f"({cb.dtype.kind.value}) with string literal "
                f"{lit.value!r}")
        return new

    def _maybe_string_col(self, e: ast.Expr) -> Optional[ColumnBinding]:
        if isinstance(e, ast.Name):
            b = self.scope.try_resolve(e.parts)
            if b is not None and b.dtype.is_string:
                return b
        return None

    def _case(self, e: ast.Case) -> ir.Expr:
        sc = self._maybe_string_case(e)
        if sc is not None:
            return sc
        whens = []
        for cond, res in e.whens:
            if e.operand is not None:
                cond = ast.BinOp("=", e.operand, cond)
            whens.append((self.bind(cond), self.bind(res)))
        if e.default is not None:
            out = self.bind(e.default)
        else:
            out = ir.call("typed_null", whens[-1][1])
        for cond, res in reversed(whens):
            out = ir.call("if", cond, res, out)
        return out

    def _maybe_string_case(self, e: ast.Case) -> Optional[ir.Expr]:
        """String-valued CASE: branch values are string expressions of one
        source column and/or string literals. All branches encode into ONE
        fresh derived dictionary; the device selects int32 codes with the
        `if` kernel (the string CASE in ClickBench Q39's Src column).
        Mirrors how the reference keeps CASE over utf8 inside the block
        engine via dictionary-encoded arrays."""
        from ydb_tpu_torch.core.dictionary import Dictionary
        branches = [res for _, res in e.whens]
        if e.default is not None:
            branches.append(e.default)
        kinds = []               # ("lit", str) | ("col", binding, fn)
        src_binding = None
        any_string = False
        for r in branches:
            f = _try_fold(r)
            if f is not None and isinstance(f.value, str):
                kinds.append(("lit", f.value))
                any_string = True
                continue
            sf = _string_fn(r, self.scope)
            if sf is None:
                return None      # non-string branch → normal CASE path
            b, fn = sf
            if src_binding is not None and b.internal != src_binding.internal:
                raise BindError(
                    "string CASE branches must derive from one column")
            src_binding = b
            kinds.append(("col", b, fn))
            any_string = True
        if not any_string:
            return None
        cache = self.pool.__dict__.setdefault("_derived_cache", {})
        ckey = ("case", repr(e))
        hit = cache.get(ckey)
        if hit is not None:
            return hit
        nd = Dictionary()
        irs = []
        lut_params = []
        for kind in kinds:
            if kind[0] == "lit":
                code = int(nd.encode([kind[1]])[0])
                irs.append(ir.Const(code, dt.DType(dt.Kind.STRING, False)))
            else:
                _, b, fn = kind
                src = b.dictionary.values_array()
                lut = np.full(max(len(src), 1), -1, dtype=np.int32)
                for i, v in enumerate(src):
                    r = fn(v)
                    if r is not None:
                        lut[i] = nd.encode([r])[0]
                p = self.pool.add(lut, dt.DType(dt.Kind.STRING, False),
                                  is_array=True)
                lut_params.append(p.name)
                irs.append(ir.call("take_lut", ir.Col(b.internal), p))
        default_ir = irs.pop() if e.default is not None else ir.Const(
            -1, dt.DType(dt.Kind.STRING, False))
        out = default_ir
        conds = []
        for cond, _ in e.whens:
            if e.operand is not None:
                cond = ast.BinOp("=", e.operand, cond)
            conds.append(self.bind(cond))
        for cond_ir, res_ir in zip(reversed(conds), reversed(irs)):
            out = ir.call("if", cond_ir, res_ir, out)
        for pname in lut_params:
            self.pool.param_dicts[pname] = nd
        # all-literal CASE has no take_lut param to carry the dictionary —
        # key it on the root IR node identity (the memo cache returns this
        # exact object for every rebinding)
        self.pool.__dict__.setdefault("expr_dicts", {})[id(out)] = nd
        cache[ckey] = out
        return out

    def _func(self, e: ast.FuncCall) -> ir.Expr:
        name = e.name
        if name in AGG_NAMES:
            raise BindError(f"aggregate {name} not allowed here")
        # string-valued if/coalesce must share ONE derived dictionary —
        # route through the string-CASE path (independent dictionaries
        # would decode each other's codes)
        if name == "if" and len(e.args) == 3:
            sc = self._maybe_string_case(ast.Case(
                None, ((e.args[0], e.args[1]),), e.args[2]))
            if sc is not None:
                return sc
        if name == "coalesce" and len(e.args) >= 2:
            sc = self._maybe_string_case(ast.Case(
                None, tuple((ast.IsNull(a, negated=True), a)
                            for a in e.args[:-1]), e.args[-1]))
            if sc is not None:
                return sc
        simple = {"year": "year", "month": "month", "day": "day_of_month",
                  "hour": "hour_of_day", "minute": "minute_of_hour",
                  "second": "second_of_minute",
                  "abs": "abs", "floor": "floor", "ceil": "ceil",
                  "sqrt": "sqrt", "exp": "exp", "ln": "ln", "round": "round",
                  "coalesce": "coalesce", "if": "if"}
        if name in simple:
            return ir.call(simple[name], *[self.bind(a) for a in e.args])
        if name == "power":
            return ir.call("pow", *[self.bind(a) for a in e.args])
        if name == "length":
            if len(e.args) != 1:
                raise BindError("length takes one argument")
            sf = _string_fn(e.args[0], self.scope, self.udfs)
            if sf is None:
                raise BindError("length needs a string expression")
            b, fn = sf
            return _lut_int(
                b, lambda s: None if s is None or fn(s) is None
                else len(fn(s)), self.pool)
        if name in ("startswith", "endswith", "contains_string"):
            sf = _string_fn(e.args[0], self.scope, self.udfs)
            lit = _try_fold(e.args[1])
            if sf is None or lit is None:
                raise BindError(f"{name} needs a string column and literal")
            b, fn = sf
            tgt = lit.value
            if isinstance(e.args[0], ast.Name) and b.dictionary is not None:
                # raw column: vectorized over the whole dictionary
                vec = {"startswith":
                       lambda s: s.str.startswith(tgt),
                       "endswith": lambda s: s.str.endswith(tgt),
                       "contains_string":
                       lambda s: s.str.contains(tgt, regex=False)}[name]
                return _lut_pred_vec(b, vec, self.pool)
            test = {"startswith": lambda s: s.startswith(tgt),
                    "endswith": lambda s: s.endswith(tgt),
                    "contains_string": lambda s: tgt in s}[name]
            return _lut_pred(b, lambda s: s is not None and test(fn(s)),
                             self.pool)
        if self.udfs is not None and name in self.udfs:
            return self._bind_udf(self.udfs.get(name), e)
        raise BindError(f"unknown function {name}")

    def _bind_udf(self, u, e: ast.FuncCall) -> ir.Expr:
        """Scalar UDF over a dictionary column: evaluate once per
        DISTINCT value host-side, gather through a LUT on device
        (`query/udf.py` — the loadable-UDF seat, re2/url/json/ip udfs).
        First arg = string expression of one dictionary column; the rest
        fold to literals."""
        if not (u.min_args <= len(e.args) <= u.max_args):
            raise BindError(f"udf {u.name} takes {u.min_args}"
                            f"..{u.max_args} arguments")
        lit0 = _try_fold(e.args[0])
        if lit0 is not None and isinstance(lit0.value, str) \
                and u.returns != "string":
            # constant input: evaluate once at bind time
            lits0 = []
            for a in e.args[1:]:
                lf = _try_fold(a)
                if lf is None:
                    raise BindError(f"udf {u.name}: arguments after the "
                                    "first must fold to literals")
                lits0.append(lf.value)
            try:
                r = u.fn(lit0.value, *lits0)
            except Exception as ex:          # noqa: BLE001 — user code
                raise BindError(f"udf {u.name} failed: "
                                f"{type(ex).__name__}: {ex}") from ex
            kind0 = {"int64": dt.Kind.INT64, "float64": dt.Kind.FLOAT64,
                     "bool": dt.Kind.BOOL}[u.returns]
            if r is None:
                return ir.call("typed_null",
                               ir.Const(0, dt.DType(kind0, False)))
            # coerce like the LUT paths do (bool() / int() / float())
            r = {"int64": int, "float64": float,
                 "bool": bool}[u.returns](r)
            return ir.Const(r, dt.DType(kind0, False))
        sf = _string_fn(e.args[0], self.scope, self.udfs)
        if sf is None:
            raise BindError(
                f"udf {u.name} needs a dictionary-encoded string "
                f"expression as its first argument")
        b, f = sf
        lits = []
        for a in e.args[1:]:
            lf = _try_fold(a)
            if lf is None:
                raise BindError(f"udf {u.name}: arguments after the "
                                "first must fold to literals")
            lits.append(lf.value)

        def call(s, f=f, fn=u.fn, lits=tuple(lits), name=u.name):
            inner = f(s) if s is not None else None
            try:
                return fn(inner, *lits)
            except Exception as ex:          # noqa: BLE001 — user code
                raise BindError(
                    f"udf {name} failed on {inner!r}: "
                    f"{type(ex).__name__}: {ex}") from ex

        if u.returns == "string":
            return self._derived_string(e, (b, call))
        if u.returns == "bool":
            # predicate LUT: fn-None and input-NULL both read as FALSE
            return _lut_pred(b, lambda s: bool(call(s)), self.pool)
        kind = dt.Kind.INT64 if u.returns == "int64" else dt.Kind.FLOAT64
        return _lut_typed(b, call, self.pool, kind)
