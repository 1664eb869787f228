"""Scalar kernel registry — the block-function vocabulary.

Each kernel has one abstract semantics and two lowerings selected by the
array namespace (`numpy` for the CPU oracle, `jax.numpy` for the XLA path) —
the analog of the reference's dual scalar/block kernel surface
(`ydb/library/yql/minikql/invoke_builtins/` exposed as Arrow kernels via
`mkql_block_impl.h:33` and the ColumnShard custom registry
`ydb/core/formats/arrow/custom_registry.cpp:95`).

Null semantics:
  * ``propagate`` — result row is null iff any argument row is null
    (arithmetic, comparisons, math, casts, date extraction);
  * ``kleene``    — SQL three-valued AND/OR;
  * ``custom``    — kernel computes its own validity (coalesce, if,
    is_null, dictionary LUT gathers).

Values are (data, valid) pairs; ``valid is None`` means all-valid. Kernels
never branch on data-dependent Python conditions, so both lowerings trace
under ``jax.jit``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ydb_tpu_torch.core.dtypes import (
    BOOL, DType, FLOAT64, INT32, Kind, common_numeric,
)
from ydb_tpu_torch.ops.torch_ns import astype as _astype


@dataclass
class Kernel:
    name: str
    result_dtype: Callable       # (arg_dtypes, extra) -> DType
    impl: Callable               # (xp, datas, extra) -> data           [propagate]
    null_mode: str = "propagate"  # propagate | kleene_and | kleene_or | custom
    impl_nv: Optional[Callable] = None  # (xp, (data, valid) pairs, extra) -> (data, valid)


KERNELS: dict[str, Kernel] = {}


def _reg(name, result_dtype, impl=None, null_mode="propagate", impl_nv=None):
    KERNELS[name] = Kernel(name, result_dtype, impl, null_mode, impl_nv)


# -- dtype rules -----------------------------------------------------------

def _rt_common(ts, extra):
    out = ts[0]
    for t in ts[1:]:
        out = common_numeric(out, t)
    return out


def _rt_bool(ts, extra):
    return DType(Kind.BOOL, any(t.nullable for t in ts))


def _rt_float(ts, extra):
    return DType(Kind.FLOAT64, any(t.nullable for t in ts))


def _rt_same(ts, extra):
    return ts[0]


def _rt_div(ts, extra):
    if all(t.is_integer for t in ts):
        return DType(Kind.FLOAT64, any(t.nullable for t in ts))
    return _rt_common(ts, extra)


def _rt_cast(ts, extra):
    return DType(Kind(extra["to"]), ts[0].nullable)


def _rt_i32(ts, extra):
    return DType(Kind.INT32, ts[0].nullable)


# -- arithmetic ------------------------------------------------------------

_reg("add", _rt_common, lambda xp, a, e: a[0] + a[1])
_reg("sub", _rt_common, lambda xp, a, e: a[0] - a[1])
_reg("mul", _rt_common, lambda xp, a, e: a[0] * a[1])
_reg("div", _rt_div, lambda xp, a, e: _safe_div(xp, a[0], a[1]))
_reg("idiv", _rt_common, lambda xp, a, e: a[0] // xp.where(a[1] == 0, 1, a[1]))
_reg("mod", _rt_common, lambda xp, a, e: a[0] % xp.where(a[1] == 0, 1, a[1]))
_reg("neg", _rt_same, lambda xp, a, e: -a[0])
_reg("abs", _rt_same, lambda xp, a, e: xp.abs(a[0]))


def _safe_div(xp, a, b):
    # lint: transfer-ok(np.asarray only on the xp-is-np host lane — dtype probe, never a device value)
    integral = np.issubdtype(np.asarray(a).dtype, np.integer) if xp is np else xp.is_integer(a)
    num = _astype(xp, a, np.float64) if integral else a
    den = _astype(xp, b, num.dtype) if hasattr(b, "dtype") else b
    zero = den == 0
    return xp.where(zero, xp.zeros_like(num), num) / xp.where(zero, xp.ones_like(den), den)


# -- comparison ------------------------------------------------------------

_reg("eq", _rt_bool, lambda xp, a, e: a[0] == a[1])
_reg("ne", _rt_bool, lambda xp, a, e: a[0] != a[1])
_reg("lt", _rt_bool, lambda xp, a, e: a[0] < a[1])
_reg("le", _rt_bool, lambda xp, a, e: a[0] <= a[1])
_reg("gt", _rt_bool, lambda xp, a, e: a[0] > a[1])
_reg("ge", _rt_bool, lambda xp, a, e: a[0] >= a[1])


# -- boolean (Kleene) ------------------------------------------------------

def _and_nv(xp, args, extra):
    (da, va), (db, vb) = args
    if va is None and vb is None:
        return da & db, None
    ta = va if va is not None else _ones(xp, da)
    tb = vb if vb is not None else _ones(xp, db)
    # Kleene: false dominates null; null-as-true in data, masked by validity
    data = (da | ~ta) & (db | ~tb)
    valid = (ta & tb) | (ta & ~da) | (tb & ~db)
    return data, valid


def _or_nv(xp, args, extra):
    (da, va), (db, vb) = args
    data = da | db
    if va is None and vb is None:
        return data, None
    ta = va if va is not None else _ones(xp, da)
    tb = vb if vb is not None else _ones(xp, db)
    valid = (ta & tb) | (ta & da) | (tb & db)
    return (da & ta) | (db & tb), valid


def _ones(xp, like):
    return xp.ones_like(like, dtype=bool) if hasattr(like, "shape") else True


def _zeros(xp, like):
    return xp.zeros_like(like, dtype=bool) if hasattr(like, "shape") else False


_reg("and", _rt_bool, null_mode="custom", impl_nv=_and_nv)
_reg("or", _rt_bool, null_mode="custom", impl_nv=_or_nv)
_reg("not", _rt_bool, lambda xp, a, e: ~a[0])
_reg("xor", _rt_bool, lambda xp, a, e: a[0] ^ a[1])


# -- conditionals / null handling -----------------------------------------

def _if_nv(xp, args, extra):
    (dc, vc), (dt, vt), (df, vf) = args
    cond = dc if vc is None else (dc & vc)
    data = xp.where(cond, dt, df)
    if vt is None and vf is None:
        return data, None
    tt = vt if vt is not None else _ones(xp, data)
    tf = vf if vf is not None else _ones(xp, data)
    return data, xp.where(cond, tt, tf)


def _coalesce_nv(xp, args, extra):
    (da, va), (db, vb) = args
    if va is None:
        return da, None
    data = xp.where(va, da, db)
    valid = None if vb is None else (va | vb)
    return data, valid


def _is_null_nv(xp, args, extra):
    (da, va) = args[0]
    if va is None:
        return _zeros(xp, da), None
    return ~va, None


def _is_not_null_nv(xp, args, extra):
    data, valid = _is_null_nv(xp, args, extra)
    return ~data, None


def _rt_if(ts, extra):
    t = common_numeric(ts[1], ts[2]) if (ts[1].is_numeric and ts[2].is_numeric) else ts[1]
    return t.with_nullable(ts[1].nullable or ts[2].nullable)


def _typed_null_nv(xp, args, extra):
    """All-null column with the dtype/shape of the argument (CASE w/o ELSE)."""
    (da, _va) = args[0]
    return da, xp.zeros_like(da, dtype=bool)


_reg("if", _rt_if, null_mode="custom", impl_nv=_if_nv)
_reg("typed_null", lambda ts, e: ts[0].with_nullable(True),
     null_mode="custom", impl_nv=_typed_null_nv)
_reg("coalesce", lambda ts, e: ts[0].with_nullable(ts[1].nullable),
     null_mode="custom", impl_nv=_coalesce_nv)
_reg("is_null", lambda ts, e: DType(Kind.BOOL, False), null_mode="custom", impl_nv=_is_null_nv)
_reg("is_not_null", lambda ts, e: DType(Kind.BOOL, False), null_mode="custom", impl_nv=_is_not_null_nv)


# -- math ------------------------------------------------------------------

_reg("floor", _rt_same, lambda xp, a, e: xp.floor(a[0]))
_reg("ceil", _rt_same, lambda xp, a, e: xp.ceil(a[0]))
_reg("round", _rt_same, lambda xp, a, e: xp.sign(a[0]) * xp.floor(xp.abs(a[0]) + 0.5))
_reg("sqrt", _rt_float, lambda xp, a, e: xp.sqrt(xp.maximum(a[0], 0)))
_reg("exp", _rt_float, lambda xp, a, e: xp.exp(a[0]))
_reg("ln", _rt_float, lambda xp, a, e: xp.log(xp.maximum(a[0], 1e-300)))
_reg("pow", _rt_float, lambda xp, a, e: xp.power(a[0], a[1]))


# -- cast ------------------------------------------------------------------

def _cast_impl(xp, a, e):
    from ydb_tpu_torch.core.dtypes import DType as _DT
    target = _DT(Kind(e["to"])).np
    return _astype(xp, a[0], target)


_reg("cast", _rt_cast, _cast_impl)


# -- date extraction (civil-from-days, branch-free) ------------------------
# Algorithm: Howard Hinnant's civil_from_days; pure integer ops → jittable.

def _civil(xp, days):
    z = _astype(xp, days, np.int64) + 719468
    era = xp.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = xp.where(mp < 10, mp + 3, mp - 9)
    y = xp.where(m <= 2, y + 1, y)
    return y, m, d


_reg("year", _rt_i32, lambda xp, a, e: _astype(xp, _civil(xp, a[0])[0], np.int32))
_reg("month", _rt_i32, lambda xp, a, e: _astype(xp, _civil(xp, a[0])[1], np.int32))
_reg("day_of_month", _rt_i32, lambda xp, a, e: _astype(xp, _civil(xp, a[0])[2], np.int32))

# time-of-day extraction over unix-seconds int64 (TIMESTAMP storage is
# seconds; the reference's datetime2 UDF module is the analog surface)
_reg("hour_of_day", _rt_i32,
     lambda xp, a, e: _astype(xp, (a[0] // 3600) % 24, np.int32))
_reg("minute_of_hour", _rt_i32,
     lambda xp, a, e: _astype(xp, (a[0] // 60) % 60, np.int32))
_reg("second_of_minute", _rt_i32,
     lambda xp, a, e: _astype(xp, a[0] % 60, np.int32))


# -- dictionary-coded string ops ------------------------------------------

def _take_lut_nv(xp, args, extra):
    """lut[code] gather; code<0 (null string) → null result.

    The LUT is a runtime Param computed host-side over the column dictionary
    (see core/dictionary.py) — this is how LIKE/substr/eq on strings run on
    the device without touching bytes.

    `null_neg`: the LUT VALUES are themselves dictionary codes where a
    negative entry means "the transform produced NULL for this input"
    (derived-string lane: regexp_extract with no match, split_part out of
    range) — the result validity must reflect it, or COUNT/IS NULL see a
    phantom value."""
    (codes, vc), (lut, _) = args
    safe = xp.clip(codes, 0, lut.shape[0] - 1) if hasattr(lut, "shape") else codes
    data = lut[safe]
    nul = codes < 0
    valid = ~nul if vc is None else (vc & ~nul)
    if extra.get("null_neg"):
        valid = valid & (data >= 0)
    return data, valid


def _rt_take_lut(ts, extra):
    return DType(ts[1].kind, True)


_reg("take_lut", _rt_take_lut, null_mode="custom", impl_nv=_take_lut_nv)


# -- hashing (for shuffles / joins) ---------------------------------------

from ydb_tpu_torch.utils.hashing import hash_combine as _hc, splitmix64 as _sm64


def _rt_u64(ts, extra):
    return DType(Kind.UINT64, ts[0].nullable)


_reg("hash64", _rt_u64, lambda xp, a, e: _sm64(xp, a[0]))


def _hash_combine(xp, a, e):
    h = a[0]
    for x in a[1:]:
        h = _hc(xp, h, x)
    return h


_reg("hash_combine", _rt_u64, _hash_combine)
