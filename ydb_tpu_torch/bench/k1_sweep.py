"""Seeded inputs and stages that sweep K1 (``ops/k1.py``) over every op
of ``ops/kernels.py``.

Each case is one stage of Assigns over a dtype combination: every op
that takes those operand dtypes, with and without NULLs. The columns
hold negative operands for the floor ops, zero divisors (and -0.0),
NaN, +-inf and -0.0 in the float numerators, codes of -1 and past the
LUT, a LUT with negative values under ``null_neg``, hash inputs whose
bits are >= 2^63, dates before 1970 and timestamps before it. The CPU
tests (against the JAX reference and the host-compiled source) and
``chip_smoke.py`` (the kernel against its plain version on the card)
share them."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ydb_tpu_torch.core.dtypes import DType, Kind
from ydb_tpu_torch.ops import ir

STORAGE = ("bool", "int8", "int16", "int32", "int64", "uint8", "float32",
           "float64")
MIXED = (("int32", "int64"), ("int8", "uint8"), ("int64", "float64"),
         ("int32", "float32"), ("float32", "float64"), ("bool", "int64"),
         ("int16", "float64"))
BINARY = ("add", "sub", "mul", "div", "idiv", "mod", "eq", "ne", "lt", "le",
          "gt", "ge", "xor", "and", "or")
UNARY = ("neg", "abs", "not", "floor", "ceil", "round", "sqrt", "exp", "ln",
         "is_null", "is_not_null", "typed_null")
CAST_TO = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint64",
           "float32", "float64", "date32", "timestamp")
LUT_LEN = 37
_KIND = {t: Kind(t) for t in STORAGE}


@dataclass
class Case:
    """A stage over `cols` (name -> (numpy data, numpy valid | None), in
    storage dtypes) and `params` (name -> numpy scalar or array). `jax`
    is False where the reference's semantics differ by design (integer
    powers with negative exponents)."""
    name: str
    stage: tuple
    cols: dict
    params: dict
    jax: bool = True


def _values(t: str, n: int, rng, divisor: bool) -> np.ndarray:
    if t == "bool":
        return rng.random(n) < 0.5
    if t in ("float32", "float64"):
        x = rng.integers(-320, 320, n) / 8.0
        if divisor:
            x[::7] = 0.0
            x[3::14] = -0.0
        else:
            x[:5] = [np.nan, np.inf, -np.inf, -0.0, 0.0]
        return x.astype(t)
    lo, hi = {"int8": (-100, 100), "int16": (-3000, 3000),
              "int32": (-100_000, 100_000), "int64": (-1_000_000, 1_000_000),
              "uint8": (0, 256)}[t]
    x = rng.integers(lo, hi, n).astype(t)
    if divisor:
        x[::7] = 0
    elif t == "int64":
        x[:2] = [(1 << 62) + 12345, -(1 << 62) - 999]   # products wrap
    return x


def columns(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    cols = {}
    for t in STORAGE:
        for nm, div in (("x", False), ("y", True)):
            d = _values(t, n, rng, div)
            cols[f"{nm}_{t}"] = (d, None)
            cols[f"{nm}n_{t}"] = (d, rng.random(n) < 0.8)
        cols[f"e_{t}"] = (rng.integers(0, 5, n).astype(t), None)
    cols["cond"] = (rng.random(n) < 0.5, rng.random(n) < 0.8)
    h = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    cols["h64"] = (h, None)
    cols["days"] = (rng.integers(-200_000, 200_000, n).astype(np.int32),
                    rng.random(n) < 0.9)
    cols["ts"] = (rng.integers(-4_000_000_000, 4_000_000_000, n), None)
    cols["codes"] = (rng.integers(-1, LUT_LEN + 2, n).astype(np.int32), None)
    cols["codesn"] = (cols["codes"][0], rng.random(n) < 0.8)
    cols["base"] = (rng.integers(-6, 7, n), None)
    cols["expo"] = (rng.integers(-3, 7, n), None)
    return cols


def params(seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    return {"lut_b": rng.random(LUT_LEN) < 0.5,
            "lut_c": rng.integers(-2, 1000, LUT_LEN).astype(np.int32),
            "lut_f": rng.normal(size=LUT_LEN),
            "p_i64": np.int64(-7), "p_f64": np.float64(2.5),
            "p_b": np.bool_(True)}


def _col(name):
    return ir.Col(name)


def _assigns(exprs: dict) -> tuple:
    return tuple(ir.Assign(f"r_{k}", e) for k, e in exprs.items())


def cases(n: int, seed: int, supported=None) -> list:
    """Every case. `supported(expr, cols, params) -> bool` drops the
    Assigns whose operand dtypes an op does not take (the generator's
    own judgement, ``ops/k1.py``); None keeps them all."""
    cols, prm = columns(n, seed), params(seed)
    out = []

    def add(name, exprs, jax=True):
        keep = {k: e for k, e in exprs.items()
                if supported is None or supported(e, cols, prm)}
        if keep:
            out.append(Case(name, _assigns(keep), cols, prm, jax))

    for t in STORAGE:
        for null in ("", "n"):
            x, y = _col(f"x{null}_{t}"), _col(f"y_{t}")
            ex = {op: ir.call(op, x, y) for op in BINARY}
            ex.update({op: ir.call(op, x) for op in UNARY})
            ex["pow"] = ir.call("pow", x, _col(f"e_{t}"))
            ex["if"] = ir.call("if", _col("cond"), x, y)
            ex["coalesce"] = ir.call("coalesce", x, y)
            # hashes, times and dates convert floats to int64: finite
            # operands only (NaN and inf have no integer value)
            f = _col(f"y{null}_{t}") if t.startswith("float") else x
            ex["hash64"] = ir.call("hash64", f)
            ex["hash_combine"] = ir.call(
                "hash_combine", ir.call("hash64", f),
                ir.call("hash_combine", ir.call("hash64", y),
                        ir.call("hash64", f)))
            ex["hashed_key"] = ir.call("hash_combine", ir.call("hash64", f),
                                       ir.call("hash64", y))
            ex["hour"] = ir.call("hour_of_day", f)
            ex["minute"] = ir.call("minute_of_hour", f)
            ex["second"] = ir.call("second_of_minute", f)
            ex["year"] = ir.call("year", f)
            for k in CAST_TO:
                if t.startswith("float") and k in ("int8", "uint8", "uint64"):
                    continue          # out of range: undefined in C and XLA
                ex[f"cast_{k}"] = ir.call("cast", _col(f"y_{t}"), to=k)
            add(f"{t}{' nullable' if null else ''}", ex)
    for a, b in MIXED:
        for null in ("", "n"):
            x, y = _col(f"x{null}_{a}"), _col(f"y_{b}")
            ex = {op: ir.call(op, x, y) for op in BINARY}
            ex["if"] = ir.call("if", _col("cond"), x, y)
            ex["coalesce"] = ir.call("coalesce", x, y)
            add(f"{a} x {b}{' nullable' if null else ''}", ex)
    add("dates and times", {
        "year": ir.call("year", _col("days")),
        "month": ir.call("month", _col("days")),
        "day": ir.call("day_of_month", _col("days")),
        "hour": ir.call("hour_of_day", _col("ts")),
        "minute": ir.call("minute_of_hour", _col("ts")),
        "second": ir.call("second_of_minute", _col("ts"))})
    lut = {k: ir.Param(k, DType(_KIND[str(v.dtype) if v.dtype != np.bool_
                                      else "bool"]), is_array=True)
           for k, v in prm.items() if k.startswith("lut")}
    add("dictionary LUTs", {
        "lut_b": ir.call("take_lut", _col("codes"), lut["lut_b"]),
        "lut_c": ir.call("take_lut", _col("codes"), lut["lut_c"],
                         null_neg=True),
        "lut_cn": ir.call("take_lut", _col("codesn"), lut["lut_c"],
                          null_neg=True),
        "lut_f": ir.call("take_lut", _col("codesn"), lut["lut_f"])})
    add("hashes of u64 bits", {
        "hash64": ir.call("hash64", _col("h64")),
        "combine": ir.call("hash_combine", ir.call("hash64", _col("h64")),
                           ir.call("hash_combine",
                                   ir.call("hash64", _col("x_int64")),
                                   ir.call("hash64", _col("h64")))),
        "key": ir.call("hash_combine", ir.call("hash64", _col("h64")),
                       ir.call("hash64", _col("xn_int32")))})
    add("constants and params", {
        "c_i": ir.call("add", _col("xn_int32"), ir.Const(-3, DType(Kind.INT32))),
        "c_f": ir.call("mul", _col("x_float64"),
                       ir.Const(-0.0, DType(Kind.FLOAT64))),
        "c_u": ir.call("eq", _col("h64"),
                       ir.Const((1 << 64) - 5, DType(Kind.UINT64))),
        "p_i": ir.call("sub", _col("x_int64"),
                       ir.Param("p_i64", DType(Kind.INT64))),
        "p_f": ir.call("div", _col("xn_float32"),
                       ir.Param("p_f64", DType(Kind.FLOAT64))),
        "p_b": ir.call("and", _col("cond"),
                       ir.Param("p_b", DType(Kind.BOOL))),
        "c_n": ir.call("typed_null", ir.Const(1.5, DType(Kind.FLOAT32)))})
    add("integer powers with negative exponents",
        {"pow": ir.call("pow", _col("base"), _col("expo"))}, jax=False)
    return out


def filter_stage(n_filters: int = 2) -> tuple:
    """A stage with `n_filters` (1 or 2) Filters between its Assigns
    (the selection mask)."""
    i64, f64 = DType(Kind.INT64), DType(Kind.FLOAT64)
    first = ir.Filter(ir.call("lt", _col("a"), ir.Const(50, i64)))
    second = ir.Filter(ir.call("or", ir.call("is_null", _col("b")),
                               ir.call("gt", _col("b"), ir.Const(-20.0, f64))))
    return ((ir.Assign("a", ir.call("add", _col("xn_int32"), _col("y_int64"))),
             first,
             ir.Assign("b", ir.call("if", _col("cond"), _col("a"),
                                    _col("x_float64"))))
            + ((second,) if n_filters > 1 else ())
            + (ir.Assign("c", _col("a")),))
