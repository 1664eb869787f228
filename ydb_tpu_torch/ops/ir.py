"""Columnar SSA program IR.

The device-executable program shape mirrors the reference's ColumnShard
pushdown program (`ydb/core/protos/ssa.proto:19-209`): an ordered list of
commands over named columns —

  * ``Assign``     — bind a new named column to an expression
    (constant / parameter / kernel call over existing columns),
  * ``Filter``     — intersect the block's selection mask with a predicate,
  * ``GroupBy``    — hash/sort aggregate by key columns,
  * ``Projection`` — restrict to a set of columns.

It is also the per-stage compute IR (the analog of serialized MiniKQL
programs in DQ task specs, `ydb/library/yql/dq/proto/dq_tasks.proto:186`);
every program has two lowerings: a numpy oracle (`ops/numpy_exec.py`) and the
XLA lowering (`ops/xla_exec.py`). Programs are structurally fingerprinted for
the jit pattern cache (analog of
`mkql_computation_pattern_cache.h:56`).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Optional, Union

from ydb_tpu_torch.core.dtypes import BOOL, DType, FLOAT64, INT64, Kind, UINT64, common_numeric
from ydb_tpu_torch.core.schema import Column, Schema

# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Col:
    name: str


@dataclass(frozen=True)
class Const:
    value: Any
    dtype: DType


@dataclass(frozen=True)
class Param:
    """Runtime-bound input (scalar or array), e.g. a dictionary LUT.

    Analog of the SSA program's parameters schema
    (`ssa.proto:201` TOlapProgram.Parameters).
    """
    name: str
    dtype: DType
    is_array: bool = False


@dataclass(frozen=True)
class Call:
    op: str
    args: tuple                      # tuple[Expr, ...]
    extra: tuple = ()                # sorted tuple of (key, value) pairs

    def extra_dict(self) -> dict:
        return dict(self.extra)


Expr = Union[Col, Const, Param, Call]


def call(op: str, *args: Expr, **extra) -> Call:
    return Call(op, tuple(args), tuple(sorted(extra.items())))


# --------------------------------------------------------------------------
# Commands
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Assign:
    name: str
    expr: Expr


@dataclass(frozen=True)
class Filter:
    pred: Expr


@dataclass(frozen=True)
class Agg:
    out: str
    func: str                        # count | count_all | sum | min | max | some
    arg: Optional[str] = None        # column name; None only for count_all


@dataclass(frozen=True)
class GroupBy:
    keys: tuple                      # tuple[str, ...] (may be empty: global agg)
    aggs: tuple                      # tuple[Agg, ...]
    # static per-key domain sizes (codes in [-1, domain)); 0 = unbounded.
    # When every key is bounded and the product is small, the XLA lowering
    # uses direct-indexed scatter aggregation (BlockCombineHashed analog)
    # instead of sort-based segmentation. Part of the structural
    # fingerprint, so dictionary growth recompiles.
    key_domains: tuple = ()
    # PROVEN static upper bound on the number of groups (0 = unbounded).
    # The sorted lowering late-materializes per-group outputs at a bucket
    # of this size instead of scan capacity, so per-group gathers run at
    # output cardinality. An UNDERSTATED bound silently drops groups —
    # only guaranteed sources may set it: the planner's key-domain
    # products (dictionary/bool domains snapshot at plan time) and the
    # executor's inner-join build cardinality (ngroups ≤ build rows when
    # every key is the probe key or a unique build's payload). Part of
    # the structural fingerprint.
    out_bound: int = 0
    # CARRIED keys: grouping columns PROVEN functionally determined by
    # `keys` (the executor's bounds rewrite: a unique-keyed build's
    # payload is a function of its join key; dataset-verified
    # determinants within one build's payload). They do not participate
    # in the sort / bucket identity — their per-group value materializes
    # from the group leader row, exactly like key late-materialization.
    # A FALSE dependency silently merges groups, so only runtime-verified
    # sources may populate this. Part of the structural fingerprint.
    carry_keys: tuple = ()


@dataclass(frozen=True)
class Projection:
    names: tuple                     # tuple[str, ...]


@dataclass(frozen=True)
class Compact:
    """Shrink the working capacity to `cap` rows: selected rows compact
    to the front (stable, like BlockCompress) and the block is SLICED to
    the ladder-quantized `cap` (`progstore/buckets.bucket_segment`) —
    downstream commands compile and run at the small shape instead of
    scan capacity.

    `cap` is SIZING-quality (an estimate or a lattice bound), never a
    correctness input: the lowering emits the live count and an overflow
    flag out-of-band (`_trace_program`'s aux box) and the executor
    re-runs the un-compacted program LOUDLY when live > cap — truncation
    is detected, never silent. `bound` records the pre-quantized bound
    the planner/executor derived (documentation + structural identity).
    Part of the structural fingerprint, so a re-sized compact recompiles.
    """
    cap: int
    bound: int = 0


Command = Union[Assign, Filter, GroupBy, Projection, Compact]


@dataclass
class Program:
    commands: list = field(default_factory=list)

    def assign(self, name: str, expr: Expr) -> "Program":
        self.commands.append(Assign(name, expr))
        return self

    def filter(self, pred: Expr) -> "Program":
        self.commands.append(Filter(pred))
        return self

    def group_by(self, keys: list[str], aggs: list[Agg],
                 key_domains: tuple = (), out_bound: int = 0,
                 carry_keys: tuple = ()) -> "Program":
        self.commands.append(GroupBy(tuple(keys), tuple(aggs),
                                     tuple(key_domains), out_bound,
                                     tuple(carry_keys)))
        return self

    def project(self, names: list[str]) -> "Program":
        self.commands.append(Projection(tuple(names)))
        return self

    def compact(self, cap: int, bound: int = 0) -> "Program":
        self.commands.append(Compact(cap, bound))
        return self

    # -- structural identity (jit pattern-cache key) ----------------------

    def fingerprint(self) -> str:
        h = hashlib.sha256(repr(self.commands).encode())
        return h.hexdigest()[:24]

    def __repr__(self) -> str:
        return f"Program({self.commands!r})"


# --------------------------------------------------------------------------
# Type inference
# --------------------------------------------------------------------------

AGG_FUNCS = ("count", "count_all", "sum", "min", "max", "some")


def infer_expr(expr: Expr, schema: Schema) -> DType:
    from ydb_tpu_torch.ops.kernels import KERNELS  # late import: registry below IR

    if isinstance(expr, Col):
        return schema.dtype(expr.name)
    if isinstance(expr, (Const, Param)):
        return expr.dtype
    if isinstance(expr, Call):
        k = KERNELS[expr.op]
        arg_types = [infer_expr(a, schema) for a in expr.args]
        return k.result_dtype(arg_types, expr.extra_dict())
    raise TypeError(f"bad expr {expr!r}")


def agg_result_dtype(func: str, arg_dtype: Optional[DType]) -> DType:
    if func in ("count", "count_all"):
        return DType(Kind.UINT64, nullable=False)
    assert arg_dtype is not None
    if func == "sum":
        if arg_dtype.is_float:
            return FLOAT64
        if arg_dtype.kind in (Kind.UINT8, Kind.UINT16, Kind.UINT32, Kind.UINT64):
            return UINT64
        return INT64
    return arg_dtype  # min/max/some


def infer_schema(program: Program, schema: Schema) -> Schema:
    """Output schema of a program over an input schema (also validates)."""
    cur = Schema(list(schema.columns))
    for cmd in program.commands:
        if isinstance(cmd, Assign):
            dt = infer_expr(cmd.expr, cur)
            cols = [c for c in cur.columns if c.name != cmd.name]
            cur = Schema(cols + [Column(cmd.name, dt)])
        elif isinstance(cmd, Filter):
            dt = infer_expr(cmd.pred, cur)
            if dt.kind is not Kind.BOOL:
                raise TypeError(f"filter predicate must be bool, got {dt}")
        elif isinstance(cmd, GroupBy):
            cols = [cur.col(k) for k in cmd.keys]
            cols += [cur.col(k) for k in cmd.carry_keys]
            for a in cmd.aggs:
                if a.func not in AGG_FUNCS:
                    raise ValueError(f"unknown aggregate {a.func}")
                arg_dt = cur.dtype(a.arg) if a.arg is not None else None
                cols.append(Column(a.out, agg_result_dtype(a.func, arg_dt)))
            cur = Schema(cols)
        elif isinstance(cmd, Projection):
            cur = cur.select(list(cmd.names))
        elif isinstance(cmd, Compact):
            pass                         # capacity change only — schema holds
        else:
            raise TypeError(f"bad command {cmd!r}")
    return cur


def expr_columns(expr: Expr, out: Optional[set] = None) -> set:
    """Set of input column names referenced by an expression."""
    if out is None:
        out = set()
    if isinstance(expr, Col):
        out.add(expr.name)
    elif isinstance(expr, Call):
        for a in expr.args:
            expr_columns(a, out)
    return out


def program_params(program: Program) -> list[Param]:
    """All Params referenced anywhere in the program, in first-use order."""
    seen: dict[str, Param] = {}

    def walk(e: Expr):
        if isinstance(e, Param):
            seen.setdefault(e.name, e)
        elif isinstance(e, Call):
            for a in e.args:
                walk(a)

    for cmd in program.commands:
        if isinstance(cmd, Assign):
            walk(cmd.expr)
        elif isinstance(cmd, Filter):
            walk(cmd.pred)
    return list(seen.values())
