"""SQL AST.

The analog of the reference's SQL→AST layer (`ydb/library/yql/sql/v1/` —
ANTLR grammar `SQLv1.g.in` producing `TExprNode` s-expressions). Here the
grammar is hand-written recursive descent (ydb_tpu/sql/parser.py) and the
AST is plain dataclasses consumed by the logical planner
(ydb_tpu/query/planner.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Union


# -- expressions -----------------------------------------------------------


@dataclass(frozen=True)
class Name:
    """Column reference: `x` or `t.x`."""
    parts: tuple                   # ("x",) or ("t", "x")


@dataclass(frozen=True)
class Literal:
    value: Any                     # int | float | str | bool | None
    type_hint: Optional[str] = None  # "date" | "interval_day" | ...


@dataclass(frozen=True)
class BinOp:
    op: str                        # + - * / % and or = <> < <= > >= ||
    left: "Expr"
    right: "Expr"


@dataclass(frozen=True)
class UnaryOp:
    op: str                        # - not
    arg: "Expr"


@dataclass(frozen=True)
class FuncCall:
    name: str                      # lower-cased
    args: tuple                    # tuple[Expr, ...]
    distinct: bool = False         # COUNT(DISTINCT x)
    star: bool = False             # COUNT(*)


@dataclass(frozen=True)
class Case:
    operand: Optional["Expr"]      # CASE <operand> WHEN ... (None: searched)
    whens: tuple                   # tuple[(cond, result), ...]
    default: Optional["Expr"]


@dataclass(frozen=True)
class Cast:
    arg: "Expr"
    to: str                        # type name, lower-cased


@dataclass(frozen=True)
class Between:
    arg: "Expr"
    lo: "Expr"
    hi: "Expr"
    negated: bool = False


@dataclass(frozen=True)
class InList:
    arg: "Expr"
    items: tuple                   # tuple[Expr, ...]
    negated: bool = False


@dataclass(frozen=True)
class InSubquery:
    arg: "Expr"
    query: "Select"
    negated: bool = False


@dataclass(frozen=True)
class Exists:
    query: "Select"
    negated: bool = False


@dataclass(frozen=True)
class ScalarSubquery:
    query: "Select"


@dataclass(frozen=True)
class Like:
    arg: "Expr"
    pattern: str
    negated: bool = False


@dataclass(frozen=True)
class IsNull:
    arg: "Expr"
    negated: bool = False


@dataclass(frozen=True)
class Star:
    """SELECT * or t.*"""
    table: Optional[str] = None


@dataclass(frozen=True)
class WindowFunc:
    """fn(args) OVER (PARTITION BY ... ORDER BY ...) — no frame clauses
    yet (the reference's window support lives in
    `yql/core/common_opt/yql_window.cpp`)."""
    func: str                      # row_number | rank | dense_rank |
    #                                sum | min | max | count | avg
    args: tuple                    # tuple[Expr, ...] (empty for row_number)
    partition_by: tuple = ()       # tuple[Expr, ...]
    order_by: tuple = ()           # tuple[OrderItem, ...]
    distinct: bool = False         # parsed but rejected (explicit error)
    # ROWS BETWEEN frame: ("rows", lo, hi); bounds are signed row offsets
    # (0 = current row) or ("unbounded", ±1)
    frame: tuple = None            # type: ignore[assignment]


@dataclass(frozen=True)
class BoundParam:
    """Planner-synthesized runtime parameter (uncorrelated scalar subquery
    result). Never produced by the parser."""
    name: str
    dtype: object                  # core.dtypes.DType


Expr = Union[Name, Literal, BinOp, UnaryOp, FuncCall, Case, Cast, Between,
             InList, InSubquery, Exists, ScalarSubquery, Like, IsNull, Star]


# -- relations -------------------------------------------------------------


@dataclass(frozen=True)
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass(frozen=True)
class SubqueryRef:
    query: "Select"
    alias: str


@dataclass(frozen=True)
class Join:
    kind: str                      # inner | left | right | full | cross
    left: "Relation"
    right: "Relation"
    on: Optional[Expr] = None


Relation = Union[TableRef, SubqueryRef, Join]


# -- statements ------------------------------------------------------------


@dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass(frozen=True)
class OrderItem:
    expr: Expr
    ascending: bool = True
    nulls_first: Optional[bool] = None   # None = dialect default (last)


@dataclass
class Select:
    items: list = field(default_factory=list)          # list[SelectItem]
    relation: Optional[Relation] = None
    where: Optional[Expr] = None
    group_by: list = field(default_factory=list)       # list[Expr]
    having: Optional[Expr] = None
    order_by: list = field(default_factory=list)       # list[OrderItem]
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    ctes: list = field(default_factory=list)           # list[(name, Select)]


@dataclass
class SetOp:
    """UNION / UNION ALL chain; trailing ORDER BY/LIMIT bind to the whole
    set result (the `yql_expr` Extend/UnionAll callables)."""
    op: str          # union | union_all | intersect[_all] | except[_all]
    left: object                   # Select | SetOp
    right: object                  # Select
    order_by: list = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    ctes: list = field(default_factory=list)   # visible to every arm


@dataclass
class CreateTable:
    name: str
    columns: list                     # list[(name, type_str, not_null)]
    primary_key: list                 # list[str]
    partition_count: int = 1
    store: str = "column"             # column | row
    ttl_column: str = ""              # WITH (ttl_column=..., ttl_days=N)
    ttl_days: int = 0
    if_not_exists: bool = False


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclass
class CreateIndex:
    name: str
    table: str
    column: str


@dataclass
class DropIndex:
    name: str
    table: str


@dataclass
class AlterTable:
    """ADD COLUMN / DROP COLUMN (schemeshard__operation_alter_table
    analog — the v0 of the reference's ~120 suboperation state machines)."""
    name: str
    action: str                       # "add" | "drop"
    column: str = ""
    col_type: str = ""                # for add
    not_null: bool = False            # for add (empty tables only)


@dataclass
class Insert:
    table: str
    columns: list                     # list[str] (may be empty = all)
    rows: list = field(default_factory=list)   # list[list[Literal]]
    query: Optional[Select] = None
    mode: str = "insert"              # insert | upsert | replace


@dataclass
class Delete:
    table: str
    where: Optional[Expr] = None


@dataclass
class Update:
    table: str
    assignments: list = field(default_factory=list)  # list[(col, Expr)]
    where: Optional[Expr] = None


@dataclass
class CreateMaterializedView:
    """CREATE MATERIALIZED VIEW v AS SELECT ... — registers a continuous
    query maintained from the source table's changefeed (ydb_tpu/views/,
    the reference's change-exchange + continuous-query surface)."""
    name: str
    query: "Select"
    sql: str = ""                  # defining SELECT text (restart recompile)


@dataclass
class DropMaterializedView:
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class Explain:
    query: "Select"
    analyze: bool = False
    sql: str = ""                  # inner statement text (re-run by ANALYZE)


@dataclass(frozen=True)
class Begin:
    pass


@dataclass(frozen=True)
class Commit:
    pass


@dataclass(frozen=True)
class Rollback:
    pass


Statement = Union[Select, CreateTable, DropTable, Insert, Delete, Update,
                  CreateMaterializedView, DropMaterializedView,
                  Explain, Begin, Commit, Rollback]
