"""SQL engine front (slim port of ``ydb_tpu/query/engine.py``).

`QueryEngine(device=None)` runs on ``cuda`` and raises when no GPU is
present unless the caller passes ``device="cpu"``. The port carries the
SELECT path of one node (parse → plan cache → planner → fused executor)
and CREATE TABLE; tables are filled through ``ydb_tpu_torch.interop``
or ``bench.tpch_gen.load_tpch``. DML, transactions and sessions, set
operations, windows, CTE/derived-table materialization, system views,
materialized views, topics, tracing and admission raise ``NotPorted``.
"""

from __future__ import annotations

from typing import Optional

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.schema import Column, Schema
from ydb_tpu_torch.device import resolve_device
from ydb_tpu_torch.errors import NotPorted
from ydb_tpu_torch.query.binder import BindError, sql_type_to_dtype
from ydb_tpu_torch.query.executor import Executor
from ydb_tpu_torch.query.planner import PlanError, Planner
from ydb_tpu_torch.scheme.catalog import Catalog
from ydb_tpu_torch.sql import ast, parse
from ydb_tpu_torch.storage.mvcc import MAX_SNAPSHOT, Snapshot


class QueryError(Exception):
    pass


def _has_window(e) -> bool:
    """Whether an expression tree holds a window function call."""
    if isinstance(e, ast.WindowFunc):
        return True
    if isinstance(e, tuple):
        return any(_has_window(x) for x in e)
    return hasattr(e, "__dataclass_fields__") and any(
        _has_window(getattr(e, f)) for f in e.__dataclass_fields__)


class QueryEngine:
    def __init__(self, catalog: Optional[Catalog] = None, device=None):
        self.device = resolve_device(device)
        self.catalog = catalog or Catalog()
        self.planner = Planner(self.catalog)
        self.executor = Executor(self.catalog, self.device)
        # plan cache keyed by SQL text, validated against the
        # (uid, data_version) of every referenced table
        self._plan_cache: dict = {}
        self.plan_cache_hits = 0

    def snapshot(self) -> Snapshot:
        """Reads see every committed version: the port has no concurrent
        writers (DML and transactions are not ported)."""
        return MAX_SNAPSHOT

    def execute(self, sql: str) -> HostBlock:
        stmt = parse(sql)
        try:
            if isinstance(stmt, ast.Select):
                return self._execute_read(stmt, sql)
            if isinstance(stmt, ast.CreateTable):
                return self._create_table(stmt)
        except (BindError, PlanError) as e:
            raise QueryError(str(e)) from e
        raise NotPorted(f"{type(stmt).__name__} statements")

    def query(self, sql: str):
        """Execute and return a pandas DataFrame."""
        return self.execute(sql).to_pandas()

    def _execute_read(self, stmt: ast.Select, sql: str) -> HostBlock:
        from ydb_tpu_torch.ops.torch_exec import late_mat_enabled
        from ydb_tpu_torch.query.bounds import bounds_enabled
        if any(_has_window(i.expr) for i in stmt.items):
            raise NotPorted("window functions (K13)")
        if stmt.relation is None:
            raise NotPorted("SELECT without FROM")
        if self._needs_materialize(stmt):
            raise NotPorted("CTE / derived-table / system-view "
                            "materialization")
        names = self._referenced_tables(stmt)
        fp = (self._table_fingerprint(names), bounds_enabled(),
              late_mat_enabled())
        cached = self._plan_cache.get(sql)
        if cached is not None and cached[0] == fp:
            plan = cached[1]
            self.plan_cache_hits += 1
        else:
            plan = self.planner.plan_select(stmt)
            self._plan_cache[sql] = (fp, plan)
        return self.executor.execute(plan, self.snapshot())

    def _table_fingerprint(self, names) -> tuple:
        out = []
        for n in sorted(names):
            if self.catalog.has(n):
                t = self.catalog.table(n)
                out.append((n, t.uid, t.data_version))
        return tuple(out)

    def _referenced_tables(self, sel) -> set:
        """Every table name the statement touches (plan-cache keys)."""
        names: set = set()

        def walk_sel(s):
            if isinstance(s, ast.SetOp):
                walk_sel(s.left)
                walk_sel(s.right)
                return
            for (_n, body) in s.ctes:
                walk_sel(body)
            if s.relation is not None:
                walk_rel(s.relation)
            for e in ([i.expr for i in s.items] + [s.where, s.having]
                      + list(s.group_by) + [o.expr for o in s.order_by]):
                walk_expr(e)

        def walk_rel(r):
            if isinstance(r, ast.TableRef):
                names.add(r.name)
            elif isinstance(r, ast.Join):
                walk_rel(r.left)
                walk_rel(r.right)
                walk_expr(r.on)
            elif isinstance(r, ast.SubqueryRef):
                walk_sel(r.query)

        def walk_expr(e):
            if e is None or not hasattr(e, "__dataclass_fields__"):
                return
            if isinstance(e, (ast.Exists, ast.InSubquery, ast.ScalarSubquery)):
                walk_sel(e.query)
                if isinstance(e, ast.InSubquery):
                    walk_expr(e.arg)
                return

            def walk_val(v):
                if isinstance(v, tuple):
                    for x in v:
                        walk_val(x)
                else:
                    walk_expr(v)

            for f in e.__dataclass_fields__:
                walk_val(getattr(e, f))

        walk_sel(sel)
        return names

    def _needs_materialize(self, sel) -> bool:
        """The reference materializes CTEs, derived tables, system views
        and subqueries that themselves need it before planning."""
        if isinstance(sel, ast.SetOp) or sel.ctes:
            return True
        if any(n.startswith(".sys") for n in self._referenced_tables(sel)):
            return True

        def rel_has(r):
            if isinstance(r, ast.SubqueryRef):
                return True
            if isinstance(r, ast.Join):
                return rel_has(r.left) or rel_has(r.right)
            return False

        def expr_has(e):
            if e is None or not hasattr(e, "__dataclass_fields__"):
                return False
            if isinstance(e, (ast.Exists, ast.InSubquery, ast.ScalarSubquery)):
                sub = self._needs_materialize(e.query)
                if isinstance(e, ast.InSubquery):
                    return sub or expr_has(e.arg)
                return sub

            def any_in(v):
                if isinstance(v, tuple):
                    return any(any_in(x) for x in v)
                return expr_has(v)

            return any(any_in(getattr(e, f))
                       for f in e.__dataclass_fields__)

        if sel.relation is not None and rel_has(sel.relation):
            return True
        for e in ([i.expr for i in sel.items] + [sel.where, sel.having]
                  + list(sel.group_by) + [o.expr for o in sel.order_by]):
            if expr_has(e):
                return True
        return False

    def _create_table(self, stmt: ast.CreateTable) -> HostBlock:
        if self.catalog.has(stmt.name):
            if stmt.if_not_exists:
                return _unit_block()
            raise QueryError(f"table {stmt.name!r} already exists")
        if stmt.ttl_column or stmt.ttl_days:
            raise NotPorted("TTL tables")
        cols = [Column(name, sql_type_to_dtype(ty, not_null))
                for (name, ty, not_null) in stmt.columns]
        if any(ty.lower() in ("serial", "bigserial")
               for (_n, ty, _nn) in stmt.columns):
            raise NotPorted("SERIAL columns")
        pk = stmt.primary_key or [cols[0].name]
        self.catalog.create_table(stmt.name, Schema(cols), pk,
                                  shards=max(1, stmt.partition_count),
                                  store_kind=stmt.store)
        return _unit_block()


def _unit_block() -> HostBlock:
    return HostBlock(Schema([]), {}, 0)
