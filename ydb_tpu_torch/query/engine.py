"""SQL engine front (slim port of ``ydb_tpu/query/engine.py``).

`QueryEngine(device=None)` runs on ``cuda`` and raises when no GPU is
present unless the caller passes ``device="cpu"``. The port carries the
SELECT path of one node (parse → plan cache → planner → fused executor),
WITH bodies and FROM subqueries materialized into transient tables
before the outer statement plans, and CREATE TABLE; tables are filled
through ``ydb_tpu_torch.interop`` or ``bench.tpch_gen.load_tpch``. DML,
transactions and sessions, set operations, windows, system views,
materialized views, topics, tracing and admission raise ``NotPorted``.
"""

from __future__ import annotations

import itertools
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
from ydb_tpu_torch.storage.mvcc import MAX_SNAPSHOT, Snapshot, WriteVersion


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
    def __init__(self, catalog: Optional[Catalog] = None, device=None,
                 block_rows: int = 1 << 20):
        self.device = resolve_device(device)
        self.catalog = catalog or Catalog()
        self.planner = Planner(self.catalog)
        self.executor = Executor(self.catalog, self.device, block_rows)
        self._tmp_ids = itertools.count()    # thread-safe temp names
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
            return self._execute_materialized(stmt)
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

    # -- CTE / derived-table materialization -------------------------------
    #
    # WITH bodies and FROM subqueries materialize into transient column
    # tables before the outer statement plans (the reference's stage
    # materialization). Set operations, system views and windows inside
    # them are not ported.

    def _needs_materialize(self, sel) -> bool:
        if isinstance(sel, ast.SetOp):
            return True
        if sel.ctes:
            return True
        if any(n.startswith(".sys") for n in self._referenced_tables(sel)):
            return True               # `.sys/...` materializes at plan time

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

    def _execute_materialized(self, sel: ast.Select,
                              snap: Optional[Snapshot] = None) -> HostBlock:
        snap = snap or self.snapshot()
        temps: list = []
        try:
            sel2 = self._rewrite_sel(sel, {}, temps, snap)
            plan = self.planner.plan_select(sel2)
            return self.executor.execute(plan, snap)
        finally:
            for t in temps:
                if self.catalog.has(t):
                    self.catalog.drop_table(t)

    def _rewrite_sel(self, sel, cte_map: dict,
                     temps: list, snap: Optional[Snapshot] = None):
        if isinstance(sel, ast.SetOp):
            raise NotPorted("set operations")
        cte_map = dict(cte_map)
        for (name, body) in sel.ctes:
            cte_map[name] = self._materialize(
                self._rewrite_sel(body, cte_map, temps, snap), temps,
                snap)

        def rewrite_rel(r):
            if isinstance(r, ast.TableRef):
                t = cte_map.get(r.name)
                if t is not None:
                    return ast.TableRef(t, r.alias or r.name)
                if r.name.startswith(".sys"):
                    raise NotPorted("system views")
                return r
            if isinstance(r, ast.Join):
                return ast.Join(r.kind, rewrite_rel(r.left),
                                rewrite_rel(r.right),
                                rewrite_expr(r.on))
            if isinstance(r, ast.SubqueryRef):
                t = self._materialize(
                    self._rewrite_sel(r.query, cte_map, temps, snap), temps,
                    snap)
                return ast.TableRef(t, r.alias)
            return r

        def rewrite_expr(e):
            import dataclasses
            if e is None or not hasattr(e, "__dataclass_fields__"):
                return e
            if isinstance(e, (ast.Exists, ast.InSubquery,
                              ast.ScalarSubquery)):
                q = self._rewrite_sel(e.query, cte_map, temps, snap)
                kw = {"query": q}
                if isinstance(e, ast.InSubquery):
                    kw["arg"] = rewrite_expr(e.arg)
                return dataclasses.replace(e, **kw)

            def rw(v):
                if isinstance(v, tuple):
                    return tuple(rw(x) for x in v)
                return rewrite_expr(v)

            kw = {f: rw(getattr(e, f)) for f in e.__dataclass_fields__}
            return dataclasses.replace(e, **kw)

        out = ast.Select(**{**sel.__dict__})
        out.ctes = []
        if out.relation is not None:
            out.relation = rewrite_rel(out.relation)
        out.where = rewrite_expr(out.where)
        out.having = rewrite_expr(out.having)
        out.items = [ast.SelectItem(rewrite_expr(i.expr), i.alias)
                     for i in out.items]
        out.group_by = [rewrite_expr(g) for g in out.group_by]
        out.order_by = [ast.OrderItem(rewrite_expr(o.expr), o.ascending,
                                      o.nulls_first) for o in out.order_by]
        return out

    def _materialize(self, sel, temps: list,
                     snap: Optional[Snapshot] = None) -> str:
        """Materialize an already-rewritten Select into a transient
        table; returns its name."""
        snap = snap or self.snapshot()
        if any(_has_window(i.expr) for i in sel.items):
            raise NotPorted("window functions (K13)")
        block = self.executor.execute(self.planner.plan_select(sel), snap)
        return self._register_temp(block, temps, snap)

    def _register_temp(self, block: HostBlock, temps: list,
                       snap: Optional[Snapshot] = None) -> str:
        snap = snap or self.snapshot()
        tname = f"__tmp{next(self._tmp_ids)}"
        # temps take the engine's block size, not the 1M-row default
        t = self.catalog.create_table(tname, block.schema,
                                      [block.schema.names[0]], shards=1,
                                      portion_rows=self.executor.block_rows,
                                      transient=True)
        t.dictionaries = {n: cd.dictionary
                          for n, cd in block.columns.items()
                          if cd.dictionary is not None}
        if block.length:
            # committed INSIDE the driving snapshot (tx snapshots are
            # pinned — a fresh coordinator step would be invisible); the
            # temp is private and dropped right after, so the early
            # version leaks nowhere
            t.commit(t.write(block), WriteVersion(snap.plan_step, 0))
            t.indexate()
        temps.append(tname)
        return tname

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
