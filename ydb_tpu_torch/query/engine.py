"""SQL engine front (slim port of ``ydb_tpu/query/engine.py``).

`QueryEngine(device=None)` runs on ``cuda`` and raises when no GPU is
present unless the caller passes ``device="cpu"``. The port carries the
read path of one node: SELECT (parse → plan cache → planner → executor,
fused or portioned), WITH bodies and FROM subqueries materialized into
transient tables before the outer statement plans, set operations
(arms on the device, the combine in pandas), SELECT without FROM, and
window functions (the inner query on the device, the window pass on the
device lane `ops/window_dev.py` or the pandas lane `query/window.py`);
and CREATE TABLE. Tables are filled through ``ydb_tpu_torch.interop`` or
the generators under ``bench/``. `config` (`utils/config.Config`) is
read for the window lane (``enable_device_windows``,
``window_device_min_rows``), the host-lane limit
(``host_lane_max_rows``) and the GraceJoin budget
(``grace_budget_bytes``, unless ``YDB_TPU_GRACE_BUDGET`` is set).
`executor.last_path` names the lane a SELECT took: fused, fused-batched,
fused-tiled, fused-tiled-spill, fused-tiled-union, portioned,
distributed, distributed-shuffle-join, distributed-map, set-op or
literal. `mesh` (`ydb_tpu_torch.parallel.make_mesh`) runs SELECTs over
its shards: scans spread over them and aggregation boundaries become
exchanges between them (`query/executor.py`'s mesh lanes).

A plain SELECT reserves its estimated device bytes under memory
admission (`query/admission.py`: ``YDB_TPU_ADMISSION_BUDGET``,
``YDB_TPU_ADMISSION_TIMEOUT``) and a slot of the pipeline window
(``YDB_TPU_PIPELINE_WINDOW`` / ``Config.pipeline_window``) from dispatch
to readout, as the reference's does. With ``YDB_TPU_BATCH_WINDOW`` (ms)
above 0, same-shape SELECTs arriving inside the window coalesce into one
batched execution (`query/batch_lane.py`, at most ``YDB_TPU_BATCH_MAX``
members). `query` is safe to call from many threads; `counters()`
returns the ``batch/*``, ``admission/*`` and ``pipeline/*`` counters.
DML, transactions and sessions, system views, materialized views,
topics and tracing raise ``NotPorted``.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Optional

import numpy as np

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


# counters() keys that read 0 before their first event
_ALWAYS_VISIBLE = (
    "batch/batches", "batch/coalesced_queries", "batch/max_size",
    "batch/singles", "batch/fallbacks", "batch/declined",
    "batch/reservations", "batch/window_timeouts", "admission/waits",
    "admission/timeouts", "admission/in_flight_bytes",
    "admission/active_queries", "pipeline/dispatched",
    "pipeline/overlap_hits", "pipeline/window_timeouts",
    "pipeline/in_flight")


class QueryEngine:
    def __init__(self, catalog: Optional[Catalog] = None, device=None,
                 block_rows: Optional[int] = None, config=None, mesh=None):
        from ydb_tpu_torch.utils.config import Config
        self.config = config or Config.load()
        block_rows = block_rows if block_rows is not None \
            else self.config.block_rows
        self.device = resolve_device(device)
        self.catalog = catalog or Catalog()
        self.planner = Planner(self.catalog)
        self.executor = Executor(self.catalog, self.device, block_rows,
                                 mesh=mesh)
        self.executor.enable_fused = self.config.flag("enable_fused")
        # budget priority: explicit env var > config > built-in default
        # (the executor's constructor already read the env)
        if "YDB_TPU_GRACE_BUDGET" not in os.environ:
            self.executor.grace_budget_bytes = \
                self.config.grace_budget_bytes
        self._tmp_ids = itertools.count()    # thread-safe temp names
        # plan cache keyed by SQL text, validated against the
        # (uid, data_version) of every referenced table
        self._plan_cache: dict = {}          # guarded-by: _plan_mu
        self._plan_mu = threading.Lock()
        self.plan_cache_hits = 0
        # device-memory admission (the reference's kqp_rm_service seat):
        # SELECTs reserve their scan+build estimate before dispatch
        from ydb_tpu_torch.query.admission import MemoryAdmission
        from ydb_tpu_torch.storage.device_cache import DEFAULT_BUDGET
        self.admission = MemoryAdmission(
            int(os.environ.get("YDB_TPU_ADMISSION_BUDGET", DEFAULT_BUDGET)),
            timeout_s=float(os.environ.get("YDB_TPU_ADMISSION_TIMEOUT",
                                           60.0)))
        # the window bounds dispatched-but-undrained SELECTs: each holds
        # its result buffers (plus its admission reservation) on the
        # device until drained
        self.pipeline_window = max(1, int(os.environ.get(
            "YDB_TPU_PIPELINE_WINDOW", self.config.pipeline_window)))
        self._pipe_sem = threading.BoundedSemaphore(self.pipeline_window)
        self._pipe_mu = threading.Lock()
        self._pipe_inflight = 0          # guarded-by: _pipe_mu
        # the batched serving lane: with YDB_TPU_BATCH_WINDOW=<ms> > 0,
        # same-shape SELECTs arriving inside the window coalesce into
        # ONE batched execution; 0 (the default) is off
        self.batch_window_ms = float(
            os.environ.get("YDB_TPU_BATCH_WINDOW", "0") or 0)
        self._batch_lane = None
        if self.batch_window_ms > 0:
            from ydb_tpu_torch.query.batch_lane import BatchLane
            self._batch_lane = BatchLane(
                self, self.batch_window_ms / 1000.0,
                max_batch=int(os.environ.get("YDB_TPU_BATCH_MAX", "64")))

    def snapshot(self) -> Snapshot:
        """Reads see every committed version: the port has no concurrent
        writers (DML and transactions are not ported)."""
        return MAX_SNAPSHOT

    def execute(self, sql: str) -> HostBlock:
        stmt = parse(sql)
        try:
            if isinstance(stmt, (ast.Select, ast.SetOp)):
                return self._execute_read(stmt, sql)
            if isinstance(stmt, ast.CreateTable):
                return self._create_table(stmt)
        except (BindError, PlanError) as e:
            raise QueryError(str(e)) from e
        raise NotPorted(f"{type(stmt).__name__} statements")

    def query(self, sql: str):
        """Execute and return a pandas DataFrame."""
        return self.execute(sql).to_pandas()

    def _execute_read(self, stmt, sql: str) -> HostBlock:
        """SELECT / set-op execution, dispatched as the reference's
        `_execute_read` does."""
        from ydb_tpu_torch.ops.torch_exec import late_mat_enabled
        from ydb_tpu_torch.query import window as W
        from ydb_tpu_torch.query.bounds import bounds_enabled
        snap = self.snapshot()
        if isinstance(stmt, ast.SetOp):
            block = self._execute_set_op(stmt, snap)
            self.executor.last_path = "set-op"
            return block
        if W.has_window(stmt):
            return self._execute_windowed(stmt, snap)
        if stmt.relation is None:
            block = self._select_without_from(stmt, snap)
            self.executor.last_path = "literal"
            return block
        if self._needs_materialize(stmt):
            return self._execute_materialized(stmt, snap)
        names = self._referenced_tables(stmt)
        fp = (self._table_fingerprint(names), bounds_enabled(),
              late_mat_enabled())
        use_cache = self.config.flag("enable_plan_cache")
        with self._plan_mu:
            cached = self._plan_cache.get(sql) if use_cache else None
            if cached is not None and cached[0] == fp:
                plan = cached[1]
                self.plan_cache_hits += 1
            else:
                plan = self.planner.plan_select(stmt)
                if use_cache:
                    self._plan_cache[sql] = (fp, plan)
        return self._select(plan, snap)

    def _select(self, plan, snap) -> HostBlock:
        """The reference's `_execute_read` tail: the plan's device-byte
        estimate, then the batch lane (its leader holds one window slot
        and one reservation for the whole batch) or the per-query
        pipeline."""
        from ydb_tpu_torch.query.admission import (
            AdmissionTimeout, estimate_plan_bytes,
        )
        # floor: even column-less scans (count(*)) reserve a nominal
        # slot so admission can actually bound concurrency
        est = max(estimate_plan_bytes(self.catalog, plan, snap), 1 << 20)
        try:
            block = None
            if self._batch_lane is not None:
                block = self._batch_lane.try_run(plan, snap, est)
            if block is None:
                block = self._dispatch_and_drain(plan, snap, est)
        except AdmissionTimeout as e:
            raise QueryError(str(e)) from e
        return block

    def _dispatch_and_drain(self, plan, snap, est: int) -> HostBlock:
        """The concurrent query pipeline: a *dispatch phase* (plan →
        compile-cache hit → device enqueue, `Executor.execute_async`)
        followed by a *readout phase* that resolves the device-result
        future lock-free — so while this query drains D2H, the next
        one's dispatch is already in flight.

        The admission reservation spans BOTH phases (result buffers
        live in device memory until drained), and `pipeline_window`
        bounds dispatched-but-undrained queries on top of the byte
        budget."""
        # window slot FIRST, byte reservation second: a query parked
        # behind the window must not sit on admission bytes it isn't
        # using (that would shed concurrent large queries with spurious
        # AdmissionTimeouts). Sem holders waiting on admission shed via
        # its deadline and release the slot — no circular wait — and the
        # slot wait itself is BOUNDED by the same deadline, so a window
        # saturated by admission-queued queries sheds instead of
        # head-of-line blocking every later SELECT indefinitely.
        from ydb_tpu_torch.query.admission import AdmissionTimeout
        from ydb_tpu_torch.utils.metrics import GLOBAL
        if not self._pipe_sem.acquire(timeout=self.admission.timeout_s):
            GLOBAL.inc("pipeline/window_timeouts")
            raise AdmissionTimeout(
                f"pipeline window saturated: {self.pipeline_window} "
                "queries dispatched-or-queued for longer than the "
                "admission deadline")
        try:
            with self.admission.admit(est):
                return self._dispatch_drain_admitted(plan, snap, est)
        finally:
            self._pipe_sem.release()

    def _dispatch_drain_admitted(self, plan, snap, est: int) -> HostBlock:
        """Body of the pipeline once the window slot + byte reservation
        are held: dispatch, account the in-flight overlap, drain."""
        from ydb_tpu_torch.utils.metrics import GLOBAL
        entered = False
        try:
            fut = self.executor.execute_async(plan, snap)
            with self._pipe_mu:
                self._pipe_inflight += 1
                entered = True
                if self._pipe_inflight > 1:
                    # another query was dispatched and undrained when
                    # this one entered: the pipeline genuinely
                    # overlapped (the counter the threaded throughput
                    # test asserts on)
                    GLOBAL.inc("pipeline/overlap_hits")
                GLOBAL.set("pipeline/in_flight", self._pipe_inflight)
            GLOBAL.inc("pipeline/dispatched")
            block = fut.result()
            return block
        finally:
            if entered:
                with self._pipe_mu:
                    self._pipe_inflight -= 1
                    GLOBAL.set("pipeline/in_flight", self._pipe_inflight)

    def counters(self) -> dict:
        """Live counter snapshot (a slim form of the reference's
        /counters payload): the process counters, the
        plan cache size, the pipeline window and the batch window; the
        lane's and admission's counters are present (0) before their
        first use."""
        from ydb_tpu_torch.utils.metrics import GLOBAL
        c = GLOBAL.snapshot()
        with self._plan_mu:
            c["engine/plan_cache_size"] = len(self._plan_cache)
        c["pipeline/window"] = self.pipeline_window
        c["batch/window_ms"] = self.batch_window_ms
        for k in _ALWAYS_VISIBLE:
            c.setdefault(k, 0)
        return c

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

    # -- reads beside the plain SELECT: literal, set operations, windows ---
    #
    # Copies of the reference's methods (tests/test_torch_drift.py lists
    # their edits).

    def _select_without_from(self, sel: ast.Select,
                             snap: Optional[Snapshot] = None) -> HostBlock:
        """Constant SELECT (`select 1 + 1 as x`): fold each item host-side
        — one row, no scan (the literal-executer analog). Scalar
        subqueries evaluate first (the q88 report shape: a row of
        independent counts)."""
        from ydb_tpu_torch.core import dtypes as dt
        from ydb_tpu_torch.core.dictionary import Dictionary
        from ydb_tpu_torch.query.binder import _try_fold

        def eval_subs(e):
            import dataclasses
            if isinstance(e, ast.ScalarSubquery):
                blk = self._run_select(e.query, snap)
                if len(blk.schema.names) != 1:
                    raise QueryError("scalar subquery must select one "
                                     "column")
                if blk.length > 1:
                    raise QueryError("scalar subquery returned "
                                     f"{blk.length} rows")
                if blk.length == 0:
                    return ast.Literal(None)     # SQL: empty → NULL
                v = blk.to_pandas().iloc[0, 0]
                if v is None or (isinstance(v, float) and np.isnan(v)):
                    return ast.Literal(None)
                if hasattr(v, "item"):
                    v = v.item()   # numpy scalar → python
                return ast.Literal(v)
            if not hasattr(e, "__dataclass_fields__"):
                return e

            def rw(v):
                if isinstance(v, tuple):
                    return tuple(rw(x) for x in v)
                if hasattr(v, "__dataclass_fields__"):
                    return eval_subs(v)
                return v
            return dataclasses.replace(
                e, **{fld: rw(getattr(e, fld))
                      for fld in e.__dataclass_fields__})

        cols, arrays, valids, dicts = [], {}, {}, {}
        for i, item in enumerate(sel.items):
            expr2 = eval_subs(item.expr)
            if isinstance(expr2, ast.Literal) and expr2.value is None:
                name = item.alias or f"column{i}"
                cols.append(Column(name, dt.DType(dt.Kind.INT64, True)))
                arrays[name] = np.zeros(1, np.int64)
                valids[name] = np.zeros(1, bool)
                continue
            folded = _try_fold(expr2)
            if folded is None:
                raise QueryError(
                    "SELECT without FROM supports constant expressions only")
            name = item.alias or f"column{i}"
            v = folded.value
            if v is None:
                cols.append(Column(name, dt.DType(dt.Kind.INT64, True)))
                arrays[name] = np.zeros(1, np.int64)
                valids[name] = np.zeros(1, bool)
            elif isinstance(v, bool):
                cols.append(Column(name, dt.DType(dt.Kind.BOOL, False)))
                arrays[name] = np.array([v])
            elif isinstance(v, int):
                cols.append(Column(name, dt.DType(dt.Kind.INT64, False)))
                arrays[name] = np.array([v], np.int64)
            elif isinstance(v, float):
                cols.append(Column(name, dt.DType(dt.Kind.FLOAT64, False)))
                arrays[name] = np.array([v], np.float64)
            else:
                d = Dictionary()
                cols.append(Column(name, dt.DType(dt.Kind.STRING, False)))
                arrays[name] = d.encode([str(v)])
                dicts[name] = d
        return HostBlock.from_arrays(Schema(cols), arrays, valids, dicts)

    def _run_select(self, sel,
                    snap: Optional[Snapshot] = None) -> HostBlock:
        """Execute an in-memory Select/SetOp AST (DML subflows, CTE
        bodies, window inner queries) — no text-keyed plan cache."""
        from ydb_tpu_torch.query import window as W
        snap = snap or self.snapshot()
        if isinstance(sel, ast.SetOp):
            return self._execute_set_op(sel, snap)
        if W.has_window(sel):
            return self._execute_windowed(sel, snap)
        if self._needs_materialize(sel):
            return self._execute_materialized(sel, snap)
        plan = self.planner.plan_select(sel)
        return self.executor.execute(plan, snap)

    def _execute_set_op(self, stmt: ast.SetOp,
                        snap: Optional[Snapshot] = None) -> HostBlock:
        """UNION / UNION ALL: CTEs materialize once (visible to every
        arm), arms run through the normal device path, the combine (and
        dedup for UNION) runs host-side."""
        from ydb_tpu_torch.query import window as W
        snap = snap or self.snapshot()
        temps: list = []
        try:
            rewritten = self._rewrite_sel(stmt, {}, temps, snap)
            df = self._eval_setop_df(rewritten, snap)
            try:
                df = W.apply_order_limit(df, stmt.order_by,
                                         stmt.limit, stmt.offset)
            except ValueError as e:
                raise QueryError(str(e)) from e
            return HostBlock.from_pandas(df)
        finally:
            for tn in temps:
                if self.catalog.has(tn):
                    self.catalog.drop_table(tn)

    def _eval_setop_df(self, node, snap):
        """Evaluate an already-rewritten SetOp tree to a pandas frame."""
        import pandas as pd
        if isinstance(node, ast.SetOp):
            left = self._eval_setop_df(node.left, snap)
            right = self._eval_setop_df(node.right, snap)
            if len(left.columns) != len(right.columns):
                raise QueryError("UNION arms have different arity")
            right.columns = left.columns
            # the combined frame is the actual host job — guard it too
            # (N arms each under the limit can still combine over it);
            # count=False: rows were already counted at their leaf arms
            self._host_lane_guard(len(left) + len(right), "setop",
                                  count=False)
            if node.op in ("union", "union_all"):
                out = pd.concat([left, right], ignore_index=True)
                if node.op == "union":
                    out = out.drop_duplicates(ignore_index=True)
                return out
            cols = list(left.columns)

            def counts(lf, rf, how):
                """Per-distinct-row multiplicities of both arms."""
                lc = lf.groupby(cols, dropna=False).size() \
                       .rename("__l").reset_index()
                rc = rf.groupby(cols, dropna=False).size() \
                       .rename("__r").reset_index()
                return lc.merge(rc, on=cols, how=how)

            if node.op == "intersect":
                return left.drop_duplicates().merge(
                    right.drop_duplicates(), on=cols, how="inner") \
                    .reset_index(drop=True)
            if node.op == "intersect_all":
                m = counts(left, right, "inner")
                reps = np.minimum(m["__l"], m["__r"]).to_numpy()
            elif node.op == "except":
                m = left.drop_duplicates().merge(
                    right.drop_duplicates(), on=cols, how="left",
                    indicator=True)
                return m[m["_merge"] == "left_only"][cols] \
                    .reset_index(drop=True)
            else:                    # except_all: multiplicity difference
                m = counts(left, right, "left")
                reps = np.maximum(m["__l"] - m["__r"].fillna(0), 0) \
                    .astype(int).to_numpy()
            return m[cols].loc[m.index.repeat(reps)] \
                          .reset_index(drop=True)
        arm = self._run_select(node, snap)
        self._host_lane_guard(arm.length, "setop")
        return arm.to_pandas()

    def _host_lane_guard(self, rows: int, lane: str,
                         count: bool = True) -> None:
        """Host pandas lanes (windows, set-op combine) degrade loudly:
        frames above the configured limit refuse instead of silently
        becoming single-core pandas jobs (`count` is the reference's
        row-counter switch; the port keeps no such counter)."""
        if rows > self.config.host_lane_max_rows:
            raise QueryError(
                f"{lane} host-fallback lane refused a {rows}-row frame "
                f"(host_lane_max_rows={self.config.host_lane_max_rows}; "
                f"raise it in config to accept the single-core cost)")

    def _execute_windowed(self, sel: ast.Select,
                          snap: Optional[Snapshot] = None) -> HostBlock:
        """Window functions: the inner query (scan/filter/join/agg) runs
        on the device; the window pass runs host-side over its (usually
        post-aggregation) result — see `ydb_tpu/query/window.py`."""
        from ydb_tpu_torch.query import window as W
        snap = snap or self.snapshot()
        try:
            inner, outer, post = W.split_windowed(sel)
        except ValueError as e:
            raise QueryError(str(e)) from e
        inner_block = self._run_select(inner, snap)
        df = None
        device_ok = self.config.flag("enable_device_windows") \
            and inner_block.length >= self.config.window_device_min_rows
        if device_ok and post is None and not sel.distinct \
                and sel.limit is not None:
            # final ORDER BY + LIMIT pushable: every output leaves the
            # device sliced to offset+limit rows (O(rows) egress was the
            # dominant window cost — PERF.md r5)
            fs = self._final_sort_spec(sel, outer)
            if fs is not None:
                done = self._windows_on_device(inner_block, outer,
                                               final_sort=fs,
                                               limit=sel.limit,
                                               offset=sel.offset or 0)
                if done is not None:
                    lo = sel.offset or 0
                    return HostBlock.from_pandas(
                        done.iloc[lo:lo + sel.limit]
                        .reset_index(drop=True))
        if device_ok:
            df = self._windows_on_device(inner_block, outer)
        if df is None:
            self._host_lane_guard(inner_block.length, "window")
            try:
                df = W.compute_windows(inner_block.to_pandas(), outer)
            except ValueError as e:
                raise QueryError(str(e)) from e
        if post is not None:
            # window results used INSIDE expressions: evaluate the
            # rewritten items as a second pass over the computed frame.
            # NULL-bearing numeric columns come back from to_pandas as
            # object dtype — coerce them back, or from_pandas would
            # classify them as STRING and the post arithmetic would run
            # on dictionary codes
            import pandas as pd
            win_cols = {p["alias"] for k, p in outer if k == "win"}
            for c in df.columns:
                if df[c].dtype != object:
                    continue
                numeric = c in win_cols or (
                    inner_block.schema.has(c)
                    and not inner_block.schema.dtype(c).is_string)
                if numeric:
                    df[c] = pd.to_numeric(df[c])
            temps: list = []
            try:
                tname = self._register_temp(HostBlock.from_pandas(df),
                                            temps, snap)
                final = ast.Select(items=post,
                                   relation=ast.TableRef(tname))
                df = self._run_select(final, snap).to_pandas()
            finally:
                for tn in temps:
                    if self.catalog.has(tn):
                        self.catalog.drop_table(tn)
        if sel.distinct:
            df = df.drop_duplicates(ignore_index=True)
        try:
            df = W.apply_order_limit(df, sel.order_by, sel.limit,
                                     sel.offset)
        except ValueError as e:
            raise QueryError(str(e)) from e
        return HostBlock.from_pandas(df)

    def _final_sort_spec(self, sel, outer):
        """[(output name, ascending)] when every ORDER BY key is a plain
        output-column reference with default NULL placement; None
        otherwise (the host tail handles the exotic cases)."""
        names = set()
        for kind, payload in outer:
            names.add(payload if kind == "col" else payload["alias"])
        fs = []
        for o in sel.order_by:
            if not isinstance(o.expr, ast.Name) \
                    or o.expr.parts[-1] not in names \
                    or o.nulls_first is not None:
                return None
            fs.append((o.expr.parts[-1], o.ascending))
        return fs

    def _windows_on_device(self, inner_block: HostBlock, outer,
                           final_sort=None, limit=None, offset=0):
        """Device window lane (`ops/window_dev.py`): every spec computed
        on the engine's device — sort, segment boundaries, prefix scans
        (the window_scan kernel) — with a single device→host transfer for
        all outputs (sliced to offset+limit rows when the final sort
        pushes down). Returns the assembled frame, or None when a spec
        requires the pandas lane."""
        import pandas as pd

        from ydb_tpu_torch.ops.window_dev import compute_windows_device
        dev = compute_windows_device(inner_block, outer,
                                     final_sort=final_sort,
                                     limit=limit, offset=offset,
                                     device=self.device)
        if dev is None:
            return None

        def series(vals, valid, dic):
            if dic is not None:
                s = pd.Series(dic.decode(vals), dtype=object)
            else:
                s = pd.Series(vals)
            if valid is not None and not valid.all():
                s = s.where(pd.Series(valid))
            return s

        if final_sort is not None:
            sliced, _n = dev
            cols = {}
            for kind, payload in outer:
                name = payload if kind == "col" else payload["alias"]
                cols[name] = series(*sliced[name])
            return pd.DataFrame(cols)
        base = inner_block.to_pandas()
        cols = {}
        for kind, payload in outer:
            if kind == "col":
                cols[payload] = base[payload]
            else:
                cols[payload["alias"]] = series(*dev[payload["alias"]])
        return pd.DataFrame(cols)

    # -- CTE / derived-table materialization -------------------------------
    #
    # WITH bodies and FROM subqueries materialize into transient column
    # tables before the outer statement plans (the reference's stage
    # materialization). System views inside them are not ported.

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
            cte_map = dict(cte_map)
            for (name, body) in sel.ctes:
                cte_map[name] = self._materialize(
                    self._rewrite_sel(body, cte_map, temps, snap), temps,
                    snap)
            out = ast.SetOp(
                sel.op,
                self._rewrite_sel(sel.left, cte_map, temps, snap),
                self._rewrite_sel(sel.right, cte_map, temps, snap),
                sel.order_by, sel.limit, sel.offset)
            return out
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
                return ast.TableRef(t, r.alias)   # Select OR SetOp body
            return r

        def rewrite_expr(e):
            import dataclasses
            if e is None or not hasattr(e, "__dataclass_fields__"):
                return e
            if isinstance(e, (ast.Exists, ast.InSubquery,
                              ast.ScalarSubquery)):
                q = self._rewrite_sel(e.query, cte_map, temps, snap)
                if isinstance(q, ast.SetOp):
                    # plan over a materialized temp: the planner only
                    # decorrelates plain selects (explicit column items —
                    # Star would lose the planner's naming contract)
                    tname = self._materialize(q, temps, snap)
                    cols = self.catalog.table(tname).schema.names
                    q = ast.Select(
                        items=[ast.SelectItem(ast.Name((c,)), c)
                               for c in cols],
                        relation=ast.TableRef(tname))
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
        """Materialize an already-rewritten Select or SetOp into a
        transient table; returns its name."""
        from ydb_tpu_torch.query import window as W
        snap = snap or self.snapshot()
        if isinstance(sel, ast.SetOp):
            df = self._eval_setop_df(sel, snap)
            try:
                df = W.apply_order_limit(df, sel.order_by, sel.limit,
                                         sel.offset)
            except ValueError as e:
                raise QueryError(str(e)) from e
            block = HostBlock.from_pandas(df)
        elif W.has_window(sel):
            block = self._execute_windowed(sel, snap)
        else:
            block = self.executor.execute(self.planner.plan_select(sel),
                                          snap)
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
