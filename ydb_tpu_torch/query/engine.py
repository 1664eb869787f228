"""SQL engine front (slim port of ``ydb_tpu/query/engine.py``).

`QueryEngine(device=None)` runs on ``cuda`` and raises when no GPU is
present unless the caller passes ``device="cpu"``. The port carries one
node in memory. Reads: SELECT (parse → plan cache → planner → executor,
fused or portioned), WITH bodies and FROM subqueries materialized into
transient tables before the outer statement plans, set operations
(arms on the device, the combine in pandas), SELECT without FROM, and
window functions (the inner query on the device, the window pass on the
device lane `ops/window_dev.py` or the pandas lane `query/window.py`).
Writes: INSERT / UPSERT / REPLACE (VALUES or SELECT), UPDATE and DELETE
on column tables (MVCC delete marks on immutable portions, re-inserts
at the same commit) and row tables (`storage/rowtable.py`, ``with
(store = row)``: per-key version chains); CREATE / DROP / ALTER TABLE
(ADD / DROP COLUMN), CREATE / DROP INDEX on row tables, SERIAL columns
and TTL (``with (ttl_column = ..., ttl_days = N)``, swept by
`run_ttl(now)`). The WHERE of an UPDATE or DELETE, its computed SETs
and the SELECT of an INSERT run through the read path's lanes.
`last_rows_affected` counts a write's rows.

Every commit takes a plan step from the coordinator
(`tx/coordinator.py`); `snapshot()` is the published read watermark,
and `executor.execute(plan, snapshot)` reads at any snapshot taken
before. SELECTs run without the write lock: each registers its
snapshot so auto-compaction never restamps what it still reads.
`session()` opens an interactive session (`tx/session.py`): BEGIN,
COMMIT and ROLLBACK with optimistic locks, a conflicting commit
aborting with "optimistic lock". Tables are also filled through
``ydb_tpu_torch.interop`` or the generators under ``bench/``. `config`
(`utils/config.Config`) is read for the window lane
(``enable_device_windows``, ``window_device_min_rows``), the host-lane
limit (``host_lane_max_rows``), the GraceJoin budget
(``grace_budget_bytes``, unless ``YDB_TPU_GRACE_BUDGET`` is set), auto-
compaction (``enable_auto_compaction``) and the split threshold
(``shard_split_rows``). `executor.last_path` names the lane a SELECT
took: fused, fused-batched, fused-tiled, fused-tiled-spill,
fused-tiled-union, portioned, distributed, distributed-shuffle-join,
distributed-map, set-op or literal. `mesh`
(`ydb_tpu_torch.parallel.make_mesh`) runs SELECTs over its shards:
scans spread over them and aggregation boundaries become exchanges
between them (`query/executor.py`'s mesh lanes).

A plain SELECT reserves its estimated device bytes under memory
admission (`query/admission.py`: ``YDB_TPU_ADMISSION_BUDGET``,
``YDB_TPU_ADMISSION_TIMEOUT``) and a slot of the pipeline window
(``YDB_TPU_PIPELINE_WINDOW`` / ``Config.pipeline_window``) from dispatch
to readout, as the reference's does. With ``YDB_TPU_BATCH_WINDOW`` (ms)
above 0, same-shape SELECTs arriving inside the window coalesce into one
batched execution (`query/batch_lane.py`, at most ``YDB_TPU_BATCH_MAX``
members). `query` is safe to call from many threads; `counters()`
returns the process counters and the statement histograms.

Every statement runs under a trace (`utils/tracing.py`; sampled at
admission, ``YDB_TPU_TRACE_SAMPLE``) and a resource ledger
(`utils/memledger.py`, ``YDB_TPU_MEMLEDGER``); `last_stats` (a
`utils.metrics.QueryStats`: parse, plan and execute ms, rows, path, the
phases — on the card the device phase is CUDA-event time — the memory
line and the critical path) and `last_trace` are per thread.
``EXPLAIN [ANALYZE] <select>`` and `explain(sql)` give the reference's
plan text; ANALYZE adds the stats lines and the span tree.
Durable tables (``data_dir``), system views, materialized views and
topics raise ``NotPorted``.
"""

from __future__ import annotations

import itertools
import os
import threading
from contextlib import contextmanager as _contextmanager
from typing import Optional

import numpy as np

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.schema import Column, Schema
from ydb_tpu_torch.device import resolve_device
from ydb_tpu_torch.errors import NotPorted
from ydb_tpu_torch.query.binder import BindError, sql_type_to_dtype
from ydb_tpu_torch.query.executor import Executor
from ydb_tpu_torch.query.plan import explain
from ydb_tpu_torch.query.planner import PlanError, Planner
from ydb_tpu_torch.scheme.catalog import Catalog
from ydb_tpu_torch.sql import ast, parse
from ydb_tpu_torch.storage.mvcc import Snapshot, WriteVersion


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
                 block_rows: Optional[int] = None, config=None, mesh=None,
                 data_dir: Optional[str] = None):
        from ydb_tpu_torch.utils.config import Config
        self.config = config or Config.load()
        if data_dir is not None or self.config.data_dir is not None:
            raise NotPorted("durable tables (data_dir: storage/persist.py, "
                            "ROADMAP Queue 1 item 3)")
        # the write lock: DML, DDL and transaction control from every
        # session serialize here; SELECTs run without it over MVCC
        # snapshots. Re-entrant: a DML body runs its SELECT through
        # execute() again
        self.lock = threading.RLock()
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
        from ydb_tpu_torch.tx import Coordinator, Session
        self.coordinator = Coordinator(start_step=1)
        # the engine's own statements run through a default session
        # (autocommit unless BEGIN is issued on it); `session()` opens
        # more concurrent sessions
        self._default_session = Session(self)
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
        # per-statement stats ring (the reference's `.sys/query_metrics`
        # source)
        from collections import deque
        self.query_history = deque(maxlen=256)
        # tracing (utils/tracing.py): span tree per statement, rendered
        # by EXPLAIN ANALYZE; the executor's device spans nest under it
        from ydb_tpu_torch.utils.tracing import Tracer
        self.tracer = Tracer()
        self.executor.tracer = self.tracer
        # admission-time trace sampling: YDB_TPU_TRACE_SAMPLE in [0, 1]
        # — 1 (default) traces every statement, 0 records zero spans and
        # zero CUDA events (results byte-identical), fractions sample
        # deterministically 1-in-1/rate. Statements whose text blew the
        # slow-query threshold before are sampled regardless of rate.
        self.trace_sample = min(1.0, max(0.0, float(
            os.environ.get("YDB_TPU_TRACE_SAMPLE", "1") or 0)))
        self.slow_query_ms = float(
            os.environ.get("YDB_TPU_SLOW_QUERY_MS", "1000"))
        self._slow_sqls: dict = {}       # guarded-by: _trace_mu
        self._trace_mu = threading.Lock()
        self._trace_acc = 0.0            # guarded-by: _trace_mu
        # assembled query profiles, last-N ring: one record per SAMPLED
        # outermost statement — sql, wall, phase breakdown, span tree
        self.profiles = deque(maxlen=int(
            os.environ.get("YDB_TPU_PROFILE_RING", "64")))
        # per-statement resource-ledger and critical-path rollups,
        # last-N rings (utils/memledger.py, utils/critpath.py)
        self.memory_stats = deque(maxlen=256)
        self.critpath_stats = deque(maxlen=256)
        # per-statement result metadata is thread-local: concurrent
        # callers each see their own stats and trace
        self._tls = threading.local()
        # in-flight lock-free reads register their snapshot's plan step,
        # so auto-compaction's watermark never restamps portions a
        # running SELECT still needs (transactions pin theirs in the
        # coordinator)
        from collections import Counter
        self._active_reads = Counter()   # guarded-by: _reads_mu
        self._reads_mu = threading.Lock()

    # -- per-thread statement metadata -------------------------------------

    @property
    def last_stats(self):
        return getattr(self._tls, "last_stats", None)

    @last_stats.setter
    def last_stats(self, v):
        self._tls.last_stats = v

    @property
    def last_rows_affected(self) -> int:
        return getattr(self._tls, "last_rows_affected", 0)

    @last_rows_affected.setter
    def last_rows_affected(self, v: int):
        self._tls.last_rows_affected = v

    @property
    def last_trace(self):
        return getattr(self._tls, "last_trace", [])

    @last_trace.setter
    def last_trace(self, v):
        self._tls.last_trace = v

    # -- in-flight read registry (compaction safety floor) -----------------

    def _enter_read(self, plan_step: int) -> None:
        with self._reads_mu:
            self._active_reads[plan_step] += 1

    def _register_read(self):
        """Atomically take an autocommit read snapshot AND register it in
        the active-read floor. Taking the snapshot first and registering
        after (the r4 shape) left a gap where a commit + auto-compaction
        could restamp portions the snapshot still needed (ADVICE r4):
        under `_reads_mu`, any maintenance watermark computed before this
        registration was bounded by an older published step, so portions
        this snapshot sees are never restamped past it."""
        with self._reads_mu:
            snap = self.coordinator.read_snapshot()
            self._active_reads[snap.plan_step] += 1
        return snap

    def _exit_read(self, plan_step: int) -> None:
        with self._reads_mu:
            self._active_reads[plan_step] -= 1
            if self._active_reads[plan_step] <= 0:
                del self._active_reads[plan_step]

    def _maintenance_watermark(self) -> int:
        """Highest plan step background compaction may restamp up to:
        bounded by pinned tx snapshots (coordinator) AND every in-flight
        lock-free read."""
        w = self.coordinator.safe_watermark()
        with self._reads_mu:
            if self._active_reads:
                w = min(w, min(self._active_reads))
        return w

    # -- versions (coordinator time, ydb_tpu/tx/coordinator.py) ------------

    @property
    def _plan_step(self) -> int:
        return self.coordinator.last_plan_step

    def _next_version(self) -> WriteVersion:
        """A plan step published immediately — for callers that commit to
        storage directly (tests, loaders) with no reader able to observe
        the mid-apply state they create. Statement paths use
        `_commit_step` so the watermark trails the apply."""
        version = self.coordinator.propose(0)
        self.coordinator.publish(version.plan_step)
        return version

    @_contextmanager
    def _commit_step(self, tx_id: int = 0):
        """Propose→apply→publish envelope. The coordinator grants the plan
        step on entry; the read watermark advances only when the body's
        in-memory apply (stamps + delete marks) has finished, so lock-free
        SELECTs snapshotting mid-commit never observe a torn multi-shard
        apply. Publish runs in `finally` — a failed apply must not wedge
        the watermark (storage-level intent journals own partial-failure
        atomicity)."""
        version = self.coordinator.propose(tx_id)
        try:
            yield version
        finally:
            self.coordinator.publish(version.plan_step)

    def snapshot(self) -> Snapshot:
        return self.coordinator.read_snapshot()

    def session(self):
        """Open an interactive session (BEGIN/COMMIT/ROLLBACK scope)."""
        from ydb_tpu_torch.tx import Session
        return Session(self)

    def execute(self, sql: str, session=None,
                _internal: bool = False) -> HostBlock:
        """`_internal`: a re-entrant call from inside another statement
        (EXPLAIN ANALYZE, a TTL sweep). The engine has no quoter and no
        audit trail, which are what such a call skips."""
        from contextlib import nullcontext
        session = session or self._default_session
        # per-session statement serialization (SESSION_BUSY analog —
        # concurrency comes from many sessions, not one)
        ctx = session._mu if session is not self._default_session \
            else nullcontext()
        outermost = self.tracer._state().depth == 0
        # the sampling decision (and its accumulator/forced-slow side
        # effects) applies to OUTERMOST statements only — a nested
        # begin_trace inherits the open trace's decision anyway
        self.tracer.begin_trace(
            sampled=self._sample_decision(sql) if outermost else True)
        kind_box: list = []
        # resource ledger (utils/memledger.py): one per OUTERMOST
        # statement on this thread — a nested execute (EXPLAIN ANALYZE,
        # DQ router merge) contributes to the enclosing ledger
        from ydb_tpu_torch.utils import memledger
        led = memledger.open_statement()
        try:
            with ctx, self.tracer.span("statement", sql=sql[:60]):
                return self._execute_traced(sql, session, kind_box)
        finally:
            if led is not None:
                memledger.close_statement(led)
                self._record_memory(sql, kind_box[0] if kind_box else "",
                                    led)
            self.last_trace = self.tracer.end_trace()
            # profiles record USER statements: a DQ stage program run
            # through a legacy (context-free) caller is still internal
            if outermost and self.last_trace \
                    and not self.executor.dq_stage_depth:
                self._record_profile(sql, self.last_trace,
                                     memory=led.summary()
                                     if led is not None else None)

    def _execute_traced(self, sql: str, session=None,
                        kind_box: Optional[list] = None) -> HostBlock:
        from ydb_tpu_torch.utils.metrics import GLOBAL, QueryStats, Timer
        session = session or self._default_session
        t = Timer()
        stats = QueryStats(sql=sql)
        # per-statement group-by trace window (thread-local): whatever
        # sorted group-bys THIS statement freshly compiles lands in
        # stats.groupby for EXPLAIN ANALYZE / query history. Mark/delta,
        # not reset/snapshot — a nested same-thread statement (DQ router
        # merge stage) must not wipe the outer statement's window
        from ydb_tpu_torch.ops.torch_exec import groupby_trace_mark
        stats._gb_mark = groupby_trace_mark()
        # span-window mark: THIS statement's phase breakdown must only
        # cover spans recorded from here on — a nested statement (the DQ
        # router merge) shares the trace with already-ingested worker
        # spans whose device time is NOT this statement's
        stats._span_mark = len(self.tracer.spans)
        with self.tracer.span("parse"):
            stmt = parse(sql)
        stats.parse_ms = t.lap()
        stats.kind = type(stmt).__name__.lower()
        if kind_box is not None:
            kind_box.append(stats.kind)
        self.last_rows_affected = 0
        GLOBAL.inc("engine/statements")
        self.last_stats = stats
        tx = session.tx
        snap = tx.snapshot if tx is not None else self.snapshot()
        try:
            from ydb_tpu_torch.tx import TxAborted, TxCommitTorn
            if isinstance(stmt, (ast.Begin, ast.Commit, ast.Rollback)):
                with self.lock:
                    try:
                        if isinstance(stmt, ast.Begin):
                            session.begin()
                        elif isinstance(stmt, ast.Commit):
                            session.commit()
                        else:
                            session.rollback()
                    except (TxAborted, TxCommitTorn) as e:
                        # TxCommitTorn keeps its "internal: ... torn"
                        # message — SQL clients see the distinct error
                        # text; session-API clients get the distinct type
                        raise QueryError(str(e)) from e
                return _unit_block()
            if isinstance(stmt, ast.Explain):
                return self._explain_stmt(stmt, session)
            if isinstance(stmt, (ast.SetOp, ast.Select)):
                # read locks FIRST — every select path (fused, windowed,
                # set-op, materialized) must register conflicts
                names = self._referenced_tables(stmt)
                stats.tables = sorted(names)
                if tx is not None:
                    for name in names:
                        if self.catalog.has(name):
                            tx.lock(self.catalog.table(name))
                # register the snapshot: auto-compaction must not restamp
                # portions this lock-free read still scans. Autocommit
                # reads re-take the snapshot ATOMICALLY with registration;
                # tx snapshots are already coordinator-pinned, so their
                # registration has no gap to race.
                if tx is None:
                    snap = self._register_read()
                else:
                    self._enter_read(snap.plan_step)
                try:
                    return self._execute_read(stmt, sql, snap, stats, t)
                finally:
                    self._exit_read(snap.plan_step)
            # everything below mutates shared state — one writer at a time
            # (readers above run lock-free over their MVCC snapshots)
            with self.lock:   # noqa: SIM117
                # re-take the autocommit snapshot UNDER the lock: two
                # UPDATE v = v + 1 statements that both snapshotted before
                # serializing here would otherwise read the same state and
                # lose an update
                snap = tx.snapshot if tx is not None else self.snapshot()
                if isinstance(stmt, ast.CreateTable):
                    if tx is not None:
                        raise QueryError("DDL inside a transaction is not "
                                         "supported")
                    return self._create_table(stmt)
                if isinstance(stmt, ast.CreateMaterializedView):
                    if tx is not None:
                        raise QueryError("DDL inside a transaction is not "
                                         "supported")
                    raise NotPorted("materialized views (ROADMAP Queue 1 "
                                    "item 6)")
                if isinstance(stmt, ast.DropMaterializedView):
                    if tx is not None:
                        raise QueryError("DDL inside a transaction is not "
                                         "supported")
                    raise NotPorted("materialized views (ROADMAP Queue 1 "
                                    "item 6)")
                if isinstance(stmt, ast.DropTable):
                    if tx is not None:
                        raise QueryError("DDL inside a transaction is not "
                                         "supported")
                    if stmt.if_exists and not self.catalog.has(stmt.name):
                        return _unit_block()
                    self.catalog.drop_table(stmt.name)
                    return _unit_block()
                if isinstance(stmt, ast.AlterTable):
                    if tx is not None:
                        raise QueryError("DDL inside a transaction is not "
                                         "supported")
                    return self._alter_table(stmt)
                if isinstance(stmt, (ast.CreateIndex, ast.DropIndex)):
                    if tx is not None:
                        raise QueryError("DDL inside a transaction is not "
                                         "supported")
                    if not self.catalog.has(stmt.table):
                        raise QueryError(f"unknown table {stmt.table!r}")
                    t = self._table(stmt.table)
                    if getattr(t, "store_kind", "column") != "row":
                        raise QueryError(
                            "secondary indexes are row-store only (column "
                            "tables index via per-portion min/max stats)")
                    try:
                        if isinstance(stmt, ast.CreateIndex):
                            t.create_index(stmt.name, stmt.column)
                        else:
                            t.drop_index(stmt.name)
                    except ValueError as e:
                        raise QueryError(str(e)) from e
                    if self.catalog.store is not None:
                        self.catalog.store.save_catalog(self.catalog)
                    return _unit_block()
                if isinstance(stmt, ast.Insert):
                    return self._insert(stmt, snap, tx)
                if isinstance(stmt, ast.Update):
                    return self._update(stmt, snap, tx)
                if isinstance(stmt, ast.Delete):
                    return self._delete(stmt, snap, tx)
                raise QueryError(
                    f"unsupported statement {type(stmt).__name__}")
        except (BindError, PlanError) as e:
            raise QueryError(str(e)) from e

    def query(self, sql: str):
        """Execute and return a pandas DataFrame."""
        return self.execute(sql).to_pandas()

    def _execute_read(self, stmt, sql: str, snap, stats, t) -> HostBlock:
        """SELECT / set-op execution, dispatched as the reference's
        `_execute_read` does."""
        from ydb_tpu_torch.ops.torch_exec import late_mat_enabled
        from ydb_tpu_torch.query import window as W
        from ydb_tpu_torch.query.bounds import bounds_enabled
        from ydb_tpu_torch.utils.metrics import GLOBAL
        if isinstance(stmt, ast.SetOp):
            block = self._execute_set_op(stmt, snap)
            self.executor.last_path = "set-op"
            self._finish_stats(stats, t, block)
            return block
        if W.has_window(stmt):
            block = self._execute_windowed(stmt, snap)
            self._finish_stats(stats, t, block)
            return block
        if stmt.relation is None:
            block = self._select_without_from(stmt, snap)
            self.executor.last_path = "literal"
            self._finish_stats(stats, t, block)
            return block
        if self._needs_materialize(stmt):
            block = self._execute_materialized(stmt, snap)
            self._finish_stats(stats, t, block)
            return block
        fp = (self._table_fingerprint(stats.tables), bounds_enabled(),
              late_mat_enabled())
        use_cache = self.config.flag("enable_plan_cache")
        with self._plan_mu:
            cached = self._plan_cache.get(sql) if use_cache else None
            if cached is not None and cached[0] == fp:
                plan = cached[1]
                self.plan_cache_hits += 1
                stats.plan_cache_hit = True
            else:
                with self.tracer.span("plan"):
                    plan = self.planner.plan_select(stmt)
                if use_cache:
                    self._plan_cache[sql] = (fp, plan)
        GLOBAL.inc("engine/plan_cache_hits" if stats.plan_cache_hit
                   else "engine/plan_cache_misses")
        stats.plan_ms = t.lap()
        block = self._select(plan, snap, stats)
        self._finish_stats(stats, t, block)
        return block

    def _select(self, plan, snap, stats=None) -> HostBlock:
        """The reference's `_execute_read` tail: the plan's device-byte
        estimate (noted on the statement's ledger for its calibration),
        then the batch lane (its leader holds one window slot and one
        reservation for the whole batch) or the per-query pipeline."""
        from ydb_tpu_torch.query.admission import (
            AdmissionTimeout, estimate_plan_bytes,
        )
        from ydb_tpu_torch.utils import memledger
        # floor: even column-less scans (count(*)) reserve a nominal
        # slot so admission can actually bound concurrency
        est = max(estimate_plan_bytes(self.catalog, plan, snap), 1 << 20)
        memledger.note_admission(est)
        try:
            block = None
            if self._batch_lane is not None:
                block = self._batch_lane.try_run(plan, snap, est, stats)
            if block is None:
                block = self._dispatch_and_drain(plan, snap, est)
        except AdmissionTimeout as e:
            raise QueryError(str(e)) from e
        return block

    def _sample_decision(self, sql: str) -> bool:
        """Admission-time trace sampling: rate-based, with forced-on for
        EXPLAIN (the user asked for the profile) and for statements whose
        text previously exceeded the slow-query threshold. Nested
        (internal) statements inherit the enclosing decision — this is
        only consulted for the thread's OUTERMOST begin_trace."""
        if self.trace_sample >= 1.0:
            return True
        if sql.lstrip()[:7].lower() == "explain":
            return True
        if sql in self._slow_sqls:
            from ydb_tpu_torch.utils.metrics import GLOBAL
            GLOBAL.inc("trace/forced_slow")
            return True
        if self.trace_sample <= 0.0:
            return False
        with self._trace_mu:
            self._trace_acc += self.trace_sample
            if self._trace_acc >= 1.0:
                self._trace_acc -= 1.0
                return True
        return False

    def _record_memory(self, sql: str, kind: str, led) -> None:
        """Append one closed ledger to the `.sys/query_memory` ring.
        Statements that never touched the device (DDL, constant
        SELECTs) are skipped — a ring of zero rows would bury the
        queries this view exists to rank."""
        s = led.summary()
        if not (s["peak_bytes"] or s["transfers"] or s["padded_bytes"]):
            return
        self.memory_stats.append({
            "sql": sql, "kind": kind,
            "peak_bytes": s["peak_bytes"],
            "alloc_bytes": s["alloc_bytes"],
            "live_bytes": s["live_bytes"],
            "padded_bytes": s["padded_bytes"],
            "waste_bytes": s["waste_bytes"],
            "pad_efficiency": s["pad_efficiency"],
            "transfers": s["transfers"],
            "transfer_bytes": s["transfer_bytes"],
            "to_pandas_in_plan": s["to_pandas_in_plan"],
            "admission_est_bytes": s["admission_est_bytes"],
            "est_error_pct": s["est_error_pct"],
        })

    def _record_profile(self, sql: str, spans: list,
                        stage_stats: list = None, total_ms: float = None,
                        rows_out: int = None, kind: str = None,
                        memory: dict = None) -> None:
        """Append one assembled profile to the last-N ring
        (`.sys/query_profiles`): the span tree plus its device-timeline
        rollup. `stage_stats`: the DQ runner's per-(stage, worker) rows
        for distributed queries. total_ms/rows_out/kind overrides: the
        router passes the DQ wall explicitly — for a distributed query
        `last_stats` holds only the router-MERGE statement's numbers
        (or a previous statement's, when the final stage had no merge
        SQL), not the graph's."""
        from ydb_tpu_torch.utils.tracing import phase_breakdown
        st = self.last_stats
        # last_stats is only trustworthy when it belongs to THIS
        # statement and finished: a statement that raised before (or
        # inside) stats assembly leaves the PREVIOUS statement's record
        # in the thread-local — attributing its wall/kind/rows to this
        # profile row would fabricate exactly the numbers this view
        # exists to make reliable
        mine = st is not None and getattr(st, "sql", None) == sql
        finished = mine and getattr(st, "total_ms", 0.0) > 0.0
        rec = {
            "trace_id": spans[0].trace_id,
            "sql": sql,
            "kind": kind if kind is not None
            else (st.kind if mine else "error"),
            "total_ms": total_ms if total_ms is not None
            else (st.total_ms if finished
                  else round(spans[0].dur_ms, 3)),
            "rows_out": rows_out if rows_out is not None
            else (int(st.rows_out) if mine else 0),
            "phases": phase_breakdown(spans),
            "n_spans": len(spans),
            "spans": [s.to_dict() for s in spans],
            "stages": list(stage_stats or []),
        }
        # critical-path extraction (utils/critpath.py): which chain of
        # segments actually bounded this query's wall — classified,
        # counted (`crit/*`), ringed (`.sys/query_critical_path`), and
        # stored on the profile for the `/trace/<id>` timeline export.
        # Lever-gated: YDB_TPU_CRITPATH=0 freezes all of it.
        from ydb_tpu_torch.utils import critpath
        if critpath.enabled():
            try:
                cp = critpath.extract(spans, memory=memory)
                rec["critical_path"] = cp
                if finished and getattr(st, "_critpath_deferred", None) \
                        == rec["trace_id"]:
                    # the statement's own critical path: its window is
                    # this whole trace, so it is extracted once, here
                    st.critical_path = critpath.summarize(cp)
                critpath.record_counters(cp)
                self.critpath_stats.append({
                    "trace_id": rec["trace_id"], "sql": sql,
                    "kind": rec["kind"], "wall_ms": cp["wall_ms"],
                    "coverage": cp["coverage"],
                    "connected": cp["connected"],
                    "non_device_ms": cp["non_device_ms"],
                    "dominant_span": cp["dominant_span"],
                    "dominant_class": cp["dominant_class"],
                    "dominant_ms": cp["dominant_ms"],
                    **{f"{cls}_ms": cp["classes"].get(cls, 0.0)
                       for cls in critpath.CLASSES},
                })
            except Exception:                # noqa: BLE001 — analysis
                pass                         # must never fail a query
        self.profiles.append(rec)

    def _finish_stats(self, stats, t, block) -> None:
        from ydb_tpu_torch.ops.torch_exec import groupby_trace_delta
        from ydb_tpu_torch.utils.metrics import GLOBAL, GLOBAL_HIST
        from ydb_tpu_torch.utils.tracing import phase_breakdown
        stats.execute_ms = t.lap()
        stats.total_ms = stats.parse_ms + stats.plan_ms + stats.execute_ms
        stats.rows_out = block.length
        stats.fused = self.executor.last_path == "fused"
        stats.distributed = self.executor.last_path == "distributed"
        delta = groupby_trace_delta(getattr(stats, "_gb_mark", {}))
        # the bounds-lattice gauges ride the same trace window under a
        # `bounds_` prefix — split them into their own stats surface
        stats.bounds = {k[len("bounds_"):]: v for k, v in delta.items()
                        if k.startswith("bounds_")}
        stats.groupby = {k: v for k, v in delta.items()
                         if not k.startswith("bounds_")}
        if self.tracer.sampled:
            stats.phases = phase_breakdown(
                self.tracer.spans[getattr(stats, "_span_mark", 0):])
        # resource-ledger rollup as of NOW (the ledger closes in
        # execute() after this statement returns; EXPLAIN ANALYZE and
        # bench read stats.memory, so the live summary attaches here)
        from ydb_tpu_torch.utils import memledger
        led = memledger.current()
        if led is not None:
            stats.memory = led.summary()
        # per-statement critical path over the same span window (the
        # EXPLAIN ANALYZE `-- critical path:` source, joined with the
        # live ledger's bytes); the full-tree extraction with counters
        # and the sysview ring happens once in _record_profile
        from ydb_tpu_torch.utils import critpath
        if self.tracer.sampled and critpath.enabled():
            window = self.tracer.spans[getattr(stats, "_span_mark", 0):]
            # root the window under a CLOSED copy of the still-open
            # statement span: un-spanned statement-interior time (binder
            # work, dictionary predicate evaluation, CTE/derived-table
            # materialization — the q13 host lane) then classifies as
            # the statement's host_lane self-time instead of vanishing
            # into a virtual-root scheduler gap
            stk = self.tracer._stack
            if stk:
                import dataclasses as _dc
                window = [_dc.replace(
                    stk[-1],
                    dur_ms=self.tracer._now() - stk[-1].start_ms)] \
                    + window
            if getattr(stats, "_span_mark", 0) == 1 and len(stk) == 1 \
                    and stk[0] is self.tracer.spans[0] \
                    and not self.executor.dq_stage_depth:
                # the window is the whole trace: _record_profile extracts
                # it once, over the closed trace and ledger, and sets
                # stats.critical_path from that extraction
                stats._critpath_deferred = stk[0].trace_id
            elif window:
                try:
                    stats.critical_path = critpath.summarize(
                        critpath.extract(window, memory=stats.memory))
                except Exception:            # noqa: BLE001 — analysis
                    pass                     # must never fail a query
        # latency histograms count USER statements once: a nested
        # internal statement (EXPLAIN ANALYZE's re-entrant execute, the
        # DQ router-merge SELECT — its trace depth is >1) must not add a
        # second, cheaper sample that drags p50 down and doubles count.
        # Worker-side DQ stage programs are excluded via dq_stage_depth,
        # NOT trace depth — an unsampled task opens no trace, and the
        # histogram contents must not depend on the sampling rate
        if self.tracer._state().depth <= 1 \
                and not self.executor.dq_stage_depth:
            GLOBAL_HIST.observe("query/latency_ms", stats.total_ms)
            GLOBAL_HIST.observe("query/parse_ms", stats.parse_ms)
            GLOBAL_HIST.observe("query/plan_ms", stats.plan_ms)
            GLOBAL_HIST.observe("query/execute_ms", stats.execute_ms)
            # slow-query bookkeeping is USER-statement-scoped too: DQ
            # stage/merge SQL embeds per-query uuid temp names that can
            # never match a future run — remembering them would churn
            # the bounded forced-trace set and inflate slow_query/*
            self._note_slow(stats.sql, stats.total_ms, stats.kind)
        GLOBAL.inc("engine/rows_out", block.length)
        GLOBAL.inc("engine/queries")
        self.query_history.append(stats)

    def _note_slow(self, sql: str, total_ms: float, kind: str) -> None:
        """Slow-query log counter family + the forced-sampling set: a
        statement over the threshold is counted, and its TEXT is
        remembered so its next run is traced even at sample rate 0."""
        if total_ms < self.slow_query_ms or not sql:
            return
        from ydb_tpu_torch.utils.metrics import GLOBAL
        GLOBAL.inc("slow_query/count")
        GLOBAL.inc(f"slow_query/{kind or 'other'}")
        GLOBAL.set_max("slow_query/worst_ms", total_ms)
        with self._trace_mu:
            if len(self._slow_sqls) >= 256 and sql not in self._slow_sqls:
                # bounded: drop the least-slow remembered offender
                victim = min(self._slow_sqls, key=self._slow_sqls.get)
                del self._slow_sqls[victim]
            self._slow_sqls[sql] = max(self._slow_sqls.get(sql, 0.0),
                                       total_ms)

    def _explain_stmt(self, stmt: ast.Explain, session) -> HostBlock:
        """EXPLAIN [ANALYZE] — plan text (+ live execution stats), the
        `kqp_query_plan.cpp` plan-with-stats analog."""
        from ydb_tpu_torch.core.dictionary import Dictionary
        from ydb_tpu_torch.core import dtypes as dt
        if self._needs_materialize(stmt.query):
            # CTE/derived-table stages materialize at run time; their
            # sub-plans depend on intermediate results
            lines = ["(materialized CTE/derived-table stages; run EXPLAIN "
                     "ANALYZE for live stats)"]
        elif stmt.query.relation is None:
            lines = ["(constant SELECT — literal executer, no scan)"]
        else:
            try:
                lines = explain(
                    self.planner.plan_select(stmt.query)).split("\n")
            except (BindError, PlanError, KeyError) as e:
                raise QueryError(str(e)) from e
        if stmt.analyze:
            block = self.execute(stmt.sql, session=session, _internal=True)
            lines += self.last_stats.render().split("\n")
            tr = self.tracer.render()
            if tr:
                lines += ["-- trace:"] + tr.split("\n")
        d = Dictionary()
        codes = d.encode(lines)
        schema = Schema([Column("plan", dt.DType(dt.Kind.STRING, False))])
        return HostBlock.from_arrays(schema, {"plan": codes},
                                     dictionaries={"plan": d})

    def explain(self, sql: str) -> str:
        stmt = parse(sql)
        if not isinstance(stmt, ast.Select):
            raise QueryError("EXPLAIN supports SELECT only")
        return explain(self.planner.plan_select(stmt))

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
            import time as _time
            t_adm = _time.perf_counter()
            with self.admission.admit(est):
                wait_ms = (_time.perf_counter() - t_adm) * 1000.0
                if wait_ms >= 1.0:
                    # the statement QUEUED behind the byte budget:
                    # record the wait as its own (already-elapsed) span
                    # so critical-path extraction can class it
                    # admission_wait instead of burying it in a gap
                    sp = self.tracer.attach_span(
                        "admission-wait", admitted_mb=est >> 20)
                    if sp is not None:
                        sp.start_ms = round(sp.start_ms - wait_ms, 3)
                        sp.dur_ms = round(wait_ms, 3)
                return self._dispatch_drain_admitted(plan, snap, est)
        finally:
            self._pipe_sem.release()

    def _dispatch_drain_admitted(self, plan, snap, est: int) -> HostBlock:
        """Body of the pipeline once the window slot + byte reservation
        are held: dispatch, account the in-flight overlap, drain."""
        from ydb_tpu_torch.utils.metrics import GLOBAL, Timer
        entered = False
        try:
            with self.tracer.span("execute", admitted_mb=est >> 20):
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
            t_read = Timer()
            with self.tracer.span("readout"):
                block = fut.result()
            GLOBAL.inc("pipeline/readout_ms", t_read.ms())
            return block
        finally:
            if entered:
                with self._pipe_mu:
                    self._pipe_inflight -= 1
                    GLOBAL.set("pipeline/in_flight", self._pipe_inflight)

    def counters(self) -> dict:
        """Live counter snapshot (a slim form of the reference's
        /counters payload): the process counters and histograms
        (`hist/<family>/{count,p50,p95,p99,max}`, the fixed families
        zero before their first observation), the plan cache size, the
        device column cache's hits, misses and bytes, the coordinator's
        last plan step, the pipeline window, the batch window and the
        trace sampling; the registry's always-visible counters, the
        lane's and admission's are present (0) before their first use.
        The write path counts `engine/shard_splits` and
        `engine/ttl_evicted` as the reference's does."""
        from ydb_tpu_torch.utils.metrics import (
            ALWAYS_VISIBLE, GLOBAL, GLOBAL_HIST, HIST_FAMILIES,
        )
        c = GLOBAL.snapshot()
        c.update(GLOBAL_HIST.snapshot())
        for fam in HIST_FAMILIES:
            for q in ("count", "p50", "p95", "p99", "max"):
                c.setdefault(f"hist/{fam}/{q}", 0)
        with self._plan_mu:
            c["engine/plan_cache_size"] = len(self._plan_cache)
        dc = self.executor.device_cache
        c["device_cache/hits"] = dc.hits
        c["device_cache/misses"] = dc.misses
        c["device_cache/bytes"] = dc.bytes
        c["coordinator/plan_step"] = self.coordinator.last_plan_step
        c["pipeline/window"] = self.pipeline_window
        c["batch/window_ms"] = self.batch_window_ms
        for k in _ALWAYS_VISIBLE + ALWAYS_VISIBLE:
            c.setdefault(k, 0)
        c.setdefault("trace/sample_rate", self.trace_sample)
        c.setdefault("trace/profiles_held", len(self.profiles))
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
            # combine/dedup is host pandas work: spanned so it ranks as
            # host_lane on the critical path (arms' device spans nest
            # inside and classify themselves)
            with self.tracer.span("setop-host-lane"):
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
        """Host pandas lanes (windows, set-op combine) degrade loudly: a
        counter records the rows crossing to host (`count=False` for
        re-checks of already-counted rows, e.g. set-op combine levels),
        and frames above the configured limit refuse instead of silently
        becoming single-core pandas jobs."""
        from ydb_tpu_torch.utils.metrics import GLOBAL
        if count:
            GLOBAL.inc(f"engine/host_lane/{lane}_rows", rows)
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
                with self.tracer.span("window-device",
                                      rows=inner_block.length):
                    done = self._windows_on_device(inner_block, outer,
                                                   final_sort=fs,
                                                   limit=sel.limit,
                                                   offset=sel.offset
                                                   or 0)
                if done is not None:
                    lo = sel.offset or 0
                    return HostBlock.from_pandas(
                        done.iloc[lo:lo + sel.limit]
                        .reset_index(drop=True))
        if device_ok:
            with self.tracer.span("window-device",
                                  rows=inner_block.length):
                df = self._windows_on_device(inner_block, outer)
        if df is None:
            self._host_lane_guard(inner_block.length, "window")
            try:
                # its own span so the single-core pandas lane ranks as
                # host_lane on the critical path (the q13 class), not
                # as unattributed statement self-time
                with self.tracer.span("window-host-lane",
                                      rows=inner_block.length):
                    df = W.compute_windows(inner_block.to_pandas(),
                                           outer)
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
        requires the pandas lane (which then counts its host rows)."""
        import pandas as pd

        from ydb_tpu_torch.ops.window_dev import compute_windows_device
        from ydb_tpu_torch.utils.metrics import GLOBAL
        dev = compute_windows_device(inner_block, outer,
                                     final_sort=final_sort,
                                     limit=limit, offset=offset,
                                     device=self.device)
        if dev is None:
            return None
        GLOBAL.inc("engine/window_device_rows", inner_block.length)
        if final_sort is not None:
            GLOBAL.inc("engine/window_device_pushdown")

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

    # -- DDL / DML ---------------------------------------------------------
    #
    # Copies of the reference's methods (tests/test_torch_drift.py lists
    # their edits). Every WHERE, SET expression and INSERT ... SELECT
    # runs through `_run_select`, the read path's lanes on the device.

    def _create_table(self, stmt: ast.CreateTable) -> HostBlock:
        if self.catalog.has(stmt.name):
            if stmt.if_not_exists:
                return _unit_block()
            raise QueryError(f"table {stmt.name!r} already exists")
        cols = [Column(name, sql_type_to_dtype(ty, not_null))
                for (name, ty, not_null) in stmt.columns]
        pk = stmt.primary_key or [cols[0].name]
        schema = Schema(cols)
        if stmt.ttl_days and not stmt.ttl_column:
            raise QueryError("ttl_days needs ttl_column")
        if stmt.ttl_column:            # validate BEFORE creating anything
            from ydb_tpu_torch.core.dtypes import Kind as _K
            if not schema.has(stmt.ttl_column):
                raise QueryError(f"unknown TTL column {stmt.ttl_column!r}")
            if schema.dtype(stmt.ttl_column).kind not in (_K.DATE32,
                                                          _K.INT64):
                raise QueryError("TTL column must be Date or Int64 "
                                 "(unix seconds)")
            if stmt.ttl_days <= 0:
                raise QueryError("ttl_days must be positive")
        t = self.catalog.create_table(stmt.name, schema, pk,
                                      shards=max(1, stmt.partition_count),
                                      store_kind=stmt.store)
        serial_cols = [n for (n, ty, _nn) in stmt.columns
                       if ty.lower() in ("serial", "bigserial")]
        if serial_cols:
            t.serial_next = {c: 1 for c in serial_cols}
        if stmt.ttl_column:
            t.ttl = (stmt.ttl_column, stmt.ttl_days)
        if (serial_cols or stmt.ttl_column) \
                and self.catalog.store is not None:
            self.catalog.store.save_catalog(self.catalog)
        return _unit_block()

    def run_ttl(self, now: Optional[float] = None) -> dict:
        """Evict expired rows from every TTL-configured table (the
        background `ttl.cpp` change in the reference — here an explicit
        maintenance entry point, like `indexate`). `now`: unix seconds
        (defaults to wall clock; tests pass a fixed value). Returns
        {table: rows evicted}."""
        import datetime as _dt
        import time as _time
        from ydb_tpu_torch.core.dtypes import Kind as _K
        now = _time.time() if now is None else now
        out = {}
        for name in list(self.catalog.tables):
            t = self.catalog.table(name)
            ttl = getattr(t, "ttl", None)
            if not ttl or getattr(t, "transient", False):
                continue
            col, days = ttl
            if t.schema.dtype(col).kind is _K.DATE32:
                cutoff_days = int(now // 86400) - days
                d = _dt.date(1970, 1, 1) + _dt.timedelta(days=cutoff_days)
                pred = f"{col} < date '{d.isoformat()}'"
            else:
                pred = f"{col} < {int(now) - days * 86400}"
            self.execute(f"delete from {name} where {pred}",
                         _internal=True)
            out[name] = self.last_rows_affected
            from ydb_tpu_torch.utils.metrics import GLOBAL
            GLOBAL.inc("engine/ttl_evicted", self.last_rows_affected)
        return out

    def _table(self, name: str):
        """Catalog lookup with a user-facing error (not a raw KeyError)."""
        try:
            return self.catalog.table(name)
        except KeyError as e:
            raise QueryError(str(e.args[0])) from e

    def _alter_table(self, stmt: ast.AlterTable) -> HostBlock:
        """ADD/DROP COLUMN (the schemeshard alter-table suboperation
        analog): schema evolves in place, old portions serve nulls for
        added columns, the plan cache invalidates via data_version."""
        if not self.catalog.has(stmt.name):
            raise QueryError(f"unknown table {stmt.name!r}")
        t = self._table(stmt.name)
        if stmt.action == "add":
            if t.schema.has(stmt.column):
                raise QueryError(
                    f"column {stmt.column!r} already exists")
            if stmt.not_null and (
                    t.num_rows > 0
                    or getattr(t, "store_kind", "column") == "row"):
                # existing rows have no value for it; row tables replay
                # their full mutation log at boot, so even an empty one
                # cannot prove future replays satisfy NOT NULL
                raise QueryError(
                    "ADD COLUMN NOT NULL needs an empty column table "
                    "(no default-value backfill yet)")
            if stmt.col_type.lower() in ("serial", "bigserial"):
                raise QueryError("ADD COLUMN Serial is not supported "
                                 "(sequences initialize at CREATE TABLE)")
            col = Column(stmt.column,
                         sql_type_to_dtype(stmt.col_type, stmt.not_null))
            t.add_column(col)
        else:
            if not t.schema.has(stmt.column):
                raise QueryError(f"unknown column {stmt.column!r}")
            if stmt.column in t.key_columns \
                    or stmt.column in (t.partition_by or []):
                raise QueryError(
                    f"cannot drop key/partition column {stmt.column!r}")
            ttl = getattr(t, "ttl", None)
            if ttl is not None and ttl[0] == stmt.column:
                raise QueryError(
                    f"column {stmt.column!r} is the TTL column")
            serial = getattr(t, "serial_next", None)
            if serial is not None:
                serial.pop(stmt.column, None)
            try:
                t.drop_column(stmt.column)
            except ValueError as e:     # e.g. column still indexed
                raise QueryError(str(e)) from e
        if self.catalog.store is not None:
            self.catalog.store.save_catalog(self.catalog)
            self.catalog.store.save_dictionaries(t)
        return _unit_block()

    def _insert(self, stmt: ast.Insert, snap=None, tx=None) -> HostBlock:
        table = self._table(stmt.table)
        if tx is not None:
            # a blind VALUES insert/upsert only WRITES the target:
            # pk-granular write locks (row stores) or commuting appends
            # (column stores) — duplicate-pk races are caught by the
            # point-conflict check at commit. INSERT ... SELECT may READ
            # the target (self-reference) and its source reads aren't
            # separately locked, so it keeps the table-granular lock.
            tx.lock(table, read=stmt.query is not None)
        if stmt.query is not None:
            return self._insert_select(stmt, table, snap, tx)
        names = stmt.columns or table.schema.names
        data: dict[str, list] = {n: [] for n in names}
        from ydb_tpu_torch.query.binder import _try_fold
        for row in stmt.rows:
            if len(row) != len(names):
                raise QueryError("VALUES arity mismatch")
            for n, lit in zip(names, row):
                if isinstance(lit, ast.Literal) and lit.value is None:
                    data[n].append(None)
                    continue
                folded = _try_fold(lit)   # literals, -x, DATE '...', CAST
                if folded is None:
                    raise QueryError("VALUES must be constant expressions")
                data[n].append(folded.value)

        # SERIAL columns omitted from the column list draw from the
        # table's sequence (the sequenceshard analog); counters persist
        # via the catalog and heal from data maxima at recovery
        serial = getattr(table, "serial_next", None)
        if serial:
            n_rows = len(stmt.rows)
            changed = False
            for c, nxt in list(serial.items()):
                if c not in data:
                    data[c] = list(range(nxt, nxt + n_rows))
                    names = list(names) + [c]
                    serial[c] = nxt + n_rows
                    changed = True
                else:
                    # explicit values advance the counter past their max
                    # (same-session duplicates, not just post-restart heal)
                    mx = max((int(v) for v in data[c] if v is not None),
                             default=0)
                    if mx >= serial[c]:
                        serial[c] = mx + 1
                        changed = True
            if changed and self.catalog.store is not None:
                self.catalog.store.save_catalog(self.catalog)

        if getattr(table, "store_kind", "column") == "row":
            ops = []
            for i in range(len(stmt.rows)):
                ops.append((stmt.mode, {n: data[n][i] for n in names}))
            try:
                self._apply_row_ops(table, ops, tx)
                self.last_rows_affected = len(ops)
            except ValueError as e:
                raise QueryError(str(e)) from e
            return _unit_block()

        arrays, valids = {}, {}
        n_rows = len(stmt.rows)
        for c in table.schema:
            if c.name in data:
                vals = data[c.name]
                mask = np.array([v is not None for v in vals])
                if c.dtype.is_string:
                    codes = table.dictionaries[c.name].encode(
                        [None if v is None else str(v) for v in vals])
                    arrays[c.name] = codes
                else:
                    arrays[c.name] = np.array(
                        [0 if v is None else v for v in vals], dtype=c.dtype.np)
                if not mask.all():
                    if not c.dtype.nullable:
                        raise QueryError(f"NULL in NOT NULL column {c.name}")
                    valids[c.name] = mask
            else:
                if not c.dtype.nullable:
                    raise QueryError(f"missing NOT NULL column {c.name}")
                arrays[c.name] = np.zeros(n_rows, dtype=c.dtype.np)
                valids[c.name] = np.zeros(n_rows, dtype=bool)
        block = HostBlock.from_arrays(table.schema, arrays, valids,
                                      dict(table.dictionaries))
        if tx is not None:
            writes = table.write(block, tx=tx.tx_id)
            tx.col_writes.append((table, writes))
            tx.note_self_bump(table)   # staged write bumps data_version
            self.last_rows_affected = block.length
            return _unit_block()
        writes = table.write(block)
        with self._commit_step() as version:
            table.commit(writes, version)
        self.last_rows_affected = block.length
        table.indexate(self._maintenance_watermark(),
                       compact=self.config.flag("enable_auto_compaction"))
        self._maybe_split(table)
        return _unit_block()

    def _maybe_split(self, table) -> None:
        """Auto-split trigger at commit points (the table-stats split of
        `schemeshard__table_stats.cpp`, collapsed to a row threshold)."""
        if not getattr(table, "maybe_split", None):
            return
        if table.maybe_split(self.config.shard_split_rows):
            from ydb_tpu_torch.utils.metrics import GLOBAL
            GLOBAL.inc("engine/shard_splits")
            if self.catalog.store is not None:
                self.catalog.store.save_catalog(self.catalog)

    def _apply_row_ops(self, table, ops, tx) -> None:
        """Row-table mutation: immediate at a fresh version (autocommit)
        or staged under the open transaction."""
        if not ops:
            return
        if tx is not None:
            table.apply(ops, None, durable=False, tx=tx.tx_id)
            tx.row_writes.append((table, ops))
            # pk-granular write lock: a tx that only WRITES this table
            # validates point conflicts on these keys, not the whole
            # table's data_version
            tx.note_self_bump(table, write_pks=table.pks_of_ops(ops))
        else:
            with self._commit_step() as version:
                table.apply(ops, version)


    # -- UPDATE / DELETE ---------------------------------------------------
    #
    # Row tables (DataShard analog): evaluate the WHERE through the normal
    # query path, then apply point mutations on the version chains — MVCC
    # snapshots keep seeing the old rows.
    #
    # Column tables: evaluated the same way, then applied as MVCC delete
    # marks on immutable portions (storage/portion.py DeleteMark) — time
    # travel preserved, transactional staging supported; UPDATE commits
    # its marks and re-inserts through one intent-journal record.

    def _update(self, stmt: ast.Update, snap=None, tx=None) -> HostBlock:
        table = self._table(stmt.table)
        if tx is not None:
            tx.lock(table)
        set_cols = [c for (c, _e) in stmt.assignments]
        for c in set_cols:
            if c in table.key_columns:
                raise QueryError("UPDATE of primary key columns is not "
                                 "supported (DELETE + INSERT)")
        # constant assignments (incl. string literals, which the binder
        # cannot type outside comparisons) apply directly; computed
        # expressions evaluate through the query path
        from ydb_tpu_torch.query.binder import _try_fold
        const_vals: dict = {}
        computed: list = []
        for (c, e) in stmt.assignments:
            if isinstance(e, ast.Literal) and e.value is None:
                const_vals[c] = None
                continue
            folded = _try_fold(e)
            if folded is not None:
                const_vals[c] = folded.value
            else:
                computed.append((c, e))

        if getattr(table, "store_kind", "column") == "row":
            items = [ast.SelectItem(ast.Name((k,)), k)
                     for k in table.key_columns]
            items += [ast.SelectItem(e, f"__set_{c}")
                      for (c, e) in computed]
            df = self._run_select(ast.Select(
                items=items, relation=ast.TableRef(stmt.table),
                where=stmt.where), snap).to_pandas()
            ops = []
            for row in df.to_dict("records"):
                vals = {k: _native(row[k]) for k in table.key_columns}
                vals.update(const_vals)
                vals.update({c: _native(row[f"__set_{c}"])
                             for (c, _e) in computed})
                ops.append(("upsert", vals))
            self._apply_row_ops(table, ops, tx)
            self.last_rows_affected = len(ops)
            return _unit_block()
        # column table: select full updated rows at the snapshot, mark the
        # originals deleted (MVCC delete marks — historical snapshots keep
        # the old rows), re-insert the new versions at the same commit
        items = [ast.SelectItem(ast.Name((c,)), c)
                 for c in table.schema.names]
        items += [ast.SelectItem(e, f"__set_{c}") for (c, e) in computed]
        df = self._run_select(ast.Select(
            items=items, relation=ast.TableRef(stmt.table),
            where=stmt.where), snap).to_pandas()
        for (c, _e) in computed:
            df[c] = df.pop(f"__set_{c}")
        for c, v in const_vals.items():
            df[c] = v
        hits = self._column_delete_hits(table, stmt.where, snap)
        n_hits = sum(len(rows) for (_s, _p, rows) in hits)
        if tx is not None:
            if n_hits != len(df):
                # portion hits only cover indexed rows: a mismatch means
                # the predicate matched rows STAGED by this same open tx
                # (indexation cannot convert them) — marking would miss
                # them and the re-insert would duplicate
                raise QueryError(
                    "UPDATE of rows inserted in the same transaction is "
                    "not supported yet (commit the insert first)")
            if not len(df):
                self.last_rows_affected = 0
                return _unit_block()
            handles = table.stage_deletes(hits, tx.tx_id)
            if handles:
                tx.note_self_bump(table)      # stage_deletes bump
                tx.col_deletes.append((table, handles))
            block = HostBlock.from_pandas(
                df[list(table.schema.names)], schema=table.schema,
                dictionaries=table.dictionaries)
            writes = table.write(block, tx=tx.tx_id)
            tx.col_writes.append((table, writes))
            tx.note_self_bump(table)  # staged write bump
        else:
            if not len(df):
                self.last_rows_affected = 0
                return _unit_block()
            block = HostBlock.from_pandas(
                df[list(table.schema.names)], schema=table.schema,
                dictionaries=table.dictionaries)
            writes = table.write(block)
            # marks + new rows in ONE commit (one intent record): a crash
            # must never leave a pure delete or a duplicating insert
            with self._commit_step() as version:
                table.commit(writes, version, deletes=hits)
            table.indexate(self._maintenance_watermark(),
                           compact=self.config.flag(
                               "enable_auto_compaction"))
        self.last_rows_affected = len(df)
        return _unit_block()

    def _delete(self, stmt: ast.Delete, snap=None, tx=None) -> HostBlock:
        table = self._table(stmt.table)
        if tx is not None:
            tx.lock(table)
        if getattr(table, "store_kind", "column") == "row":
            items = [ast.SelectItem(ast.Name((k,)), k)
                     for k in table.key_columns]
            df = self._run_select(ast.Select(
                items=items, relation=ast.TableRef(stmt.table),
                where=stmt.where), snap).to_pandas()
            ops = [("delete", {k: _native(row[k])
                               for k in table.key_columns})
                   for row in df.to_dict("records")]
            self._apply_row_ops(table, ops, tx)
            self.last_rows_affected = len(ops)
            return _unit_block()
        hits = self._column_delete_hits(table, stmt.where, snap)
        n = sum(len(rows) for (_s, _p, rows) in hits)
        if tx is not None:
            cnt = int(self._run_select(ast.Select(
                items=[ast.SelectItem(
                    ast.FuncCall("count", (), star=True), "c")],
                relation=ast.TableRef(stmt.table),
                where=stmt.where), snap).to_pandas().iloc[0, 0])
            if n != cnt:
                raise QueryError(
                    "DELETE of rows inserted in the same transaction is "
                    "not supported yet (commit the insert first)")
            handles = table.stage_deletes(hits, tx.tx_id)
            if handles:
                tx.note_self_bump(table)
                tx.col_deletes.append((table, handles))
        elif hits:
            with self._commit_step() as version:
                table.apply_deletes(hits, version)
        self.last_rows_affected = n
        return _unit_block()

    def _column_delete_hits(self, table, where, snap=None) -> list:
        """Matching rows per portion at the snapshot: [(shard, portion,
        row indices)] — the input of the MVCC delete-mark path (the r3
        portion-rewrite delete destroyed time travel; marks preserve it)."""
        keys = table.key_columns
        pks = self._run_select(ast.Select(
            items=[ast.SelectItem(ast.Name((k,)), k) for k in keys],
            relation=ast.TableRef(table.name),
            where=where), snap).to_pandas().drop_duplicates()
        if pks.empty:
            return []
        with self.tracer.span("column-delete-hits", keys=len(pks)):
            # inserts → portions first: marks attach to portions (staged
            # inserts are transient; indexation makes them markable)
            table.indexate(self._maintenance_watermark(),
                           compact=self.config.flag(
                               "enable_auto_compaction"))
            snap = snap or self.snapshot()
            hits = []
            for shard in table.shards:
                for p in shard.portions:
                    if not snap.includes(p.version):
                        continue
                    kdf = p.block.select(keys).to_pandas()
                    kdf["__pos"] = np.arange(len(kdf))
                    hit = kdf.merge(pks, on=keys, how="inner")["__pos"] \
                             .to_numpy()
                    dead = p.visible_dead(snap)
                    if dead is not None:
                        hit = np.setdiff1d(hit, dead)
                    if len(hit):
                        hits.append((shard, p, hit))
        return hits

    def _insert_select(self, stmt: ast.Insert, table, snap=None,
                       tx=None) -> HostBlock:
        block = self._run_select(stmt.query, snap)
        df = block.to_pandas()
        self.last_rows_affected = len(df)
        names = stmt.columns or table.schema.names
        if len(df.columns) != len(names):
            raise QueryError("INSERT ... SELECT arity mismatch")
        df.columns = names
        # SERIAL columns draw from the sequence here too (the VALUES path
        # does the same); explicit values advance the counter
        serial = getattr(table, "serial_next", None)
        if serial:
            changed = False
            for c, nxt in list(serial.items()):
                if c not in df.columns:
                    df[c] = range(nxt, nxt + len(df))
                    names = list(names) + [c]
                    serial[c] = nxt + len(df)
                    changed = True
                else:
                    vals = [int(v) for v in df[c] if v is not None]
                    mx = max(vals, default=0)
                    if mx >= serial[c]:
                        serial[c] = mx + 1
                        changed = True
            if changed and self.catalog.store is not None:
                self.catalog.store.save_catalog(self.catalog)
        if getattr(table, "store_kind", "column") == "row":
            # ops carry only the named columns — "upsert" must keep the
            # unmentioned ones, so no null-filling here (apply() enforces
            # NOT NULL for genuinely absent values)
            ops = [(stmt.mode, {c: _native(v) for c, v in row.items()})
                   for row in df.to_dict("records")]
            try:
                self._apply_row_ops(table, ops, tx)
            except ValueError as e:
                raise QueryError(str(e)) from e
            return _unit_block()
        # null-fill unspecified columns (the VALUES path's semantics)
        for c in table.schema:
            if c.name not in df.columns:
                if not c.dtype.nullable:
                    raise QueryError(f"missing NOT NULL column {c.name}")
                df[c.name] = None
        df = df[list(table.schema.names)]
        if tx is not None and len(df):
            from ydb_tpu_torch.core.block import HostBlock as _HB
            blk = _HB.from_pandas(df, schema=table.schema,
                                  dictionaries=table.dictionaries)
            writes = table.write(blk, tx=tx.tx_id)
            tx.col_writes.append((table, writes))
            tx.note_self_bump(table)   # staged write bumps data_version
            return _unit_block()
        if len(df):
            with self._commit_step() as version:
                table.bulk_upsert(df, version)
        return _unit_block()


def _native(v):
    """pandas cell → python native (None for NA; unwrap numpy scalars)."""
    import pandas as pd
    if v is None or (isinstance(v, float) and v != v):
        return None
    try:
        if pd.isna(v):
            return None
    except (TypeError, ValueError):
        pass
    return v.item() if hasattr(v, "item") else v


def _unit_block() -> HostBlock:
    return HostBlock(Schema([]), {}, 0)
