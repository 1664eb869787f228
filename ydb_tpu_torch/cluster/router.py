"""Multi-node seam: a shard-aware SQL router over worker engines (port of
``ydb_tpu/cluster/router.py``).

N worker engines each own a shard of every sharded table's rows; the
router scatters work over the workers and gathers:

  * DDL broadcasts to every worker;
  * every SELECT lowers to a DQ STAGE GRAPH (`ydb_tpu_torch/dq/`):
    partial/merge aggregation, two-level distinct, order/limit scatter
    scans and sharded x sharded hash-shuffle joins are graph lowerings
    executed by one task runner over the workers.

Dimension tables are replicated (`replicated`): every worker holds a
full copy, so joins against them stay worker-local.

The port's workers are in-process objects with the worker surface
(`dq.runner.LocalWorker`). When every worker is in-process and has a
device, worker-to-worker edges ride the ICI plane (`dq/ici.py`). Every
SELECT's graph runs under one trace on the merge engine's tracer, the
workers' task spans ingested into it (`engine.last_trace`), and
`EXPLAIN [ANALYZE] <select>` returns the stage graph (with ANALYZE, the
per-task stats and the span tree of a run of that graph).
Not ported here: gRPC endpoints, INSERT/UPSERT routing and two-phase
commit (`cluster/dtx.py`, ROADMAP Queue 1 items 3 and 8) and Hive
placement and failover (item 8) raise `NotPorted`.
"""

from __future__ import annotations

from typing import Optional

import pandas as pd

from ydb_tpu_torch.errors import NotPorted
from ydb_tpu_torch.sql import ast, parse, render


class ClusterError(Exception):
    pass


class ShardedCluster:
    """Router over in-process worker engines (one engine per shard)."""

    def __init__(self, endpoints: list, merge_engine=None,
                 dtx_log: Optional[str] = None, dtx_replica=None,
                 hive=None):
        from ydb_tpu_torch.query import QueryEngine
        if any(not hasattr(ep, "execute") for ep in endpoints):
            raise NotPorted("gRPC worker endpoints (server.Client, ROADMAP "
                            "Queue 1 item 8)")
        if hive is not None:
            raise NotPorted("Hive placement and failover (ROADMAP Queue 1 "
                            "item 8)")
        if dtx_log is not None or dtx_replica is not None:
            raise NotPorted("two-phase commit (cluster/dtx.py, ROADMAP "
                            "Queue 1 items 3 and 8)")
        self.workers = list(endpoints)
        # local engine used for the merge stage (schema-free: merge runs
        # over the gathered partial frame registered as a temp table)
        self.engine = merge_engine or QueryEngine(block_rows=1 << 16)
        self.replicated: set = set()        # table names on every worker
        self.key_columns: dict = {}         # table -> [pk col]
        # the stage-stats rows of the last query's graph run (per task
        # and per ICI channel: rows, ici_bytes, seg, pad_efficiency)
        self.last_stage_stats: list = []

    # -- DDL / DML ----------------------------------------------------------

    def execute(self, sql: str, replicated: bool = False):
        """DDL: broadcast. INSERT/UPSERT routing is not ported."""
        stmt = parse(sql)
        if isinstance(stmt, ast.Insert):
            raise NotPorted("INSERT/UPSERT routing by primary-key hash "
                            "(ROADMAP Queue 1 item 3)")
        for w in self.workers:
            w.execute(sql)
        if isinstance(stmt, ast.CreateTable):
            # remember pk for insert routing
            self.key_columns[stmt.name] = list(stmt.primary_key)
            if replicated:
                self.replicated.add(stmt.name)
        return {"ok": True}

    # -- SELECT (DQ stage-graph path) ---------------------------------------

    def _table_columns(self, table: str) -> list:
        """Column names of a worker table (cached; schema probe)."""
        cache = self.__dict__.setdefault("_col_cache", {})
        cols = cache.get(table)
        if cols is None:
            resp = self.workers[0].execute(f"select * from {table} limit 0")
            cols = cache[table] = list(resp["columns"])
        return cols

    def _ici_devices(self) -> int:
        """Devices the DQ runner can drive directly: every worker is
        in-process (`ici_land`) and its engine has a device; then one
        device per worker (a device may repeat: workers that share a
        card). 0 = host plane only."""
        if not self.workers or \
                not all(hasattr(w, "ici_land") for w in self.workers):
            return 0
        if any(getattr(w, "device", None) is None for w in self.workers):
            return 0
        return len(self.workers)

    def _lower(self, stmt: ast.Select):
        from ydb_tpu_torch.dq.lower import (DqLowerError, DqTopology,
                                            lower_select)
        topo = DqTopology(n_workers=len(self.workers),
                          replicated=set(self.replicated),
                          key_columns=dict(self.key_columns),
                          ici_devices=self._ici_devices())
        try:
            return lower_select(stmt, topo, self._table_columns)
        except DqLowerError as e:
            raise ClusterError(str(e)) from e

    def plan(self, sql: str):
        """Lower a SELECT to its DQ stage graph without running it."""
        stmt = parse(sql)
        if not isinstance(stmt, ast.Select):
            raise ClusterError("only SELECT lowers to a stage graph")
        return self._lower(stmt)

    def query(self, sql: str) -> pd.DataFrame:
        """Distribute one SELECT: lower to a StageGraph, execute it with
        the task runner (one task per (stage, worker), channels between
        stages), merge router-side. The whole graph runs under ONE trace
        on the merge engine's tracer — the workers' task spans assemble
        into a single span tree (`engine.last_trace`).

        `EXPLAIN ANALYZE <select>` returns the distributed profile: the
        stage graph, per-(stage, worker) task stats and the assembled
        span tree, as a one-column frame."""
        stmt = parse(sql)
        if isinstance(stmt, ast.Explain):
            if not isinstance(stmt.query, ast.Select):
                raise ClusterError("EXPLAIN distributes SELECT only")
            return self._explain(stmt)
        if not isinstance(stmt, ast.Select):
            raise ClusterError("the router distributes SELECT; use "
                               "execute() for DDL/DML")
        from ydb_tpu_torch.dq.lower import table_names
        refs = table_names(stmt.relation) if stmt.relation is not None \
            else []
        if refs and all(t.startswith(".sys/") for t in refs):
            raise NotPorted("system views")
        df, _runner = self._run_traced(stmt, sql)
        return df

    def _run_traced(self, stmt: ast.Select, sql: str,
                    force_trace: bool = False, graph=None):
        """Lower (unless `graph` is given) and run one graph under a
        trace of its own; returns (frame, runner). `last_stage_stats`
        keeps the run's stage-stats rows."""
        import time as _time

        from ydb_tpu_torch.dq.runner import DqError, DqTaskRunner
        from ydb_tpu_torch.utils.metrics import GLOBAL_HIST
        if graph is None:
            graph = self._lower(stmt)
        runner = DqTaskRunner(self.workers, self.engine)
        eng = self.engine
        sampled = force_trace or eng._sample_decision(sql)
        eng.tracer.begin_trace(sampled=sampled)
        t0 = _time.perf_counter()
        rows_out = None
        try:
            with eng.tracer.span("dq-query", sql=sql[:60],
                                 workers=len(self.workers),
                                 stages=len(graph.stages)):
                df = runner.run(graph)
            rows_out = len(df)
            return df, runner
        except DqError as e:
            raise ClusterError(str(e)) from e
        finally:
            self.last_stage_stats = list(runner.stage_stats)
            total_ms = (_time.perf_counter() - t0) * 1000.0
            if rows_out is not None:
                # successes only, as the local path records latency
                GLOBAL_HIST.observe("query/latency_ms", total_ms)
                eng._note_slow(sql, total_ms, "dq-select")
            spans = eng.tracer.end_trace()
            if spans:
                eng.last_trace = spans
                # the DQ wall and rows pass explicitly: last_stats only
                # covers the router-merge statement
                eng._record_profile(
                    sql, spans, stage_stats=runner.stage_stats,
                    total_ms=round(total_ms, 3),
                    rows_out=rows_out or 0,
                    kind="dq-select" if rows_out is not None
                    else "dq-error",
                    memory=runner.mem_summary)

    def _explain(self, stmt: ast.Explain) -> pd.DataFrame:
        """Distributed EXPLAIN [ANALYZE]: the stage graph, and with
        ANALYZE the per-stage/per-channel profile of an actual run."""
        graph = self._lower(stmt.query)
        lines = [f"DQ stage graph: {len(graph.stages)} stages, "
                 f"{len(graph.channels)} channels, "
                 f"{len(self.workers)} workers"]
        for stage in graph.stages:
            lines.append(f"  stage {stage.id} on={stage.on} "
                         f"in={list(stage.inputs)} "
                         f"out={list(stage.outputs)}")
        # per-channel data plane: which edges go device-resident (ICI
        # collective) vs host gRPC frames — the operator-facing half of
        # the pluggable-plane lowering
        for ch in graph.channels.values():
            lines.append(
                f"  channel {ch.id} kind={ch.kind} plane={ch.plane}"
                + (f" key={ch.key}" if ch.key else "")
                + (f" quant_cols={ch.quant_cols}" if ch.quant_cols
                   else ""))
        if not stmt.analyze:
            return pd.DataFrame({"plan": lines})
        # run the SAME lowered graph the listing above describes —
        # re-lowering could diverge from the plan this output claims
        # to profile (and pays the lowering twice)
        df, runner = self._run_traced(stmt.query,
                                      render.select(stmt.query),
                                      force_trace=True, graph=graph)
        lines.append(f"-- rows out: {len(df)}")
        lines.append("-- stage stats (per task):")
        for r in runner.stage_stats:
            lines.append(
                f"  {r['stage']}@{r['worker']}: rows {r['rows']} | "
                f"bytes {r['bytes']} | frames {r['frames']} | "
                f"plane {r.get('plane', 'host')} | "
                f"ici-bytes {r.get('ici_bytes', 0)} | "
                f"exec {r['exec_ms']:.1f}ms | flush {r['flush_ms']:.1f}ms"
                f" | input-wait {r['input_wait_ms']:.1f}ms | "
                f"backpressure {r['backpressure_wait_ms']:.1f}ms | "
                f"attempts {r['attempts']}")
        tr = self.engine.tracer.render(self.engine.last_trace)
        if tr:
            lines += ["-- trace:"] + tr.split("\n")
        # the distributed critical path (extracted in _record_profile
        # from the SAME assembled tree rendered above): per-class % of
        # the graph wall + the dominant span — the worklist line
        from ydb_tpu_torch.utils import critpath
        prof = self.engine.profiles[-1] if self.engine.profiles else {}
        lines += critpath.render_lines(prof.get("critical_path") or {})
        return pd.DataFrame({"plan": lines})
