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
device, worker-to-worker edges ride the ICI plane (`dq/ici.py`).
Not ported here: gRPC endpoints, INSERT/UPSERT routing and two-phase
commit (`cluster/dtx.py`, ROADMAP Queue 1 items 3 and 8), Hive
placement and failover (item 8) and the distributed EXPLAIN (item 2)
raise `NotPorted`.
"""

from __future__ import annotations

from typing import Optional

import pandas as pd

from ydb_tpu_torch.errors import NotPorted
from ydb_tpu_torch.sql import ast, parse


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
        stages), merge router-side."""
        stmt = parse(sql)
        if isinstance(stmt, ast.Explain):
            raise NotPorted("the distributed EXPLAIN (ROADMAP Queue 1 "
                            "item 2)")
        if not isinstance(stmt, ast.Select):
            raise ClusterError("the router distributes SELECT; use "
                               "execute() for DDL/DML")
        from ydb_tpu_torch.dq.lower import table_names
        refs = table_names(stmt.relation) if stmt.relation is not None \
            else []
        if refs and all(t.startswith(".sys/") for t in refs):
            raise NotPorted("system views")
        return self._run_traced(stmt)

    def _run_traced(self, stmt: ast.Select) -> pd.DataFrame:
        """Lower and run one graph (the port has no tracer: the run
        records no spans, only `last_stage_stats`)."""
        from ydb_tpu_torch.dq.runner import DqError, DqTaskRunner
        graph = self._lower(stmt)
        runner = DqTaskRunner(self.workers, self.engine)
        try:
            return runner.run(graph)
        except DqError as e:
            raise ClusterError(str(e)) from e
        finally:
            self.last_stage_stats = list(runner.stage_stats)
