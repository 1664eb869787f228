"""Memory admission for concurrent queries (the KQP resource-manager seat).

The reference admits queries against per-node memory pools
(`ydb/core/kqp/rm_service/kqp_rm_service.h:68` — TxMemory limits with
queueing at the session/executer boundary). Here: a byte-budget gate over
the device working set — each query's scan + build estimate reserves
budget before dispatch, waits (bounded) when the chip is oversubscribed,
and sheds with an admission error past the deadline. Estimates above the
whole budget clamp to it, so giant (tiled/spilled) queries serialize
against everything rather than deadlock.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class AdmissionTimeout(Exception):
    pass


class MemoryAdmission:
    def __init__(self, budget_bytes: int, timeout_s: float = 60.0):
        self.budget = int(budget_bytes)
        self.timeout_s = timeout_s
        self.in_flight = 0
        self.active = 0
        self._cv = threading.Condition()

    @contextmanager
    def admit(self, est_bytes: int):
        from ydb_tpu_torch.utils.metrics import GLOBAL
        est = max(0, min(int(est_bytes), self.budget))
        with self._cv:
            t_enter = time.monotonic()
            deadline = t_enter + self.timeout_s
            waited = False
            while self.in_flight + est > self.budget:
                waited = True
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    GLOBAL.inc("admission/timeouts")
                    raise AdmissionTimeout(
                        f"memory admission timed out: need {est} bytes, "
                        f"{self.budget - self.in_flight} free of "
                        f"{self.budget} (queries queue while the device "
                        f"is oversubscribed)")
            if waited:
                GLOBAL.inc("admission/waits")
            self.in_flight += est
            self.active += 1
            GLOBAL.set("admission/in_flight_bytes", self.in_flight)
            GLOBAL.set("admission/active_queries", self.active)
        try:
            yield
        finally:
            with self._cv:
                self.in_flight -= est
                self.active -= 1
                GLOBAL.set("admission/in_flight_bytes", self.in_flight)
                GLOBAL.set("admission/active_queries", self.active)
                self._cv.notify_all()

    def backlog(self) -> dict:
        """Queue snapshot for the compile-ahead observability surfaces
        (`.sys/progstore`, ProgStoreStats): active reservations,
        reserved bytes, free bytes — the wait a background compile
        overlaps with."""
        with self._cv:
            return {"active": self.active,
                    "in_flight_bytes": self.in_flight,
                    "free_bytes": max(0, self.budget - self.in_flight)}


def batch_reservation_bytes(est_bytes: int, n_members: int,
                            member_floor: int = 1 << 20) -> int:
    """ONE reservation for a coalesced batch (`query/batch_lane.py`).

    Charging each member its full scan+build estimate as an independent
    nominal-slot reservation would both multiply-count the shared
    superblock AND risk deadlocking the pipeline window against
    admission; charging only the leader's estimate would under-count the
    vmapped execution, which materializes one cap-sized copy of every
    intermediate PER MEMBER. The honest size of the stacked execution is
    therefore one reservation of ~N x the per-member estimate (floored
    for tiny scans); estimates above the whole budget clamp there and
    serialize against everything, like any giant query."""
    return int(est_bytes) + max(0, n_members - 1) * \
        max(int(member_floor), int(est_bytes))


def estimate_plan_bytes(catalog, plan, snapshot) -> int:
    """Device-byte estimate for a SELECT plan: the driving scan's columns
    at the table's row count, plus each join build's scan (one level deep
    — build subplans estimate their own driving scan).

    Deliberately stats-only (row counts × column widths; the bounds
    lattice adds portion-STATS prune previews and build output bounds,
    never block data): the executor enumerates the actual scan sources
    right after admission — re-walking blocks here would do it twice.

    Bounds-lattice tightening (`query/bounds.py`, YDB_TPU_BOUNDS):
      * the driving scan honors the plan's prune predicates against
        portion min/max stats — the q12/q20 prune-blind outlier class
        (a scan pruned to one month estimated at the full table);
      * a join build reserves min(scan, proven output bound × width) —
        builds MATERIALIZE at output cardinality, so a grouped/limited/
        bounded-multiplicity build stops double-charging its driving
        scan (the q21 class).

    Join-payload copy term: the fused probe materializes each build
    payload column at PROBE capacity — on q7/q9 that padded copy is most
    of the gap between the scan+build estimate and the peak. With late
    materialization (`YDB_TPU_LATE_MAT`) the
    probe threads a 5-byte (row-id, match) pair instead, and payload
    widths materialize once at build cardinality (bound-sized tail) —
    the estimate charges whichever execution the lever selects."""
    import numpy as np

    from ydb_tpu_torch.ops.torch_exec import late_mat_enabled
    from ydb_tpu_torch.query.bounds import (bounds_enabled, build_bytes_bound,
                                      scan_rows_bound)
    from ydb_tpu_torch.utils.metrics import GLOBAL
    lattice = bounds_enabled()
    late = late_mat_enabled()
    memo: dict = {}                    # one stats walk per plan node

    def pipe_rows(pipe) -> int:
        try:
            table = catalog.table(pipe.scan.table)
        except KeyError:
            return 0
        rows = getattr(table, "num_rows", 0)
        if rows and lattice and pipe.scan.prune:
            rows = min(rows, scan_rows_bound(catalog, pipe.scan, snapshot)
                       or rows)
        return int(rows)

    def pipe_bytes(pipe) -> int:
        rows = pipe_rows(pipe)
        if not rows:
            return 0
        table = catalog.table(pipe.scan.table)
        per_row = 0
        for (s, _i) in pipe.scan.columns:
            if not table.schema.has(s):
                continue
            dt = table.schema.dtype(s)
            per_row += np.dtype(dt.np).itemsize + (1 if dt.nullable else 0)
        return rows * per_row

    def payload_width(bp, step) -> int:
        """Per-row bytes of the payload columns a probe attaches
        (data + validity; unresolvable names assume a wide 9-byte
        column — overcharging beats under-admitting)."""
        try:
            table = catalog.table(bp.scan.table)
        except KeyError:
            return 9 * len(step.payload)
        w = 0
        for name in step.payload:
            if table.schema.has(name):
                dt = table.schema.dtype(name)
                w += np.dtype(dt.np).itemsize + 1   # probe payloads
                #                                     are nullable-tagged
            else:
                w += 9                 # derived/renamed build column
        return w

    total = pipe_bytes(plan.pipeline)
    probe_rows = pipe_rows(plan.pipeline)
    for kind, step in plan.pipeline.steps:
        if kind != "join":
            continue
        build = step.build
        bp = getattr(build, "pipeline", build)   # QueryPlan | Pipeline
        if not hasattr(bp, "scan"):
            continue
        scan_est = pipe_bytes(bp)
        if lattice:
            bb = build_bytes_bound(catalog, step, snapshot, memo)
            if bb and bb < scan_est:
                GLOBAL.inc("bounds/admission_capped_bytes",
                           scan_est - bb)
                scan_est = bb
        total += scan_est
        # the probe-time copy of this join's output columns
        if step.kind in ("inner", "left") and step.payload:
            width = payload_width(bp, step)
            if late:
                # (int32 row-id + bool match) per probe row; widths
                # materialize once at build cardinality
                total += probe_rows * 5 + pipe_rows(bp) * width
            else:
                total += probe_rows * width
        elif step.kind == "mark":
            total += probe_rows       # 1-byte match-flag column
    return total
