"""Multi-query batched dispatch lane (continuous batching for SQL).

The north-star traffic shape is millions of concurrent point-lookup /
small-SELECT clients. The query pipeline overlaps their readouts, and
parameter lifting (`query/paramlift.py`) already collapses their
compiles to one executable per plan SHAPE — but each client still pays
its own device dispatch and its own device→host readout, and each
carries a fixed cost of its own. The inference-serving answer is to batch:
same-shape arrivals inside a small time window coalesce into ONE
stacked execution (`Executor.execute_fused_batched` — a vmap over the
members' lifted literals, DrJAX-style mapped composition, arxiv
2403.07128), each client's result resolving to its slice.

`YDB_TPU_BATCH_WINDOW` (milliseconds; 0 = off, the default) is the A/B
switch: off is byte-identical to the per-query pipeline path. A group
seals EARLY when it reaches `YDB_TPU_BATCH_MAX` members (default 64),
so a thundering herd pays no window latency; sparse traffic pays at
most one window per query.

Grouping is correctness-first. Two statements coalesce only when:

  * their `lift_sig`s match — same prune-stripped plan shape, so one
    compiled program serves both (the batched execution runs UN-pruned:
    pruning's outcome is literal-dependent and cannot partition a
    shared scan; the filter programs still apply every predicate);
  * every table either statement scans presents the IDENTICAL visible
    source set (src ids) at both snapshots — the superblock cache's
    data-identity discipline, so executing at the leader's snapshot is
    exact for every member (explicit-tx snapshots with older pins
    simply land in their own groups);
  * their build-affecting lifted literals agree — join builds execute
    once per batch, with the leader's values.

Admission discipline (the double-charge fix): members do NOT take
individual admission reservations or pipeline-window slots. The leader
takes ONE window slot and ONE byte reservation sized to the stacked
execution (`admission.batch_reservation_bytes`) spanning dispatch and
readout — N nominal slots for one physical execution could deadlock
the window under storm load.

Counters: batch/batches, batch/coalesced_queries, batch/max_size,
batch/singles, batch/fallbacks, batch/declined, batch/trace_errors,
plus paramlift's batch/lift_hits / batch/lift_misses; EXPLAIN ANALYZE
carries a `batching` block per statement (QueryStats.batching).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from ydb_tpu_torch.ops import ir
from ydb_tpu_torch.query.plan import QueryPlan


class _Group:
    __slots__ = ("members", "sealed", "full", "done", "results", "exc",
                 "batched")

    def __init__(self):
        self.members: list = []       # [(plan, params, snap, est)]
        self.sealed = False
        self.full = threading.Event()
        self.done = threading.Event()
        self.results: Optional[list] = None
        self.exc: Optional[BaseException] = None
        self.batched = False


def _has_groupby(plan: QueryPlan) -> bool:
    pipe = plan.pipeline
    progs = [pipe.partial, plan.final_program]
    return any(p is not None and any(isinstance(c, ir.GroupBy)
                                     for c in p.commands) for p in progs)


def _plan_tables(plan: QueryPlan, out: Optional[set] = None) -> set:
    """Every table any pipeline of the plan scans (builds included)."""
    if out is None:
        out = set()

    def walk_pipe(pipe):
        out.add(pipe.scan.table)
        for kind, step in pipe.steps:
            if kind != "join":
                continue
            b = step.build
            if isinstance(b, QueryPlan):
                _plan_tables(b, out)
            else:
                walk_pipe(b)

    walk_pipe(plan.pipeline)
    return out


class BatchLane:
    def __init__(self, engine, window_s: float, max_batch: int = 64):
        self.engine = engine
        self.window_s = window_s
        self.max_batch = max(1, int(max_batch))
        self._mu = threading.Lock()
        self._groups: dict = {}              # guarded-by: _mu
        # (table, uid, data_version, snap.plan_step) -> src-id sig memo:
        # between commits the coordinator publishes no new plan step, so
        # a storm's members all hit one entry; ANY commit advances the
        # step and naturally invalidates (compaction/indexation run at
        # commit points). Bounded: cleared when it outgrows the window.
        self._sig_memo: dict = {}            # guarded-by: _mu

    # -- eligibility / grouping --------------------------------------------

    def _group_key(self, plan: QueryPlan, snap, est: int):
        from ydb_tpu_torch.query.paramlift import build_lift_values
        if getattr(plan, "lift_sig", None) is None:
            return None
        if plan.init_subplans:
            # precompute stages run their own sub-SELECTs; keep them on
            # the per-query path
            return None
        ex = self.engine.executor
        if not ex.enable_fused:
            return None
        if ex.mesh is not None and ex.mesh.devices.size > 1:
            return None
        # working-set gate: vmapped execution materializes B copies of
        # every cap-sized intermediate (masks, filtered columns) whatever
        # the OUTPUT shape — a LIMIT or GROUP BY bounds only the result.
        # Shapes whose stacked intermediates could approach the fused
        # scan budget stay on the per-query path (where admission queues
        # them one at a time); un-limited un-aggregated outputs keep the
        # tighter merge-budget bound, since B full result buffers also
        # cross to the host.
        if est * self.max_batch > ex.fused_scan_budget_bytes:
            return None
        if plan.limit is None and not _has_groupby(plan) \
                and est * self.max_batch > ex.merge_budget_bytes:
            return None
        try:
            data_sig = tuple(self._table_sig(t, snap)
                             for t in sorted(_plan_tables(plan)))
        except (AttributeError, KeyError):
            return None      # row-store scan / dropped table: no src ids
        return (plan.lift_sig, data_sig, build_lift_values(plan))

    def _table_sig(self, name: str, snap) -> tuple:
        from ydb_tpu_torch.storage.device_cache import enumerate_scan_sources
        t = self.engine.catalog.table(name)
        memo_key = (name, t.uid, t.data_version, snap.plan_step)
        with self._mu:
            sig = self._sig_memo.get(memo_key)
        if sig is None:
            # enumerate outside the lock (it walks portions); publish
            # under it — storm threads raced clear()+setitem unguarded
            # here before the locks pass caught it
            _sources, ids = enumerate_scan_sources(t, snap, None)
            sig = (t.uid, t.data_version, tuple(ids))
            with self._mu:
                if len(self._sig_memo) > 256:
                    self._sig_memo.clear()
                self._sig_memo[memo_key] = sig
        return sig

    # -- entry -------------------------------------------------------------

    def try_run(self, plan: QueryPlan, snap, est: int, stats=None):
        """Coalesce this SELECT into a same-shape batch and return its
        HostBlock, or None when the statement isn't lane-eligible (the
        caller runs the normal per-query pipeline)."""
        from ydb_tpu_torch.query.admission import AdmissionTimeout
        from ydb_tpu_torch.utils.metrics import GLOBAL

        key = self._group_key(plan, snap, est)
        if key is None:
            GLOBAL.inc("batch/declined")
            return None
        with self._mu:
            g = self._groups.get(key)
            leader = g is None or g.sealed or len(g.members) >= self.max_batch
            if leader:
                g = _Group()
                self._groups[key] = g
            idx = len(g.members)
            g.members.append((plan, dict(plan.params), snap, est))
            if len(g.members) >= self.max_batch:
                g.full.set()             # herd: seal without window latency
        if leader:
            # the WHOLE leader section runs under one finally: a
            # BaseException during the window wait or the seal (not just
            # inside _execute) must still seal the group and release the
            # followers — an unsealed leaderless group would keep
            # collecting arrivals that block until their deadline
            try:
                # continuous-batching probe: a leader that is still
                # ALONE after a ~2 ms grace executes immediately —
                # sparse traffic must not pay the window as latency.
                # Only evidence of concurrency (a follower already
                # queued) buys the full window; a herd seals even
                # earlier via the full event.
                probe = min(0.002, self.window_s)
                if not g.full.wait(probe):
                    with self._mu:
                        alone = len(g.members) <= 1
                    if not alone:
                        g.full.wait(max(self.window_s - probe, 0.0))
                with self._mu:
                    g.sealed = True
                    if self._groups.get(key) is g:
                        del self._groups[key]
                    members = list(g.members)
                g.results, g.batched = self._execute(members)
            except Exception as e:       # noqa: BLE001 — fanned out below
                g.exc = e
            finally:
                with self._mu:
                    g.sealed = True
                    if self._groups.get(key) is g:
                        del self._groups[key]
                if g.results is None and g.exc is None:
                    # a BaseException (KeyboardInterrupt) tore the leader
                    # out mid-batch: followers must not hang on it
                    g.exc = RuntimeError("batch leader aborted")
                g.done.set()
        ok = g.done.wait(self.engine.admission.timeout_s
                         + self.window_s + 60.0)
        if not ok:
            GLOBAL.inc("batch/window_timeouts")
            raise AdmissionTimeout(
                "batched dispatch did not complete inside the admission "
                "deadline (leader stalled)")
        if g.exc is not None:
            raise g.exc
        if stats is not None:
            stats.batching = {"coalesced": len(g.results),
                              "leader": leader,
                              "batched": g.batched}
        if g.batched:
            self.engine.executor.last_path = "fused-batched"
        return g.results[idx]

    # -- leader ------------------------------------------------------------

    def _execute(self, members: list):
        """Run one sealed batch under ONE window slot + ONE admission
        reservation; returns ([HostBlock] in member order, batched?)."""
        from ydb_tpu_torch.query.admission import (
            AdmissionTimeout, batch_reservation_bytes,
        )
        from ydb_tpu_torch.utils.metrics import GLOBAL

        eng = self.engine
        B = len(members)
        if not eng._pipe_sem.acquire(timeout=eng.admission.timeout_s):
            GLOBAL.inc("pipeline/window_timeouts")
            raise AdmissionTimeout(
                f"pipeline window saturated: {eng.pipeline_window} "
                "queries dispatched-or-queued for longer than the "
                "admission deadline (batched dispatch)")
        try:
            est = batch_reservation_bytes(max(m[3] for m in members), B)
            with eng.admission.admit(est):
                GLOBAL.inc("batch/reservations")
                leader_plan, _p, snap, _e = members[0]
                if B == 1:
                    # nothing coalesced: the per-query executable (with
                    # pruning) already exists — don't compile a
                    # batch-of-1 variant for sparse traffic
                    GLOBAL.inc("batch/singles")
                    return [eng.executor.execute(leader_plan, snap)], False
                pipe = leader_plan.pipeline
                plan_b = dataclasses.replace(
                    leader_plan, pipeline=dataclasses.replace(
                        pipe, scan=dataclasses.replace(pipe.scan,
                                                       prune=[])))
                blocks = eng.executor.execute_fused_batched(
                    plan_b, [(m[0], m[1]) for m in members], snap)
                if blocks is None:
                    # shape declined at execution depth (expanding probe,
                    # tiled-class scan, vmap trace failure): serve every
                    # member individually under the held reservation
                    GLOBAL.inc("batch/fallbacks")
                    return [eng.executor.execute(m[0], m[2])
                            for m in members], False
                GLOBAL.inc("batch/batches")
                GLOBAL.inc("batch/coalesced_queries", B)
                GLOBAL.set_max("batch/max_size", B)
                return blocks, True
        finally:
            eng._pipe_sem.release()
