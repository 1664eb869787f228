"""Physical plan executor, single node (port of ``ydb_tpu/query/executor.py``).

The port carries the reference's two single-node lanes. The fused
whole-query path: the scan's (K, CAP) superblock on the engine's device,
the join builds prepared on the host and placed on the device, and the
query body (`ops/fused.py`) launched once, with the result read back in
one copy when the returned future is consumed. The portioned path, for
the plans the fused path declines (an empty scan, more joins than the
fuse cap, duplicate-key builds): each portion runs through the
pipeline's programs and probes on its own (`_run_pipeline`), and
`_finalize` concatenates the partials, runs the final program, sorts
and limits.

Beyond the device budgets (the reference's defaults, `YDB_TPU_*`):
- a scan whose stacked superblock exceeds `fused_scan_budget_bytes`
  streams through tiles of `tile_budget_bytes` (`_execute_fused_tiled`,
  `ops/fused.build_tile_fn`), its partials finalized together, spilled,
  or (non-aggregating plans) unioned on the host;
- a build side above `grace_budget_bytes` hash-partitions on the host
  (`ops/join.build_partitioned`, GraceJoin): the plan runs portioned and
  each scan block is routed to the partitions by the `partition` kernel;
- partial-aggregate states above `merge_budget_bytes` spill to host
  key-hash partitions (`ops/spill.py`, K14) and merge per partition.
The batched serving lane (`execute_fused_batched`, driven by
`query/batch_lane.py`) runs B same-shape SELECTs as one fused execution
with a member axis on the lifted params that differ.

On a mesh of more than one shard (`parallel/mesh.py`), a SELECT takes
one of the mesh lanes before the fused path: scan portions spread
round-robin over the shards and each shard runs the pipeline on its
portions. A two-phase aggregation merges its partials over the mesh
(`distributed`: `parallel/shuffle.DistributedAgg`); when the last join's
build is above `dist_broadcast_budget_bytes` (`YDB_TPU_DIST_BROADCAST_
BUDGET`), the build is partitioned over the shards and probe rows are
routed to their key's shard (`distributed-shuffle-join`:
`parallel/shuffle_join.ShuffleJoin`); a plan without an aggregation over
more than one scan source unions the shards' results on the host
(`distributed-map`).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from ydb_tpu_torch.core.block import ColumnData, HostBlock
from ydb_tpu_torch.core.schema import Column, Schema
from ydb_tpu_torch.ops import ir
from ydb_tpu_torch.ops import join as J
from ydb_tpu_torch.ops.device import (
    DeviceBlock, DeviceResultFuture, DeviceStageBlock, batched_to_host,
    bucket_capacity, to_device, to_host,
)
from ydb_tpu_torch.ops.torch_ns import storage_array, to_tensor, torch_dtype
from ydb_tpu_torch.progstore import buckets as shape_buckets
from ydb_tpu_torch.query.plan import JoinStep, Pipeline, QueryPlan
from ydb_tpu_torch.storage.mvcc import MAX_SNAPSHOT, Snapshot
from ydb_tpu_torch.utils.metrics import GLOBAL

class Executor:
    def __init__(self, catalog, device, block_rows: int = 1 << 20,
                 mesh=None):
        from ydb_tpu_torch.query.build_cache import BuildCache
        from ydb_tpu_torch.storage.device_cache import DeviceColumnCache
        self.catalog = catalog
        self.device = device
        # portion size of transient tables (materialized CTEs, derived
        # tables): the capacity their scans run at
        self.block_rows = block_rows
        # feature flag (utils/config.py): the whole-query fused path; off
        # sends every SELECT (and build pipeline) down the portioned path
        self.enable_fused = True
        self.device_cache = DeviceColumnCache(device)
        self._tls = threading.local()
        # build sides above this estimate hash-partition into a GraceJoin
        self.grace_budget_bytes = int(
            os.environ.get("YDB_TPU_GRACE_BUDGET", 1 << 29))
        # scans whose stacked superblock estimate exceeds this stream
        # through the tiled lane instead of residing on the device
        self.fused_scan_budget_bytes = int(
            os.environ.get("YDB_TPU_FUSED_SCAN_BUDGET", 6 << 30))
        # device bytes per scan tile on the tiled lane (2 tiles in flight)
        self.tile_budget_bytes = int(
            os.environ.get("YDB_TPU_TILE_BUDGET", 1 << 30))
        self.fuse_max_joins = int(
            os.environ.get("YDB_TPU_FUSE_MAX_JOINS", 6))
        # partial-agg states above this estimate spill to host memory and
        # merge per key-hash partition (K14)
        self.merge_budget_bytes = int(
            os.environ.get("YDB_TPU_MERGE_BUDGET", 1 << 30))
        self.build_cache = BuildCache(int(
            os.environ.get("YDB_TPU_BUILD_CACHE_BUDGET", 2 << 30)),
            device_cache=self.device_cache)
        # bound-sized compaction: measured live counts per compact-free
        # query identity (monotone max) and the chosen capacities
        self._compact_memo: dict = {}
        self._compact_caps: dict = {}
        # the device mesh of the distributed lanes (None, or a one-shard
        # mesh: single-device execution)
        self.mesh = mesh
        self._dist_aggs: dict = {}
        self._shuffle_joins: dict = {}
        # mesh joins: build sides above this estimate partition over the
        # shards (the shuffle join) instead of being placed on every shard
        self.dist_broadcast_budget_bytes = int(
            os.environ.get("YDB_TPU_DIST_BROADCAST_BUDGET", 256 << 20))

    # DQ task-graph runtime (`dq/`): >0 while THIS THREAD runs a
    # statement as a stage program of a distributed task. Thread-local: a
    # worker serving a DQ task beside a plain query on another thread
    # must not count the plain query.
    @property
    def dq_stage_depth(self) -> int:
        return getattr(self._tls, "dq_stage_depth", 0)

    @dq_stage_depth.setter
    def dq_stage_depth(self, v: int):
        self._tls.dq_stage_depth = v

    # device-resident stage spine: while True on THIS THREAD, a fused
    # statement's result comes back as a `DeviceStageBlock` (device
    # tensors by reference, host readback deferred) instead of through
    # `fetch_fused_result`. `dq/task.py` arms it around stage statements
    # so multi-stage plans flow device to device.
    @property
    def dq_device_capture(self) -> bool:
        return getattr(self._tls, "dq_device_capture", False)

    @dq_device_capture.setter
    def dq_device_capture(self, v: bool):
        self._tls.dq_device_capture = v

    @property
    def last_path(self) -> str:
        return getattr(self._tls, "last_path", "")

    @last_path.setter
    def last_path(self, v: str):
        self._tls.last_path = v

    # -- entry -------------------------------------------------------------

    def execute(self, plan: QueryPlan,
                snapshot: Snapshot = MAX_SNAPSHOT) -> HostBlock:
        return self.execute_async(plan, snapshot).result()

    def execute_async(self, plan: QueryPlan,
                      snapshot: Snapshot = MAX_SNAPSHOT
                      ) -> DeviceResultFuture:
        """Dispatch phase of a SELECT: the query's kernels are enqueued
        on the current stream and a future is returned whose `result()`
        performs the single device→host readout."""
        params = dict(plan.params)
        # precompute stage: uncorrelated scalar subqueries → params
        for (pname, subplan) in plan.init_subplans:
            sub = self.execute(subplan, snapshot)
            if sub.length > 1:
                raise RuntimeError("scalar subquery produced more than one row")
            col = sub.columns[sub.schema.names[0]]
            if sub.length == 0 or (col.valid is not None
                                   and not col.valid[0]):
                params[pname] = np.zeros((), col.data.dtype)[()]
                params[pname + "__valid"] = False
            else:
                params[pname] = col.data[0]
                params[pname + "__valid"] = True

        if self.mesh is not None and self.mesh.devices.size > 1:
            if self._can_distribute(plan):
                prebuilt: dict = {}
                sj = self._try_execute_shuffle_join(plan, params, snapshot,
                                                    prebuilt)
                if sj is not None:
                    self.last_path = "distributed-shuffle-join"
                    return DeviceResultFuture.completed(
                        self._project_output(sj, plan.output))
                self.last_path = "distributed"
                merged = self._execute_distributed(plan, params, snapshot,
                                                   prebuilt)
                return DeviceResultFuture.completed(
                    self._project_output(merged, plan.output))
            if self._can_distribute_map(plan, snapshot):
                self.last_path = "distributed-map"
                merged = self._execute_distributed_map(plan, params,
                                                       snapshot)
                return DeviceResultFuture.completed(
                    self._project_output(merged, plan.output))

        fused = self._try_execute_fused(plan, params, snapshot, defer=True) \
            if self.enable_fused else None
        if isinstance(fused, tuple):           # tiled lane: (kind, block)
            kind, block = fused
            self.last_path = kind
            return DeviceResultFuture.completed(
                self._project_output(block, plan.output))
        if isinstance(fused, DeviceResultFuture):
            self.last_path = "fused"
            return fused.map(
                lambda b: self._project_output(b, plan.output))
        # fused path declined: it may have prepared the join builds already
        self.last_path = "portioned"
        partials = self._run_pipeline(plan.pipeline, params, snapshot,
                                      builds=fused)
        fut = self._finalize(plan, partials, params, defer=True)
        return fut.map(lambda b: self._project_output(b, plan.output))

    # -- fused whole-query path --------------------------------------------

    def _try_execute_fused(self, plan: QueryPlan, params: dict,
                           snapshot: Snapshot, defer: bool = False,
                           _no_compact: bool = False):
        """Run the query as one fused device function (`ops/fused.py`).
        Returns the HostBlock (`defer=True`: a `DeviceResultFuture`
        deferring the single readout); for a scan above the scan budget,
        the tiled lane's ("fused-tiled[...]", HostBlock); on a decline
        (more joins than the fuse cap, a partitioned build, an expanding
        probe, an empty scan), the list of prepared join BuildTables for
        `_run_pipeline` to reuse, or None if none were prepared."""
        from ydb_tpu_torch.ops import fused as F
        from ydb_tpu_torch.storage.device_cache import (
            enumerate_scan_sources, estimate_scan_bytes,
        )

        pipe = plan.pipeline
        table = self.catalog.table(pipe.scan.table)
        join_steps = [step for kind, step in pipe.steps if kind == "join"]
        if len(join_steps) > self.fuse_max_joins:
            return None                  # program-complexity cap
        builds = self._prepare_builds(pipe, params, snapshot)
        for step, bt in zip(join_steps, builds):
            if isinstance(bt, J.PartitionedBuild) or (
                    not bt.unique and step.kind in ("inner", "left", "mark")):
                return builds            # partitioned / expanding probe

        plan0 = plan            # pre-rewrite plan (the overflow-rerun input)
        (plan, pipe, scan_cols, schema, partial_schema, dicts,
         join_metas, late_scan) = self._fused_plan_setup(plan, builds)

        storage_names = [s for (s, _i) in pipe.scan.columns]
        rename = {s: i for (s, i) in pipe.scan.columns}
        sources, src_ids = enumerate_scan_sources(table, snapshot,
                                                  pipe.scan.prune or None)
        Kb = shape_buckets.bucket_sources(len(sources))
        if sources and estimate_scan_bytes(sources, storage_names,
                                           pad_to=Kb) \
                > self.fused_scan_budget_bytes:
            return self._execute_fused_tiled(
                plan, params, pipe, sources, scan_cols, builds, join_metas,
                dicts, partial_schema)
        sb = self.device_cache.superblock(table, storage_names, rename,
                                          snapshot, pipe.scan.prune or None,
                                          sources, src_ids, pad_to=Kb)
        if sb is None:
            return builds or None          # empty scan → portioned path
        arrays, valids, lengths, K, CAP, sb_dicts = sb
        sb_valid_names = frozenset(valids.keys())
        dicts.update(sb_dicts)

        sort_params, sort_spec, rank_assigns = self._sort_setup_fused(
            plan, schema, dicts)
        all_params = {**params, **sort_params}
        lift_limit, lim_key = self._lift_limit_setup(plan, all_params)

        builds_sig = tuple(F.build_inputs_sig(bt) for bt in builds)
        base_key = F.fused_cache_key(plan, scan_cols, K, CAP,
                                     sb_valid_names, builds_sig, sort_spec,
                                     rank_assigns,
                                     tuple(sorted(all_params)),
                                     lim_key=lim_key)
        # bound-sized device compaction: sized from CBO + FK selectivities
        # plus the measured-live memo; an underestimate trips the device
        # overflow flag in `fetch` and the statement reruns WITHOUT the
        # compact — loud and counted, never a silent truncation
        compact_cap = None if _no_compact else self._compact_sizing(
            base_key, pipe, builds, sources, K * CAP)
        compact_prog = None
        if compact_cap:
            compact_prog = ir.Program([ir.Compact(compact_cap)])
            GLOBAL.inc("latemat/compact_plans")
            GLOBAL.inc("latemat/compact_capacity_rows", compact_cap)
        ndeferred = len(late_scan) + sum(
            len(m["payload_names"]) for m in join_metas if m["late"])
        if ndeferred:
            GLOBAL.inc("latemat/deferred_cols", ndeferred)

        fn, layout_box = F.build_fused_fn(
            pipe, plan.final_program, scan_cols, K, CAP, sb_valid_names,
            join_metas, rank_assigns, sort_spec, plan.limit, plan.offset,
            tuple(dict.fromkeys(n for (n, _lbl) in plan.output)),
            lift_limit=lift_limit, late_scan=late_scan,
            compact_prog=compact_prog)
        keep = list(dict.fromkeys(n for (n, _lbl) in plan.output))
        out_schema = Schema([c for c in schema.columns if c.name in keep]
                            or list(schema.columns))

        dev_params = {k: (to_tensor(v, self.device)
                          if isinstance(v, np.ndarray) else v)
                      for k, v in all_params.items()}
        build_inputs = [F.build_traced_inputs(bt) for bt in builds]
        data_stacks, valid_stack, length, aux = fn(
            arrays, valids, lengths, build_inputs, dev_params)

        out_dicts = {n2: d for n2, d in dicts.items() if out_schema.has(n2)}
        out_dicts.update({n2: d for n2, d in plan.result_dicts.items()
                          if out_schema.has(n2)})
        lo = plan.offset or 0
        limit = plan.limit
        # stage-spine capture: read the thread-local flag at dispatch
        # time (the future may be resolved on another thread). An OFFSET
        # tail would force a host slice anyway, so those plans keep the
        # host readout.
        capture_device = bool(self.dq_device_capture) and not lo

        def fetch() -> HostBlock:
            if aux:
                # compact live/overflow: two scalars the loud-rerun
                # decision needs on the host
                live, ovf = (int(x[0]) for x in batched_to_host(
                    [aux["compact_live"].reshape(1),
                     aux["compact_ovf"].reshape(1)]))
                GLOBAL.inc("latemat/compact_live_rows", live)
                if live > self._compact_memo.get(base_key, 0):
                    self._compact_memo[base_key] = live
                if ovf:
                    # the bound was forged low — rows past compact_cap
                    # were dropped on the device. Discard this result and
                    # rerun without the compact. Never serve a truncation.
                    GLOBAL.inc("latemat/compact_overflow_reruns")
                    prev_cap = self.dq_device_capture
                    self.dq_device_capture = capture_device
                    try:
                        return self._try_execute_fused(
                            plan0, params, snapshot, _no_compact=True)
                    finally:
                        self.dq_device_capture = prev_cap
            if capture_device:
                # device-resident spine: the stage result goes back as
                # device tensors by reference; only the length crosses
                n = int(length)
                dev = F.capture_fused_device(data_stacks, valid_stack, n,
                                             layout_box, out_schema,
                                             out_dicts)
                return DeviceStageBlock(dev, n)
            block = F.fetch_fused_result(data_stacks, valid_stack, length,
                                         layout_box, out_schema, out_dicts)
            return _apply_offset(block, lo, limit)

        fut = DeviceResultFuture(fetch)
        return fut if defer else fut.result()

    # -- multi-query batched dispatch --------------------------------------

    def execute_fused_batched(self, plan: QueryPlan, members: list,
                              snapshot: Snapshot):
        """ONE fused execution for a batch of same-shape queries (the
        serving lane, `query/batch_lane.py`): the shared scan superblock
        and join builds are taken once, the lifted params whose values
        differ across the members get a member axis, and one launch
        sequence (`ops/fused.build_fused_batched_fn`) serves the whole
        batch — one readout for B clients.

        `plan`: the leader's plan with scan pruning STRIPPED (pruning is
        literal-dependent and cannot partition a shared execution; the
        lane already verified every member sees identical source sets).
        `members`: [(member_plan, member_params)] — same `lift_sig`.
        Returns [HostBlock] projected per member, or None where the
        reference declines the shape before dispatch (more joins than
        the fuse cap, a partitioned or non-unique build, an empty or
        tiled-class scan, param-name drift, array params whose shapes
        differ). Nothing is traced here, so a failure inside the
        execution is a fault and reaches the caller: there is no
        per-member fallback for it (the reference's `batch/trace_errors`
        lane). The reference pads the member axis to a power of two to
        key compiled programs; the port compiles none and runs exactly
        B members (identical members run once)."""
        from ydb_tpu_torch.ops import fused as F
        from ydb_tpu_torch.ops.torch_exec import PerMember
        from ydb_tpu_torch.storage.device_cache import (
            enumerate_scan_sources, estimate_scan_bytes,
        )

        pipe = plan.pipeline
        table = self.catalog.table(pipe.scan.table)
        join_steps = [step for kind, step in pipe.steps if kind == "join"]
        if len(join_steps) > self.fuse_max_joins:
            return None
        params0 = dict(members[0][1])
        builds = self._prepare_builds(pipe, params0, snapshot)
        for step, bt in zip(join_steps, builds):
            if isinstance(bt, J.PartitionedBuild) or (
                    not bt.unique and step.kind in ("inner", "left",
                                                    "mark")):
                return None
        (plan, pipe, scan_cols, schema, _partial_schema, dicts,
         join_metas, late_scan) = self._fused_plan_setup(plan, builds)

        storage_names = [s for (s, _i) in pipe.scan.columns]
        rename = {s: i for (s, i) in pipe.scan.columns}
        sources, src_ids = enumerate_scan_sources(table, snapshot, None)
        Kb = shape_buckets.bucket_sources(len(sources))
        if not sources or estimate_scan_bytes(sources, storage_names,
                                              pad_to=Kb) \
                > self.fused_scan_budget_bytes:
            return None                  # empty / tiled-class scan
        sb = self.device_cache.superblock(table, storage_names, rename,
                                          snapshot, None, sources, src_ids,
                                          pad_to=Kb)
        if sb is None:
            return None
        arrays, valids, lengths, K, CAP, sb_dicts = sb
        sb_valid_names = frozenset(valids.keys())
        dicts.update(sb_dicts)

        sort_params, sort_spec, rank_assigns = self._sort_setup_fused(
            plan, schema, dicts)
        # per-member param dicts (sort params are batch-invariant; a
        # LIMIT always lifts here — see _lift_limit_setup — so each
        # member clamps to ITS OWN limit+offset, not the leader's)
        lift_limit, _lim_key = self._lift_limit_setup(plan, force=True)
        mem_params = []
        for (mp, prms) in members:
            p = {**prms, **sort_params}
            if lift_limit:
                p[F.LIMIT_PARAM] = np.int32(mp.limit + (mp.offset or 0))
            mem_params.append(p)
        names = sorted(mem_params[0])
        for p in mem_params[1:]:
            if sorted(p) != names:
                return None              # shape drift — lane sig was stale

        # the member axis only on the params whose values differ; the
        # batch-invariant ones (rank LUTs, shared pool arrays) are taken
        # once
        shared, mapped = {}, {}
        for n in names:
            vals = [p[n] for p in mem_params]
            if all(_param_values_equal(vals[0], v) for v in vals[1:]):
                shared[n] = vals[0]
                continue
            arrs = [np.asarray(v) for v in vals]
            if any(a.shape != arrs[0].shape or a.dtype != arrs[0].dtype
                   for a in arrs[1:]):
                # array params whose SHAPES vary with the literal
                # (integer IN lists) — Param fingerprints carry no
                # shape, so the sig can't split these; decline
                return None
            mapped[n] = np.stack(arrs)
        B = len(members)
        # every member identical (a same-text storm): one execution,
        # every member unpacks row 0
        rows = B if mapped else 1
        member_rows = list(range(B)) if mapped else [0] * B

        keep = tuple(dict.fromkeys(n for (n, _lbl) in plan.output))
        fn, layout_box = F.build_fused_batched_fn(
            pipe, plan.final_program, scan_cols, K, CAP, sb_valid_names,
            join_metas, rank_assigns, sort_spec, plan.limit, plan.offset,
            keep, rows, lift_limit=lift_limit, late_scan=late_scan)
        out_schema = Schema([c for c in schema.columns if c.name in keep]
                            or list(schema.columns))
        dev_params = {k: (to_tensor(v, self.device)
                          if isinstance(v, np.ndarray) else v)
                      for k, v in shared.items()}
        dev_params.update({k: PerMember(to_tensor(v, self.device))
                           for k, v in mapped.items()})
        build_inputs = [F.build_traced_inputs(bt) for bt in builds]
        data_stacks, valid_stack, length, _aux = fn(
            arrays, valids, lengths, build_inputs, dev_params)

        out_dicts = {n2: d for n2, d in dicts.items() if out_schema.has(n2)}
        out_dicts.update({n2: d for n2, d in plan.result_dicts.items()
                          if out_schema.has(n2)})
        blocks = F.fetch_fused_batch(data_stacks, valid_stack, length,
                                     layout_box, out_schema, out_dicts,
                                     member_rows)
        out = []
        for (mp, _prms), blk in zip(members, blocks):
            blk = _apply_offset(blk, mp.offset or 0, mp.limit)
            out.append(self._project_output(blk, mp.output))
        return out


    def _sort_setup_fused(self, plan: QueryPlan, schema: Schema,
                          dicts: dict):
        """Rank-LUT sort params against the fused pipeline's final schema."""
        from ydb_tpu_torch.core import dtypes as dt
        sort_params, rank_assigns, spec = {}, [], []
        dicts = {**dicts, **plan.result_dicts}
        for j, sk in enumerate(plan.sort):
            dtype = schema.dtype(sk.name)
            dic = dicts.get(sk.name)
            if dtype.is_string and dic is not None:
                ranks = dic.sort_ranks()
                pname = f"__rank{j}"
                sort_params[pname] = ranks
                rank_col = f"__sortrank{j}"
                rank_assigns.append(ir.Assign(rank_col, ir.call(
                    "take_lut", ir.Col(sk.name),
                    ir.Param(pname, dt.DType(dt.Kind.INT32, False),
                             is_array=True))))
                spec.append((rank_col, sk.ascending, sk.nulls_first))
            else:
                spec.append((sk.name, sk.ascending, sk.nulls_first))
        return sort_params, tuple(spec), rank_assigns

    def _fused_plan_setup(self, plan: QueryPlan, builds: list):
        """One schema walk over the pipeline collecting join metas (incl.
        the LUT-vs-bsearch probe choice per build) and landing on the
        final schema, plus the join-derived group-bound rewrite. Returns
        (plan, pipe, scan_cols, schema, partial_schema, dicts, join_metas,
        late_scan)."""
        from ydb_tpu_torch.core.dtypes import DType, Kind as _K
        from ydb_tpu_torch.ops import fused as F
        from ydb_tpu_torch.ops.torch_exec import late_mat_enabled
        from ydb_tpu_torch.query import latemat

        late = late_mat_enabled()
        pipe = plan.pipeline
        table = self.catalog.table(pipe.scan.table)
        scan_cols = [Column(i, table.schema.dtype(s))
                     for (s, i) in pipe.scan.columns]

        dicts = {}
        join_metas = []
        bi = 0
        schema = Schema(list(scan_cols))
        if pipe.pre_program is not None:
            schema = ir.infer_schema(pipe.pre_program, schema)
        for kind, step in pipe.steps:
            if kind != "join":
                schema = ir.infer_schema(step, schema)
                continue
            bt = builds[bi]
            bi += 1
            payload_cols = []
            for name in bt.schema.names:
                payload_cols.append(
                    Column(name, bt.schema.dtype(name).with_nullable(True)))
                if name in bt.dictionaries:
                    dicts[name] = bt.dictionaries[name]
            if step.kind == "mark":
                payload_cols.append(Column(step.mark_col or "__mark",
                                           DType(_K.BOOL, False)))
            join_metas.append({
                "probe_key": step.probe_key,
                "kind": step.kind,
                "src_names": tuple(bt.schema.names),
                "payload_names": tuple(bt.schema.names),
                "mark_col": step.mark_col,
                "not_in": step.not_in,
                "payload_cols": payload_cols,
                # sparse key spans have no LUT; float probes must not
                # truncate through an integer LUT
                "bsearch": bt.lut is None
                or schema.dtype(step.probe_key).kind in (_K.FLOAT64,
                                                         _K.FLOAT32),
                "late": late and step.kind in ("inner", "left")
                and bool(bt.schema.names),
                "row_col": f"__lmr{bi - 1}",
                "found_col": f"__lmf{bi - 1}",
            })
            schema = F.apply_join_schema(schema, payload_cols)
        if pipe.partial is not None:
            schema = ir.infer_schema(pipe.partial, schema)
        partial_schema = schema
        if plan.final_program is not None:
            schema = ir.infer_schema(plan.final_program, schema)
        plan, pipe = self._bounded_groupby_rewrite(plan, builds, join_metas)
        late_scan = latemat.deferrable_scan(
            pipe, [c.name for c in scan_cols]) if late else frozenset()
        return plan, pipe, scan_cols, schema, partial_schema, dicts, \
            join_metas, late_scan

    @staticmethod
    def _lift_limit_setup(plan: QueryPlan, all_params=None,
                          force: bool = False):
        """(lift_limit, lim_key) for a fused compile: lifted plans with a
        LIMIT pass limit+offset as the __lim2 device input and key the
        program on its capacity bucket; everything else keeps the baked
        constants (byte-identical compile key to the pre-lift path).

        `force`: the batched lane ALWAYS lifts a LIMIT — its shape sig
        groups on the bucket, so members whose only difference is the
        LIMIT/OFFSET value must still clamp per member (a zero-literal
        `limit 3` and `limit 5` coalesce; baking the leader's value
        would hand every member the leader's row count).
        `all_params`: when given, the leader's __lim2 is injected (the
        batched lane instead injects per member)."""
        from ydb_tpu_torch.ops.fused import LIMIT_PARAM
        if plan.limit is None or not (
                force or getattr(plan, "lift_names", ())):
            return False, None
        lim2 = plan.limit + (plan.offset or 0)
        if all_params is not None:
            all_params[LIMIT_PARAM] = np.int32(lim2)
        return True, ("limB", bucket_capacity(lim2, minimum=128))

    def _compact_sizing(self, base_key, pipe, builds, sources,
                        cap0: int) -> Optional[int]:
        """Ladder-quantized capacity the fused pipeline compacts to after
        its join steps, or None when compaction isn't worth a shape. The
        estimate (the reference's, unchanged): live scan rows tightened by
        the CBO's post-predicate estimate, FK selectivities of inner and
        declared-unique semi joins, the plan's proven bound, the measured
        live memo, 25% headroom, floor 1024, quantized up on the segment
        ladder, sticky per shape; only capacities under cap0/2 are worth
        it. The device overflow flag catches every underestimate."""
        from ydb_tpu_torch.ops.torch_exec import late_mat_enabled
        if not late_mat_enabled():
            return None
        live = float(sum(b.length for b in sources)) if sources else 0.0
        if pipe.scan.est_rows >= 0:
            live = min(live, float(pipe.scan.est_rows))
        est = live
        bi = 0
        for kind, step in pipe.steps:
            if kind != "join":
                continue
            bt = builds[bi]
            bi += 1
            if step.not_in:
                continue
            if step.kind == "inner":
                base = self._build_base_rows(step)
                if base > 0:
                    est *= min(1.0, float(int(bt.n)) / base)
            elif step.kind == "left_semi":
                dom = self._semi_key_domain(step)
                if dom > 0:
                    est *= min(1.0, float(int(bt.n)) / dom)
        if pipe.out_bound and not (
                pipe.partial is not None
                and any(isinstance(c, ir.GroupBy)
                        for c in pipe.partial.commands)):
            est = min(est, float(pipe.out_bound))
        est = max(est, float(self._compact_memo.get(base_key, 0)))
        prev = self._compact_caps.get(base_key)
        if prev is not None and est <= prev:
            return prev
        cand = shape_buckets.bucket_segment(
            max(int(est * 1.25) + 1, 1024))
        if cand >= cap0 // 2:
            self._compact_caps.pop(base_key, None)
            return None
        self._compact_caps[base_key] = cand
        return cand

    def _build_base_rows(self, step: JoinStep) -> int:
        """Unfiltered base-table row count of a join's build side (the
        FK-selectivity denominator); 0 = unknown."""
        build = step.build
        pipe = getattr(build, "pipeline", build)   # QueryPlan | Pipeline
        scan = getattr(pipe, "scan", None)
        if scan is None:
            return 0
        try:
            tbl = self.catalog.table(scan.table)
        except Exception:              # noqa: BLE001 — sizing, not law
            return 0
        return int(getattr(tbl, "num_rows", 0))

    def _semi_key_domain(self, step: JoinStep) -> int:
        """Key-domain denominator for a semi join's coverage estimate, or
        0 when the build key isn't declared-unique (see the reference)."""
        from ydb_tpu_torch.query import bounds
        if not bounds._build_key_unique_declared(step, self.catalog):
            return 0
        if "." in step.probe_key:
            alias, col = step.probe_key.split(".", 1)
            try:
                tbl = self.catalog.table(alias)
                if list(tbl.key_columns) == [col]:
                    return int(getattr(tbl, "num_rows", 0))
            except Exception:          # noqa: BLE001 — sizing, not law
                pass
        if not isinstance(step.build, QueryPlan):
            return self._build_base_rows(step)
        return 0

    def _bounded_groupby_rewrite(self, plan: QueryPlan, builds: list,
                                 join_metas: list):
        """The executor half of the bounds lattice (the reference's,
        unchanged): a PROVEN `out_bound` on the partial (and merge)
        GroupBy from inner/semi joins against unique-keyed builds, and
        CARRY keys for grouping columns a verified determinant fixes.
        Returns the (possibly rewritten, copied) plan and pipeline."""
        import dataclasses as _dc

        from ydb_tpu_torch.query.bounds import bounds_enabled
        pipe = plan.pipeline
        if pipe.partial is None or not pipe.partial.commands:
            return plan, pipe
        gb = pipe.partial.commands[-1]
        if not isinstance(gb, ir.GroupBy) or not gb.keys:
            return plan, pipe
        keys = set(gb.keys)
        partial_assigned = {c.name for c in pipe.partial.commands[:-1]
                            if isinstance(c, ir.Assign)}
        best = None
        cands = []     # (step, bt, allowed, has_payload)
        bi = 0
        for si, (kind, step) in enumerate(pipe.steps):
            if kind != "join":
                continue
            bt = builds[bi]
            meta = join_metas[bi]
            bi += 1
            if step.not_in:
                continue
            if step.kind == "inner" and getattr(bt, "unique", False):
                allowed = {step.probe_key} | set(meta["payload_names"])
                has_payload = True
            elif step.kind == "left_semi":
                allowed = {step.probe_key}
                has_payload = False
            else:
                continue
            later = set(partial_assigned)
            bj = bi
            for sj in range(si + 1, len(pipe.steps)):
                k2, s2 = pipe.steps[sj]
                if k2 == "join":
                    later |= set(join_metas[bj]["payload_names"])
                    if s2.kind == "mark":
                        later.add(s2.mark_col or "__mark")
                    bj += 1
                else:
                    later |= {c.name for c in s2.commands
                              if isinstance(c, ir.Assign)}
            allowed -= later
            cands.append((step, bt, allowed, has_payload))
            if keys <= allowed:
                n = max(int(bt.n), 1)
                best = n if best is None else min(best, n)

        carry: list = []
        claimed: set = set()
        if bounds_enabled():
            for (step, bt, allowed, has_payload) in cands:
                if not has_payload:
                    continue
                gj = [k for k in gb.keys
                      if k in allowed and k not in claimed
                      and k not in carry]
                if len(gj) < 2:
                    continue
                det, measured = self._fd_determinant(step, bt, gj)
                if det is None:
                    continue
                claimed.add(det)
                for k in gj:
                    if k != det:
                        carry.append(k)
                if measured is not None and keys <= allowed:
                    best = measured if best is None \
                        else min(best, measured)

        bound = gb.out_bound
        if best is not None:
            cand = bucket_capacity(max(best, 1), minimum=128)
            rows = max(int(getattr(self.catalog.table(pipe.scan.table),
                                   "num_rows", 0)), 1)
            if cand < bucket_capacity(rows) \
                    and (not bound or int(bound) > cand):
                bound = cand
        if bound == gb.out_bound and not carry:
            return plan, pipe

        kept = tuple(k for k in gb.keys if k not in carry)
        domains = gb.key_domains
        if carry and domains and len(domains) == len(gb.keys):
            domains = tuple(d for k, d in zip(gb.keys, domains)
                            if k not in carry)
        elif carry:
            domains = ()
        new_carry = tuple(gb.carry_keys) + tuple(carry)
        gb2 = _dc.replace(gb, keys=kept, key_domains=domains,
                          out_bound=bound, carry_keys=new_carry)
        pipe = _dc.replace(pipe, partial=ir.Program(
            list(pipe.partial.commands[:-1]) + [gb2]))
        fp = plan.final_program
        if fp is not None and fp.commands \
                and isinstance(fp.commands[0], ir.GroupBy) \
                and fp.commands[0].keys == gb.keys:
            fgb0 = fp.commands[0]
            fgb = _dc.replace(
                fgb0, keys=kept, key_domains=domains,
                carry_keys=tuple(fgb0.carry_keys) + tuple(carry),
                out_bound=bound if (not fgb0.out_bound
                                    or (bound and int(fgb0.out_bound)
                                        > int(bound)))
                else fgb0.out_bound)
            fp = ir.Program([fgb] + list(fp.commands[1:]))
        plan = _dc.replace(plan, pipeline=pipe, final_program=fp)
        GLOBAL.inc("groupby/join_bounded_plans")
        if carry:
            GLOBAL.inc("bounds/carry_rewrites")
        return plan, pipe

    def _fd_determinant(self, step: JoinStep, bt, gj: list):
        """One grouping column that provably determines all of `gj`,
        verified on the materialized build block (the reference's rule).
        Returns (determinant | None, measured distinct count | None)."""
        from ydb_tpu_torch.query.bounds import dataset_distinct
        if step.probe_key in gj:
            return step.probe_key, None
        if step.build_key in gj:
            return step.build_key, None
        fdb = getattr(bt, "fd_block", None)
        if fdb is None:
            return None, None
        mcols = [step.build_key if k == step.probe_key else k for k in gj]
        if any(c not in fdb.columns for c in mcols):
            return None, None
        memo = getattr(bt, "fd_memo", None)
        if memo is None:
            memo = bt.fd_memo = {}

        def distinct(cols: tuple) -> int:
            got = memo.get(cols)
            if got is None:
                got = memo[cols] = dataset_distinct(fdb, list(cols))
            return got

        GLOBAL.inc("bounds/fd_checks")
        total = distinct(tuple(sorted(mcols)))
        order = sorted(zip(gj, mcols),
                       key=lambda km: (fdb.columns[km[1]].data.itemsize,
                                       km[0]))
        for (k, m) in order:
            if distinct((m,)) == total:
                GLOBAL.inc("bounds/fd_verified")
                return k, total
        return None, None

    # -- tiled fused path (scan > device budget) ---------------------------

    def _execute_fused_tiled(self, plan: QueryPlan, params: dict, pipe,
                             sources: list, scan_cols: list, builds: list,
                             join_metas: list, build_dicts: dict,
                             partial_schema: Schema):
        """Stream a scan too large for the device through fixed-size
        tiles: each tile is K_tile stacked sources run through one
        scan→filter→join→partial body (`ops/fused.build_tile_fn`), with
        at most two tiles in flight (the next tile's stack and upload
        overlap the current one's kernels). Partials either stay on the
        device for the normal finalize, spill to host key-hash partitions
        for a per-partition merge (`ops/spill.py` — the WideCombiner
        InMemory→Spilling→ProcessSpilled analog,
        `mkql_wide_combine.cpp:338-600`), or, for non-aggregating plans,
        union on the host with per-tile top-k pre-cuts (DqCnMerge-style).

        Returns ("fused-tiled[...]", HostBlock)."""
        import dataclasses

        from ydb_tpu_torch.ops import fused as F
        from ydb_tpu_torch.ops import spill as SP
        from ydb_tpu_torch.ops.torch_exec import _SCATTER_MAX_BUCKETS

        CAP = max(bucket_capacity(max(b.length, 1)) for b in sources)
        row_bytes = 0
        sb_valid_names = set()
        tile_dicts = dict(build_dicts)
        for (s, internal) in pipe.scan.columns:
            cd0 = sources[0].columns[s]
            row_bytes += cd0.data.itemsize
            if any(b.columns[s].valid is not None for b in sources):
                sb_valid_names.add(internal)
                row_bytes += 1
            if cd0.dictionary is not None:
                tile_dicts[internal] = cd0.dictionary
        K_tile = max(1, int(self.tile_budget_bytes // (CAP * row_bytes)))
        K_tile = min(K_tile, len(sources))
        n_tiles = (len(sources) + K_tile - 1) // K_tile
        tile_cap = K_tile * CAP
        sb_valid_names = frozenset(sb_valid_names)

        # static tile-output capacity: bounded-domain partial group-bys
        # compact to their bucket count; everything else stays tile-sized
        tile_out_cap = tile_cap
        last = pipe.partial.commands[-1] \
            if pipe.partial is not None and pipe.partial.commands else None
        if isinstance(last, ir.GroupBy):
            if not last.keys:
                tile_out_cap = 1
            elif last.key_domains and all(d > 0 for d in last.key_domains):
                nb = 1
                for d in last.key_domains:
                    nb *= d + 1
                if nb + 1 <= _SCATTER_MAX_BUCKETS:
                    tile_out_cap = bucket_capacity(nb, minimum=128)
            if last.out_bound:
                # a proven ngroups bound: the partials really are this
                # small — don't let a tile-sized estimate trigger a
                # needless spill
                tile_out_cap = min(
                    tile_out_cap,
                    bucket_capacity(max(int(last.out_bound), 1),
                                    minimum=128))
        prow = sum(np.dtype(c.dtype.np).itemsize + 1
                   for c in partial_schema.columns)
        est_partial = n_tiles * min(tile_out_cap, tile_cap) * prow

        fp = plan.final_program
        merge_gb = fp.commands[0] if fp is not None and fp.commands \
            and isinstance(fp.commands[0], ir.GroupBy) else None
        spill = (merge_gb is not None and merge_gb.keys
                 and est_partial > self.merge_budget_bytes)
        union = merge_gb is None and est_partial > self.merge_budget_bytes

        fn = F.build_tile_fn(pipe, scan_cols, K_tile, CAP, sb_valid_names,
                             join_metas)
        build_inputs = [F.build_traced_inputs(bt) for bt in builds]
        dev_params = {k: (to_tensor(v, self.device)
                          if isinstance(v, np.ndarray) else v)
                      for k, v in params.items()}
        out_dicts = {n: d for n, d in tile_dicts.items()
                     if partial_schema.has(n)}

        GLOBAL.inc("executor/tiled_queries")
        # the tile stacks + resident partials live OUTSIDE the cache's
        # accounting: make room so warm cache + streaming fit the device
        self.device_cache.reserve(2 * self.tile_budget_bytes
                                  + self.merge_budget_bytes)
        store = None
        if spill:
            P = 1
            while est_partial / P > self.merge_budget_bytes and P < 256:
                P *= 2
            store = SP.PartitionStore(partial_schema, list(merge_gb.keys),
                                      P, out_dicts)

        # union mode: per-tile finalize plans (top-k pre-cut when the
        # query sort-limits, plain program application otherwise)
        lim = None if plan.limit is None else plan.limit + (plan.offset or 0)
        topk = bool(plan.sort) and lim is not None and lim <= (1 << 17)
        out_names = {n for (n, _lbl) in plan.output}
        extra = [(sk.name, sk.name) for sk in plan.sort
                 if sk.name not in out_names]
        if union:
            if topk:
                plan_tile = dataclasses.replace(
                    plan, offset=None, limit=lim, output=plan.output + extra)
            else:
                plan_tile = dataclasses.replace(
                    plan, sort=[], limit=None, offset=None,
                    output=plan.output + extra)

        partials, unions = [], []
        prev = None
        for t in range(n_tiles):
            tile_sources = sources[t * K_tile:(t + 1) * K_tile]
            sb, sbv, lengths = self._stack_tile(
                tile_sources, pipe.scan.columns, K_tile, CAP,
                sb_valid_names)
            out_d, out_v, length = fn(sb, sbv, lengths, build_inputs,
                                      dev_params)
            out_d = {n: out_d[n] for n in partial_schema.names}
            out_v = {n: v for n, v in out_v.items()
                     if partial_schema.has(n)}
            cap_t = (next(iter(out_d.values())).shape[0]
                     if out_d else tile_cap)
            dblock = DeviceBlock(partial_schema, out_d, out_v, length,
                                 cap_t, out_dicts)
            if spill:
                store.feed(dblock)       # syncs → natural backpressure
            elif union:
                unions.append(self._finalize(plan_tile, [dblock], params))
            else:
                partials.append(dblock)
                # two tiles in flight: wait for the one before this one
                # before stacking the next
                done = _tile_done(self.device)
                if prev is not None:
                    prev.synchronize()
                prev = done

        if spill:
            GLOBAL.inc("executor/spilled_rows", store.spilled_rows)
            GLOBAL.inc("executor/spilled_bytes", store.spilled_bytes)
            return ("fused-tiled-spill",
                    self._merge_spilled(plan, store, params))
        if union:
            u = HostBlock.concat(unions) if len(unions) > 1 else unions[0]
            if topk:
                plan_merge = dataclasses.replace(
                    plan, final_program=None, output=plan.output + extra)
                block = self._finalize(plan_merge,
                                       [to_device(u, self.device)], params)
            else:
                block = SP.host_sort_limit(
                    u, plan.sort, plan.limit, plan.offset,
                    {**out_dicts, **plan.result_dicts})
            return ("fused-tiled-union", block)
        return ("fused-tiled", self._finalize(plan, partials, params))

    def _stack_tile(self, tile_sources: list, scan_columns: list,
                    K_tile: int, CAP: int, sb_valid_names: frozenset):
        """Stack one tile of sources into (K_tile, CAP) host tensors
        (pinned on a CUDA engine) and copy them to the device without
        waiting. Short tiles pad with zero-length sources so every tile
        has one shape."""
        pin = self.device.type == "cuda"
        lengths = torch.zeros(K_tile, dtype=torch.int32, pin_memory=pin)
        for k, b in enumerate(tile_sources):
            lengths[k] = b.length
        arrays, valids = {}, {}
        for (s, internal) in scan_columns:
            dtype = torch_dtype(tile_sources[0].columns[s].data.dtype)
            stack = torch.zeros((K_tile, CAP), dtype=dtype, pin_memory=pin)
            vstack = torch.zeros((K_tile, CAP), dtype=torch.bool,
                                 pin_memory=pin) \
                if internal in sb_valid_names else None
            hs = stack.numpy()
            hv = vstack.numpy() if vstack is not None else None
            for k, b in enumerate(tile_sources):
                cd = b.columns[s]
                hs[k, :b.length] = storage_array(cd.data)
                if hv is not None:
                    hv[k, :b.length] = (cd.valid if cd.valid is not None
                                        else True)
            arrays[internal] = stack.to(self.device, non_blocking=True)
            if vstack is not None:
                valids[internal] = vstack.to(self.device, non_blocking=True)
        return arrays, valids, lengths.to(self.device, non_blocking=True)

    def _merge_spilled(self, plan: QueryPlan, store, params: dict):
        """ProcessSpilled: per key-hash partition, concat the spilled
        pieces, run the merge group-by + rest of the final program on
        the device, then combine partitions on the host (disjoint key
        sets) and apply ORDER BY / LIMIT there."""
        import dataclasses

        from ydb_tpu_torch.ops import spill as SP

        out_names = {n for (n, _lbl) in plan.output}
        extra = [(sk.name, sk.name) for sk in plan.sort
                 if sk.name not in out_names]
        plan_p = dataclasses.replace(plan, sort=[], limit=None, offset=None,
                                     output=plan.output + extra)
        outs = []
        for p in range(store.nparts):
            hb = store.partition(p)
            if hb.length == 0 and outs:
                continue
            outs.append(self._finalize(plan_p, [to_device(hb, self.device)],
                                       params))
        union = HostBlock.concat(outs) if len(outs) > 1 else outs[0]
        return SP.host_sort_limit(
            union, plan.sort, plan.limit, plan.offset,
            {**store.dictionaries, **plan.result_dicts})

    # -- the mesh lanes ----------------------------------------------------

    def _can_distribute(self, plan: QueryPlan) -> bool:
        """Distributable = the two-phase aggregation shape: the pipeline
        ends in a partial GroupBy and the final program starts with the
        merge GroupBy (the exchange sits between the two)."""
        pipe = plan.pipeline
        if pipe.partial is None or not pipe.partial.commands:
            return False
        if not isinstance(pipe.partial.commands[-1], ir.GroupBy):
            return False
        fp = plan.final_program
        return bool(fp is not None and fp.commands
                    and isinstance(fp.commands[0], ir.GroupBy))

    def _can_distribute_map(self, plan: QueryPlan,
                            snapshot: Snapshot) -> bool:
        """Map-style distribution: no aggregation boundary, so the scan,
        filter and join work spreads over the shards and their results
        union for the final stage. Needs more than one scan source."""
        pipe = plan.pipeline
        if pipe.partial is not None and any(
                isinstance(c, ir.GroupBy) for c in pipe.partial.commands):
            return False
        if plan.final_program is not None and any(
                isinstance(c, ir.GroupBy)
                for c in plan.final_program.commands):
            return False
        return self._scan_source_count(plan, snapshot) > 1

    def _scan_source_count(self, plan: QueryPlan, snapshot: Snapshot) -> int:
        pipe = plan.pipeline
        table = self.catalog.table(pipe.scan.table)
        return sum(len(p) + len(e)
                   for (p, e) in (s.scan_sources(snapshot,
                                                 pipe.scan.prune or None)
                                  for s in table.shards))

    def _execute_distributed_map(self, plan: QueryPlan, params: dict,
                                 snapshot: Snapshot) -> HostBlock:
        """Per-shard pipelines (scan, filter, joins), their results
        unioned on the host, the final stage (expressions, sort, limit)
        on one device. A sort-limit query takes each shard's top
        (limit + offset) rows before the union."""
        import dataclasses

        nsrc = self._scan_source_count(plan, snapshot)
        # no point placing builds on shards that get no blocks
        devs = list(self.mesh.devices.flat)[:max(2, min(
            self.mesh.devices.size, nsrc))]
        builds = self._prepare_builds(plan.pipeline, params, snapshot)
        builds_by_dev = [[J.place(b, d) for b in builds] for d in devs]
        # every shard's pipeline is enqueued before any readout
        pending = [self._run_block(plan.pipeline, dblock,
                                   builds_by_dev[di], params)
                   for di, dblock in self._scan_device_blocks(
                       plan.pipeline, snapshot, devices=devs)]
        lim = None if plan.limit is None else plan.limit + (plan.offset or 0)
        if plan.sort and lim is not None and lim <= (1 << 17):
            # the sort keys survive the per-shard projection, so the merge
            # can sort again; the offset applies only at the merge
            out_names = {n for (n, _lbl) in plan.output}
            extra = [(sk.name, sk.name) for sk in plan.sort
                     if sk.name not in out_names]
            plan_local = dataclasses.replace(
                plan, offset=None, limit=lim, output=plan.output + extra)
            outs = [self._finalize(plan_local, [d], params)
                    for d in pending]
            union = HostBlock.concat(outs) if len(outs) > 1 else outs[0]
            plan_merge = dataclasses.replace(
                plan, final_program=None, output=plan.output + extra)
            return self._finalize(plan_merge,
                                  [to_device(union, self.device)], params)
        outs = [to_host(d) for d in pending]
        union = HostBlock.concat(outs) if len(outs) > 1 else outs[0]
        return self._finalize(plan, [to_device(union, self.device)], params)

    def _execute_distributed(self, plan: QueryPlan, params: dict,
                             snapshot: Snapshot,
                             prebuilt: Optional[dict] = None) -> HostBlock:
        """Scan portions round-robin over the shards, the whole pipeline
        (pushdown, joins, partial aggregate) per block on its shard, the
        partials merged over the mesh, then the rest of the final
        program, sort and limit on one device."""
        pipe = plan.pipeline
        devs = list(self.mesh.devices.flat)
        builds = self._prepare_builds(pipe, params, snapshot,
                                      prebuilt=prebuilt)
        per_dev = self._shard_partials(pipe, snapshot, devs, builds, params)
        return self._merge_distributed_partials(plan, per_dev, params)

    def _shard_partials(self, pipe: Pipeline, snapshot: Snapshot, devs: list,
                        builds: list, params: dict,
                        until: Optional[int] = None) -> list:
        """Each shard's pipeline outputs over its round-robin share of the
        scan portions, the builds placed on every shard; a shard without
        portions still runs the pipeline once over an empty block (a
        global aggregate emits its row from it). `until`: as
        `_run_block_multi`'s."""
        builds_by_dev = [[J.place(b, d) for b in builds] for d in devs]
        per_dev = [[] for _ in devs]
        for di, dblock in self._scan_device_blocks(pipe, snapshot,
                                                   devices=devs):
            per_dev[di].extend(self._run_block_multi(
                pipe, dblock, builds_by_dev[di], params, until=until))
        for di, dev in enumerate(devs):
            if not per_dev[di]:
                empty = to_device(self._empty_scan_block(pipe), dev)
                per_dev[di].extend(self._run_block_multi(
                    pipe, empty, builds_by_dev[di], params, until=until))
        return per_dev

    def _try_execute_shuffle_join(self, plan: QueryPlan, params: dict,
                                  snapshot: Snapshot,
                                  prebuilt: Optional[dict] = None):
        """The shuffle join over the mesh: the LAST join's build side
        partitions over the shards by key hash and probe rows route to
        their key's shard (`parallel/shuffle_join.py`). Taken when the
        build's estimate exceeds `dist_broadcast_budget_bytes`; declined
        (→ the broadcast lane, None) for kinds it does not cover, NOT IN,
        float keys, a NULL build key under anti/mark semantics, a
        dictionary key whose probe dictionary is not derivable, duplicate
        keys under inner/left/mark, and a payload the partition drops.
        Every decline after the build ran hands its block over in
        `prebuilt`, so it never runs twice."""
        from ydb_tpu_torch.core.dtypes import DType, Kind
        from ydb_tpu_torch.ops.torch_exec import groupby_tuning
        from ydb_tpu_torch.parallel import shuffle_join as SJ
        from ydb_tpu_torch.query.admission import estimate_plan_bytes

        pipe = plan.pipeline
        join_pos = [i for i, (k, _s) in enumerate(pipe.steps)
                    if k == "join"]
        if not join_pos:
            return None
        j = join_pos[-1]
        step = pipe.steps[j][1]
        if step.kind not in ("inner", "left", "left_semi", "left_anti",
                             "mark"):
            return None
        if step.not_in:
            return None          # NOT IN null semantics: broadcast lane
        bp = getattr(step.build, "pipeline", step.build)
        if not hasattr(bp, "scan"):
            return None
        bplan = step.build if isinstance(step.build, QueryPlan) else None
        est = estimate_plan_bytes(
            self.catalog,
            bplan if bplan is not None else QueryPlan(pipeline=step.build),
            snapshot)
        if est <= self.dist_broadcast_budget_bytes:
            return None

        if isinstance(step.build, QueryPlan):
            built = self.execute(step.build, snapshot)
        else:
            built = HostBlock.concat(
                [to_host(d) for d in
                 self._run_pipeline(step.build, params, snapshot)])
        if prebuilt is not None:
            prebuilt[j] = built
        if step.build_hash_keys:
            # composite key: the probe side carries the combined 64-bit
            # hash in `probe_key`; the build gets the same column, and the
            # per-key equality checks ride in the post-join programs
            built = _add_hash_column(built, step.build_hash_keys,
                                     step.build_key)
            if prebuilt is not None:
                prebuilt[j] = built
        kcd = built.columns.get(step.build_key)
        if kcd is None or np.issubdtype(kcd.data.dtype, np.floating):
            return None
        if step.anti_null_check:
            # an actually-NULL build key under anti/mark semantics: the
            # broadcast lane owns the three-valued logic
            cd0 = built.columns.get(step.anti_null_col or step.build_key)
            if cd0 is not None and cd0.valid is not None \
                    and not cd0.valid.all():
                return None
        if kcd.dictionary is not None:
            # remap build codes into the probe side's dictionary, so codes
            # exchange as plain comparable ints
            table = self.catalog.table(pipe.scan.table)
            probe_dicts = dict(table.dictionaries)
            for (storage, internal) in pipe.scan.columns:
                if storage in probe_dicts:
                    probe_dicts[internal] = probe_dicts[storage]
            probe_dict = probe_dicts.get(step.probe_key)
            if probe_dict is None:
                return None
            if kcd.dictionary is not probe_dict:
                built = _remap_build_codes(built, step.build_key,
                                           probe_dict)
                # values absent from the probe dictionary (code -2) never
                # match: drop them before the exchange
                codes2 = built.columns[step.build_key].data
                if (codes2 == -2).any():
                    built = built.take(np.nonzero(codes2 != -2)[0])
                if prebuilt is not None:
                    prebuilt[j] = built
        # duplicate keys: the exchange probe is first-match only
        if step.kind in ("inner", "left", "mark"):
            enc = built.columns[step.build_key].data
            if len(enc) > 1 and len(np.unique(enc)) != len(enc):
                return None
        devs = list(self.mesh.devices.flat)
        ndev = len(devs)
        barrays, pschema, bdicts, _bcap = SJ.partition_build(
            built, step.build_key, list(step.payload), ndev)
        if not pschema.names and step.payload:
            return None

        # stage A: the pipeline prefix per shard (earlier joins broadcast)
        prefix_builds = self._prepare_builds(pipe, params, snapshot,
                                             until=j)
        per_dev = self._shard_partials(pipe, snapshot, devs, prefix_builds,
                                       params, until=j)

        in_schema = per_dev[0][0].schema
        payload_cols = [Column(name, pschema.dtype(name).with_nullable(True))
                        for name in pschema.names]
        if step.kind == "mark":
            payload_cols.append(Column(step.mark_col or "__mark",
                                       DType(Kind.BOOL, False)))
        rest = [s for (k, s) in pipe.steps[j + 1:]]
        key = (tuple((c.name, c.dtype.kind.value, c.dtype.nullable)
                     for c in in_schema.columns),
               step.probe_key, step.kind,
               tuple((c.name, c.dtype.kind.value, c.dtype.nullable)
                     for c in payload_cols),
               ndev,
               tuple(p.fingerprint() for p in rest),
               pipe.partial.fingerprint() if pipe.partial else "",
               groupby_tuning())
        sj = self._shuffle_joins.get(key)
        if sj is None:
            sj = SJ.ShuffleJoin(self.mesh, in_schema, step.probe_key,
                                step.kind, payload_cols,
                                step.mark_col or "__mark", step.not_in,
                                rest, pipe.partial)
            self._shuffle_joins[key] = sj
        dicts = {}
        for blks in per_dev:
            for b in blks:
                dicts.update(b.dictionaries)
        dicts.update(bdicts)
        post_blocks = sj.run(per_dev, barrays, params, dicts)
        GLOBAL.inc("executor/shuffle_joins")
        return self._merge_distributed_partials(
            plan, [[b] for b in post_blocks], params)

    def _merge_distributed_partials(self, plan: QueryPlan, per_dev: list,
                                    params: dict) -> HostBlock:
        """The mesh lanes' shared tail: the merge of per-shard partial
        aggregates over the mesh, then the rest of the final program."""
        import dataclasses

        from ydb_tpu_torch.ops.torch_exec import groupby_tuning
        from ydb_tpu_torch.parallel.shuffle import DistributedAgg

        ndev = self.mesh.devices.size
        gb = plan.final_program.commands[0]
        merge_prog = ir.Program([gb])
        in_schema = per_dev[0][0].schema
        # a PROVEN merge group-count bound sizes the exchange's segments:
        # each shard's partial holds <= out_bound groups, so a segment of
        # that many rows cannot overflow
        seg_rows = 0
        if gb.out_bound:
            seg_rows = bucket_capacity(max(int(gb.out_bound), 1),
                                       minimum=128)
            GLOBAL.inc("bounds/seg_bounded_shuffles")
        key = (merge_prog.fingerprint(),
               tuple((c.name, c.dtype.kind.value, c.dtype.nullable)
                     for c in in_schema.columns), ndev, seg_rows,
               groupby_tuning())
        dag = self._dist_aggs.get(key)
        if dag is None:
            dag = DistributedAgg(merge_prog, merge_prog, in_schema,
                                 self.mesh, seg_rows=seg_rows)
            self._dist_aggs[key] = dag
        merged = dag.run_device_blocks(per_dev, params)
        rest = list(plan.final_program.commands[1:])
        plan2 = dataclasses.replace(
            plan, final_program=ir.Program(rest) if rest else None)
        return self._finalize(plan2, [to_device(merged, self.device)],
                              params)

    # -- join builds -------------------------------------------------------

    def _prepare_builds(self, pipe: Pipeline, params: dict,
                        snapshot: Snapshot, until: Optional[int] = None,
                        prebuilt: Optional[dict] = None) -> list:
        """Prepare every join build of a pipeline in order, threading the
        probe side's string dictionaries so cross-dictionary string keys
        remap to probe codes.

        `until`: only the joins among steps[:until] (the shuffle join's
        prefix). `prebuilt`: {step index: HostBlock} build sides already
        materialized (a declined shuffle-join attempt hands its block
        over)."""
        probe_dicts = dict(self.catalog.table(pipe.scan.table).dictionaries)
        for (storage, internal) in pipe.scan.columns:
            if storage in probe_dicts:
                probe_dicts[internal] = probe_dicts[storage]
        keep_fd = (pipe.partial is not None and pipe.partial.commands
                   and isinstance(pipe.partial.commands[-1], ir.GroupBy)
                   and len(pipe.partial.commands[-1].keys) >= 2)
        builds = []
        for si, (kind, step) in enumerate(pipe.steps):
            if kind != "join" or (until is not None and si >= until):
                continue
            bt = self._prepare_join(step, params, snapshot,
                                    probe_dict=probe_dicts.get(
                                        step.probe_key),
                                    prebuilt_block=(prebuilt or {}).get(si),
                                    keep_fd=keep_fd)
            builds.append(bt)
            probe_dicts.update(getattr(bt, "dictionaries", None) or {})
        return builds

    def _single_device(self) -> bool:
        return self.mesh is None or self.mesh.devices.size <= 1

    def _prepare_join(self, step: JoinStep, params: dict,
                      snapshot: Snapshot, probe_dict=None,
                      prebuilt_block: Optional[HostBlock] = None,
                      keep_fd: bool = False) -> J.BuildTable:
        from ydb_tpu_torch.query.build_cache import build_plan_fingerprint
        cache_key = None
        if prebuilt_block is None:
            cache_key = build_plan_fingerprint(
                step, params, snapshot, self.catalog,
                extra=(self._single_device(), self.grace_budget_bytes,
                       keep_fd))
            if cache_key is not None:
                hit = self.build_cache.lookup(cache_key, probe_dict)
                if hit is not None:
                    return hit
        bt = self._prepare_join_uncached(step, params, snapshot, probe_dict,
                                         prebuilt_block, keep_fd=keep_fd)
        if cache_key is not None:
            self.build_cache.insert(cache_key, bt, probe_dict)
        return bt

    def _prepare_join_uncached(self, step: JoinStep, params: dict,
                               snapshot: Snapshot, probe_dict=None,
                               prebuilt_block: Optional[HostBlock] = None,
                               keep_fd: bool = False) -> J.BuildTable:
        if prebuilt_block is not None:
            built = prebuilt_block
        elif isinstance(step.build, QueryPlan):
            built = self.execute(step.build, snapshot)
        else:
            # the build PIPELINE runs through the fused path too. Empty
            # output = keep every column (composite-key builds carry
            # internal hash columns a projection would drop)
            bplan = QueryPlan(pipeline=step.build, params=dict(params))
            fused = self._try_execute_fused(bplan, params, snapshot) \
                if self.enable_fused else None
            if isinstance(fused, tuple):
                built = fused[1]
            elif isinstance(fused, HostBlock):
                built = fused
            else:
                built = HostBlock.concat(
                    [to_host(d) for d in
                     self._run_pipeline(step.build, params, snapshot,
                                        builds=fused)])
        kcd = built.columns.get(step.build_key)
        if kcd is not None and kcd.dictionary is not None \
                and probe_dict is not None \
                and kcd.dictionary is not probe_dict:
            built = _remap_build_codes(built, step.build_key, probe_dict)
        if step.build_hash_keys:
            built = _add_hash_column(built, step.build_hash_keys,
                                     step.build_key)
        anti_has_null = False
        if step.anti_null_check:
            cd = built.columns[step.anti_null_col or step.build_key]
            if cd.valid is not None and not cd.valid.all():
                if step.kind == "left_anti":
                    anti_has_null = True
                else:
                    raise NotImplementedError(
                        "correlated NOT IN over a subquery producing NULLs "
                        "is not supported yet")
        # GraceJoin: a build side above the device budget hash-
        # partitions on the host (single-device execution only: the mesh
        # lanes place builds on every shard)
        if self._single_device() and not step.not_in and built.length:
            cols = list(dict.fromkeys([step.build_key] + list(step.payload)))
            row_bytes = sum(built.columns[n].data.itemsize for n in cols)
            if built.length * row_bytes > self.grace_budget_bytes:
                return J.build_partitioned(built, step.build_key,
                                           list(step.payload),
                                           self.grace_budget_bytes,
                                           self.device)
        bt = J.build(built, step.build_key, list(step.payload), self.device,
                     keep_fd=keep_fd)
        bt.anti_has_null = anti_has_null
        return bt

    # -- pipelines (the portioned path) ------------------------------------

    def _run_pipeline(self, pipe: Pipeline, params: dict,
                      snapshot: Snapshot, builds=None) -> list:
        """Partial-result DeviceBlocks, one per scan block (≥1: an empty
        scan still runs the programs once so global aggregates emit their
        row). `builds`: BuildTables already prepared by a declined fused
        attempt."""
        if builds is None:
            builds = self._prepare_builds(pipe, params, snapshot)
        out = []
        for d in self._scan_device_blocks(pipe, snapshot):
            out.extend(self._run_block_multi(pipe, d, builds, params))
        if not out:
            out = self._run_block_multi(
                pipe, to_device(self._empty_scan_block(pipe), self.device),
                builds, params)
        return out

    def _run_block(self, pipe: Pipeline, d: DeviceBlock, builds: list,
                   params: dict) -> DeviceBlock:
        """Single-stream block runner (the mesh lanes, whose builds are
        never partitioned)."""
        out = self._run_block_multi(pipe, d, builds, params)
        assert len(out) == 1, "partitioned join on the mesh path"
        return out[0]

    def _run_block_multi(self, pipe: Pipeline, d: DeviceBlock, builds: list,
                         params: dict, until: Optional[int] = None) -> list:
        """Run one scan block through the pipeline: its programs in
        order, each join a probe of the block, then the partial. A
        GraceJoin-partitioned build forks the stream: probe rows route to
        their key's partition and each partition continues through the
        remaining steps on its own — their partials merge like any other
        blocks.

        `until`: stop BEFORE step index `until` and skip the partial (the
        shuffle join's prefix)."""
        from ydb_tpu_torch.ops.torch_exec import run_on_device
        if pipe.pre_program is not None:
            d = run_on_device(pipe.pre_program, d, params)
        stop = len(pipe.steps) if until is None else until

        def run_steps(d: DeviceBlock, si: int, bi: int) -> list:
            while si < stop:
                kind, step = pipe.steps[si]
                if kind != "join":
                    d = run_on_device(step, d, params)
                    si += 1
                    continue
                table = builds[bi]
                if isinstance(table, J.PartitionedBuild):
                    out = []
                    parts = self._partition_block(d, step.probe_key,
                                                  table.n_partitions)
                    for dp, bt in zip(parts, table.tables):
                        out.extend(self._probe_one(dp, bt, step, run_steps,
                                                   si, bi))
                    return out
                return self._probe_one(d, table, step, run_steps, si, bi)
            if until is None and pipe.partial is not None:
                d = run_on_device(pipe.partial, d, params)
            return [d]

        return run_steps(d, 0, 0)

    @staticmethod
    def _probe_one(d: DeviceBlock, table, step, run_steps, si: int,
                   bi: int) -> list:
        from ydb_tpu_torch.ops.torch_exec import compress_block
        if not table.unique and step.kind in ("inner", "left"):
            # duplicate build keys → expanding probe; output compact
            d = J.probe_expand(d, table, step.probe_key, step.kind)
            return run_steps(d, si + 1, bi + 1)
        d, sel = J.probe(d, table, step.probe_key, step.kind,
                         mark_col=step.mark_col or None, not_in=step.not_in)
        if step.kind != "mark":
            d = compress_block(d, sel)
        return run_steps(d, si + 1, bi + 1)

    @staticmethod
    def _partition_block(d: DeviceBlock, key: str, nparts: int) -> list:
        """The block's rows split by the hash of their key (splitmix64 of
        its int64 value, as the host partitioner hashes the build side):
        one DeviceBlock per partition, holding its rows in order. The
        `partition` kernel moves every column once, so each partition is
        a contiguous range of the moved columns (the reference compresses
        the block once per partition); each block keeps the input's
        capacity, and its rows past its length belong to later partitions
        or are zero. One readback of the counts places the ranges."""
        from ydb_tpu_torch.ops.cuda import bindings as K
        from ydb_tpu_torch.ops.spill import as_int64
        h = K.hash64([as_int64(d.arrays[key])])
        names = [c.name for c in d.schema.columns]
        vnames = [n for n in names if n in d.valids]
        cap = d.capacity
        _ids, counts, moved = K.partition(
            h, d.length, nparts,
            [d.arrays[n].contiguous() for n in names]
            + [d.valids[n].contiguous() for n in vnames],
            out_rows=2 * cap, ids=False)
        lengths = counts.to(torch.int32)
        ends = np.cumsum(batched_to_host([counts])[0])
        out = []
        for p in range(nparts):
            lo = int(ends[p - 1]) if p else 0
            cols = [m[lo:lo + cap] for m in moved]
            out.append(DeviceBlock(
                d.schema, dict(zip(names, cols[:len(names)])),
                dict(zip(vnames, cols[len(names):])), lengths[p], cap,
                dict(d.dictionaries)))
        return out

    def _scan_device_blocks(self, pipe: Pipeline, snapshot: Snapshot,
                            devices=None):
        """Per-portion device blocks via the column cache; committed but
        unindexed inserts, and portions with MVCC delete marks visible at
        the snapshot, upload uncached.

        With `devices`, sources are placed round-robin over the mesh's
        devices and (device index, block) pairs are yielded."""
        table = self.catalog.table(pipe.scan.table)
        storage_names = [s for (s, _i) in pipe.scan.columns]
        rename = {s: i for (s, i) in pipe.scan.columns}
        i = 0
        for shard in table.shards:
            portions, insert_entries = shard.scan_sources(
                snapshot, pipe.scan.prune or None)
            sources = [("p", p) for p in portions] \
                + [("i", e) for e in insert_entries]
            for kind, src in sources:
                di = None
                dev = self.device
                if devices is not None:
                    di = i % len(devices)
                    i += 1
                    dev = devices[di]
                if kind == "i":
                    hb = _rename_block(src.block.select(storage_names),
                                       rename)
                    blk = to_device(hb, dev)
                elif src.deletes and src.delete_sig(snapshot):
                    hb = _rename_block(
                        src.visible_block(snapshot).select(storage_names),
                        rename)
                    blk = to_device(hb, dev)
                else:
                    blk = self.device_cache.device_block(
                        src, storage_names, rename, device=dev)
                yield blk if di is None else (di, blk)

    def _empty_scan_block(self, pipe: Pipeline) -> HostBlock:
        """Zero-row block with the scan's schema and dictionaries."""
        table = self.catalog.table(pipe.scan.table)
        cols, schema_cols = {}, []
        for (storage, internal) in pipe.scan.columns:
            c = table.schema.col(storage)
            cols[internal] = ColumnData(
                np.zeros(0, dtype=c.dtype.np), None,
                table.dictionaries.get(storage))
            schema_cols.append(Column(internal, c.dtype))
        return HostBlock(Schema(schema_cols), cols, 0)

    def _finalize(self, plan: QueryPlan, dblocks: list, params: dict,
                  defer: bool = False) -> "HostBlock | DeviceResultFuture":
        """Concatenate the partials, then the final program, sort and
        limit on the device, then one batched transfer (`defer=True`: the
        transfer runs at `result()` time). Partial-aggregate states too
        large to merge in one device concat (high-cardinality group-bys
        on the portioned path) route to the host partitioned merge
        instead (K14)."""
        in_schema = dblocks[0].schema

        fp = plan.final_program
        merge_gb = fp.commands[0] if fp is not None and fp.commands \
            and isinstance(fp.commands[0], ir.GroupBy) else None
        if merge_gb is not None and merge_gb.keys and len(dblocks) > 1:
            prow = sum(np.dtype(c.dtype.np).itemsize + 1
                       for c in in_schema.columns)
            total = sum(d.capacity for d in dblocks) * prow
            if total > self.merge_budget_bytes:
                from ydb_tpu_torch.ops import spill as SP
                P = 1
                while total / P > self.merge_budget_bytes and P < 256:
                    P *= 2
                dicts = {}
                for d in dblocks:
                    dicts.update(d.dictionaries)
                store = SP.PartitionStore(in_schema, list(merge_gb.keys),
                                          P, dicts)
                for d in dblocks:
                    store.feed(d)
                GLOBAL.inc("executor/spilled_rows", store.spilled_rows)
                GLOBAL.inc("executor/spilled_bytes", store.spilled_bytes)
                merged = self._merge_spilled(plan, store, params)
                return DeviceResultFuture.completed(merged) if defer \
                    else merged
        sort_params, sort_spec, rank_assigns = self._sort_setup(
            plan, in_schema, dblocks)
        all_params = {**params, **sort_params}
        dev = _block_device(dblocks[0], self.device)
        dev_params = {k: (to_tensor(v, dev)
                          if isinstance(v, np.ndarray) else v)
                      for k, v in all_params.items()}
        out_d, out_v, length, out_schema = self._build_finalize(
            plan, in_schema, dblocks, sort_spec, rank_assigns, dev_params)

        dicts = {}
        for d in dblocks:
            dicts.update(d.dictionaries)
        dicts.update(plan.result_dicts)
        dicts = {n: dc for n, dc in dicts.items() if out_schema.has(n)}
        out_cap = (next(iter(out_d.values())).shape[0] if out_d else 0)
        dblock = DeviceBlock(out_schema, out_d, out_v, length, out_cap, dicts)
        lo = plan.offset or 0
        limit = plan.limit
        fut = DeviceResultFuture(
            lambda: _apply_offset(to_host(dblock), lo, limit))
        return fut if defer else fut.result()

    def _sort_setup(self, plan: QueryPlan, in_schema: Schema, dblocks: list):
        """Rank-LUT params for string sort keys (lexicographic order over
        dictionary codes) + the static sort spec."""
        schema = in_schema
        if plan.final_program is not None:
            schema = ir.infer_schema(plan.final_program, in_schema)
        dicts = {}
        for d in dblocks:
            dicts.update(d.dictionaries)
        return self._sort_setup_fused(plan, schema, dicts)

    def _build_finalize(self, plan: QueryPlan, in_schema: Schema,
                        dblocks: list, sort_spec: tuple, rank_assigns: list,
                        params: dict):
        """The finalize body, eager: concatenate the partials' live rows,
        run the final program, the rank assigns, the sort and the limit.
        Returns (arrays, valids, length, out_schema)."""
        from ydb_tpu_torch.core.dtypes import Kind
        from ydb_tpu_torch.ops.sort import sort_env
        from ydb_tpu_torch.ops import k1
        from ydb_tpu_torch.ops.torch_exec import (
            _trace_program, compress,
        )
        final_prog = plan.final_program
        in_cols = list(in_schema.columns)
        names = [c.name for c in in_cols]
        out_schema = ir.infer_schema(final_prog, in_schema) \
            if final_prog is not None else in_schema
        limit = plan.limit
        lim2 = None if limit is None else limit + (plan.offset or 0)
        keep = list(dict.fromkeys(n for (n, _lbl) in plan.output))
        dev = _block_device(dblocks[0], self.device)

        masks = [torch.arange(d.capacity, dtype=torch.int32, device=dev)
                 < d.length for d in dblocks]
        total = sum(d.capacity for d in dblocks)
        env = {}
        for n in names:
            data = torch.cat([d.arrays[n] for d in dblocks])
            valid = torch.cat([d.valids[n] if n in d.valids
                               else torch.ones(d.capacity, dtype=torch.bool,
                                               device=dev)
                               for d in dblocks])
            env[n] = (data, valid)
        mask = torch.cat(masks)
        env, length = compress(env, total, mask, total, dev)
        cap = total
        if final_prog is not None:
            env, length, sel, _schema = _trace_program(
                final_prog, in_cols, cap, env, length, params, dev)
            if env:
                cap = next(iter(env.values()))[0].shape[0]
            if sel is not None:
                env, length = compress(env, length, sel, cap, dev)
        if rank_assigns:
            k1.run_stage(rank_assigns, env, params, None, cap, dev)
        if sort_spec:
            arrays = {n: d for n, (d, _v) in env.items()}
            valids = {n: v for n, (d, v) in env.items() if v is not None}
            arrays2, valids2, length = sort_env(
                arrays, valids, length, None, sort_spec,
                tuple(arrays.keys()),
                unsigned=frozenset(n for n in arrays if out_schema.has(n)
                                   and out_schema.dtype(n).kind
                                   == Kind.UINT64))
            env = {n: (arrays2[n], valids2.get(n)) for n in arrays2}
        if lim2 is not None:
            length = torch.clamp(length, max=lim2)
            out_cap = min(bucket_capacity(lim2, minimum=128), cap)
            env = {n: (d[:out_cap], v[:out_cap] if v is not None else None)
                   for n, (d, v) in env.items()}
        out_names = [n for n in keep if n in env] or list(env.keys())
        out_d = {n: env[n][0] for n in out_names}
        out_v = {n: env[n][1] for n in out_names if env[n][1] is not None}
        out_cols = [c for c in out_schema.columns if c.name in keep] \
            or list(out_schema.columns)
        return out_d, out_v, length, Schema(out_cols)

    # -- output ------------------------------------------------------------

    def _project_output(self, block: HostBlock, output: list) -> HostBlock:
        if isinstance(block, DeviceStageBlock) and not block.materialized:
            # stage-spine path: rename on the device, references only
            # (touching `block.columns` would force the readback the
            # capture exists to avoid)
            return block.project(output)
        cols = {}
        schema_cols = []
        used = set()
        for (internal, label) in output:
            lbl = label
            k = 2
            while lbl in used:
                lbl = f"{label}_{k}"
                k += 1
            used.add(lbl)
            cd = block.columns[internal]
            cols[lbl] = ColumnData(cd.data, cd.valid, cd.dictionary)
            schema_cols.append(Column(lbl, block.schema.dtype(internal)))
        return HostBlock(Schema(schema_cols), cols, block.length)


def _block_device(d: DeviceBlock, default):
    """The device a block's columns live on (a mesh shard's, or the
    executor's own)."""
    for t in d.arrays.values():
        return t.device
    return default


def _tile_done(device):
    """A CUDA event marking the work queued so far (None on the CPU,
    where every call has finished when it returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _param_values_equal(a, b) -> bool:
    """Batch-invariance test for one runtime param across two members
    (arrays compare by dtype/shape/contents; scalars by type + value)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and bool(a == b)


def _apply_offset(block: HostBlock, lo: int, limit) -> HostBlock:
    """OFFSET/LIMIT tail slice of the deferred readout."""
    if lo:
        hi = lo + limit if limit is not None else block.length
        block = block.slice(lo, min(hi, block.length))
    return block


def _remap_build_codes(built: HostBlock, key: str, probe_dict) -> HostBlock:
    """Translate a build block's dictionary-encoded key codes into the
    PROBE side's dictionary (values absent from the probe dictionary →
    -2, the never-match code; the -1 NULL slot passes through)."""
    kcd = built.columns[key]
    src = kcd.dictionary.values_array()
    lut = np.full(max(len(src), 1), -2, dtype=np.int32)
    for i, v in enumerate(src):
        lut[i] = probe_dict.encode_existing(v)
    codes = kcd.data
    remapped = np.where(codes >= 0, lut[np.clip(codes, 0, None)],
                        codes).astype(codes.dtype)
    return HostBlock(
        built.schema,
        {**built.columns, key: ColumnData(remapped, kcd.valid, probe_dict)},
        built.length)


def _add_hash_column(block: HostBlock, key_cols: list, out: str) -> HostBlock:
    """Host-side composite-key hash column (`hash_combine(hash64(c0),
    hash64(c1), ...)`, `utils/hashing.py`)."""
    from ydb_tpu_torch.core.dtypes import DType, Kind
    from ydb_tpu_torch.utils.hashing import hash_combine, splitmix64

    if out in block.columns:
        return block
    h = None
    valid = None
    for name in key_cols:
        cd = block.columns[name]
        x = splitmix64(np, cd.data.astype(np.int64))
        h = x if h is None else hash_combine(np, h, x)
        if cd.valid is not None:
            valid = cd.valid if valid is None else (valid & cd.valid)
    cols = dict(block.columns)
    cols[out] = ColumnData(h, valid, None)
    schema = block.schema.extend([Column(out, DType(Kind.UINT64,
                                                    valid is not None))])
    return HostBlock(schema, cols, block.length)


def _rename_block(block: HostBlock, rename: dict) -> HostBlock:
    cols = {}
    schema_cols = []
    for c in block.schema:
        new = rename.get(c.name, c.name)
        cols[new] = block.columns[c.name]
        schema_cols.append(Column(new, c.dtype))
    return HostBlock(Schema(schema_cols), cols, block.length)
