"""Process counters, latency histograms and per-statement stats of the port.

``Counters`` is the port's named counter registry (``GLOBAL``): the
planner, bounds, executor, batch lane, admission and pipeline count
into it (``inc``, ``set``, ``set_max``, ``get``). The rest is copied
from the reference's ``utils/metrics.py`` (``tests/test_torch_drift.py``
holds each piece): the log-bucketed ``Histogram`` and its registry
``GLOBAL_HIST`` (the statement latency families, the admission wait,
the ledger's peaks, the critical path's coverage), ``COUNTER_REGISTRY``
with the ``HIST_FAMILIES`` and ``ALWAYS_VISIBLE`` marks that
``QueryEngine.counters()`` zero-fills, the per-statement ``QueryStats``
that EXPLAIN ANALYZE renders (``engine.last_stats``), and ``Timer``.
The OpenMetrics renderer is not ported (the HTTP front is not)."""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


class Counters:
    def __init__(self):
        self._mu = threading.Lock()
        self._vals: dict = {}

    def inc(self, name: str, by=1) -> None:
        with self._mu:
            self._vals[name] = self._vals.get(name, 0) + by

    def set(self, name: str, value) -> None:
        with self._mu:
            self._vals[name] = value

    def set_max(self, name: str, value) -> None:
        """High-watermark gauge: the largest value ever reported."""
        with self._mu:
            if value > self._vals.get(name, float("-inf")):
                self._vals[name] = value

    def get(self, name: str, default=0):
        with self._mu:
            return self._vals.get(name, default)

    def snapshot(self) -> dict:
        with self._mu:
            return dict(self._vals)


GLOBAL = Counters()


class Histogram:
    """Log-bucketed latency histogram (the monlib NHistogram exponential
    bucket family): bucket i covers [BASE·G^(i-1), BASE·G^i), G=2,
    BASE=0.05 ms — 32 buckets span 50 µs … ~30 h (0.05·2^31 ms),
    everything above lands in one overflow bucket. Quantiles
    interpolate geometrically inside the winning bucket and clamp to
    the exact observed min/max, so a single sample reports itself at
    every quantile."""

    BASE = 0.05
    GROWTH = 2.0
    N_BUCKETS = 32                    # + 1 overflow

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * (self.N_BUCKETS + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bucket(self, v: float) -> int:
        if v < self.BASE:
            return 0
        i = int(math.log(v / self.BASE, self.GROWTH)) + 1
        return min(i, self.N_BUCKETS)      # N_BUCKETS = overflow

    def record(self, v: float) -> None:
        v = max(0.0, float(v))
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= rank:
                if i >= self.N_BUCKETS:
                    # overflow bucket is unbounded above — the exact
                    # observed max is the only honest answer
                    return self.max
                lo = self.BASE * self.GROWTH ** (i - 1) if i > 0 else 0.0
                hi = self.BASE * self.GROWTH ** i
                frac = (rank - acc) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            acc += c
        return self.max

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                    "max": 0.0}
        return {"count": self.count,
                "p50": round(self.quantile(0.50), 3),
                "p95": round(self.quantile(0.95), 3),
                "p99": round(self.quantile(0.99), 3),
                "max": round(self.max, 3)}

    def cumulative(self) -> list:
        """[(upper_bound, cumulative_count)] in bucket order, ending
        with (inf, count) — the OpenMetrics histogram `_bucket{le=}`
        series (cumulative by spec; the overflow bucket maps to
        le=\"+Inf\")."""
        out, acc = [], 0
        for i in range(self.N_BUCKETS):
            acc += self.counts[i]
            out.append((self.BASE * self.GROWTH ** i, acc))
        out.append((math.inf, self.count))
        return out


class HistogramRegistry:
    """Named histograms with the Counters locking discipline; surfaced
    on /counters as `hist/<name>/{count,p50,p95,p99,max}`."""

    def __init__(self):
        import threading
        self._h: dict[str, Histogram] = {}
        self._mu = threading.Lock()

    def observe(self, name: str, value_ms: float) -> None:
        with self._mu:
            h = self._h.get(name)
            if h is None:
                h = self._h[name] = Histogram()
            h.record(value_ms)

    def get(self, name: str) -> Optional[Histogram]:
        with self._mu:
            return self._h.get(name)

    def snapshot(self) -> dict:
        """Flat /counters payload: hist/<name>/p50 etc. Per-histogram
        snapshots are taken UNDER the lock — quantile() walks counts[]
        against self.count, and a concurrent record() between the two
        would hand back a torn view."""
        out = {}
        with self._mu:
            for name, h in self._h.items():
                for k, v in h.snapshot().items():
                    out[f"hist/{name}/{k}"] = v
        return out

    def families(self) -> dict:
        """Consistent per-histogram export payload (taken under the
        lock, same torn-view discipline as snapshot()):
        name -> {"buckets": [(le, cum)], "sum", "count"}."""
        out = {}
        with self._mu:
            for name, h in self._h.items():
                out[name] = {"buckets": h.cumulative(),
                             "sum": h.sum, "count": h.count}
        return out


GLOBAL_HIST = HistogramRegistry()

# the reference's counter registry (its docs are the reference's;
# the port emits a subset): the [hist] and [viz] marks below make
# the histogram families and the always-visible counters
COUNTER_REGISTRY = {
    # -- statement latency histograms (end-to-end + per phase) -------------
    "query/latency_ms": "[hist] statement wall end-to-end",
    "query/parse_ms": "[hist] statement parse phase",
    "query/plan_ms": "[hist] statement plan phase",
    "query/execute_ms": "[hist] statement execute phase",
    # -- engine -------------------------------------------------------------
    "engine/queries": "SELECTs executed",
    "engine/statements": "statements executed (all kinds)",
    "engine/rows_out": "result rows returned",
    "engine/plan_cache_hits": "text-keyed plan cache hits",
    "engine/plan_cache_misses": "text-keyed plan cache misses",
    "engine/plan_cache_size": "(derived) live plan-cache entries",
    "engine/throttled": "statements rejected by the quoter",
    "engine/ttl_evicted": "rows dropped by TTL sweeps",
    "engine/shard_splits": "shard split operations",
    "engine/window_device_pushdown": "window queries on the device lane",
    "engine/window_device_rows": "rows through the device window lane",
    "engine/window_device_errors": "device window lane fallbacks",
    "engine/host_lane/*": "host-lane residency by statement shape",
    # -- executor -----------------------------------------------------------
    "executor/fused_plans": "(derived) live fused-plan cache entries",
    "executor/tiled_queries": "queries run through the tiled path",
    "executor/shuffle_joins": "mesh shuffle-join executions",
    "executor/spilled_rows": "rows spilled by the partition store",
    "executor/spilled_bytes": "bytes spilled by the partition store",
    # -- concurrent pipeline ------------------------------------------------
    "pipeline/dispatched": "[viz] queries dispatched async",
    "pipeline/in_flight": "[viz] dispatched-undrained gauge",
    "pipeline/overlap_hits": "[viz] entries that found another in flight",
    "pipeline/readout_ms": "[viz] cumulative readout wall",
    "pipeline/window_timeouts": "admissions that outwaited the window",
    "pipeline/window": "(derived) configured pipeline window",
    # -- batched dispatch lane ---------------------------------------------
    "batch/batches": "[viz] stacked executions dispatched",
    "batch/coalesced_queries": "[viz] member queries across batches",
    "batch/max_size": "[viz] largest batch ever sealed",
    "batch/singles": "[viz] solo members run per-query",
    "batch/fallbacks": "[viz] sealed batches that fell back per-member",
    "batch/declined": "[viz] lane-ineligible statements",
    "batch/trace_errors": "[viz] stacked-trace failures",
    "batch/reservations": "[viz] single admission reservations taken",
    "batch/window_timeouts": "[viz] members that outwaited the seal",
    "batch/lift_hits": "[viz] plans with every literal lifted",
    "batch/lift_misses": "[viz] plans the lift pass skipped",
    "batch/window_ms": "(derived) configured batch window",
    # -- admission ----------------------------------------------------------
    "admission/active_queries": "admitted-statement gauge",
    "admission/in_flight_bytes": "reserved working-set gauge",
    "admission/waits": "admissions that had to queue",
    "admission/timeouts": "admissions that hit the deadline",
    "admission/wait_ms": "[hist] admission queue wait",
    "admission/calibrated":
        "[viz] queries with both an estimate and a measured peak",
    "admission/est_error_pct":
        "[hist] admission estimate vs measured peak (|est-peak|/peak %)",
    # -- resource ledger (utils/memledger.py): per-query device bytes ------
    "mem/ledgers": "[viz] statements that closed a resource ledger",
    "mem/alloc_bytes": "[viz] ledger: device bytes allocated (cumulative)",
    "mem/freed_bytes": "[viz] ledger: device bytes released (cumulative)",
    "mem/peak_bytes":
        "[viz] high-watermark of any single query's device working set",
    "mem/peak_mb": "[hist] per-query peak device working set (MB)",
    # -- padding-waste accounting (live vs padded structure bytes) ---------
    "pad/live_bytes": "[viz] live-row bytes through padded structures",
    "pad/padded_bytes": "[viz] allocated/shipped bytes of those structures",
    "pad/waste_bytes": "[viz] padded minus live — the padding tax",
    # -- host-transfer flight recorder (device→host readbacks) -------------
    "hostsync/transfers": "[viz] device→host transfers (flight recorder)",
    "hostsync/bytes": "[viz] bytes those transfers moved",
    "hostsync/boundary_transfers":
        "[viz] the transfer-ok-excused boundary subset (client egress)",
    "hostsync/to_pandas_in_plan":
        "[viz] to_pandas materializations INSIDE a multi-stage plan",
    "devlink/handoffs":
        "[viz] device→device block handoffs (stage spine, no host sync)",
    "devlink/bytes": "[viz] live bytes those handoffs kept on device",
    # -- DQ task-graph runtime ---------------------------------------------
    "dq/stages": "stages executed (runner)",
    "dq/tasks": "tasks launched (runner + worker)",
    "dq/tasks_retried": "tasks re-run by a stage-level retry",
    "dq/channel_bytes": "frame bytes shipped over host-plane channels",
    "dq/frames": "frames shipped over host-plane channels",
    "dq/local_stage_execs": "statements run as DQ stage programs",
    "dq/channel_inflight_peak_bytes": "flow-control high watermark",
    "dq/merge_groupby_stages":
        "[viz] merge stages that are partial-agg merges",
    "dq/retry_rerouted":
        "[viz] tasks/statements re-routed off a transport-dead worker",
    "dq/stage_ms": "[hist] per-stage wall",
    "dq/channel_wait_ms":
        "[hist] channel wait (input drain + writer backpressure)",
    # -- DQ ICI plane (device-resident edges; dq/channel_bytes stays 0) ----
    "dq/ici_bytes": "[viz] interconnect bytes moved by collectives",
    "dq/ici_frames": "[viz] (src, dst) segments exchanged",
    "dq/ici_fallbacks": "[viz] ICI edges re-run on the host plane",
    "dq/quant_bytes_saved":
        "[viz] wire bytes saved by EQuARX block quantization",
    "dq/quant_refused":
        "[viz] declared quant columns refused (shipped exact)",
    "dq/planned_overflow_reruns":
        "[viz] planned exchanges whose counts beat the sized segment "
        "(full-capacity rerun)",
    "dq/count_exchange_batched":
        "[viz] stage-level batched count exchanges (one fused counts "
        "program + one device_get for ALL outgoing edges)",
    # -- Hive control plane -------------------------------------------------
    "hive/registered": "[viz] workers registered (first time)",
    "hive/heartbeats": "[viz] lease renewals (push agents or pulse)",
    "hive/worker_dead": "[viz] alive→dead transitions",
    "hive/lease_expired": "[viz] the expiry subset of worker_dead",
    "hive/workers_alive": "[viz] gauge: currently alive workers",
    "hive/shards_replaced": "[viz] shards moved off dead workers",
    "hive/shards_adopted": "shard images replayed INTO this node",
    "hive/adopted_rows": "rows absorbed by those replays",
    "hive/adopt_failed": "[viz] re-placements whose image replay raised",
    "hive/rejoin_stale": "dead workers that re-registered re-placed",
    "hive/failover_holds": "[viz] queries held at the placement barrier",
    "hive/placement_epoch": "[viz] gauge: placement map version",
    "hive/elections_won": "lease-election wins (pending→leader)",
    "hive/leadership_lost": "leaders fenced by a lost lease",
    "hive/standby_promotions": "engines booted from a standby root",
    # -- sorted group-by trace counters (accrued at TRACE time; deltas
    # visible only for freshly compiled shapes — the CI gather gate
    # relies on that; emitted via _t_inc/_t_max in ops/xla_exec.py) ---------
    "groupby/traces": "[viz] (dynamic) sorted group-by lowerings traced",
    "groupby/tiles": "[viz] (dynamic) tiles across those traces",
    "groupby/gather_ops":
        "[viz] (dynamic) gathers above the tile-row budget",
    "groupby/gather_ops_total": "[viz] (dynamic) every traced gather",
    "groupby/batched_gathers":
        "[viz] (dynamic) per-dtype multi-column 2-D gathers",
    "groupby/scatter_ops": "[viz] (dynamic) scatter-reduces (legacy path)",
    "groupby/sort_rows_max": "[viz] (dynamic) group-by sort row watermark",
    "groupby/value_gather_rows_max":
        "[viz] (dynamic) value-column gather row watermark",
    # -- bounds lattice (query/bounds.py, YDB_TPU_BOUNDS) ------------------
    "bounds/plans": "[viz] plans annotated by the bounds lattice",
    "bounds/finite_plans": "[viz] plans whose result bound is finite",
    "bounds/proven_rows":
        "[viz] (dynamic) per-group rows allocated at the proven bound",
    "bounds/capacity_rows":
        "[viz] (dynamic) rows capacity sizing would have allocated",
    "bounds/bounded_groupbys":
        "[viz] (dynamic) group-by traces with a finite group bound",
    "bounds/carried_keys":
        "[viz] (dynamic) grouping columns carried out of sort identity",
    "bounds/carry_rewrites": "[viz] executor carry-key plan rewrites",
    "bounds/eager_agg_rewrites":
        "[viz] LEFT JOIN builds pre-aggregated below the join",
    "bounds/fd_checks": "functional-dependency verifications attempted",
    "bounds/fd_verified": "functional-dependency verifications proven",
    "bounds/admission_capped_bytes":
        "admission estimate bytes removed by proven build bounds",
    "bounds/seg_bounded_shuffles":
        "mesh shuffle merges with bound-sized segments",
    "groupby/join_bounded_plans":
        "[viz] plans whose group count a join build side bounded",
    # -- late materialization (query/latemat.py, YDB_TPU_LATE_MAT) ---------
    "latemat/deferred_cols":
        "[viz] columns carried as row-ids per fused dispatch "
        "(scan deferrals + late join payloads)",
    "latemat/compact_plans":
        "[viz] fused dispatches carrying a bound-sized ir.Compact",
    "latemat/compact_capacity_rows":
        "ladder-quantized compact capacities allocated (rows)",
    "latemat/compact_live_rows":
        "measured live rows at the compact seam (rows)",
    "latemat/compact_overflow_reruns":
        "[viz] compacts whose live count beat the sized bound "
        "(full-capacity rerun — loud, never a truncation)",
    "sort/rows_max": "[viz] (dynamic) lax.sort row watermark",
    "sort/operands_max": "[viz] (dynamic) lax.sort operand watermark",
    # -- program / device caches -------------------------------------------
    "program_cache/compiles": "[viz] fresh XLA compiles (timed shim)",
    "program_cache/compile_ms": "[viz] cumulative compile wall",
    "program_cache/hits": "(derived) ProgramCache hits",
    "program_cache/misses": "(derived) ProgramCache misses",
    # -- compiled-program observatory (utils/progstats.py): XLA cost-model
    # roofline accounting per compiled executable ---------------------------
    "prog/registered":
        "[viz] programs captured with compile-time cost/memory analysis",
    "prog/compile_ms": "[viz] cumulative AOT lower+compile wall",
    "prog/executions":
        "[viz] measured device executions joined to a program",
    "prog/device_ms": "[viz] cumulative measured device-execute wall",
    "prog/evicted": "[viz] inventory entries marked evicted (LRU)",
    "prog/recompiled":
        "[viz] evicted keys compiled again (a MISS, never a hit)",
    "prog/cost_unavailable":
        "[viz] programs whose backend withheld cost analysis",
    "prog/aot_errors":
        "[viz] AOT captures that failed (the legacy jit path ran)",
    "prog/aot_fallbacks":
        "[viz] AOT calls re-dispatched via jit (aval/device drift)",
    "prog/utilization_pct":
        "[hist] per-execution roofline utilization (% of peak)",
    # -- persistent program store + compile-ahead lane (ydb_tpu/progstore):
    # executables that outlive the process, shape buckets, background
    # compiles overlapped with the admission wait ---------------------------
    "prog/store_hits":
        "[viz] executables deserialized from the on-disk store "
        "(compile_ms ~= 0 — the zero-compile restart path)",
    "prog/store_misses": "[viz] store lookups that found no entry",
    "prog/store_writes": "[viz] fresh executables serialized to disk",
    "prog/store_corrupt":
        "[viz] corrupt/truncated/version-skewed entries evicted from "
        "disk and treated as cold misses",
    "prog/store_refused":
        "[viz] entries refused on device-fingerprint mismatch (a "
        "copied data dir must not dispatch a foreign executable)",
    "prog/store_errors":
        "[viz] store I/O failures swallowed as misses (a broken disk "
        "never fails the query)",
    "prog/compile_ahead_launches":
        "[viz] background fused-program fills kicked before admission",
    "prog/compile_ahead_hits":
        "[viz] programs the background lane made ready before their "
        "first dispatch",
    "prog/compile_ahead_dedup":
        "[viz] concurrent fills that deduped onto an in-flight "
        "compile (the storm-compiles-once guarantee)",
    "prog/compile_ahead_errors":
        "[viz] background fills that failed (the synchronous path "
        "re-raises with full context)",
    "device_cache/hits": "(derived) HBM column cache hits",
    "device_cache/misses": "(derived) HBM column cache misses",
    "device_cache/bytes": "(derived) HBM column cache residency",
    # -- critical-path analysis (utils/critpath.py): the blocking-chain
    # decomposition of query wall — crit/<class>_ms accumulate via the
    # wildcard family below --------------------------------------------------
    "crit/extractions": "[viz] critical paths extracted",
    "crit/disconnected": "[viz] extractions whose chain had gaps",
    "crit/non_device_ms":
        "[viz] cumulative critical-path wall NOT spent executing on "
        "device — the speed-gap ledger's raw material",
    "crit/coverage_pct":
        "[hist] critical-path coverage of the query wall (%)",
    "crit/*": "critical-path milliseconds by segment class "
              "(device_execute/compile/host_transfer/host_lane/"
              "channel_wait/admission_wait/scheduler_gap)",
    # -- tracing / slow queries --------------------------------------------
    "trace/forced_slow": "[viz] statements force-sampled as offenders",
    "trace/sample_rate": "(derived) configured sample rate",
    "trace/profiles_held": "(derived) profile ring occupancy",
    "slow_query/count": "[viz] over-threshold statements",
    "slow_query/worst_ms": "worst statement wall seen",
    "slow_query/*": "over-threshold statements by kind",
    # -- materialized views (ydb_tpu/views/): continuous queries folding
    # CDC deltas into device-maintained aggregate state ----------------------
    "view/registered": "(dynamic) materialized views currently defined",
    "view/applied_deltas":
        "[viz] changefeed messages folded into view state",
    "view/delta_rows":
        "[viz] signed delta rows (old/new images) through fold programs",
    "view/fold_ms":
        "[hist] one delta-batch fold wall (delta block -> row program "
        "-> partial group-by -> state apply) — flat in delta size, "
        "never O(table)",
    "view/rebuilds":
        "[viz] full-recompute escapes (bound exceeded / pre-image-less "
        "mutation / missing host mirror)",
    "view/lag_versions":
        "(dynamic) coordinator steps the laggiest fold is behind",
    "view/reads_state":
        "[viz] view reads served from folded state at the watermark",
    "view/reads_fallback":
        "[viz] view reads that fell back to the base query (snapshot "
        "behind state, or degraded view)",
    # -- servers ------------------------------------------------------------
    "server/http_queries": "HTTP front statements",
    "server/rpc_in_flight": "(dynamic) gRPC handler gauge",
    "coordinator/plan_step": "(derived) last 2PC plan step",
}

# the fixed histogram families (always-visible keys on /counters — see
# QueryEngine.counters): derived from the registry's [hist] marks
HIST_FAMILIES = tuple(sorted(
    n for n, doc in COUNTER_REGISTRY.items() if doc.startswith("[hist]")))

# counters QueryEngine.counters() zero-fills so dashboards/probes never
# see missing keys — the registry's [viz] marks
ALWAYS_VISIBLE = tuple(sorted(
    n for n, doc in COUNTER_REGISTRY.items() if doc.startswith("[viz]")))


@dataclass
class QueryStats:
    """Per-statement execution breakdown (TDqTaskRunnerStatsView analog)."""
    sql: str = ""
    kind: str = ""                 # select | insert | update | ddl | ...
    parse_ms: float = 0.0
    plan_ms: float = 0.0
    execute_ms: float = 0.0
    total_ms: float = 0.0
    rows_out: int = 0
    plan_cache_hit: bool = False
    fused: bool = False            # whole-query single-dispatch path
    distributed: bool = False      # mesh hash-shuffle path
    tables: list = field(default_factory=list)
    # sorted group-by trace breakdown (tiles/gather_ops/…, the
    # `xla_exec.groupby_trace_delta` window for this statement) —
    # non-empty only when it compiled a fresh group-by shape
    groupby: dict = field(default_factory=dict)
    # bounds-lattice trace breakdown (`query/bounds.py`): proven vs
    # capacity per-group rows this statement's fresh group-by shapes
    # allocated, carried-key counts — the `-- bounds:` line's source
    bounds: dict = field(default_factory=dict)
    # batched dispatch lane (`query/batch_lane.py`): how this statement
    # rode a coalesced batch — {"coalesced": B, "leader": bool,
    # "batched": bool} (batched=False → the lane fell back to per-member
    # execution); empty when the lane is off or the shape was ineligible
    batching: dict = field(default_factory=dict)
    # device-timeline attribution (`utils/tracing.phase_breakdown` over
    # this statement's spans): {build_ms, upload_ms, dispatch_ms,
    # device_ms, readout_ms, compile_ms} — empty when the statement was
    # unsampled or never touched the device
    phases: dict = field(default_factory=dict)
    # resource-ledger rollup (`utils/memledger.MemLedger.summary`):
    # peak/alloc device bytes, padding live-vs-padded account, host
    # transfers, admission calibration — empty when YDB_TPU_MEMLEDGER=0
    memory: dict = field(default_factory=dict)
    # critical-path rollup (`utils/critpath.summarize`): per-class ms +
    # % of wall, coverage, the dominant span — the blocking chain, not
    # another aggregate. Empty when unsampled or YDB_TPU_CRITPATH=0.
    critical_path: dict = field(default_factory=dict)
    # compiled-program roofline rollup (`utils/progstats.py`): the
    # programs this statement executed with their measured device ms
    # joined to the XLA cost model — {n, device_ms, utilization_pct,
    # bound_class, programs: [...]}. Empty when no instrumented program
    # ran or YDB_TPU_PROGSTATS=0.
    programs: dict = field(default_factory=dict)
    # materialized-view serving decisions (`views/manager.py`): one
    # {view, mode, watermark} per view this read referenced — mode
    # "state" served the folded aggregate state at the watermark,
    # "fallback"/"degraded" re-ran the defining query at the snapshot
    view_serving: list = field(default_factory=list)

    def render(self) -> str:
        path = ("mesh-distributed" if self.distributed
                else "fused single-dispatch" if self.fused
                else "portioned")
        out = (f"-- stats: total {self.total_ms:.1f}ms "
               f"(parse {self.parse_ms:.1f}, plan {self.plan_ms:.1f}"
               f"{' [cache hit]' if self.plan_cache_hit else ''}, "
               f"execute {self.execute_ms:.1f}) | "
               f"rows out {self.rows_out} | path {path}")
        if self.groupby:
            g = self.groupby
            out += (f"\n-- groupby trace: tiles {g.get('tiles', 0)} | "
                    f"gathers {g.get('gather_ops_total', 0)} "
                    f"({g.get('gather_ops', 0)} over tile budget, "
                    f"{g.get('batched_gathers', 0)} batched) | "
                    f"sort rows max {g.get('sort_rows_max', 0)} | "
                    f"value gather rows max "
                    f"{g.get('value_gather_rows_max', 0)}")
        if self.bounds:
            bd = self.bounds
            proven = bd.get("proven_rows", 0)
            cap = bd.get("capacity_rows", 0)
            line = (f"\n-- bounds: proven {proven} rows vs capacity "
                    f"{cap}")
            if cap:
                line += f" ({proven / cap:.3f}x tightening)"
            if bd.get("carried_keys"):
                line += f" | {bd['carried_keys']} carried key(s)"
            if bd.get("bounded_groupbys"):
                line += (f" | {bd['bounded_groupbys']} bounded "
                         "group-by(s)")
            out += line
        if self.batching:
            b = self.batching
            out += (f"\n-- batching: coalesced {b.get('coalesced', 0)} "
                    f"queries | leader "
                    f"{str(b.get('leader', False)).lower()} | "
                    f"{'stacked dispatch' if b.get('batched') else 'per-member fallback'}")
        if self.phases:
            p = self.phases
            out += ("\n-- phases: " + " | ".join(
                f"{k.removesuffix('_ms')} {p[k]:.1f}ms"
                for k in ("compile_ms", "build_ms", "upload_ms",
                          "dispatch_ms", "device_ms", "readout_ms")
                if k in p))
        if self.memory and (self.memory.get("peak_bytes")
                            or self.memory.get("transfers")):
            m = self.memory
            mb = 1 << 20
            line = f"\n-- memory: peak {m.get('peak_bytes', 0) / mb:.2f}MB"
            if m.get("admission_est_bytes") is not None:
                line += (f" (admitted {m['admission_est_bytes'] / mb:.2f}"
                         f"MB")
                if m.get("est_error_pct") is not None:
                    line += f", err {m['est_error_pct']:.0f}%"
                line += ")"
            if m.get("pad_efficiency") is not None:
                line += (f" | pad eff {m['pad_efficiency']:.2f} "
                         f"(live {m.get('live_bytes', 0) / mb:.2f}MB / "
                         f"padded {m.get('padded_bytes', 0) / mb:.2f}MB)")
            line += (f" | host transfers {m.get('transfers', 0)} "
                     f"({m.get('transfer_bytes', 0) / mb:.2f}MB")
            if m.get("to_pandas_in_plan"):
                line += f", {m['to_pandas_in_plan']} to_pandas-in-plan"
            line += ")"
            out += line
        for v in self.view_serving:
            if v.get("mode") == "state":
                out += (f"\n-- view {v['view']}: state @ plan_step "
                        f"{v['watermark']}")
            else:
                out += (f"\n-- view {v['view']}: base-query fallback "
                        f"({v.get('mode', 'fallback')}, watermark "
                        f"plan_step {v['watermark']})")
        if self.programs and self.programs.get("programs"):
            p = self.programs
            head = (f"\n-- programs: {p['n']} | "
                    f"device {p['device_ms']:.2f}ms")
            if p.get("utilization_pct") is not None:
                head += f" | utilization {p['utilization_pct']:.1f}%"
            if p.get("bound_class"):
                head += f" | {p['bound_class']}"
            out += head
            for pr in p["programs"][:6]:
                # provenance tag: [fresh] = compiled inside this
                # statement; [store]/[compile-ahead] = the compile was
                # skipped (persistent store hit / background lane)
                src = pr.get("source", "fresh")
                tag = (" [fresh]" if pr.get("fresh")
                       else f" [{src.replace('_', '-')}]"
                       if src != "fresh" else "")
                line = f"\n--   {pr['key']}{tag}: "
                if pr.get("bound_class") == "unavailable" \
                        or pr.get("flops") is None:
                    line += ("cost unavailable (backend withheld "
                             "analysis)")
                else:
                    line += (f"flops {pr['flops']:.4g} "
                             f"bytes {pr['bytes_accessed']:.4g}")
                    if pr.get("intensity") is not None:
                        line += f" (intensity {pr['intensity']:.2f})"
                line += f" | device {pr['device_ms']:.2f}ms"
                if pr.get("achieved_gflops") is not None:
                    line += (f" -> {pr['achieved_gflops']:.2f} GFLOP/s, "
                             f"{pr['achieved_gbps']:.2f} GB/s")
                if pr.get("utilization_pct") is not None:
                    line += f" | {pr['utilization_pct']:.1f}% of peak"
                if pr.get("bound_class") \
                        and pr["bound_class"] != "unavailable":
                    line += f" | {pr['bound_class']}"
                out += line
        if self.critical_path:
            from ydb_tpu_torch.utils.critpath import render_lines
            lines = render_lines(self.critical_path)
            if lines:
                out += "\n" + "\n".join(lines)
        return out


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1000.0

    def lap(self) -> float:
        now = time.perf_counter()
        out = (now - self.t0) * 1000.0
        self.t0 = now
        return out
