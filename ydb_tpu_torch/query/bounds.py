"""Planner-wide bounded-cardinality lattice.

Generalizes the proven-cardinality machinery that retired the group-by
gathers (`ir.GroupBy.out_bound`, planner `_groups_bound`, the executor's
join-derived bound rewrite) into a bound that rides the WHOLE plan: every
pipeline carries a row-count upper bound derived bottom-up — scans bound
by table row counts (prune-aware where portion stats eliminate portions),
filters by selectivity-1 pass-through, inner/semi joins by build-side key
multiplicity, group-bys by key-domain products / proven out_bounds,
LIMIT by its K — and consumers size data movement from the proven bound
instead of worst-case capacity (the stance of arxiv 2112.01075: size
redistribution from static bounds, not padding).

Two trust tiers, deliberately distinct:

  * ``ir.GroupBy.out_bound`` / ``carry_keys`` are CORRECTNESS-BEARING —
    an understatement silently drops/merges groups. Only runtime-verified
    sources set them (the executor rewrite over materialized builds).
  * ``Pipeline.out_bound`` / ``QueryPlan.out_bound`` (stamped here) are
    SIZING-QUALITY — consumed by admission estimates, segment sizing with
    overflow reruns, EXPLAIN, and counters. They trust declared PKs for
    join-multiplicity the same way the join planner ranks with them.

`YDB_TPU_BOUNDS=0` disables the lattice end-to-end (plan stamping, the
executor carry/bound rewrite, admission capping, segment shrinking) —
byte-equal execution at capacity sizing, and part of the plan-cache
fingerprint plus every compiled-program cache key via `groupby_tuning`.
"""

from __future__ import annotations

import os

from ydb_tpu_torch.ops import ir

_BIG = 1 << 62


def bounds_enabled() -> bool:  # lint: tuning-provider
    """`YDB_TPU_BOUNDS` lever: unset/1 = on; 0 = capacity sizing."""
    return os.environ.get("YDB_TPU_BOUNDS", "1").strip() != "0"


def groupby_bound(gb: ir.GroupBy) -> int:
    """Static group-count bound of one GroupBy: a stamped proven
    out_bound, else the mixed-radix key-domain product (0 = unbounded)."""
    if not gb.keys:
        return 1
    if gb.out_bound:
        return int(gb.out_bound)
    if gb.key_domains and all(d > 0 for d in gb.key_domains) \
            and len(gb.key_domains) == len(gb.keys):
        nb = 1
        for d in gb.key_domains:
            nb *= d + 1
            if nb > (1 << 40):
                return 0
        return nb
    return 0


def program_bound(prog, rows: int) -> int:
    """Row bound after a program: Filters/Assigns/Projections pass
    through (selectivity ≤ 1); each GroupBy caps rows at its group
    bound. `rows` 0 = unknown in, unknown out unless a GroupBy bounds."""
    out = rows
    if prog is None:
        return out
    for cmd in prog.commands:
        if isinstance(cmd, ir.GroupBy):
            gb = groupby_bound(cmd)
            if gb and out:
                out = min(out, gb)
            elif gb:
                out = gb
            # unbounded group-by: ngroups ≤ input rows — pass-through
    return out


def scan_rows_bound(catalog, scan, snapshot=None) -> int:
    """Driving-scan row bound: the table row count, tightened by a
    portion-stats prune preview when the plan carries prune predicates
    (the same `prune_by_range` elimination the executor performs at
    source enumeration — stats reads only, no block data touched)."""
    try:
        table = catalog.table(scan.table)
    except KeyError:
        return 0
    rows = int(getattr(table, "num_rows", 0))
    if not rows:
        return 0
    if not scan.prune:
        return rows
    try:
        from ydb_tpu_torch.storage.mvcc import MAX_SNAPSHOT
        from ydb_tpu_torch.storage.portion import prune_by_range
        if snapshot is None:
            snapshot = MAX_SNAPSHOT
        kept = 0
        for shard in table.shards:
            for p in shard.portions:
                if not snapshot.includes(p.version):
                    continue
                if any(prune_by_range(p, c, op, v)
                       for (c, op, v) in scan.prune):
                    continue
                kept += p.length
            for e in shard.inserts:
                kept += e.block.length
        return min(rows, kept) if kept else min(rows, 1)
    except Exception:                  # noqa: BLE001 — sizing, not law
        return rows


def _build_key_unique_declared(step, catalog) -> bool:
    """Does the build side's key provably (by DECLARED PK) hold unique
    values? True when the build is a plain pipeline whose key column is
    exactly its scan table's primary key, with no expanding steps of its
    own, or a subquery plan whose output is grouped by the key."""
    from ydb_tpu_torch.query.plan import QueryPlan
    build = step.build
    if isinstance(build, QueryPlan):
        # subquery build: grouped/distinct output keyed on the build key.
        # The build key is the plan's OUTPUT label (`__s0k0`) — resolve
        # it back to the projected internal name first, or a grouped
        # q18-class build (group l_orderkey having sum > K) reads as
        # non-unique just because of the rename.
        bk = step.build_key
        for (iname, label) in build.output:
            if label == bk:
                bk = iname
                break
        progs = [build.pipeline.partial, build.final_program]
        for prog in progs:
            if prog is None:
                continue
            for cmd in prog.commands:
                if isinstance(cmd, ir.GroupBy) and cmd.keys \
                        and len(cmd.keys) + len(cmd.carry_keys) >= 1 \
                        and bk in cmd.keys \
                        and len(cmd.keys) == 1:
                    return True
        return False
    if step.build_hash_keys:
        keys = list(step.build_hash_keys)
    elif step.build_key_cols:
        # in-program composite hash: the synthesized `__jkNb` isn't a
        # storage column, but the columns it was derived from are — a
        # 64-bit hash of a unique tuple stays unique for sizing purposes
        # (collisions are post-join-verified and overflow-rerun-guarded)
        keys = list(step.build_key_cols)
    else:
        keys = [step.build_key]
    storage = {i: s for (s, i) in build.scan.columns}
    cols = {storage.get(k) for k in keys}
    if None in cols:
        return False
    try:
        table = catalog.table(build.scan.table)
    except KeyError:
        return False
    if set(table.key_columns) != cols:
        return False
    # the build's own joins must not expand it (unique-keyed probes keep
    # row count; any inner/left join is conservatively treated as
    # potentially expanding unless ITS build is PK-unique too)
    for kind, s2 in build.steps:
        if kind == "join" and s2.kind in ("inner", "left") \
                and not _build_key_unique_declared(s2, catalog):
            return False
    return True


def pipeline_bound(pipe, catalog, snapshot=None, _memo=None) -> int:
    """Bottom-up row bound of one pipeline (0 = unknown). `_memo`
    (id(node) → bound) dedups the walk within one derivation — nested
    builds would otherwise re-run the portion-stats scan preview once
    per enclosing level (2^depth walks on the q8 join-chain class)."""
    if _memo is not None and id(pipe) in _memo:
        return _memo[id(pipe)]
    rows = scan_rows_bound(catalog, pipe.scan, snapshot)
    bound = rows
    for kind, step in pipe.steps:
        if kind != "join":
            bound = program_bound(step, bound)
            continue
        if step.kind in ("left_semi", "left_anti", "mark"):
            continue                   # never expands the probe stream
        if _build_key_unique_declared(step, catalog):
            continue                   # unique build: row-preserving
        b = step.build
        from ydb_tpu_torch.query.plan import QueryPlan
        bb = plan_bound(b, catalog, snapshot, _memo) \
            if isinstance(b, QueryPlan) \
            else pipeline_bound(b, catalog, snapshot, _memo)
        if bound and bb:
            bound = min(bound * bb, _BIG)
        else:
            bound = 0                  # unknown multiplicity
    bound = program_bound(pipe.partial, bound)
    if _memo is not None:
        _memo[id(pipe)] = bound
    return bound


def plan_bound(plan, catalog, snapshot=None, _memo=None) -> int:
    """Row bound of a whole plan's result (0 = unknown)."""
    key = ("plan", id(plan))
    if _memo is not None and key in _memo:
        return _memo[key]
    bound = pipeline_bound(plan.pipeline, catalog, snapshot, _memo)
    bound = program_bound(plan.final_program, bound)
    if plan.limit is not None:
        k = int(plan.limit) + int(plan.offset or 0)
        bound = min(bound, k) if bound else k
    if _memo is not None:
        _memo[key] = bound
    return bound


def annotate_plan(plan, catalog, snapshot=None):
    """Stamp the lattice onto a freshly planned SELECT: every pipeline's
    `out_bound` (driving + build fragments, recursively) and the plan's
    result bound. No-op with the lever off. Mutates the plan in place
    (plans are per-query objects at this point; the plan cache stores
    the annotated plan, and the fingerprint carries the lever)."""
    if not bounds_enabled():
        return plan
    from ydb_tpu_torch.query.plan import QueryPlan
    from ydb_tpu_torch.utils.metrics import GLOBAL
    memo: dict = {}                    # one stats walk per node

    def walk_pipe(pipe):
        for kind, step in pipe.steps:
            if kind != "join":
                continue
            if isinstance(step.build, QueryPlan):
                walk_plan(step.build)
            else:
                walk_pipe(step.build)
                step.build.out_bound = pipeline_bound(
                    step.build, catalog, snapshot, memo)
        pipe.out_bound = pipeline_bound(pipe, catalog, snapshot, memo)

    def walk_plan(p):
        walk_pipe(p.pipeline)
        for (_n, sub) in p.init_subplans:
            walk_plan(sub)
        p.out_bound = plan_bound(p, catalog, snapshot, memo)

    walk_plan(plan)
    # lint: allow-counters(bounds/* registered)
    GLOBAL.inc("bounds/plans")
    if plan.out_bound:
        GLOBAL.inc("bounds/finite_plans")
    return plan


def dataset_distinct(block, cols: list) -> int:
    """Distinct (validity-aware) tuple count of `cols` over a HostBlock —
    the measured side of the carry rewrite's functional-dependency
    verification. Counts under THE grouping equality itself
    (`ops/numpy_exec.canonical_key_pair`, shared with the group-by
    oracle): NULLs form one value per column, -0.0 == 0.0, all NaNs
    equal."""
    import numpy as np

    from ydb_tpu_torch.ops.numpy_exec import canonical_key_pair
    if block.length == 0:
        return 0
    mats = []
    for name in cols:
        cd = block.columns[name]
        phys, valid = canonical_key_pair(cd.data, cd.valid)
        mats.append(phys)
        mats.append(valid)
    mat = np.stack(mats, axis=1)
    return int(len(np.unique(mat, axis=0)))


def build_bytes_bound(catalog, step, snapshot=None, _memo=None) -> int:
    """Admission-sizing bound for one join build's MATERIALIZED bytes:
    the build executes and lands host-side at its OUTPUT cardinality, so
    a bounded build (grouped subquery, LIMIT, bounded multiplicity
    chain) reserves bound × row-width instead of its driving scan's full
    table footprint (the q21 build double-charge class)."""
    import numpy as np
    from ydb_tpu_torch.query.plan import QueryPlan
    build = step.build
    bp = getattr(build, "pipeline", build)
    if not hasattr(bp, "scan"):
        return 0
    bound = plan_bound(build, catalog, snapshot, _memo) \
        if isinstance(build, QueryPlan) \
        else pipeline_bound(build, catalog, snapshot, _memo)
    if not bound:
        return 0
    try:
        table = catalog.table(bp.scan.table)
    except KeyError:
        return 0
    per_row = 0
    for (s, _i) in bp.scan.columns:
        if table.schema.has(s):
            dt = table.schema.dtype(s)
            per_row += np.dtype(dt.np).itemsize + (1 if dt.nullable else 0)
    return bound * max(per_row, 1)
