"""Physical query plans.

The analog of the reference's `TKqpPhyQuery` protobuf (`kqp_physical.proto`)
+ DQ task-graph stages (`dq/tasks/dq_tasks_graph.h`): a query is a tree of
streaming *pipelines*, each anchored on a table scan (its SSA pre-program
pushed down into the scan, `TKqpPhyOpReadOlapRanges` style), followed by
broadcast-join probe steps and an optional partial aggregation, and a final
stage that merges partials, applies HAVING, computes output expressions,
sorts and limits.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ydb_tpu_torch.ops import ir


@dataclass
class ScanSpec:
    table: str
    columns: list                    # [(storage_name, internal_name)]
    prune: list = field(default_factory=list)   # [(storage_col, op, value)]
    # CBO estimate: post-local-predicate cardinality (query/stats.py);
    # -1 = not estimated
    est_rows: float = -1.0


@dataclass
class JoinStep:
    build: object                    # Pipeline | QueryPlan (subquery build)
    build_key: str                   # internal name in build output
    probe_key: str                   # internal name in probe pipeline
    kind: str                        # inner | left | left_semi | left_anti | mark
    payload: list = field(default_factory=list)  # build columns to attach
    mark_col: str = ""               # for kind=mark: bool match-flag column
    anti_null_check: bool = False    # NOT IN: reject NULLs in the build key
    anti_null_col: str = ""          # column to null-check (default build_key)
    # NOT IN semantics: a NULL probe key is excluded unless the build set is
    # empty (x NOT IN S is NULL when x is NULL and S != {}, TRUE when S = {})
    not_in: bool = False
    # composite keys: executor hashes these build columns host-side into
    # `build_key` before building (probe side hashes in its program)
    build_hash_keys: list = field(default_factory=list)
    # sizing metadata ONLY (bounds lattice / compact sizing): the
    # storage-backed build columns a synthesized `build_key` was derived
    # from, for in-program composite hashes where `build_hash_keys` must
    # stay empty (the hash is computed inside the build's partial, not
    # host-side). Lets PK-uniqueness survive the key synthesis — without
    # it a composite-PK probe (q9 lineitem x partsupp on the partkey/
    # suppkey pair) degrades the pipeline bound to a row product.
    build_key_cols: list = field(default_factory=list)


@dataclass
class Pipeline:
    """One streaming stage: scan → program → (join → program)* → partial."""
    scan: ScanSpec
    pre_program: Optional[ir.Program] = None      # pushdown filters/assigns
    steps: list = field(default_factory=list)     # [("join", JoinStep) | ("program", ir.Program)]
    partial: Optional[ir.Program] = None          # ends in partial GroupBy / projection
    out_names: list = field(default_factory=list)  # pipeline output columns
    # bounds lattice (query/bounds.py): proven-at-plan-time row upper
    # bound of this pipeline's output; 0 = unknown (capacity sizing).
    # Sizing-quality (admission, segment sizing, EXPLAIN) — the
    # correctness-bearing bounds live on ir.GroupBy.
    out_bound: int = 0
    # late materialization (query/latemat.py): columns the fused path
    # carries as row-ids — scan deferrals by name, join payloads as
    # "name(row-id)". Observability metadata (EXPLAIN `-- latemat:`);
    # the executor recomputes the sets against the actual fused shape.
    late_names: tuple = ()


@dataclass
class SortKey:
    name: str
    ascending: bool = True
    nulls_first: bool = False


@dataclass
class QueryPlan:
    pipeline: Pipeline
    final_program: Optional[ir.Program] = None    # merge agg + having + exprs
    sort: list = field(default_factory=list)      # [SortKey]
    limit: Optional[int] = None
    offset: Optional[int] = None
    output: list = field(default_factory=list)    # [(internal_name, label)]
    params: dict = field(default_factory=dict)    # param name -> value
    # uncorrelated scalar subqueries: executed first, their single value
    # becomes a runtime param (the KQP precompute-stage analog,
    # `KqpPhysicalTx` TxResultBinding)
    init_subplans: list = field(default_factory=list)  # [(param, QueryPlan)]
    # dictionaries for derived string columns (substring/concat results):
    # internal column name -> Dictionary
    result_dicts: dict = field(default_factory=dict)
    # schema-declaration order of every FROM relation's columns
    # ("alias.col" internal names) — SELECT * output order
    star_order: list = field(default_factory=list)
    # parameter lifting (query/paramlift.py): canonical `__litN` params
    # whose values were extracted from this plan's literals — programs
    # fingerprint on SHAPE, one compiled executable serves every literal
    # variant. `lift_sig`: prune-stripped shape identity the batched
    # dispatch lane groups same-shape arrivals by (build-affecting param
    # VALUES are rederived from the programs per member —
    # `paramlift.build_lift_values`); None = not lifted (lane
    # ineligible).
    lift_names: tuple = ()
    lift_sig: Optional[tuple] = None
    # bounds lattice (query/bounds.py): proven row upper bound of the
    # final result (post sort/limit); 0 = unknown
    out_bound: int = 0


def explain(plan: QueryPlan, indent: int = 0) -> str:
    """Human-readable plan (the `kqp_query_plan.cpp` analog)."""
    pad = "  " * indent
    lines = []

    def pipe(p: Pipeline, d: int):
        pp = "  " * d
        lines.append(f"{pp}Scan {p.scan.table} cols={[c[1] for c in p.scan.columns]}"
                     + (f" est_rows={p.scan.est_rows:g}"
                        if p.scan.est_rows >= 0 else "")
                     + (f" prune={p.scan.prune}" if p.scan.prune else ""))
        if p.out_bound:
            lines.append(f"{pp}  -- bounds: pipeline ≤ {p.out_bound} rows"
                         + _gb_bounds(p.partial))
        if p.late_names:
            lines.append(f"{pp}  -- latemat: {len(p.late_names)} deferred "
                         f"[{', '.join(p.late_names)}]")
        if p.pre_program:
            lines.append(f"{pp}  pre: {_prog(p.pre_program)}")
        for kind, step in p.steps:
            if kind == "join":
                lines.append(f"{pp}  {step.kind.upper()} JOIN probe={step.probe_key} "
                             f"build={step.build_key} payload={step.payload}")
                if isinstance(step.build, QueryPlan):
                    lines.append(f"{pp}    subplan:")
                    lines.append(explain(step.build, d + 3))
                else:
                    pipe(step.build, d + 2)
            else:
                lines.append(f"{pp}  program: {_prog(step)}")
        if p.partial:
            lines.append(f"{pp}  partial: {_prog(p.partial)}")

    pipe(plan.pipeline, indent)
    if plan.final_program:
        lines.append(f"{pad}final: {_prog(plan.final_program)}")
    if plan.out_bound:
        lines.append(f"{pad}-- bounds: result ≤ {plan.out_bound} rows")
    if plan.sort:
        lines.append(f"{pad}sort: {[(s.name, 'asc' if s.ascending else 'desc') for s in plan.sort]}")
    if plan.limit is not None:
        lines.append(f"{pad}limit: {plan.limit}")
    lines.append(f"{pad}output: {[lbl for _, lbl in plan.output]}")
    return "\n".join(lines)


def _gb_bounds(prog) -> str:
    """Group-by bound annotation for the `-- bounds:` line: each stage's
    proven bound next to what capacity sizing would have allocated."""
    if prog is None:
        return ""
    parts = []
    for cmd in prog.commands:
        if isinstance(cmd, ir.GroupBy) and cmd.out_bound:
            s = f"groupby ≤ {cmd.out_bound} groups"
            if cmd.carry_keys:
                s += f" ({len(cmd.carry_keys)} carried)"
            parts.append(s)
    return (" | " + ", ".join(parts)) if parts else ""


def _prog(p: ir.Program) -> str:
    parts = []
    for cmd in p.commands:
        if isinstance(cmd, ir.Assign):
            parts.append(f"assign {cmd.name}")
        elif isinstance(cmd, ir.Filter):
            parts.append("filter")
        elif isinstance(cmd, ir.GroupBy):
            parts.append(f"groupby[{','.join(cmd.keys)}]"
                         f"({','.join(a.func for a in cmd.aggs)})")
        elif isinstance(cmd, ir.Projection):
            parts.append(f"project[{len(cmd.names)}]")
    return " → ".join(parts)
