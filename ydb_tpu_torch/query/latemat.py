"""Late-materialization planning: which columns can ride as row-ids.

The fused path hauls every payload byte through the middle of a plan —
probe gathers at scan capacity, compress/sort over full payload widths
(PERF round-16: "the gathered payload WIDTH is the remaining tax").
This pass marks, statically per pipeline, the columns whose VALUES are
not needed until late:

  * scan columns never referenced by the pre-program's compute or any
    join's probe key — a single int32 row-position column stands in for
    all of them (`ops/fused.LM_POS`);
  * inner/left join payload columns — the probe threads a
    (build row-id, match) pair per side instead of gathering widths
    (`ops/join.probe_lut_traced` late mode).

Deferred columns materialize at their first compute reference (group-by
keys/agg args, filters, sort keys) — which, once the executor's
`ir.Compact` has shrunk the pipeline to its ladder-quantized bound, runs
at the bound instead of scan capacity — or at the post-LIMIT tail, where
a LIMIT-K plan gathers K-bucket rows. The analysis here is purely
structural (the same walk the trace performs), so EXPLAIN's
`-- latemat:` lines and the executed deferral agree by construction.

Lever: `YDB_TPU_LATE_MAT` (`ops/xla_exec.late_mat_enabled`, a
tuning-provider riding every fused cache key via `groupby_tuning`).
"""

from __future__ import annotations

from ydb_tpu_torch.ops import ir
from ydb_tpu_torch.ops.fused import _prog_refs


def deferrable_scan(pipe, scan_names) -> frozenset:
    """Scan columns (internal names) the fused body may defer: not part
    of the pre-program's compute set, not any join step's probe key, and
    only when the pre-program cannot drop the row-position helper (a
    GroupBy or Projection in the PRE-program would — those plans keep
    eager scan loads)."""
    if pipe.pre_program is not None and any(
            isinstance(c, (ir.GroupBy, ir.Projection))
            for c in pipe.pre_program.commands):
        return frozenset()
    refs = set()
    if pipe.pre_program is not None:
        refs |= _prog_refs(pipe.pre_program)
        # projected names in the PRE-program would be dropped from env
        # before the scan helper exists; excluded above
    for kind, step in pipe.steps:
        if kind == "join":
            refs.add(step.probe_key)
    return frozenset(n for n in scan_names if n not in refs)


def deferrable_joins(pipe) -> list:
    """Per join step (in order), True when its payload gathers defer:
    inner/left joins with payload columns (semi/anti carry none; mark
    keeps the eager gather — its mark column is the probe's product)."""
    out = []
    for kind, step in pipe.steps:
        if kind != "join":
            continue
        out.append(step.kind in ("inner", "left") and bool(step.payload))
    return out


def annotate_plan(plan) -> None:
    """Stamp the pipeline with its late-materialization sets (sizing/
    observability metadata — EXPLAIN's `-- latemat:` lines; the executor
    recomputes the same sets against the actual fused shape). Mirrors
    `bounds.annotate_plan`'s role for the bounds lattice."""
    from ydb_tpu_torch.ops.torch_exec import late_mat_enabled
    pipe = plan.pipeline
    if not late_mat_enabled():
        pipe.late_names = ()
        return
    scan_names = [i for (_s, i) in pipe.scan.columns]
    late = sorted(deferrable_scan(pipe, scan_names))
    for (kind, step), d in zip(
            [(k, s) for (k, s) in pipe.steps if k == "join"],
            deferrable_joins(pipe)):
        if d:
            late += [f"{n}(row-id)" for n in step.payload]
    pipe.late_names = tuple(late)
