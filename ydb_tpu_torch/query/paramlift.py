"""Parameter lifting: literals out of compiled programs.

N concurrent point-lookup clients whose SQL differs only in literals used
to compile N distinct device programs: every `ir.Const` value sits in the
program's structural fingerprint, so `where k = 5` and `where k = 7` were
different `fused_cache_key`s, different XLA compiles, and N entries of
exec-cache pressure (the executable-accumulation class behind the r5
full-suite SIGSEGV). The reference separates query TEXT from parameter
VALUES at the compile-service boundary (`kqp_compile_service.cpp` keys
its cache on text + schema version, with TParams bound at run time);
this pass recovers that split for plans whose SQL carries inline
literals — the wire shape of virtually every real client.

`lift_plan` runs at the tail of `Planner.plan_select`: every liftable
scalar `ir.Const` in the plan's programs (pushdown filters, join-build
fragments, partial/merge aggregation, HAVING, output expressions)
becomes a canonically named `ir.Param` (`__lit0`, `__lit1`, … in walk
order) whose value lands in `plan.params`. Programs then fingerprint on
*shape*: literal variants of one statement share one compiled program
(fused, tiled, finalize, and per-stage ProgramCache alike), and the
literal arrives as a device input at dispatch time — the inference
stance of arxiv 2603.09555 (pay compilation once, every subsequent step
constant-cost) applied to SQL.

Planning itself still sees concrete values: scan pruning
(`ScanSpec.prune`), CBO selectivity, and dictionary-code folding all run
BEFORE the lift, so plan *quality* is unchanged — only the compiled
artifact is value-free. LIMIT/OFFSET lift separately in the executor
(`__lim2` device input, program keyed on the limit's capacity bucket —
`ops/fused.py`).

Not lifted: `None` (NULL folds structurally at bind time), python
strings (dictionary codes are already ints by the time they reach IR; a
str-valued Const is host-only), array constants, and kernel `extra`
statics (they steer codegen shapes).

The lift also stamps the plan with the batch lane's grouping identity:
`lift_names` (the lifted slots) and `lift_sig` (the prune-stripped plan
shape the batched dispatch lane groups same-shape arrivals by —
`query/batch_lane.py`; build-affecting param VALUES are rederived per
member by `build_lift_values`, builds execute once per batch).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ydb_tpu_torch.ops import ir
from ydb_tpu_torch.query.plan import Pipeline, QueryPlan

LIFT_PREFIX = "__lit"
# the lifted LIMIT+OFFSET device input is named by `ops/fused.LIMIT_PARAM`
# ("__lim2") — the executor attaches it at dispatch time, not this pass


def lift_enabled() -> bool:
    """`YDB_TPU_PARAM_LIFT=0` restores literal-embedding plans (A/B
    lever; the batch lane requires lifting and disables with it)."""
    return os.environ.get("YDB_TPU_PARAM_LIFT", "1") not in ("0", "false")


def _liftable(c: ir.Const) -> bool:
    v = c.value
    if v is None or isinstance(v, str):
        return False
    if not isinstance(v, (bool, int, float, np.integer, np.floating,
                          np.bool_)):
        return False
    try:
        np.dtype(c.dtype.np)
    except TypeError:
        return False
    return True


class _Lifter:
    """One walk-ordered `__litN` namespace across the whole plan tree
    (nested build plans included), so merged param dicts never collide
    and literal variants of one statement name their slots identically."""

    def __init__(self):
        self.n = 0

    def _param(self, c: ir.Const, sink: dict) -> ir.Param:
        name = f"{LIFT_PREFIX}{self.n}"
        self.n += 1
        sink[name] = np.dtype(c.dtype.np).type(c.value)
        return ir.Param(name, c.dtype)

    def expr(self, e, sink: dict):
        if isinstance(e, ir.Const) and _liftable(e):
            return self._param(e, sink)
        if isinstance(e, ir.Call):
            return ir.Call(e.op,
                           tuple(self.expr(a, sink) for a in e.args),
                           e.extra)
        return e

    def program(self, p, sink: dict):
        if p is None:
            return None
        cmds = []
        for cmd in p.commands:
            if isinstance(cmd, ir.Assign):
                cmds.append(ir.Assign(cmd.name, self.expr(cmd.expr, sink)))
            elif isinstance(cmd, ir.Filter):
                cmds.append(ir.Filter(self.expr(cmd.pred, sink)))
            else:
                cmds.append(cmd)      # GroupBy / Projection carry no exprs
        return ir.Program(cmds)

    def pipeline(self, pipe: Pipeline, sink: dict) -> Pipeline:
        steps = []
        for kind, step in pipe.steps:
            if kind == "join":
                b = step.build
                if isinstance(b, QueryPlan):
                    # a QueryPlan build executes with its OWN params
                    # (`executor._prepare_join_uncached` → execute()):
                    # its lifted values live in ITS dict
                    b2 = self.queryplan(b)
                else:
                    b2 = self.pipeline(b, sink)
                steps.append((kind, dataclasses.replace(step, build=b2)))
            else:
                steps.append((kind, self.program(step, sink)))
        return dataclasses.replace(
            pipe,
            pre_program=self.program(pipe.pre_program, sink),
            steps=steps,
            partial=self.program(pipe.partial, sink))

    def queryplan(self, plan: QueryPlan, top: bool = False) -> QueryPlan:
        sink: dict = {}
        pipe2 = self.pipeline(plan.pipeline, sink)
        final2 = self.program(plan.final_program, sink)
        init2 = [(pname, self.queryplan(sub))
                 for (pname, sub) in plan.init_subplans]
        plan2 = dataclasses.replace(
            plan, pipeline=pipe2, final_program=final2,
            init_subplans=init2,
            params={**plan.params, **sink},
            lift_names=tuple(sink))
        if top:
            plan2 = dataclasses.replace(plan2,
                                        lift_sig=plan_shape_sig(plan2))
        return plan2


def lift_plan(plan: QueryPlan) -> QueryPlan:
    """Lift every literal in a freshly planned SELECT (no-op when
    disabled). Idempotent by construction: lifted plans contain no
    liftable Consts."""
    if not lift_enabled():
        return plan
    from ydb_tpu_torch.utils.metrics import GLOBAL
    plan2 = _Lifter().queryplan(plan, top=True)
    if plan2.lift_names or any(
            getattr(sub, "lift_names", ())
            for (_p, sub) in plan2.init_subplans):
        GLOBAL.inc("batch/lift_hits")
    else:
        GLOBAL.inc("batch/lift_misses")
    return plan2


# -- plan shape identity (batch-lane grouping) ------------------------------


def plan_shape_sig(plan: QueryPlan) -> tuple:
    """Hashable identity of the plan's compiled SHAPE, literal-values
    excluded and scan pruning excluded (the batched lane executes the
    un-pruned superblock — pruning is a skip optimization whose outcome
    is literal-dependent, so it cannot partition a shared execution).
    Two statements with equal sigs lower to the same fused program
    modulo runtime inputs; the lane still keys separately on the visible
    DATA (src ids) and on build-affecting literal values."""
    from ydb_tpu_torch.ops.device import bucket_capacity

    def prog_fp(p):
        return p.fingerprint() if p is not None else ""

    def pipe_sig(pipe: Pipeline) -> tuple:
        parts = [("scan", pipe.scan.table, tuple(pipe.scan.columns)),
                 ("pre", prog_fp(pipe.pre_program))]
        for kind, step in pipe.steps:
            if kind == "join":
                b = step.build
                bsig = ("plan", plan_shape_sig(b)) \
                    if isinstance(b, QueryPlan) else ("pipe", pipe_sig(b))
                parts.append(("join", step.probe_key, step.build_key,
                              step.kind, tuple(step.payload), step.mark_col,
                              step.not_in, tuple(step.build_hash_keys),
                              bsig))
            else:
                parts.append(("prog", prog_fp(step)))
        parts.append(("partial", prog_fp(pipe.partial)))
        return tuple(parts)

    lim2 = None if plan.limit is None else plan.limit + (plan.offset or 0)
    return ("shape-v1", pipe_sig(plan.pipeline),
            prog_fp(plan.final_program),
            tuple((sk.name, sk.ascending, sk.nulls_first)
                  for sk in plan.sort),
            plan.limit is None,
            None if lim2 is None else bucket_capacity(lim2, minimum=128),
            tuple(n for (n, _lbl) in plan.output),
            tuple(sorted(plan.params)),
            tuple(p for (p, _s) in plan.init_subplans))


def build_lift_values(plan: QueryPlan) -> tuple:
    """Every runtime param value a join-build fragment references —
    lifted literals AND pool params (IN-list LUT arrays, string-function
    LUTs: their VALUES are literal-derived too) — as a hashable
    (name, value-hash) tuple, the batch-lane group-key component. Build
    sides execute ONCE per batch with the leader's values, so members
    whose build-affecting values differ in ANY param must land in
    different groups."""
    from ydb_tpu_torch.ops.ir import program_params
    from ydb_tpu_torch.query.build_cache import _hash_param_value

    out: list = []

    def build_progs(pipe: Pipeline, progs: list) -> None:
        if pipe.pre_program is not None:
            progs.append(pipe.pre_program)
        for kind, step in pipe.steps:
            if kind == "join":
                b = step.build
                if isinstance(b, QueryPlan):
                    collect_plan(b, owner=b)
                else:
                    build_progs(b, progs)
            else:
                progs.append(step)
        if pipe.partial is not None:
            progs.append(pipe.partial)

    def collect(progs: list, owner: QueryPlan) -> None:
        for p in progs:
            for prm in program_params(p):
                v = owner.params.get(prm.name)
                if v is not None:
                    out.append((prm.name, _hash_param_value(v)))

    def collect_plan(p: QueryPlan, owner: QueryPlan) -> None:
        """A whole nested build plan is build-affecting: every param any
        of its programs reference pins the group."""
        progs: list = []
        build_progs(p.pipeline, progs)
        if p.final_program is not None:
            progs.append(p.final_program)
        collect(progs, owner)

    for kind, step in plan.pipeline.steps:
        if kind != "join":
            continue
        b = step.build
        if isinstance(b, QueryPlan):
            collect_plan(b, owner=b)
        else:
            progs: list = []
            build_progs(b, progs)
            collect(progs, plan)

    return tuple(sorted(set(out)))
