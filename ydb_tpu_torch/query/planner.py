"""AST → physical plan.

Combines the reference's logical/physical optimization + stage building:
  * predicate classification & pushdown into scans — the
    `KqpPushOlapFilter` rule (`kqp_opt_phy_olap_filter.cpp:527`);
  * join-tree construction from equi-edges with the largest table as the
    streaming fact side and broadcast build fragments — the MapJoin
    strategy of `dq_opt_join.cpp` (CBO/DPhyp ordering comes later);
  * two-phase aggregation: per-block partial GroupBy on device, final
    merge GroupBy — the BlockCombineHashed → BlockMergeFinalizeHashed
    split (`mkql_block_agg.cpp`);
  * HAVING/output/ORDER BY expression binding over the aggregated schema.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ydb_tpu_torch.core import dtypes as dt
from ydb_tpu_torch.ops import ir
from ydb_tpu_torch.query import binder as B
from ydb_tpu_torch.query.plan import JoinStep, Pipeline, QueryPlan, ScanSpec, SortKey
from ydb_tpu_torch.sql import ast


class PlanError(Exception):
    pass


def conjuncts(e: Optional[ast.Expr]) -> list:
    if e is None:
        return []
    if isinstance(e, ast.BinOp) and e.op == "and":
        return conjuncts(e.left) + conjuncts(e.right)
    return [e]


def disjuncts(e: ast.Expr) -> list:
    if isinstance(e, ast.BinOp) and e.op == "or":
        return disjuncts(e.left) + disjuncts(e.right)
    return [e]


def _and_fold(parts: list) -> Optional[ast.Expr]:
    out = None
    for p in parts:
        out = p if out is None else ast.BinOp("and", out, p)
    return out


def _or_fold(parts: list) -> Optional[ast.Expr]:
    out = None
    for p in parts:
        out = p if out is None else ast.BinOp("or", out, p)
    return out


def hoist_or_common(pred: ast.Expr) -> list:
    """(a AND x) OR (a AND y) → a AND (x OR y): lift conjuncts shared by
    every OR branch to the top (TPC-H Q19's join condition shape) — the
    role of the reference's common-opt OR factoring."""
    out: list = []
    for p in conjuncts(pred):
        if not (isinstance(p, ast.BinOp) and p.op == "or"):
            out.append(p)
            continue
        branches = [conjuncts(b) for b in disjuncts(p)]
        common = [c for c in branches[0]
                  if all(c in b for b in branches[1:])]
        if not common:
            out.append(p)
            continue
        out.extend(common)
        rests = []
        degenerate = False
        for b in branches:
            rest = [c for c in b if c not in common]
            if not rest:
                degenerate = True   # one branch had only common conjuncts
                break
            rests.append(_and_fold(rest))
        if not degenerate:
            out.append(_or_fold(rests))
    return out


def walk_names(e, out: set):
    """Collect ast.Name nodes (skipping into subqueries)."""
    if isinstance(e, ast.Name):
        out.add(e.parts)
    elif isinstance(e, ast.BinOp):
        walk_names(e.left, out)
        walk_names(e.right, out)
    elif isinstance(e, ast.UnaryOp):
        walk_names(e.arg, out)
    elif isinstance(e, ast.FuncCall):
        for a in e.args:
            walk_names(a, out)
    elif isinstance(e, ast.Case):
        if e.operand is not None:
            walk_names(e.operand, out)
        for c, r in e.whens:
            walk_names(c, out)
            walk_names(r, out)
        if e.default is not None:
            walk_names(e.default, out)
    elif isinstance(e, (ast.Cast,)):
        walk_names(e.arg, out)
    elif isinstance(e, ast.Between):
        walk_names(e.arg, out)
        walk_names(e.lo, out)
        walk_names(e.hi, out)
    elif isinstance(e, (ast.InList,)):
        walk_names(e.arg, out)
        for i in e.items:
            walk_names(i, out)
    elif isinstance(e, (ast.Like, ast.IsNull)):
        walk_names(e.arg, out)


def walk_aggs(e, out: list):
    """Collect aggregate FuncCalls (no nesting into their args)."""
    if isinstance(e, ast.FuncCall):
        if e.name in B.AGG_NAMES:
            out.append(e)
            return
        for a in e.args:
            walk_aggs(a, out)
    elif isinstance(e, ast.BinOp):
        walk_aggs(e.left, out)
        walk_aggs(e.right, out)
    elif isinstance(e, ast.UnaryOp):
        walk_aggs(e.arg, out)
    elif isinstance(e, ast.Case):
        if e.operand is not None:
            walk_aggs(e.operand, out)
        for c, r in e.whens:
            walk_aggs(c, out)
            walk_aggs(r, out)
        if e.default is not None:
            walk_aggs(e.default, out)
    elif isinstance(e, ast.Cast):
        walk_aggs(e.arg, out)
    elif isinstance(e, ast.Between):
        walk_aggs(e.arg, out)
        walk_aggs(e.lo, out)
        walk_aggs(e.hi, out)


def _hash_key_expr(cols: list) -> ir.Expr:
    """Combined 64-bit hash over key columns (both join sides use this same
    expression, mirroring `ydb/core/formats/arrow/hash/calcer.cpp`)."""
    return _hash_key_expr_of([ir.Col(c) for c in cols])


def _hash_key_expr_of(exprs: list) -> ir.Expr:
    parts = [ir.call("hash64", e) for e in exprs]
    if len(parts) == 1:
        return parts[0]
    return ir.call("hash_combine", *parts)


@dataclass
class _Rel:
    alias: str
    table: object                 # ColumnTable
    local_preds: list = field(default_factory=list)


class Planner:
    def __init__(self, catalog):
        import threading
        self.catalog = catalog
        # planning keeps per-query working state on the instance (scope,
        # sub-spec lists, eff map); concurrent lock-free SELECTs must not
        # interleave plans. RLock: correlated subqueries re-enter via
        # _plan_inner. Planning is microseconds; execution runs outside.
        self._mu = threading.RLock()

    # -- entry -------------------------------------------------------------

    def plan_select(self, sel: ast.Select) -> QueryPlan:
        # literal lifting runs AFTER planning (paramlift.py): pruning,
        # selectivity, and dictionary folding all saw concrete values;
        # only the compiled artifact becomes value-free
        from ydb_tpu_torch.query.bounds import annotate_plan
        from ydb_tpu_torch.query.paramlift import lift_plan
        with self._mu:
            plan = lift_plan(self._plan_select_locked(sel))
            try:
                # bounds lattice (query/bounds.py): stamp every
                # pipeline's proven row bound — sizing only, must never
                # fail a query
                annotate_plan(plan, self.catalog)
            except Exception:          # noqa: BLE001 — sizing, not law
                pass
            try:
                # late-materialization sets (query/latemat.py): which
                # columns the fused path carries as row-ids — EXPLAIN
                # metadata; the executor recomputes against the actual
                # fused shape, so this too must never fail a query
                from ydb_tpu_torch.query.latemat import annotate_plan as _lm
                _lm(plan)
            except Exception:          # noqa: BLE001 — sizing, not law
                pass
            return plan

    def plan_dq(self, sel: ast.Select, topology):
        """Lower a SELECT to a DQ stage graph (`ydb_tpu/dq/graph.py`) —
        the distributed counterpart of `plan_select`: stages own the
        programs (rendered stage SQL each worker engine compiles through
        plan_select locally), edges are UnionAll / HashShuffle /
        Broadcast / Merge channels. Column references resolve from THIS
        catalog's schemas; the cross-process router passes an RPC schema
        probe instead (`cluster/router.py`). `topology`: a
        `dq.lower.DqTopology`."""
        from ydb_tpu_torch.dq.lower import lower_select

        def table_cols(table: str) -> list:
            return list(self.catalog.table(table).schema.names)
        return lower_select(sel, topology, table_cols)

    def _plan_select_locked(self, sel: ast.Select) -> QueryPlan:
        if sel.relation is None:
            raise PlanError("SELECT without FROM is not supported yet")
        pool = B.ParamPool()
        self._jk_counter = 0

        rels, join_conds, left_joins = self._flatten_relations(sel.relation)
        scope = B.Scope()
        for r in rels.values():
            for col in r.table.schema:
                internal = f"{r.alias}.{col.name}"
                scope.add(r.alias, col.name, B.ColumnBinding(
                    internal, col.dtype,
                    r.table.dictionaries.get(col.name)))
        # left-joined relations: columns visible (nullable — the join may
        # null-extend), but OUTSIDE the inner-join spanning tree
        self._left_specs = []
        self._left_post_preds: list = []
        for (tref, on) in left_joins:
            alias = tref.alias or tref.name
            if alias in rels or any(s["alias"] == alias
                                    for s in self._left_specs):
                raise PlanError(f"duplicate alias {alias}")
            try:
                table = self.catalog.table(tref.name)
            except KeyError as e:
                raise PlanError(str(e.args[0])) from e
            for col in table.schema:
                scope.add(alias, col.name, B.ColumnBinding(
                    f"{alias}.{col.name}", col.dtype.with_nullable(True),
                    table.dictionaries.get(col.name)))
            self._left_specs.append({"alias": alias, "table": table,
                                     "tref": tref, "on": on})
        self.scope = scope
        self.pool = pool
        binder = B.ExprBinder(scope, pool,
                              udfs=getattr(self.catalog, "udfs", None))
        left_aliases = {s["alias"] for s in self._left_specs}

        # classify each left join's ON conjuncts: equi pair vs build-local
        for spec in self._left_specs:
            alias = spec["alias"]
            pairs, local = [], []
            if spec["on"] is None:
                raise PlanError("LEFT JOIN requires an ON clause")
            for c in conjuncts(spec["on"]):
                aliases = self._pred_aliases(c, rels, scope)
                if aliases <= {alias}:
                    local.append(c)
                    continue
                ok = (isinstance(c, ast.BinOp) and c.op == "="
                      and isinstance(c.left, ast.Name)
                      and isinstance(c.right, ast.Name))
                if ok:
                    la = self._name_alias(c.left, rels, scope)
                    ra = self._name_alias(c.right, rels, scope)
                    if la == alias and ra not in left_aliases:
                        pairs.append((c.right, c.left))
                        continue
                    if ra == alias and la not in left_aliases:
                        pairs.append((c.left, c.right))
                        continue
                raise PlanError(f"unsupported LEFT JOIN condition {c!r}")
            if not pairs:
                raise PlanError("LEFT JOIN needs at least one equi-join "
                                "condition")
            spec["pairs"], spec["local"] = pairs, local

        # eager aggregation: a LEFT JOIN consumed only through aggregates
        # pre-aggregates its build by the join key — the expanding
        # duplicate-key probe (portioned-path cliff) stops existing
        sel = self._eager_agg_rewrite(sel, rels, scope)

        # classify predicates ((a∧x)∨(a∧y) → a∧(x∨y) first: surfaces
        # join conditions buried in OR branches, e.g. TPC-H Q19)
        preds = []
        for p in conjuncts(sel.where) + join_conds:
            preds.extend(hoist_or_common(p))

        # subquery extraction: IN/EXISTS → semi/anti join specs; scalar
        # subqueries → precompute params (uncorrelated) or decorrelated
        # aggregate joins (the KqpRewrite*-style flattening the reference
        # does in logical opt, `dq_opt_join.cpp` / kqp_opt_log)
        self._sub_specs: list = []
        self._init_subplans: list = []
        self._post_preds: list = []
        kept = []
        for p in preds:
            q = self._extract_subqueries(p, rels)
            if q is not None:
                kept.append(q)
        preds = kept
        if sel.having is not None or any(
                not isinstance(it.expr, ast.Star) and
                self._has_scalar_sub(it.expr) for it in sel.items):
            sel = ast.Select(**{**sel.__dict__})
            if sel.having is not None:
                sel.having = self._rewrite_scalar_subqueries(
                    sel.having, rels, allow_correlated=False)
            # scalar subqueries in the SELECT list precompute to params
            # (the KqpPhysicalTx TxResultBinding shape: q88-style reports)
            sel.items = [
                it if isinstance(it.expr, ast.Star) else ast.SelectItem(
                    self._rewrite_scalar_subqueries(
                        it.expr, rels, allow_correlated=False), it.alias)
                for it in sel.items]
        edges: list = []           # (alias_a, col_a, alias_b, col_b)
        residuals: list = []
        for p in preds:
            aliases = self._pred_aliases(p, rels, scope)
            if aliases & left_aliases:
                # WHERE over a null-extended side filters AFTER the left
                # join (standard SQL: ON extends, WHERE restricts)
                self._left_post_preds.append(p)
                continue
            if len(aliases) <= 1:
                alias = next(iter(aliases), None)
                if alias is None:
                    residuals.append(p)     # constant pred → keep at top
                else:
                    rels[alias].local_preds.append(p)
            elif (len(aliases) == 2 and isinstance(p, ast.BinOp)
                  and p.op == "=" and isinstance(p.left, ast.Name)
                  and isinstance(p.right, ast.Name)):
                la = self._name_alias(p.left, rels, scope)
                ra = self._name_alias(p.right, rels, scope)
                edges.append((la, p.left, ra, p.right))
            else:
                residuals.append(p)

        # column demand: everything referenced above the scans
        needed: set = set()        # internal names
        for item in sel.items:
            if isinstance(item.expr, ast.Star):
                if item.expr.table is not None:
                    if item.expr.table not in rels:
                        raise PlanError(
                            f"unknown table alias {item.expr.table!r} in "
                            f"{item.expr.table}.*")
                    star_rels = [rels[item.expr.table]]
                else:
                    star_rels = list(rels.values())
                for r in star_rels:
                    for col in r.table.schema:
                        needed.add(f"{r.alias}.{col.name}")
            else:
                self._demand(item.expr, needed)
        for e in sel.group_by:
            self._demand(e, needed)
        for o in sel.order_by:
            self._demand(o.expr, needed)
        if sel.having is not None:
            self._demand(sel.having, needed)
        for p in residuals:
            self._demand(p, needed)
        for spec in self._sub_specs:
            for (oexpr, _lbl) in spec["keys"]:
                self._demand(oexpr, needed)
            if spec.get("neq"):
                self._demand(spec["neq"][0], needed)
        for p in self._post_preds:
            self._demand(p, needed)

        # fact table and join spanning tree (PK edges preferred: MapJoin
        # needs unique build keys; leftover edges become residual filters).
        # Try every candidate fact and keep the tree with the fewest
        # non-PK build sides, ranked by ESTIMATED post-predicate
        # cardinality (query/stats.py — selectivity-aware effective rows,
        # the statistics-fed cost model of `dq_opt_join_cost_based.cpp`
        # over this executor's star-shaped plan space): the biggest
        # surviving row stream drives the scan, well-filtered relations
        # become broadcast builds however large their raw tables are.
        from ydb_tpu_torch.query import stats as S
        eff = {a: S.effective_rows(a, r.table, r.local_preds)
               for a, r in rels.items()}
        # cost of a candidate tree: every relation is scanned whichever
        # orientation we pick, so orientations differ only in their BUILD
        # terms — each build side pays its EFFECTIVE rows (host transfer +
        # table construction), non-PK-unique builds penalized (expanding
        # probes, fused-path decline). Minimizing the build sum puts the
        # largest surviving row stream in the driving scan and strongly
        # filtered relations in tiny builds, whatever their raw sizes.
        # The non-unique penalty is steep: such builds force expanding
        # probes onto the portioned path, losing whole-query fusion — on
        # this platform a constant-factor cliff, not a linear cost.
        # And when such a build must also ATTACH PAYLOAD (columns of it
        # are demanded above the join — a payload-free join replans as a
        # fusable semi probe), the cliff is certain, so the DRIVER's
        # effective rows join the cost: the portioned fallback walks the
        # whole driving stream host-side. That term is what flips q12
        # onto the lineitem-driven orientation — a 32× penalty on a
        # well-filtered lineitem build still undercut scanning every
        # order through the host lane.
        _BAD_MULT = 32.0
        payload_alias = {a for a in rels
                         if any(n.split(".", 1)[0] == a for n in needed)}
        best = None
        for cand in rels:
            children_c, in_tree_c, leftovers_c, scores = \
                self._spanning_tree(cand, rels, edges, eff)
            unreachable = set(rels) - in_tree_c
            cost = 0.0
            defused = False
            for a in in_tree_c:
                if a != cand:
                    bad = scores.get(a, 0) < 2
                    cost += eff[a] * (_BAD_MULT if bad else 1.0)
                    defused = defused or (bad and a in payload_alias)
            if defused:
                cost += eff[cand]
            rank = (len(unreachable), cost)
            if best is None or rank < best[0]:
                best = (rank, cand, children_c, in_tree_c, leftovers_c)
        (rank, fact, children, in_tree, leftovers) = best
        self._eff_map = eff          # reused by _build_pipeline (EXPLAIN)
        unreachable = set(rels) - in_tree
        if unreachable:
            raise PlanError(f"no join path to {sorted(unreachable)} "
                            "(cross joins not supported yet)")
        for (la, lname, ra, rname) in leftovers:
            residuals.append(ast.BinOp("=", lname, rname))
        for p in residuals:
            self._demand(p, needed)
        for spec in self._left_specs:
            for (p_ast, _b) in spec["pairs"]:
                self._demand(p_ast, needed)
        for p in self._left_post_preds:
            self._demand(p, needed)

        pipeline = self._build_pipeline(fact, rels, children, needed,
                                        binder, top=True)

        # residual predicates at top
        if residuals:
            prog = ir.Program()
            for p in residuals:
                prog.filter(binder.bind(p))
            pipeline.steps.append(("program", prog))

        # null-extending (left outer) joins + their post-join filters
        self._attach_left_joins(pipeline, binder, needed)

        # semi/anti/scalar subquery joins + their filters
        self._attach_sub_specs(pipeline, binder)

        plan = QueryPlan(pipeline=pipeline, params=pool.values,
                         init_subplans=list(self._init_subplans))
        plan.star_order = [f"{r.alias}.{col.name}"
                           for r in rels.values() for col in r.table.schema]
        self._plan_projection_agg(sel, plan, binder)
        return plan

    # -- relations ---------------------------------------------------------

    def _flatten_relations(self, rel: ast.Relation):
        rels: dict[str, _Rel] = {}
        conds: list = []
        left_joins: list = []

        def add_table(t: ast.TableRef):
            alias = t.alias or t.name
            if alias in rels:
                raise PlanError(f"duplicate alias {alias}")
            try:
                rels[alias] = _Rel(alias, self.catalog.table(t.name))
            except KeyError as e:
                raise PlanError(str(e.args[0])) from e

        def walk(r):
            if isinstance(r, ast.TableRef):
                add_table(r)
            elif isinstance(r, ast.Join):
                if r.kind in ("inner", "cross"):
                    walk(r.left)
                    walk(r.right)
                    if r.on is not None:
                        conds.extend(conjuncts(r.on))
                elif r.kind == "left":
                    walk(r.left)
                    # the nullable side stays OUT of the inner-join tree; it
                    # becomes a null-extending build fragment attached after
                    # the inner pipeline (`CommonJoinCore` left semantics)
                    if not isinstance(r.right, ast.TableRef):
                        raise PlanError("LEFT JOIN right side must be a "
                                        "table (materialize subqueries "
                                        "first)")
                    left_joins.append((r.right, r.on))
                elif r.kind == "right":
                    # A RIGHT JOIN B == B LEFT JOIN A
                    walk(r.right)
                    if not isinstance(r.left, ast.TableRef):
                        raise PlanError("RIGHT JOIN left side must be a "
                                        "table")
                    left_joins.append((r.left, r.on))
                else:
                    raise PlanError(f"{r.kind} join not supported yet")
            elif isinstance(r, ast.SubqueryRef):
                raise PlanError("FROM subqueries must be materialized by "
                                "the engine before planning")
            else:
                raise PlanError(f"bad relation {r!r}")

        walk(rel)
        return rels, conds, left_joins

    def _pred_aliases(self, p, rels, scope) -> set:
        names: set = set()
        walk_names(p, names)
        out = set()
        for parts in names:
            b = scope.try_resolve(parts)
            if b is None:
                raise PlanError(f"unknown column {'.'.join(parts)}")
            out.add(b.internal.split(".", 1)[0])
        return out

    def _name_alias(self, n: ast.Name, rels, scope) -> str:
        return scope.resolve(n.parts).internal.split(".", 1)[0]

    def _demand(self, e, needed: set):
        names: set = set()
        walk_names(e, names)
        for parts in names:
            b = self.scope.try_resolve(parts)
            if b is not None:
                needed.add(b.internal)

    # -- join tree ---------------------------------------------------------

    def _spanning_tree(self, fact: str, rels, edges, eff=None):
        """Prim-style tree from the fact outward over alias-pair edge
        GROUPS (all equi-conditions between a pair join together — composite
        keys). Prefer groups whose child columns cover the child table's
        primary key, so the broadcast-join build side has unique keys;
        among candidates, attach the smallest ESTIMATED child first
        (`eff`: effective-cardinality map from query/stats.py)."""
        if eff is None:
            eff = {a: r.table.num_rows for a, r in rels.items()}
        groups: dict[tuple, list] = {}
        for (la, lname, ra, rname) in edges:
            key = (la, ra) if la <= ra else (ra, la)
            pair = (lname, rname) if la <= ra else (rname, lname)
            groups.setdefault(key, []).append(pair)
        group_list = list(groups.items())

        in_tree = {fact}
        children: dict[str, list] = {a: [] for a in rels}
        used = [False] * len(group_list)
        scores: dict = {}   # child alias -> PK-coverage score (2 = unique)
        while True:
            best = None
            for i, ((a1, a2), pairs) in enumerate(group_list):
                if used[i]:
                    continue
                for (pa, ca, flip) in ((a1, a2, False), (a2, a1, True)):
                    if pa in in_tree and ca not in in_tree:
                        child_cols = {
                            self.scope.resolve((p[1] if not flip else p[0]).parts)
                            .internal.split(".", 1)[1] for p in pairs}
                        pk = set(rels[ca].table.key_columns)
                        score = 2 if pk <= child_cols \
                            else (1 if child_cols & pk else 0)
                        cand = (score, -eff[ca], -i,
                                pa, ca, flip)
                        if best is None or cand[:3] > best[:3]:
                            best = cand
            if best is None:
                break
            _s, _r, neg_i, pa, ca, flip = best
            scores[ca] = _s
            used[-neg_i] = True
            in_tree.add(ca)
            pairs = group_list[-neg_i][1]
            oriented = [(cn, pn) if flip else (pn, cn) for (pn, cn) in pairs]
            children[pa].append((ca, oriented))   # [(parent_name, child_name)]
        leftovers = []
        for i, ((a1, a2), pairs) in enumerate(group_list):
            if not used[i]:
                for (lname, rname) in pairs:
                    leftovers.append((a1, lname, a2, rname))
        return children, in_tree, leftovers, scores

    def _build_pipeline(self, alias: str, rels, children, needed,
                        binder, top: bool) -> Pipeline:
        r = rels[alias]
        # local predicate program
        pre = ir.Program()
        scan_cols: set = set()
        for p in r.local_preds:
            pre.filter(binder.bind(p))
            self._demand(p, scan_cols)

        # recurse into children first (they register join-key demand)
        join_steps = []       # [(JoinStep, post_program | None)]
        for (child, pairs) in children[alias]:
            probe_bs = [self.scope.resolve(pn.parts) for (pn, _cn) in pairs]
            build_bs = [self.scope.resolve(cn.parts) for (_pn, cn) in pairs]
            for b in probe_bs:
                scan_cols.add(b.internal)
            child_needed = set(needed)
            for b in build_bs:
                child_needed.add(b.internal)
            sub = self._build_pipeline(child, rels, children,
                                       child_needed, binder, top=False)
            if len(pairs) == 1:
                build_key, probe_key = build_bs[0].internal, probe_bs[0].internal
                # keep the build key in the payload when referenced above
                payload = [c for c in sub.out_names
                           if c in needed
                           and (c != build_key or build_key in needed)]
                kind = "inner" if payload else "left_semi"
                join_steps.append((JoinStep(sub, build_key, probe_key,
                                            kind, payload), None))
            else:
                # composite key: join on a combined 64-bit hash of the key
                # columns on both sides, then verify each equality post-join
                # (collision guard) — the packed-key analog of GraceJoin's
                # multi-column keys (`mkql_grace_join.cpp`)
                jk = f"__jk{self._jk_counter}"
                self._jk_counter += 1
                pre.assign(jk, _hash_key_expr([b.internal for b in probe_bs]))
                bjk = f"{jk}b"
                sub_partial = ir.Program()
                # string key columns from a DIFFERENT dictionary than the
                # probe side's must remap codes before hashing/verifying —
                # raw code equality across dictionaries is meaningless
                hash_cols, remap_names = [], []
                verify = ir.Program()
                for i, (pb, bb) in enumerate(zip(probe_bs, build_bs)):
                    if pb.dtype.is_string and pb.dictionary is not None \
                            and bb.dictionary is not None \
                            and bb.dictionary is not pb.dictionary:
                        src = bb.dictionary.values_array()
                        lut = np.full(max(len(src), 1), -2, dtype=np.int32)
                        for ci, v in enumerate(src):
                            lut[ci] = pb.dictionary.encode_existing(v)
                        p = self.pool.add(
                            lut, dt.DType(dt.Kind.STRING, False),
                            is_array=True)
                        self.pool.param_dicts[p.name] = pb.dictionary
                        rname = f"{jk}r{i}"
                        sub_partial.assign(
                            rname, ir.call("take_lut",
                                           ir.Col(bb.internal), p))
                        remap_names.append(rname)
                        hash_cols.append(rname)
                        verify.filter(ir.call("eq", ir.Col(pb.internal),
                                              ir.Col(rname)))
                    else:
                        hash_cols.append(bb.internal)
                        verify.filter(ir.call("eq", ir.Col(pb.internal),
                                              ir.Col(bb.internal)))
                sub_partial.assign(bjk, _hash_key_expr(hash_cols))
                sub_partial.project(sub.out_names + remap_names + [bjk])
                sub.partial = sub_partial
                payload = list(dict.fromkeys(
                    [c for c in sub.out_names if c in needed]
                    + [b.internal for b in build_bs] + remap_names))
                join_steps.append(
                    (JoinStep(sub, bjk, jk, "inner", payload,
                              build_key_cols=[b.internal
                                              for b in build_bs]),
                     verify))

        # own columns demanded from above
        own_cols = {n for n in needed
                    if n.split(".", 1)[0] == alias
                    and self.scope.by_alias[alias].get(n.split(".", 1)[1])}
        scan_cols |= own_cols

        storage_cols = []
        for internal in sorted(scan_cols):
            a, col = internal.split(".", 1)
            if a == alias:
                storage_cols.append((col, internal))
        scan = ScanSpec(r.table.name, storage_cols)
        est = getattr(self, "_eff_map", {}).get(alias)
        if est is None:              # single-relation plans skip the tree
            from ydb_tpu_torch.query import stats as S
            est = S.effective_rows(alias, r.table, r.local_preds)
        scan.est_rows = round(est, 1)
        self._extract_prune(pre, scan, r.table)

        out_names = sorted(own_cols)
        steps = []
        for (js, verify) in join_steps:
            out_names.extend(c for c in js.payload if c not in out_names)
            steps.append(("join", js))
            if verify is not None:
                steps.append(("program", verify))
        pipe = Pipeline(scan=scan,
                        pre_program=pre if pre.commands else None,
                        steps=steps,
                        out_names=out_names)
        if not top:
            # build fragments materialize: project to outputs
            prog = ir.Program().project(out_names)
            pipe.partial = prog
        return pipe

    def _extract_prune(self, prog: ir.Program, scan: ScanSpec, table) -> None:
        from ydb_tpu_torch.storage.pushdown import extract_prune_predicates
        internal_to_storage = {i: s for (s, i) in scan.columns}
        for (col, op, val) in extract_prune_predicates(prog):
            storage = internal_to_storage.get(col)
            if storage is None:
                continue
            dtype = table.schema.dtype(storage)
            if dtype.is_string and op != "eq":
                continue   # dictionary codes are unordered
            scan.prune.append((storage, op, val))

    # -- left outer joins --------------------------------------------------

    # -- eager aggregation (LEFT JOIN build pre-aggregation) ---------------

    _EAGER_FNS = ("count", "sum", "min", "max")

    def _eager_agg_rewrite(self, sel: ast.Select, rels, scope):
        """Pre-aggregate a LEFT JOIN build below the join (classic eager
        aggregation) when the joined relation is consumed ONLY through
        count/sum/min/max aggregates over its columns:

            c LEFT JOIN o ON c.k = o.k [AND o-local] ... count(o.x)
        →   build' = SELECT o.k, count(o.x) FROM o [WHERE local] GROUP BY o.k
            c LEFT JOIN build' ON c.k = o.k ... sum(coalesce(o.cnt, 0))

        The payoff is the bounds lattice's: the pre-aggregated build is
        UNIQUE-keyed (grouped by the join key), so the expanding
        duplicate-key probe — the shape that declines whole-plan fusion
        and runs the portioned host lane (q13's measured 89.5% wall) —
        stops existing, and the join becomes row-preserving with a
        key-domain-bounded build. Exact per SQL semantics: per-key
        partial counts SUM over the probe stream (an unmatched probe row
        contributes coalesce(NULL, 0) = 0); sum/min/max merge with
        themselves, and their all-NULL-group result stays NULL through
        the null-extended payload. The rewrite only fires when every
        reference to the alias outside the ON clause sits in a
        qualifying aggregate — any other use (group key, scalar context,
        subquery, string min/max, DISTINCT) keeps the expanding join."""
        import dataclasses as _dc

        from ydb_tpu_torch.query.bounds import bounds_enabled
        if not sel.group_by or not self._left_specs:
            return sel
        if not bounds_enabled():       # lever off: capacity-shaped plans
            return sel
        if any(isinstance(it.expr, ast.Star) for it in sel.items):
            return sel

        def alias_of(parts) -> Optional[str]:
            b = scope.try_resolve(parts)
            return b.internal.split(".", 1)[0] if b is not None else None

        def scan(e, alias, calls) -> bool:
            """True iff every reference to `alias` under `e` is the sole
            Name argument of a qualifying aggregate (collected into
            `calls`). Conservative: unknown node kinds fail."""
            if e is None or isinstance(e, (ast.Literal, ast.BoundParam)):
                return True
            if isinstance(e, ast.Name):
                return alias_of(e.parts) != alias
            if isinstance(e, ast.FuncCall):
                if e.name in B.AGG_NAMES:
                    refs: set = set()
                    walk_names(e, refs)
                    if not any(alias_of(p) == alias for p in refs):
                        # a probe-side aggregate sees k copies of each
                        # matched probe row in the EXPANDING join; the
                        # rewrite makes the probe row-preserving, so only
                        # multiplicity-insensitive aggregates (min/max,
                        # DISTINCT) keep their value — count(*)/sum/avg
                        # over the probe stream disqualify the spec
                        return bool(e.distinct) or e.name in ("min", "max")
                    if (e.name not in self._EAGER_FNS or e.distinct
                            or e.star or len(e.args) != 1
                            or not isinstance(e.args[0], ast.Name)):
                        return False
                    b = scope.try_resolve(e.args[0].parts)
                    if b is None or (b.dtype.is_string
                                     and e.name in ("min", "max")):
                        return False
                    calls.append(e)
                    return True
                return all(scan(a, alias, calls) for a in e.args)
            if isinstance(e, ast.BinOp):
                return scan(e.left, alias, calls) \
                    and scan(e.right, alias, calls)
            if isinstance(e, ast.UnaryOp):
                return scan(e.arg, alias, calls)
            if isinstance(e, ast.Case):
                parts = ([e.operand] if e.operand is not None else []) \
                    + [x for (c, r) in e.whens for x in (c, r)] \
                    + ([e.default] if e.default is not None else [])
                return all(scan(x, alias, calls) for x in parts)
            if isinstance(e, ast.Cast):
                return scan(e.arg, alias, calls)
            if isinstance(e, ast.Between):
                return all(scan(x, alias, calls)
                           for x in (e.arg, e.lo, e.hi))
            if isinstance(e, ast.InList):
                return all(scan(x, alias, calls)
                           for x in (e.arg,) + tuple(e.items))
            if isinstance(e, (ast.Like, ast.IsNull)):
                return scan(e.arg, alias, calls)
            return False               # subqueries / unknown nodes

        def agg_sig(e: ast.FuncCall):
            return (e.name, repr(e.args[0]))

        rewritten = False
        for spec in self._left_specs:
            if len(spec["pairs"]) != 1:
                continue
            alias = spec["alias"]
            # keys / filters must not touch the alias at all (WHERE over
            # the null-extended side restricts post-join — incompatible)
            no_ref: list = []
            if not all(scan(e, alias, no_ref) and not no_ref
                       for e in list(sel.group_by) + [sel.where]):
                continue
            calls: list = []
            agg_exprs = [it.expr for it in sel.items] \
                + [o.expr for o in sel.order_by] \
                + ([sel.having] if sel.having is not None else [])
            if not all(scan(e, alias, calls) for e in agg_exprs):
                continue
            if not calls:
                continue
            # one synthetic payload per distinct (fn, arg)
            insts: dict = {}           # sig -> (payload_col, sub_item_expr)
            repl: dict = {}            # sig -> outer replacement FuncCall
            for c in calls:
                sig = agg_sig(c)
                if sig in insts:
                    continue
                pname = f"__ea{len(insts)}"
                ref = ast.Name((alias, pname))
                if c.name == "count":
                    # int64-cast partial counts: coalesce/sum over a
                    # uint64 payload and an int literal would promote;
                    # the outer cast restores count's uint64 result type
                    # so the lever cannot flip the output schema
                    sub_e = ast.Cast(c, "int64")
                    out_dt = dt.DType(dt.Kind.INT64, True)
                    repl[sig] = ast.Cast(ast.FuncCall("sum", (ast.FuncCall(
                        "coalesce", (ref, ast.Literal(0))),)), "uint64")
                else:
                    sub_e = c
                    arg_dt = scope.resolve(c.args[0].parts).dtype
                    from ydb_tpu_torch.ops.ir import agg_result_dtype
                    out_dt = agg_result_dtype(
                        c.name if c.name == "sum" else "some",
                        arg_dt).with_nullable(True)
                    repl[sig] = ast.FuncCall(c.name, (ref,))
                insts[sig] = (pname, sub_e)
                scope.add(alias, pname,
                          B.ColumnBinding(f"{alias}.{pname}", out_dt, None))
            spec["eager"] = list(insts.values())

            def walk(e):
                if isinstance(e, ast.FuncCall) and e.name in B.AGG_NAMES \
                        and not e.distinct and not e.star and e.args:
                    r = repl.get(agg_sig(e))
                    if r is not None:
                        return r

                def rw(v):
                    if isinstance(v, tuple):
                        return tuple(rw(x) for x in v)
                    if hasattr(v, "__dataclass_fields__"):
                        return walk(v)
                    return v

                kw = {f: rw(getattr(e, f))
                      for f in e.__dataclass_fields__}
                return _dc.replace(e, **kw)

            sel = ast.Select(**{**sel.__dict__})
            sel.items = [ast.SelectItem(walk(it.expr), it.alias)
                         for it in sel.items]
            sel.order_by = [ast.OrderItem(walk(o.expr), o.ascending,
                                          o.nulls_first)
                            for o in sel.order_by]
            if sel.having is not None:
                sel.having = walk(sel.having)
            rewritten = True
        if rewritten:
            from ydb_tpu_torch.utils.metrics import GLOBAL
            GLOBAL.inc("bounds/eager_agg_rewrites")
        return sel

    def _attach_left_joins(self, pipeline, binder: B.ExprBinder,
                           needed: set) -> None:
        """Append a null-extending build fragment per LEFT JOIN: the right
        side plans as its own (filtered) subquery whose output labels are
        the internal `alias.col` names, so payload columns land in the
        outer scope's namespace. Duplicate build keys take the expanding
        probe automatically."""
        for spec in self._left_specs:
            alias = spec["alias"]
            pairs = spec["pairs"]
            build_cols = [bn.parts[-1] for (_p, bn) in pairs]
            if spec.get("eager"):
                # eager aggregation (`_eager_agg_rewrite`): the build
                # GROUPS by its join key — unique-keyed by construction,
                # so the probe is row-preserving and fusion survives
                bk = build_cols[0]
                items = [ast.SelectItem(ast.Name((alias, bk)),
                                        f"{alias}.{bk}")]
                items += [ast.SelectItem(sub_e, f"{alias}.{pname}")
                          for (pname, sub_e) in spec["eager"]]
                sub = ast.Select(items=items,
                                 relation=ast.TableRef(spec["tref"].name,
                                                       alias),
                                 where=_and_fold(spec["local"]),
                                 group_by=[ast.Name((alias, bk))])
                right_cols = [bk] + [p for (p, _e) in spec["eager"]]
            else:
                right_cols = sorted({n.split(".", 1)[1] for n in needed
                                     if n.startswith(alias + ".")}
                                    | set(build_cols))
                items = [ast.SelectItem(ast.Name((alias, col)),
                                        f"{alias}.{col}")
                         for col in right_cols]
                sub = ast.Select(items=items,
                                 relation=ast.TableRef(spec["tref"].name,
                                                       alias),
                                 where=_and_fold(spec["local"]))
            jplan = self._plan_inner(sub)
            payload = [f"{alias}.{c}" for c in right_cols]

            if len(pairs) == 1:
                e = binder.bind(pairs[0][0])
                if isinstance(e, ir.Col):
                    probe_key = e.name
                else:
                    probe_key = f"__lj{self._jk_counter}"
                    self._jk_counter += 1
                    pre = ir.Program().assign(probe_key, e)
                    pipeline.steps.append(("program", pre))
                js = JoinStep(jplan, f"{alias}.{build_cols[0]}", probe_key,
                              "left", payload)
                pipeline.steps.append(("join", js))
            else:
                # composite key: hash-combine both sides (host-side for
                # the build via build_hash_keys, in-program for the
                # probe), then verify each equality POST-join — a hash
                # collision cannot filter the row (LEFT keeps it), so
                # mismatched payloads are NULLed instead
                bound = [binder.bind(p_ast) for (p_ast, _b) in pairs]
                for (p_ast, _b), e in zip(pairs, bound):
                    b = self.scope.try_resolve(p_ast.parts) \
                        if isinstance(p_ast, ast.Name) else None
                    if b is not None and b.dtype.is_string:
                        raise PlanError(
                            "composite LEFT JOIN over string keys is "
                            "not supported yet")
                probe_key = f"__lj{self._jk_counter}"
                self._jk_counter += 1
                pre = ir.Program().assign(
                    probe_key,
                    _hash_key_expr_of(bound))
                pipeline.steps.append(("program", pre))
                bh = f"{alias}.__ljbh"
                js = JoinStep(jplan, bh, probe_key, "left", payload,
                              build_hash_keys=[f"{alias}.{c}"
                                               for c in build_cols])
                pipeline.steps.append(("join", js))
                ver = ir.Program()
                ok = None
                for e, bc in zip(bound, build_cols):
                    t = ir.call("eq", e, ir.Col(f"{alias}.{bc}"))
                    ok = t if ok is None else ir.call("and", ok, t)
                okname = f"__ljok{self._jk_counter}"
                self._jk_counter += 1
                ver.assign(okname, ok)
                for pcol in payload:
                    ver.assign(pcol, ir.call(
                        "if", ir.Col(okname), ir.Col(pcol),
                        ir.call("typed_null", ir.Col(pcol))))
                pipeline.steps.append(("program", ver))
            pipeline.out_names.extend(
                c for c in payload if c not in pipeline.out_names)

        if self._left_post_preds:
            prog = ir.Program()
            for p in self._left_post_preds:
                prog.filter(binder.bind(p))
            pipeline.steps.append(("program", prog))

    # -- subqueries --------------------------------------------------------

    def _inner_scope(self, inner_sel: ast.Select):
        """Scope + relation map for a subquery's own tables."""
        inner_rels, _conds, _lj = self._flatten_relations(inner_sel.relation)
        scope = B.Scope()
        for r in inner_rels.values():
            for col in r.table.schema:
                scope.add(r.alias, col.name, B.ColumnBinding(
                    f"{r.alias}.{col.name}", col.dtype,
                    r.table.dictionaries.get(col.name)))
        return scope

    def _split_correlations(self, inner_sel: ast.Select,
                            with_neq: bool = False):
        """Pull `inner_col = outer_col` conjuncts out of the subquery's
        WHERE (the equality-decorrelation the reference performs in logical
        optimization). Returns (inner select w/o them, [(inner_name_ast,
        outer_name_ast)]) — plus, when `with_neq`, the list of
        `inner_col <> outer_col` conjuncts as a third element (decorrelated
        via the min/max trick in `_add_semi_spec`)."""
        inner_scope = self._inner_scope(inner_sel)
        rest, pairs, neqs = [], [], []
        for c in conjuncts(inner_sel.where):
            names: set = set()
            walk_names(c, names)
            outer = [p for p in names if inner_scope.try_resolve(p) is None]
            if not outer:
                rest.append(c)
                continue
            ok = (isinstance(c, ast.BinOp) and c.op in ("=", "<>")
                  and isinstance(c.left, ast.Name)
                  and isinstance(c.right, ast.Name))
            if not ok or (c.op == "<>" and not with_neq):
                raise PlanError(
                    f"unsupported correlated predicate {c!r} (only "
                    "inner_col = outer_col correlation is decorrelated)")
            dest = pairs if c.op == "=" else neqs
            if inner_scope.try_resolve(c.left.parts) is not None:
                dest.append((c.left, c.right))
            elif inner_scope.try_resolve(c.right.parts) is not None:
                dest.append((c.right, c.left))
            else:
                raise PlanError(f"correlated predicate {c!r} references no "
                                "subquery column")
        new_sel = ast.Select(**{**inner_sel.__dict__})
        new_sel.where = _and_fold(rest)
        if with_neq:
            return new_sel, pairs, neqs
        return new_sel, pairs

    def _expr_dtype(self, e: ast.Expr, scope: B.Scope):
        """Static result dtype of a (possibly aggregate) expression."""
        from ydb_tpu_torch.core import dtypes as dt
        from ydb_tpu_torch.ops.ir import agg_result_dtype
        if isinstance(e, ast.FuncCall) and e.name in B.AGG_NAMES:
            if e.star or not e.args:
                return dt.DType(dt.Kind.UINT64, False)
            if e.name == "avg":
                return dt.DType(dt.Kind.FLOAT64, True)
            arg = self._expr_dtype(e.args[0], scope)
            return agg_result_dtype("sum" if e.name == "sum" else "some",
                                    arg).with_nullable(True)
        if isinstance(e, ast.BinOp):
            if e.op in ("and", "or", "=", "<>", "<", "<=", ">", ">="):
                return dt.DType(dt.Kind.BOOL, True)
            lt = self._expr_dtype(e.left, scope)
            rt = self._expr_dtype(e.right, scope)
            if e.op == "/":
                return dt.DType(dt.Kind.FLOAT64, lt.nullable or rt.nullable)
            return dt.common_numeric(lt, rt)
        if isinstance(e, ast.UnaryOp):
            return self._expr_dtype(e.arg, scope)
        if isinstance(e, ast.Name):
            return scope.resolve(e.parts).dtype
        f = B._try_fold(e)
        if f is not None:
            return f.dtype
        raise PlanError(f"cannot type subquery expression {e!r}")

    def _plan_inner(self, inner_sel: ast.Select) -> "QueryPlan":
        return Planner(self.catalog).plan_select(inner_sel)

    def _extract_subqueries(self, p: ast.Expr, rels):
        """Consume IN/EXISTS predicates into semi/anti-join specs; rewrite
        scalar subqueries. Returns the remaining predicate (or None if the
        conjunct was fully consumed)."""
        if isinstance(p, ast.UnaryOp) and p.op == "not":
            a = p.arg
            if isinstance(a, ast.Exists):
                p = ast.Exists(a.query, not a.negated)
            elif isinstance(a, ast.InSubquery):
                p = ast.InSubquery(a.arg, a.query, not a.negated)
        if isinstance(p, ast.InSubquery):
            self._add_semi_spec([p.arg], p.query, p.negated,
                                first_item_key=True)
            return None
        if isinstance(p, ast.Exists):
            self._add_semi_spec([], p.query, p.negated, first_item_key=False)
            return None
        n_before = len(self._sub_specs)
        p = self._rewrite_embedded_membership(p)
        if len(self._sub_specs) > n_before:
            # the predicate now references mark columns that only exist
            # AFTER the mark joins attach — apply it post-join. Scalar
            # subqueries sharing the predicate still need their rewrite
            # (they would otherwise reach the binder raw).
            rewritten, _corr = self._rewrite_scalars(p)
            self._post_preds.append(p if rewritten is None else rewritten)
            return None
        rewritten, correlated = self._rewrite_scalars(p)
        if rewritten is None:
            return p
        if correlated:
            self._post_preds.append(rewritten)
            return None
        return rewritten

    def _rewrite_embedded_membership(self, p):
        """IN/EXISTS sitting INSIDE a larger predicate (an OR arm, a CASE
        condition): each becomes a MARK join whose bool bit substitutes
        for the membership test — `a IN s1 OR a IN s2` runs as two mark
        joins + one filter (ds35-family demographics queries)."""
        import dataclasses as _dc

        def walk(e):
            # normalize NOT (x IN (...)) / NOT EXISTS the way the
            # top-level extraction does, so the negated-inside-OR guard
            # actually fires instead of silently planning a plain mark
            if isinstance(e, ast.UnaryOp) and e.op == "not":
                a = e.arg
                if isinstance(a, ast.Exists):
                    e = ast.Exists(a.query, not a.negated)
                elif isinstance(a, ast.InSubquery):
                    e = ast.InSubquery(a.arg, a.query, not a.negated)
            if isinstance(e, (ast.InSubquery, ast.Exists)):
                n = len(self._sub_specs) + len(self._init_subplans)
                mark = f"__s{n}m"
                if isinstance(e, ast.InSubquery):
                    self._add_semi_spec([e.arg], e.query, e.negated,
                                        first_item_key=True,
                                        mark_pred=mark)
                else:
                    self._add_semi_spec([], e.query, e.negated,
                                        first_item_key=False,
                                        mark_pred=mark)
                from ydb_tpu_torch.core import dtypes as dt
                self.scope.add("__sub", mark, B.ColumnBinding(
                    mark, dt.DType(dt.Kind.BOOL, False)))
                return ast.Name((mark,))
            if not hasattr(e, "__dataclass_fields__") \
                    or isinstance(e, (ast.ScalarSubquery, ast.Select)):
                return e

            def rw(v):
                if isinstance(v, tuple):
                    return tuple(rw(x) for x in v)
                if hasattr(v, "__dataclass_fields__"):
                    return walk(v)
                return v
            out = {f: rw(getattr(e, f)) for f in e.__dataclass_fields__}
            try:
                return _dc.replace(e, **out)
            except TypeError:
                return e
        return walk(p)

    def _has_scalar_sub(self, e) -> bool:
        """Generic dataclass-field walk (matches the shapes the rewriter's
        walk at `_rewrite_scalars` can reach). Exists/InSubquery bodies
        are handled by the semi-join machinery, not the scalar rewrite —
        don't descend into them."""
        if isinstance(e, ast.ScalarSubquery):
            return True
        if isinstance(e, (ast.Exists, ast.InSubquery)) \
                or not hasattr(e, "__dataclass_fields__"):
            return False

        def any_sub(v) -> bool:
            if isinstance(v, tuple):
                return any(any_sub(x) for x in v)
            return hasattr(v, "__dataclass_fields__") \
                and self._has_scalar_sub(v)
        return any(any_sub(getattr(e, f)) for f in e.__dataclass_fields__)

    def _rewrite_scalar_subqueries(self, p, rels, allow_correlated):
        rewritten, correlated = self._rewrite_scalars(
            p, allow_correlated=allow_correlated)
        return p if rewritten is None else rewritten

    def _rewrite_scalars(self, p, allow_correlated=True):
        """Replace every ScalarSubquery in `p`: uncorrelated → BoundParam
        (precomputed), correlated → reference to a decorrelated aggregate
        join column. Returns (rewritten or None-if-unchanged, any_correlated)."""
        state = {"changed": False, "correlated": False}

        def walk(e):
            if isinstance(e, ast.ScalarSubquery):
                state["changed"] = True
                inner, pairs = self._split_correlations(e.query)
                if len(inner.items) != 1:
                    raise PlanError("scalar subquery must select one column")
                inner_scope = self._inner_scope(inner)
                dtype = self._expr_dtype(inner.items[0].expr, inner_scope) \
                    .with_nullable(True)
                n = len(self._sub_specs) + len(self._init_subplans)
                if not pairs:
                    pname = f"__sp{n}"
                    self._init_subplans.append(
                        (pname, self._plan_inner(inner)))
                    return ast.BoundParam(pname, dtype)
                if not allow_correlated:
                    raise PlanError("correlated scalar subquery not "
                                    "supported in this clause")
                state["correlated"] = True
                agg_label = f"__s{n}agg"
                items = [ast.SelectItem(inner.items[0].expr, agg_label)]
                key_labels = []
                for i, (iname, _oname) in enumerate(pairs):
                    lbl = f"__s{n}k{i}"
                    items.append(ast.SelectItem(iname, lbl))
                    key_labels.append(lbl)
                sub_sel = ast.Select(
                    items=items, relation=inner.relation, where=inner.where,
                    group_by=[iname for (iname, _o) in pairs])
                spec = {
                    "kind": "scalar", "n": n,
                    "plan": self._plan_inner(sub_sel),
                    "keys": [(oname, lbl) for (_i, oname), lbl
                             in zip(pairs, key_labels)],
                    "payload": [agg_label],
                }
                self._sub_specs.append(spec)
                self.scope.add("__sub", agg_label,
                               B.ColumnBinding(agg_label, dtype))
                return ast.Name((agg_label,))
            # structural rebuild
            if isinstance(e, ast.BinOp):
                return ast.BinOp(e.op, walk(e.left), walk(e.right))
            if isinstance(e, ast.UnaryOp):
                return ast.UnaryOp(e.op, walk(e.arg))
            if isinstance(e, ast.Between):
                return ast.Between(walk(e.arg), walk(e.lo), walk(e.hi),
                                   e.negated)
            if isinstance(e, ast.InList):
                return ast.InList(walk(e.arg),
                                  tuple(walk(x) for x in e.items),
                                  e.negated)
            if isinstance(e, ast.IsNull):
                return ast.IsNull(walk(e.arg), e.negated)
            if isinstance(e, ast.Like):
                return ast.Like(walk(e.arg), e.pattern, e.negated)
            if isinstance(e, ast.FuncCall):
                return ast.FuncCall(e.name, tuple(walk(a) for a in e.args),
                                    e.distinct, e.star)
            if isinstance(e, ast.Case):
                return ast.Case(
                    walk(e.operand) if e.operand is not None else None,
                    tuple((walk(c), walk(r)) for (c, r) in e.whens),
                    walk(e.default) if e.default is not None else None)
            if isinstance(e, ast.Cast):
                return ast.Cast(walk(e.arg), e.to)
            return e

        out = walk(p)
        if not state["changed"]:
            return None, False
        return out, state["correlated"]

    def _add_semi_spec(self, outer_exprs, inner_sel: ast.Select,
                       negated: bool, first_item_key: bool,
                       mark_pred: str = ""):
        """`mark_pred`: non-empty = the membership test sits INSIDE a
        larger predicate (an OR arm) — plan a MARK join exposing the
        bit under that name instead of a filtering semi join."""
        inner, pairs, neqs = self._split_correlations(inner_sel,
                                                      with_neq=True)
        n = len(self._sub_specs) + len(self._init_subplans)
        if neqs:
            if first_item_key or not pairs:
                raise PlanError("inner <> outer correlation needs an "
                                "EXISTS with an equality correlation too")
            if len(neqs) > 1:
                raise PlanError("at most one <> correlation is supported")
            return self._add_neq_semi_spec(inner, pairs, neqs[0], negated, n)
        items = []
        keys = []        # [(outer_ast_expr, build_label)]
        i = 0
        if first_item_key:
            if len(inner.items) != 1:
                raise PlanError("IN subquery must select one column")
            lbl = f"__s{n}k{i}"; i += 1
            items.append(ast.SelectItem(inner.items[0].expr, lbl))
            keys.append((outer_exprs[0], lbl))
        for (iname, oname) in pairs:
            lbl = f"__s{n}k{i}"; i += 1
            items.append(ast.SelectItem(iname, lbl))
            keys.append((oname, lbl))
        if not keys:
            raise PlanError("uncorrelated EXISTS is not supported yet")
        has_aggs: list = []
        for it in inner.items:
            walk_aggs(it.expr, has_aggs)
        grouped = bool(inner.group_by) or bool(has_aggs) \
            or inner.having is not None
        sub_sel = ast.Select(
            items=items, relation=inner.relation, where=inner.where,
            group_by=list(inner.group_by), having=inner.having,
            distinct=not grouped)
        if grouped and pairs:
            # correlated grouped subquery: correlation keys join the groups
            sub_sel.group_by = list(inner.group_by) + \
                [iname for (iname, _o) in pairs]
        spec = {
            "kind": "anti" if negated else "semi", "n": n,
            "plan": self._plan_inner(sub_sel),
            "keys": keys, "payload": [],
            # NOT IN (vs NOT EXISTS): NULL probe keys must be excluded when
            # the build set is non-empty — x NOT IN S is NULL, not TRUE
            "not_in": negated and first_item_key,
        }
        if mark_pred:
            if negated:
                raise PlanError("negated IN/EXISTS inside OR is not "
                                "supported yet")
            if len(keys) > 1:
                raise PlanError("composite-key IN/EXISTS inside OR is "
                                "not supported yet")
            spec["kind"] = "markpred"
            spec["mark"] = mark_pred
        if spec["not_in"] and pairs:
            # correlated NOT IN additionally needs a per-correlation-key
            # set-emptiness probe (x NOT IN {} is TRUE even for NULL x):
            # a distinct projection of the correlation keys alone
            if grouped:
                raise PlanError(
                    "correlated NOT IN over a grouped subquery is not "
                    "supported yet")
            corr_items = [ast.SelectItem(iname, f"__s{n}c{i}")
                          for i, (iname, _o) in enumerate(pairs)]
            sub2 = ast.Select(
                items=corr_items, relation=inner.relation, where=inner.where,
                group_by=[iname for (iname, _o) in pairs])
            spec["plan2"] = self._plan_inner(sub2)
            spec["keys2"] = [(oname, f"__s{n}c{i}")
                             for i, (_i, oname) in enumerate(pairs)]
        self._sub_specs.append(spec)

    def _add_neq_semi_spec(self, inner: ast.Select, pairs, neq,
                           negated: bool, n: int):
        """EXISTS(... WHERE k = outer.k AND col <> outer.col): a row with a
        different `col` exists in group k iff min(col) != outer.col OR
        max(col) != outer.col (all-equal collapses min=max=outer). The
        subquery groups by the equi keys with min/max aggregates; the
        existence test becomes a mark join + verification filter."""
        (neq_inner, neq_outer) = neq
        items, keys = [], []
        for i, (iname, oname) in enumerate(pairs):
            lbl = f"__s{n}k{i}"
            items.append(ast.SelectItem(iname, lbl))
            keys.append((oname, lbl))
        mn, mx = f"__s{n}mn", f"__s{n}mx"
        items.append(ast.SelectItem(
            ast.FuncCall("min", (neq_inner,)), mn))
        items.append(ast.SelectItem(
            ast.FuncCall("max", (neq_inner,)), mx))
        sub_sel = ast.Select(
            items=items, relation=inner.relation, where=inner.where,
            group_by=[iname for (iname, _o) in pairs])
        self._sub_specs.append({
            "kind": "anti" if negated else "semi", "n": n,
            "plan": self._plan_inner(sub_sel),
            "keys": keys, "payload": [mn, mx],
            "not_in": False,
            "neq": (neq_outer, mn, mx),
        })

    def _attach_sub_specs(self, pipeline, binder: B.ExprBinder):
        for spec in self._sub_specs:
            n = spec["n"]
            bound = []
            pre = ir.Program()
            for (oexpr, _lbl) in spec["keys"]:
                e = binder.bind(oexpr)
                bound.append(e)
            if spec.get("neq"):
                self._attach_neq_spec(pipeline, spec, bound, binder, pre)
                continue
            if len(spec["keys"]) == 1:
                e = bound[0]
                if isinstance(e, ir.Col):
                    probe_key = e.name
                else:
                    probe_key = f"__s{n}p"
                    pre.assign(probe_key, e)
                if pre.commands:
                    pipeline.steps.append(("program", pre))
                build_key = spec["keys"][0][1]
                if spec["kind"] == "markpred":
                    # membership bit for a disjunctive predicate: a MARK
                    # join attaches `mark` = matched without filtering
                    # (the reference lowers ORed existence tests the
                    # same way before peephole, `dq_opt_join.cpp`)
                    js = JoinStep(spec["plan"], build_key, probe_key,
                                  "mark", [], mark_col=spec["mark"])
                elif spec["kind"] == "scalar":
                    js = JoinStep(spec["plan"], build_key, probe_key,
                                  "inner", list(spec["payload"]))
                else:
                    kind = "left_semi" if spec["kind"] == "semi" \
                        else "left_anti"
                    js = JoinStep(spec["plan"], build_key, probe_key, kind,
                                  [], anti_null_check=(kind == "left_anti"),
                                  not_in=(kind == "left_anti"
                                          and spec.get("not_in", False)))
                pipeline.steps.append(("join", js))
            else:
                # composite: hash-key mark join + per-key verification
                self._guard_composite_string_keys(
                    [o for (o, _lbl) in spec["keys"]])
                probe_key = f"__s{n}p"
                hashed = [ir.call("hash64", e) for e in bound]
                pre.assign(probe_key,
                           hashed[0] if len(hashed) == 1
                           else ir.call("hash_combine", *hashed))
                pipeline.steps.append(("program", pre))
                mark = f"__s{n}m"
                key_labels = [lbl for (_o, lbl) in spec["keys"]]
                not_in = spec["kind"] == "anti" and spec.get("not_in", False)
                js = JoinStep(spec["plan"], f"__s{n}bh", probe_key, "mark",
                              key_labels + list(spec["payload"]),
                              mark_col=mark,
                              build_hash_keys=key_labels,
                              # correlated NOT IN: a NULL build value poisons
                              # its whole per-key set — raise like the
                              # single-key path does
                              anti_null_check=not_in,
                              anti_null_col=key_labels[0] if not_in else "")
                pipeline.steps.append(("join", js))
                matched = ir.Col(mark)
                for e, lbl in zip(bound, key_labels):
                    matched = ir.call("and", matched,
                                      ir.call("eq", e, ir.Col(lbl)))
                if not_in:
                    self._attach_not_in_verify(pipeline, spec, bound,
                                               matched, n)
                    continue
                verify = ir.Program()
                if spec["kind"] == "anti":
                    verify.filter(ir.call("not", matched))
                else:          # semi or scalar
                    verify.filter(matched)
                pipeline.steps.append(("program", verify))

        if self._post_preds:
            prog = ir.Program()
            for p in self._post_preds:
                prog.filter(binder.bind(p))
            pipeline.steps.append(("program", prog))

    def _guard_composite_string_keys(self, outer_exprs) -> None:
        """Composite correlated keys hash raw per-table dictionary codes;
        a string key from another dictionary would silently mismatch —
        refuse loudly until remapping reaches these join shapes (the
        single-key and edge-join paths DO remap)."""
        for e in outer_exprs:
            if isinstance(e, ast.Name):
                b = self.scope.try_resolve(e.parts)
                if b is not None and b.dtype.is_string:
                    raise PlanError(
                        "multi-key correlated subqueries with string key "
                        "columns are not supported yet")

    def _attach_neq_spec(self, pipeline, spec, bound, binder, pre):
        """EXISTS / NOT EXISTS with a `col <> outer.col` correlation: mark
        join against the per-key min/max aggregate, then verify
        `min != outer OR max != outer` (coalesced to FALSE so NULL min/max
        — empty or all-NULL groups — read as 'no differing row')."""
        n = spec["n"]
        key_labels = [lbl for (_o, lbl) in spec["keys"]]
        mark = f"__s{n}m"
        if len(bound) == 1:
            e = bound[0]
            if isinstance(e, ir.Col):
                probe_key = e.name
            else:
                probe_key = f"__s{n}p"
                pre.assign(probe_key, e)
            if pre.commands:
                pipeline.steps.append(("program", pre))
            js = JoinStep(spec["plan"], key_labels[0], probe_key, "mark",
                          list(spec["payload"]), mark_col=mark)
            pipeline.steps.append(("join", js))
            matched = ir.Col(mark)
        else:
            self._guard_composite_string_keys(
                [o for (o, _lbl) in spec["keys"]])
            probe_key = f"__s{n}p"
            hashed = [ir.call("hash64", e) for e in bound]
            pre.assign(probe_key, hashed[0] if len(hashed) == 1
                       else ir.call("hash_combine", *hashed))
            pipeline.steps.append(("program", pre))
            js = JoinStep(spec["plan"], f"__s{n}bh", probe_key, "mark",
                          key_labels + list(spec["payload"]),
                          mark_col=mark, build_hash_keys=key_labels)
            pipeline.steps.append(("join", js))
            matched = ir.Col(mark)
            for e, lbl in zip(bound, key_labels):
                matched = ir.call("and", matched,
                                  ir.call("eq", e, ir.Col(lbl)))
        (neq_outer, mn, mx) = spec["neq"]
        o = binder.bind(neq_outer)
        differs = ir.call("or", ir.call("ne", ir.Col(mn), o),
                          ir.call("ne", ir.Col(mx), o))
        exists_true = ir.call(
            "coalesce", ir.call("and", matched, differs),
            ir.Const(False, dt.DType(dt.Kind.BOOL, False)))
        verify = ir.Program()
        verify.filter(exists_true if spec["kind"] == "semi"
                      else ir.call("not", exists_true))
        pipeline.steps.append(("program", verify))

    def _attach_not_in_verify(self, pipeline, spec, bound, matched, n):
        """Correlated NOT IN (composite-key mark join): `x NOT IN S_k` is
        NULL — row excluded — when x is NULL and the per-correlation-key
        set S_k is non-empty, but TRUE when S_k is empty. Emptiness is
        probed with a second mark join on the correlation keys alone;
        Kleene AND/OR then give keep = NOT matched AND
        (x IS NOT NULL OR NOT any_corr)."""
        # snapshot `matched` before the second join clobbers columns
        mcol = f"__s{n}mt"
        snap = ir.Program()
        snap.assign(mcol, matched)
        pipeline.steps.append(("program", snap))

        corr_bound = bound[1:]
        self._guard_composite_string_keys(
            [o for (o, _lbl) in spec["keys2"]])
        corr_labels = [lbl for (_o, lbl) in spec["keys2"]]
        probe2 = f"__s{n}p2"
        h2 = [ir.call("hash64", e) for e in corr_bound]
        pre2 = ir.Program()
        pre2.assign(probe2, h2[0] if len(h2) == 1
                    else ir.call("hash_combine", *h2))
        pipeline.steps.append(("program", pre2))
        mark2 = f"__s{n}m2"
        js2 = JoinStep(spec["plan2"], f"__s{n}bh2", probe2, "mark",
                       list(corr_labels), mark_col=mark2,
                       build_hash_keys=list(corr_labels))
        pipeline.steps.append(("join", js2))
        any_corr = ir.Col(mark2)
        for e, lbl in zip(corr_bound, corr_labels):
            any_corr = ir.call("and", any_corr,
                               ir.call("eq", e, ir.Col(lbl)))
        verify = ir.Program()
        verify.filter(ir.call(
            "and", ir.call("not", ir.Col(mcol)),
            ir.call("or", ir.call("is_not_null", bound[0]),
                    ir.call("not", any_corr))))
        pipeline.steps.append(("program", verify))

    # -- aggregation & projection ------------------------------------------

    def _plan_projection_agg(self, sel: ast.Select, plan: QueryPlan,
                             binder: B.ExprBinder) -> None:
        aggs: list = []
        for item in sel.items:
            if not isinstance(item.expr, ast.Star):
                walk_aggs(item.expr, aggs)
        if sel.having is not None:
            walk_aggs(sel.having, aggs)
        for o in sel.order_by:
            walk_aggs(o.expr, aggs)

        has_agg = bool(aggs) or bool(sel.group_by)

        # alias map for GROUP BY / ORDER BY references to select aliases
        alias_map = {item.alias: item.expr for item in sel.items if item.alias}

        def deref(e, positional=False, prefer_alias=False):
            """Select-alias substitution; `positional` additionally resolves
            bare integers as 1-based select positions (ORDER BY 1 / GROUP
            BY 1) and must only be used at the top level of those clauses —
            never recursively, or nested literals would be rewritten.
            `prefer_alias` (ORDER BY): a select alias shadows a source
            column of the same name (PostgreSQL rule: `sum(x) as x ...
            order by x` sorts the aggregate); GROUP BY keeps the source
            column."""
            if isinstance(e, ast.Name) and len(e.parts) == 1 \
                    and e.parts[0] in alias_map \
                    and (prefer_alias
                         or self.scope.try_resolve(e.parts) is None):
                return alias_map[e.parts[0]]
            if positional and isinstance(e, ast.Literal) \
                    and isinstance(e.value, int) and e.type_hint is None \
                    and 1 <= e.value <= len(sel.items):
                return sel.items[e.value - 1].expr
            return e

        if has_agg:
            self._plan_aggregate(sel, plan, binder, aggs, deref)
        else:
            self._plan_simple(sel, plan, binder, deref)

    def _plan_simple(self, sel: ast.Select, plan: QueryPlan,
                     binder: B.ExprBinder, deref) -> None:
        """No aggregation: compute outputs per block; final sort/limit."""
        prog = ir.Program()
        output = []
        out_names = []
        for i, item in enumerate(sel.items):
            if isinstance(item.expr, ast.Star):
                # pipeline out_names are demand-set derived (unordered);
                # emit * in schema-declaration order
                avail = set(plan.pipeline.out_names)
                names = [n for n in plan.star_order if n in avail] \
                    or plan.pipeline.out_names
                if item.expr.table is not None:
                    prefix = item.expr.table + "."
                    names = [n for n in names if n.startswith(prefix)]
                    if not names:
                        raise PlanError(
                            f"unknown table alias {item.expr.table!r} in "
                            f"{item.expr.table}.*")
                for name in names:
                    output.append((name, name.split(".", 1)[1]))
                    out_names.append(name)
                continue
            e = binder.bind(item.expr)
            label = item.alias or (
                item.expr.parts[-1] if isinstance(item.expr, ast.Name)
                else f"column{i}")
            if isinstance(e, ir.Col):
                name = e.name
            else:
                name = f"expr{i}"
                prog.assign(name, e)
                d = self._maybe_result_dict(e)
                if d is not None:
                    plan.result_dicts[name] = d
            output.append((name, label))
            out_names.append(name)

        uniq_outs = list(dict.fromkeys(out_names))
        if sel.distinct:
            # dedup per block, then globally; sort expressions are computed
            # after the final dedup (they would be dropped by the GroupBy)
            domains = self._key_domains(uniq_outs)
            dbound = self._groups_bound(domains)
            prog.group_by(uniq_outs, [], domains, out_bound=dbound)
            plan.pipeline.partial = prog
            final = ir.Program().group_by(uniq_outs, [], domains,
                                          out_bound=dbound)
            sort_keys, _extra = self._bind_sort(sel, binder.bind, out_names,
                                                final, alias_deref=deref)
            plan.final_program = final
        else:
            sort_keys, extra = self._bind_sort(sel, binder.bind, out_names,
                                               prog, alias_deref=deref)
            prog.project(list(dict.fromkeys(out_names + extra)))
            plan.pipeline.partial = prog
        plan.sort = sort_keys
        plan.limit, plan.offset = sel.limit, sel.offset
        plan.output = output

    def _plan_aggregate(self, sel: ast.Select, plan: QueryPlan,
                        binder: B.ExprBinder, agg_calls, deref) -> None:
        partial = ir.Program()
        # group keys
        key_specs = []     # (ast_expr, ir_expr, key_name)
        for i, ge in enumerate(sel.group_by):
            ge = deref(ge, positional=True)
            e = binder.bind(ge)
            if isinstance(e, ir.Col):
                name = e.name
            else:
                name = f"gk{i}"
                partial.assign(name, e)
                d = self._maybe_result_dict(e)
                if d is not None:
                    plan.result_dicts[name] = d
            key_specs.append((ge, e, name))
        key_names = [k[2] for k in key_specs]

        # DISTINCT aggregates: dedup by (group keys + arg) in the partial
        # and first-final GroupBys, then aggregate the arg in a second
        # final GroupBy over the group keys alone. All distinct aggs must
        # share one argument (one dedup dimension).
        distinct_calls = [c for c in agg_calls if c.distinct]
        dcol = None
        final2_aggs: list = []
        if distinct_calls:
            if any(c.star or not c.args for c in distinct_calls):
                raise PlanError("COUNT(DISTINCT *) is meaningless")
            args = {repr(c.args[0]) for c in distinct_calls}
            if len(args) != 1:
                raise PlanError("DISTINCT aggregates over different "
                                "arguments are not supported yet")
            d_ir = binder.bind(distinct_calls[0].args[0])
            if isinstance(d_ir, ir.Col):
                dcol = d_ir.name
            else:
                dcol = "__dx"
                partial.assign(dcol, d_ir)

        # aggregate instances (deduped by bound signature)
        agg_map: dict = {}          # signature -> dict describing partial/final
        partial_aggs: list = []
        final_aggs: list = []
        n = 0

        sealed = [False]

        string_agg_decodes: list = []
        string_rank_luts: dict = {}   # column name -> (rank col, inv param)

        def register(call: ast.FuncCall) -> dict:
            nonlocal n
            if call.distinct:
                sig = (call.name, "distinct", repr(call.args[0]))
                inst = agg_map.get(sig)
                if inst is not None:
                    return inst
                if sealed[0]:
                    raise PlanError(
                        f"aggregate {call.name} appeared only after the "
                        "partial stage was sealed (planner bug)")
                inst = {"func": call.name}
                if call.name == "avg":
                    s, c = f"agg{n}s", f"agg{n}c"; n += 1
                    final2_aggs.append(ir.Agg(s, "sum", dcol))
                    final2_aggs.append(ir.Agg(c, "count", dcol))
                    inst["sum"], inst["count"] = s, c
                else:
                    out = f"agg{n}"; n += 1
                    f = {"count": "count", "sum": "sum", "min": "min",
                         "max": "max"}.get(call.name)
                    if f is None:
                        raise PlanError(
                            f"DISTINCT {call.name} not supported")
                    final2_aggs.append(ir.Agg(out, f, dcol))
                    inst["col"] = out
                agg_map[sig] = inst
                return inst
            # dedup on the AST (bound IR is not stable: LUT params get
            # fresh names per binding)
            if call.star or not call.args:
                sig = ("count_all",)
            else:
                sig = (call.name, repr(call.args[0]))
            inst = agg_map.get(sig)
            if inst is not None:
                return inst
            if sealed[0]:
                raise PlanError(
                    f"aggregate {call.name} appeared only after the partial "
                    "stage was sealed (planner bug)")
            inst = {"func": call.name}
            if call.star or not call.args:
                out = f"agg{n}"; n += 1
                partial_aggs.append(ir.Agg(out, "count_all"))
                final_aggs.append(ir.Agg(out, "sum", out))
                inst["col"] = out
            else:
                arg_ir = binder.bind(call.args[0])
                arg_name = arg_ir.name if isinstance(arg_ir, ir.Col) else None
                if arg_name is None:
                    arg_name = f"aggarg{n}"
                    partial.assign(arg_name, arg_ir)
                if call.name == "avg":
                    s, c = f"agg{n}s", f"agg{n}c"; n += 1
                    partial_aggs.append(ir.Agg(s, "sum", arg_name))
                    partial_aggs.append(ir.Agg(c, "count", arg_name))
                    final_aggs.append(ir.Agg(s, "sum", s))
                    final_aggs.append(ir.Agg(c, "sum", c))
                    inst["sum"], inst["count"] = s, c
                elif call.name == "count":
                    out = f"agg{n}"; n += 1
                    partial_aggs.append(ir.Agg(out, "count", arg_name))
                    final_aggs.append(ir.Agg(out, "sum", out))
                    inst["col"] = out
                elif call.name in ("min", "max") and isinstance(
                        arg_ir, ir.Col) and self._string_dict(arg_ir.name):
                    # lexicographic MIN/MAX over a dictionary-coded string:
                    # aggregate the code's lexicographic RANK (plan-time
                    # LUT — the plan cache keys on data_version, so the
                    # dictionary snapshot stays valid), then map the
                    # winning rank back to a code in the final stage
                    dic = self._string_dict(arg_ir.name)
                    i32 = dt.DType(dt.Kind.INT32, False)
                    # the inverse LUT holds string CODES — typing it as
                    # STRING makes the decoded column a real string
                    # (codes + dictionary) through schema inference
                    sstr = dt.DType(dt.Kind.STRING, False)
                    cached = string_rank_luts.get(arg_ir.name)
                    if cached is None:
                        vals = dic.values_array()
                        order = np.argsort(vals) if len(vals) else None
                        ranks = (np.argsort(order).astype(np.int32)
                                 if order is not None
                                 else np.zeros(1, np.int32))
                        inv = (order.astype(np.int32) if order is not None
                               else np.zeros(1, np.int32))
                        rp, ip = f"__aggrank{n}", f"__agginv{n}"
                        plan.params[rp] = ranks
                        plan.params[ip] = inv
                        rank_col = f"aggarg{n}"
                        partial.assign(rank_col, ir.call(
                            "take_lut", arg_ir, ir.Param(rp, i32,
                                                         is_array=True)))
                        cached = (rank_col, ip)
                        string_rank_luts[arg_ir.name] = cached
                    rank_col, ip = cached
                    out = f"agg{n}"; n += 1
                    partial_aggs.append(ir.Agg(out, call.name, rank_col))
                    final_aggs.append(ir.Agg(out, call.name, out))
                    dec = f"{out}dec"
                    string_agg_decodes.append(
                        (dec, ir.call("take_lut", ir.Col(out),
                                      ir.Param(ip, sstr, is_array=True))))
                    plan.result_dicts[dec] = dic
                    inst["col"] = dec
                elif call.name in ("sum", "min", "max", "some"):
                    out = f"agg{n}"; n += 1
                    f = call.name
                    partial_aggs.append(ir.Agg(out, f, arg_name))
                    final_aggs.append(ir.Agg(out, "sum" if f == "sum" else f, out))
                    inst["col"] = out
                else:
                    raise PlanError(f"aggregate {call.name} not supported")
            agg_map[sig] = inst
            return inst

        for call in agg_calls:
            register(call)

        domains = self._key_domains(key_names)
        gbound = self._groups_bound(domains)
        sealed[0] = True
        if dcol is None:
            partial.group_by(key_names, partial_aggs, domains,
                             out_bound=gbound)
            plan.pipeline.partial = partial
            # -- final stage: merge aggs, having, outputs, sort -----------
            final = ir.Program().group_by(key_names, final_aggs, domains,
                                          out_bound=gbound)
            for (dec, expr) in string_agg_decodes:
                final.assign(dec, expr)
        else:
            ddom = self._key_domains([dcol])
            dbound = self._groups_bound(domains + ddom)
            partial.group_by(key_names + [dcol], partial_aggs,
                             domains + ddom, out_bound=dbound)
            plan.pipeline.partial = partial
            # first final GroupBy completes the global dedup by
            # (keys + arg); the second collapses to the group keys, counting
            # the deduplicated arg and re-merging the regular aggregates
            # (associative, so the double merge is exact)
            final = ir.Program().group_by(key_names + [dcol], final_aggs,
                                          domains + ddom, out_bound=dbound)
            final.group_by(
                key_names,
                [ir.Agg(a.out, a.func, a.out) for a in final_aggs]
                + final2_aggs, domains, out_bound=gbound)
            for (dec, expr) in string_agg_decodes:
                final.assign(dec, expr)

        planner = self

        class GroupBinder(B.ExprBinder):
            def bind(self, e):
                e = deref(e)
                # whole-expression match against a group key
                try:
                    be = binder.bind(e)
                except B.BindError:
                    be = None
                if be is not None:
                    for (_ge, ire, name) in key_specs:
                        if be == ire:
                            return ir.Col(name)
                if isinstance(e, ast.FuncCall) and e.name in B.AGG_NAMES:
                    inst = register(e)
                    if e.name == "avg":
                        return ir.call("div", ir.Col(inst["sum"]),
                                       ir.Col(inst["count"]))
                    return ir.Col(inst["col"])
                return super().bind(e)

        gbinder = GroupBinder(self.scope, self.pool)

        if sel.having is not None:
            final.filter(gbinder.bind(sel.having))

        output = []
        out_names = []
        for i, item in enumerate(sel.items):
            if isinstance(item.expr, ast.Star):
                raise PlanError("* with GROUP BY")
            e = gbinder.bind(item.expr)
            label = item.alias or (
                item.expr.parts[-1] if isinstance(item.expr, ast.Name)
                else f"column{i}")
            if isinstance(e, ir.Col):
                name = e.name
            else:
                name = f"out{i}"
                final.assign(name, e)
                d = self._maybe_result_dict(e)
                if d is not None:
                    plan.result_dicts[name] = d
            output.append((name, label))
            out_names.append(name)

        sort_keys, extra = self._bind_sort(sel, gbinder.bind, out_names, final,
                                           alias_deref=deref)
        final.project(list(dict.fromkeys(out_names + extra)))
        plan.final_program = final
        plan.sort = sort_keys
        plan.limit, plan.offset = sel.limit, sel.offset
        plan.output = output

    def _maybe_result_dict(self, e) -> object:
        """Dictionary of a derived string expression (take_lut through a
        pool param), or the source column's dictionary for plain columns."""
        d = getattr(self.pool, "expr_dicts", None)
        if d is not None and id(e) in d:
            return d[id(e)]
        if isinstance(e, ir.Call) and e.op == "take_lut" \
                and len(e.args) == 2 and isinstance(e.args[1], ir.Param):
            return self.pool.param_dicts.get(e.args[1].name)
        if isinstance(e, ir.Call) and e.op in ("if", "coalesce"):
            # string CASE: every string branch encodes into one shared
            # derived dictionary (binder._maybe_string_case); branches from
            # DIFFERENT dictionaries would decode through the wrong one
            found = {id(x): x for x in
                     (self._maybe_result_dict(a) for a in e.args)
                     if x is not None}
            if len(found) > 1:
                raise PlanError("string branches of if/coalesce come from "
                                "different dictionaries")
            if found:
                return next(iter(found.values()))
        return None

    def _string_dict(self, name: str):
        """The dictionary of a string scan column (None otherwise)."""
        b = self.scope.by_internal(name)
        if b is not None and b.dtype.is_string and b.dictionary is not None:
            return b.dictionary
        return None

    @staticmethod
    def _groups_bound(domains: tuple) -> int:
        """Guaranteed ngroups upper bound from bounded key domains: the
        mixed-radix bucket count prod(domain+1) (each key contributes its
        domain plus the NULL slot). Feeds `ir.GroupBy.out_bound` so the
        sorted lowering late-materializes per-group gathers at output
        cardinality when the bounded product overflows the scatter paths
        (multi-string-key group-bys, q16-class). 0 = no guarantee (any
        unbounded key, or a product too large to ever matter)."""
        bound = 1
        for d in domains:
            if d <= 0:
                return 0
            bound *= d + 1
            if bound > (1 << 40):
                return 0
        return bound

    def _key_domains(self, key_names: list) -> tuple:
        """Static key-domain sizes for the scatter aggregation path:
        dictionary-coded strings (len(dict)) and bools (2); 0 = unbounded.
        Domains snapshot the dictionary size at plan time — plans are built
        per query, so codes cannot exceed them during execution."""
        from ydb_tpu_torch.core.dtypes import Kind
        domains = []
        for name in key_names:
            b = self.scope.by_internal(name)
            if b is None:
                domains.append(0)
            elif b.dtype.is_string and b.dictionary is not None:
                domains.append(max(len(b.dictionary), 1))
            elif b.dtype.kind is Kind.BOOL:
                domains.append(2)
            else:
                domains.append(0)
        return tuple(domains)

    def _bind_sort(self, sel, bind_fn, out_names: list, prog: ir.Program,
                   alias_deref) -> tuple[list, list]:
        sort_keys: list = []
        extra: list = []
        for j, o in enumerate(sel.order_by):
            e = bind_fn(alias_deref(o.expr, positional=True,
                                    prefer_alias=True))
            if isinstance(e, ir.Col):
                name = e.name
                extra.append(name)     # keep through the output projection
            else:
                name = f"sort{j}"
                prog.assign(name, e)
                extra.append(name)
            nf = o.nulls_first
            if nf is None:
                nf = o.ascending       # YQL: NULL is smallest
            sort_keys.append(SortKey(name, o.ascending, nf))
        return sort_keys, extra
