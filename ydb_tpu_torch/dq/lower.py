"""SELECT AST + shard topology → StageGraph (the planner lowering pass).

This subsumes the router's former per-shape rewrites — scatter/merge
aggregation, two-level distinct, order/limit scatter scans and the
sharded×sharded shuffle join each used to be a bespoke code path in
`cluster/router.py`; they are now *lowerings* producing one StageGraph
executed by one runner (`dq/runner.py`), the way the reference builds
every distributed plan through `dq_tasks_graph.h` stage builders:

  * no sharded table      → single task on one worker, result collected
                            (replicated copies must not double-count);
  * one sharded table     → partial stage per worker —union_all→ router
                            merge stage (sum→sum, count→sum, avg→sum+
                            count; two-level COUNT(DISTINCT));
  * two sharded tables    → scan stage per side —hash_shuffle(key)→
                            co-partitioned join+partial stage —union_all→
                            router merge (the ShuffleJoin connection);
  * non-aggregating       → limit-pushdown scan stage —merge→ router
                            order/limit tail.

The same aggregate decomposition (`AggCollector`) serves every shape.
"""

from __future__ import annotations

import dataclasses
import uuid
from dataclasses import dataclass, field

from ydb_tpu_torch.dq.graph import (DQ_TMP_PREFIX, HASH_SHUFFLE, INPUT_TABLE,
                              MERGE, PLANE_ICI, UNION_ALL, Channel,
                              Stage, StageGraph)
from ydb_tpu_torch.sql import ast, render

AGGS = ("sum", "count", "min", "max", "avg")

# aggregates whose inputs tolerate bounded per-value error (a final
# reduction absorbs it — the EQuARX stance): their argument columns may
# block-quantize on the ICI plane. COUNT/MIN/MAX do NOT qualify: count
# ignores values but min/max REPORT one, and a quantized extremum would
# surface verbatim in the result
TOLERANT_AGGS = ("sum", "avg")


def plane_mode() -> str:
    """The `YDB_TPU_DQ_PLANE` lever: `auto` (ICI where both endpoints
    share a mesh), `host` (force gRPC frames everywhere — the byte-equal
    escape hatch), `ici` (refuse to lower rather than fall back)."""
    import os
    mode = (os.environ.get("YDB_TPU_DQ_PLANE", "auto").strip().lower()
            or "auto")
    if mode not in ("auto", "host", "ici"):
        raise DqLowerError(f"YDB_TPU_DQ_PLANE={mode!r} — expected "
                           "auto | host | ici")
    return mode


class DqLowerError(Exception):
    """Statement shape not lowerable to a distributed stage graph."""


@dataclass
class DqTopology:
    """What the lowering needs to know about the cluster. With a Hive
    attached (`from_hive`), the worker count comes from the CURRENT
    placement — alive, non-stale shard owners — instead of a static
    endpoint list, and the graph is stamped with the placement epoch it
    was lowered against (a failed run re-lowers against the next one)."""
    n_workers: int
    replicated: set = field(default_factory=set)
    key_columns: dict = field(default_factory=dict)  # sharded: table -> pk
    placement_epoch: int = 0
    # devices of ONE JAX mesh the runner can drive directly (0 = workers
    # are separate OS processes — no shared mesh, host plane only). Set
    # by the router when every worker is in-process and the process
    # exposes at least n_workers devices: that is the "both endpoints on
    # the same mesh" condition the ICI plane needs.
    ici_devices: int = 0

    @property
    def ici_capable(self) -> bool:
        return 2 <= self.n_workers <= self.ici_devices

    @classmethod
    def from_hive(cls, hive, replicated=(), key_columns=None,
                  ici_devices: int = 0) -> "DqTopology":
        orphans = hive.orphaned_shards()
        if orphans:
            # refusing beats silently returning a partial scan: these
            # shards' rows are unreachable until a re-placement (sweep
            # retries the image replay) or an operator intervenes
            raise DqLowerError(
                f"shard(s) {orphans} have no live owner — re-placement "
                "pending or failed; refusing a silently-partial scan")
        eps = hive.query_endpoints()
        if not eps:
            raise DqLowerError(
                "no alive shard-owning workers in the Hive placement — "
                "the cluster has no queryable topology")
        return cls(n_workers=len(eps), replicated=set(replicated),
                   key_columns=dict(key_columns or {}),
                   placement_epoch=hive.epoch,
                   ici_devices=int(ici_devices))


# -- AST helpers (moved from cluster/router.py — shared by lowerings) ------


class AggCollector:
    """Collect distinct aggregate calls in an expression tree and the
    substitution from each call to its merge-side expression."""

    def __init__(self):
        self.partial_items: list = []     # [(alias, ast expr)]
        self.merge_map: dict = {}         # FuncCall -> merge expr (ast)
        self.has_distinct = False         # seen a DISTINCT aggregate
        self._n = 0

    def _alias(self) -> str:
        self._n += 1
        return f"__a{self._n}"

    def visit(self, e):
        if isinstance(e, ast.FuncCall) and e.name in AGGS:
            if e in self.merge_map:
                return
            if e.distinct:
                # recorded, not raised: detection passes (has_agg) walk
                # the same tree; only actual decomposition refuses
                self.has_distinct = True
                return
            if e.name == "avg":
                a_s, a_c = self._alias(), self._alias()
                self.partial_items.append(
                    (a_s, ast.FuncCall("sum", e.args)))
                self.partial_items.append(
                    (a_c, ast.FuncCall("count", e.args)))
                self.merge_map[e] = ast.BinOp(
                    "/",
                    ast.FuncCall("sum", (ast.Name((a_s,)),)),
                    ast.FuncCall("sum", (ast.Name((a_c,)),)))
                return
            a = self._alias()
            self.partial_items.append((a, e))
            merge_fn = {"sum": "sum", "count": "sum",
                        "min": "min", "max": "max"}[e.name]
            self.merge_map[e] = ast.FuncCall(merge_fn, (ast.Name((a,)),))
            return
        for f in getattr(e, "__dataclass_fields__", ()):
            v = getattr(e, f)
            if isinstance(v, tuple):
                for x in v:
                    if hasattr(x, "__dataclass_fields__"):
                        self.visit(x)
            elif hasattr(v, "__dataclass_fields__"):
                self.visit(v)


def substitute(e, mapping: dict):
    """Replace subtrees by the mapping (dataclass equality), recursively."""
    if e in mapping:
        return mapping[e]
    if not hasattr(e, "__dataclass_fields__"):
        return e

    def rw(v):
        if isinstance(v, tuple):
            return tuple(rw(x) for x in v)
        if hasattr(v, "__dataclass_fields__"):
            return substitute(v, mapping)
        return v
    try:
        return dataclasses.replace(
            e, **{f: rw(getattr(e, f)) for f in e.__dataclass_fields__})
    except TypeError:
        return e


def has_agg(sel: ast.Select) -> bool:
    c = AggCollector()
    for it in sel.items:
        c.visit(it.expr)
    if sel.having is not None:
        c.visit(sel.having)
    return bool(c.merge_map) or c.has_distinct or bool(sel.group_by)


def contains_subquery(node) -> bool:
    """Any nested SELECT (CTE, derived table, IN/EXISTS/scalar subquery):
    shipping those verbatim would compute their aggregates shard-locally
    — silently wrong — so the lowering refuses them."""
    if isinstance(node, (ast.InSubquery, ast.Exists, ast.ScalarSubquery,
                         ast.SubqueryRef)):
        return True
    if isinstance(node, ast.Select) and node.ctes:
        return True
    for fname in getattr(node, "__dataclass_fields__", ()):
        v = getattr(node, fname)
        vs = v if isinstance(v, (tuple, list)) else (v,)
        for x in vs:
            if isinstance(x, tuple):
                if any(contains_subquery(y) for y in x
                       if hasattr(y, "__dataclass_fields__")):
                    return True
            elif hasattr(x, "__dataclass_fields__") \
                    and contains_subquery(x):
                return True
    return False


def table_names(rel) -> list:
    if isinstance(rel, ast.TableRef):
        return [rel.name]
    if isinstance(rel, ast.Join):
        return table_names(rel.left) + table_names(rel.right)
    return []


def has_outer_join(rel) -> bool:
    if isinstance(rel, ast.Join):
        return (rel.kind not in ("inner", "cross")
                or has_outer_join(rel.left) or has_outer_join(rel.right))
    return False


def relation_binds(rel) -> dict:
    """FROM bindings: {bind name (alias or table): table name}."""
    out: dict = {}
    if isinstance(rel, ast.TableRef):
        out[rel.alias or rel.name] = rel.name
    elif isinstance(rel, ast.Join):
        out.update(relation_binds(rel.left))
        out.update(relation_binds(rel.right))
    return out


def collect_names(node, out=None) -> list:
    if out is None:
        out = []
    if isinstance(node, ast.Name):
        out.append(node.parts)
        return out
    for f in getattr(node, "__dataclass_fields__", ()):
        v = getattr(node, f)
        vs = v if isinstance(v, (tuple, list)) else (v,)
        for x in vs:
            if isinstance(x, tuple):
                for y in x:
                    if hasattr(y, "__dataclass_fields__"):
                        collect_names(y, out)
            elif hasattr(x, "__dataclass_fields__"):
                collect_names(x, out)
    return out


def attribute(parts: tuple, binds: dict, table_cols: dict):
    """Which TABLE a column reference binds to (None = unresolvable)."""
    if len(parts) == 2:
        return binds.get(parts[0])
    hits = [t for t in set(binds.values())
            if parts[-1] in table_cols.get(t, ())]
    if len(hits) == 1:
        return hits[0]
    if len(hits) > 1:
        raise DqLowerError(f"ambiguous column {parts[-1]!r} across "
                           f"{sorted(hits)} — qualify it")
    return None


def conjuncts(e) -> list:
    if e is None:
        return []
    if isinstance(e, ast.BinOp) and e.op == "and":
        return conjuncts(e.left) + conjuncts(e.right)
    return [e]


def join_ons(rel) -> list:
    if isinstance(rel, ast.Join):
        return (conjuncts(rel.on) + join_ons(rel.left)
                + join_ons(rel.right))
    return []


def expr_tables(e, binds: dict, table_cols: dict) -> set:
    out = set()
    for parts in collect_names(e):
        t = attribute(parts, binds, table_cols)
        if t is not None:
            out.add(t)
    return out


def only_tables(e, allowed: set, binds: dict, table_cols: dict) -> bool:
    ts = expr_tables(e, binds, table_cols)
    return bool(ts) and ts <= allowed


def cross_equality(e, a: str, b: str, binds: dict, table_cols: dict):
    """`A.x = B.y` (either orientation) → (x, y); else None."""
    if not (isinstance(e, ast.BinOp) and e.op == "="
            and isinstance(e.left, ast.Name)
            and isinstance(e.right, ast.Name)):
        return None
    lt = attribute(e.left.parts, binds, table_cols)
    rt = attribute(e.right.parts, binds, table_cols)
    if lt == a and rt == b:
        return (e.left.parts[-1], e.right.parts[-1])
    if lt == b and rt == a:
        return (e.right.parts[-1], e.left.parts[-1])
    return None


def split_name_contexts(node, exact: list, tolerant: list,
                        in_tolerant: bool = False) -> None:
    """Collect column references by usage context: inside a SUM/AVG
    argument (`tolerant` — a final reduction absorbs bounded per-value
    error) vs anywhere else (`exact` — keys, group-bys, filters,
    COUNT/MIN/MAX args, ORDER BY). The quantization planner only trusts
    a column that NEVER appears in an exact context."""
    if isinstance(node, ast.Name):
        (tolerant if in_tolerant else exact).append(node.parts)
        return
    if isinstance(node, ast.FuncCall) and node.name in AGGS:
        inner = node.name in TOLERANT_AGGS and not node.distinct
        for a in node.args:
            if hasattr(a, "__dataclass_fields__"):
                split_name_contexts(a, exact, tolerant, inner)
        return
    for f in getattr(node, "__dataclass_fields__", ()):
        v = getattr(node, f)
        vs = v if isinstance(v, (tuple, list)) else (v,)
        for x in vs:
            if isinstance(x, tuple):
                for y in x:
                    if hasattr(y, "__dataclass_fields__"):
                        split_name_contexts(y, exact, tolerant,
                                            in_tolerant)
            elif hasattr(x, "__dataclass_fields__"):
                split_name_contexts(x, exact, tolerant, in_tolerant)


def rewrite_relation(rel, temp_of: dict):
    """Swap sharded TableRefs for their shuffle-temp names, keeping the
    original bind name as the alias so every column reference resolves
    unchanged."""
    if isinstance(rel, ast.TableRef):
        if rel.name in temp_of:
            return ast.TableRef(temp_of[rel.name],
                                rel.alias or rel.name)
        return rel
    if isinstance(rel, ast.Join):
        return dataclasses.replace(
            rel, left=rewrite_relation(rel.left, temp_of),
            right=rewrite_relation(rel.right, temp_of))
    return rel


# -- lowering --------------------------------------------------------------


class _Builder:
    def __init__(self, tag: str):
        self.tag = tag
        self.stages: list = []
        self.channels: dict = {}
        self._n = 0

    def channel(self, kind: str, src: str, dst: str = "", key: str = "",
                columns=None, table: str = "") -> Channel:
        self._n += 1
        ch = Channel(id=f"dqc_{self.tag}_{self._n}", kind=kind,
                     src_stage=src, dst_stage=dst, key=key,
                     columns=list(columns or []), table=table)
        self.channels[ch.id] = ch
        return ch

    def graph(self) -> StageGraph:
        g = StageGraph(stages=self.stages, channels=self.channels,
                       tag=self.tag)
        g.validate()
        return g


def lower_select(sel: ast.Select, topo: DqTopology,
                 table_cols) -> StageGraph:
    """Lower one SELECT to a StageGraph. `table_cols(table)` resolves a
    table's column names (catalog schemas in-process, an RPC schema probe
    on the router)."""
    from ydb_tpu_torch.query.window import has_window
    if not isinstance(sel, ast.Select):
        raise DqLowerError("only SELECT lowers to a stage graph")
    if has_window(sel):
        raise DqLowerError("window functions are not distributable over "
                           "shards yet (per-shard windows would be "
                           "silently wrong)")
    if contains_subquery(sel):
        raise DqLowerError("CTEs/subqueries are not distributable over "
                           "shards yet (their aggregates would compute "
                           "shard-locally)")
    b = _Builder(uuid.uuid4().hex[:10])
    tables = set(table_names(sel.relation))
    unknown = sorted(t for t in tables if t not in topo.replicated
                     and t not in topo.key_columns)
    if unknown:
        # ambiguous distribution must refuse, not guess: assuming
        # replicated would run one worker's shard (missing rows);
        # assuming sharded would N-fold overcount a replicated copy
        raise DqLowerError(
            f"unknown distribution for table(s) {unknown} — register "
            "them in key_columns (sharded) or replicated before "
            "distributing")
    sharded = sorted({n for n in tables
                      if n not in topo.replicated
                      and n in topo.key_columns})
    if len(sharded) > 2:
        raise DqLowerError(
            f"joining {len(sharded)} sharded tables ({sharded}) is not "
            "supported yet — at most two shuffle; create dimensions with "
            "replicated=True")
    if len(sharded) == 2:
        final_sel, scan_channels = _lower_shuffle_scans(b, sel, sharded,
                                                        table_cols)
        _lower_two_phase(b, final_sel, inputs=scan_channels)
    elif not sharded:
        # every referenced table is replicated: run the whole statement
        # as ONE task on one worker — scattering over N full copies would
        # double-count every aggregate N times
        s = Stage(id=f"s{len(b.stages)}", sql=render.select(sel),
                  on="worker0")
        ch = b.channel(UNION_ALL, src=s.id)
        s.outputs = [ch.id]
        b.stages.append(s)
        b.stages.append(Stage(id="merge", inputs=[ch.id], on="router"))
    else:
        _lower_two_phase(b, sel, inputs=[])
    g = b.graph()
    g.placement_epoch = topo.placement_epoch
    _assign_planes(g, topo)
    return g


def _assign_planes(g: StageGraph, topo: DqTopology) -> None:
    """Pick each channel's data plane. Worker-bound edges (both
    endpoints are worker tasks) go device-resident when the topology
    says every worker sits on one JAX mesh; router-bound edges always
    collect over the host plane. `YDB_TPU_DQ_PLANE` overrides."""
    mode = plane_mode()
    if mode == "host":
        return                         # default plane on every channel
    if mode == "ici" and not topo.ici_capable:
        raise DqLowerError(
            f"YDB_TPU_DQ_PLANE=ici but the topology is not "
            f"device-colocated ({topo.n_workers} worker(s), "
            f"{topo.ici_devices} mesh device(s)) — the ICI plane needs "
            "every worker on one JAX mesh")
    if not topo.ici_capable:
        return
    for ch in g.channels.values():
        if not ch.router_bound:
            ch.plane = PLANE_ICI


def _lower_two_phase(b: _Builder, sel: ast.Select, inputs: list) -> None:
    if has_agg(sel):
        if _lower_count_distinct(b, sel, inputs):
            return
        _lower_agg(b, sel, inputs)
    else:
        _lower_scan(b, sel, inputs)


def _label(it: ast.SelectItem, i: int) -> str:
    if it.alias:
        return it.alias
    if isinstance(it.expr, ast.Name):          # single-node naming
        return it.expr.parts[-1]
    return f"column{i}"


def _lower_agg(b: _Builder, sel: ast.Select, inputs: list) -> None:
    """Partial/merge aggregation split (sum→sum, count→sum, avg→sum+count,
    min/max→min/max) — the BlockCombineHashed → BlockMergeFinalizeHashed
    boundary expressed as a UnionAll edge."""
    if sel.distinct or sel.ctes:
        raise DqLowerError("DISTINCT/CTE SELECTs are not distributable "
                           "over shards yet")
    col = AggCollector()
    for it in sel.items:
        col.visit(it.expr)
    if sel.having is not None:
        col.visit(sel.having)
    for o in sel.order_by:
        col.visit(o.expr)
    if col.has_distinct:
        # the distinct-only shape was handled by _lower_count_distinct;
        # mixtures of DISTINCT and plain aggregates need a per-agg plan
        raise DqLowerError(
            "mixing DISTINCT aggregates with other aggregates is not "
            "distributable over shards yet")

    gmap = {}
    gitems = []
    for i, g in enumerate(sel.group_by):
        a = f"__g{i}"
        gmap[g] = ast.Name((a,))
        gitems.append(ast.SelectItem(g, a))
    items = gitems + [ast.SelectItem(e, a)
                      for (a, e) in col.partial_items]
    worker_sel = ast.Select(
        items=items, relation=sel.relation, where=sel.where,
        group_by=list(sel.group_by), ctes=list(sel.ctes))

    sub = {**col.merge_map, **gmap}
    mitems = [ast.SelectItem(substitute(it.expr, sub), _label(it, i))
              for i, it in enumerate(sel.items)]
    morder = [dataclasses.replace(o, expr=substitute(o.expr, sub))
              for o in sel.order_by]
    mhaving = substitute(sel.having, sub) \
        if sel.having is not None else None
    merge_sel = ast.Select(
        items=mitems, relation=ast.TableRef(INPUT_TABLE),
        group_by=[gmap[g] for g in sel.group_by], having=mhaving,
        order_by=morder, limit=sel.limit, offset=sel.offset)

    s = Stage(id=f"s{len(b.stages)}", sql=render.select(worker_sel),
              inputs=list(inputs))
    for cid in inputs:
        b.channels[cid].dst_stage = s.id
    ch = b.channel(UNION_ALL, src=s.id)
    s.outputs = [ch.id]
    b.stages.append(s)
    # the merge GROUP BY re-plans through the router engine and therefore
    # rides the same tiled/late-materialized sorted group-by as every
    # statement (its key domains come from the landed temp table's
    # dictionaries) — marked so the runner counts it on /counters
    b.stages.append(Stage(id="merge", inputs=[ch.id], on="router",
                          merge_sel=merge_sel,
                          groupby_merge=bool(sel.group_by)))


def _lower_count_distinct(b: _Builder, sel: ast.Select,
                          inputs: list) -> bool:
    """COUNT(DISTINCT x) distribution (the two-level distinct shuffle):
    supported when every aggregate is a distinct count — workers emit
    SELECT DISTINCT keys+args, the merge dedups and counts. Returns False
    when the shape doesn't apply."""
    aggs = []
    for it in sel.items:
        if isinstance(it.expr, ast.FuncCall) and it.expr.name in AGGS:
            if not (it.expr.name == "count" and it.expr.distinct):
                return False
            aggs.append(it)
        elif it.expr not in sel.group_by:
            return False
    if not aggs:
        return False
    gitems = [ast.SelectItem(g, f"__g{i}")
              for i, g in enumerate(sel.group_by)]
    ditems = [ast.SelectItem(a.expr.args[0], f"__d{k}")
              for k, a in enumerate(aggs)]
    worker_sel = ast.Select(items=gitems + ditems, relation=sel.relation,
                            where=sel.where, distinct=True)
    gmap = {g: ast.Name((f"__g{i}",))
            for i, g in enumerate(sel.group_by)}
    mitems, k = [], 0
    for i, it in enumerate(sel.items):
        if it in aggs:
            e = ast.FuncCall("count", (ast.Name((f"__d{k}",)),),
                             distinct=True)
            k += 1
        else:
            e = substitute(it.expr, gmap)
        mitems.append(ast.SelectItem(e, _label(it, i)))
    morder = [dataclasses.replace(o, expr=substitute(o.expr, gmap))
              for o in sel.order_by]
    merge_sel = ast.Select(
        items=mitems, relation=ast.TableRef(INPUT_TABLE),
        group_by=[gmap[g] for g in sel.group_by], order_by=morder,
        limit=sel.limit, offset=sel.offset)

    s = Stage(id=f"s{len(b.stages)}", sql=render.select(worker_sel),
              inputs=list(inputs))
    for cid in inputs:
        b.channels[cid].dst_stage = s.id
    ch = b.channel(UNION_ALL, src=s.id)
    s.outputs = [ch.id]
    b.stages.append(s)
    # cross-shard duplicate rows shrink before the merge aggregation;
    # the distinct-count merge is a group-by merge like _lower_agg's
    b.stages.append(Stage(id="merge", inputs=[ch.id], on="router",
                          merge_sel=merge_sel, dedup_input=True,
                          groupby_merge=True))
    return True


def _lower_scan(b: _Builder, sel: ast.Select, inputs: list) -> None:
    """Non-aggregating scatter: limit+offset push down per worker; the
    router stage re-sorts the union and applies the final slice."""
    lim = None if sel.limit is None else sel.limit + (sel.offset or 0)
    worker_sel = dataclasses.replace(sel, limit=lim, offset=None)
    # ORDER BY the pre-alias expression: rewrite to the output alias
    # (the router merge sorts the gathered frame by column name)
    alias_of = {it.expr: it.alias for it in sel.items if it.alias}
    order = [dataclasses.replace(o, expr=ast.Name((alias_of[o.expr],)))
             if o.expr in alias_of else o for o in sel.order_by]

    s = Stage(id=f"s{len(b.stages)}", sql=render.select(worker_sel),
              inputs=list(inputs))
    for cid in inputs:
        b.channels[cid].dst_stage = s.id
    ch = b.channel(MERGE if sel.order_by else UNION_ALL, src=s.id)
    # bounds lattice: the pushed-down LIMIT bounds every producer's
    # output rows on this channel
    if lim is not None:
        ch.out_bound = int(lim)
    s.outputs = [ch.id]
    b.stages.append(s)
    b.stages.append(Stage(
        id="merge", inputs=[ch.id], on="router",
        post={"distinct": sel.distinct, "order": order,
              "limit": sel.limit, "offset": sel.offset}))


def _lower_shuffle_scans(b: _Builder, sel: ast.Select, sharded: list,
                         table_cols):
    """Two sharded tables: emit one projection/scan stage per side whose
    output hash-shuffles on the join key, so the downstream stage joins
    co-partitioned rows worker-locally (`dq_opt_join.cpp` ShuffleJoin —
    neither worker ever holds the other's shard set). Returns the
    relation-rewritten SELECT for the downstream stage plus the two
    shuffle channel ids."""
    if any(isinstance(it.expr, ast.Star) for it in sel.items):
        raise DqLowerError("SELECT * is not supported in a shuffle join "
                           "— name the columns")
    if has_outer_join(sel.relation):
        # the shuffle drops NULL join keys (inner semantics); a LEFT/FULL
        # join would silently lose its NULL-extended rows
        raise DqLowerError("outer joins between two sharded tables are "
                           "not supported yet (inner only)")
    binds = relation_binds(sel.relation)          # bind name -> table
    cols = {t: table_cols(t) for t in set(binds.values())}
    refs = collect_names(sel)
    used: dict = {t: set() for t in binds.values()}
    for parts in refs:
        t = attribute(parts, binds, cols)
        if t is not None:
            used[t].add(parts[-1])

    # join key: the first WHERE/ON equality linking the two sharded
    # tables (additional equalities stay as local filters — rows
    # co-partitioned by the first key still satisfy them locally)
    conjs = conjuncts(sel.where) + join_ons(sel.relation)
    a, bt = sharded
    key_a = key_b = None
    for c in conjs:
        pair = cross_equality(c, a, bt, binds, cols)
        if pair is not None:
            key_a, key_b = pair
            break
    if key_a is None:
        raise DqLowerError(
            f"no equality join condition between sharded tables {a!r} "
            f"and {bt!r} — a cross join cannot shuffle")
    used[a].add(key_a)
    used[bt].add(key_b)

    # quantization proof: a shipped column is aggregation-tolerant iff
    # EVERY reference to it sits inside a SUM/AVG argument — those feed
    # a final reduction that absorbs the per-value quant error. Keys,
    # group-bys, filters and COUNT/MIN/MAX inputs must cross exact.
    exact_refs: list = []
    tol_refs: list = []
    split_name_contexts(sel, exact_refs, tol_refs)
    exact_cols: dict = {t: set() for t in binds.values()}
    tol_cols: dict = {t: set() for t in binds.values()}
    for refs, bucket in ((exact_refs, exact_cols), (tol_refs, tol_cols)):
        for parts in refs:
            t = attribute(parts, binds, cols)
            if t is not None:
                bucket[t].add(parts[-1])

    temp_of = {t: f"{DQ_TMP_PREFIX}{b.tag}_{t}" for t in sharded}
    channels = []
    for t, key in ((a, key_a), (bt, key_b)):
        alias = next(al for al, tbl in binds.items() if tbl == t)
        local = [c for c in conjuncts(sel.where)
                 if only_tables(c, {t}, binds, cols)]
        where = None
        for c in local:
            where = c if where is None else ast.BinOp("and", where, c)
        items = [ast.SelectItem(ast.Name((alias, col)), col)
                 for col in sorted(used[t])]
        stage_sel = ast.Select(items=items,
                               relation=ast.TableRef(t, alias),
                               where=where)
        s = Stage(id=f"s{len(b.stages)}", sql=render.select(stage_sel))
        ch = b.channel(HASH_SHUFFLE, src=s.id, dst="join", key=key,
                       columns=sorted(used[t]), table=temp_of[t])
        ch.quant_cols = sorted(
            ((tol_cols[t] - exact_cols[t]) & used[t]) - {key})
        s.outputs = [ch.id]
        b.stages.append(s)
        channels.append(ch.id)
    # channels' dst_stage is stamped when the consumer stage is built
    final_sel = dataclasses.replace(
        sel, relation=rewrite_relation(sel.relation, temp_of))
    return final_sel, channels
