"""Whole-query fused execution (port of ``ydb_tpu/ops/fused.py``).

The reference compiles an entire single-node query — scan over all
portions, pushdown filters, join probes, aggregation, HAVING, output
expressions, ORDER BY, LIMIT — into one ``jax.jit`` program. torch runs
eagerly, so here the same body is a Python closure that launches the
query's kernels in order on the current CUDA stream without waiting for
any of them: scan sources arrive as stacked (K, CAP) superblocks,
flattened to one K·CAP row vector with a per-row activity mask; filters
thread a selection mask; joins probe with the ``probe`` kernel; group-by,
compaction and sort go through ``bucket_agg``, ``compact`` and ``sort``.
The result is stacked by dtype and crosses to the host in ONE copy
(``fetch_fused_result``). A scan above the fused scan budget runs the
front half of the same body once per tile of sources (``build_tile_fn``,
the executor's tiled lane). B same-shape queries run the same body once
with a member axis on the values that differ (``build_fused_batched_fn``,
the batched serving lane), and read back in one copy for the batch
(``fetch_fused_batch``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ydb_tpu_torch.core.dtypes import Kind
from ydb_tpu_torch.core.schema import Schema
from ydb_tpu_torch.ops import ir, k1
from ydb_tpu_torch.ops.device import batched_to_host, bucket_capacity
from ydb_tpu_torch.ops.join import probe_lut_traced
from ydb_tpu_torch.ops.sort import sort_env
from ydb_tpu_torch.ops.torch_exec import (
    PerMember, _trace_program, compress,
)

# the executor-lifted LIMIT+OFFSET input (companion of the
# query/paramlift.py literal lift)
LIMIT_PARAM = "__lim2"


def apply_join_schema(schema: Schema, payload_cols: list) -> Schema:
    """Schema effect of a join probe: payload columns replace any existing
    columns with the same names and append at the end."""
    taken = {p.name for p in payload_cols}
    return Schema([c for c in schema.columns if c.name not in taken]
                  + list(payload_cols))


LM_POS = "__lmpos"                       # deferred-scan row-position column


def _prog_refs(prog: ir.Program) -> set:
    """Column names a program actually COMPUTES over (Assign exprs,
    Filter preds, GroupBy keys/carries/agg args). Projection names are
    deliberately excluded: projecting a deferred column keeps it
    deferred (`_trace_program` passthrough) rather than forcing a
    full-capacity gather."""
    refs: set = set()
    for cmd in prog.commands:
        if isinstance(cmd, ir.Assign):
            ir.expr_columns(cmd.expr, refs)
        elif isinstance(cmd, ir.Filter):
            ir.expr_columns(cmd.pred, refs)
        elif isinstance(cmd, ir.GroupBy):
            refs.update(cmd.keys)
            refs.update(cmd.carry_keys)
            refs.update(a.arg for a in cmd.aggs if a.arg is not None)
    return refs


def build_fused_fn(pipe, final_program: Optional[ir.Program],
                   scan_cols: list, K: int, CAP: int,
                   sb_valid_names: frozenset, join_metas: list,
                   rank_assigns: list, sort_spec: tuple,
                   limit: Optional[int], offset: Optional[int],
                   keep: tuple, lift_limit: bool = False,
                   late_scan: frozenset = frozenset(),
                   compact_prog: Optional[ir.Program] = None):
    """The full single-node query as one eager function (`_fused_body`
    without a member axis).

    scan_cols: [Column] of the flattened scan env (internal names).
    join_metas: per join step, the static meta for `probe_lut_traced`
    plus "payload_cols" ([Column] appended to the schema by the probe).

    Returns (fn, layout_box); fn(sb, sbv, lengths, builds, params) →
    (data_stacks {dtype: (k, cap)}, valid_stack (m, cap) | None, length,
    aux) — `aux` carries the compact live count + overflow flag when
    `compact_prog` ran (the executor checks it before any result use).
    `layout_box` is filled by each call with {"data": [(name, dtype_key,
    row)], "valids": [name]} describing the stacking.

    Late materialization (`YDB_TPU_LATE_MAT`): `late_scan` names scan
    columns that are NOT loaded into the row env up front — an int32
    row-position column (`__lmpos`) rides the pipeline instead, and each
    deferred column gathers from the superblock at its first compute
    reference or at the bound-sized tail. Joins whose meta carries
    `late` thread a (build row-id, match) pair in place of their
    payloads."""
    return _fused_body(pipe, final_program, scan_cols, K, CAP,
                       sb_valid_names, join_metas, rank_assigns, sort_spec,
                       limit, offset, keep, lift_limit=lift_limit,
                       late_scan=late_scan, compact_prog=compact_prog)


def build_fused_batched_fn(pipe, final_program: Optional[ir.Program],
                           scan_cols: list, K: int, CAP: int,
                           sb_valid_names: frozenset, join_metas: list,
                           rank_assigns: list, sort_spec: tuple,
                           limit: Optional[int], offset: Optional[int],
                           keep: tuple, members: int,
                           lift_limit: bool = False,
                           late_scan: frozenset = frozenset()):
    """The batched serving lane's body: `members` same-shape queries in
    ONE launch sequence. The scan superblock, the builds and every param
    whose value is the same for all members are taken once; a param
    whose values differ arrives as a `torch_exec.PerMember` ((B,) or
    (B, L)), and a value becomes per member, (B, cap), only where it
    depends on one — the reference's vmap with `in_axes` None or 0 per
    param, written out because the kernels are not traceable. The
    number of kernel launches does not depend on B.

    Returns (fn, layout_box); fn(sb, sbv, lengths, builds, params) →
    (data_stacks {dtype: (B, k, cap)}, valid_stack (B, m, cap) | None,
    lengths (B,), aux) — `aux` is always empty (the compact step is
    single-query only, as in the reference)."""
    return _fused_body(pipe, final_program, scan_cols, K, CAP,
                       sb_valid_names, join_metas, rank_assigns, sort_spec,
                       limit, offset, keep, lift_limit=lift_limit,
                       late_scan=late_scan, members=members)


def _fused_body(pipe, final_program: Optional[ir.Program],
                scan_cols: list, K: int, CAP: int,
                sb_valid_names: frozenset, join_metas: list,
                rank_assigns: list, sort_spec: tuple,
                limit: Optional[int], offset: Optional[int],
                keep: tuple, lift_limit: bool = False,
                late_scan: frozenset = frozenset(),
                compact_prog: Optional[ir.Program] = None,
                members: int = 0):
    """Eager body shared by `build_fused_fn` and, with `members` B > 0,
    `build_fused_batched_fn` (outputs then carry the member axis
    first)."""
    lim2 = None if limit is None else limit + (offset or 0)
    layout_box: dict = {}
    unsigned = frozenset(c.name for c in scan_cols
                         if c.dtype.kind == Kind.UINT64)

    def fn(sb, sbv, lengths, builds, params):
        device = lengths.device
        cap0 = K * CAP
        cap = cap0
        aux: dict = {}
        env = {}
        deferred: dict = {}              # out name -> ("scan", src) |
        #                                  ("join", join_idx, src)
        for c in scan_cols:
            if c.name in late_scan:
                deferred[c.name] = ("scan", c.name)
            else:
                d = sb[c.name].reshape(cap0)
                v = sbv[c.name].reshape(cap0) \
                    if c.name in sb_valid_names else None
                env[c.name] = (d, v)
        if deferred:
            env[LM_POS] = (torch.arange(cap0, dtype=torch.int32,
                                        device=device), None)
        sel = (torch.arange(CAP, dtype=torch.int32, device=device)[None, :]
               < lengths[:, None]).reshape(cap0)
        length = torch.tensor(cap0, dtype=torch.int32, device=device)
        schema = Schema(list(scan_cols))

        def helper_names() -> tuple:
            return tuple(n for n in env if n.startswith("__lm"))

        def gc():
            # drop row-id helper columns whose deferrals are all
            # materialized — they must not ride sorts/compactions for free
            if not any(s[0] == "scan" for s in deferred.values()):
                env.pop(LM_POS, None)
            live_joins = {s[1] for s in deferred.values()
                          if s[0] == "join"}
            for j, m in enumerate(join_metas):
                if m.get("late") and j not in live_joins:
                    env.pop(m["row_col"], None)
                    env.pop(m["found_col"], None)

        def live_index(idx):
            # a member's compacted rows past its length are undefined
            # (`compress` writes only the live prefix): no gather takes
            # its index from them
            if not members:
                return idx
            iota = torch.arange(idx.shape[-1], device=idx.device)
            live = iota < (length[:, None] if length.dim() == 1
                           else length)
            return torch.where(live, idx, torch.zeros_like(idx))

        def materialize(names):
            # the deferred gather: runs at the CURRENT capacity — after a
            # compact/limit slice that is the bound, not the scan
            for nm in names:
                src = deferred.pop(nm, None)
                if src is None:
                    continue
                if src[0] == "scan":
                    pos = live_index(env[LM_POS][0])
                    d = sb[src[1]].reshape(cap0)[pos]
                    v = (sbv[src[1]].reshape(cap0)[pos]
                         if src[1] in sb_valid_names else None)
                    env[nm] = (d, v)
                else:
                    _k, j, s = src
                    m = join_metas[j]
                    row = live_index(env[m["row_col"]][0])
                    ok = env[m["found_col"]][0]
                    pv = builds[j]["pvalid"].get(s)
                    d = builds[j]["payload"][s][row]
                    v = ok if pv is None else (ok & pv[row])
                    env[nm] = (d, v)
            gc()

        def run(prog):
            nonlocal env, length, sel, schema, cap
            materialize(sorted(_prog_refs(prog) & set(deferred)))
            env, length, sel, schema = _trace_program(
                prog, schema.columns, cap, env, length, params, device,
                sel=sel, aux=aux, passthrough=helper_names())
            if env:
                cap = next(iter(env.values()))[0].shape[-1]
            elif sel is not None:
                # a column-free env (count(*) plans) still changes
                # capacity through a Compact — the mask carries it
                cap = sel.shape[-1]
            # a GroupBy/Projection that dropped a deferred column from
            # the schema retires its deferral (it no longer exists)
            for nm in [n for n in deferred if not schema.has(n)]:
                del deferred[nm]
            gc()

        if pipe.pre_program is not None:
            run(pipe.pre_program)
        bi = 0
        for kind, step in pipe.steps:
            if kind == "join":
                meta = join_metas[bi]
                if meta["probe_key"] in deferred:
                    materialize([meta["probe_key"]])
                env, sel = probe_lut_traced(env, sel, builds[bi], meta)
                if meta.get("late") and meta["kind"] in ("inner", "left"):
                    for src, out in zip(meta["src_names"],
                                        meta["payload_names"]):
                        env.pop(out, None)   # replaced by this probe
                        deferred[out] = ("join", bi, src)
                bi += 1
                schema = apply_join_schema(schema, meta["payload_cols"])
            else:
                run(step)
        if compact_prog is not None:
            run(compact_prog)
        if pipe.partial is not None:
            run(pipe.partial)
        if final_program is not None:
            run(final_program)
        if sel is not None:
            env, length = compress(env, length, sel, cap, device)
            sel = None

        need: set = set()
        for a in rank_assigns:
            ir.expr_columns(a.expr, need)
        need.update(n for (n, _asc, _nf) in sort_spec)
        materialize(sorted(need & set(deferred)))
        if rank_assigns:
            k1.run_stage(rank_assigns, env, params, None, cap, device)
        if sort_spec:
            arrays = {n: d for n, (d, _v) in env.items()}
            valids = {n: v for n, (d, v) in env.items() if v is not None}
            arrays2, valids2, length = sort_env(
                arrays, valids, length, None, sort_spec,
                tuple(arrays.keys()),
                unsigned=frozenset(n for n in arrays
                                   if schema.has(n) and schema.dtype(n).kind
                                   == Kind.UINT64) | unsigned)
            env = {n: (arrays2[n], valids2.get(n)) for n in arrays2}
        if lim2 is not None:
            bound = params[LIMIT_PARAM] if lift_limit else lim2
            if isinstance(bound, PerMember):      # each member's own limit
                length = torch.minimum(length, bound.t.to(torch.int32))
            else:
                length = torch.clamp(length, max=int(bound))
            out_cap = min(bucket_capacity(lim2, minimum=128), cap)
            env = {n: (d[..., :out_cap],
                       v[..., :out_cap] if v is not None else None)
                   for n, (d, v) in env.items()}
        # the tail gather: whatever is still deferred materializes HERE,
        # at the post-limit capacity
        want = [n for n in keep if n in env or n in deferred]
        if want:
            materialize([n for n in want if n in deferred])
        else:
            materialize(sorted(deferred))
            want = [n for n in env if not n.startswith("__lm")]
        out_names = [n for n in want if n in env]

        def row(x):        # the member axis on every output (batched)
            if members and x.dim() == 1:
                return x.unsqueeze(0).expand(members, x.shape[0])
            return x
        axis = 1 if members else 0
        groups: dict = {}
        data_layout = []
        for n in out_names:
            d = env[n][0]
            key = str(d.dtype)
            groups.setdefault(key, []).append(row(d))
            data_layout.append((n, key, len(groups[key]) - 1))
        valid_names = [n for n in out_names if env[n][1] is not None]
        layout_box["data"] = data_layout
        layout_box["valids"] = valid_names
        data_stacks = {k: torch.stack(v, axis) for k, v in groups.items()}
        valid_stack = (torch.stack([row(env[n][1]) for n in valid_names],
                                   axis) if valid_names else None)
        if members:
            length = length.to(torch.int32).reshape(1).repeat(members) \
                if length.dim() == 0 else length.to(torch.int32)
        return data_stacks, valid_stack, length, aux

    return fn, layout_box


def build_tile_fn(pipe, scan_cols: list, K: int, CAP: int,
                  sb_valid_names: frozenset, join_metas: list):
    """Scan→filter→join→partial-agg body for ONE tile of a scan above the
    fused scan budget (the streaming front half of `build_fused_fn`,
    stopping after `pipe.partial`): a tile is K stacked sources run
    through the query's kernels without a host sync, and the partial
    stays on the device for the finalize or spill merge.

    fn(sb, sbv, lengths, builds, params) → (data {name}, valids {name},
    length) — compressed (active rows at front). Tiles merge after the
    loop, so the late-materialization deferral is stripped here (a row
    id crossing a tile boundary would dangle)."""
    join_metas = [{**m, "late": False} for m in join_metas]

    def fn(sb, sbv, lengths, builds, params):
        device = lengths.device
        cap = K * CAP
        env = {}
        for c in scan_cols:
            d = sb[c.name].reshape(cap)
            v = sbv[c.name].reshape(cap) if c.name in sb_valid_names else None
            env[c.name] = (d, v)
        sel = (torch.arange(CAP, dtype=torch.int32, device=device)[None, :]
               < lengths[:, None]).reshape(cap)
        length = torch.tensor(cap, dtype=torch.int32, device=device)
        schema = Schema(list(scan_cols))

        def run(prog, env, length, sel, schema, cap):
            env, length, sel, schema = _trace_program(
                prog, schema.columns, cap, env, length, params, device,
                sel=sel)
            if env:
                cap = next(iter(env.values()))[0].shape[0]
            return env, length, sel, schema, cap

        if pipe.pre_program is not None:
            env, length, sel, schema, cap = run(pipe.pre_program, env,
                                                length, sel, schema, cap)
        bi = 0
        for kind, step in pipe.steps:
            if kind == "join":
                meta = join_metas[bi]
                env, sel = probe_lut_traced(env, sel, builds[bi], meta)
                bi += 1
                schema = apply_join_schema(schema, meta["payload_cols"])
            else:
                env, length, sel, schema, cap = run(step, env, length, sel,
                                                    schema, cap)
        if pipe.partial is not None:
            env, length, sel, schema, cap = run(pipe.partial, env, length,
                                                sel, schema, cap)
        if sel is not None:
            env, length = compress(env, length, sel, cap, device)
        out_d = {n: d for n, (d, _v) in env.items()}
        out_v = {n: v for n, (d, v) in env.items() if v is not None}
        return out_d, out_v, length

    return fn


def _unpack_fused_host(host_stacks, host_valids, n: int, layout_box: dict,
                       out_schema: Schema, out_dicts: dict):
    """Host-side assembly of one query's result from transferred
    dtype-stacked arrays."""
    from ydb_tpu_torch.core.block import HostBlock
    from ydb_tpu_torch.ops.device import host_column

    valid_row = {nm: i for i, nm in enumerate(layout_box["valids"])}
    cols = {}
    out_cols = []
    for (name, dtype_key, row) in layout_box["data"]:
        if not out_schema.has(name):
            continue
        valid = (host_valids[valid_row[name]][:n]
                 if name in valid_row and host_valids is not None
                 else None)
        cols[name] = host_column(host_stacks[dtype_key][row][:n], valid,
                                 out_schema.dtype(name),
                                 out_dicts.get(name))
        out_cols.append(out_schema.col(name))
    return HostBlock(Schema(out_cols), cols, n)


def fetch_fused_result(data_stacks, valid_stack, length, layout_box: dict,
                       out_schema: Schema, out_dicts: dict):
    """Device→host readout of one fused query: ONE copy for the whole
    result, length included. Large row-level outputs sync the length
    first and slice on the device so padding doesn't cross."""
    keys = list(data_stacks)
    cap_out = data_stacks[keys[0]].shape[1] if keys else 0
    if cap_out > (1 << 16):
        n = int(length)
        m = max(n, 1)
        host = batched_to_host([data_stacks[k][:, :m] for k in keys]
                               + ([valid_stack[:, :m]]
                                  if valid_stack is not None else []))
    else:
        host = batched_to_host([data_stacks[k] for k in keys]
                               + ([valid_stack] if valid_stack is not None
                                  else [])
                               + [length.reshape(1)])
        n = int(host.pop()[0])
    host_stacks = dict(zip(keys, host[:len(keys)]))
    host_valids = host[len(keys)] if valid_stack is not None else None
    return _unpack_fused_host(host_stacks, host_valids, n, layout_box,
                              out_schema, out_dicts)


def capture_fused_device(data_stacks, valid_stack, length, layout_box: dict,
                         out_schema: Schema, out_dicts: dict):
    """Device-resident view of one fused execution: the stage-spine
    capture. Slices the dtype-stacked output rows back into per-column
    device tensors BY REFERENCE (views, no copy, no transfer), so a DQ
    stage hands its result to the next stage or the ICI exchange without
    the readout `fetch_fused_result` pays. `length` is the host int the
    caller read; rows past it are dead rows the consumer masks."""
    from ydb_tpu_torch.ops.device import DeviceBlock

    valid_row = {nm: i for i, nm in enumerate(layout_box["valids"])}
    arrays, valids, dicts = {}, {}, {}
    out_cols = []
    for (name, dtype_key, row) in layout_box["data"]:
        if not out_schema.has(name):
            continue
        arrays[name] = data_stacks[dtype_key][row]
        if name in valid_row and valid_stack is not None:
            valids[name] = valid_stack[valid_row[name]]
        if out_dicts.get(name) is not None:
            dicts[name] = out_dicts[name]
        out_cols.append(out_schema.col(name))
    cap = int(next(iter(arrays.values())).shape[0]) if arrays else 0
    return DeviceBlock(Schema(out_cols), arrays, valids, length, cap,
                       dicts)


def fetch_fused_batch(data_stacks, valid_stack, lengths, layout_box: dict,
                      out_schema: Schema, out_dicts: dict,
                      member_rows: list):
    """Device→host readout of one BATCHED execution: ONE copy for the
    whole batch (lengths included), then each member unpacks its row on
    the host. Large row-level outputs read the lengths first and slice
    the padding off on the device, as `fetch_fused_result` does.
    `member_rows[i]` is member i's row (identical members all read row
    0). Returns [HostBlock], one per member."""
    keys = list(data_stacks)
    cap_out = data_stacks[keys[0]].shape[2] if keys else 0
    tensors = [data_stacks[k] for k in keys] + (
        [valid_stack] if valid_stack is not None else [])
    if cap_out > (1 << 16):
        ns = batched_to_host([lengths])[0]
        m = max(int(ns.max()), 1)
        host = batched_to_host([t[:, :, :m] for t in tensors])
    else:
        host = batched_to_host(tensors + [lengths])
        ns = host.pop()
    host_stacks = dict(zip(keys, host[:len(keys)]))
    host_valids = host[len(keys)] if valid_stack is not None else None
    out = []
    for b in member_rows:
        hs = {k: v[b] for k, v in host_stacks.items()}
        hv = host_valids[b] if host_valids is not None else None
        out.append(_unpack_fused_host(hs, hv, int(ns[b]), layout_box,
                                      out_schema, out_dicts))
    return out


def fused_cache_key(plan, scan_cols, K, CAP, sb_valid_names, builds_sig,
                    sort_spec, rank_assigns, param_names, lim_key=None,
                    compact_cap=None):
    """Identity of one fused query shape (the reference's compiled-program
    key); the port keys the compact-sizing memo on it."""
    from ydb_tpu_torch.ops.torch_exec import groupby_tuning
    pipe = plan.pipeline
    progs = []
    if pipe.pre_program is not None:
        progs.append(pipe.pre_program.fingerprint())
    for kind, step in pipe.steps:
        if kind == "join":
            progs.append(("join", step.probe_key, step.kind,
                          tuple(step.payload), step.mark_col, step.not_in))
        else:
            progs.append(step.fingerprint())
    if pipe.partial is not None:
        progs.append(pipe.partial.fingerprint())
    if plan.final_program is not None:
        progs.append(plan.final_program.fingerprint())
    lim = (plan.limit, plan.offset) if lim_key is None else lim_key
    return (tuple(progs),
            tuple((c.name, c.dtype.kind.value, c.dtype.nullable)
                  for c in scan_cols),
            K, CAP, tuple(sorted(sb_valid_names)), builds_sig,
            sort_spec,
            ir.Program(rank_assigns).fingerprint() if rank_assigns else "",
            lim,
            tuple(n for (n, _lbl) in plan.output), tuple(param_names),
            ("compact", int(compact_cap or 0)),
            groupby_tuning())


def build_inputs_sig(bt) -> tuple:
    """Shape signature of a BuildTable's inputs."""
    return (bt.lut.shape[0] if bt.lut is not None else "bs",
            bt.keys_sorted.shape[0],
            next(iter(bt.payload.values())).shape[0] if bt.payload else 0,
            tuple(sorted(bt.payload)), tuple(sorted(bt.payload_valid)))


def build_traced_inputs(bt) -> dict:
    """The per-build input dict of the fused function."""
    out = {
        "lut_base": int(bt.lut_base),
        "n": int(bt.n),
        "has_null": bool(bt.anti_has_null),
        "keys": bt.keys_sorted,      # bsearch probes (sparse/float keys)
        "payload": dict(bt.payload),
        "pvalid": dict(bt.payload_valid),
    }
    if bt.lut is not None:
        out["lut"] = bt.lut
    return out
