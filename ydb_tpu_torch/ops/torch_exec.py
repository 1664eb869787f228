"""Eager torch lowering of SSA programs (port of ``ydb_tpu/ops/xla_exec.py``).

The reference traces each program into one XLA computation; torch runs
eagerly, so here a program is executed command by command over
(data, valid) tensor pairs on one device. The shapes stay the
reference's: blocks are padded to power-of-two capacities, the live row
count rides as a 0-d tensor, filters keep selection masks instead of
gathering, and every reduction masks by ``row < length``.

The non-elementwise work goes through the hand-written CUDA kernels
(``ops/cuda``): grouped and keyless aggregation (``bucket_agg``), the
sort (``sort``), the counting sort by bucket id (``bucket_perm``) and
per-group folds (``segment_agg``) of the sorted lanes, compaction
(``compact``) and composite-key hashing (``hash64``).
Elementwise expressions (K1 of the kernel table) run stage by stage —
each maximal run of Assign and Filter commands — through ``ops/k1.py``:
one generated kernel per stage on the card. ``_eval`` below, torch over
``ops/kernels.py``'s lowerings, is K1's plain version.

Group-by lanes, as the reference routes them: keyless; small bounded
domains (≤ 512 buckets, ``bucket_agg``); medium bounded domains (513 to
65,535 buckets: ordered by bucket id with ``bucket_perm``, folded by
``segment_agg``, emitted in bucket order); everything else sorted by its
key words (``sort``) and folded per run (``segment_agg``). The
reference's levers ``YDB_TPU_GROUPBY_TILE_ROWS``,
``YDB_TPU_GATHER_BATCH_CAP`` and ``YDB_TPU_GROUPBY_LEGACY`` shaped its
XLA programs (gather tiling, batching, the pre-tiling lowering) and
never changed an answer; this lowering has no such programs and reads
none of them.

The member axis (the batched serving lane, ``ops/fused.
build_fused_batched_fn``): B same-shape queries run as one, and every
value is either shared, shape (cap,), or per member, shape (B, cap) —
the reference's vmap ``in_axes`` None against 0, decided per value. A
lifted param whose value differs across the members arrives as a
``PerMember``; a value becomes per member only when it depends on one.
Elementwise work broadcasts; a mask, a length (then (B,)) or a column
that is per member sends a group-by, a compaction, a probe or a sort to
its kernel's member-axis entry (``bucket_agg_batched``,
``segment_agg_batched``, ``compact_batched``); the probe and the sort
launch once for every member (the probe over the union of the masks
when its key is shared, else over the flattened members). A shared
input is never copied per member where the kernel takes it once.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.dtypes import Kind
from ydb_tpu_torch.core.schema import Column, Schema
from ydb_tpu_torch.ops import ir, k1
from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.device import (
    DeviceBlock, bucket_capacity, to_device, to_host,
)
from ydb_tpu_torch.ops.kernels import KERNELS
from ydb_tpu_torch.ops.sort import encode_key, group_key_words
from ydb_tpu_torch.ops.torch_ns import TXP, to_tensor, torch_dtype
from ydb_tpu_torch.utils.metrics import GLOBAL

_SMALL_DOMAIN_BUCKETS = 1 << 9     # bounded-domain bucket_agg lane bound
_SCATTER_MAX_BUCKETS = 1 << 16     # reference's medium-domain lane bound


def late_mat_enabled() -> bool:  # lint: tuning-provider
    """YDB_TPU_LATE_MAT — default ON (the reference's lever, same name):
    the fused path carries row-id vectors instead of payload columns
    through the middle of a plan and may compact intermediates to a
    ladder-quantized bound (`ir.Compact`). `=0` restores eager gathers."""
    return os.environ.get("YDB_TPU_LATE_MAT", "") not in ("0",)


def groupby_tuning() -> tuple:  # lint: tuning-provider
    """The levers that change plan or program structure, as a cache-key
    component (the port keeps the reference's key discipline even though
    nothing is compiled per key: the compact-sizing memo keys on it)."""
    from ydb_tpu_torch.query.bounds import bounds_enabled
    return (bounds_enabled(), late_mat_enabled())


def _b_inc(name: str, by: int = 1) -> None:
    GLOBAL.inc(f"bounds/{name}", by)


# --------------------------------------------------------------------------
# the member axis
# --------------------------------------------------------------------------


class PerMember:
    """A lifted param whose value differs across the members of a batch:
    `t` carries the member axis first — (B,) for a scalar, (B, L) for an
    array (an IN-list LUT, a string pool)."""
    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        self.t = t


def _members(*xs) -> int:
    """B when any of `xs` (data, validity or mask) is (B, cap), else 0."""
    for x in xs:
        if isinstance(x, torch.Tensor) and x.dim() == 2:
            return x.shape[0]
    return 0


def _rows(t: torch.Tensor) -> torch.Tensor:
    """`t` with contiguous rows (a kernel's member-axis input)."""
    return t if t.dim() == 2 and t.stride(-1) == 1 else t.contiguous()


def _is_member_length(length) -> bool:
    return isinstance(length, torch.Tensor) and length.dim() == 1


def _take(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """d at row positions idx, along the last axis; either may carry the
    member axis."""
    if d.dim() == 1:
        return d[idx]
    if idx.dim() == 1:
        return d[:, idx]
    return torch.gather(d, 1, idx)


def _member_masks(active: torch.Tensor, B: int) -> torch.Tensor:
    """A (B, cap) mask with its own row per member (the kernels' input)."""
    if active.dim() == 2:
        return active.contiguous()
    return active.unsqueeze(0).expand(B, active.shape[0]).contiguous()


# --------------------------------------------------------------------------
# expressions
# --------------------------------------------------------------------------


def _full(cap: int, value, np_dtype, device) -> torch.Tensor:
    dt = torch_dtype(np_dtype)
    if np.dtype(np_dtype) == np.uint64:
        value = int(np.uint64(value).view(np.int64))
    return torch.full((cap,), value, dtype=dt, device=device)


def _eval(expr, env, params, cap, device):
    if isinstance(expr, ir.Col):
        return env[expr.name]
    if isinstance(expr, ir.Const):
        return _full(cap, expr.value, expr.dtype.np, device), None
    if isinstance(expr, ir.Param):
        val = params[expr.name]
        if isinstance(val, PerMember):
            t = val.t
            if expr.is_array:
                return t, None
            t = t.to(torch_dtype(expr.dtype.np))
            return t[:, None].expand(t.shape[0], cap), None
        if expr.is_array:
            return val, None
        return _full(cap, val, expr.dtype.np, device), None
    if isinstance(expr, ir.Call):
        if expr.op == "hash_combine" and all(
                isinstance(a, ir.Call) and a.op == "hash64"
                for a in expr.args):
            return _eval_hashed_key(expr, env, params, cap, device)
        k = KERNELS[expr.op]
        args = [_eval(a, env, params, cap, device) for a in expr.args]
        extra = expr.extra_dict()
        if expr.op == "take_lut" and args[1][0].dim() == 2:
            return _take_lut_members(args, extra)
        if k.null_mode == "custom":
            return k.impl_nv(TXP, args, extra)
        data = k.impl(TXP, [a[0] for a in args], extra)
        valid = None
        for _, v in args:
            if v is not None:
                valid = v if valid is None else (valid & v)
        return data, valid
    raise TypeError(f"bad expr {expr!r}")


def _take_lut_members(args, extra):
    """`take_lut` with a per-member LUT (B, L): each member gathers from
    its own row (the kernels' `lut[code]` broadcast along the member
    axis); validity as `ops/kernels.py _take_lut_nv`."""
    (codes, vc), (lut, _v) = args
    B, L = lut.shape
    safe = torch.clamp(codes, 0, L - 1).to(torch.int64)
    data = torch.gather(lut, 1, safe.expand(B, safe.shape[-1]))
    nul = codes < 0
    valid = ~nul if vc is None else (vc & ~nul)
    if extra.get("null_neg"):
        valid = valid & (data >= 0)
    return data, valid


def _eval_hashed_key(expr, env, params, cap, device):
    """`hash_combine(hash64(c0), hash64(c1), ...)` — a composite join
    key — as one ``hash64`` launch over the columns instead of one pass
    per operator; NULL where any column is NULL, as the kernels'
    default null rule gives."""
    args = [_eval(a.args[0], env, params, cap, device) for a in expr.args]
    valid = None
    for _, v in args:
        if v is not None:
            valid = v if valid is None else (valid & v)
    return K.hash64([d for d, _ in args]), valid


# --------------------------------------------------------------------------
# group-by
# --------------------------------------------------------------------------


def _agg_operand(d: torch.Tensor) -> torch.Tensor:
    """8-byte kernel operand: floats widen to float64, everything else to
    int64 (sums accumulate in f64 / i64 like the reference's
    `_acc_dtype`; min/max results narrow back to the column dtype)."""
    if d.dtype.is_floating_point:
        return d.to(torch.float64).contiguous()
    return d.to(torch.int64).contiguous()


def _agg_specs(cmd: ir.GroupBy, env, schema: Schema):
    """Kernel aggregate specs for `cmd.aggs` (count_all is the kernels'
    per-group row count and takes no slot). Returns (specs, slots)."""
    specs, slots = [], []
    for a in cmd.aggs:
        if a.func == "count_all":
            slots.append(None)
            continue
        d, v = env[a.arg]
        v = None if v is None else v.contiguous()
        if a.func == "count":
            specs.append(("count", None, v, False))
        elif a.func in ("sum", "min", "max"):
            unsigned = schema.has(a.arg) \
                and schema.dtype(a.arg).kind == Kind.UINT64
            specs.append((a.func, _agg_operand(d), v, unsigned))
        elif a.func == "some":
            specs.append(("first", None, v, False))
        else:
            raise ValueError(a.func)
        slots.append(len(specs) - 1)
    return specs, slots


def _agg_outputs(cmd: ir.GroupBy, env, slots, vals, cnts, present_cnt,
                 cap: int) -> dict:
    """Per-group aggregate columns from a kernel's results, with the
    reference's validity rules (a sum, min, max or some with no valid
    row is NULL; counts are never NULL)."""
    new_env = {}
    for a, slot in zip(cmd.aggs, slots):
        if slot is None:                       # count_all
            new_env[a.out] = (present_cnt, None)
            continue
        d, _v = env[a.arg]
        val, cnt = vals[slot], cnts[slot]
        if a.func == "count":
            new_env[a.out] = (val, None)
            continue
        any_valid = cnt > 0
        if a.func == "sum":
            new_env[a.out] = (val, any_valid)
        elif a.func in ("min", "max"):
            new_env[a.out] = (val.to(d.dtype), any_valid)
        else:                                  # some: first valid row
            new_env[a.out] = (_take(d, torch.clamp(val, 0, cap - 1)),
                              any_valid)
    return new_env


def _run_aggs(cmd: ir.GroupBy, env, schema: Schema, kid, nb: int, active,
              cap: int, device, want_first: bool, B: int = 0):
    """Every aggregate of `cmd` (plus, when asked, the first active row
    per bucket for carried keys) through ONE bucket_agg call (B members:
    one bucket_agg_batched call). Returns (new_env, present bool (nb,),
    firstpos int64 (nb,) | None), each (B, nb) for B members."""
    specs, slots = _agg_specs(cmd, env, schema)
    if want_first:
        specs.append(("first", None, None, False))
    if B:
        vals, cnts, present_cnt = K.bucket_agg_batched(
            kid, nb, _member_masks(active, B), specs)
    else:
        vals, cnts, present_cnt = K.bucket_agg(kid, nb, active, specs)
    new_env = _agg_outputs(cmd, env, slots, vals, cnts, present_cnt, cap)
    firstpos = vals[-1] if want_first else None
    return new_env, present_cnt > 0, firstpos


def _active(length, sel, cap: int, device) -> torch.Tensor:
    """row < length (and sel): (cap,), or (B, cap) when the length (B,)
    or the mask carries the member axis."""
    iota = torch.arange(cap, dtype=torch.int32, device=device)
    active = iota < (length[:, None] if _is_member_length(length)
                     else length)
    return active if sel is None else (active & sel)


def _groupby_global(cmd: ir.GroupBy, env, schema: Schema, active, cap: int,
                    device, B: int = 0):
    """Keyless GROUP BY: one bucket, one output row (per member)."""
    new_env, _present, _first = _run_aggs(cmd, env, schema, None, 1, active,
                                          cap, device, want_first=False,
                                          B=B)
    return new_env, torch.tensor(1, dtype=torch.int32, device=device)


def _bucket_ids(cmd: ir.GroupBy, env, cap: int, device):
    """Mixed-radix bucket id per row for bounded key domains (+1 slot per
    key for NULL)."""
    kid = torch.zeros((cap,), dtype=torch.int32, device=device)
    stride = 1
    strides = []
    for kname, dom in zip(cmd.keys, cmd.key_domains):
        d, v = env[kname]
        code = d.to(torch.int32) + 1           # -1 (null string code) → 0
        if v is not None:
            code = torch.where(v, code, torch.zeros_like(code))
        code = torch.clamp(code, 0, dom)
        kid = kid + code * stride
        strides.append(stride)
        stride *= dom + 1
    return kid, stride, strides


def _groupby_small_domain(cmd: ir.GroupBy, env, schema: Schema, sel,
                          length, cap: int, device, B: int = 0):
    """Bounded-domain aggregation: bucket ids in torch, every aggregate
    in one `bucket_agg` launch, then the shared epilogue."""
    active = _active(length, sel, cap, device)
    kid, nbuckets, strides = _bucket_ids(cmd, env, cap, device)
    new_env, present, firstpos = _run_aggs(
        cmd, env, schema, kid, nbuckets, active, cap, device,
        want_first=bool(cmd.carry_keys), B=B)
    return _emit_bucket_groups(cmd, env, schema, new_env, present, nbuckets,
                               strides, cap, device, firstpos)


def _pad(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros appended along the last axis."""
    return torch.cat([t, torch.zeros(t.shape[:-1] + (pad,), dtype=t.dtype,
                                     device=t.device)], dim=-1)


def _emit_bucket_groups(cmd: ir.GroupBy, env, schema: Schema, new_env,
                        present, nbuckets: int, strides, cap: int, device,
                        firstpos=None):
    """Shared bounded-domain epilogue: rebuild key columns from bucket ids,
    then compact non-empty buckets to the front of a small capacity
    bucket. `firstpos`: leader row per bucket, for carried keys."""
    _b_inc("proven_rows", bucket_capacity(nbuckets, minimum=128))
    _b_inc("capacity_rows", cap)
    _b_inc("bounded_groupbys")
    if cmd.carry_keys:
        _b_inc("carried_keys", len(cmd.carry_keys))
    bucket_ids = torch.arange(nbuckets, dtype=torch.int32, device=device)
    for kname, dom, st in zip(cmd.keys, cmd.key_domains, strides):
        code = torch.div(bucket_ids, st, rounding_mode="floor") \
            % (dom + 1) - 1
        d, _v = env[kname]
        kd = code.to(d.dtype)
        kv = code >= 0
        dt = schema.dtype(kname)
        new_env[kname] = (kd, kv if dt.nullable else None)
    for kname in cmd.carry_keys:
        d, v = env[kname]
        safe = torch.clamp(firstpos, 0, cap - 1)
        kd = _take(d, safe)
        dt = schema.dtype(kname)
        if dt.nullable:
            kv = (_take(v, safe) if v is not None
                  else torch.ones((nbuckets,), dtype=torch.bool,
                                  device=device))
            new_env[kname] = (kd, kv & present)
        else:
            new_env[kname] = (kd, None)

    out_cap = bucket_capacity(nbuckets, minimum=128)
    pad = out_cap - nbuckets
    padded = {}
    for name, (d, v) in new_env.items():
        dp = _pad(d, pad) if pad > 0 else d[..., :out_cap]
        vp = None
        if v is not None:
            vp = _pad(v, pad) if pad > 0 else v[..., :out_cap]
        padded[name] = (dp, vp)
    present_p = _pad(present, pad) if pad > 0 else present[..., :out_cap]
    return compress(padded, nbuckets, present_p, out_cap, device)


def _unsigned_keys(names, schema: Schema) -> frozenset:
    return frozenset(n for n in names
                     if schema.has(n) and schema.dtype(n).kind == Kind.UINT64)


def _key_order(words: list, active, n: int, device) -> torch.Tensor:
    """The sorted lane's permutation: the ``sort`` kernel over (inactive
    rank, key words, row id)."""
    inactive = encode_key((~active).to(torch.int64))
    return K.sort_perm([inactive] + words, n, device)


def _sorted_groups(key_words: list, cmd: ir.GroupBy, env, schema: Schema,
                   active, cap: int, oc: int, device, B: int = 0,
                   order=_key_order):
    """The sort-then-fold core of both lanes below: `order(words, active,
    n, device)` gives the permutation that puts the active rows first in
    key order (row id breaking ties), then ``segment_agg`` folds each run
    of equal words. Returns (new_env of the aggregates at `oc` slots,
    ngroups, lead).

    B members: with shared key words, ONE permutation over the union of
    the members' masks and ``segment_agg_batched`` (each member's groups,
    (B,) ngroups, (B, oc) slots); with a per-member word, one permutation
    of the B·cap rows with the member id as the leading word
    (`_member_key_groups`)."""
    specs, slots = _agg_specs(cmd, env, schema)
    if B and any(w.dim() == 2 for w in key_words):
        ngroups, lead, present, vals, cnts = _member_key_groups(
            key_words, _member_masks(active, B), specs, cap, oc, device,
            order)
    elif B:
        masks = _member_masks(active, B)
        union = masks.any(0)
        perm = order(key_words, union, cap, device)
        ngroups, lead, present, vals, cnts = K.segment_agg_batched(
            perm, key_words, masks, specs, oc, union=union)
    else:
        perm = order(key_words, active, cap, device)
        ngroups, lead, present, vals, cnts = K.segment_agg(
            perm, key_words, active, specs, oc)
    new_env = _agg_outputs(cmd, env, slots, vals, cnts, present, cap)
    return new_env, ngroups, lead


def _member_key_groups(key_words: list, masks, specs, cap: int, oc: int,
                       device, order=_key_order):
    """Groups whose key words differ per member: the B·cap rows ordered
    once by (member, words) — `order` over the flattened words with the
    member id leading — folded as one query by ``segment_agg`` at B·oc
    slots (the members' groups come out member by member), then each
    member's run of groups taken into its (B, oc) row. Returns
    segment_agg_batched's (ngroups, lead, present, vals, cnts)."""
    B = masks.shape[0]
    n = B * cap
    member = torch.arange(B, dtype=torch.int64,
                          device=device).repeat_interleave(cap)
    words = [encode_key(member)] + [
        (w if w.dim() == 2 else w.unsqueeze(0).expand(B, cap))
        .reshape(-1).contiguous() for w in key_words]
    active = masks.reshape(-1)
    perm = order(words, active, n, device)
    flat = [(f, None if d is None else K._per_member(d, B).reshape(-1)
             .contiguous(),
             None if v is None else K._per_member(v, B).reshape(-1)
             .contiguous(), u) for (f, d, v, u) in specs]
    ng, lead, present, vals, cnts = K.segment_agg(perm, words, active, flat,
                                                  B * oc)
    slots = torch.arange(B * oc, device=device)
    live = slots < ng
    owner = torch.where(live, lead.to(torch.int64) // cap,
                        torch.full_like(slots, B))
    counts = torch.bincount(owner, minlength=B + 1)[:B]
    first = torch.cumsum(counts, 0) - counts
    i = torch.arange(oc, device=device)
    here = i[None, :] < counts[:, None]
    idx = torch.where(here, first[:, None] + i[None, :],
                      torch.zeros_like(here, dtype=torch.int64))

    def per(x):
        y = x[idx]
        return torch.where(here, y, torch.zeros_like(y))

    off = torch.arange(B, device=device)[:, None] * cap
    lead_m = per(lead.to(torch.int64))
    lead_m = torch.where(here, lead_m - off, torch.zeros_like(lead_m))
    out_vals = []
    for (f, *_r), v in zip(specs, vals):
        y = per(v)
        if f == "first":          # flat row id → the member's row id
            y = torch.where(here & (y < n), y - off,
                            torch.where(here, torch.full_like(y, cap), y))
        out_vals.append(y)
    return (counts.to(torch.int32), lead_m.to(torch.int32), per(present),
            out_vals, [per(c) for c in cnts])


def _groupby_medium_domain(cmd: ir.GroupBy, env, schema: Schema, sel,
                           length, cap: int, device, B: int = 0):
    """Bounded domains too wide for bucket_agg (513 to 65,535 buckets):
    the rows are ordered by bucket id with ``bucket_perm`` (a counting
    sort) and folded per bucket run (the reference scatter-reduces
    instead), the per-group results are scattered to their bucket slots,
    and the shared epilogue emits the non-empty buckets in bucket order,
    as the reference does."""
    active = _active(length, sel, cap, device)
    kid, nbuckets, strides = _bucket_ids(cmd, env, cap, device)
    oc = min(bucket_capacity(nbuckets, minimum=128), cap)
    words = [encode_key(kid.to(torch.int64))]

    def order(_words, act, _n, _device):
        # the per-member form sorts the B·cap rows by (member, bucket id)
        return K.bucket_perm(kid, act.reshape(kid.shape), nbuckets) \
            if kid.dim() == 2 else K.bucket_perm(kid, act, nbuckets)
    grp_env, ngroups, lead = _sorted_groups(words, cmd, env, schema,
                                            active, cap, oc, device, B,
                                            order)
    # group slot g holds bucket kid[lead[g]]; slots past ngroups spill
    live = torch.arange(oc, device=device) < (ngroups[:, None] if B
                                              else ngroups)
    slot = torch.where(live, _take(kid, lead.to(torch.int64))
                       .to(torch.int64),
                       torch.full(live.shape, nbuckets, dtype=torch.int64,
                                  device=device))

    def scatter(x, fill=0):
        out = torch.full(x.shape[:-1] + (nbuckets + 1,), fill,
                         dtype=x.dtype, device=device)
        return out.scatter_(-1, slot, x)[..., :nbuckets]

    new_env = {}
    for name, (d, v) in grp_env.items():
        new_env[name] = (scatter(d), None if v is None else scatter(v))
    present = scatter(live)
    firstpos = scatter(lead.to(torch.int64), cap) if cmd.carry_keys else None
    return _emit_bucket_groups(cmd, env, schema, new_env, present, nbuckets,
                               strides, cap, device, firstpos)


def _trace_group_by_sorted(cmd: ir.GroupBy, env, schema: Schema, sel, length,
                           cap: int, device, B: int = 0):
    """Unbounded-domain aggregation: one sort of (inactive rank, key
    words, row id), then ``segment_agg`` over the sorted permutation,
    with the values read through it (nothing is gathered into sorted
    order). Key and carried-key columns are taken at each group's leader
    row, ``d[perm[start]]``, at the output capacity `oc`: the proven
    ``cmd.out_bound`` when there is one, the scan capacity otherwise.
    Groups come out in key order, NULL keys first."""
    active = _active(length, sel, cap, device)
    oc = cap
    if cmd.out_bound:
        oc = min(bucket_capacity(max(int(cmd.out_bound), 1), minimum=128),
                 cap)
    words = group_key_words(cmd.keys, env, _unsigned_keys(cmd.keys, schema))
    new_env, ngroups, lead = _sorted_groups(words, cmd, env, schema, active,
                                            cap, oc, device, B)
    live = torch.arange(oc, device=device) < (ngroups[:, None] if B
                                              else ngroups)
    _b_inc("proven_rows", oc)
    _b_inc("capacity_rows", cap)
    if cmd.out_bound:
        _b_inc("bounded_groupbys")
    if cmd.carry_keys:
        _b_inc("carried_keys", len(cmd.carry_keys))
    lead = lead.to(torch.int64)
    for kname in list(cmd.keys) + list(cmd.carry_keys):
        d, v = env[kname]
        if schema.dtype(kname).nullable:
            kv = _take(v, lead) if v is not None else torch.ones_like(live)
            new_env[kname] = (_take(d, lead), kv & live)
        else:
            new_env[kname] = (_take(d, lead), None)
    return new_env, ngroups


def _trace_group_by(cmd: ir.GroupBy, env, schema: Schema, sel, length,
                    cap: int, device):
    """GroupBy dispatch: keyless → one bucket; small bounded domains →
    bucket_agg; medium bounded domains → the bucket-sorted lane;
    everything else → the sort-based lane. Returns (new_env,
    new_length). With the member axis on the mask, the length or a
    column the group-by reads, every lane runs once for all B members
    (per-member results (B, oc), lengths (B,))."""
    refs = list(cmd.keys) + list(cmd.carry_keys) + [
        a.arg for a in cmd.aggs if a.arg is not None]
    B = _members(sel, *[x for n in refs for x in env[n]])
    if not B and _is_member_length(length):
        B = length.shape[0]
    if not cmd.keys:
        return _groupby_global(cmd, env, schema,
                               _active(length, sel, cap, device), cap,
                               device, B)
    if cmd.key_domains and all(d > 0 for d in cmd.key_domains):
        nb = 1
        for d in cmd.key_domains:
            nb *= d + 1
        if nb <= _SMALL_DOMAIN_BUCKETS:
            return _groupby_small_domain(cmd, env, schema, sel, length, cap,
                                         device, B)
        if nb + 1 <= _SCATTER_MAX_BUCKETS:
            return _groupby_medium_domain(cmd, env, schema, sel, length, cap,
                                          device, B)
    return _trace_group_by_sorted(cmd, env, schema, sel, length, cap, device,
                                  B)


# --------------------------------------------------------------------------
# programs
# --------------------------------------------------------------------------


_STAGES: dict = {}                  # id(program) -> (program, n, items)


def _stages(program: ir.Program) -> list:
    """The program's commands with each maximal run of Assign/Filter
    commands grouped into one tuple (a K1 stage), computed once per
    program object (a stage's tuple is then the same object on every
    run, which keys K1's memo)."""
    hit = _STAGES.get(id(program))
    if hit is not None and hit[0] is program \
            and hit[1] == len(program.commands):
        return hit[2]
    items, run = [], []
    for cmd in program.commands:
        if isinstance(cmd, (ir.Assign, ir.Filter)):
            run.append(cmd)
            continue
        if run:
            items.append(tuple(run))
            run = []
        items.append(cmd)
    if run:
        items.append(tuple(run))
    if len(_STAGES) >= 1 << 14:
        _STAGES.clear()
    _STAGES[id(program)] = (program, len(program.commands), items)
    return items


def _trace_program(program: ir.Program, in_schema_cols, cap, env, length,
                   params, device, sel=None, aux=None, passthrough=()):
    """env: name -> (data, valid|None); returns (env, length, sel, schema).
    `sel` seeds the selection mask (fused pipelines thread it between
    programs instead of compressing). `aux` receives an `ir.Compact`'s
    live count and overflow flag; `passthrough` names helper columns
    (late-materialization row ids) that survive Projections."""
    schema = Schema(list(in_schema_cols))
    for cmd in _stages(program):
        if isinstance(cmd, tuple):             # an Assign/Filter stage: K1
            sel = k1.run_stage(cmd, env, params, sel, cap, device)
            for c in cmd:
                if isinstance(c, ir.Assign):
                    dt = ir.infer_expr(c.expr, schema)
                    schema = Schema([x for x in schema.columns
                                     if x.name != c.name]
                                    + [Column(c.name, dt)])
        elif isinstance(cmd, ir.GroupBy):
            env, length = _trace_group_by(cmd, env, schema, sel, length, cap,
                                          device)
            if env:
                cap = next(iter(env.values()))[0].shape[-1]
            schema = ir.infer_schema(ir.Program([cmd]), schema)
            sel = None
        elif isinstance(cmd, ir.Projection):
            schema = schema.select(list(cmd.names))
            if passthrough:
                new_env = {nm: env[nm] for nm in cmd.names if nm in env}
                for h in passthrough:
                    if h in env:
                        new_env[h] = env[h]
                env = new_env
            else:
                env = {nm: env[nm] for nm in cmd.names}
        elif isinstance(cmd, ir.Compact):
            env, length, sel, live, ovf = compact_env(env, length, sel,
                                                      cap, cmd.cap, device)
            cap = cmd.cap
            if aux is not None:
                aux["compact_live"] = live
                aux["compact_ovf"] = ovf
        else:
            raise TypeError(f"bad command {cmd!r}")
    return env, length, sel, schema


def _compact_cols(env, length, sel, cap: int, new_cap: int):
    names = list(env)
    cols, where = [], []
    for nm in names:
        d, v = env[nm]
        cols.append(d.contiguous())
        where.append((nm, "d"))
        if v is not None:
            cols.append(v.contiguous())
            where.append((nm, "v"))
    outs, live, new_len, ovf = K.compact(
        cols, None if sel is None else sel.contiguous(), length, cap,
        new_cap)
    new_env = {nm: [None, None] for nm in names}
    for (nm, part), o in zip(where, outs):
        new_env[nm][0 if part == "d" else 1] = o
    return {nm: (d, v) for nm, (d, v) in new_env.items()}, live, new_len, \
        ovf


def compress(env, length, sel, cap: int, device):
    """BlockCompress: the selected rows, in order, at the front of the
    same capacity (the `compact` kernel). The port defines only the live
    prefix [0, length'); the reference also keeps the dropped rows after
    it. With the member axis (on the mask, the length or a column) each
    member compacts its own rows: (B, cap) columns and (B,) lengths
    through `compact_batched`."""
    B = _members(sel, *[x for pair in env.values() for x in pair])
    if not B and _is_member_length(length):
        B = length.shape[0]
    if B:
        names = list(env)
        cols, where = [], []
        for nm in names:
            d, v = env[nm]
            cols.append(_rows(d))
            where.append((nm, 0))
            if v is not None:
                cols.append(_rows(v))
                where.append((nm, 1))
        outs, live, _new_len, _ovf = K.compact_batched(
            cols, None if sel is None else _rows(sel), length, cap, cap, B)
        new_env = {nm: [None, None] for nm in names}
        for (nm, part), o in zip(where, outs):
            new_env[nm][part] = o
        return {nm: (d, v) for nm, (d, v) in new_env.items()}, live
    new_env, live, _new_len, _ovf = _compact_cols(env, length, sel, cap,
                                                  cap)
    return new_env, live


def compact_env(env, length, sel, cap: int, new_cap: int, device):
    """`ir.Compact` lowering: stable-compress selected rows to the front
    of a `new_cap`-row buffer. Returns (env', length', sel', live,
    overflow): `live` is the true selected count and `overflow = live >
    new_cap` — the executor's loud-rerun signal; rows beyond `new_cap`
    are dropped, so a result produced under overflow must be discarded."""
    new_env, live, new_len, ovf = _compact_cols(env, length, sel, cap,
                                                new_cap)
    new_sel = torch.arange(new_cap, dtype=torch.int32,
                           device=device) < new_len
    return new_env, new_len, new_sel, live, ovf


def compress_block(dblock: DeviceBlock, sel) -> DeviceBlock:
    """Apply a selection mask, compacting survivors to the block front
    (the `compact` kernel), at the same capacity."""
    names = tuple(dblock.schema.names)
    env = {n: (dblock.arrays[n], dblock.valids.get(n)) for n in names}
    device = dblock.length.device
    env, new_len = compress(env, dblock.length, sel, dblock.capacity,
                            device)
    out_d = {n: env[n][0] for n in names}
    out_v = {n: env[n][1] for n in names if env[n][1] is not None}
    return DeviceBlock(dblock.schema, out_d, out_v, new_len,
                       dblock.capacity, dict(dblock.dictionaries))


# --------------------------------------------------------------------------
# single-program entry points
# --------------------------------------------------------------------------


def run_on_device(program: ir.Program, dblock: DeviceBlock,
                  params: Optional[dict] = None) -> DeviceBlock:
    """Run a program over a device-resident block."""
    params = params or {}
    device = dblock.length.device
    dev_params = {k: (to_tensor(v, device) if isinstance(v, np.ndarray)
                      else v) for k, v in params.items()}
    in_cols = list(dblock.schema.columns)
    env = {c.name: (dblock.arrays[c.name], dblock.valids.get(c.name))
           for c in in_cols}
    cap = dblock.capacity
    env, length, sel, schema = _trace_program(
        program, in_cols, cap, env, dblock.length, dev_params, device)
    if sel is not None:
        out_cap = next(iter(env.values()))[0].shape[0] if env else cap
        env, length = compress(env, length, sel, out_cap, device)
    out_d = {nm: env[nm][0] for nm in schema.names}
    out_v = {nm: env[nm][1] for nm in schema.names if env[nm][1] is not None}
    out_schema = ir.infer_schema(program, dblock.schema)
    dicts = {n: d for n, d in dblock.dictionaries.items() if out_schema.has(n)}
    out_cap = (next(iter(out_d.values())).shape[0] if out_d
               else dblock.capacity)
    return DeviceBlock(out_schema, out_d, out_v, length, out_cap, dicts)


def run_program(program: ir.Program, block: HostBlock,
                params: Optional[dict] = None, device=None) -> HostBlock:
    """Host-convenience entry: pad → device → program → HostBlock. Runs
    on ``cuda`` unless `device` says otherwise."""
    from ydb_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    return to_host(run_on_device(program, to_device(block, dev), params))
