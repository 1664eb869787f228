"""CPU oracle lowering of SSA programs.

Executes a ``Program`` over a ``HostBlock`` with plain numpy. This is the
correctness reference every XLA kernel is differentially tested against —
the role Arrow compute plays for the reference's ColumnShard program
(`ydb/core/formats/arrow/program.cpp` TProgramStep::Apply).

Selection-vector semantics mirror the reference's ``TColumnFilter``
(`ydb/core/formats/arrow/arrow_filter.h`): filters accumulate a boolean
mask; rows are only physically compacted at block egress or before a
GroupBy.
"""

from __future__ import annotations

# lint: allow-file-host-sync(CPU oracle lane — operates on host numpy only, never device values)

from typing import Optional

import numpy as np

from ydb_tpu_torch.core.block import ColumnData, HostBlock
from ydb_tpu_torch.core.dtypes import Kind
from ydb_tpu_torch.core.schema import Column, Schema
from ydb_tpu_torch.ops import ir
from ydb_tpu_torch.ops.kernels import KERNELS


def _eval(expr, cols: dict, schema: Schema, params: dict, n: int):
    """Evaluate an expression → (data, valid) over full-length arrays."""
    if isinstance(expr, ir.Col):
        cd = cols[expr.name]
        return cd[0], cd[1]
    if isinstance(expr, ir.Const):
        return np.full(n, expr.value, dtype=expr.dtype.np), None
    if isinstance(expr, ir.Param):
        val = params[expr.name]
        if expr.is_array:
            return np.asarray(val, dtype=expr.dtype.np), None
        return np.full(n, val, dtype=expr.dtype.np), None
    if isinstance(expr, ir.Call):
        k = KERNELS[expr.op]
        args = [_eval(a, cols, schema, params, n) for a in expr.args]
        extra = expr.extra_dict()
        if k.null_mode == "custom":
            return k.impl_nv(np, args, extra)
        data = k.impl(np, [a[0] for a in args], extra)
        valid = None
        for _, v in args:
            if v is not None:
                valid = v if valid is None else (valid & v)
        return data, valid
    raise TypeError(f"bad expr {expr!r}")


def canonical_key_pair(d, v):
    """Canonical (physical int64, validity int64) encoding of ONE
    group-key column — the grouping equality itself: all NULLs form one
    value, -0.0 == 0.0, all NaNs equal. Shared by the group-by oracle
    below and the bounds lattice's functional-dependency verification
    (`query/bounds.dataset_distinct`), which must count distinct tuples
    under exactly the equality grouping uses — a drift between the two
    would let a "verified" dependency silently merge groups."""
    if v is not None:  # SQL: all NULL keys form one group
        d = np.where(v, d, np.zeros((), d.dtype))
    if np.issubdtype(d.dtype, np.floating):
        d = np.where(d == 0, np.zeros((), d.dtype), d)
        d = np.where(np.isnan(d), np.full((), np.nan, d.dtype), d)
        phys = d.astype(np.float64).view(np.uint64)
    else:
        phys = d
    valid = (v if v is not None else np.ones(len(d), bool)).astype(np.int64)
    return np.ascontiguousarray(phys.astype(np.int64)), valid


def _group_by(cmd: ir.GroupBy, cols: dict, schema: Schema, sel):
    n = None
    for d, _ in cols.values():
        n = len(d)
        break
    idx = np.nonzero(sel)[0] if sel is not None else np.arange(n)

    # -- key codes: np.unique over a (rows, nkeys*2) matrix incl. validity --
    if cmd.keys:
        mats = []
        for kname in cmd.keys:
            d, v = cols[kname]
            phys, valid = canonical_key_pair(
                d[idx], v[idx] if v is not None else None)
            mats.append(phys)
            mats.append(valid)
        mat = np.stack(mats, axis=1) if mats else np.zeros((len(idx), 0), np.int64)
        uniq, inverse = np.unique(mat, axis=0, return_inverse=True)
        inverse = np.asarray(inverse).reshape(-1)
        ngroups = len(uniq)
        first = np.full(ngroups, len(idx), dtype=np.int64)
        np.minimum.at(first, inverse, np.arange(len(idx)))
    else:
        ngroups = 1
        inverse = np.zeros(len(idx), dtype=np.int64)
        first = np.zeros(1, dtype=np.int64)

    out_cols: dict[str, tuple] = {}
    # carried keys (functionally determined by `keys`) take the group
    # leader's value, exactly like the device lowerings
    for kname in list(cmd.keys) + list(cmd.carry_keys):
        d, v = cols[kname]
        dk, vk = d[idx], (v[idx] if v is not None else None)
        out_cols[kname] = (dk[first], vk[first] if vk is not None else None)

    for a in cmd.aggs:
        if a.func == "count_all":
            data = np.bincount(inverse, minlength=ngroups).astype(np.uint64)
            out_cols[a.out] = (data, None)
            continue
        d, v = cols[a.arg]
        dk = d[idx]
        vk = v[idx] if v is not None else np.ones(len(idx), bool)
        if a.func == "count":
            data = np.bincount(inverse, weights=vk.astype(np.float64),
                               minlength=ngroups).astype(np.uint64)
            out_cols[a.out] = (data, None)
            continue
        any_valid = np.zeros(ngroups, dtype=bool)
        np.logical_or.at(any_valid, inverse, vk)
        if a.func == "sum":
            acc_dt = np.float64 if np.issubdtype(dk.dtype, np.floating) else np.int64
            acc = np.zeros(ngroups, dtype=acc_dt)
            np.add.at(acc, inverse, np.where(vk, dk, 0).astype(acc_dt))
            out_cols[a.out] = (acc, any_valid if not np.all(any_valid) else None)
        elif a.func in ("min", "max"):
            if np.issubdtype(dk.dtype, np.floating):
                sentinel = np.inf if a.func == "min" else -np.inf
            else:
                info = np.iinfo(dk.dtype)
                sentinel = info.max if a.func == "min" else info.min
            acc = np.full(ngroups, sentinel, dtype=dk.dtype)
            op = np.minimum if a.func == "min" else np.maximum
            op.at(acc, inverse, np.where(vk, dk, sentinel).astype(dk.dtype))
            out_cols[a.out] = (acc, any_valid if not np.all(any_valid) else None)
        elif a.func == "some":
            acc = np.zeros(ngroups, dtype=dk.dtype)
            pos = np.full(ngroups, len(idx), dtype=np.int64)
            valid_pos = np.where(vk, np.arange(len(idx)), len(idx))
            np.minimum.at(pos, inverse, valid_pos)
            ok = pos < len(idx)
            acc[ok] = dk[pos[ok]]
            out_cols[a.out] = (acc, any_valid if not np.all(any_valid) else None)
        else:
            raise ValueError(a.func)
    return out_cols, ngroups


def run_program(program: ir.Program, block: HostBlock,
                params: Optional[dict] = None) -> HostBlock:
    params = params or {}
    schema = Schema(list(block.schema.columns))
    cols = {c.name: (block.columns[c.name].data, block.columns[c.name].valid)
            for c in schema}
    dicts = {c.name: block.columns[c.name].dictionary for c in schema}
    sel = None
    n = block.length

    for cmd in program.commands:
        if isinstance(cmd, ir.Assign):
            data, valid = _eval(cmd.expr, cols, schema, params, n)
            if np.isscalar(data) or (hasattr(data, "shape") and data.shape == ()):
                data = np.full(n, data)
            dt = ir.infer_expr(cmd.expr, schema)
            cols[cmd.name] = (np.asarray(data, dtype=dt.np), valid)
            schema = Schema([c for c in schema.columns if c.name != cmd.name]
                            + [Column(cmd.name, dt)])
            if isinstance(cmd.expr, ir.Col):
                dicts[cmd.name] = dicts.get(cmd.expr.name)
        elif isinstance(cmd, ir.Filter):
            data, valid = _eval(cmd.pred, cols, schema, params, n)
            mask = data if valid is None else (data & valid)
            sel = mask if sel is None else (sel & mask)
        elif isinstance(cmd, ir.GroupBy):
            out_cols, ngroups = _group_by(cmd, cols, schema, sel)
            schema = ir.infer_schema(ir.Program([cmd]), schema)
            cols = {name: out_cols[name] for name in schema.names}
            sel = None
            n = ngroups
        elif isinstance(cmd, ir.Projection):
            schema = schema.select(list(cmd.names))
            cols = {nm: cols[nm] for nm in cmd.names}
        elif isinstance(cmd, ir.Compact):
            # the oracle is unpadded: compact just materializes the
            # selection. `cap` is a device-sizing hint — truncating here
            # would bake a forged bound into the truth the differential
            # tests compare against, so the oracle never truncates.
            if sel is not None:
                idx = np.nonzero(sel)[0]
                cols = {nm: (d[idx], v[idx] if v is not None else None)
                        for nm, (d, v) in cols.items()}
                n = len(idx)
                sel = None
        else:
            raise TypeError(f"bad command {cmd!r}")

    if sel is not None:
        idx = np.nonzero(sel)[0]
        cols = {nm: (d[idx], v[idx] if v is not None else None)
                for nm, (d, v) in cols.items()}
        n = len(idx)

    out = {}
    for c in schema:
        d, v = cols[c.name]
        out[c.name] = ColumnData(np.asarray(d, dtype=c.dtype.np), v, dicts.get(c.name))
    return HostBlock(schema, out, n)
