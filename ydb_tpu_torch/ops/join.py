"""Broadcast join (port of ``ydb_tpu/ops/join.py``).

The build side is sorted on the host once per build (``build``) and
placed on the engine's device: sorted keys padded to a power-of-two
capacity with a +inf / INT64_MAX sentinel, the payload columns in key
order, and — for integral keys with a bounded span — a direct-address
LUT (key − lut_base → sorted build row, −1 = absent). The probe runs
inside the fused query as the ``probe`` CUDA kernel: a LUT lookup or a
branchless lower_bound, the join-kind selection with the NOT IN rule,
and the payload gathers (or, under late materialization, the
(row id, found) pair the fused body gathers from later).

The portioned path probes one scan block at a time: ``probe`` runs the
same kernel over a ``DeviceBlock`` and appends the payloads, and
``probe_expand`` joins against a build with duplicate keys through the
``expand_counts`` and ``expand_gather`` kernels (K8), with one readback
of the output row count to size the result.

A build side above the executor's grace budget is split on the host by
key hash into a ``PartitionedBuild`` (``build_partitioned``, GraceJoin);
the executor routes each probe block to the partitions with the
``partition`` kernel and probes each partition's rows against its table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.dtypes import DType, Kind
from ydb_tpu_torch.core.schema import Column, Schema
from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.device import DeviceBlock, bucket_capacity
from ydb_tpu_torch.ops.torch_ns import to_tensor


def _host_key(block: HostBlock, name: str) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Key in its search domain: float keys stay float64, the rest int64."""
    cd = block.columns[name]
    d = cd.data
    if np.issubdtype(d.dtype, np.floating):
        return d.astype(np.float64), cd.valid
    return d.astype(np.int64), cd.valid


_LUT_SPAN_BUDGET = 1 << 26         # max direct-address entries (256MB int32)
_FD_BUDGET = 1 << 28               # max host bytes retained for FD checks


@dataclass
class BuildTable:
    """Sorted build side, resident on the engine's device (see module
    doc). With duplicate keys the LUT holds the FIRST sorted row of the
    key run (existence checks — semi/anti/mark — stay LUT-probeable)."""
    keys_sorted: object            # int64 / float64 tensor (sentinel-padded)
    n: int                         # real build rows
    payload: dict                  # name -> tensor (sorted by key)
    payload_valid: dict            # name -> bool tensor
    schema: Schema                 # payload schema
    dictionaries: dict
    unique: bool
    lut: object = None             # int32 tensor (span,) or None
    lut_base: int = 0              # key value of lut[0]
    # NOT IN: the build side contained a NULL key — x NOT IN S is then
    # never TRUE for any x, so a not_in anti probe must select nothing
    anti_has_null: bool = False
    # bounds lattice: the HOST build block (post null-key drop), retained
    # so the executor's carry rewrite can VERIFY functional dependencies
    fd_block: object = None
    fd_memo: object = None         # {cols tuple: distinct count} cache


@dataclass
class PartitionedBuild:
    """GraceJoin-style hash-partitioned build side (`mkql_grace_join.cpp`):
    the build rows are split on the host by key hash into partitions
    small enough for the grace budget; the probe side routes each row to
    its key's partition, so every partition joins independently. Each
    partition is a `BuildTable` placed on the device by `build`, as the
    reference places them, so all partitions are device-resident at once
    (keeping them in host memory until probed is later work)."""
    tables: list                   # [BuildTable] per partition
    n_partitions: int
    key: str


def build(block: HostBlock, key: str, payload_names: list[str], device,
          keep_fd: bool = False) -> BuildTable:
    enc, valid = _host_key(block, key)
    if valid is not None:
        # null build keys never match; drop them
        keep = np.nonzero(valid)[0]
        block = block.take(keep)
        enc = enc[keep]
    order = np.argsort(enc, kind="stable")
    enc = enc[order]
    unique = bool(np.all(np.diff(enc) != 0)) if len(enc) > 1 else True
    cap = bucket_capacity(max(len(enc), 1), minimum=128)
    sentinel = np.inf if enc.dtype == np.float64 else np.iinfo(np.int64).max
    keys_pad = np.full(cap, sentinel, dtype=enc.dtype)
    keys_pad[:len(enc)] = enc

    lut = None
    lut_base = 0
    if enc.dtype != np.float64 and len(enc):
        lo, hi = int(enc[0]), int(enc[-1])
        span = hi - lo + 1
        # density cap 64x (see the reference): the absolute budget still
        # bounds device memory
        if 0 < span <= max(1 << 12, min(_LUT_SPAN_BUDGET, 64 * len(enc))):
            span_cap = bucket_capacity(span, minimum=1024)
            lut_np = np.full(span_cap, -1, np.int32)
            offs = (enc - lo).astype(np.int64)
            # first sorted row of each key run wins (reversed assignment:
            # numpy keeps the last write, which is the run's first row)
            lut_np[offs[::-1]] = np.arange(len(enc) - 1, -1, -1,
                                           dtype=np.int32)
            lut = to_tensor(lut_np, device)
            lut_base = lo

    payload, payload_valid, dicts = {}, {}, {}
    for name in payload_names:
        cd = block.columns[name]
        d = cd.data[order]
        pad = np.zeros(cap - len(d), dtype=d.dtype)
        payload[name] = to_tensor(np.concatenate([d, pad]), device)
        if cd.valid is not None:
            v = np.concatenate([cd.valid[order],
                                np.zeros(cap - len(d), np.bool_)])
            payload_valid[name] = to_tensor(v, device)
        if cd.dictionary is not None:
            dicts[name] = cd.dictionary
    from ydb_tpu_torch.query.bounds import bounds_enabled
    fd_block = block if keep_fd and unique and bounds_enabled() \
        and block.length \
        and sum(cd.data.nbytes
                for cd in block.columns.values()) <= _FD_BUDGET \
        else None
    return BuildTable(to_tensor(keys_pad, device), len(enc), payload,
                      payload_valid, block.schema.select(payload_names),
                      dicts, unique, lut, lut_base, fd_block=fd_block)


def place(table: BuildTable, device) -> BuildTable:
    """The build table on `device` (the broadcast leg of a join on a
    mesh: every shard probes its own copy). A table already there is
    returned as it is, not copied."""
    dev = torch.device(device)

    def put(x):
        return x.to(dev, non_blocking=True)
    if table.keys_sorted.device == dev or (
            dev.type == table.keys_sorted.device.type == "cuda"
            and dev.index is None):
        return table
    return BuildTable(
        put(table.keys_sorted), table.n,
        {k: put(v) for k, v in table.payload.items()},
        {k: put(v) for k, v in table.payload_valid.items()},
        table.schema, table.dictionaries, table.unique,
        None if table.lut is None else put(table.lut), table.lut_base,
        table.anti_has_null)


def build_partitioned(block: HostBlock, key: str, payload_names: list[str],
                      budget_bytes: int, device) -> PartitionedBuild:
    """Partition a too-big build side by key hash (splitmix64, matching
    the device-side routing in the probe)."""
    from ydb_tpu_torch.utils.hashing import splitmix64

    row_bytes = max(1, sum(block.columns[n].data.itemsize
                           for n in payload_names) + 8)
    total = row_bytes * max(block.length, 1)
    nparts = 1
    while total / nparts > budget_bytes:
        nparts *= 2
    enc, _valid = _host_key(block, key)
    h = splitmix64(np, enc.astype(np.int64))
    part = (h % np.uint64(nparts)).astype(np.int64)
    tables = []
    for p in range(nparts):
        idx = np.nonzero(part == p)[0]
        tables.append(build(block.take(idx), key, payload_names, device))
    return PartitionedBuild(tables, nparts, key)


def _probe_enc(d: torch.Tensor) -> torch.Tensor:
    if d.dtype.is_floating_point:
        return d.to(torch.float64).contiguous()
    return d.to(torch.int64).contiguous()


def probe_lut_traced(env: dict, sel, bt_arrays: dict, meta: dict):
    """Build-probe inside a fused query (`ops/fused.py`) through the
    `probe` kernel: a direct-address LUT lookup when the build has one,
    a lower_bound on the sorted keys otherwise (sparse key spans, float
    keys).

    env: {name: (data, valid|None)}; sel: bool selection mask — REQUIRED,
    already including the row-activity mask; bt_arrays: build inputs
    {lut, lut_base, n, has_null, keys, payload, pvalid} (`fused.
    build_traced_inputs`); meta (static): probe_key, kind, payload_names,
    src_names, mark_col, not_in, bsearch, late, row_col, found_col.

    Returns (env', sel'). Selection: matched rows for inner/semi,
    unmatched for anti, all for left/mark.

    The member axis (the batched lane): with a shared key and a
    per-member `sel` (B, cap), ONE probe over the union of the members'
    masks serves them all — on a row active in member b the union's
    match, payloads and mark equal b's own, and each member's selection
    is the union's result AND its own mask, for every kind (inner, left,
    semi, anti, NOT IN: `_probe_members`). A per-member key probes the
    B·cap rows flattened."""
    if sel is None:
        raise ValueError("probe_lut_traced needs the row-activity mask")
    d, v = env[meta["probe_key"]]
    if d.dim() == 2 or (v is not None and v.dim() == 2):
        return _probe_members(env, sel, bt_arrays, meta)
    if sel.dim() == 2:
        env2, out_sel = probe_lut_traced(env, sel.any(0), bt_arrays, meta)
        return env2, out_sel & sel
    kind = meta["kind"]
    if not meta.get("bsearch") and d.dtype.is_floating_point:
        # LUTs address integer keys; truncating a float probe would
        # mis-match (10.5 → 10) — floats must take the bsearch path
        raise TypeError("LUT probe requires an integral probe key")
    enc = _probe_enc(d)
    pcap = next(iter(bt_arrays["payload"].values())).shape[0] \
        if bt_arrays["payload"] else d.shape[0]
    late = bool(meta.get("late")) and kind in ("inner", "left")
    gather = () if late or kind not in ("inner", "left", "mark") \
        else meta["src_names"]
    keys = bt_arrays["keys"]
    if meta.get("bsearch"):
        enc, keys = _matched_domain(enc, keys)
    found, safe, out_sel, gathered = K.probe(
        enc, None if v is None else v.contiguous(), sel.contiguous(),
        lut=None if meta.get("bsearch") else bt_arrays["lut"],
        lut_base=bt_arrays["lut_base"], keys_sorted=keys,
        n_build=bt_arrays["n"], pcap=pcap, kind=kind,
        not_in=meta["not_in"], has_null=bt_arrays["has_null"],
        payloads=[(bt_arrays["payload"][s], bt_arrays["pvalid"].get(s))
                  for s in gather])

    env2 = dict(env)
    if late:
        env2[meta["row_col"]] = (safe, None)
        env2[meta["found_col"]] = (found, None)
    else:
        for (src, out), (gd, gv) in zip(
                [(s, o) for s, o in zip(meta["src_names"],
                                        meta["payload_names"])
                 if s in gather], gathered):
            env2[out] = (gd, gv)
    if kind == "mark":
        env2[meta["mark_col"] or "__mark"] = (found, None)
    return env2, out_sel


def _probe_members(env: dict, sel, bt_arrays: dict, meta: dict):
    """`probe_lut_traced` for a per-member probe key: one probe over the
    B·cap rows (every column the probe reads flattened along the member
    axis), its outputs back at (B, cap)."""
    d, v = env[meta["probe_key"]]
    B, cap = (d if d.dim() == 2 else v).shape

    def flat(x):
        if x is None:
            return None
        return (x if x.dim() == 2 else x.unsqueeze(0).expand(B, cap)) \
            .reshape(-1)
    flat_env = {meta["probe_key"]: (flat(d), flat(v))}
    env2, out_sel = probe_lut_traced(flat_env, flat(sel), bt_arrays, meta)
    out = dict(env)
    for name, (gd, gv) in env2.items():
        if name != meta["probe_key"]:
            out[name] = (gd.reshape(B, cap),
                         None if gv is None else gv.reshape(B, cap))
    return out, out_sel.reshape(B, cap)


def _matched_domain(enc: torch.Tensor, keys: torch.Tensor):
    """Probe encoding and sorted keys in one dtype (the reference's
    promotion: an int probe against float keys, or the reverse, compares
    as float64)."""
    if keys.dtype != enc.dtype:
        return enc.to(torch.float64), keys.to(torch.float64)
    return enc, keys


def probe(dblock: DeviceBlock, table: BuildTable, probe_key: str,
          kind: str = "inner", mark_col: Optional[str] = None,
          not_in: bool = False) -> tuple[DeviceBlock, object]:
    """Probe a device block against a build table (the portioned path).

    Returns (new DeviceBlock with payload columns appended, new selection
    mask); the caller decides when to compress. The ``probe`` kernel runs
    its lower_bound over the sorted keys (the reference's searchsorted).
    Kind "mark" keeps every active row, attaches payloads (null where
    unmatched) and a bool `mark_col` column holding the match flag."""
    if not table.unique and kind in ("inner", "left", "mark"):
        raise ValueError(
            "broadcast MapJoin requires unique build keys for inner/left "
            "joins; duplicate keys need the expanding probe")
    names = tuple(table.schema.names)
    cap = dblock.capacity
    dev = dblock.arrays[probe_key].device
    active = torch.arange(cap, dtype=torch.int32, device=dev) \
        < dblock.length
    v = dblock.valids.get(probe_key)
    enc, keys = _matched_domain(_probe_enc(dblock.arrays[probe_key]),
                                table.keys_sorted)
    gather = names if kind in ("inner", "left", "mark") else ()
    found, _safe, out_sel, gathered = K.probe(
        enc, None if v is None else v.contiguous(), active.contiguous(),
        lut=None, lut_base=0, keys_sorted=keys, n_build=table.n,
        pcap=keys.shape[0], kind=kind, not_in=not_in,
        has_null=table.anti_has_null,
        payloads=[(table.payload[s], table.payload_valid.get(s))
                  for s in gather])

    arrays = dict(dblock.arrays)
    valids = dict(dblock.valids)
    dicts = dict(dblock.dictionaries)
    cols = list(dblock.schema.columns)
    for name, (gd, gv) in zip(gather, gathered):
        arrays[name] = gd
        valids[name] = gv
        dt = table.schema.dtype(name).with_nullable(True)
        cols = [c for c in cols if c.name != name] + [Column(name, dt)]
        if name in table.dictionaries:
            dicts[name] = table.dictionaries[name]
    if kind == "mark":
        name = mark_col or "__mark"
        arrays[name] = found
        cols = [c for c in cols if c.name != name] + [
            Column(name, DType(Kind.BOOL, nullable=False))]
    out = DeviceBlock(Schema(cols), arrays, valids, dblock.length, cap,
                      dicts)
    return out, out_sel


def probe_expand(dblock: DeviceBlock, table: BuildTable, probe_key: str,
                 kind: str = "inner") -> DeviceBlock:
    """Join a device block against a build table with duplicate keys.

    Returns a NEW compacted DeviceBlock whose capacity is the bucket for
    the expanded row count (inner: one output row per probe×build match;
    left: additionally one null-extended row per unmatched probe row),
    rows in probe order and, within a probe row, in sorted build order.
    One device→host read of the total decides the capacity bucket."""
    assert kind in ("inner", "left"), kind
    enc, keys = _matched_domain(_probe_enc(dblock.arrays[probe_key]),
                                table.keys_sorted)
    v = dblock.valids.get(probe_key)
    lo, mcounts, offsets, total = K.expand_counts(
        enc, None if v is None else v.contiguous(), dblock.length, keys,
        table.n, kind == "left")
    n_out = int(total)                     # sync point (capacity decision)
    out_cap = bucket_capacity(max(n_out, 1), minimum=128)
    names = tuple(table.schema.names)
    pcap = keys.shape[0]
    # one gather over every column: the probe side's data and validity
    # at the slot's probe row, the payloads and their validity at its
    # build row
    probe_cols = [c.name for c in dblock.schema.columns
                  if c.name not in names]
    specs, where = [], []
    for name in probe_cols:
        specs.append((dblock.arrays[name].contiguous(), "probe"))
        where.append((name, "d"))
        if name in dblock.valids:
            specs.append((dblock.valids[name].contiguous(), "probe"))
            where.append((name, "v"))
    for name in names:
        specs.append((table.payload[name], "build"))
        where.append((name, "d"))
        specs.append((table.payload_valid.get(name), "build_valid"))
        where.append((name, "v"))
    outs = K.expand_gather(lo, mcounts, offsets, total, out_cap, pcap, specs)
    out_arrays, out_valids = {}, {}
    for (name, part), o in zip(where, outs):
        (out_arrays if part == "d" else out_valids)[name] = o

    dicts = dict(dblock.dictionaries)
    cols = [c for c in dblock.schema.columns if c.name not in names]
    for n in names:
        cols.append(Column(n, table.schema.dtype(n).with_nullable(True)))
        if n in table.dictionaries:
            dicts[n] = table.dictionaries[n]
    length = torch.tensor(n_out, dtype=torch.int32, device=enc.device)
    return DeviceBlock(Schema(cols), out_arrays, out_valids, length, out_cap,
                       dicts)
