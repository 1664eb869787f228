"""Distributed shuffle join: a partitioned build and the probe-row
exchange (port of ``ydb_tpu/parallel/shuffle_join.py``).

When a join's build side is too large to broadcast to every shard, both
sides partition by the hash of the join key. The build is partitioned on
the host (splitmix64, the family of every other routing decision) with
partition d placed on mesh shard d, so no shard holds the full build.
Probe rows arrive as each shard's pipeline prefix output; per shard they
are bucketed by key into send segments (the `segments` kernel), the
exchange hands each shard the rows of its keys, and each shard compacts
them, probes its local partition (the `probe` kernel, through
`ops/join.probe_lut_traced`) and runs the rest of the pipeline (the
post-join programs and the partial aggregation) without leaving its
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.schema import Schema
from ydb_tpu_torch.ops.device import DeviceBlock, bucket_capacity
from ydb_tpu_torch.ops.join import build as build_table
from ydb_tpu_torch.ops.torch_ns import to_tensor
from ydb_tpu_torch.parallel.collective import (
    compact_segments, exchange_segments, route_segments,
)
from ydb_tpu_torch.parallel.shuffle import _fuse_device_blocks, device_params
from ydb_tpu_torch.utils.hashing import splitmix64


def partition_build(built: HostBlock, key: str, payload: list, ndev: int):
    """Hash-partition a build side into ndev per-shard build tables, as
    the host arrays the shards take: row p of each array is partition p.
    Returns (arrays {keys [ndev, cap] sorted with an INT64_MAX pad, ns
    [ndev], payload {name: [ndev, cap]}, pvalid {name: [ndev, cap]}},
    payload schema, dictionaries, cap)."""
    from ydb_tpu_torch.ops.join import _host_key

    enc, valid = _host_key(built, key)
    if valid is not None:
        keep = np.nonzero(valid)[0]       # NULL keys never match
        built = built.take(keep)
        enc = enc[keep]
    h = splitmix64(np, enc.astype(np.int64))
    part = (h % np.uint64(ndev)).astype(np.int64)
    host = torch.device("cpu")
    tables = []
    for p in range(ndev):
        idx = np.nonzero(part == p)[0]
        tables.append(build_table(built.take(idx), key, list(payload), host))
    cap = max(t.keys_sorted.shape[0] for t in tables)
    keys = np.full((ndev, cap), np.iinfo(np.int64).max, np.int64)
    ns = np.zeros(ndev, np.int32)
    payload_np: dict = {n: None for n in payload}
    pvalid_np: dict = {}
    for p, t in enumerate(tables):
        k = t.keys_sorted.numpy()
        keys[p, :k.shape[0]] = k
        ns[p] = t.n
        for n in payload:
            arr = t.payload[n].numpy()
            if payload_np[n] is None:
                payload_np[n] = np.zeros((ndev, cap), arr.dtype)
            payload_np[n][p, :len(arr)] = arr
            pv = t.payload_valid.get(n)
            if pv is not None:
                pvalid_np.setdefault(n, np.zeros((ndev, cap), np.bool_))
                pvalid_np[n][p, :pv.shape[0]] = pv.numpy()
    dicts = dict(tables[0].dictionaries) if tables else {}
    return ({"keys": keys, "ns": ns, "payload": payload_np,
             "pvalid": pvalid_np},
            tables[0].schema if tables else Schema([]), dicts, cap)


class ShuffleJoin:
    """Probe-row exchange, local probe and post-join pipeline."""

    def __init__(self, mesh, in_schema: Schema, probe_key: str, kind: str,
                 payload_cols: list, mark_col: str, not_in: bool,
                 rest_programs: list, partial):
        self.mesh = mesh
        self.in_schema = in_schema
        self.probe_key = probe_key
        self.kind = kind
        self.payload_cols = payload_cols       # [Column] appended by probe
        self.mark_col = mark_col
        self.not_in = not_in
        self.rest_programs = rest_programs     # [ir.Program] after the join
        self.partial = partial                 # ir.Program | None

    def _place_build(self, build_arrays: dict) -> list:
        """Partition p of the build on shard p: per shard (keys, payload,
        pvalid). Shards that share a device take rows of one upload."""
        devices = list(self.mesh.devices.flat)
        shared = self.mesh.shared_device

        def rows(a):
            if shared is not None:
                return list(to_tensor(a, shared).unbind(0))
            return [to_tensor(a[p], dev) for p, dev in enumerate(devices)]
        keys = rows(build_arrays["keys"])
        pay = {n: rows(a) for n, a in build_arrays["payload"].items()}
        pv = {n: rows(a) for n, a in build_arrays["pvalid"].items()}
        return [(keys[p], {n: a[p] for n, a in pay.items()},
                 {n: a[p] for n, a in pv.items()})
                for p in range(len(devices))]

    def run(self, per_dev_blocks: list, build_arrays: dict, params: dict,
            dicts: dict) -> list:
        """per_dev_blocks[d]: the pipeline prefix's DeviceBlocks on shard
        d. Returns one post-join (post-partial) DeviceBlock per shard."""
        from ydb_tpu_torch.ops.join import probe_lut_traced
        from ydb_tpu_torch.ops.torch_exec import _trace_program, compress
        devices = list(self.mesh.devices.flat)
        ndev = len(devices)
        names = list(self.in_schema.names)
        in_cols = list(self.in_schema.columns)
        pcap = bucket_capacity(max(sum(b.capacity for b in blks)
                                   for blks in per_dev_blocks), minimum=128)
        # route probe rows to their key's owner; seg = pcap: full-capacity
        # segments cannot overflow
        sends = []
        for blks in per_dev_blocks:
            env, glen = _fuse_device_blocks(blks, pcap, names)
            sd, sv, cnts, _ovf = route_segments(env, [self.probe_key], glen,
                                                pcap, pcap, ndev, names)
            sends.append((sd, sv, cnts))
        builds = self._place_build(build_arrays)
        payload_names = tuple(sorted(build_arrays["payload"]))
        meta = {"probe_key": self.probe_key, "kind": self.kind,
                "payload_names": payload_names, "src_names": payload_names,
                "mark_col": self.mark_col, "not_in": self.not_in,
                "bsearch": True, "late": False}
        flat = ndev * pcap
        blocks = []
        for t, (rd, rv, rc) in enumerate(
                exchange_segments(sends, names, devices)):
            dev = devices[t]
            prm = device_params(params, dev)
            env2, tot = compact_segments(rd, rv, rc, pcap, ndev, names)
            # probe the shard's own build partition
            bkeys, bpay, bpv = builds[t]
            act = torch.arange(flat, dtype=torch.int32, device=dev) < tot
            env2, out_sel = probe_lut_traced(
                env2, act, {"lut": None, "lut_base": 0,
                            "n": int(build_arrays["ns"][t]),
                            "has_null": False, "keys": bkeys,
                            "payload": bpay, "pvalid": bpv}, meta)
            schema = Schema(list(in_cols))
            for c in self.payload_cols:
                schema = Schema([x for x in schema.columns
                                 if x.name != c.name] + [c])
            if self.kind != "mark":
                env2, tot = compress(env2, tot, out_sel, flat, dev)
            # the rest of the pipeline and the partial, on the shard
            cap2 = flat
            sel = None
            for prog in [*self.rest_programs, *([self.partial]
                                                 if self.partial else [])]:
                env2, tot, sel, schema = _trace_program(
                    prog, schema.columns, cap2, env2, tot, prm, dev,
                    sel=sel)
                if env2:
                    cap2 = next(iter(env2.values()))[0].shape[0]
            if sel is not None:
                env2, tot = compress(env2, tot, sel, cap2, dev)
            out_d = {n: env2[n][0] for n in schema.names}
            out_v = {n: (env2[n][1] if env2[n][1] is not None
                         else torch.ones_like(out_d[n], dtype=torch.bool))
                     for n in schema.names}
            out_cap = next(iter(out_d.values())).shape[0] if out_d else 0
            blocks.append(DeviceBlock(
                schema, out_d, out_v, tot, out_cap,
                {n: dc for n, dc in dicts.items() if schema.has(n)}))
        return blocks

