"""Mesh hash shuffle and the distributed two-phase aggregation (port of
``ydb_tpu/parallel/shuffle.py``).

Per shard: the partial GroupBy, then the rows bucketed by the hash of
their group key into `ndev` fixed-capacity send segments (the `segments`
kernel); the exchange hands segment t of every shard to shard t; per
shard again: the received segments compacted, then the final GroupBy.
Group keys are disjoint across shards after the exchange, so the host
only concatenates the per-shard results, in shard order. A keyless
aggregate (or a one-shard mesh) gathers every shard's partial instead
and merges it once, on the first shard.

Everything keeps the reference's static shapes. A segment holds `seg`
rows and carries its row count; an overflow (a target with more rows)
is flagged on the device, and `run` then reruns with full-capacity
segments, which cannot overflow. `run_device_blocks` sizes segments by
a proven bound and asserts that none overflowed.

The per-shard bodies are Python loops over the mesh's devices, each
running the port's programs (`ops/torch_exec._trace_program`) on its
shard's device; host syncs are one batched readout of the overflow
flags and lengths, and one of the results (`_finish`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.schema import Schema
from ydb_tpu_torch.ops import ir
from ydb_tpu_torch.ops.device import (
    batched_to_host, bucket_capacity, host_column,
)
from ydb_tpu_torch.ops.torch_ns import to_tensor
from ydb_tpu_torch.parallel.collective import (
    compact_segments, exchange_segments, gather_all, route_segments,
    segment_pad_account,
)
from ydb_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401


def _fuse_device_blocks(blocks: list, pcap: int, names):
    """Concatenate and compact one shard's partial blocks (DeviceBlocks
    on one device) into `pcap`-row buffers. Returns (env, length): every
    column with a valid (True where the block had none)."""
    from ydb_tpu_torch.ops.torch_exec import _compact_cols
    dev = blocks[0].length.device
    total = sum(b.capacity for b in blocks)
    mask = torch.cat([torch.arange(b.capacity, dtype=torch.int32,
                                   device=dev) < b.length for b in blocks])
    env = {}
    for n in names:
        env[n] = (torch.cat([b.arrays[n] for b in blocks]),
                  torch.cat([b.valids[n] if n in b.valids
                             else torch.ones(b.capacity, dtype=torch.bool,
                                             device=dev) for b in blocks]))
    env, _live, new_len, _ovf = _compact_cols(env, total, mask, total, pcap)
    return env, new_len


def device_params(params: dict, device) -> dict:
    """A statement's params as one shard's programs read them: host
    arrays uploaded to its device, scalars as they are."""
    return {k: (to_tensor(v, device) if isinstance(v, np.ndarray) else v)
            for k, v in params.items()}


@dataclass
class DistributedAgg:
    """Distributed two-phase aggregation over a device mesh."""

    partial: ir.Program
    final: ir.Program
    in_schema: Schema
    mesh: Mesh
    seg_rows: int = 0        # per-edge segment capacity (0: = capacity)

    # -- the per-shard body ------------------------------------------------

    def _build(self, cap: int):
        """The body over every shard at input capacity `cap`:
        `body(envs, lengths, params)` takes per-shard envs {name: (data,
        valid | None)} and lengths on the shards' devices and returns
        (outs, overflows, schema): per shard that reports rows a tuple
        (data, valid, length), the per-shard overflow flags, and the
        output schema."""
        devices = list(self.mesh.devices.flat)
        ndev = len(devices)
        in_cols = list(self.in_schema.columns)
        partial_prog, final_prog = self.partial, self.final
        gb = next(c for c in partial_prog.commands
                  if isinstance(c, ir.GroupBy))
        key_names = list(gb.keys)

        def run_final(env2, flat, tot, schema, params, dev):
            from ydb_tpu_torch.ops.torch_exec import _trace_program, compress
            fenv, flen, fsel, fschema = _trace_program(
                final_prog, list(schema.columns), flat, env2, tot, params,
                dev)
            if fsel is not None:
                fcap = next(iter(fenv.values()))[0].shape[0] if fenv \
                    else flat
                fenv, flen = compress(fenv, flen, fsel, fcap, dev)
            out_d = {n: fenv[n][0] for n in fschema.names}
            out_v = {n: (fenv[n][1] if fenv[n][1] is not None
                         else torch.ones_like(out_d[n], dtype=torch.bool))
                     for n in fschema.names}
            return (out_d, out_v, flen), fschema

        def body(envs, lengths, params):
            from ydb_tpu_torch.ops.torch_exec import _trace_program
            parts = []
            for d, dev in enumerate(devices):
                env, glen, sel, schema = _trace_program(
                    partial_prog, in_cols, cap, dict(envs[d]), lengths[d],
                    device_params(params, dev), dev)
                assert sel is None  # partial ends in GroupBy
                parts.append((env, glen, schema))
            schema = parts[0][2]
            names = list(schema.names)
            # the scatter group-by lanes shrink the working capacity
            pcap = next(iter(parts[0][0].values()))[0].shape[0] \
                if parts[0][0] else cap
            dev0 = devices[0]

            if not key_names or ndev == 1:
                # global aggregate: no shuffle; every shard's partial is
                # gathered and merged once, on the first shard (the
                # reference merges it on every shard and reports once)
                per_dev = []
                for env, glen, _s in parts:
                    per_dev.append((
                        {n: env[n][0] for n in names},
                        {n: (env[n][1] if env[n][1] is not None
                             else torch.ones(pcap, dtype=torch.bool,
                                             device=env[n][0].device))
                         for n in names}, glen))
                (env2, tot), = gather_all(per_dev, pcap, names, devices,
                                          receivers=[dev0])
                out, fschema = run_final(env2, ndev * pcap, tot, schema,
                                         device_params(params, dev0), dev0)
                return [out], [torch.zeros((), dtype=torch.bool,
                                           device=dev0)], fschema

            # hash shuffle: ndev segments of seg rows per shard, the
            # exchange, and the compaction of what each shard received
            seg = min(self.seg_rows or pcap, pcap)
            sends, overflows = [], []
            for env, glen, _s in parts:
                sd, sv, cnts, ovf = route_segments(env, key_names, glen,
                                                   pcap, seg, ndev, names)
                sends.append((sd, sv, cnts))
                overflows.append(ovf)
            outs, fschema = [], None
            for t, (rd, rv, rc) in enumerate(
                    exchange_segments(sends, names, devices)):
                env2, tot = compact_segments(rd, rv, rc, seg, ndev, names)
                out, fschema = run_final(env2, ndev * seg, tot, schema,
                                         device_params(params, devices[t]),
                                         devices[t])
                outs.append(out)
            return outs, overflows, fschema

        return body

    @staticmethod
    def _verdict(outs: list, overflows: list, device):
        """ONE readout of every shard's overflow flag and output length:
        (any overflow, [length per reporting shard])."""
        flags = torch.stack([o.to(device, non_blocking=True).reshape(())
                             for o in overflows])
        lens = torch.stack([torch.as_tensor(f).reshape(()).to(
            device=device, dtype=torch.int64, non_blocking=True)
            for (_d, _v, f) in outs])
        hflags, hlens = batched_to_host([flags, lens])
        return bool(hflags.any()), [int(x) for x in hlens]

    # -- run ---------------------------------------------------------------

    def run(self, blocks_per_device: list, params: Optional[dict] = None
            ) -> HostBlock:
        """blocks_per_device: one HostBlock per mesh shard (a row
        partition)."""
        devices = list(self.mesh.devices.flat)
        ndev = len(devices)
        assert len(blocks_per_device) == ndev
        params = params or {}
        cap = bucket_capacity(max(max(b.length for b in blocks_per_device),
                                  1))
        valid_names = [c.name for c in self.in_schema
                       if any(b.columns[c.name].valid is not None
                              for b in blocks_per_device)]
        envs, lengths = [], []
        for b, dev in zip(blocks_per_device, devices):
            env = {}
            pad = cap - b.length
            for c in self.in_schema:
                cd = b.columns[c.name]
                data = to_tensor(np.pad(cd.data, (0, pad)), dev)
                valid = None
                if c.name in valid_names:
                    v = cd.valid if cd.valid is not None \
                        else np.ones(b.length, np.bool_)
                    valid = to_tensor(np.pad(v, (0, pad)), dev)
                env[c.name] = (data, valid)
            envs.append(env)
            lengths.append(torch.tensor(b.length, dtype=torch.int32,
                                        device=dev))

        outs, overflows, fschema = self._build(cap)(envs, lengths, params)
        overflow, flens = self._verdict(outs, overflows, devices[0])
        if overflow:
            # overflowed rows were clamped on the device, so that result
            # is partial: discard it and rerun with full-capacity segments
            # (seg = pcap >= any per-target count: cannot overflow)
            assert self.seg_rows, "full-capacity segments cannot overflow"
            self.seg_rows = 0
            return self.run(blocks_per_device, params)
        # padding waste of the shuffle's fixed-capacity segments
        self.pad_account = segment_pad_account(
            "shuffle_segments", ndev, min(self.seg_rows or cap, cap),
            sum(b.length for b in blocks_per_device),
            sum(np.dtype(c.dtype.np).itemsize for c in self.in_schema)
            + len(valid_names))
        dicts = {}
        for b in blocks_per_device:
            for name, cd in b.columns.items():
                if cd.dictionary is not None:
                    dicts[name] = cd.dictionary
        return self._finish(outs, flens, fschema, dicts)

    def run_device_blocks(self, per_dev_blocks: list,
                          params: Optional[dict] = None) -> HostBlock:
        """The distributed merge over partials already on the shards:
        ``per_dev_blocks[d]`` lists DeviceBlocks on mesh device d (the
        per-portion partial aggregates of the executor). Each shard
        concatenates and compacts its partials, then the shuffle and
        merge run over them."""
        devices = list(self.mesh.devices.flat)
        assert len(per_dev_blocks) == len(devices)
        assert all(blks for blks in per_dev_blocks), \
            "every device needs at least one (possibly empty) partial block"
        params = params or {}
        names = tuple(self.in_schema.names)
        pcap = bucket_capacity(max(sum(b.capacity for b in blks)
                                   for blks in per_dev_blocks), minimum=128)
        fused = [_fuse_device_blocks(blks, pcap, names)
                 for blks in per_dev_blocks]
        outs, overflows, fschema = self._build(pcap)(
            [env for env, _l in fused], [ln for _e, ln in fused], params)
        overflow, flens = self._verdict(outs, overflows, devices[0])
        # seg_rows here is 0 (full capacity) or a PROVEN merge-GroupBy
        # bound (each producer's partial holds <= out_bound groups), so an
        # overflow means the bound is wrong: crash, never clamp rows
        assert not overflow, \
            "proven segment bound overflowed — bound source is wrong"
        dicts = {}
        for blks in per_dev_blocks:
            for b in blks:
                dicts.update(b.dictionaries)
        return self._finish(outs, flens, fschema, dicts)

    def _finish(self, outs: list, flens: list, fschema: Schema,
                dicts: dict) -> HostBlock:
        """Per-shard results → one host block, in shard order (groups are
        disjoint): ONE batched device→host copy of every (column, shard)
        prefix."""
        dev0 = self.mesh.devices.flat[0]
        tensors = []
        for (out_d, out_v, _f), n in zip(outs, flens):
            for c in fschema.columns:
                tensors.append(out_d[c.name][:n].to(dev0, non_blocking=True))
                tensors.append(out_v[c.name][:n].to(dev0, non_blocking=True))
        host = iter(batched_to_host(tensors))
        blocks = []
        for n in flens:
            cols = {}
            for c in fschema.columns:
                data, valid = next(host), next(host)
                cols[c.name] = host_column(data, valid, c.dtype,
                                           dicts.get(c.name))
            blocks.append(HostBlock(fschema, cols, n))
        return HostBlock.concat(blocks)
