"""Aggregation-state spill: device → host partitioned merge (port of
``ydb_tpu/ops/spill.py``).

When the partial group-by states of a query exceed the device merge
budget, each partial block is hash-partitioned BY GROUP KEY on the
device, read out to host memory in one copy, and the merge group-by then
runs per partition — partitions hold disjoint key sets, so per-partition
merges compose into the global result without ever holding all states
on the device at once (the reference WideCombiner's InMemory → Spilling
→ ProcessSpilled, `mkql_wide_combine.cpp:338-600`).

The partition step is the ``partition`` kernel (K14): a stable counting
sort by partition id after the ``hash64`` kernel (K12) hashes the group
keys. ``PartitionStore`` and ``host_sort_limit`` are the reference's
host code (`tests/test_torch_drift.py` holds them).
"""

from __future__ import annotations

import numpy as np
import torch

from ydb_tpu_torch.core.block import ColumnData, HostBlock
from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.device import batched_to_host, host_column

# fixed hash slot for NULL keys: every all-NULL key lands in one partition
_NULL_SENTINEL = -0x61C8864680B583EB

_TWO_63 = 2.0 ** 63


def as_int64(x: torch.Tensor) -> torch.Tensor:
    """`x.astype(int64)` as XLA converts: floats truncate toward zero,
    NaN → 0, and values outside the int64 range saturate (±inf too).
    torch's own conversion leaves those undefined (INT64_MIN on the CPU),
    and the partition of a key follows its int64 value."""
    if not x.dtype.is_floating_point:
        return x.to(torch.int64)
    f = x.to(torch.float64)
    # the largest double below 2^63 converts exactly; larger ones saturate
    t = torch.nan_to_num(f, nan=0.0).clamp(min=-_TWO_63,
                                           max=_TWO_63 - 1024.0)
    return torch.where(f >= _TWO_63,
                       torch.full_like(f, torch.iinfo(torch.int64).max,
                                       dtype=torch.int64),
                       t.to(torch.int64))


def key_hashes(arrays, valids, key_names) -> torch.Tensor:
    """Each row's group-key hash (uint64 as int64 bits, the `hash64`
    kernel): splitmix64 of each key's int64 value, NULL keys on a fixed
    sentinel, combined from the left. Float keys hash on their int64
    conversion — partitioning only needs same key → same partition, not
    injectivity."""
    encs = []
    for k in key_names:
        enc = as_int64(arrays[k])
        v = valids.get(k)
        if v is not None:
            enc = torch.where(v, enc, torch.full_like(enc, _NULL_SENTINEL))
        encs.append(enc)
    return K.hash64(encs)


def _partition_sort(arrays, valids, length, names: tuple, key_names: tuple,
                    nparts: int):
    """Move a block's rows into key-hash partition order; returns the
    moved columns plus per-partition row counts (no host sync)."""
    h = key_hashes(arrays, valids, key_names)
    anames, vnames = list(arrays), list(valids)
    cols = [arrays[n].contiguous() for n in anames] \
        + [valids[n].contiguous() for n in vnames]
    _ids, counts, moved = K.partition(h, length, nparts, cols, ids=False)
    out_arrays = dict(zip(anames, moved[:len(anames)]))
    out_valids = dict(zip(vnames, moved[len(anames):]))
    return out_arrays, out_valids, counts


def _fetch(schema, arrays: dict, valids: dict, counts):
    """One device→host copy of a partitioned block, columns in the
    schema's host dtypes (the port keeps unsigned values in wider or
    signed storage on the device)."""
    anames, vnames = list(arrays), list(valids)
    host = batched_to_host([arrays[n] for n in anames]
                           + [valids[n] for n in vnames] + [counts])
    h_arrays = {n: host_column(a, None, schema.dtype(n), None).data
                for n, a in zip(anames, host)}
    h_valids = dict(zip(vnames, host[len(anames):len(anames) + len(vnames)]))
    return h_arrays, h_valids, host[-1]


class PartitionStore:
    """Host-DRAM store of key-hash partitions of partial-agg blocks.

    feed() spills one device block; partition(p) returns the
    host-concatenated rows of partition p across every fed block."""

    def __init__(self, schema, key_names: list, nparts: int,
                 dictionaries: dict | None = None):
        self.schema = schema
        self.key_names = tuple(key_names)
        self.nparts = nparts
        self.dictionaries = dict(dictionaries or {})
        # partition -> list of {name: np array}, {name: np bool array}
        self._parts: list = [[] for _ in range(nparts)]
        self.spilled_rows = 0
        self.spilled_bytes = 0

    def feed(self, dblock) -> None:
        names = tuple(dblock.schema.names)
        arrays, valids, counts = _partition_sort(
            dblock.arrays, dblock.valids, dblock.length, names,
            self.key_names, self.nparts)
        h_arrays, h_valids, h_counts = _fetch(dblock.schema, arrays, valids,
                                              counts)
        self.dictionaries.update(dblock.dictionaries)
        bounds = np.cumsum(h_counts)
        total = int(bounds[-1])
        self.spilled_rows += total
        lo = 0
        for p in range(self.nparts):
            hi = int(bounds[p])
            if hi > lo:
                piece_a = {n: a[lo:hi] for n, a in h_arrays.items()}
                piece_v = {n: v[lo:hi] for n, v in h_valids.items()}
                self._parts[p].append((piece_a, piece_v))
                self.spilled_bytes += sum(a.nbytes for a in piece_a.values())
                self.spilled_bytes += sum(v.nbytes for v in piece_v.values())
            lo = hi

    def partition(self, p: int) -> HostBlock:
        pieces = self._parts[p]
        cols = {}
        if not pieces:
            for c in self.schema.columns:
                cols[c.name] = ColumnData(np.zeros(0, dtype=c.dtype.np),
                                          None, self.dictionaries.get(c.name))
            return HostBlock(self.schema, cols, 0)
        n = sum(len(next(iter(a.values()))) for (a, _v) in pieces)
        for c in self.schema.columns:
            data = np.concatenate([a[c.name] for (a, _v) in pieces])
            valid = None
            if any(c.name in v for (_a, v) in pieces):
                valid = np.concatenate(
                    [v.get(c.name, np.ones(len(next(iter(a.values()))),
                                           np.bool_))
                     for (a, v) in pieces])
            cols[c.name] = ColumnData(data, valid,
                                      self.dictionaries.get(c.name))
        self._parts[p] = []          # release as soon as merged
        return HostBlock(self.schema, cols, n)


def host_sort_limit(block: HostBlock, sort: list, limit, offset,
                    dictionaries: dict | None = None) -> HostBlock:
    """Host-side ORDER BY + LIMIT/OFFSET over a merged result (the spill
    path's final pass — per-partition results are each sorted on device
    or small enough that a host lexsort is cheap). String keys order by
    dictionary value rank; NULLs honor nulls_first."""
    dicts = dict(dictionaries or {})
    if sort:
        keys = []
        for sk in reversed(sort):       # lexsort: last key is primary
            cd = block.columns[sk.name]
            data = cd.data
            dic = dicts.get(sk.name) or cd.dictionary
            if dic is not None and block.schema.dtype(sk.name).is_string:
                ranks = dic.sort_ranks().astype(np.int64)
                safe = np.clip(data.astype(np.int64), 0, len(ranks) - 1)
                data = ranks[safe]
            k = data.astype(np.float64) \
                if np.issubdtype(data.dtype, np.floating) \
                else data.astype(np.int64)
            if not sk.ascending:
                k = -k.astype(np.float64) if k.dtype == np.float64 else -k
            if cd.valid is not None:
                nullk = np.where(cd.valid, 0, -1 if sk.nulls_first else 1)
                keys.append(k)
                keys.append(nullk)       # appended after → higher priority
            else:
                keys.append(k)
        order = np.lexsort(tuple(keys))
        block = block.take(order)
    lo = offset or 0
    hi = block.length if limit is None else min(lo + limit, block.length)
    if lo or hi < block.length:
        block = block.slice(lo, hi)
    return block
