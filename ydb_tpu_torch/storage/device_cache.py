"""Device-resident column cache (port of ``ydb_tpu/storage/device_cache.py``).

Immutable portion columns are stacked into (K, CAP) superblocks and
uploaded to the engine's device once per data version, then reused
across queries, LRU-evicted under a byte budget. The fused path reads
``superblock``s; the portioned path reads one portion at a time
(``device_block``), each column cached under the portion's id.
A landed DQ channel table's source is a ``DeviceStageBlock`` still on
the device: the superblock stacks its tensors there, with no readback.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ydb_tpu_torch.ops.device import bucket_capacity
from ydb_tpu_torch.ops.torch_ns import to_tensor

import os as _os

# bytes of device memory for cached columns (an 80 GB card keeps room
# for the working sets of the query beside them)
DEFAULT_BUDGET = int(_os.environ.get("YDB_TPU_HBM_BUDGET", 40 << 30))


def enumerate_scan_sources(table, snapshot, prune):
    """Every visible scan source of a table: (HostBlocks, source ids).
    Source ids key superblock cache entries (write id, not list position:
    two snapshots seeing different insert subsets must not collide).
    Portions with MVCC delete marks visible at the snapshot contribute
    their filtered view under an id that carries the visible mark set."""
    sources, src_ids = [], []
    for shard in table.shards:
        portions, insert_entries = shard.scan_sources(snapshot, prune)
        for p in portions:
            sig = p.delete_sig(snapshot) if p.deletes else ()
            if sig:
                sources.append(p.visible_block(snapshot))
                src_ids.append(("pv", p.id, sig))
            else:
                sources.append(p.block)
                src_ids.append(("p", p.id))
        for e in insert_entries:
            sources.append(e.block)
            src_ids.append(("i", shard.shard_id, e.write_id))
    return sources, src_ids


def _device_source(b):
    """The still-on-device view of a stage-spine scan source (a landed
    `DeviceStageBlock` channel table), or None for plain host blocks.
    Reading it instead of `.columns` keeps the admission estimate and
    the superblock stack from forcing the block's host readback."""
    return getattr(b, "device", None)


def _source_cap(b) -> int:
    dev = _device_source(b)
    return dev.capacity if dev is not None \
        else bucket_capacity(max(b.length, 1))


def _source_has_valid(b, s: str) -> bool:
    dev = _device_source(b)
    return (s in dev.valids) if dev is not None \
        else (b.columns[s].valid is not None)


def estimate_scan_bytes(sources, storage_names: list,
                        pad_to: int = 0) -> int:
    """Superblock device footprint of a scan: K stacked sources at the
    max capacity bucket, per column data + validity — the fused-path
    admission estimate (no upload happens to find out it didn't fit).
    `pad_to`: the shape-bucketed row count (padded rows allocate real
    memory, so the estimate must charge them). Device-resident sources
    answer from shape metadata, with no readback."""
    if not sources:
        return 0
    K = max(len(sources), pad_to)
    CAP = max(_source_cap(b) for b in sources)
    total = 0
    for s in storage_names:
        b0 = sources[0]
        itemsize = int(np.dtype(b0.schema.dtype(s).np).itemsize) \
            if _device_source(b0) is not None \
            else b0.columns[s].data.itemsize
        total += K * CAP * itemsize
        if any(_source_has_valid(b, s) for b in sources):
            total += K * CAP
    return total


class DeviceColumnCache:
    def __init__(self, device, budget_bytes: int = DEFAULT_BUDGET):
        import threading
        self.device = device
        self.budget = budget_bytes
        self._entries: OrderedDict = OrderedDict()  # key -> (data, valid, nbytes)
        self.bytes = 0
        # device bytes held by OTHER long-lived caches sharing this
        # budget (the cross-query BuildCache registers here)
        self.foreign_bytes = 0
        self.hits = 0
        self.misses = 0
        self._mu = threading.RLock()

    def _evict(self):
        while self.bytes + self.foreign_bytes > self.budget \
                and self._entries:
            _key, (_d, _v, nbytes) = self._entries.popitem(last=False)
            self.bytes -= nbytes

    def acquire_foreign(self, nbytes: int) -> None:
        with self._mu:
            self.foreign_bytes += nbytes
            self._evict()

    def release_foreign(self, nbytes: int) -> None:
        with self._mu:
            self.foreign_bytes = max(0, self.foreign_bytes - nbytes)

    def reserve(self, nbytes: int) -> None:
        """Evict LRU entries until `nbytes` of device memory fits beside
        the cached set — for paths that allocate device memory the cache
        doesn't track (tiled scan stacks, spill partials)."""
        with self._mu:
            while self.bytes + self.foreign_bytes + nbytes > self.budget \
                    and self._entries:
                _key, (_d, _v, nb) = self._entries.popitem(last=False)
                self.bytes -= nb

    def _lookup(self, key):
        with self._mu:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return hit

    def _insert(self, key, data, valid, nbytes):
        with self._mu:
            hit = self._entries.get(key)
            if hit is not None:
                return hit[0], hit[1]
            self._entries[key] = (data, valid, nbytes)
            self.bytes += nbytes
            self._evict()
            return data, valid

    def column(self, portion, col: str, device=None):
        """(device data, device valid | None) of one portion column,
        padded to the portion's capacity bucket, on `device` (a mesh
        shard's) or the cache's own. Entries are keyed by device too."""
        dev = torch.device(self.device if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (portion.id, col, str(dev))
        hit = self._lookup(key)
        if hit is not None:
            return hit[0], hit[1]
        cd = portion.block.columns[col]
        cap = bucket_capacity(max(portion.num_rows, 1))
        pad = cap - portion.num_rows
        data = to_tensor(np.pad(cd.data, (0, pad)) if pad else cd.data, dev)
        valid = None
        nbytes = data.nbytes
        if cd.valid is not None:
            valid = to_tensor(np.pad(cd.valid, (0, pad)) if pad
                              else cd.valid, dev)
            nbytes += valid.nbytes
        return self._insert(key, data, valid, nbytes)

    def device_block(self, portion, columns: list, rename=None,
                     device=None):
        """A DeviceBlock of a portion's columns from the cache, on
        `device` (a mesh shard's) or the cache's own."""
        from ydb_tpu_torch.core.schema import Column, Schema
        from ydb_tpu_torch.ops.device import DeviceBlock
        dev = self.device if device is None else device
        rename = rename or {}
        cap = bucket_capacity(max(portion.num_rows, 1))
        arrays, valids, dicts, cols = {}, {}, {}, []
        for name in columns:
            out = rename.get(name, name)
            d, v = self.column(portion, name, dev)
            arrays[out] = d
            if v is not None:
                valids[out] = v
            cd = portion.block.columns[name]
            if cd.dictionary is not None:
                dicts[out] = cd.dictionary
            cols.append(Column(out, portion.block.schema.dtype(name)))
        length = torch.tensor(portion.num_rows, dtype=torch.int32,
                              device=dev)
        return DeviceBlock(Schema(cols), arrays, valids, length, cap, dicts)

    def superblock(self, table, storage_names: list, rename: dict,
                   snapshot, prune, sources=None, src_ids=None,
                   pad_to: int = 0):
        """Stacked (K, CAP) tensors on the cache's device covering every
        visible scan source of `table` — the input of the fused query
        (`ops/fused.py`), one upload per column per data version. Rows
        beyond the real source count (`pad_to`, the shape bucket) are
        zero-filled with length 0, masked out like a short source.

        Returns (arrays {internal: (K,CAP)}, valids {internal: (K,CAP)},
        lengths (K,) int32, K, CAP, dicts) or None when the table has no
        visible sources."""
        if sources is None:
            sources, src_ids = enumerate_scan_sources(table, snapshot, prune)
        if not sources:
            return None
        K = max(len(sources), pad_to)
        CAP = max(_source_cap(b) for b in sources)
        src_key = (table.uid, table.data_version, tuple(src_ids), CAP, K)

        lengths_np = np.zeros(K, np.int32)
        lengths_np[:len(sources)] = [b.length for b in sources]
        arrays, valids, dicts = {}, {}, {}
        for s in storage_names:
            out = rename.get(s, s)
            key = ("sbc", src_key, s)
            hit = self._lookup(key)
            if hit is not None:
                arrays[out] = hit[0]
                if hit[1] is not None:
                    valids[out] = hit[1]
            elif all(_device_source(b) is not None for b in sources):
                # device-resident sources (stage-spine channel landings):
                # stacked on the device, no readback and no re-upload.
                # Pad regions are zero and validity is clipped to each
                # length, so the stack equals what the host path builds.
                d, v = self._stack_device(sources, s, K, CAP)
                nbytes = d.nbytes + (v.nbytes if v is not None else 0)
                d, v = self._insert(key, d, v, nbytes)
                arrays[out] = d
                if v is not None:
                    valids[out] = v
            else:
                dtype = sources[0].columns[s].data.dtype
                stack = np.zeros((K, CAP), dtype=dtype)
                has_valid = any(b.columns[s].valid is not None
                                for b in sources)
                vstack = np.zeros((K, CAP), np.bool_) if has_valid else None
                for k, b in enumerate(sources):
                    cd = b.columns[s]
                    stack[k, :b.length] = cd.data
                    if vstack is not None:
                        vstack[k, :b.length] = (cd.valid if cd.valid is not None
                                                else True)
                d = to_tensor(stack, self.device)
                v = to_tensor(vstack, self.device) \
                    if vstack is not None else None
                nbytes = d.nbytes + (v.nbytes if v is not None else 0)
                d, v = self._insert(key, d, v, nbytes)
                arrays[out] = d
                if v is not None:
                    valids[out] = v
            dv0 = _device_source(sources[0])
            dic = dv0.dictionaries.get(s) if dv0 is not None \
                else sources[0].columns[s].dictionary
            if dic is not None:
                dicts[out] = dic

        lkey = ("sbl", src_key)
        lhit = self._lookup(lkey)
        if lhit is None:
            lengths = to_tensor(lengths_np, self.device)
            lengths, _ = self._insert(lkey, lengths, None, lengths.nbytes)
        else:
            lengths = lhit[0]
        return arrays, valids, lengths, K, CAP, dicts

    def _stack_device(self, sources, s: str, K: int, CAP: int):
        """(K, CAP) data and validity (None when no source has a mask)
        of column `s` over device-resident sources, on the cache's
        device: each source's live rows, zeros past its length."""
        has_valid = any(_source_has_valid(b, s) for b in sources)
        dt = _device_source(sources[0]).arrays[s].dtype
        d = torch.zeros((K, CAP), dtype=dt, device=self.device)
        v = torch.zeros((K, CAP), dtype=torch.bool, device=self.device) \
            if has_valid else None
        for k, b in enumerate(sources):
            dv = _device_source(b)
            n = min(int(b.length), CAP)
            d[k, :n] = dv.arrays[s][:n]
            if v is not None:
                va = dv.valids.get(s)
                if va is None:
                    v[k, :n] = True
                else:
                    v[k, :n] = va[:n]
        return d, v
