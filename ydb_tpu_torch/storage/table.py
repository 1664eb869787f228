"""Sharded column tables.

A table is N ``ColumnShard``s; rows are routed by hash of the first
partitioning key column — the analog of the reference's hash-sharded OLAP
tables (`ydb/core/tx/data_events/shards_splitter.cpp` hash splitter, and
SchemeShard's partitioning metadata). String columns share one table-wide
dictionary per column so codes are comparable across shards and portions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.dictionary import Dictionary
from ydb_tpu_torch.core.schema import Schema
from ydb_tpu_torch.storage.mvcc import MAX_SNAPSHOT, Snapshot, WriteVersion
from ydb_tpu_torch.storage.shard import ColumnShard
from ydb_tpu_torch.utils.hashing import splitmix64

_table_uids = iter(range(1, 2 ** 62))

# virtual routing buckets per table: rows hash into a fixed bucket space
# and a bucket->shard map places them — splits reassign buckets instead
# of re-hashing the world (consistent-hashing-style, the splittable
# analog of the reference's key-range partitions)
VBUCKETS = 64


class ColumnTable:
    def __init__(self, name: str, schema: Schema, key_columns: list[str],
                 shards: int = 1, portion_rows: int = 1 << 20,
                 partition_by: Optional[list[str]] = None):
        if not key_columns:
            raise ValueError("column tables need a primary key")
        for k in key_columns:
            if not schema.has(k):
                raise ValueError(f"unknown key column {k}")
        self.name = name
        self.schema = schema
        self.key_columns = key_columns
        self.partition_by = partition_by or [key_columns[0]]
        self.shards = [ColumnShard(schema, i, portion_rows) for i in range(shards)]
        self.buckets = [i % shards for i in range(VBUCKETS)]
        self.dictionaries: dict[str, Dictionary] = {
            c.name: Dictionary() for c in schema if c.dtype.is_string}
        # data_version: bumped on every commit — cached plans snapshot
        # dictionary domains, so the plan cache keys on (uid, data_version)
        # per referenced table (the compile-cache schema-version key of
        # `kqp_compile_service.cpp:411`). uid distinguishes drop/recreate.
        self.uid = next(_table_uids)
        self.data_version = 0
        # durability hook (ydb_tpu/storage/persist.Store); None = volatile
        self.store = None
        # row TTL (ttl.cpp analog): (column, days) — expired rows evict
        # through the portion-rewrite delete path (engine.run_ttl)
        self.ttl = None

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self.shards)

    # -- write path -------------------------------------------------------

    def _route(self, block: HostBlock) -> np.ndarray:
        col = self.partition_by[0]
        cd = block.columns[col]
        b = self._bucket_of(cd.data)
        return np.asarray(self.buckets, np.int64)[b]

    @staticmethod
    def _bucket_of(data: np.ndarray) -> np.ndarray:
        h = splitmix64(np, data)
        return (h % np.uint64(VBUCKETS)).astype(np.int64)

    def write(self, block: HostBlock,
              tx: Optional[int] = None) -> list[tuple[int, int]]:
        """Stage rows into shards (WAL-logged when durable); returns
        [(shard_id, write_id)]. `tx`: owning open transaction (entries
        visible only through its tx_view until commit)."""
        staged: list[tuple[int, int, HostBlock]] = []
        if len(self.shards) == 1:
            staged.append((0, self.shards[0].write(block, tx), block))
        else:
            dest = self._route(block)
            for sid in range(len(self.shards)):
                idx = np.nonzero(dest == sid)[0]
                if len(idx):
                    blk = block.take(idx)
                    staged.append((sid, self.shards[sid].write(blk, tx),
                                   blk))
        if tx is not None:
            # staged writes grow shared dictionaries and change what the
            # owning tx's snapshot sees — cached plans must re-fingerprint
            self.data_version += 1
        if self.store is not None:
            for sid, wid, blk in staged:
                self.store.wal_write(self.name, sid, wid, blk, tx=tx)
        return [(sid, wid) for (sid, wid, _b) in staged]

    def rollback(self, writes: list[tuple[int, int]]) -> None:
        """Drop staged-but-uncommitted writes (interactive tx abort)."""
        by_shard: dict[int, list[int]] = {}
        for sid, wid in writes:
            by_shard.setdefault(sid, []).append(wid)
        for sid, wids in by_shard.items():
            self.shards[sid].rollback(wids)
            if self.store is not None:
                self.store.wal_abort(self.name, sid, wids)
        self.data_version += 1

    def commit(self, writes: list[tuple[int, int]],
               version: WriteVersion, deletes: Optional[list] = None) -> None:
        """Commit staged writes and/or MVCC delete marks ATOMICALLY:
        `deletes` = [(shard, portion, row indices)]. One intent-journal
        record covers both — a crash mid-commit heals to all-or-nothing
        (an UPDATE is delete marks + new rows; losing one half would be
        a data-losing pure delete or a duplicating pure insert)."""
        by_shard: dict[int, list[int]] = {}
        for sid, wid in writes:
            by_shard.setdefault(sid, []).append(wid)
        hits = deletes or []
        if self.store is not None and (by_shard or hits):
            # durable FIRST: the in-memory state below must never be
            # acknowledged unless it can be recovered
            self.store.commit_table(
                self.name, by_shard, version,
                deletes=[(s.shard_id, p.id, [int(r) for r in rows])
                         for (s, p, rows) in hits])
        for sid, wids in by_shard.items():
            self.shards[sid].commit(wids, version)
        for (_shard, portion, rows) in hits:
            portion.add_delete(rows, version=version)
        self.data_version += 1
        if self.store is not None:
            self.store.save_dictionaries(self)
            self.store.save_state(version.plan_step)

    # -- MVCC deletes (transactional column DML) ---------------------------

    def apply_deletes(self, hits: list, version: WriteVersion) -> int:
        """Commit delete marks: `hits` = [(shard, portion, row indices)].
        Historical snapshots keep seeing the rows (time travel preserved —
        the r3 portion-rewrite path destroyed it)."""
        hits = [h for h in hits if len(h[2])]
        if not hits:
            return 0                   # no-op: no bump, no WAL — a match-
        #                                nothing DELETE must not abort
        #                                concurrent optimistic txs
        self.commit([], version, deletes=hits)
        return sum(len(rows) for (_s, _p, rows) in hits)

    def stage_deletes(self, hits: list, tx: int) -> list:
        """Stage delete marks for an open tx (visible only through its
        tx_view); returns handles for commit/rollback."""
        handles = []
        for (shard, portion, rows) in hits:
            if not len(rows):
                continue
            handles.append((shard, portion,
                            portion.add_delete(rows, tx=tx)))
        if handles:
            self.data_version += 1   # own snapshot changes; re-fingerprint
        return handles

    def rollback_deletes(self, handles: list) -> None:
        if not handles:
            return
        for (_shard, portion, mark) in handles:
            portion.drop_delete(mark)
        self.data_version += 1

    def indexate(self, watermark: Optional[int] = None,
                 compact: bool = True) -> int:
        """Background indexation across shards (persists portion sets),
        followed by the compaction policy check — the background-controller
        analog (`columnshard_impl.h` background changes): steady small
        inserts must not accumulate unbounded small portions. `watermark`:
        see `ColumnShard.compact` (snapshot safety)."""
        made = 0
        for s in self.shards:
            n = s.indexate()
            merged = s.compact(watermark) if compact else 0
            made += n
            if self.store is not None and (n or merged):
                self.store.save_indexation(self, s)
        if self.store is not None and made:
            self.store.compact_intents(self)
        return made

    def compact(self, watermark: Optional[int] = None) -> int:
        """Compaction across shards (persists the rewritten portion sets)."""
        merged = 0
        for s in self.shards:
            n = s.compact(watermark)
            merged += n
            if self.store is not None and n:
                self.store.save_indexation(self, s)
        return merged

    # -- shard split / merge -----------------------------------------------

    def split_shard(self, sid: int) -> bool:
        """Split a hot/large shard: half its routing buckets move to a new
        shard and every portion's rows redistribute by bucket — the
        SchemeShard split trigger (`schemeshard__table_stats.cpp`)
        collapsed onto hash-bucket routing. Readers see the swap
        atomically (one shards-list rebind of copy-on-write shard
        objects); versions are preserved, so MVCC snapshots are unmoved.

        Returns False when the shard cannot split yet (single bucket,
        pending uncommitted inserts, or live delete marks — fold first)."""
        from ydb_tpu_torch.storage.portion import Portion
        shard = self.shards[sid]
        mine = [b for b, s in enumerate(self.buckets) if s == sid]
        if len(mine) < 2 or any(e.committed_version is None
                                for e in shard.inserts):
            return False
        if any(p.deletes for p in shard.portions):
            return False               # marks hold row indices; fold first
        shard.indexate()               # committed inserts -> portions
        moving = set(mine[len(mine) // 2:])
        new_sid = len(self.shards)
        keep_shard = ColumnShard(self.schema, sid, shard.portion_rows)
        keep_shard._next_write_id = shard._next_write_id
        new_shard = ColumnShard(self.schema, new_sid, shard.portion_rows)
        col = self.partition_by[0]
        for p in shard.portions:
            b = self._bucket_of(p.block.columns[col].data)
            mv = np.isin(b, list(moving))
            if not mv.any():
                keep_shard.portions.append(p)      # untouched: same object
                continue
            stay = np.nonzero(~mv)[0]
            go = np.nonzero(mv)[0]
            if len(stay):
                keep_shard.portions.append(
                    Portion.from_block(p.block.take(stay), p.version))
            child = Portion.from_block(p.block.take(go), p.version)
            # crash-recovery marker: while the parent portion still exists
            # in the keep shard's manifest, these children are NOT yet
            # authoritative — load() drops them (split is all-or-nothing)
            child.split_src = p.id
            new_shard.portions.append(child)
        new_buckets = [new_sid if b in moving else s
                       for b, s in enumerate(self.buckets)]
        # ONE rebind each: lock-free readers see old or new state whole
        self.buckets = new_buckets
        self.shards = self.shards[:sid] + [keep_shard] \
            + self.shards[sid + 1:] + [new_shard]
        self.data_version += 1
        if self.store is not None:
            # durable ORDER is the crash-safety argument:
            # 1. the new shard's children land (additive; parents still
            #    authoritative → a crash here rolls the split back),
            # 2. the catalog learns the new shard count + bucket map,
            # 3. the keep shard's purge removes the parents — from here
            #    the children are authoritative.
            self.store.save_indexation(self, new_shard)
            if getattr(self, "catalog", None) is not None:
                self.store.save_catalog(self.catalog)
            self.store.save_indexation(self, keep_shard)
        return True

    def merge_last_shard(self) -> bool:
        """Merge the last shard into the one owning the fewest rows:
        whole portions move (reads scan every shard; routing only places
        new writes), its buckets reassign, and the shard list shrinks."""
        if len(self.shards) < 2:
            return False
        src = self.shards[-1]
        if any(e.committed_version is None for e in src.inserts):
            return False
        src.indexate()
        sid = src.shard_id
        target = min(range(len(self.shards) - 1),
                     key=lambda i: self.shards[i].num_rows)
        tgt = self.shards[target]
        merged = ColumnShard(self.schema, target, tgt.portion_rows)
        merged._next_write_id = max(tgt._next_write_id,
                                    src._next_write_id)
        merged.portions = tgt.portions + src.portions
        merged.inserts = list(tgt.inserts)
        self.buckets = [target if s == sid else s for s in self.buckets]
        self.shards = self.shards[:target] + [merged] \
            + self.shards[target + 1:-1]
        self.data_version += 1
        if self.store is not None:
            # moved portions keep their ids, so until the source dir is
            # dropped they exist in BOTH manifests — load() dedups by
            # portion id, making every crash window read-consistent
            self.store.save_indexation(self, merged)
            if getattr(self, "catalog", None) is not None:
                self.store.save_catalog(self.catalog)
            self.store.drop_shard_dir(self.name, sid)
        return True

    def maybe_split(self, threshold_rows: int) -> bool:
        """Auto-split check (called at commit points): split the biggest
        shard once it crosses the threshold."""
        if not threshold_rows:
            return False
        sid = max(range(len(self.shards)),
                  key=lambda i: self.shards[i].num_rows)
        if self.shards[sid].num_rows <= threshold_rows:
            return False
        return self.split_shard(sid)

    # -- schema evolution (ALTER TABLE) ------------------------------------

    def add_column(self, col) -> None:
        """ADD COLUMN: existing portions/staged blocks gain an all-null
        column in memory; on-disk portion files stay untouched (the blob
        reader synthesizes nulls for columns a portion predates — the
        per-portion schema-versioning stance of the reference's
        ColumnShard)."""
        from ydb_tpu_torch.core.block import ColumnData
        self.schema = self.schema.extend([col])
        if col.dtype.is_string:
            self.dictionaries[col.name] = Dictionary()

        def patch(block: HostBlock) -> HostBlock:
            # string nulls are code -1 (0 would index an empty dictionary)
            fill = -1 if col.dtype.is_string else 0
            data = np.full(block.length, fill, dtype=col.dtype.np)
            cd = ColumnData(data, np.zeros(block.length, bool),
                            self.dictionaries.get(col.name))
            return HostBlock(block.schema.extend([col]),
                             {**block.columns, col.name: cd}, block.length)

        for s in self.shards:
            s.schema = self.schema
            for p in s.portions:
                p.block = patch(p.block)
            for e in s.inserts:
                e.block = patch(e.block)
        self.data_version += 1

    def drop_column(self, name: str) -> None:
        """DROP COLUMN: stripped from memory AND from on-disk blobs (a
        later re-ADD of the same name must see nulls, not stale bytes)."""
        self.schema = Schema([c for c in self.schema.columns
                              if c.name != name])
        self.dictionaries.pop(name, None)

        def strip(block: HostBlock) -> HostBlock:
            if name not in block.columns:
                return block
            cols = {n: cd for n, cd in block.columns.items() if n != name}
            return HostBlock(
                Schema([c for c in block.schema.columns if c.name != name]),
                cols, block.length)

        for s in self.shards:
            s.schema = self.schema
            for p in s.portions:
                p.block = strip(p.block)
                p.stats.pop(name, None)
            for e in s.inserts:
                e.block = strip(e.block)
            if self.store is not None:
                self.store.rewrite_shard_blobs(self, s)
        self.data_version += 1

    def bulk_upsert(self, df, version: WriteVersion) -> int:
        """Ingest a pandas DataFrame (BulkUpsert analog): write+commit+indexate."""
        block = HostBlock.from_pandas(df, schema=self.schema,
                                      dictionaries=self.dictionaries)
        writes = self.write(block)
        self.commit(writes, version)
        self.indexate()
        return block.length

    # -- read path --------------------------------------------------------

    def scan_shard(self, shard_id: int, columns: list[str],
                   snapshot: Snapshot = MAX_SNAPSHOT,
                   prune_predicates: Optional[list[tuple]] = None,
                   block_rows: Optional[int] = None) -> Iterator[HostBlock]:
        return self.shards[shard_id].scan(columns, snapshot,
                                          prune_predicates, block_rows)
