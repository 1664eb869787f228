"""A single column shard: insert buffer → portions → compaction → scan.

Mirrors the reference ColumnShard's write/read lifecycle
(`ydb/core/tx/columnshard/columnshard_impl.h`):

  * writes land in an **insert table** of uncommitted blobs
    (`engines/insert_table/`), become visible at commit (plan step);
  * **indexation** turns committed inserts into immutable portions with
    stats (`engines/changes/indexation.cpp`);
  * **compaction** merges small portions (`general_compaction.cpp`);
  * **scan** iterates portions under an MVCC snapshot, prunes by stats,
    and hands blocks to the device program — the per-portion early-filter
    shape of `engines/reader/plain_reader/iterator/`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.schema import Schema
from ydb_tpu_torch.ops import ir
from ydb_tpu_torch.storage.mvcc import MAX_SNAPSHOT, Snapshot, WriteVersion
from ydb_tpu_torch.storage.portion import Portion, prune_by_range

DEFAULT_PORTION_ROWS = 1 << 20
COMPACT_MIN_PORTIONS = 8


@dataclass
class InsertEntry:
    block: HostBlock
    write_id: int
    committed_version: Optional[WriteVersion] = None
    tx: Optional[int] = None       # open interactive tx that staged this


class ColumnShard:
    def __init__(self, schema: Schema, shard_id: int = 0,
                 portion_rows: int = DEFAULT_PORTION_ROWS):
        self.schema = schema
        self.shard_id = shard_id
        self.portion_rows = portion_rows
        self.portions: list[Portion] = []
        self.inserts: list[InsertEntry] = []
        self._next_write_id = 1
        self.rows_written = 0

    # -- write path -------------------------------------------------------

    def write(self, block: HostBlock, tx: Optional[int] = None) -> int:
        """Stage an uncommitted insert; returns write id (InsertTable model)."""
        wid = self._next_write_id
        self._next_write_id += 1
        self.inserts.append(InsertEntry(block, wid, tx=tx))
        return wid

    def commit(self, write_ids: list[int], version: WriteVersion) -> None:
        for e in self.inserts:
            if e.write_id in write_ids:
                e.committed_version = version
                e.tx = None
                self.rows_written += e.block.length

    def rollback(self, write_ids: list[int]) -> None:
        self.inserts = [e for e in self.inserts
                        if e.write_id not in write_ids
                        or e.committed_version is not None]

    def indexate(self) -> int:
        """Background indexation: committed inserts → portions. Returns
        #portions.

        Concurrent-reader discipline: the portions list is extended in ONE
        rebind (atomic under the GIL) BEFORE the consumed inserts are
        removed in a second rebind; a reader between the two sees the rows
        in both places, and `scan_sources` dedups by the portions'
        `src_write_ids` — never zero copies, never two."""
        ready = [e for e in self.inserts if e.committed_version is not None]
        if not ready:
            return 0
        made = []
        # group by version so a portion has a single write version
        by_ver: dict[WriteVersion, list] = {}
        for e in ready:
            by_ver.setdefault(e.committed_version, []).append(e)
        for ver, entries in by_ver.items():
            wids = frozenset(e.write_id for e in entries)
            blocks = [e.block for e in entries]
            merged = HostBlock.concat(blocks) if len(blocks) > 1 else blocks[0]
            for start in range(0, merged.length, self.portion_rows):
                chunk = merged.slice(start, min(start + self.portion_rows,
                                                merged.length))
                p = Portion.from_block(chunk, ver)
                p.src_write_ids = wids
                made.append(p)
        consumed = {e.write_id for e in ready}
        self.portions = self.portions + made
        self.inserts = [e for e in self.inserts
                        if e.write_id not in consumed
                        or e.committed_version is None]
        return len(made)

    def compact(self, watermark: Optional[int] = None) -> int:
        """Merge small portions into full ones (`general_compaction.cpp`).

        The merged portion is stamped with the NEWEST version among its
        inputs, so only portions at or below `watermark` (the highest plan
        step no pinned snapshot is behind, `Coordinator.safe_watermark`)
        are eligible — every pinned reader stays at or past the merged
        version and sees identical data. Ad-hoc snapshots never registered
        with the coordinator keep only per-portion granularity (the
        reference tracks per-row versions inside portions — a later
        refinement here)."""
        folded = self._fold_deletes(watermark)
        small = [p for p in self.portions
                 if p.num_rows < self.portion_rows // 2
                 and not p.deletes      # freshly marked portions wait for
                 #                        their marks to pass the watermark
                 and (watermark is None
                      or p.version.plan_step <= watermark)]
        if len(small) < COMPACT_MIN_PORTIONS:
            return folded
        ids = {p.id for p in small}
        merged = HostBlock.concat([p.block for p in small])
        ver = max(p.version for p in small)
        new_portions = []
        src = frozenset().union(*(getattr(p, "src_write_ids", frozenset())
                                  for p in small))
        for start in range(0, merged.length, self.portion_rows):
            chunk = merged.slice(start,
                                 min(start + self.portion_rows,
                                     merged.length))
            p2 = Portion.from_block(chunk, ver)
            p2.src_write_ids = src
            new_portions.append(p2)
        # ONE rebind: a concurrent reader sees either the old set or the
        # new set — both contain the same rows for any snapshot at or
        # past the watermark (the eligibility gate above)
        self.portions = [p for p in self.portions
                         if p.id not in ids] + new_portions
        return len(small) + folded

    def _fold_deletes(self, watermark: Optional[int]) -> int:
        """Reclaim delete-marked rows: a portion whose every mark is
        committed at or below the watermark rewrites without the dead
        rows (new portion at the newest involved version) — TTL/DELETE
        must eventually free memory and disk, and every reader at or past
        the watermark sees identical data either way."""
        if watermark is None:
            return 0
        replaced, removed_ids = [], set()
        for p in self.portions:
            if not p.deletes or p.version.plan_step > watermark:
                continue
            if not all(m.version is not None
                       and m.version.plan_step <= watermark
                       for m in p.deletes):
                continue
            dead = np.unique(np.concatenate([m.rows for m in p.deletes]))
            ver = max([p.version] + [m.version for m in p.deletes])
            removed_ids.add(p.id)
            keep = np.setdiff1d(np.arange(p.num_rows, dtype=np.int64),
                                dead)
            if len(keep):
                p2 = Portion.from_block(p.block.take(keep), ver)
                p2.src_write_ids = getattr(p, "src_write_ids", frozenset())
                replaced.append(p2)
        if not removed_ids:
            return 0
        self.portions = [p for p in self.portions
                         if p.id not in removed_ids] + replaced
        return len(removed_ids)

    # -- read path --------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return sum(p.num_rows for p in self.portions) + sum(
            e.block.length for e in self.inserts if e.committed_version)

    def scan_sources(self, snapshot: Snapshot = MAX_SNAPSHOT,
                     prune_predicates: Optional[list[tuple]] = None
                     ) -> tuple[list, list]:
        """(visible portions, visible committed-but-unindexed InsertEntry
        list) under the snapshot, after min/max pruning. Entries (not bare
        blocks) so callers can key device caches on stable write ids."""
        prune_predicates = prune_predicates or []
        # READ ORDER CONTRACT with indexate(): inserts FIRST, portions
        # second. Indexate appends portions before removing consumed
        # inserts, so a reader can see a row in both places (deduped by
        # covered write ids below) but never in neither. Reading portions
        # first would open exactly that missing-rows window.
        all_inserts = self.inserts           # one read: stable list object
        all_portions = self.portions
        portions = [
            p for p in all_portions
            if snapshot.includes(p.version)
            and not any(prune_by_range(p, c, op, v)
                        for (c, op, v) in prune_predicates)]
        # write ids already covered by a visible portion: during the
        # indexation window a reader can see an insert both places — the
        # portion wins (indexate's rebind-ordering contract)
        covered = set()
        for p in all_portions:
            if snapshot.includes(p.version):
                covered.update(getattr(p, "src_write_ids", ()))
        inserts = [e for e in all_inserts
                   if e.write_id not in covered
                   and ((e.committed_version
                         and snapshot.includes(e.committed_version))
                        or (e.committed_version is None and e.tx is not None
                            and e.tx == snapshot.tx_view))]
        return portions, inserts

    def scan(self, columns: list[str],
             snapshot: Snapshot = MAX_SNAPSHOT,
             prune_predicates: Optional[list[tuple]] = None,
             block_rows: Optional[int] = None) -> Iterator[HostBlock]:
        """Yield host blocks of ~block_rows under the snapshot.

        prune_predicates: [(col, op, value)] conjuncts for min/max pruning.
        """
        block_rows = block_rows or self.portion_rows
        pending: list[HostBlock] = []
        pending_rows = 0

        def flush():
            nonlocal pending, pending_rows
            if pending:
                out = HostBlock.concat(pending) if len(pending) > 1 else pending[0]
                pending, pending_rows = [], 0
                return out
            return None

        portions, insert_entries = self.scan_sources(snapshot,
                                                     prune_predicates)
        sources = [p.visible_block(snapshot) for p in portions] \
            + [e.block for e in insert_entries]

        for src in sources:
            blk = src.select(columns)
            pos = 0
            while pos < blk.length:
                take = min(block_rows - pending_rows, blk.length - pos)
                pending.append(blk.slice(pos, pos + take))
                pending_rows += take
                pos += take
                if pending_rows >= block_rows:
                    out = flush()
                    if out is not None:
                        yield out
        out = flush()
        if out is not None:
            yield out
