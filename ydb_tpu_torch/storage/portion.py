"""Immutable indexed portions with per-column statistics.

The unit of storage in a column shard — analog of the reference's portion
(`ydb/core/tx/columnshard/engines/portions/`): an immutable columnar chunk
with min/max stats per column used for scan pruning, stamped with the MVCC
write version that committed it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.storage.mvcc import WriteVersion


class _IdGen:
    """Monotonic portion ids; recovery advances past ids found on disk so
    new portions never collide with persisted files."""

    def __init__(self):
        self.n = 0

    def __next__(self) -> int:
        self.n += 1
        return self.n

    def ensure_above(self, m: int) -> None:
        self.n = max(self.n, m)


_portion_ids = _IdGen()


@dataclass
class ColumnStats:
    min: object = None
    max: object = None
    null_count: int = 0


@dataclass
class DeleteMark:
    """MVCC delete of specific rows of a portion — the reference keeps
    per-row delete versions inside portions for transactional OLAP DML
    (`ydb/core/tx/columnshard/engines/` MVCC portions); here a mark is a
    row-index set stamped with its commit version. Uncommitted marks
    (version None) belong to an open interactive tx and are visible only
    through its tx_view — the InsertEntry model, mirrored for deletes."""
    rows: np.ndarray                   # sorted unique row indices
    version: Optional[WriteVersion] = None
    tx: Optional[int] = None
    seq: int = 0                       # unique per portion (cache keys)


@dataclass
class Portion:
    block: HostBlock
    version: WriteVersion
    stats: dict = field(default_factory=dict)   # col name -> ColumnStats
    id: int = field(default_factory=lambda: next(_portion_ids))
    deletes: list = field(default_factory=list)  # [DeleteMark]
    _mark_seq: int = 0

    @property
    def num_rows(self) -> int:
        return self.block.length

    # -- MVCC deletes -------------------------------------------------------

    def add_delete(self, rows: np.ndarray,
                   version: Optional[WriteVersion] = None,
                   tx: Optional[int] = None) -> "DeleteMark":
        self._mark_seq += 1
        mark = DeleteMark(np.unique(np.asarray(rows, np.int64)), version,
                          tx, self._mark_seq)
        # single rebind: lock-free readers see the old or new list whole
        self.deletes = self.deletes + [mark]
        return mark

    def drop_delete(self, mark: "DeleteMark") -> None:
        self.deletes = [m for m in self.deletes if m is not mark]

    def visible_dead(self, snapshot) -> Optional[np.ndarray]:
        """Union of row indices deleted as of `snapshot` (None = none):
        committed marks at or before the snapshot, plus the snapshot's own
        open tx's staged marks."""
        dead = None
        for m in self.deletes:
            vis = (m.version is not None and snapshot.includes(m.version)) \
                or (m.version is None and m.tx is not None
                    and m.tx == snapshot.tx_view)
            if vis:
                dead = m.rows if dead is None \
                    else np.union1d(dead, m.rows)
        return dead if dead is not None and len(dead) else None

    def delete_sig(self, snapshot) -> tuple:
        """Cache-key component: which marks the snapshot sees."""
        return tuple(m.seq for m in self.deletes
                     if (m.version is not None
                         and snapshot.includes(m.version))
                     or (m.version is None and m.tx is not None
                         and m.tx == snapshot.tx_view))

    def visible_block(self, snapshot) -> HostBlock:
        dead = self.visible_dead(snapshot)
        if dead is None:
            return self.block
        sig = self.delete_sig(snapshot)
        cached = getattr(self, "_vb_cache", None)
        if cached is not None and cached[0] == sig:
            return cached[1]
        keep = np.setdiff1d(np.arange(self.num_rows, dtype=np.int64), dead)
        blk = self.block.take(keep)
        self._vb_cache = (sig, blk)      # one filtered view per mark set
        return blk

    @staticmethod
    def from_block(block: HostBlock, version: WriteVersion,
                   id: Optional[int] = None) -> "Portion":
        """`id`: recovery restores the persisted portion id (a fresh one
        would alias a different on-disk file)."""
        stats = {}
        for c in block.schema:
            cd = block.columns[c.name]
            st = ColumnStats()
            if cd.valid is not None:
                st.null_count = int((~cd.valid).sum())
                vals = cd.data[cd.valid]
            else:
                vals = cd.data
            if len(vals) and not c.dtype.is_string:
                st.min = vals.min()
                st.max = vals.max()
            stats[c.name] = st
        if id is not None:
            return Portion(block, version, stats, id)
        return Portion(block, version, stats)


def prune_by_range(portion: Portion, col: str, op: str, value) -> bool:
    """True if the portion can be skipped for `col <op> value` (no row matches).

    The pruning analog of the reference's early-filter index checks
    (`engines/reader/.../fetching.h` TApplyIndexStep / TPredicateFilter)."""
    st = portion.stats.get(col)
    if st is None or st.min is None:
        return False
    lo, hi = st.min, st.max
    if op == "eq":
        return value < lo or value > hi
    if op == "lt":
        return lo >= value
    if op == "le":
        return lo > value
    if op == "gt":
        return hi <= value
    if op == "ge":
        return hi < value
    return False
