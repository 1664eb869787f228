"""Row-store OLTP tables — the DataShard analog (embedded v0).

The reference's DataShard (`ydb/core/tx/datashard/datashard_impl.h:165`)
is a key-ordered row store with MVCC reads (`datashard__read_iterator.cpp`)
and per-key UPSERT/DELETE under the distributed-tx protocol. The TPU-first
analog keeps rows on the HOST — OLTP point ops are control-plane work; the
TPU earns its keep on scans — with:

  * a primary-key → version-chain map (each entry `(version, values|None)`,
    None = tombstone) giving MVCC point reads and snapshot scans;
  * UPSERT / INSERT (duplicate-checked) / REPLACE / DELETE by key;
  * columnar materialization of any snapshot (`snapshot_entries`), so the
    whole SQL/scan/device path runs unchanged over row tables (the scan
    executor consumes it through the same `scan_sources` protocol as
    ColumnShard insert buffers);
  * a mutation WAL through `storage/persist.Store` for durability.

Column tables remain the analytics home; a row table is the right home for
high-churn key-value state (the reference's default `STORE=ROW`).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ydb_tpu_torch.core.block import ColumnData, HostBlock
from ydb_tpu_torch.core.dictionary import Dictionary
from ydb_tpu_torch.core.schema import Schema
from ydb_tpu_torch.storage.mvcc import MAX_SNAPSHOT, Snapshot, WriteVersion
from ydb_tpu_torch.storage.table import _table_uids


class _RowScanAdapter:
    """Presents a snapshot of the row store through the ColumnShard
    `scan_sources` protocol (as one committed insert-buffer entry), so the
    scan executor and device caches need no row-specific path."""

    def __init__(self, table: "RowTable"):
        self.table = table
        self.shard_id = 0
        self.portion_rows = 1 << 20
        self.portions: list = []       # row stores have no portions

    def scan_sources(self, snapshot: Snapshot = MAX_SNAPSHOT,
                     prune_predicates=None):
        # equality prune over an indexed column (or the pk) serves a
        # candidates-only block instead of the full table
        t = self.table
        eq = None
        for (col, op, val) in (prune_predicates or ()):
            if op == "eq" and (
                    col in t._index_data
                    or (len(t.key_columns) == 1 and col == t.key_columns[0]
                        and not t.schema.dtype(col).is_string)):
                eq = (col, val)
                break
        return [], t.snapshot_entries(snapshot, eq=eq)

    def scan(self, columns: list[str], snapshot: Snapshot = MAX_SNAPSHOT,
             prune_predicates=None,
             block_rows: Optional[int] = None) -> Iterator[HostBlock]:
        for e in self.table.snapshot_entries(snapshot):
            if e.block.length:
                yield e.block.select(columns)

    def indexate(self) -> int:
        return 0

    def compact(self) -> int:
        return 0

    @property
    def num_rows(self) -> int:
        return self.table.num_rows


class _SnapshotEntry:
    """Duck-typed InsertEntry: (block, write_id) for cache identity."""

    def __init__(self, block: HostBlock, write_id):
        self.block = block
        self.write_id = write_id
        self.committed_version = WriteVersion(0, 0)


class RowTable:
    def __init__(self, name: str, schema: Schema, key_columns: list[str],
                 shards: int = 1, portion_rows: int = 1 << 20,
                 partition_by: Optional[list[str]] = None):
        if not key_columns:
            raise ValueError("row tables need a primary key")
        self.name = name
        self.schema = schema
        self.key_columns = key_columns
        self.partition_by = partition_by or [key_columns[0]]
        self.store_kind = "row"
        # pk tuple -> [(WriteVersion | None, values tuple | None, tx)],
        # append-ordered; version None = uncommitted entry of open tx `tx`
        # (stamped at commit, removed at rollback)
        self.rows: dict[tuple, list] = {}
        self.dictionaries: dict[str, Dictionary] = {
            c.name: Dictionary() for c in schema if c.dtype.is_string}
        self.uid = next(_table_uids)
        self.data_version = 0
        self.store = None
        self.shards = [_RowScanAdapter(self)]
        self._snap_cache: dict = {}    # (data_version, snap) -> entries
        self._tx_touched: dict = {}    # open tx id -> set of touched pks
        # secondary indexes (schemeshard build-index analog, v0):
        # name -> column; per-column candidate map value -> {pk}. The map
        # over-approximates (no removal on delete/update) — reads verify
        # visibility + current value, so stale candidates are harmless.
        self.indexes: dict[str, str] = {}
        self._index_data: dict[str, dict] = {}
        # CDC sink (storage/topic.ChangefeedSink) — committed mutations
        # publish to a topic in commit order (change_exchange analog)
        self.changefeed = None
        # open-tx CDC events (old/new images captured at statement time;
        # emitted at stamp_tx, discarded at rollback_tx). Statement-time
        # images are commit-time-correct: optimistic point-conflict
        # validation aborts any tx whose touched keys were re-committed
        # under it, so a tx that reaches stamp_tx saw the images it
        # publishes.
        self._tx_events: dict = {}
        # WAL-replay event log: persist.load arms this ([]) before
        # replaying rowwal.bin, apply() appends (version, events) per
        # replayed commit, and the engine re-emits them through the
        # changefeed after topics load — producer seq dedup drops all but
        # a torn topic tail. None outside recovery.
        self._replay_log = None
        # rows visible at MAX_SNAPSHOT, kept by every committed change
        self._live_rows = 0

    # -- write path -------------------------------------------------------

    def _pk_of(self, vals: dict) -> tuple:
        return tuple(vals[k] for k in self.key_columns)

    def _encode_value(self, col: str, v):
        dt = self.schema.dtype(col)
        if v is None:
            return None
        if dt.is_string:
            return int(self.dictionaries[col].encode([str(v)])[0])
        return dt.np(v).item() if not isinstance(v, (int, float, bool)) \
            else v

    def _decode_row(self, values) -> Optional[dict]:
        """Stored (encoded) value tuple -> {col: python value} with string
        codes decoded — the CDC row-image domain."""
        if values is None:
            return None
        out = {}
        for c, v in zip(self.schema.columns, values):
            if v is not None and c.dtype.is_string:
                v = self.dictionaries[c.name]._values[v]
            out[c.name] = v
        return out

    # -- schema evolution (ALTER TABLE) ------------------------------------

    def add_column(self, col) -> None:
        """ADD COLUMN (nullable only): stored value tuples are positional
        by schema order — every version chain gains a None slot."""
        self.schema = self.schema.extend([col])
        if col.dtype.is_string:
            self.dictionaries[col.name] = Dictionary()
        for pk, chain in self.rows.items():
            self.rows[pk] = [
                (v, (vals + (None,)) if vals is not None else None, etx)
                for (v, vals, etx) in chain]
        self.data_version += 1
        self._snap_cache.clear()

    def create_index(self, iname: str, col: str) -> None:
        if not self.schema.has(col):
            raise ValueError(f"unknown column {col!r}")
        if iname in self.indexes:
            raise ValueError(f"index {iname!r} already exists")
        self.indexes[iname] = col
        if col not in self._index_data:
            ix = self.schema.names.index(col)
            data: dict = {}
            for pk, chain in self.rows.items():
                for (_v, vals, _tx) in chain:
                    if vals is not None:
                        data.setdefault(vals[ix], set()).add(pk)
            self._index_data[col] = data

    def drop_index(self, iname: str) -> None:
        col = self.indexes.pop(iname, None)
        if col is None:
            raise ValueError(f"unknown index {iname!r}")
        if col not in self.indexes.values():
            self._index_data.pop(col, None)

    def drop_column(self, name: str) -> None:
        for iname, col in list(self.indexes.items()):
            if col == name:
                raise ValueError(
                    f"column {name!r} is indexed by {iname!r}; drop the "
                    "index first")
        ix = self.schema.names.index(name)
        self.schema = Schema([c for c in self.schema.columns
                              if c.name != name])
        self.dictionaries.pop(name, None)
        for pk, chain in self.rows.items():
            self.rows[pk] = [
                (v, (vals[:ix] + vals[ix + 1:]) if vals is not None
                 else None, etx)
                for (v, vals, etx) in chain]
        self.data_version += 1
        self._snap_cache.clear()
        if self.store is not None:
            # the mutation log still carries pre-DROP values: compact it
            # to the surviving state or a later re-ADD of the same name
            # would resurrect them at replay
            self.store.rewrite_row_wal(self)

    def apply(self, ops: list, version: Optional[WriteVersion],
              durable: bool = True, tx: Optional[int] = None,
              strict: bool = True) -> int:
        """Apply a batch of mutations.

        ops: [("upsert"|"insert"|"replace", {col: value}) | ("delete",
        {pk col: value})]. "insert" raises on a live duplicate key;
        "replace" nulls unspecified columns; "upsert" merges with the
        previous visible row. Returns rows affected.

        With `tx`, entries stay UNCOMMITTED (visible only through a
        snapshot carrying `tx_view == tx`) until `stamp_tx`/`rollback_tx`
        — the interactive-transaction write path (`ydb_tpu/tx`).

        The batch is ATOMIC: every op validates against the batch's own
        running state first; nothing mutates until all of them pass."""
        view = Snapshot(2 ** 62, 2 ** 62, tx_view=tx)
        appends: list[tuple[tuple, object]] = []   # (pk, values | None)
        overlay: dict[tuple, object] = {}          # batch-local live view
        events: list = []   # CDC: committed effects with old/new images
        live_delta = 0      # the batch's change to the visible row count
        for kind, vals in ops:
            # non-strict = WAL replay: mutations may predate a DROP COLUMN
            enc = {c: self._encode_value(c, v) for c, v in vals.items()
                   if strict or self.schema.has(c)}
            pk = self._pk_of(enc)
            if pk in overlay:
                live = overlay[pk]
            else:
                live = self._visible(self.rows.get(pk, ()), view)
            if kind == "delete":
                if live is None:
                    continue           # no-op delete: no effect, no event
                appends.append((pk, None))
                overlay[pk] = None
                live_delta -= 1
                events.append({"op": kind, "row": vals,
                               "old": self._decode_row(live), "new": None})
                continue
            if kind == "insert" and live is not None:
                raise ValueError(
                    f"duplicate primary key {pk} in {self.name}")
            row = {}
            if kind == "upsert" and live is not None:
                row.update(dict(zip(self.schema.names, live)))
            for c in self.schema.names:
                if c in enc:
                    row[c] = enc[c]
                elif c not in row:
                    if not self.schema.dtype(c).nullable:
                        raise ValueError(f"missing NOT NULL column {c}")
                    row[c] = None
            values = tuple(row[c] for c in self.schema.names)
            appends.append((pk, values))
            overlay[pk] = values
            live_delta += live is None
            events.append({"op": kind, "row": vals,
                           "old": self._decode_row(live),
                           "new": self._decode_row(values)})
        # validation passed — mutate
        idx_cols = [(col, self.schema.names.index(col), data)
                    for col, data in self._index_data.items()]
        for pk, values in appends:
            self.rows.setdefault(pk, []).append((version, values, tx))
            if values is not None:
                for _col, cix, data in idx_cols:
                    data.setdefault(values[cix], set()).add(pk)
        if tx is not None:
            self._tx_touched.setdefault(tx, set()).update(
                pk for pk, _v in appends)
            if events:
                self._tx_events.setdefault(tx, []).extend(events)
        if tx is None and version is not None:
            self._live_rows += live_delta
        self.data_version += 1
        self._snap_cache.clear()
        if durable and tx is None and self.store is not None:
            self.store.row_wal_append(self.name, ops, version)
            self.store.save_dictionaries(self)
            self.store.save_state(version.plan_step)
        if tx is None and version is not None \
                and self._replay_log is not None:
            self._replay_log.append((version, events))
        if self.changefeed is not None and tx is None \
                and version is not None and durable and events:
            self.changefeed.emit(events, version)
        return len(appends)

    def max_committed_step(self, pks) -> int:
        """Highest committed plan step across the given pk chains — the
        point-conflict probe for write-only optimistic validation."""
        hi = 0
        for pk in pks:
            for (ver, _vals, _tx) in self.rows.get(pk, ()):
                if ver is not None and ver.plan_step > hi:
                    hi = ver.plan_step
        return hi

    def pks_of_ops(self, ops: list) -> set:
        """Primary keys a mutation batch touches (encoded domain) —
        only KEY columns encode (apply() already paid the full pass)."""
        out = set()
        for (_kind, vals) in ops:
            try:
                enc = {k: self._encode_value(k, vals[k])
                       for k in self.key_columns if k in vals}
                out.add(self._pk_of(enc))
            except KeyError:
                pass                   # malformed op: apply() will raise
        return out

    def stamp_tx(self, tx: int, version: WriteVersion,
                 ops_for_wal: Optional[list] = None) -> None:
        """Commit an open transaction's entries at `version` — O(write
        set), not O(table)."""
        for pk in self._tx_touched.pop(tx, ()):
            chain = self.rows.get(pk)
            if not chain:
                continue
            was = self._visible(chain, MAX_SNAPSHOT) is not None
            for i, (ver, vals, etx) in enumerate(chain):
                if etx == tx and ver is None:
                    chain[i] = (version, vals, None)
            self._live_rows += \
                (self._visible(chain, MAX_SNAPSHOT) is not None) - was
        self.data_version += 1
        self._snap_cache.clear()
        if self.store is not None and ops_for_wal:
            self.store.row_wal_append(self.name, ops_for_wal, version)
            self.store.save_dictionaries(self)
            self.store.save_state(version.plan_step)
        events = self._tx_events.pop(tx, None)
        if self.changefeed is not None and events:
            self.changefeed.emit(events, version)

    def rollback_tx(self, tx: int) -> None:
        self._tx_events.pop(tx, None)
        for pk in self._tx_touched.pop(tx, ()):
            chain = [(v, vals, etx)
                     for (v, vals, etx) in self.rows.get(pk, [])
                     if not (etx == tx and v is None)]
            if chain:
                self.rows[pk] = chain
            else:
                self.rows.pop(pk, None)
        self.data_version += 1
        self._snap_cache.clear()

    # -- read path --------------------------------------------------------

    @staticmethod
    def _visible(chain: list, snapshot: Snapshot):
        vis = None
        for ver, vals, etx in chain:
            if ver is None:
                if snapshot.tx_view is not None and etx == snapshot.tx_view:
                    vis = vals            # own uncommitted write
            elif snapshot.includes(ver):
                vis = vals
        return vis

    def read_row(self, pk_vals: dict,
                 snapshot: Snapshot = MAX_SNAPSHOT) -> Optional[tuple]:
        """MVCC point read (the TEvRead iterator analog) — host-side, no
        device round trip."""
        enc = {c: self._encode_value(c, v) for c, v in pk_vals.items()}
        chain = self.rows.get(self._pk_of(enc))
        if not chain:
            return None
        return self._visible(chain, snapshot)

    def snapshot_entries(self, snapshot: Snapshot = MAX_SNAPSHOT,
                         eq=None) -> list:
        """Visible rows as one columnar block. `eq=(col, value)`: serve
        from a secondary index (or the pk map) — candidate pks only,
        verified against visibility + current value (the index-lookup
        read of `datashard__read_iterator`)."""
        key = (self.data_version, snapshot.plan_step, snapshot.tx_id,
               snapshot.tx_view, eq)
        hit = self._snap_cache.get(key)
        if hit is not None:
            return hit
        names = self.schema.names
        if eq is not None:
            col, want = eq
            ix = names.index(col)
            if col in self._index_data:
                cands = sorted(self._index_data[col].get(want, ()))
            else:                       # single-column pk point lookup
                cands = [(want,)] if (want,) in self.rows else []
            pks = (pk for pk in cands)
        else:
            pks = iter(sorted(self.rows))  # key-ordered, like DataShard
        cols: dict[str, list] = {c: [] for c in names}
        length = 0
        for pk in pks:
            chain = self.rows.get(pk)
            if chain is None:
                continue
            vals = self._visible(chain, snapshot)
            if vals is None:
                continue
            if eq is not None and vals[ix] != want:
                continue               # stale index candidate
            for c, v in zip(names, vals):
                cols[c].append(v)
            length += 1
        arrays, valids = {}, {}
        for c in self.schema:
            raw = cols[c.name]
            mask = np.array([v is not None for v in raw], dtype=bool)
            arrays[c.name] = np.array(
                [0 if v is None else v for v in raw], dtype=c.dtype.np)
            if not mask.all():
                valids[c.name] = mask
        block = HostBlock.from_arrays(self.schema, arrays, valids,
                                      dict(self.dictionaries))
        entries = [_SnapshotEntry(block, ("rowsnap", key))] if length else []
        self._snap_cache[key] = entries
        return entries

    @property
    def num_shards(self) -> int:
        return 1

    @property
    def num_rows(self) -> int:
        return self._live_rows

    # -- compat shims (ColumnTable interface used by the engine) ----------

    def indexate(self) -> int:
        return 0

    def bulk_upsert(self, df, version: WriteVersion) -> int:
        ops = [("upsert", {c: (None if v != v else v) if isinstance(v, float)
                           else v for c, v in row.items()})
               for row in df.to_dict("records")]
        return self.apply(ops, version)

    def scan_shard(self, shard_id: int, columns: list[str],
                   snapshot: Snapshot = MAX_SNAPSHOT,
                   prune_predicates=None, block_rows=None):
        return self.shards[0].scan(columns, snapshot, prune_predicates,
                                   block_rows)
