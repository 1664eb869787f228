"""Table catalog — the SchemeShard/SchemeCache analog (embedded, v0).

The reference keeps a path tree in the SchemeShard tablet
(`ydb/core/tx/schemeshard/schemeshard_impl.h:69`) replicated to per-node
SchemeCaches (`ydb/core/tx/scheme_cache/scheme_cache.h:102`). Here the
catalog is an in-process registry of tables; DDL versioning, path tree, and
replication arrive with the distributed control plane.
"""

from __future__ import annotations

from typing import Optional

from ydb_tpu_torch.core.schema import Schema
from ydb_tpu_torch.storage.table import ColumnTable


class Catalog:
    def __init__(self, store=None):
        """`store`: a `ydb_tpu.storage.persist.Store` for durability; None
        keeps the catalog purely in-memory (tests, transient engines)."""
        self.tables: dict[str, ColumnTable] = {}
        self.store = store
        self._next_version = 1
        # scalar UDF registry (query/udf.py) with the standard string/
        # url/re2/json/ip library preinstalled; engine.register_udf adds
        from ydb_tpu_torch.query.udf import UdfRegistry
        self.udfs = UdfRegistry()

    def create_table(self, name: str, schema: Schema, key_columns: list[str],
                     shards: int = 1, portion_rows: int = 1 << 20,
                     partition_by: Optional[list[str]] = None,
                     transient: bool = False,
                     store_kind: str = "column"):
        """`transient`: never persisted (materialized CTE/derived-table
        temps). `store_kind`: "column" (ColumnShard analog) or "row"
        (DataShard analog, `storage/rowtable.py`)."""
        if name in self.tables:
            raise ValueError(f"table {name!r} already exists")
        if store_kind == "row":
            from ydb_tpu_torch.storage.rowtable import RowTable
            t = RowTable(name, schema, key_columns, shards, portion_rows,
                         partition_by)
        else:
            t = ColumnTable(name, schema, key_columns, shards, portion_rows,
                            partition_by)
        t.transient = transient
        t.catalog = self            # back-ref: split/merge re-save metadata
        self.tables[name] = t
        if self.store is not None and not transient:
            t.store = self.store
            self.store.create_table(t)
            self.store.save_catalog(self)
        return t

    def drop_table(self, name: str) -> None:
        t = self.tables.pop(name)
        if self.store is not None and t.store is not None:
            self.store.drop_table(name)
            self.store.save_catalog(self)

    def table(self, name: str) -> ColumnTable:
        t = self.tables.get(name)
        if t is None:
            raise KeyError(f"unknown table {name!r}")
        return t

    def has(self, name: str) -> bool:
        return name in self.tables
