"""Stored tables carried across packages.

A database's state is its tables. ``export_tables`` describes every
column table of a catalog as plain data — numpy arrays and Python
values — and ``load_tables`` builds the port's ``ColumnTable``s from
such a description, through the same write → commit → indexate path the
loaders use, so both catalogs hold the same portions and dictionary
codes. ``export_tables`` reads only the catalog's public structure
(tables, shards, portions, dictionaries), so it describes a reference
catalog as well as a port one without importing either package.

The description, per table name::

    {"columns": [(name, kind, nullable), ...],   # kind: DType kind string
     "data": {name: ndarray},          # storage values; codes for strings
     "valid": {name: bool ndarray},    # only for columns with NULLs
     "dictionaries": {name: [str, ...]},   # values in code order
     "primary_key": [name, ...], "shards": int, "portion_rows": int}
"""

from __future__ import annotations

import numpy as np

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.dictionary import Dictionary
from ydb_tpu_torch.core.dtypes import DType, Kind
from ydb_tpu_torch.core.schema import Column, Schema
from ydb_tpu_torch.storage.mvcc import MAX_SNAPSHOT, WriteVersion


def export_tables(catalog, names=None) -> dict:
    """Describe the visible rows of `catalog`'s column tables (all, or
    `names`), shard by shard and portion by portion in storage order."""
    out = {}
    for name in (names if names is not None else list(catalog.tables)):
        t = catalog.table(name)
        cols = [(c.name, c.dtype.kind.value, c.dtype.nullable)
                for c in t.schema]
        blocks = []
        for shard in t.shards:
            portions, inserts = shard.scan_sources(MAX_SNAPSHOT, None)
            for p in portions:
                blocks.append(p.visible_block(MAX_SNAPSHOT) if p.deletes
                              else p.block)
            blocks.extend(e.block for e in inserts)
        data, valid = {}, {}
        for (cname, kind, _nullable) in cols:
            parts = [b.columns[cname].data for b in blocks]
            data[cname] = np.concatenate(parts) if parts else \
                np.zeros(0, DType(Kind(kind)).np)
            if any(b.columns[cname].valid is not None for b in blocks):
                valid[cname] = np.concatenate(
                    [b.columns[cname].valid
                     if b.columns[cname].valid is not None
                     else np.ones(b.length, np.bool_) for b in blocks])
        out[name] = {
            "columns": cols,
            "data": data,
            "valid": valid,
            "dictionaries": {c: list(d.values_array())
                             for c, d in t.dictionaries.items()},
            "primary_key": list(t.key_columns),
            "shards": len(t.shards),
            "portion_rows": t.shards[0].portion_rows,
        }
    return out


def load_tables(catalog, tables: dict) -> None:
    """Create and fill one column table per entry of `tables` (the
    description above) in the port's `catalog`."""
    for name, spec in tables.items():
        schema = Schema([Column(c, DType(Kind(kind), bool(nullable)))
                         for (c, kind, nullable) in spec["columns"]])
        table = catalog.create_table(name, schema, list(spec["primary_key"]),
                                     shards=int(spec["shards"]),
                                     portion_rows=int(spec["portion_rows"]))
        for cname, values in spec.get("dictionaries", {}).items():
            d = Dictionary()
            d.encode(list(values))
            table.dictionaries[cname] = d
        block = HostBlock.from_arrays(
            schema, {c.name: spec["data"][c.name] for c in schema},
            valids=dict(spec.get("valid", {})),
            dictionaries=dict(table.dictionaries))
        if block.length:
            writes = table.write(block)
            table.commit(writes, WriteVersion(1, 1))
            table.indexate()
