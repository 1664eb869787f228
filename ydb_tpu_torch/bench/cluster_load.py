"""Fill the catalogs of a sharded cluster's worker engines.

The port has no INSERT yet, so the router cannot route rows into its
workers. This loader splits one dataset the way the reference router's
INSERT routing does (`ydb_tpu/cluster/router.py` `_route_insert`): a row
of a sharded table goes to worker `splitmix64(pk[0]) % n` (as uint64)
for an int key, `crc32(pk[0]) % n` for a string key; a replicated table
is copied whole into every worker. Each worker's table is filled
through the storage calls a landed DQ channel uses: `create_table`,
`write`, `commit` and `indexate`, with the worker's own string
dictionaries (built from its own rows, as inserts build them).

    engines = [QueryEngine() for _ in range(4)]
    data, replicated, keys = load_tpch_cluster(
        [e.catalog for e in engines], sf=1.0)
    cluster = ShardedCluster([LocalWorker(e) for e in engines])
    cluster.replicated, cluster.key_columns = replicated, keys
"""

from __future__ import annotations

import zlib

import numpy as np

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.storage.mvcc import WriteVersion
from ydb_tpu_torch.utils.hashing import splitmix64

# the TPC-H tables the DQ configuration shards (co-partitioned on the
# order key); the other six are replicated
TPCH_SHARDED = {"lineitem": ["l_orderkey", "l_linenumber"],
                "orders": ["o_orderkey"]}


def worker_of(keys: np.ndarray, n: int) -> np.ndarray:
    """The worker of every row, from its first primary-key column: the
    reference router's INSERT routing."""
    keys = np.asarray(keys)
    if keys.dtype.kind in "OUS":
        h = np.array([zlib.crc32(str(v).encode()) for v in keys],
                     np.uint64)
    else:
        h = splitmix64(np, keys.astype(np.int64))
    return (h % np.uint64(n)).astype(np.int64)


def load_table(catalog, name: str, schema, key_columns: list,
               arrays: dict, valids: dict = None,
               portion_rows: int = 1 << 20):
    """Create and fill one column table: `arrays` holds each column's
    values (strings as Python str objects), `valids` the NULL masks of
    the nullable ones."""
    valids = valids or {}
    table = catalog.create_table(name, schema, list(key_columns),
                                 portion_rows=portion_rows)
    enc = {}
    for c in schema:
        a = arrays[c.name]
        if c.dtype.is_string:
            enc[c.name] = table.dictionaries[c.name].encode_bulk(
                np.asarray(a, dtype=object))
        else:
            enc[c.name] = np.asarray(a, dtype=c.dtype.np)
    block = HostBlock.from_arrays(schema, enc,
                                  valids={k: np.asarray(v, np.bool_)
                                          for k, v in valids.items()},
                                  dictionaries=dict(table.dictionaries))
    if block.length:
        table.commit(table.write(block), WriteVersion(1, 1))
        table.indexate()
    return table


def load_sharded(catalogs: list, name: str, schema, key_columns: list,
                 arrays: dict, valids: dict = None, replicated: bool = False,
                 portion_rows: int = 1 << 20) -> None:
    """One table into every worker catalog: whole when `replicated`,
    else split by `worker_of` its first key column."""
    valids = valids or {}
    if replicated:
        for cat in catalogs:
            load_table(cat, name, schema, key_columns, arrays, valids,
                       portion_rows)
        return
    w = worker_of(arrays[key_columns[0]], len(catalogs))
    for i, cat in enumerate(catalogs):
        idx = np.nonzero(w == i)[0]
        load_table(cat, name, schema, key_columns,
                   {c: np.asarray(a)[idx] for c, a in arrays.items()},
                   {c: np.asarray(v)[idx] for c, v in valids.items()},
                   portion_rows)


def load_tpch_cluster(catalogs: list, sf: float, seed: int = 19920101,
                      portion_rows: int = 1 << 20, data=None):
    """TPC-H at `sf` over the worker catalogs: lineitem and orders split
    by the router's rule on the order key, the other six replicated.
    `data`: an already generated `TpchData` of that scale and seed.
    Returns (the `TpchData`, the replicated table names, the sharded
    tables' key columns) — what the router's `replicated` and
    `key_columns` take."""
    from ydb_tpu_torch.bench.tpch_gen import TPCH_SCHEMAS, TpchData
    if data is None:
        data = TpchData(sf, seed)
    replicated = set()
    for tname, (schema, keys) in TPCH_SCHEMAS.items():
        rep = tname not in TPCH_SHARDED
        if rep:
            replicated.add(tname)
        load_sharded(catalogs, tname, schema, keys, data.tables[tname],
                     replicated=rep, portion_rows=portion_rows)
    return data, replicated, {t: list(k) for t, k in TPCH_SHARDED.items()}
