"""Shared harness of the DQ differential tests: sharded clusters of the
port (`ydb_tpu_torch`) and of the reference (`ydb_tpu`) over in-process
worker engines, filled from one dataset with the same split
(`ydb_tpu_torch.bench.cluster_load.worker_of`, the reference router's
INSERT routing) — the port through its loader, the reference through its
own catalog calls (create_table, write, commit, indexate), since the
port has no INSERT."""

import numpy as np
import pandas as pd

from ydb_tpu_torch.bench.cluster_load import load_sharded, worker_of

ROWS = 140
NW = 2

JOIN_SQL = ("select k, count(*) as n, sum(w) as s, min(x) as mn, "
            "max(x) as mx from t, u where k = uid group by k order by k")


def tu_tables(rows: int = ROWS, keys=None) -> dict:
    """The t/u harness of the reference's DQ ICI tests: t (140 rows, k =
    i % 7 unless `keys` overrides it, v dyadic so float sums are exact in
    any order, a string tag, nv with NULLs) and u (7 rows, x of one
    magnitude so the int8 codec's relative error stays small). Returns
    name -> (columns [(name, kind, nullable)], primary key, arrays,
    valids)."""
    i = np.arange(rows)
    k = np.asarray(keys if keys is not None else i % 7, np.int64)
    t = {"id": i.astype(np.int64), "k": k, "v": i * 0.5,
         "tag": np.array([f"tag{j % 3}" for j in i], dtype=object),
         "nv": i * 0.25}
    tv = {"nv": i % 5 != 0}
    j = np.arange(7)
    u = {"uid": j.astype(np.int64), "w": j.astype(np.float64),
         "x": 10.0 + j * 0.3}
    return {
        "t": ([("id", "int64", False), ("k", "int64", False),
               ("v", "float64", False), ("tag", "string", False),
               ("nv", "float64", True)], ["id"], t, tv),
        "u": ([("uid", "int64", False), ("w", "float64", False),
               ("x", "float64", False)], ["uid"], u, {}),
    }


def _port_schema(cols):
    from ydb_tpu_torch.core.dtypes import DType, Kind
    from ydb_tpu_torch.core.schema import Column, Schema
    return Schema([Column(n, DType(Kind(k), nl)) for (n, k, nl) in cols])


def port_engines(tables: dict, nw: int, replicated=(), block_rows=1 << 12,
                 portion_rows=1 << 20) -> list:
    from ydb_tpu_torch.query import QueryEngine
    engines = [QueryEngine(device="cpu", block_rows=block_rows)
               for _ in range(nw)]
    for name, (cols, pk, arrays, valids) in tables.items():
        load_sharded([e.catalog for e in engines], name, _port_schema(cols),
                     pk, arrays, valids, replicated=name in replicated,
                     portion_rows=portion_rows)
    return engines


def ref_engines(tables: dict, nw: int, replicated=(), block_rows=1 << 12,
                portion_rows=1 << 20) -> list:
    from ydb_tpu.core.block import HostBlock
    from ydb_tpu.core.dtypes import DType, Kind
    from ydb_tpu.core.schema import Column, Schema
    from ydb_tpu.query import QueryEngine
    from ydb_tpu.storage.mvcc import WriteVersion
    engines = [QueryEngine(block_rows=block_rows) for _ in range(nw)]
    for name, (cols, pk, arrays, valids) in tables.items():
        schema = Schema([Column(n, DType(Kind(k), nl))
                         for (n, k, nl) in cols])
        w = np.zeros(len(arrays[pk[0]]), np.int64) if name in replicated \
            else worker_of(arrays[pk[0]], nw)
        for i, e in enumerate(engines):
            idx = np.arange(len(w)) if name in replicated \
                else np.nonzero(w == i)[0]
            t = e.catalog.create_table(name, schema, list(pk),
                                       portion_rows=portion_rows)
            enc = {}
            for c in schema:
                a = np.asarray(arrays[c.name])[idx]
                enc[c.name] = t.dictionaries[c.name].encode_bulk(
                    np.asarray(a, dtype=object)) if c.dtype.is_string \
                    else np.asarray(a, dtype=c.dtype.np)
            b = HostBlock.from_arrays(
                schema, enc, valids={c: np.asarray(v)[idx]
                                     for c, v in valids.items()},
                dictionaries=dict(t.dictionaries))
            if b.length:
                t.commit(t.write(b), WriteVersion(1, 1))
                t.indexate()
    return engines


def cluster(pkg: str, engines: list, key_columns: dict, replicated=(),
            name: str = "w"):
    """A ShardedCluster of `pkg` ("port" or "ref") over `engines`."""
    if pkg == "port":
        from ydb_tpu_torch.cluster import ShardedCluster
        from ydb_tpu_torch.dq.runner import LocalWorker
    else:
        from ydb_tpu.cluster import ShardedCluster
        from ydb_tpu.dq.runner import LocalWorker
    c = ShardedCluster([LocalWorker(e, name=f"{name}{i}")
                        for i, e in enumerate(engines)],
                       merge_engine=engines[0])
    c.key_columns.update({k: list(v) for k, v in key_columns.items()})
    c.replicated = set(replicated)
    return c


def frames_equal(a: pd.DataFrame, b: pd.DataFrame, rtol=None,
                 loose_cols=()):
    """Columns and rows equal: floats bit for bit (NaN = NaN) unless in
    `loose_cols` (then to `rtol`), everything else exactly."""
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for col in a.columns:
        x, y = a[col].to_numpy(), b[col].to_numpy()
        if col in loose_cols:
            np.testing.assert_allclose(x.astype(np.float64),
                                       y.astype(np.float64), rtol=rtol)
        elif x.dtype.kind == "f" or y.dtype.kind == "f":
            assert np.array_equal(x.astype(np.float64),
                                  y.astype(np.float64),
                                  equal_nan=True), col
        else:
            assert np.array_equal(x, y), col
