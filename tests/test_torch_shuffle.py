"""The distributed aggregation and the shuffle join (K17) against the
reference's, on 8-shard meshes.

`DistributedAgg.run` of both packages takes the same per-shard blocks
(made from a seeded numpy generator) on the cases of
`tests/test_shuffle.py`, the overflow rerun included. The shuffle-join
cases of `tests/test_shuffle_join.py` run through both engines over the
same tables with the broadcast budget forced to 1, so every eligible
join partitions its build: answers, row order and `last_path` must be
equal (floats within rtol 1e-9), and equal to pandas. The port's mesh
lists the CPU eight times (`make_mesh(8, device="cpu")`); the
reference's is its 8 virtual CPU devices.
"""

import numpy as np
import pandas as pd
import pytest

from ydb_tpu.core import dtypes as rdt
from ydb_tpu.core.block import HostBlock as RBlock
from ydb_tpu.core.dictionary import Dictionary as RDictionary
from ydb_tpu.core.schema import Column as RColumn, Schema as RSchema
from ydb_tpu.ops import ir as rir
from ydb_tpu.parallel import DistributedAgg as RAgg, make_mesh as ref_mesh
from ydb_tpu.query import QueryEngine as JaxEngine
from ydb_tpu.sql import parse as jax_parse
from ydb_tpu.storage.mvcc import WriteVersion as RWriteVersion

from ydb_tpu_torch import interop
from ydb_tpu_torch.core import dtypes as pdt
from ydb_tpu_torch.core.block import HostBlock as PBlock
from ydb_tpu_torch.core.schema import Column as PColumn, Schema as PSchema
from ydb_tpu_torch.ops import ir as pir
from ydb_tpu_torch.parallel import DistributedAgg as PAgg, make_mesh
from ydb_tpu_torch.query import QueryEngine as PortEngine
from ydb_tpu_torch.sql import parse as port_parse
from ydb_tpu_torch.utils.metrics import GLOBAL

from tests.tpch_util import assert_frames_match
from tests import torch_threads  # noqa: F401,E402


@pytest.fixture(scope="module")
def meshes():
    return ref_mesh(8), make_mesh(8, device="cpu")


# -- DistributedAgg.run ----------------------------------------------------


def _schemas():
    return (RSchema([RColumn("k", rdt.DType(rdt.Kind.INT64, False)),
                     RColumn("v", rdt.DType(rdt.Kind.FLOAT64, True))]),
            PSchema([PColumn("k", pdt.DType(pdt.Kind.INT64, False)),
                     PColumn("v", pdt.DType(pdt.Kind.FLOAT64, True))]))


def _blocks(seed, rows, nkeys):
    rng = np.random.default_rng(seed)
    rs, ps = _schemas()
    ref, port = [], []
    for d in range(8):
        n = rows + d * 17
        k = rng.integers(0, nkeys, n)
        v = rng.normal(size=n) * 10
        m = rng.random(n) < 0.9
        ref.append(RBlock.from_arrays(rs, {"k": k, "v": v}, valids={"v": m}))
        port.append(PBlock.from_arrays(ps, {"k": k, "v": v},
                                       valids={"v": m}))
    return ref, port


def _programs(ir, case):
    if case == "grouped_sum":
        return (ir.Program().group_by(
            ["k"], [ir.Agg("s", "sum", "v"), ir.Agg("c", "count", "v"),
                    ir.Agg("n", "count_all")]),
            ir.Program().group_by(
            ["k"], [ir.Agg("s", "sum", "s"), ir.Agg("c", "sum", "c"),
                    ir.Agg("n", "sum", "n")]))
    if case == "global":
        return (ir.Program().group_by(
            [], [ir.Agg("s", "sum", "v"), ir.Agg("n", "count_all")]),
            ir.Program().group_by(
            [], [ir.Agg("s", "sum", "s"), ir.Agg("n", "sum", "n")]))
    if case == "minmax_filter":
        dt = rdt if ir is rir else pdt
        partial = ir.Program()
        partial.filter(ir.call("gt", ir.Col("v"),
                               ir.Const(0.0, dt.FLOAT64)))
        partial.group_by(["k"], [ir.Agg("mn", "min", "v"),
                                 ir.Agg("mx", "max", "v")])
        return partial, ir.Program().group_by(
            ["k"], [ir.Agg("mn", "min", "mn"), ir.Agg("mx", "max", "mx")])
    raise KeyError(case)


@pytest.mark.parametrize("case,rows,nkeys", [
    ("grouped_sum", 500, 37), ("global", 300, 5),
    ("minmax_filter", 400, 11)])
def test_distributed_agg_matches_reference(meshes, case, rows, nkeys):
    rmesh, pmesh = meshes
    rblocks, pblocks = _blocks(rows + nkeys, rows, nkeys)
    rs, ps = _schemas()
    want = RAgg(*_programs(rir, case), rs, rmesh).run(rblocks).to_pandas()
    got = PAgg(*_programs(pir, case), ps, pmesh).run(pblocks).to_pandas()
    assert len(got) == (1 if case == "global" else len(want))
    assert_frames_match(got, want, ordered=True)


def test_overflow_reruns_at_full_capacity(meshes):
    """seg_rows=2 overflows (~5 partial rows per target): run discards
    the clamped result, reruns with full-capacity segments and answers
    exactly, as the reference does."""
    rmesh, pmesh = meshes
    rblocks, pblocks = _blocks(9, 200, 37)
    rs, ps = _schemas()
    ragg = RAgg(*_programs(rir, "grouped_sum"), rs, rmesh, seg_rows=2)
    pagg = PAgg(*_programs(pir, "grouped_sum"), ps, pmesh, seg_rows=2)
    want = ragg.run(rblocks).to_pandas()
    got = pagg.run(pblocks).to_pandas()
    assert ragg.seg_rows == 0 and pagg.seg_rows == 0
    assert_frames_match(got, want, ordered=True)
    k = np.concatenate([b.columns["k"].data for b in pblocks])
    assert len(got) == len(np.unique(k))


# -- the shuffle join through both engines ----------------------------------


def _spec(columns, data, pk, dictionaries=None):
    return {"columns": columns, "data": data, "valid": {},
            "dictionaries": dictionaries or {}, "primary_key": pk,
            "shards": 2, "portion_rows": 1 << 11}


def _strings(values):
    """Dictionary codes of `values` in first-seen order."""
    uniq = list(dict.fromkeys(values))
    code = {v: i for i, v in enumerate(uniq)}
    return np.array([code[v] for v in values], np.int32), uniq


def _tables():
    i64, f64, s = "int64", "float64", "string"
    out, frames = {}, {}
    n, m = 20_000, 4_000
    ids = np.arange(n)
    frames["fact"] = pd.DataFrame({"id": ids, "k": (ids * 7) % m,
                                   "g": ids % 11, "v": ids * 0.5})
    frames["dim"] = pd.DataFrame({"k2": np.arange(0, m, 2),
                                  "w": np.arange(0, m, 2) * 1.5})
    n = 8_000
    ids = np.arange(n)
    frames["cfact"] = pd.DataFrame({"id": ids, "a": ids % 37, "b": ids % 11,
                                    "v": ids * 0.25})
    pairs = [(a, b, (a * 100 + b) * 0.5) for a in range(0, 37, 2)
             for b in range(11)]
    frames["cdim"] = pd.DataFrame(pairs, columns=["a2", "b2", "w"])
    n = 6_000
    ids = np.arange(n)
    frames["sfact"] = pd.DataFrame({"id": ids,
                                    "tag": [f"t{i % 97}" for i in ids],
                                    "v": ids * 0.5})
    # the dim's strings in another order: other dictionary codes
    frames["sdim"] = pd.DataFrame([(f"t{k}", k * 2.0)
                                   for k in range(96, -1, -3)],
                                  columns=["tag2", "w"])
    frames["s2fact"] = pd.DataFrame({"id": ids,
                                     "tag": [f"t{i % 40}" for i in ids],
                                     "v": ids * 0.5})
    frames["s2dim"] = pd.DataFrame([(f"t{k}", k * 2.0) for k in range(120)],
                                   columns=["tag2", "w"])
    n = 8_000
    ids = np.arange(n)
    frames["q9f"] = pd.DataFrame({"id": ids, "pk": ids % 53, "sk": ids % 13,
                                  "g": ids % 5, "v": ids * 0.1})
    frames["q9d"] = pd.DataFrame({"sk2": np.arange(13),
                                  "nm": [f"n{x % 4}" for x in range(13)]})
    frames["q9ps"] = pd.DataFrame(
        [(p, q, p + q * 0.25) for p in range(53) for q in range(13)
         if (p + q) % 3 != 0], columns=["pk2", "sk3", "cost"])
    pks = {"fact": ["id"], "dim": ["k2"], "cfact": ["id"],
           "cdim": ["a2", "b2"], "sfact": ["id"], "sdim": ["tag2"],
           "s2fact": ["id"], "s2dim": ["tag2"], "q9f": ["id"],
           "q9d": ["sk2"], "q9ps": ["pk2", "sk3"]}
    for name, df in frames.items():
        cols, data, dicts = [], {}, {}
        for c in df.columns:
            x = df[c].to_numpy()
            if x.dtype == object:
                data[c], dicts[c] = _strings(list(x))
                cols.append((c, s, False))
            else:
                data[c] = x.astype(np.float64 if x.dtype.kind == "f"
                                   else np.int64)
                cols.append((c, f64 if x.dtype.kind == "f" else i64, False))
        out[name] = _spec(cols, data, pks[name], dicts)
    return out, frames


def _load_reference(catalog, tables):
    """The reference's catalog filled as `interop.load_tables` fills the
    port's: one write, commit and indexation per table."""
    for name, spec in tables.items():
        schema = RSchema([RColumn(c, rdt.DType(rdt.Kind(k), nl))
                          for (c, k, nl) in spec["columns"]])
        t = catalog.create_table(name, schema, list(spec["primary_key"]),
                                 shards=spec["shards"],
                                 portion_rows=spec["portion_rows"])
        for c, values in spec["dictionaries"].items():
            d = RDictionary()
            d.encode(list(values))
            t.dictionaries[c] = d
        block = RBlock.from_arrays(schema, dict(spec["data"]),
                                   dictionaries=dict(t.dictionaries))
        t.commit(t.write(block), RWriteVersion(1, 1))
        t.indexate()


@pytest.fixture(scope="module")
def eng():
    tables, frames = _tables()
    je = JaxEngine(block_rows=1 << 10, mesh=ref_mesh(8))
    _load_reference(je.catalog, tables)
    pe = PortEngine(device="cpu", block_rows=1 << 10,
                    mesh=make_mesh(8, device="cpu"))
    interop.load_tables(pe.catalog, tables)
    # every build is "too big to broadcast": the partitioned lane
    je.executor.dist_broadcast_budget_bytes = 1
    pe.executor.dist_broadcast_budget_bytes = 1
    return je, pe, frames


def _both(eng, sql, path="distributed-shuffle-join"):
    je, pe, _f = eng
    want = je.query(sql)
    got = pe.query(sql)
    assert je.executor.last_path == pe.executor.last_path == path
    assert_frames_match(got, want, ordered=True)
    return got


def test_shuffle_inner_join_agg(eng):
    before = GLOBAL.snapshot().get("executor/shuffle_joins", 0)
    got = _both(eng, "select g, count(*) as n, sum(v + w) as s from fact, "
                     "dim where k = k2 group by g order by g")
    assert GLOBAL.snapshot().get("executor/shuffle_joins", 0) > before
    f = eng[2]
    j = f["fact"].merge(f["dim"], left_on="k", right_on="k2")
    w = j.assign(s=j.v + j.w).groupby("g").agg(
        n=("s", "size"), s=("s", "sum")).reset_index()
    assert list(got.g) == list(w.g) and list(got.n) == list(w.n)
    np.testing.assert_allclose(got.s, w.s, rtol=1e-9)


def test_shuffle_semi_join_agg(eng):
    got = _both(eng, "select g, sum(v) as s from fact where k in "
                     "(select k2 from dim) group by g order by g")
    f = eng[2]
    w = f["fact"][f["fact"].k.isin(f["dim"].k2)].groupby("g").v.sum()
    np.testing.assert_allclose(got.s, w.to_numpy(), rtol=1e-9)


def test_shuffle_anti_join_agg(eng):
    got = _both(eng, "select g, count(*) as n from fact where not exists "
                     "(select * from dim where k2 = k) group by g order by g")
    f = eng[2]
    w = f["fact"][~f["fact"].k.isin(f["dim"].k2)].groupby("g").size()
    assert list(got.n) == list(w)


def test_shuffle_join_global_agg(eng):
    got = _both(eng, "select sum(v * w) as s, count(*) as n "
                     "from fact, dim where k = k2")
    f = eng[2]
    j = f["fact"].merge(f["dim"], left_on="k", right_on="k2")
    np.testing.assert_allclose(got.s[0], (j.v * j.w).sum(), rtol=1e-9)
    assert got.n[0] == len(j)


def test_shuffle_join_composite_key(eng):
    got = _both(eng, "select count(*) as n, sum(v + w) as s from cfact, "
                     "cdim where a = a2 and b = b2")
    f = eng[2]
    j = f["cfact"].merge(f["cdim"], left_on=["a", "b"],
                         right_on=["a2", "b2"])
    assert int(got.n[0]) == len(j)
    np.testing.assert_allclose(got.s[0], (j.v + j.w).sum(), rtol=1e-9)


@pytest.mark.parametrize("fact,dim", [("sfact", "sdim"),
                                      ("s2fact", "s2dim")])
def test_shuffle_join_string_key(eng, fact, dim):
    """Build codes remap into the probe dictionary; build values absent
    from it (s2dim) are dropped before the exchange."""
    got = _both(eng, f"select count(*) as n, sum(v + w) as s from {fact}, "
                     f"{dim} where tag = tag2")
    f = eng[2]
    j = f[fact].merge(f[dim], left_on="tag", right_on="tag2")
    assert int(got.n[0]) == len(j)
    np.testing.assert_allclose(got.s[0], (j.v + j.w).sum(), rtol=1e-9)


def test_shuffle_join_q9_shape(eng):
    got = _both(eng, "select nm, sum(v - cost) as profit from q9f, q9d, "
                     "q9ps where sk = sk2 and pk = pk2 and sk = sk3 "
                     "group by nm order by nm")
    f = eng[2]
    j = f["q9f"].merge(f["q9d"], left_on="sk", right_on="sk2") \
        .merge(f["q9ps"], left_on=["pk", "sk"], right_on=["pk2", "sk3"])
    w = j.assign(profit=j.v - j.cost).groupby("nm", as_index=False) \
        .profit.sum()
    assert list(got.nm) == list(w.nm)
    np.testing.assert_allclose(got.profit, w.profit, rtol=1e-9)


def test_no_device_holds_full_build():
    """Each shard's build partition is a strict subset, disjoint by key
    hash, and equal to the reference's partition."""
    from ydb_tpu.parallel.shuffle_join import partition_build as ref_pb

    from ydb_tpu_torch.parallel.shuffle_join import partition_build

    n = 10_000
    data = {"k": np.arange(n, dtype=np.int64),
            "w": np.arange(n, dtype=np.float64)}
    rs = RSchema([RColumn("k", rdt.DType(rdt.Kind.INT64, False)),
                  RColumn("w", rdt.DType(rdt.Kind.FLOAT64, False))])
    ps = PSchema([PColumn("k", pdt.DType(pdt.Kind.INT64, False)),
                  PColumn("w", pdt.DType(pdt.Kind.FLOAT64, False))])
    arrays, pschema, _dicts, bcap = partition_build(
        PBlock.from_arrays(ps, data), "k", ["w"], 8)
    want, _s, _d, wcap = ref_pb(RBlock.from_arrays(rs, data), "k", ["w"], 8)
    assert bcap == wcap and pschema.names == ["w"]
    np.testing.assert_array_equal(arrays["ns"], want["ns"])
    np.testing.assert_array_equal(arrays["keys"], want["keys"])
    np.testing.assert_array_equal(arrays["payload"]["w"],
                                  want["payload"]["w"])
    assert int(arrays["ns"].sum()) == n
    assert all(int(c) < n for c in arrays["ns"])
    seen = set()
    for p in range(8):
        ks = set(arrays["keys"][p][:arrays["ns"][p]].tolist())
        assert not (ks & seen)
        seen |= ks
    assert len(seen) == n


def test_batch_lane_declines_on_a_mesh(monkeypatch, eng):
    """The batched serving lane declines on a mesh of more than one
    shard, as the reference's does; the statement takes a mesh lane."""
    monkeypatch.setenv("YDB_TPU_BATCH_WINDOW", "50")
    tables, frames = _tables()
    tables = {"fact": tables["fact"]}
    sql = "select g, sum(v) as s from fact where v > 10 group by g"
    je = JaxEngine(block_rows=1 << 10, mesh=ref_mesh(8))
    _load_reference(je.catalog, tables)
    pe = PortEngine(device="cpu", block_rows=1 << 10,
                    mesh=make_mesh(8, device="cpu"))
    lone = PortEngine(device="cpu", block_rows=1 << 10)
    for e in (pe, lone):
        interop.load_tables(e.catalog, tables)
    keys = []
    for e, parse in ((je, jax_parse), (pe, port_parse), (lone, port_parse)):
        plan = e.planner.plan_select(parse(sql))
        assert plan.lift_sig is not None
        keys.append(e._batch_lane._group_key(plan, e.snapshot(), 1 << 20))
    assert keys[0] is None and keys[1] is None and keys[2] is not None
    got = pe.query(sql).sort_values("g").reset_index(drop=True)
    assert pe.executor.last_path == "distributed"
    f = frames["fact"]
    w = f[f.v > 10].groupby("g").v.sum().reset_index(name="s")
    assert list(got.g) == list(w.g)
    np.testing.assert_allclose(got.s, w.s, rtol=1e-9)
