"""GraceJoin in the port (partitioned builds, the `partition` routing of
probe blocks) against the JAX engine, and the float probe key against
an integral build.

At SF 0.01 under the budgets of `torch_budget_util`, q4, q7, q9, q12,
q18 and q21 run on the portioned path with build sides above the 64 KiB
grace budget (2 to 16 partitions) and portioned spill merges: each must
give the reference's answer, path and spilled rows and bytes. The
reference's own GraceJoin cases (`tests/test_grace_join.py`) run through
both engines; `build_partitioned`'s partitions and the routed probe
blocks must equal the reference's.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from ydb_tpu.core.block import HostBlock as JHostBlock
from ydb_tpu.ops import device as jdev
from ydb_tpu.ops import join as RJ
from ydb_tpu.query import QueryEngine as JaxEngine
from ydb_tpu.query.executor import Executor as JaxExecutor

from ydb_tpu_torch import interop
from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.ops import device as pdev
from ydb_tpu_torch.ops import join as PJ
from ydb_tpu_torch.ops.cuda import bindings
from ydb_tpu_torch.query import QueryEngine as PortEngine
from ydb_tpu_torch.query.executor import Executor as PortExecutor

from tests.torch_budget_util import engines, run_both  # noqa: F401
from tests.tpch_util import QUERIES, assert_frames_match
from tests import torch_threads  # noqa: F401,E402

GRACE = ("q4", "q7", "q9", "q12", "q18", "q21")


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **k):
        out = real(*a, **k)
        calls.append(out)
        return out
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("name", GRACE)
def test_tpch_grace_join_matches_reference(engines, monkeypatch,  # noqa: F811
                                           name):
    je, pe = engines
    builds = _counting(monkeypatch, PJ, "build_partitioned")
    routed = _counting(monkeypatch, bindings, "partition")
    je.executor.build_cache.clear()
    pe.executor.build_cache.clear()
    _got, path, _rows = run_both(je, pe, QUERIES[name])
    assert path == "portioned"
    assert builds and all(b.n_partitions >= 2 for b in builds)
    assert routed


# -- the reference's GraceJoin cases (tests/test_grace_join.py) ------------

@pytest.fixture(scope="module")
def grace():
    je = JaxEngine(block_rows=1 << 12)
    je.execute("""create table f (fid Int64 not null, k Int64 not null,
                 x Double not null, primary key (fid))""")
    je.execute("""create table d (did Int64 not null, k Int64 not null,
                 w Double not null, primary key (did))""")
    rng = np.random.default_rng(11)
    n_f, n_d = 3000, 900
    f = pd.DataFrame({"fid": np.arange(n_f),
                      "k": rng.integers(0, 400, n_f),
                      "x": rng.random(n_f).round(3)})
    d = pd.DataFrame({"did": np.arange(n_d),
                      "k": rng.integers(0, 400, n_d),
                      "w": rng.random(n_d).round(3)})
    je.catalog.table("f").bulk_upsert(f, je._next_version())
    je.catalog.table("d").bulk_upsert(d, je._next_version())
    pe = PortEngine(device="cpu", block_rows=1 << 12)
    interop.load_tables(pe.catalog, interop.export_tables(je.catalog,
                                                          ["f", "d"]))
    for e in (je, pe):
        e.executor.grace_budget_bytes = 2048     # any build over ~2KB
    return je, pe


GRACE_CASES = {
    "inner duplicate keys": "select sum(f.x * d.w) as s, count(*) as n "
                            "from f join d on f.k = d.k",
    "group by after join": "select f.k as k, count(*) as n, sum(d.w) as s "
                           "from f join d on f.k = d.k group by f.k "
                           "order by k",
    "semi": "select count(*) as n from f where f.k in (select d.k from d)",
    "anti": "select count(*) as n from f where not exists "
            "(select 1 from d where d.k = f.k)",
    "two sums": "select f.k as k, sum(f.x) as sx, sum(d.w) as sw from f "
                "join d on f.k = d.k group by f.k order by k",
}


@pytest.mark.parametrize("case", sorted(GRACE_CASES))
def test_grace_join_cases_match_reference(grace, monkeypatch, case):
    je, pe = grace
    builds = _counting(monkeypatch, PJ, "build_partitioned")
    je.executor.build_cache.clear()
    pe.executor.build_cache.clear()
    want = je.query(GRACE_CASES[case])
    got = pe.query(GRACE_CASES[case])
    assert_frames_match(got, want, ordered=True)
    assert builds and pe.executor.last_path == je.executor.last_path


def test_partitioned_matches_broadcast(grace):
    _je, pe = grace
    sql = GRACE_CASES["two sums"]
    got_grace = pe.query(sql)
    pe.executor.grace_budget_bytes = 1 << 29      # broadcast path
    pe._plan_cache.clear()
    try:
        got_bcast = pe.query(sql)
    finally:
        pe.executor.grace_budget_bytes = 2048
    pd.testing.assert_frame_equal(got_grace, got_bcast)


def _d_block(je):
    t = je.catalog.table("d")
    return JHostBlock.concat([p.block for s in t.shards for p in s.portions])


@pytest.mark.parametrize("budget", [2048, 8192, 1 << 20])
def test_build_partitioned_matches_reference(grace, budget):
    je, _pe = grace
    jb = _d_block(je)
    pb = HostBlock.from_arrays(
        _port_schema(jb), {n: jb.columns[n].data for n in jb.schema.names})
    want = RJ.build_partitioned(jb, "k", ["did", "w"], budget)
    got = PJ.build_partitioned(pb, "k", ["did", "w"], budget, "cpu")
    assert got.n_partitions == want.n_partitions and got.key == want.key
    assert len(got.tables) == len(want.tables)
    for g, w in zip(got.tables, want.tables):
        assert (g.n, g.unique, g.lut_base) == (w.n, w.unique, w.lut_base)
        np.testing.assert_array_equal(g.keys_sorted.numpy(),
                                      np.asarray(w.keys_sorted))
        assert (g.lut is None) == (w.lut is None)
        if w.lut is not None:
            np.testing.assert_array_equal(g.lut.numpy(), np.asarray(w.lut))
        for n in ("did", "w"):
            np.testing.assert_array_equal(g.payload[n].numpy(),
                                          np.asarray(w.payload[n]))


def _port_schema(jb):
    from ydb_tpu_torch.core.dtypes import DType, Kind
    from ydb_tpu_torch.core.schema import Column, Schema
    return Schema([Column(c.name, DType(Kind(c.dtype.kind.value),
                                        c.dtype.nullable))
                   for c in jb.schema.columns])


@pytest.mark.parametrize("key", ["k", "x"])
@pytest.mark.parametrize("nparts", [1, 4, 16])
def test_routed_blocks_match_reference(grace, key, nparts):
    """The port routes a probe block once through `partition`; each
    partition's block must hold the rows the reference's per-partition
    compress keeps, in the same order, at the same capacity."""
    je, _pe = grace
    t = je.catalog.table("f")
    jb = JHostBlock.concat([p.block for s in t.shards for p in s.portions])
    rng = np.random.default_rng(nparts)
    x = jb.columns["x"].data * 1000
    x[rng.random(x.shape[0]) < 0.05] = np.nan          # floats route by
    x[rng.random(x.shape[0]) < 0.02] = np.inf           # their int64 value
    arrays = {"fid": jb.columns["fid"].data, "k": jb.columns["k"].data,
              "x": x}
    cap = 4096
    live = jb.length - 123
    jd = jdev.to_device(JHostBlock.from_arrays(
        jb.schema, arrays, {"k": rng.random(jb.length) > 0.1}), cap)
    jd = jdev.DeviceBlock(jd.schema, jd.arrays, jd.valids, live, cap, {})
    pd_ = pdev.to_device(HostBlock.from_arrays(
        _port_schema(jb), arrays, {"k": np.asarray(jd.valids["k"])[:jb.length]}),
        "cpu", cap)
    pd_ = pdev.DeviceBlock(pd_.schema, pd_.arrays, pd_.valids,
                           torch.tensor(live, dtype=torch.int32), cap, {})
    parts = PortExecutor._partition_block(pd_, key, nparts)
    assert len(parts) == nparts
    for p, got in enumerate(parts):
        want = JaxExecutor._partition_block(jd, key, p, nparts)
        n = int(want.length)
        assert int(got.length) == n and got.capacity == want.capacity
        for c in arrays:
            np.testing.assert_array_equal(got.arrays[c].numpy()[:n],
                                          np.asarray(want.arrays[c])[:n])
        np.testing.assert_array_equal(got.valids["k"].numpy()[:n],
                                      np.asarray(want.valids["k"])[:n])


# -- a float probe key against an integral build --------------------------

@pytest.mark.parametrize("lane", ["fused", "portioned"])
def test_float_probe_key_against_integral_build(lane):
    rng = np.random.default_rng(33)
    x = rng.integers(0, 15, 50).astype(np.float64)
    x[rng.random(50) < 0.3] += 0.5                 # never equal to a key
    f = pd.DataFrame({"fid": np.arange(50), "x": x})
    d = pd.DataFrame({"k": np.arange(10), "w": rng.random(10)})
    je = JaxEngine(block_rows=1 << 12)
    je.execute("create table f (fid Int64 not null, x Double, "
               "primary key (fid))")
    je.execute("create table d (k Int64 not null, w Double, "
               "primary key (k))")
    je.catalog.table("f").bulk_upsert(f, je._next_version())
    je.catalog.table("d").bulk_upsert(d, je._next_version())
    pe = PortEngine(device="cpu", block_rows=1 << 12)
    interop.load_tables(pe.catalog, interop.export_tables(je.catalog,
                                                          ["f", "d"]))
    if lane == "portioned":
        pe.executor.fuse_max_joins = 0
    sql = "select f.fid, d.w from f join d on f.x = d.k order by f.fid"
    want = je.query(sql)
    got = pe.query(sql)
    assert je.executor.last_path == "fused"
    assert pe.executor.last_path == lane
    assert len(want) == int(np.isin(x, np.arange(10)).sum()) > 0
    pd.testing.assert_frame_equal(got, want)
