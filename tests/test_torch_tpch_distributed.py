"""TPC-H through the port's mesh lanes, against the oracle and the reference.

Both engines load TPC-H at SF 0.002 with 4 shards and 2,048-row
portions (the reference's own mesh setup,
`tests/test_tpch_distributed.py`), so the scans spread over the 8
shards of the mesh (`make_mesh(8, device="cpu")` in the port, 8 virtual
CPU devices in the reference). The reference's quick subset, its map
query and two queries whose last join the shuffle join accepts (with the
broadcast budget forced to 1) must give the pandas oracle's answers
(ints, codes and row order equal, floats within rtol 1e-9) through the
lane the reference takes for them (`LANES`): `distributed`,
`distributed-map` and `distributed-shuffle-join` are each taken. The
reference engine on its 8-device mesh costs seconds a query on the CPU,
so one query of each lane is also held against it, answer and lane:
q1, the map query and q14 through the shuffle join.
"""

import pandas as pd
import pytest

from ydb_tpu.bench.tpch_gen import load_tpch as jax_load_tpch
from ydb_tpu.parallel import make_mesh as ref_mesh
from ydb_tpu.query import QueryEngine as JaxEngine

from ydb_tpu_torch.bench import tpch_gen as port_gen
from ydb_tpu_torch.parallel import make_mesh
from ydb_tpu_torch.query import QueryEngine as PortEngine

from tests.tpch_util import QUERIES, assert_frames_match, oracle
from tests import torch_threads  # noqa: F401,E402

SF = 0.002
QUICK = ("q1", "q4", "q6", "q11", "q12", "q14", "q15", "q19")
SHUFFLE_JOIN = ("q12", "q14")
# the lane the reference engine takes for each query in this setup
LANES = {**{q: "distributed" for q in QUICK}, "q15": "distributed-map"}
AGAINST_REFERENCE = {"q1", "map", "q14 (sj)"}
MAP_SQL = ("select l_orderkey, l_extendedprice from lineitem "
           "where l_quantity > 45 and l_discount >= 0.05 "
           "order by l_extendedprice desc, l_orderkey limit 20")


@pytest.fixture(scope="module")
def engines():
    je = JaxEngine(block_rows=1 << 13, mesh=ref_mesh(8))
    data = jax_load_tpch(je.catalog, sf=SF, shards=4, portion_rows=1 << 11)
    pe = PortEngine(device="cpu", block_rows=1 << 13,
                    mesh=make_mesh(8, device="cpu"))
    port_gen.load_tpch(pe.catalog, sf=SF, shards=4, portion_rows=1 << 11)
    return je, pe, data


def _run(engines, sql, tag, path):
    """The port's answer on `path`; held against the reference engine's
    (answer and lane) for the queries of AGAINST_REFERENCE."""
    je, pe, _data = engines
    got = pe.query(sql)
    assert pe.executor.last_path == path
    if tag in AGAINST_REFERENCE:
        want = je.query(sql)
        assert je.executor.last_path == path
        assert_frames_match(got, want, ordered=True)
    return got


@pytest.mark.parametrize("name", QUICK)
def test_tpch_on_the_mesh(engines, name):
    got = _run(engines, QUERIES[name], name, LANES[name])
    want = oracle(name, engines[2])
    want.columns = list(got.columns)
    assert_frames_match(got, want, ordered=True)
    if name == "q1":
        assert engines[1].executor._dist_aggs


def test_map_distribution_non_agg(engines):
    got = _run(engines, MAP_SQL, "map", "distributed-map")
    li = pd.DataFrame(engines[2].tables["lineitem"])
    w = li[(li.l_quantity > 45) & (li.l_discount >= 0.05)] \
        .sort_values(["l_extendedprice", "l_orderkey"],
                     ascending=[False, True]).head(20)
    assert list(got.l_orderkey) == list(w.l_orderkey)


@pytest.mark.parametrize("name", SHUFFLE_JOIN)
def test_tpch_shuffle_join(engines, monkeypatch, name):
    je, pe, data = engines
    for e in (je, pe):
        monkeypatch.setattr(e.executor, "dist_broadcast_budget_bytes", 1)
    got = _run(engines, QUERIES[name], f"{name} (sj)",
               "distributed-shuffle-join")
    want = oracle(name, data)
    want.columns = list(got.columns)
    assert_frames_match(got, want, ordered=True)


def test_one_shard_mesh_skips_the_mesh_lanes(engines):
    """On a one-shard mesh the mesh lanes are skipped, as the
    reference's are: the statement takes the fused path."""
    _je, pe, data = engines
    one = PortEngine(device="cpu", catalog=pe.catalog, block_rows=1 << 13,
                     mesh=make_mesh(1, device="cpu"))
    got = one.query(QUERIES["q6"])
    assert one.executor.last_path == "fused"
    want = oracle("q6", data)
    want.columns = list(got.columns)
    assert_frames_match(got, want, ordered=True)
