"""The port's main path end to end against the reference engine.

`ydb_tpu.query.QueryEngine` and `ydb_tpu_torch.query.QueryEngine(
device="cpu")` load the same TPC-H data (SF 0.002, two shards, 8192-row
portions, so scans stack several portions) and answer all 22 TPC-H
queries; the answers must agree under the repo's TPC-H checker (rtol
1e-9 for floats, exact otherwise, row order included), with late
materialization on and off, and the port must take its fused path.
"""

import numpy as np
import pytest

from ydb_tpu.bench.tpch_gen import load_tpch as jax_load_tpch
from ydb_tpu.query import QueryEngine as JaxEngine

from ydb_tpu_torch import interop
from ydb_tpu_torch.bench import tpch_gen as port_gen
from ydb_tpu_torch.query import QueryEngine as PortEngine
from ydb_tpu_torch.utils.metrics import GLOBAL

from tests.tpch_util import QUERIES, assert_frames_match
from tests import torch_threads  # noqa: F401,E402

SF = 0.002
SLICE = tuple(f"q{i}" for i in range(1, 23))


def _engines(sf: float):
    je = JaxEngine(block_rows=1 << 13)
    jax_load_tpch(je.catalog, sf=sf, shards=2, portion_rows=1 << 13)
    pe = PortEngine(device="cpu", block_rows=1 << 13)
    port_gen.load_tpch(pe.catalog, sf=sf, shards=2, portion_rows=1 << 13)
    return je, pe


@pytest.fixture(scope="module")
def engines():
    return _engines(SF)


@pytest.mark.parametrize("late", ["1", "0"])
@pytest.mark.parametrize("name", SLICE)
def test_slice_query_matches_reference(engines, monkeypatch, name, late):
    monkeypatch.setenv("YDB_TPU_LATE_MAT", late)
    je, pe = engines
    want = je.query(QUERIES[name])
    got = pe.query(QUERIES[name])
    assert pe.executor.last_path == "fused"
    assert_frames_match(got, want, ordered=True)


@pytest.mark.parametrize("late", ["1", "0"])
def test_q10_medium_domain_lane_matches_reference(monkeypatch, late):
    """At SF 0.01 q10's group key domain (customers) lies between 513
    and 65,535 buckets, so its group-by takes the medium-domain lane
    (K4) in both packages."""
    from ydb_tpu_torch.ops import torch_exec
    from ydb_tpu_torch.ops.cuda import bindings
    monkeypatch.setenv("YDB_TPU_LATE_MAT", late)
    je, pe = _engines(0.01)
    calls = []
    lane = torch_exec._groupby_medium_domain

    def counted(*a, **k):
        calls.append(1)
        return lane(*a, **k)
    monkeypatch.setattr(torch_exec, "_groupby_medium_domain", counted)
    perms = []
    real = bindings.bucket_perm
    monkeypatch.setattr(bindings, "bucket_perm",
                        lambda *a, **k: perms.append(1) or real(*a, **k))
    want = je.query(QUERIES["q10"])
    got = pe.query(QUERIES["q10"])
    assert calls, "q10 did not take the medium-domain lane"
    assert perms, "q10's medium-domain lane did not call bucket_perm"
    assert pe.executor.last_path == "fused"
    assert_frames_match(got, want, ordered=True)


def test_materialized_temps_are_dropped(engines):
    _je, pe = engines
    before = set(pe.catalog.tables)
    pe.query(QUERIES["q15"])      # WITH revenue
    pe.query(QUERIES["q13"])      # a derived table
    assert set(pe.catalog.tables) == before


def test_compact_overflow_reruns_with_the_same_answer(engines, monkeypatch):
    monkeypatch.setenv("YDB_TPU_LATE_MAT", "1")
    je, pe = engines
    sql = QUERIES["q6"]
    want = je.query(sql)
    ex = pe.executor
    # forge the compact bound low: the device flags the overflow and the
    # statement reruns without the compact
    monkeypatch.setattr(ex, "_compact_sizing", lambda *a, **k: 64)
    before = GLOBAL.get("latemat/compact_overflow_reruns")
    got = pe.query(sql)
    assert GLOBAL.get("latemat/compact_overflow_reruns") == before + 1
    assert_frames_match(got, want, ordered=True)


def test_generator_is_bit_identical_to_the_reference():
    from ydb_tpu.bench.tpch_gen import TpchData as JData
    want = JData(SF, 19920101)
    got = port_gen.TpchData(SF, 19920101)
    assert set(got.tables) == set(want.tables)
    for t in want.tables:
        for c, w in want.tables[t].items():
            g = got.tables[t][c]
            assert g.dtype == w.dtype, (t, c)
            if w.dtype == object:
                assert list(g) == list(w), (t, c)
            else:
                np.testing.assert_array_equal(g.view(np.uint8),
                                              w.view(np.uint8),
                                              err_msg=f"{t}.{c}")


def test_interop_carries_codes_and_portions(engines):
    je, _pe = engines
    pe = PortEngine(device="cpu")
    spec = interop.export_tables(je.catalog, ["lineitem", "part", "nation"])
    interop.load_tables(pe.catalog, spec)
    for name in spec:
        jt, pt = je.catalog.table(name), pe.catalog.table(name)
        assert [c.name for c in jt.schema] == [c.name for c in pt.schema]
        for c, d in jt.dictionaries.items():
            assert list(pt.dictionaries[c].values_array()) == \
                list(d.values_array())
        assert len(jt.shards) == len(pt.shards)
        for js, ps in zip(jt.shards, pt.shards):
            assert [p.num_rows for p in js.portions] == \
                [p.num_rows for p in ps.portions]
            for jp, pp in zip(js.portions, ps.portions):
                for c in jt.schema.names:
                    np.testing.assert_array_equal(
                        pp.block.columns[c].data, jp.block.columns[c].data,
                        err_msg=f"{name}.{c}")
    got = pe.query(QUERIES["q14"])
    assert_frames_match(got, je.query(QUERIES["q14"]), ordered=True)


@pytest.mark.parametrize("sql", [
    "select l_orderkey, row_number() over (partition by l_orderkey "
    "order by l_linenumber) as rn from lineitem",
    "select l_returnflag, 1 + sum(l_quantity) over "
    "(partition by l_returnflag) as s from lineitem",
])
def test_window_functions_raise_not_ported(engines, sql):
    """Window functions raised NotPorted until the port carried them (the
    test keeps its name); they now answer as the reference does, the
    window pass in the pandas lane below `window_device_min_rows`."""
    je, pe = engines
    assert_frames_match(pe.query(sql), je.query(sql), ordered=True)
