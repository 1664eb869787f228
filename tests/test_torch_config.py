"""The port's engine honours ``Config`` as the reference's does.

The counterpart of ``tests/test_config_health.py::
test_flags_gate_real_paths``: ``block_rows`` from the config when the
caller passes none, ``feature_flags.enable_fused: false`` sending every
SELECT down the portioned path (and the batched lane declining, as the
reference's ``query/batch_lane.py`` does), and ``enable_plan_cache:
false`` keeping the plan cache empty. The two rows are written through
the reference's INSERT and carried into the port with ``interop`` (the
port has no INSERT)."""

import pytest

from ydb_tpu.query import QueryEngine as JaxEngine
from ydb_tpu.utils.config import Config as JaxConfig

from ydb_tpu_torch import interop
from ydb_tpu_torch.query import QueryEngine as PortEngine
from ydb_tpu_torch.utils.config import Config
from ydb_tpu_torch.utils.metrics import GLOBAL
from tests import torch_threads  # noqa: F401,E402

DOC = {"block_rows": 1024,
       "feature_flags": {"enable_fused": False, "enable_plan_cache": False}}
SQL = "select sum(v) as s from t"


def _pair(doc):
    je = JaxEngine(config=JaxConfig.from_dict(doc))
    je.execute("create table t (id Int64 not null, v Double, "
               "primary key (id))")
    je.execute("insert into t (id, v) values (1, 1.0), (2, 2.0)")
    pe = PortEngine(device="cpu", config=Config.from_dict(doc))
    interop.load_tables(pe.catalog, interop.export_tables(je.catalog))
    return je, pe


def test_flags_gate_real_paths():
    je, pe = _pair(DOC)
    assert pe.executor.block_rows == je.executor.block_rows == 1024
    assert pe.executor.enable_fused is False
    want, got = je.query(SQL), pe.query(SQL)
    assert float(got.s[0]) == float(want.s[0]) == 3.0
    assert pe.executor.last_path == je.executor.last_path == "portioned"
    pe.query(SQL)
    je.query(SQL)
    assert pe.plan_cache_hits == je.plan_cache_hits == 0
    assert not pe._plan_cache


@pytest.mark.parametrize("flag", ["enable_fused", "enable_plan_cache"])
def test_each_flag_alone(flag):
    """Each flag gates its own path and nothing else."""
    doc = {"feature_flags": {flag: False}}
    je, pe = _pair(doc)
    assert pe.executor.block_rows == je.executor.block_rows \
        == Config().block_rows
    for _ in range(2):
        want, got = je.query(SQL), pe.query(SQL)
        assert float(got.s[0]) == float(want.s[0])
        assert pe.executor.last_path == je.executor.last_path
    assert pe.plan_cache_hits == je.plan_cache_hits
    assert pe.executor.last_path == (
        "portioned" if flag == "enable_fused" else "fused")


def test_explicit_block_rows_wins():
    pe = PortEngine(device="cpu", block_rows=4096,
                    config=Config.from_dict(DOC))
    assert pe.executor.block_rows == 4096


def test_defaults_keep_fused_and_cache():
    je, pe = _pair({})
    for _ in range(2):
        assert float(pe.query(SQL).s[0]) == float(je.query(SQL).s[0])
    assert pe.executor.last_path == "fused"
    assert pe.plan_cache_hits == je.plan_cache_hits == 1


def test_batch_lane_declines_without_the_fused_path(monkeypatch):
    """With the lane on and `enable_fused: false`, the lane declines
    every statement before grouping (reference `batch_lane.py:124`) and
    the query runs on the portioned path, as in the reference."""
    monkeypatch.setenv("YDB_TPU_BATCH_WINDOW", "500")
    je, pe = _pair(DOC)
    assert pe._batch_lane is not None and je._batch_lane is not None
    from ydb_tpu_torch.sql import parse
    plan = pe.planner.plan_select(parse(SQL))
    snap = pe.snapshot()
    assert pe._batch_lane._group_key(plan, snap, 1 << 20) is None
    d0 = GLOBAL.get("batch/declined")
    want, got = je.query(SQL), pe.query(SQL)
    assert float(got.s[0]) == float(want.s[0]) == 3.0
    assert GLOBAL.get("batch/declined") - d0 == 1
    assert pe.executor.last_path == je.executor.last_path == "portioned"
