"""All 73 TPC-DS queries through the port and the JAX engine.

The set-up of ``tests/test_tpcds.py`` (SF 0.01, 2 shards, 4,096-row
portions, 8,192-row blocks), the same tables in both packages from the
copied generator (``ydb_tpu_torch/bench/tpcds_gen.py``). Answers must be
equal under ``assert_frames_match`` (rtol 1e-9 for floats, exact
otherwise, row order included) and each query must end on the same
execution path (``executor.last_path``) in both. The ten windowed
queries run again with ``window_device_min_rows=0`` in both engines, so
their window pass takes the device lane (the port's through the
``window_scan`` kernel's plain version).
"""

import pytest

from ydb_tpu.bench.tpcds_gen import load_tpcds as load_ref
from ydb_tpu.query import QueryEngine as JEngine
from ydb_tpu.utils.config import Config as JConfig

from ydb_tpu_torch.bench.tpcds_gen import load_tpcds
from ydb_tpu_torch.ops.cuda import bindings
from ydb_tpu_torch.query import QueryEngine as PEngine
from ydb_tpu_torch.utils.config import Config as PConfig

from tests.tpcds_util import QUERIES
from tests.tpch_util import assert_frames_match
from tests import torch_threads  # noqa: F401,E402

WINDOWED = ("ds12", "ds20", "ds44", "ds47", "ds53", "ds63", "ds67", "ds70",
            "ds89", "ds98")
PORTIONED = ("ds25", "ds29", "ds59", "ds72")
LITERAL = ("ds9", "ds28", "ds61", "ds77", "ds88", "ds90")


def _pair(min_rows=None):
    jc, pc = JConfig(), PConfig()
    if min_rows is not None:
        jc.window_device_min_rows = pc.window_device_min_rows = min_rows
    j = JEngine(block_rows=1 << 13, config=jc)
    load_ref(j.catalog, sf=0.01, shards=2, portion_rows=1 << 12)
    p = PEngine(device="cpu", block_rows=1 << 13, config=pc)
    load_tpcds(p.catalog, sf=0.01, shards=2, portion_rows=1 << 12)
    return j, p


@pytest.fixture(scope="module")
def engines():
    return _pair()


@pytest.fixture(scope="module")
def device_window_engines():
    return _pair(min_rows=0)


def _check(engs, name):
    j, p = engs
    want = j.query(QUERIES[name])
    got = p.query(QUERIES[name])
    assert_frames_match(got, want, ordered=True, rtol=1e-9)
    assert p.executor.last_path == j.executor.last_path
    return p.executor.last_path


@pytest.mark.parametrize("name", list(QUERIES))
def test_tpcds_query_matches_reference(engines, name):
    path = _check(engines, name)
    if name in PORTIONED:
        assert path == "portioned"
    if name in LITERAL:
        assert path == "literal"


@pytest.mark.parametrize("name", WINDOWED)
def test_tpcds_windowed_query_on_the_device_lane(device_window_engines, name,
                                                 monkeypatch):
    calls = []
    real = bindings.window_scan_plain
    monkeypatch.setattr(bindings, "window_scan_plain",
                        lambda *a: calls.append(1) or real(*a))
    _check(device_window_engines, name)
    assert calls, "the port's window pass did not take the device lane"
