"""Shared set-up of the beyond-budget tests (`test_torch_tiled.py`,
`test_torch_grace.py`): the JAX engine and the port's CPU engine over the
same TPC-H data at SF 0.01 (two shards, 1,024-row portions), both with
the device budgets cut so that every lane runs — fused scan 2^18, tile
2^20, merge 2^17, grace 2^16 bytes — and a runner that holds one query's
answer, path and spilled rows of the port against the reference's.

The reference's compile-ahead lane re-runs a plan's join builds on a
background thread, so its spill counters count a spilling build subplan
once or twice depending on the race; the port has no such lane, and the
tests run the reference with it off (`YDB_TPU_COMPILE_AHEAD=0`)."""

import pytest

from ydb_tpu.bench.tpch_gen import load_tpch as jax_load_tpch
from ydb_tpu.query import QueryEngine as JaxEngine
from ydb_tpu.utils.metrics import GLOBAL as JAX_METRICS

from ydb_tpu_torch.bench import tpch_gen as port_gen
from ydb_tpu_torch.query import QueryEngine as PortEngine
from ydb_tpu_torch.utils.metrics import GLOBAL as PORT_METRICS

from tests.tpch_util import assert_frames_match

SF = 0.01
BUDGETS = {"fused_scan_budget_bytes": 1 << 18, "tile_budget_bytes": 1 << 20,
           "merge_budget_bytes": 1 << 17, "grace_budget_bytes": 1 << 16}


@pytest.fixture(scope="module")
def engines():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YDB_TPU_COMPILE_AHEAD", "0")
        je = JaxEngine(block_rows=1 << 10)
        data = jax_load_tpch(je.catalog, sf=SF, shards=2,
                             portion_rows=1 << 10)
        pe = PortEngine(device="cpu", block_rows=1 << 10)
        port_gen.load_tpch(pe.catalog, sf=SF, shards=2, portion_rows=1 << 10)
        for ex in (je.executor, pe.executor):
            for k, v in BUDGETS.items():
                setattr(ex, k, v)
        je.tpch_data = data
        yield je, pe


def spilled(metrics) -> tuple:
    snap = metrics.snapshot()
    return (snap.get("executor/spilled_rows", 0),
            snap.get("executor/spilled_bytes", 0))


def run_both(je, pe, sql: str, ordered: bool = True):
    """One query through both engines: equal answers (rtol 1e-9 for
    floats), equal `last_path` and equal spilled rows and bytes. Returns
    the port's answer and path."""
    j0 = spilled(JAX_METRICS)
    want = je.query(sql)
    j1 = spilled(JAX_METRICS)
    p0 = spilled(PORT_METRICS)
    got = pe.query(sql)
    p1 = spilled(PORT_METRICS)
    assert_frames_match(got, want, ordered=ordered)
    assert pe.executor.last_path == je.executor.last_path
    assert (p1[0] - p0[0], p1[1] - p0[1]) == (j1[0] - j0[0], j1[1] - j0[1])
    return got, pe.executor.last_path, p1[0] - p0[0]
