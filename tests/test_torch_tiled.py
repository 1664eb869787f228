"""The tiled lane (K11 `build_tile_fn`) and the spill merge (K14) of the
port against the JAX engine.

At SF 0.01 with the budgets of `torch_budget_util` every lineitem or
orders scan exceeds the fused scan budget and streams through tiles:
q5, q6, q14, q17 and q19 finalize their partials on the device
(`fused-tiled`), q1, q3, q8, q10, q11, q16 and q22 spill them to host
key-hash partitions (`fused-tiled-spill`), q2, q15 and q20 union their
tiles on the host (`fused-tiled-union`), and q13 stays fused while a
subplan spills. Each query must give the reference's answer, path and
spilled rows and bytes; so must the reference's own two extra queries
(`tests/test_tiled.py`): a high-cardinality group-by and a filter
without ORDER BY under a 16 KiB merge budget (its rows in the
reference's order too: tiles union in scan order).
"""

import pytest

from tests.torch_budget_util import engines, run_both  # noqa: F401
from tests.tpch_util import QUERIES
from tests import torch_threads  # noqa: F401,E402

LANES = {"fused-tiled": ("q5", "q6", "q14", "q17", "q19"),
         "fused-tiled-spill": ("q1", "q3", "q8", "q10", "q11", "q16", "q22"),
         "fused-tiled-union": ("q2", "q15", "q20"),
         "fused": ("q13",)}
CASES = [(q, lane) for lane, qs in LANES.items() for q in qs]


@pytest.mark.parametrize("name,lane", CASES)
def test_tpch_beyond_budget_matches_reference(engines, name, lane):  # noqa: F811
    je, pe = engines
    _got, path, rows = run_both(je, pe, QUERIES[name])
    assert path == lane
    if lane == "fused-tiled-spill":
        assert rows > 0


@pytest.mark.parametrize("sql,lane", [
    ("select l_orderkey, sum(l_quantity) as q from lineitem "
     "group by l_orderkey order by q desc, l_orderkey limit 25",
     "fused-tiled-spill"),
    ("select l_orderkey, l_quantity from lineitem where l_quantity >= 49",
     "fused-tiled-union"),
], ids=["high-cardinality spill", "union without order by"])
def test_small_merge_budget_matches_reference(engines, sql, lane):  # noqa: F811
    je, pe = engines
    old = (je.executor.merge_budget_bytes, pe.executor.merge_budget_bytes)
    je.executor.merge_budget_bytes = pe.executor.merge_budget_bytes = 1 << 14
    try:
        _got, path, _rows = run_both(je, pe, sql)
    finally:
        je.executor.merge_budget_bytes, pe.executor.merge_budget_bytes = old
    assert path == lane
