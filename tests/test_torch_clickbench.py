"""The 43 ClickBench queries through the port and the JAX engine.

The set-up of ``tests/test_clickbench.py`` (20,000 rows, 2 shards,
4,096-row portions, 8,192-row blocks), the same hits table in both
packages from the copied generator (``ydb_tpu_torch/bench/
clickbench_gen.py``). Answers must be equal under
``assert_frames_match`` (rtol 1e-9 for floats, exact otherwise, row
order included), on the same execution path.
"""

import pytest

from ydb_tpu.bench.clickbench_gen import load_hits as load_ref
from ydb_tpu.query import QueryEngine as JEngine

from ydb_tpu_torch.bench.clickbench_gen import load_hits
from ydb_tpu_torch.query import QueryEngine as PEngine

from tests.clickbench_util import QUERIES
from tests.tpch_util import assert_frames_match
from tests import torch_threads  # noqa: F401,E402

ROWS = 20_000


@pytest.fixture(scope="module")
def engines():
    j = JEngine(block_rows=1 << 13)
    load_ref(j.catalog, n_rows=ROWS, shards=2, portion_rows=1 << 12)
    p = PEngine(device="cpu", block_rows=1 << 13)
    load_hits(p.catalog, n_rows=ROWS, shards=2, portion_rows=1 << 12)
    return j, p


@pytest.mark.parametrize("name", list(QUERIES))
def test_clickbench_query_matches_reference(engines, name):
    j, p = engines
    want = j.query(QUERIES[name])
    got = p.query(QUERIES[name])
    assert_frames_match(got, want, ordered=True, rtol=1e-9)
    assert p.executor.last_path == j.executor.last_path
