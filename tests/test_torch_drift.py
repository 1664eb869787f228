"""Drift test for the modules the port copies from the reference.

Each module below is the reference module with its import prefix
rewritten (``ydb_tpu`` → ``ydb_tpu_torch`` in ``import`` / ``from``
lines) and with exactly the edits listed here, each with its reason.
Any other difference fails: a change to the reference must be carried
into the port (or listed here), and the port must not drift on its own.
"""

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_IMPORT = re.compile(r"(?m)^(\s*)(from|import) ydb_tpu(?=[. ])")

COPIED = """core/__init__ core/dtypes core/schema core/block core/dictionary
ops/__init__ ops/ir ops/numpy_exec ops/kernels utils/__init__ utils/hashing
storage/__init__ storage/mvcc storage/portion storage/shard storage/table
storage/pushdown scheme/__init__ scheme/catalog sql/__init__ sql/lexer
sql/parser sql/ast sql/render query/__init__ query/binder query/plan
query/planner query/bounds query/latemat query/paramlift query/stats
query/udf query/build_cache bench/tpch_gen
progstore/buckets""".split()

_NOT_PORTED_ROWS = """            from ydb_tpu_torch.errors import NotPorted
            raise NotPorted("row tables (storage/rowtable.py)")
"""

# module -> [(reason, reference text after the prefix rewrite, port text)]
EDITS = {
    "utils/hashing": [(
        "jax-only branch removed: device-side u64 hashing is Queue 2 K12",
        """    if xp is np:
        u = np.ascontiguousarray(x.astype(np.int64)).view(np.uint64).copy()
    else:
        u = x.astype(xp.int64).astype(xp.uint64)
""",
        """    if xp is not np:
        from ydb_tpu_torch.errors import NotPorted
        raise NotPorted("device-side u64 hashing (K12)")
    u = np.ascontiguousarray(x.astype(np.int64)).view(np.uint64).copy()
""")],
    "scheme/catalog": [(
        "NotPorted stub: row tables are outside the slice",
        """            from ydb_tpu_torch.storage.rowtable import RowTable
            t = RowTable(name, schema, key_columns, shards, portion_rows,
                         partition_by)
""", _NOT_PORTED_ROWS)],
    "query/planner": [(
        "NotPorted stub: DQ stage graphs are outside the slice",
        """        from ydb_tpu_torch.dq.lower import lower_select

        def table_cols(table: str) -> list:
            return list(self.catalog.table(table).schema.names)
        return lower_select(sel, topology, table_cols)
""",
        """        from ydb_tpu_torch.errors import NotPorted
        raise NotPorted("DQ stage graphs (dq/lower.py)")
""")],
    "query/latemat": [(
        "lazy import repointed: the lever lives in ops/torch_exec.py",
        "from ydb_tpu_torch.ops.xla_exec import late_mat_enabled",
        "from ydb_tpu_torch.ops.torch_exec import late_mat_enabled")],
    "ops/kernels": [
        ("torch lowering: the namespace shim and its astype helper",
         """from ydb_tpu_torch.core.dtypes import (
    BOOL, DType, FLOAT64, INT32, Kind, common_numeric,
)
""",
         """from ydb_tpu_torch.core.dtypes import (
    BOOL, DType, FLOAT64, INT32, Kind, common_numeric,
)
from ydb_tpu_torch.ops.torch_ns import astype as _astype
"""),
        ("torch lowering: no astype or numpy dtype probe on tensors",
         """    num = a.astype(np.float64) if np.issubdtype(np.asarray(a).dtype if xp is np else a.dtype, np.integer) else a
    den = b.astype(num.dtype) if hasattr(b, "dtype") else b
""",
         """    integral = np.issubdtype(np.asarray(a).dtype, np.integer) if xp is np else xp.is_integer(a)
    num = _astype(xp, a, np.float64) if integral else a
    den = _astype(xp, b, num.dtype) if hasattr(b, "dtype") else b
"""),
        ("torch lowering: masks are made like their argument (device)",
         "    return xp.ones(like.shape, dtype=bool) if hasattr(like, \"shape\") else True\n",
         "    return xp.ones_like(like, dtype=bool) if hasattr(like, \"shape\") else True\n"),
        ("torch lowering: masks are made like their argument (device)",
         "    return xp.zeros(like.shape, dtype=bool) if hasattr(like, \"shape\") else False\n",
         "    return xp.zeros_like(like, dtype=bool) if hasattr(like, \"shape\") else False\n"),
        ("torch lowering: masks are made like their argument (device)",
         "        return _zeros(xp, da) if not hasattr(da, \"shape\") else xp.zeros(da.shape, dtype=bool), None\n",
         "        return _zeros(xp, da), None\n"),
        ("torch lowering: masks are made like their argument (device)",
         "    return da, xp.zeros(da.shape, dtype=bool)\n",
         "    return da, xp.zeros_like(da, dtype=bool)\n"),
        ("torch lowering: no astype on tensors",
         "    return a[0].astype(target)\n",
         "    return _astype(xp, a[0], target)\n"),
        ("torch lowering: no astype on tensors",
         "    z = days.astype(np.int64) + 719468\n",
         "    z = _astype(xp, days, np.int64) + 719468\n"),
        ("torch lowering: no astype on tensors",
         """_reg("year", _rt_i32, lambda xp, a, e: _civil(xp, a[0])[0].astype(np.int32))
_reg("month", _rt_i32, lambda xp, a, e: _civil(xp, a[0])[1].astype(np.int32))
_reg("day_of_month", _rt_i32, lambda xp, a, e: _civil(xp, a[0])[2].astype(np.int32))
""",
         """_reg("year", _rt_i32, lambda xp, a, e: _astype(xp, _civil(xp, a[0])[0], np.int32))
_reg("month", _rt_i32, lambda xp, a, e: _astype(xp, _civil(xp, a[0])[1], np.int32))
_reg("day_of_month", _rt_i32, lambda xp, a, e: _astype(xp, _civil(xp, a[0])[2], np.int32))
"""),
        ("torch lowering: no astype on tensors",
         """     lambda xp, a, e: ((a[0] // 3600) % 24).astype(np.int32))
_reg("minute_of_hour", _rt_i32,
     lambda xp, a, e: ((a[0] // 60) % 60).astype(np.int32))
_reg("second_of_minute", _rt_i32,
     lambda xp, a, e: (a[0] % 60).astype(np.int32))
""",
         """     lambda xp, a, e: _astype(xp, (a[0] // 3600) % 24, np.int32))
_reg("minute_of_hour", _rt_i32,
     lambda xp, a, e: _astype(xp, (a[0] // 60) % 60, np.int32))
_reg("second_of_minute", _rt_i32,
     lambda xp, a, e: _astype(xp, a[0] % 60, np.int32))
"""),
    ],
}


def expected_port_text(module: str) -> str:
    ref = (ROOT / "ydb_tpu" / f"{module}.py").read_text()
    text = _IMPORT.sub(r"\1\2 ydb_tpu_torch", ref)
    for reason, old, new in EDITS.get(module, ()):
        assert text.count(old) == 1, \
            f"{module}: listed edit ({reason}) no longer matches the reference"
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("module", COPIED)
def test_copy_matches_reference(module):
    port = (ROOT / "ydb_tpu_torch" / f"{module}.py").read_text()
    assert port == expected_port_text(module), (
        f"ydb_tpu_torch/{module}.py drifted from ydb_tpu/{module}.py "
        "beyond the edits listed in tests/test_torch_drift.py")


def test_every_edit_has_a_reason():
    for module, edits in EDITS.items():
        assert module in COPIED
        for reason, old, new in edits:
            assert reason and old != new
