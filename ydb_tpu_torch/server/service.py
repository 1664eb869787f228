"""The result payload of the query service (from
``ydb_tpu/server/service.py``).

The port has no gRPC server yet (ROADMAP Queue 1 item 8). Its in-process
DQ worker (`dq/runner.LocalWorker.execute`) answers with the service's
JSON-safe result payload, so this module holds the two functions that
build it.
"""

from __future__ import annotations


def _frame_rows(df) -> list:
    """JSON-safe row lists (NaN/NaT → None, numpy scalars unboxed)."""
    rows = []
    for row in df.itertuples(index=False):
        out = []
        for v in row:
            if v is None or (isinstance(v, float) and v != v):
                out.append(None)
            elif hasattr(v, "item"):
                out.append(v.item())
            else:
                out.append(v)
        rows.append(out)
    return rows


def _result_payload(block, stats) -> dict:
    df = block.to_pandas()
    rows = _frame_rows(df)
    return {
        "columns": list(df.columns),
        "rows": rows,
        "stats": {
            "total_ms": stats.total_ms,
            "rows_out": stats.rows_out,
            "plan_cache_hit": stats.plan_cache_hit,
            "path": ("distributed" if stats.distributed
                     else "fused" if stats.fused else "portioned"),
        } if stats is not None else {},
    }
