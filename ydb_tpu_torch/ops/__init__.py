from ydb_tpu_torch.ops.ir import (
    Agg, Assign, Call, Col, Const, Filter, GroupBy, Param, Program, Projection,
)

__all__ = [
    "Agg", "Assign", "Call", "Col", "Const", "Filter", "GroupBy", "Param",
    "Program", "Projection",
]
