"""Column data types.

The type lattice follows the reference's YQL primitive types as used by the
columnar path (`ydb/core/formats/arrow/switch/switch_type.h`,
`ydb/library/yql/public/udf/udf_data_type.h`): fixed-width integers, floats,
bool, date/timestamp, and strings. Strings are dictionary-encoded for the
device path (codes on TPU, dictionary on host) — the reference has the same
move in `ydb/core/formats/arrow/dictionary/`.

Decimal follows the reference's own TPC-H schema choice of Double
(`ydb/public/lib/ydb_cli/commands/tpch_schema.sql`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class Kind(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DATE32 = "date32"          # days since unix epoch, int32 storage
    TIMESTAMP = "timestamp"    # microseconds since epoch, int64 storage
    STRING = "string"          # dictionary-encoded: int32 codes + host dict


_NUMPY = {
    Kind.BOOL: np.bool_,
    Kind.INT8: np.int8,
    Kind.INT16: np.int16,
    Kind.INT32: np.int32,
    Kind.INT64: np.int64,
    Kind.UINT8: np.uint8,
    Kind.UINT16: np.uint16,
    Kind.UINT32: np.uint32,
    Kind.UINT64: np.uint64,
    Kind.FLOAT32: np.float32,
    Kind.FLOAT64: np.float64,
    Kind.DATE32: np.int32,
    Kind.TIMESTAMP: np.int64,
    Kind.STRING: np.int32,     # physical: dictionary codes
}

_INTS = {Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64,
         Kind.UINT8, Kind.UINT16, Kind.UINT32, Kind.UINT64}
_FLOATS = {Kind.FLOAT32, Kind.FLOAT64}


@dataclass(frozen=True)
class DType:
    kind: Kind
    nullable: bool = True

    @property
    def np(self) -> type:
        """Physical numpy storage dtype."""
        return _NUMPY[self.kind]

    @property
    def is_integer(self) -> bool:
        return self.kind in _INTS

    @property
    def is_float(self) -> bool:
        return self.kind in _FLOATS

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float

    @property
    def is_string(self) -> bool:
        return self.kind is Kind.STRING

    @property
    def is_temporal(self) -> bool:
        return self.kind in (Kind.DATE32, Kind.TIMESTAMP)

    def with_nullable(self, nullable: bool) -> "DType":
        return DType(self.kind, nullable)

    def __repr__(self) -> str:  # compact: Int64?, Float64
        return self.kind.value + ("?" if self.nullable else "")


# Convenience constructors
BOOL = DType(Kind.BOOL)
INT8 = DType(Kind.INT8)
INT16 = DType(Kind.INT16)
INT32 = DType(Kind.INT32)
INT64 = DType(Kind.INT64)
UINT8 = DType(Kind.UINT8)
UINT16 = DType(Kind.UINT16)
UINT32 = DType(Kind.UINT32)
UINT64 = DType(Kind.UINT64)
FLOAT32 = DType(Kind.FLOAT32)
FLOAT64 = DType(Kind.FLOAT64)
DATE32 = DType(Kind.DATE32)
TIMESTAMP = DType(Kind.TIMESTAMP)
STRING = DType(Kind.STRING)


def common_numeric(a: DType, b: DType) -> DType:
    """Binary-op result type promotion (YQL-style: float wins, wider wins)."""
    if not (a.is_numeric and b.is_numeric):
        if a.kind == b.kind:
            return DType(a.kind, a.nullable or b.nullable)
        raise TypeError(f"no common type for {a} and {b}")
    kind = Kind(np.promote_types(a.np, b.np).name)
    return DType(kind, a.nullable or b.nullable)


def from_numpy(dt: np.dtype) -> DType:
    return DType(Kind(np.dtype(dt).name))
