"""Table/block schemas.

Analog of the reference's `ydb/core/formats/arrow/arrow_helpers.h` schema
plumbing plus SchemeShard table descriptions (simplified)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ydb_tpu_torch.core.dtypes import DType


@dataclass(frozen=True)
class Column:
    name: str
    dtype: DType


@dataclass
class Schema:
    columns: list[Column] = field(default_factory=list)

    def __post_init__(self):
        self._index = {c.name: i for i, c in enumerate(self.columns)}
        if len(self._index) != len(self.columns):
            raise ValueError("duplicate column names")

    @property
    def names(self) -> list[str]:
        return [c.name for c in self.columns]

    def has(self, name: str) -> bool:
        return name in self._index

    def col(self, name: str) -> Column:
        return self.columns[self._index[name]]

    def dtype(self, name: str) -> DType:
        return self.col(name).dtype

    def select(self, names: list[str]) -> "Schema":
        return Schema([self.col(n) for n in names])

    def extend(self, cols: list[Column]) -> "Schema":
        return Schema(self.columns + cols)

    def __len__(self) -> int:
        return len(self.columns)

    def __iter__(self):
        return iter(self.columns)
