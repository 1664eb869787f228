"""Columnar blocks (host side).

A ``HostBlock`` is the unit of data flow between storage, channels, and the
device compute path: a set of equal-length numpy columns with optional
validity bitmaps — the analog of an Arrow RecordBatch in the reference's scan
protocol (`ydb/core/kqp/common/kqp_compute_events.h` TEvScanData ArrowBatch)
and of MiniKQL block values (`mkql_block_builder.cpp`).

Null representation: (data, valid) pairs; ``valid is None`` means
"no nulls". String columns carry int32 dictionary codes plus a reference to
their host-side ``Dictionary``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ydb_tpu_torch.core.dictionary import Dictionary
from ydb_tpu_torch.core.dtypes import DType, Kind
from ydb_tpu_torch.core.schema import Column, Schema


@dataclass
class ColumnData:
    data: np.ndarray
    valid: Optional[np.ndarray] = None          # bool array or None (=all valid)
    dictionary: Optional[Dictionary] = None     # strings only


@dataclass
class HostBlock:
    schema: Schema
    columns: dict[str, ColumnData] = field(default_factory=dict)
    length: int = 0

    @staticmethod
    def from_arrays(
        schema: Schema,
        arrays: dict[str, np.ndarray],
        valids: Optional[dict[str, np.ndarray]] = None,
        dictionaries: Optional[dict[str, Dictionary]] = None,
    ) -> "HostBlock":
        valids = valids or {}
        dictionaries = dictionaries or {}
        cols = {}
        length = None
        for c in schema:
            a = np.asarray(arrays[c.name], dtype=c.dtype.np)
            if length is None:
                length = len(a)
            elif len(a) != length:
                raise ValueError("ragged block")
            cols[c.name] = ColumnData(a, valids.get(c.name), dictionaries.get(c.name))
        return HostBlock(schema, cols, length or 0)

    @staticmethod
    def from_pandas(df, schema: Optional[Schema] = None,
                    dictionaries: Optional[dict[str, Dictionary]] = None) -> "HostBlock":
        """Build a block from a pandas DataFrame (tests / ingestion)."""
        import pandas as pd  # noqa: F401
        from ydb_tpu_torch.core import dtypes as dt

        dictionaries = dict(dictionaries or {})
        cols: dict[str, ColumnData] = {}
        columns: list[Column] = []
        for name in df.columns:
            s = df[name]
            valid = None
            if s.isna().any():
                valid = (~s.isna()).to_numpy()
            if schema is not None:
                dtype = schema.dtype(name)
            elif s.dtype == object or str(s.dtype) in ("string", "str"):
                # object dtype is how pandas renders NULL-bearing NUMERIC
                # columns too (to_pandas emits them that way) — classify
                # by the non-null values, not the container dtype
                nonnull = s.dropna()
                if len(nonnull) and all(
                        isinstance(v, (int, float, np.integer, np.floating))
                        and not isinstance(v, bool)
                        for v in nonnull.tolist()):
                    if all(isinstance(v, (int, np.integer))
                           for v in nonnull.tolist()):
                        dtype = dt.DType(dt.Kind.INT64, True)
                    else:
                        dtype = dt.DType(dt.Kind.FLOAT64, True)
                else:
                    dtype = dt.STRING
            else:
                dtype = dt.from_numpy(s.dtype)
            if dtype.is_string:
                d = dictionaries.setdefault(name, Dictionary())
                arr = s.to_numpy(dtype=object, copy=True)
                if valid is not None:
                    arr[~valid] = None
                data = d.encode_bulk(arr)   # factorize, not 1 lookup/row
                cols[name] = ColumnData(data, valid, d)
            else:
                data = s.to_numpy(dtype=dtype.np, na_value=0) if valid is not None \
                    else s.to_numpy(dtype=dtype.np)
                cols[name] = ColumnData(np.ascontiguousarray(data), valid)
            columns.append(Column(name, dtype))
        return HostBlock(schema or Schema(columns), cols, len(df))

    def to_pandas(self):
        import pandas as pd

        out = {}
        for c in self.schema:
            cd = self.columns[c.name]
            if c.dtype.is_string and cd.dictionary is not None:
                vals = cd.dictionary.decode(cd.data)
            else:
                vals = cd.data.astype(object) if cd.valid is not None else cd.data
            if cd.valid is not None:
                vals = np.array(vals, dtype=object)
                vals[~cd.valid] = None
            out[c.name] = vals
        return pd.DataFrame(out)

    def take(self, indices: np.ndarray) -> "HostBlock":
        cols = {}
        for name, cd in self.columns.items():
            cols[name] = ColumnData(
                cd.data[indices],
                cd.valid[indices] if cd.valid is not None else None,
                cd.dictionary,
            )
        return HostBlock(self.schema, cols, len(indices))

    def slice(self, start: int, stop: int) -> "HostBlock":
        cols = {}
        for name, cd in self.columns.items():
            cols[name] = ColumnData(
                cd.data[start:stop],
                cd.valid[start:stop] if cd.valid is not None else None,
                cd.dictionary,
            )
        return HostBlock(self.schema, cols, max(0, stop - start))

    def select(self, names: list[str]) -> "HostBlock":
        return HostBlock(self.schema.select(names),
                         {n: self.columns[n] for n in names}, self.length)

    @staticmethod
    def concat(blocks: list["HostBlock"]) -> "HostBlock":
        if not blocks:
            raise ValueError("empty concat")
        if len(blocks) == 1:
            return blocks[0]
        schema = blocks[0].schema
        cols = {}
        n = sum(b.length for b in blocks)
        for c in schema:
            datas = [b.columns[c.name].data for b in blocks]
            data = np.concatenate(datas)
            valid = None
            if any(b.columns[c.name].valid is not None for b in blocks):
                valid = np.concatenate([
                    b.columns[c.name].valid if b.columns[c.name].valid is not None
                    else np.ones(b.length, dtype=np.bool_)
                    for b in blocks
                ])
            dicts = {id(b.columns[c.name].dictionary) for b in blocks
                     if b.columns[c.name].dictionary is not None}
            if len(dicts) > 1:
                raise ValueError(f"concat across different dictionaries for {c.name}")
            d = next((b.columns[c.name].dictionary for b in blocks
                      if b.columns[c.name].dictionary is not None), None)
            cols[c.name] = ColumnData(data, valid, d)
        return HostBlock(schema, cols, n)
