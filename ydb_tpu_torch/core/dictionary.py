"""Append-only string dictionaries.

The device data plane never sees raw bytes: string columns travel as int32
codes; the dictionary (codes → values) stays on the host. String predicates
(LIKE/eq/substr) are evaluated once over the dictionary on the host, producing
a boolean/typed lookup table the device gathers through — the TPU-native
counterpart of the reference's dictionary encoding
(`ydb/core/formats/arrow/dictionary/`) + hyperscan/re2 string UDFs
(`ydb/library/yql/udfs/common/`).
"""

from __future__ import annotations

import numpy as np


class Dictionary:
    """Append-only value dictionary: value <-> int32 code."""

    __slots__ = ("_map", "_values", "_ranks")

    def __init__(self):
        self._map: dict[str, int] = {}
        self._values: list[str] = []
        self._ranks = None          # (len, ranks) memo — see sort_ranks

    def __len__(self) -> int:
        return len(self._values)

    def encode(self, values) -> np.ndarray:
        """Encode an iterable of python strings (None → code -1)."""
        m = self._map
        vals = self._values
        out = np.empty(len(values), dtype=np.int32)
        for i, v in enumerate(values):
            if v is None:
                out[i] = -1
                continue
            code = m.get(v)
            if code is None:
                code = len(vals)
                m[v] = code
                vals.append(v)
            out[i] = code
        return out

    def encode_bulk(self, values: np.ndarray) -> np.ndarray:
        """Vectorized encode of an object array (None → -1): hash-factorize
        once (C speed), then encode only the distinct values through the
        Python-dict path. 60M rows cost one factorize + a take, not 60M
        dict lookups."""
        import pandas as pd
        codes, uniques = pd.factorize(values, use_na_sentinel=True)
        if hasattr(uniques, "to_numpy"):
            uniques = uniques.to_numpy(dtype=object)
        # str-coerce at the UNIQUES level (small): non-str objects (a
        # numeric-looking column pandas inferred as int) must enter the
        # dictionary as strings, or lookups/sorts break; equal-after-str
        # values collapse to one code via the encode map
        lut = self.encode([u if isinstance(u, str) else str(u)
                           for u in uniques])
        lut = np.concatenate([lut, np.array([-1], np.int32)])  # -1 slot
        return lut[codes].astype(np.int32)

    def encode_existing(self, value: str) -> int:
        """Code for a value, or -2 (never matches) if absent."""
        return self._map.get(value, -2)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        values = self.values_array()
        out = np.empty(len(codes), dtype=object)
        ok = codes >= 0
        out[ok] = values[codes[ok]]
        out[~ok] = None
        return out

    def values_array(self) -> np.ndarray:
        # length captured first: a concurrent writer appending (append-only,
        # codes are stable) must not grow the list mid-conversion
        vals = self._values
        return np.asarray(vals[:len(vals)], dtype=object)

    def sort_ranks(self) -> np.ndarray:
        """code → lexicographic rank (int32), memoized per dictionary
        length: sort keys recompute this per query, and at URL-scale
        cardinality a fresh double-argsort over millions of strings costs
        seconds. Append-only dictionaries make the (len, ranks) memo
        exact."""
        vals = self._values
        n = len(vals)
        cached = self._ranks
        if cached is not None and cached[0] == n:
            return cached[1]
        if not n:
            ranks = np.zeros(1, np.int32)
        else:
            arr = np.asarray(vals[:n], dtype=object)
            ranks = np.argsort(np.argsort(arr, kind="stable")) \
                .astype(np.int32)
        self._ranks = (n, ranks)
        return ranks

    def lut(self, predicate) -> np.ndarray:
        """Evaluate `predicate(value) -> bool` over all dictionary entries.

        Returns a bool LUT of len(dict); the device evaluates the predicate
        on a code column as `lut[code]` (a gather).
        """
        vals = self._values
        n = len(vals)                 # stable under concurrent appends
        out = np.empty(n, dtype=np.bool_)
        for i in range(n):
            out[i] = predicate(vals[i])
        return out
