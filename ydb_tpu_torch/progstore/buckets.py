"""Shape-bucketed polymorphism for scan source counts.

A table that grows by one portion at a time would mint a new program
shape per portion count — the `.sys/compiled_programs` inventory of a
steadily loaded table shows exactly that churn. Quantizing the
superblock row count K to a geometric ladder (ratio ~1.41: 1, 2, 3, 4,
6, 8, 12, 16, 24, 32, ...) caps the shapes a growing table can visit
at O(log n); the superblock pads the extra rows with zero-length
sources, which the fused kernels already mask out via the per-row
length vector, so padded execution is byte-equal to exact-K execution.

`bucket_sources` is the single tuning provider every bucketed cache
key must flow through: the bucketed K lands IN the superblock cache
key and IN the fused/batched program keys, so flipping
`YDB_TPU_SHAPE_BUCKETS` can never alias a padded program with an exact
one. `YDB_TPU_SHAPE_BUCKETS=0` disables bucketing (exact K, byte-equal
legacy shapes); any other value is the ladder ceiling above which K
passes through unbucketed (default 4096 — a table that large has
outgrown the single-superblock fused path anyway).
"""

from __future__ import annotations

import os

_DEFAULT_CEILING = 4096


def bucket_ceiling() -> int:
    """`YDB_TPU_SHAPE_BUCKETS` lever: 0 disables, else the largest K
    the ladder covers (default 4096)."""
    raw = os.environ.get("YDB_TPU_SHAPE_BUCKETS", "").strip()
    if raw == "0":
        return 0
    try:
        v = int(raw)
    except ValueError:
        v = 0
    return v if v > 0 else _DEFAULT_CEILING


def enabled() -> bool:
    return bucket_ceiling() > 0


def ladder(limit: int) -> tuple:
    """The geometric bucket ladder up to and including `limit`:
    1, 2, 3, 4, 6, 8, 12, 16, 24, 32, ... — the union of 2^e and
    3*2^e, ratio ~1.41, so a growing table visits O(log n) shapes."""
    vals = {1}
    e = 0
    while 2 ** e <= limit:
        vals.add(2 ** e)
        if 3 * 2 ** e <= limit:
            vals.add(3 * 2 ** e)
        e += 1
    return tuple(sorted(vals))


def bucket_sources(k: int) -> int:  # lint: tuning-provider
    """Quantize a scan source count UP to its ladder bucket. Identity
    when bucketing is off, K is degenerate, or K exceeds the ladder
    ceiling."""
    ceiling = bucket_ceiling()
    if ceiling <= 0 or k <= 1 or k > ceiling:
        return k
    for b in ladder(ceiling):
        if b >= k:
            return b
    return k


def segment_ladder(limit: int) -> tuple:
    """The FINE quarter-octave ladder for collective segment sizes:
    {m * 2^e : m in {4, 5, 6, 7}} — 4, 5, 6, 7, 8, 10, 12, 14, 16,
    20, ... — ratio <= 1.25. Segment padding is wire bytes shipped
    ndev^2 times, so the coarse ~1.41-ratio source ladder (up to 1.5x
    overshoot) would blow the <= 1.3x wire/live budget on its own;
    this ladder caps the per-segment overshoot at 25% while keeping
    the program-shape count O(log n)."""
    vals = {v for v in (1, 2, 3) if v <= limit}
    e = 0
    while 4 * 2 ** e <= limit:
        for m in (4, 5, 6, 7):
            if m * 2 ** e <= limit:
                vals.add(m * 2 ** e)
        e += 1
    return tuple(sorted(vals))


def bucket_segment(n: int, minimum: int = 1) -> int:  # lint: tuning-provider
    """Quantize a collective segment size UP to its fine-ladder rung
    (at least `minimum`, itself rounded up to a rung). Unlike
    `bucket_sources` this is NOT gated by `YDB_TPU_SHAPE_BUCKETS`:
    planned redistribution always buckets its segments — the ladder IS
    the shape-stability mechanism, not an optional compression of an
    exact shape."""
    n = max(int(n), int(minimum), 1)
    if n <= 4:
        return n                      # 1, 2, 3, 4 are their own rungs
    e = 0
    while 7 * 2 ** e < n:
        e += 1
    for m in (4, 5, 6, 7):
        if m * 2 ** e >= n:
            return m * 2 ** e
    return 8 * 2 ** e
