"""Shared hash functions.

One definition for every consumer (shard routing, device shuffle
partitioning, join hashing) so host and device agree bit-for-bit —
the role `ydb/core/formats/arrow/hash/calcer.cpp` plays in the reference.
"""

from __future__ import annotations

import numpy as np

_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB
_GOLDEN = 0x9E3779B97F4A7C15


def splitmix64(xp, x):
    """splitmix64 finalizer; xp is numpy or jax.numpy.

    Input is converted to uint64 bits (numpy path uses a view to avoid
    value conversion of negatives; jax wraps via astype).
    """
    if xp is not np:
        from ydb_tpu_torch.errors import NotPorted
        raise NotPorted("device-side u64 hashing (K12)")
    u = np.ascontiguousarray(x.astype(np.int64)).view(np.uint64).copy()
    u = (u ^ (u >> np.uint64(30))) * np.uint64(_C1)
    u = (u ^ (u >> np.uint64(27))) * np.uint64(_C2)
    return u ^ (u >> np.uint64(31))


def hash_combine(xp, h, x):
    return h ^ (x + np.uint64(_GOLDEN) + (h << np.uint64(6)) + (h >> np.uint64(2)))
