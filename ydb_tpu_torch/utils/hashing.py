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
    if xp is np:
        u = np.ascontiguousarray(x.astype(np.int64)).view(np.uint64).copy()
    else:
        from ydb_tpu_torch.ops.cuda.bindings import hash64
        return hash64([x])
    u = (u ^ (u >> np.uint64(30))) * np.uint64(_C1)
    u = (u ^ (u >> np.uint64(27))) * np.uint64(_C2)
    return u ^ (u >> np.uint64(31))


def hash_combine(xp, h, x):
    if xp is not np:
        from ydb_tpu_torch.ops.cuda.bindings import hash64
        return hash64([h, x], pre=[False, False])
    return h ^ (x + np.uint64(_GOLDEN) + (h << np.uint64(6)) + (h >> np.uint64(2)))
