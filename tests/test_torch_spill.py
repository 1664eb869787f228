"""The spill lane's partition step (K14) against the reference.

The same seeded blocks go through `ydb_tpu.ops.spill._partition_sort`
(jax on the CPU) and the port's `_partition_sort` (the `hash64` and
`partition` wrappers, which run their plain versions for CPU tensors),
and `partition_plain` is held against the reference's sort directly:
integer, nullable, float (NaN, ±inf, −0.0, out of the int64 range) and
two-column keys, 1 to 256 partitions, live lengths below the capacity.
Moved columns, masks and counts must be equal bit for bit.
`PartitionStore` and `host_sort_limit` are the reference's host code
and must give its pieces, counters and orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydb_tpu.core.block import HostBlock as JHostBlock
from ydb_tpu.core.dtypes import DType as JDType, Kind as JKind
from ydb_tpu.core.schema import Column as JColumn, Schema as JSchema
from ydb_tpu.ops import device as jdev
from ydb_tpu.ops import spill as RS
from ydb_tpu.query.plan import SortKey as JSortKey
from ydb_tpu.utils.hashing import hash_combine, splitmix64

from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.dictionary import Dictionary
from ydb_tpu_torch.core.dtypes import DType, Kind
from ydb_tpu_torch.core.schema import Column, Schema
from ydb_tpu_torch.ops import spill as PS
from ydb_tpu_torch.ops.cuda import bindings as B
from ydb_tpu_torch.ops.device import DeviceBlock
from ydb_tpu_torch.query.plan import SortKey
from tests import torch_threads  # noqa: F401,E402

FLOATS = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, -2.5, 1e300,
                   9.3e18, -9.3e18, 7.0])
KEYS = {"int": ("k",), "nullable": ("kn",), "float": ("f",),
        "two": ("kn", "f")}
SHAPES = [(1, 4096, 4096), (2, 1000, 700), (8, 5000, 4999),
          (64, 3000, 1), (256, 9000, 8500), (16, 128, 0)]


def _block(rng, cap: int):
    arrays = {"k": rng.integers(-50, 50, cap).astype(np.int64),
              "kn": rng.integers(0, 1 << 40, cap).astype(np.int64),
              "f": rng.choice(FLOATS, cap),
              "w": rng.random(cap),
              "c": rng.integers(0, 1 << 62, cap).astype(np.uint64)
              .view(np.int64),
              "i": rng.integers(-9, 9, cap).astype(np.int32)}
    valids = {"kn": rng.random(cap) > 0.3, "w": rng.random(cap) > 0.1}
    return arrays, valids


def _reference(arrays, valids, length, keys, nparts):
    ra, rv, rc = RS._partition_sort(
        {k: jnp.asarray(v) for k, v in arrays.items()},
        {k: jnp.asarray(v) for k, v in valids.items()}, jnp.int32(length),
        tuple(arrays), keys, nparts)
    return ({k: np.asarray(v) for k, v in ra.items()},
            {k: np.asarray(v) for k, v in rv.items()}, np.asarray(rc))


def _t(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.mark.parametrize("nparts,cap,length", SHAPES)
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_partition_sort_matches_reference(keys, nparts, cap, length):
    rng = np.random.default_rng(nparts * 7919 + cap)
    arrays, valids = _block(rng, cap)
    ra, rv, rc = _reference(arrays, valids, length, KEYS[keys], nparts)
    pa, pv, pc = PS._partition_sort(_t(arrays), _t(valids),
                                    torch.tensor(length, dtype=torch.int32),
                                    tuple(arrays), KEYS[keys], nparts)
    np.testing.assert_array_equal(pc.numpy(), rc)
    assert pc.dtype == torch.int64 and int(pc.sum()) == length
    for k in arrays:
        np.testing.assert_array_equal(pa[k].numpy().view(np.uint8),
                                      ra[k].view(np.uint8), err_msg=k)
    for k in valids:
        np.testing.assert_array_equal(pv[k].numpy(), rv[k], err_msg=k)


@pytest.mark.parametrize("nparts,cap,length", SHAPES)
def test_partition_plain_is_the_reference_sort(nparts, cap, length):
    """The wrapper's plain version from the hashes alone: ids (rows past
    the length in bin nparts), counts and the stable (partition, row)
    order of the reference's sort; rows past `n` of a longer output are
    zero."""
    rng = np.random.default_rng(nparts + cap)
    arrays, valids = _block(rng, cap)
    h = hash_combine(np, splitmix64(np, arrays["k"]),
                     splitmix64(np, arrays["kn"]))
    want_ids = np.where(np.arange(cap) < length,
                        (h % np.uint64(nparts)).astype(np.int32), nparts)
    order = np.lexsort((np.arange(cap), want_ids))
    cols = [arrays["w"], arrays["i"], valids["kn"]]
    ids, counts, outs = B.partition(torch.from_numpy(h.view(np.int64)),
                                    length, nparts,
                                    [torch.from_numpy(c) for c in cols],
                                    out_rows=cap + 77)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(want_ids, minlength=nparts + 1)[:nparts])
    for c, o in zip(cols, outs):
        np.testing.assert_array_equal(o.numpy()[:cap], c[order])
        assert not o.numpy()[cap:].any()


@pytest.mark.parametrize("nparts", [3, 0, 512])
def test_partition_takes_powers_of_two_up_to_256(nparts):
    with pytest.raises(ValueError, match="power of two"):
        B.partition(torch.zeros(8, dtype=torch.int64), 8, nparts, [])


def test_as_int64_converts_floats_as_xla_does():
    x = np.concatenate([FLOATS, [2.0 ** 63, -2.0 ** 63, 9.2e18, -2.7, 3.9]])
    np.testing.assert_array_equal(
        PS.as_int64(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.int64)))
    with np.errstate(over="ignore"):
        x32 = x.astype(np.float32)             # 1e300 → inf
    np.testing.assert_array_equal(
        PS.as_int64(torch.from_numpy(x32)).numpy(),
        np.asarray(jnp.asarray(x32).astype(jnp.int64)))


_COLS = [("g", Kind.INT64, True), ("f", Kind.FLOAT64, False),
         ("n", Kind.UINT64, False), ("s", Kind.FLOAT64, True)]


def _blocks(seed: int, sizes):
    """Partial-agg-shaped blocks (a nullable group key, a float key, a
    count, a nullable sum) for both packages."""
    rng = np.random.default_rng(seed)
    jschema = JSchema([JColumn(n, JDType(JKind[k.name], nul))
                       for n, k, nul in _COLS])
    pschema = Schema([Column(n, DType(k, nul)) for n, k, nul in _COLS])
    out = []
    for cap, length in sizes:
        arrays = {"g": rng.integers(0, 40, cap).astype(np.int64),
                  "f": rng.choice(FLOATS, cap),
                  "n": rng.integers(1, 1 << 20, cap).astype(np.uint64),
                  "s": rng.random(cap) * 100}
        valids = {"g": rng.random(cap) > 0.2, "s": rng.random(cap) > 0.1}
        jb = jdev.DeviceBlock(jschema,
                              {k: jnp.asarray(v) for k, v in arrays.items()},
                              {k: jnp.asarray(v) for k, v in valids.items()},
                              jnp.int32(length), cap, {})
        pb = DeviceBlock(pschema,
                         {k: torch.from_numpy(v.view(np.int64)
                                              if v.dtype == np.uint64 else v)
                          for k, v in arrays.items()},
                         _t(valids), torch.tensor(length, dtype=torch.int32),
                         cap, {})
        out.append((jb, pb))
    return jschema, pschema, out


@pytest.mark.parametrize("nparts", [1, 4, 32])
@pytest.mark.parametrize("keys", [("g",), ("g", "f")])
def test_partition_store_matches_reference(keys, nparts):
    jschema, pschema, blocks = _blocks(nparts, [(2048, 1500), (1024, 1024),
                                                (512, 0), (4096, 4000)])
    js = RS.PartitionStore(jschema, list(keys), nparts)
    ps = PS.PartitionStore(pschema, list(keys), nparts)
    for jb, pb in blocks:
        js.feed(jb)
        ps.feed(pb)
    assert (ps.spilled_rows, ps.spilled_bytes) == \
        (js.spilled_rows, js.spilled_bytes)
    for p in range(nparts):
        want, got = js.partition(p), ps.partition(p)
        assert got.length == want.length
        for n, _k, _nul in _COLS:
            w, g = want.columns[n], got.columns[n]
            assert g.data.dtype == w.data.dtype, n
            np.testing.assert_array_equal(g.data.view(np.uint8),
                                          w.data.view(np.uint8), err_msg=n)
            assert (g.valid is None) == (w.valid is None), n
            if w.valid is not None:
                np.testing.assert_array_equal(g.valid, w.valid, err_msg=n)


@pytest.mark.parametrize("sort,limit,offset", [
    ([("name", True, False), ("v", False, False)], None, None),
    ([("v", True, True)], 7, 3),
    ([("name", False, True), ("k", True, False)], 10, None),
    ([], 5, 2),
])
def test_host_sort_limit_matches_reference(sort, limit, offset):
    rng = np.random.default_rng(len(sort) * 10 + (limit or 0))
    n = 60
    names = np.array(["pear", "apple", "fig", "kiwi", "date"])
    d = Dictionary()
    codes = d.encode(names[rng.integers(0, 5, n)])
    v = np.round(rng.random(n) * 4) / 2
    k = rng.integers(-3, 3, n).astype(np.int64)
    valids = {"v": rng.random(n) > 0.2, "name": rng.random(n) > 0.1}
    kinds = {"name": Kind.STRING, "v": Kind.FLOAT64, "k": Kind.INT64}
    arrays = {"name": codes, "v": v, "k": k}
    pblock = HostBlock.from_arrays(
        Schema([Column(c, DType(kinds[c], True)) for c in arrays]), arrays,
        valids, {"name": d})
    jblock = JHostBlock.from_arrays(
        JSchema([JColumn(c, JDType(JKind[kinds[c].name], True))
                 for c in arrays]), arrays, valids, {"name": d})
    want = RS.host_sort_limit(jblock, [JSortKey(*s) for s in sort], limit,
                              offset, {"name": d})
    got = PS.host_sort_limit(pblock, [SortKey(*s) for s in sort], limit,
                             offset, {"name": d})
    assert got.length == want.length
    for c in arrays:
        np.testing.assert_array_equal(got.columns[c].data,
                                      want.columns[c].data, err_msg=c)
        np.testing.assert_array_equal(got.columns[c].valid,
                                      want.columns[c].valid, err_msg=c)
