"""The expanding join probe (K8), the window scans (K13) and the portioned
path of the port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages: the
reference runs on the CPU as its own tests run it, the port with
``device="cpu"`` (its kernels' plain versions). Integers, bools, null
masks and row order must match exactly; float sums to rtol 1e-9.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from ydb_tpu.core import dtypes as jdt
from ydb_tpu.core.block import HostBlock as JBlock
from ydb_tpu.core.schema import Column as JColumn, Schema as JSchema
from ydb_tpu.ops import device as jdevice, join as jjoin
from ydb_tpu.ops import window_dev as jwin
from ydb_tpu.query import QueryEngine as JEngine
from ydb_tpu.storage.mvcc import WriteVersion as JWriteVersion

from ydb_tpu_torch.core import dtypes as pdt
from ydb_tpu_torch.core.block import HostBlock as PBlock
from ydb_tpu_torch.core.schema import Column as PColumn, Schema as PSchema
from ydb_tpu_torch.ops import device as pdevice, join as pjoin
from ydb_tpu_torch.ops.cuda import bindings
from ydb_tpu_torch.ops.sort import encode_key
from ydb_tpu_torch.query import QueryEngine as PEngine
from ydb_tpu_torch.storage.mvcc import WriteVersion as PWriteVersion

from tests.tpch_util import assert_frames_match
from tests import torch_threads  # noqa: F401,E402

CPU = torch.device("cpu")
RTOL = 1e-9


def _blocks(spec, arrays, valids):
    jb = JBlock.from_arrays(
        JSchema([JColumn(n, jdt.DType(jdt.Kind(k), nl)) for n, k, nl in spec]),
        arrays, valids)
    pb = PBlock.from_arrays(
        PSchema([PColumn(n, pdt.DType(pdt.Kind(k), nl)) for n, k, nl in spec]),
        arrays, valids)
    return jb, pb


def _assert_blocks_equal(jb, pb):
    """Same schema, row count, null masks, and values where valid."""
    assert list(jb.schema.names) == list(pb.schema.names)
    assert jb.length == pb.length
    for name in jb.schema.names:
        jc, pc = jb.columns[name], pb.columns[name]
        jv = np.ones(jb.length, bool) if jc.valid is None else jc.valid
        pv = np.ones(pb.length, bool) if pc.valid is None else pc.valid
        np.testing.assert_array_equal(jv, pv, err_msg=f"{name} valid")
        jd, pd_ = np.asarray(jc.data)[jv], np.asarray(pc.data)[pv]
        if np.issubdtype(jd.dtype, np.floating):
            np.testing.assert_allclose(pd_, jd, rtol=RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(pd_, jd, err_msg=name)


def _expand_case(kind, rng, n_probe, build_keys, probe_keys, probe_valid,
                 length=None):
    nb = len(build_keys)
    bspec = [("bk", "int64", False), ("p1", "int64", True),
             ("p2", "float64", False)]
    jbb, pbb = _blocks(bspec, {"bk": build_keys,
                               "p1": rng.integers(0, 1 << 40, nb),
                               "p2": rng.normal(size=nb)},
                       {"p1": rng.random(nb) > 0.2})
    pspec = [("k", "int64", True), ("x", "int32", False),
             ("y", "float64", True)]
    jpb, ppb = _blocks(pspec, {"k": probe_keys,
                               "x": rng.integers(0, 99, n_probe)
                               .astype(np.int32),
                               "y": rng.normal(size=n_probe)},
                       {"k": probe_valid, "y": rng.random(n_probe) > 0.1})
    jbt = jjoin.build(jbb, "bk", ["p1", "p2"])
    pbt = pjoin.build(pbb, "bk", ["p1", "p2"], CPU)
    assert not jbt.unique and not pbt.unique
    jd = jdevice.to_device(jpb)
    pd_ = pdevice.to_device(ppb, CPU)
    if length is not None:
        jd.length = jnp.int32(length)
        pd_.length = torch.tensor(length, dtype=torch.int32)
    jout = jjoin.probe_expand(jd, jbt, "k", kind)
    pout = pjoin.probe_expand(pd_, pbt, "k", kind)
    assert jout.capacity == pout.capacity
    _assert_blocks_equal(jdevice.to_host(jout), pdevice.to_host(pout))
    return pdevice.to_host(pout)


@pytest.mark.parametrize("kind", ["inner", "left"])
@pytest.mark.parametrize("shape", ["duplicates", "skew", "null_keys",
                                   "zero_rows", "no_match"])
def test_probe_expand_matches_reference(kind, shape):
    rng = np.random.default_rng(11)
    n = 3000
    keys = rng.integers(0, 400, n)
    valid = rng.random(n) > 0.1 if shape == "null_keys" else None
    length = None
    if shape == "duplicates":
        build = rng.integers(0, 300, 900)
    elif shape == "skew":
        # one key matching 2,000 build rows, the rest 0 to 3
        build = np.concatenate([np.full(2000, 7),
                                np.repeat(np.arange(100, 400),
                                          rng.integers(0, 4, 300))])
    elif shape == "null_keys":
        build = rng.integers(0, 300, 900)
    elif shape == "zero_rows":
        build = rng.integers(0, 300, 900)
        length = 0
    else:
        build = rng.integers(1000, 1300, 900)
    out = _expand_case(kind, rng, n, build, keys, valid, length)
    if shape == "zero_rows":
        assert out.length == 0
    if shape == "no_match" and kind == "inner":
        assert out.length == 0


def test_expand_kernels_plain_agree_with_reference_arithmetic():
    """The plain versions of expand_counts / expand_gather against the
    reference's _expand_counts / _expand_gather on the same inputs."""
    rng = np.random.default_rng(3)
    n, nb = 4096, 700
    build = np.sort(rng.integers(0, 200, nb))
    kcap = 1024
    keys = np.concatenate([build, np.full(kcap - nb, np.iinfo(np.int64).max)])
    probe = rng.integers(-5, 220, n)
    valid = rng.random(n) > 0.1
    for left in (False, True):
        jlo, jm, _jc, joff, jtot = jjoin._expand_counts(
            {"k": jnp.asarray(probe)}, {"k": jnp.asarray(valid)},
            jnp.int32(n - 100), jnp.int32(nb), jnp.asarray(keys), "k", left)
        lo, m, off, tot = bindings.expand_counts_plain(
            torch.from_numpy(probe), torch.from_numpy(valid), n - 100,
            torch.from_numpy(keys), nb, left)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
        assert int(tot) == int(jtot)
        pay = rng.integers(0, 1 << 30, kcap)
        pv = rng.random(kcap) > 0.3
        out_cap = 1 << max(int(tot) - 1, 0).bit_length()
        ja, jv = jjoin._expand_gather(
            {"x": jnp.asarray(probe)}, {}, jlo, jm, joff, jtot,
            {"p": jnp.asarray(pay)}, {"p": jnp.asarray(pv)}, "inner",
            ("p",), max(out_cap, 128))
        got = bindings.expand_gather_plain(
            lo, m, off, tot, max(out_cap, 128), kcap,
            [(torch.from_numpy(probe), "probe"),
             (torch.from_numpy(pay), "build"),
             (torch.from_numpy(pv), "build_valid")])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ja["x"]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ja["p"]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(jv["p"]))


@pytest.mark.parametrize("nparts", [1, 37, 2000])
def test_window_scan_plain_matches_reference_helpers(nparts):
    """window_scan_plain's starts, ends, dense counts, prefix sums and
    running min/max against the reference's _seg_starts, _seg_ends,
    _prefix and _segmented_scan_minmax over the same sorted frame."""
    rng = np.random.default_rng(nparts)
    n = 2000
    part = np.sort(rng.integers(0, nparts, n))
    order = rng.integers(0, 30, n)
    o = np.lexsort((order, part))
    part, order = part[o], order[o]
    v = np.round(rng.normal(size=n) * 100, 2)
    vi = rng.integers(-1000, 1000, n)
    valid = rng.random(n) > 0.15
    perm = torch.arange(n, dtype=torch.int32)
    pw = [encode_key(torch.from_numpy(part))]
    ow = [encode_key(torch.from_numpy(order))]
    aggs = [("sum", torch.from_numpy(v), torch.from_numpy(valid)),
            ("sum", torch.from_numpy(vi), None),
            ("min", torch.from_numpy(v), torch.from_numpy(valid)),
            ("max", torch.from_numpy(vi), torch.from_numpy(valid))]
    seg_start, seg_end, grp_start, dense, scans = \
        bindings.window_scan_plain(perm, pw, ow, aggs)

    iota = jnp.arange(n)
    b_part = jnp.asarray(np.concatenate([[True], part[1:] != part[:-1]]))
    b_order = b_part | jnp.asarray(
        np.concatenate([[True], order[1:] != order[:-1]]))
    jstart = np.asarray(jwin._seg_starts(b_part, iota))
    jend = np.asarray(jwin._seg_ends(b_part, iota, n))
    np.testing.assert_array_equal(seg_start.numpy(), jstart)
    np.testing.assert_array_equal(seg_end.numpy(), jend)
    np.testing.assert_array_equal(
        grp_start.numpy(), np.asarray(jwin._seg_starts(b_order, iota)))
    corder = np.cumsum(np.asarray(b_order).astype(np.int64))
    np.testing.assert_array_equal(dense.numpy(),
                                  corder - corder[jstart] + 1)
    # prefix sums: the in-partition inclusive prefix equals the
    # reference's whole-frame prefix difference (_prefix) to rtol
    for (val, cnt), (_op, d, vv) in zip(scans[:2], aggs[:2]):
        ok = np.ones(n, bool) if vv is None else vv.numpy()
        filled = np.where(ok, d.numpy(), 0)
        cs = np.asarray(jwin._prefix(jnp.asarray(filled)))
        cn = np.asarray(jwin._prefix(jnp.asarray(ok.astype(np.int64))))
        np.testing.assert_allclose(val.numpy(), cs[iota + 1] - cs[jstart],
                                   rtol=RTOL, atol=1e-9)
        np.testing.assert_array_equal(cnt.numpy(), cn[iota + 1] - cn[jstart])
    for (val, _cnt), (op, d, vv) in zip(scans[2:], aggs[2:]):
        ident = (np.inf if op == "min" else -np.inf) \
            if d.dtype == torch.float64 else \
            (np.iinfo(np.int64).max if op == "min" else np.iinfo(np.int64).min)
        vm = np.where(vv.numpy(), d.numpy(), ident)
        want = jwin._segmented_scan_minmax(jnp.asarray(vm), b_part,
                                           op == "min")
        np.testing.assert_array_equal(val.numpy(), np.asarray(want))


# -- the portioned path, through both engines ------------------------------


def _engines():
    j = JEngine(block_rows=1 << 12)
    p = PEngine(device="cpu", block_rows=1 << 12)
    return j, p


def _load(engs, name, df, pk, nullable=(), portion_rows=1 << 10):
    for e, dtm, C, S, WV in ((engs[0], jdt, JColumn, JSchema, JWriteVersion),
                             (engs[1], pdt, PColumn, PSchema,
                              PWriteVersion)):
        cols = [C(c, dtm.DType(dtm.Kind.FLOAT64 if df[c].dtype.kind == "f"
                               else dtm.Kind.INT64, c in nullable))
                for c in df.columns]
        t = e.catalog.create_table(name, S(cols), [pk], shards=2,
                                   portion_rows=portion_rows)
        if len(df):
            t.bulk_upsert(df, WV(1, 1))


def _both(engs, sql, path):
    want = engs[0].query(sql)
    assert engs[0].executor.last_path == path
    got = engs[1].query(sql)
    assert engs[1].executor.last_path == path
    assert_frames_match(got, want, ordered=True)
    return got


def test_portioned_empty_scan_global_aggregate():
    engs = _engines()
    _load(engs, "empty_t", pd.DataFrame({"id": np.zeros(0, np.int64),
                                         "v": np.zeros(0)}), "id")
    got = _both(engs, "select count(*) as c, sum(v) as s, min(id) as m "
                "from empty_t", "portioned")
    assert len(got) == 1 and got["c"][0] == 0
    got = _both(engs, "select id, count(*) as c from empty_t group by id "
                "order by id", "portioned")
    assert len(got) == 0


def test_portioned_joins_above_fuse_cap():
    engs = _engines()
    rng = np.random.default_rng(5)
    n = 6000
    fact = {"id": np.arange(n)}
    for d in range(8):
        fact[f"k{d}"] = rng.integers(0, 50, n)
        _load(engs, f"dim{d}",
              pd.DataFrame({f"d{d}_id": np.arange(50),
                            f"d{d}_w": rng.integers(0, 5, 50)}), f"d{d}_id")
    fact["v"] = np.round(rng.normal(size=n) * 10, 2)
    _load(engs, "fact", pd.DataFrame(fact), "id")
    joins = " ".join(f"join dim{d} on k{d} = d{d}_id" for d in range(8))
    got = _both(engs, f"select d0_w, count(*) as c, sum(v) as s from fact "
                f"{joins} where d3_w > 0 group by d0_w order by d0_w",
                "portioned")
    assert len(got) == 5


def test_portioned_duplicate_key_join_with_left_join():
    """Build sides with duplicate keys (inner and LEFT) take the
    expanding probe on the portioned path in both engines."""
    engs = _engines()
    rng = np.random.default_rng(9)
    n = 5000
    _load(engs, "orders_f", pd.DataFrame({
        "oid": np.arange(n), "cust": rng.integers(0, 400, n),
        "amt": np.round(rng.normal(size=n) * 50, 2)}), "oid")
    m = 1200
    _load(engs, "visits", pd.DataFrame({
        "vid": np.arange(m), "vcust": rng.integers(0, 300, m),
        "pages": rng.integers(1, 9, m)}), "vid")
    for kind in ("join", "left join"):
        got = _both(engs, f"select cust, count(*) as c, sum(pages) as p, "
                    f"sum(amt) as a from orders_f {kind} visits "
                    f"on cust = vcust group by cust order by cust",
                    "portioned")
        assert len(got) > 0
