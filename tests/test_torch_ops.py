"""The port's kernel-holding modules against their JAX counterparts.

Inputs are made with numpy from a seed and handed to both packages: the
reference runs on the CPU as its own tests run it, the port with
``device="cpu"`` (its kernels' plain versions). Integers, bools, null
masks, counts and permutations must match exactly; float sums to rtol
1e-9 (the kernels sum in another order than XLA).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ydb_tpu.core import dtypes as jdt
from ydb_tpu.core.block import HostBlock as JBlock
from ydb_tpu.core.schema import Column as JColumn, Schema as JSchema
from ydb_tpu.ops import fused as jfused, ir as jir, join as jjoin
from ydb_tpu.ops import sort as jsort, xla_exec

from ydb_tpu_torch.core import dtypes as pdt
from ydb_tpu_torch.core.block import HostBlock as PBlock
from ydb_tpu_torch.core.schema import Column as PColumn, Schema as PSchema
from ydb_tpu_torch.ops import fused as pfused, ir as pir, join as pjoin
from ydb_tpu_torch.ops import sort as psort, torch_exec
from ydb_tpu_torch.ops.cuda import bindings
from tests import torch_threads  # noqa: F401,E402

CPU = torch.device("cpu")
RTOL = 1e-9          # float sums: another summation order than XLA's


def _blocks(spec, arrays, valids):
    """The same columns as a reference and a port HostBlock."""
    jb = JBlock.from_arrays(
        JSchema([JColumn(n, jdt.DType(jdt.Kind(k), nl)) for n, k, nl in spec]),
        arrays, valids)
    pb = PBlock.from_arrays(
        PSchema([PColumn(n, pdt.DType(pdt.Kind(k), nl)) for n, k, nl in spec]),
        arrays, valids)
    return jb, pb


def _data(rng, n=3000):
    spec = [("a", "int64", True), ("b", "float64", True),
            ("c", "int32", False), ("k", "int32", True),
            ("j", "int32", False), ("kk", "int64", False),
            ("d", "date32", False)]
    k = rng.integers(0, 7, n).astype(np.int32)
    arrays = {
        "a": rng.integers(-1000, 1000, n),
        "b": rng.normal(size=n) * 100,
        "c": rng.integers(0, 50, n).astype(np.int32),
        "k": k,
        "j": rng.integers(0, 3, n).astype(np.int32),
        "kk": k.astype(np.int64) * 10,
        "d": rng.integers(8000, 12000, n).astype(np.int32),
    }
    valids = {"a": rng.random(n) > 0.05, "b": rng.random(n) > 0.1,
              "k": rng.random(n) > 0.1}
    # a bucket whose b values are all NULL: min/max/sum must follow
    # the reference's any_valid rule there
    valids["b"][arrays["k"] == 6] = False
    return spec, arrays, valids


def _assert_same_block(got: PBlock, want: JBlock):
    assert list(got.schema.names) == list(want.schema.names)
    assert got.length == want.length
    for name in want.schema.names:
        g, w = got.columns[name], want.columns[name]
        gv = np.ones(got.length, bool) if g.valid is None else g.valid
        wv = np.ones(want.length, bool) if w.valid is None else w.valid
        np.testing.assert_array_equal(gv, wv, err_msg=f"{name} validity")
        assert g.data.dtype == w.data.dtype, name
        if np.issubdtype(w.data.dtype, np.floating):
            np.testing.assert_allclose(g.data[wv], w.data[wv], rtol=RTOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.data[wv], w.data[wv],
                                          err_msg=name)


def _aggs(ir):
    A = ir.Agg
    return [A("n", "count_all"), A("na", "count", "a"), A("sa", "sum", "a"),
            A("sb", "sum", "b"), A("sc", "sum", "c"), A("mina", "min", "a"),
            A("maxa", "max", "a"), A("minb", "min", "b"),
            A("maxb", "max", "b"), A("mind", "min", "d"),
            A("someb", "some", "b"), A("nb", "count", "b")]


GROUPINGS = {
    "keyless": dict(keys=[], key_domains=()),
    "one_key": dict(keys=["k"], key_domains=(7,)),
    "two_keys": dict(keys=["k", "c"], key_domains=(7, 50)),
    "carry": dict(keys=["k"], key_domains=(7,), carry_keys=("kk",)),
    # 601 × 4 buckets: the medium-domain lane (K4)
    "medium": dict(keys=["c", "j"], key_domains=(600, 3)),
    "medium_carry": dict(keys=["c", "k"], key_domains=(600, 7),
                         carry_keys=("kk",)),
    # no domains: the sorted lane (K5)
    "sorted": dict(keys=["k", "c"]),
    "sorted_carry_bound": dict(keys=["k"], carry_keys=("kk",),
                               out_bound=8),
}


def _program(ir, dt, grouping, filtered):
    p = ir.Program()
    if filtered:
        p = p.filter(ir.call("gt", ir.Col("d"), ir.Const(9000, dt.DATE32)))
    return p.group_by(aggs=_aggs(ir), **GROUPINGS[grouping])


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("grouping", list(GROUPINGS))
def test_run_program_groupby(grouping, filtered):
    rng = np.random.default_rng(7)
    spec, arrays, valids = _data(rng)
    jb, pb = _blocks(spec, arrays, valids)
    want = xla_exec.run_program(_program(jir, jdt, grouping, filtered), jb)
    got = torch_exec.run_program(_program(pir, pdt, grouping, filtered), pb,
                                 device="cpu")
    _assert_same_block(got, want)


# --------------------------------------------------------------------------
# hashing (K12)
# --------------------------------------------------------------------------


def _hash_inputs(rng, n=4096):
    a = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    b = rng.integers(0, 1 << 20, n).astype(np.int32)
    return a, b


def test_hash64_equals_the_numpy_branch_bit_for_bit():
    from ydb_tpu_torch.ops.torch_ns import TXP
    from ydb_tpu_torch.utils import hashing as ph
    from ydb_tpu.utils import hashing as jh
    rng = np.random.default_rng(9)
    a, b = _hash_inputs(rng)
    ha, hb = jh.splitmix64(np, a), jh.splitmix64(np, b)
    want = jh.hash_combine(np, ha, hb)
    assert (want >= 1 << 63).mean() > 0.4          # the top bit is used
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got_a = ph.splitmix64(TXP, ta)
    np.testing.assert_array_equal(_np(got_a).view(np.uint64), ha)
    got = ph.hash_combine(TXP, got_a, ph.splitmix64(TXP, tb))
    np.testing.assert_array_equal(_np(got).view(np.uint64), want)
    # the fused form: hash_combine(f(a), f(b)) in one launch
    np.testing.assert_array_equal(
        _np(bindings.hash64([ta, tb])).view(np.uint64), want)
    # three columns, the last already a hash
    want3 = jh.hash_combine(np, want, ha)
    got3 = bindings.hash64([ta, tb, torch.from_numpy(ha.view(np.int64))],
                           pre=[True, True, False])
    np.testing.assert_array_equal(_np(got3).view(np.uint64), want3)


def test_hashed_composite_key_matches_the_reference():
    """`hash_combine(hash64(a), hash64(b))` as a program assign (the
    fused hash64 launch) against the reference's device hashing; NULL
    where either column is NULL."""
    rng = np.random.default_rng(10)
    a, b = _hash_inputs(rng, 3000)
    spec = [("a", "int64", True), ("b", "int32", False)]
    arrays = {"a": a, "b": b}
    valids = {"a": rng.random(3000) > 0.1}
    jb, pb = _blocks(spec, arrays, valids)

    def prog(ir):
        return ir.Program().assign("h", ir.call(
            "hash_combine", ir.call("hash64", ir.Col("a")),
            ir.call("hash64", ir.Col("b")))).assign(
            "h1", ir.call("hash64", ir.Col("b"))).project(["h", "h1"])
    want = xla_exec.run_program(prog(jir), jb)
    got = torch_exec.run_program(prog(pir), pb, device="cpu")
    _assert_same_block(got, want)


# --------------------------------------------------------------------------
# compaction
# --------------------------------------------------------------------------


def _env(rng, cap):
    cols = {
        "f": rng.normal(size=cap),
        "i": rng.integers(-5, 5, cap).astype(np.int32),
        "l": rng.integers(0, 1 << 40, cap),
        "t": rng.random(cap) > 0.5,
    }
    valid = {"f": rng.random(cap) > 0.2, "i": None, "l": rng.random(cap) > 0.5,
             "t": None}
    jenv = {n: (jnp.asarray(cols[n]),
                None if valid[n] is None else jnp.asarray(valid[n]))
            for n in cols}
    penv = {n: (torch.from_numpy(cols[n].copy()),
                None if valid[n] is None else torch.from_numpy(valid[n].copy()))
            for n in cols}
    return jenv, penv


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("with_sel", [False, True])
def test_compress_live_prefix(with_sel):
    rng = np.random.default_rng(3)
    cap, length = 4096, 3000
    jenv, penv = _env(rng, cap)
    sel = rng.random(cap) > 0.6 if with_sel else None
    jout, jlen = xla_exec.compress(jenv, jnp.int32(length),
                                   None if sel is None else jnp.asarray(sel),
                                   cap)
    pout, plen = torch_exec.compress(
        penv, torch.tensor(length, dtype=torch.int32),
        None if sel is None else torch.from_numpy(sel), cap, CPU)
    n = int(jlen)
    assert int(plen) == n
    # the reference's compress also orders the dropped rows after the
    # live ones; the port defines only the live prefix [0, n)
    for name in jout:
        np.testing.assert_array_equal(_np(pout[name][0])[:n],
                                      _np(jout[name][0])[:n])
        if jout[name][1] is not None:
            np.testing.assert_array_equal(_np(pout[name][1])[:n],
                                          _np(jout[name][1])[:n])


@pytest.mark.parametrize("new_cap", [2048, 512])       # 512 overflows
def test_compact_env(new_cap):
    rng = np.random.default_rng(4)
    cap, length = 4096, 3500
    jenv, penv = _env(rng, cap)
    sel = rng.random(cap) > 0.7
    j = xla_exec.compact_env(jenv, jnp.int32(length), jnp.asarray(sel), cap,
                             new_cap)
    p = torch_exec.compact_env(penv, torch.tensor(length, dtype=torch.int32),
                               torch.from_numpy(sel), cap, new_cap, CPU)
    jenv2, jlen, jsel, jlive, jovf = j
    penv2, plen, psel, plive, povf = p
    assert int(plen) == int(jlen) and int(plive) == int(jlive)
    assert bool(povf) == bool(jovf) == (int(jlive) > new_cap)
    np.testing.assert_array_equal(_np(psel), _np(jsel))
    for name in jenv2:     # compact_env zero-fills the tail: whole buffers
        np.testing.assert_array_equal(_np(penv2[name][0]),
                                      _np(jenv2[name][0]))
        if jenv2[name][1] is not None:
            np.testing.assert_array_equal(_np(penv2[name][1]),
                                          _np(jenv2[name][1]))


# --------------------------------------------------------------------------
# join probe
# --------------------------------------------------------------------------


def _build_block(ir_pkg_block, kind, rng, keys):
    n = len(keys)
    spec = [("bk", kind, False), ("pi", "int64", True),
            ("pf", "float64", False)]
    arrays = {"bk": keys, "pi": rng.integers(0, 100, n),
              "pf": rng.normal(size=n)}
    valids = {"pi": rng.random(n) > 0.3}
    return _blocks(spec, arrays, valids)


BUILDS = {
    "lut": ("int64", lambda rng: rng.permutation(np.arange(100, 400))),
    "sparse": ("int64", lambda rng: rng.choice(1 << 40, 300, replace=False)),
    "float": ("float64", lambda rng: rng.permutation(
        np.arange(300) * 0.5 - 20.0)),
}


def _probe_keys(rng, build_keys, n, floating):
    hit = rng.choice(build_keys, n)
    miss = (rng.normal(size=n) * 1e3) if floating \
        else rng.integers(-500, 2000, n)
    keys = np.where(rng.random(n) > 0.3, hit, miss)
    return keys.astype(np.float64 if floating else np.int64)


@pytest.mark.parametrize("late", [False, True])
@pytest.mark.parametrize("kind,not_in,has_null", [
    ("inner", False, False), ("left", False, False),
    ("left_semi", False, False), ("left_anti", False, False),
    ("left_anti", True, False), ("left_anti", True, True),
    ("mark", False, False)])
@pytest.mark.parametrize("build_kind", list(BUILDS))
def test_probe_lut_traced(build_kind, kind, not_in, has_null, late):
    rng = np.random.default_rng(11)
    kdt, make = BUILDS[build_kind]
    bkeys = make(rng)
    jb, pb = _build_block(None, kdt, rng, bkeys)
    jbt = jjoin.build(jb, "bk", ["pi", "pf"])
    pbt = pjoin.build(pb, "bk", ["pi", "pf"], CPU)
    assert (jbt.lut is None) == (pbt.lut is None) == (build_kind != "lut")
    jbt.anti_has_null = pbt.anti_has_null = has_null
    n = 2048
    pk = _probe_keys(rng, bkeys, n, kdt == "float64")
    pv = rng.random(n) > 0.1
    sel = rng.random(n) > 0.2
    meta = {"probe_key": "x", "kind": kind, "src_names": ("pi", "pf"),
            "payload_names": ("pi", "pf"), "mark_col": "m",
            "not_in": not_in, "bsearch": jbt.lut is None, "late": late,
            "row_col": "__lmr0", "found_col": "__lmf0"}
    jenv, jsel = jjoin.probe_lut_traced(
        {"x": (jnp.asarray(pk), jnp.asarray(pv))}, jnp.asarray(sel),
        jfused.build_traced_inputs(jbt), meta)
    penv, psel = pjoin.probe_lut_traced(
        {"x": (torch.from_numpy(pk), torch.from_numpy(pv))},
        torch.from_numpy(sel), pfused.build_traced_inputs(pbt), meta)
    np.testing.assert_array_equal(_np(psel), _np(jsel))
    assert set(penv) == set(jenv)
    for name in jenv:
        jd, jv = jenv[name]
        pd_, pv_ = penv[name]
        np.testing.assert_array_equal(_np(pd_), _np(jd), err_msg=name)
        assert (jv is None) == (pv_ is None), name
        if jv is not None:
            np.testing.assert_array_equal(_np(pv_), _np(jv), err_msg=name)


@pytest.mark.parametrize("late", [False, True])
@pytest.mark.parametrize("kind", ["inner", "left_semi", "left_anti"])
def test_probe_u64_keys_past_two_to_the_63(kind, late):
    """Composite-key hashes are uint64, about half of them >= 2^63. The
    build sorts their int64 bits and the probe searches the same bits
    (the reference's order too): every key of the build is found, and
    the row ids equal the reference's."""
    rng = np.random.default_rng(12)
    bkeys = rng.integers(0, 2 ** 64 - 1, 500, dtype=np.uint64)
    assert (bkeys >= 2 ** 63).sum() > 100
    spec = [("bk", "uint64", False), ("pi", "int64", False)]
    jb, pb = _blocks(spec, {"bk": bkeys, "pi": np.arange(500)}, {})
    jbt = jjoin.build(jb, "bk", ["pi"])
    pbt = pjoin.build(pb, "bk", ["pi"], CPU)
    assert jbt.lut is None and pbt.lut is None
    n = 2048
    hit = rng.random(n) > 0.3
    pk = np.where(hit, bkeys[rng.integers(0, 500, n)],
                  rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64))
    meta = {"probe_key": "x", "kind": kind, "src_names": ("pi",),
            "payload_names": ("pi",), "mark_col": None, "not_in": False,
            "bsearch": True, "late": late, "row_col": "__lmr0",
            "found_col": "__lmf0"}
    sel = np.ones(n, bool)
    jenv, jsel = jjoin.probe_lut_traced(
        {"x": (jnp.asarray(pk), None)}, jnp.asarray(sel),
        jfused.build_traced_inputs(jbt), meta)
    penv, psel = pjoin.probe_lut_traced(
        {"x": (torch.from_numpy(pk.view(np.int64)), None)},
        torch.from_numpy(sel), pfused.build_traced_inputs(pbt), meta)
    found = np.isin(pk, bkeys)
    np.testing.assert_array_equal(_np(psel),
                                  ~found if kind == "left_anti" else found)
    np.testing.assert_array_equal(_np(psel), _np(jsel))
    for name in jenv:
        if name == "x":
            continue
        np.testing.assert_array_equal(_np(penv[name][0]),
                                      _np(jenv[name][0]), err_msg=name)


def test_probe_float_key_never_takes_the_lut():
    rng = np.random.default_rng(2)
    _jb, pb = _build_block(None, "int64", rng, np.arange(10, 50))
    pbt = pjoin.build(pb, "bk", ["pi"], CPU)
    meta = {"probe_key": "x", "kind": "inner", "src_names": ("pi",),
            "payload_names": ("pi",), "mark_col": None, "not_in": False,
            "bsearch": False, "late": False, "row_col": "r",
            "found_col": "f"}
    with pytest.raises(TypeError):
        pjoin.probe_lut_traced(
            {"x": (torch.tensor([10.5, 11.0], dtype=torch.float64), None)},
            torch.ones(2, dtype=torch.bool), pfused.build_traced_inputs(pbt),
            meta)


# --------------------------------------------------------------------------
# sort
# --------------------------------------------------------------------------


def _sort_inputs(rng, cap):
    special = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5,
                        -1.5])
    f = np.where(rng.random(cap) > 0.5, rng.choice(special, cap),
                 rng.integers(-3, 3, cap).astype(np.float64))
    i = rng.integers(-3, 3, cap).astype(np.int32)
    u = rng.integers(0, 4, cap).astype(np.int64)
    fv = rng.random(cap) > 0.2
    iv = rng.random(cap) > 0.2
    return {"f": f, "i": i, "u": u}, {"f": fv, "i": iv}


@pytest.mark.parametrize("keys", [
    (("f", True, False),), (("f", False, False),), (("f", True, True),),
    (("f", False, True),), (("i", False, False), ("f", True, True)),
    (("u", True, False), ("i", True, True), ("f", False, False)),
])
def test_sort_env(keys):
    rng = np.random.default_rng(5)
    cap, length = 512, 470
    arrays, valids = _sort_inputs(rng, cap)
    names = ("f", "i", "u")
    ja, jv, jl = jsort.sort_env(
        {n: jnp.asarray(a) for n, a in arrays.items()},
        {n: jnp.asarray(v) for n, v in valids.items()}, jnp.int32(length),
        None, keys, names)
    pa, pv, pl = psort.sort_env(
        {n: torch.from_numpy(a.copy()) for n, a in arrays.items()},
        {n: torch.from_numpy(v.copy()) for n, v in valids.items()},
        torch.tensor(length, dtype=torch.int32), None, keys, names)
    assert int(pl) == int(jl)
    for n in names:
        # the permutation is exact: float columns compare bit for bit
        np.testing.assert_array_equal(_np(pa[n]).view(np.uint8),
                                      np.asarray(ja[n]).view(np.uint8),
                                      err_msg=n)
    for n in valids:
        np.testing.assert_array_equal(_np(pv[n]), _np(jv[n]), err_msg=n)


def test_sort_perm_plain_orders_unsigned_keys():
    k = torch.tensor([-1, 0, 5, -(1 << 63)], dtype=torch.int64)   # u64 bits
    perm = bindings.sort_perm([k], 4, CPU)
    assert perm.tolist() == [1, 2, 3, 0]
