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


def test_run_program_medium_domain_is_not_ported():
    from ydb_tpu_torch.errors import NotPorted
    rng = np.random.default_rng(1)
    spec, arrays, valids = _data(rng, 100)
    _jb, pb = _blocks(spec, arrays, valids)
    p = pir.Program().group_by(["a", "c"], [pir.Agg("n", "count_all")],
                               key_domains=(1000, 50))
    with pytest.raises(NotPorted):
        torch_exec.run_program(p, pb, device="cpu")


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
