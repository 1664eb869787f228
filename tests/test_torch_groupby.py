"""The port's sorted (K5) and medium-domain (K4) group-by lanes against
the reference's.

The same seeded numpy blocks go through `ydb_tpu.ops.xla_exec.
run_program` and `ydb_tpu_torch.ops.torch_exec.run_program(device=
"cpu")`, which runs the `sort`, `bucket_perm` and `segment_agg`
kernels' plain versions. Without an ORDER BY the output order is the lane's own (key
order for the sorted lane, bucket order for the medium one), so rows are
compared in order: keys, counts, validity and integers exactly, floats
to rtol 1e-9 (segments are folded directly, the reference takes
cumulative-sum differences). The cases follow the hazards
`tests/test_groupby_tiled.py` pins for the reference's tiled lowering.
"""

import numpy as np
import pytest
import torch

from ydb_tpu.core import dtypes as jdt
from ydb_tpu.ops import ir as jir, xla_exec

from ydb_tpu_torch.core import dtypes as pdt
from ydb_tpu_torch.ops import ir as pir, torch_exec
from ydb_tpu_torch.ops.cuda import bindings

from tests.test_torch_ops import _assert_same_block, _blocks
from tests import torch_threads  # noqa: F401,E402

AGGS = [("cnt", "count_all", None), ("cv", "count", "v"), ("s", "sum", "v"),
        ("mn", "min", "v"), ("mx", "max", "v"), ("sm", "some", "v")]


def _aggs(ir, aggs=AGGS):
    return [ir.Agg(o, f, a) if a else ir.Agg(o, f) for o, f, a in aggs]


def _program(ir, dt, keys, filt=None, aggs=AGGS, **kw):
    p = ir.Program()
    if filt is not None:
        col, lo = filt
        p = p.filter(ir.call("gt", ir.Col(col), ir.Const(lo, dt.INT64)))
    return p.group_by(list(keys), _aggs(ir, aggs), **kw)


def _check(spec, arrays, valids, keys, filt=None, aggs=AGGS, **kw):
    jb, pb = _blocks(spec, arrays, valids)
    want = xla_exec.run_program(_program(jir, jdt, keys, filt, aggs, **kw),
                                jb)
    got = torch_exec.run_program(_program(pir, pdt, keys, filt, aggs, **kw),
                                 pb, device="cpu")
    _assert_same_block(got, want)
    return got


def _kv(k, v, kkind="int64", vvalid=None, kvalid=None):
    spec = [("k", kkind, kvalid is not None), ("v", "float64",
                                              vvalid is not None)]
    valids = {}
    if kvalid is not None:
        valids["k"] = kvalid
    if vvalid is not None:
        valids["v"] = vvalid
    return spec, {"k": k, "v": v}, valids


@pytest.fixture
def rng():
    return np.random.default_rng(20)


# --------------------------------------------------------------------------
# K5: the sorted lane
# --------------------------------------------------------------------------


def test_group_spans_tile_boundary(rng):
    # 16 groups of 500 rows: in sorted order nearly every group crosses a
    # 1024-row tile of the kernel
    n = 8000
    k = (np.arange(n, dtype=np.int64) // 500)[rng.permutation(n)]
    _check(*_kv(k, rng.normal(size=n) * 50, vvalid=rng.random(n) > 0.1),
           ["k"])


def test_all_rows_one_group(rng):
    n = 5000
    _check(*_kv(np.zeros(n, np.int64), rng.normal(size=n)), ["k"])


def test_mostly_empty_input(rng):
    # 40 of 5000 rows pass the filter: most of the scan is inactive
    n = 5000
    d = np.zeros(n, np.int64)
    d[rng.choice(n, 40, replace=False)] = 1
    spec, arrays, valids = _kv(rng.integers(0, 5, n), rng.normal(size=n))
    spec.append(("d", "int64", False))
    arrays["d"] = d
    _check(spec, arrays, valids, ["k"], filt=("d", 0))


def test_skewed_sizes(rng):
    # 90% of the rows in one group, the rest singletons
    n = 6000
    k = np.where(rng.random(n) < 0.9, 7, np.arange(n) + 100).astype(np.int64)
    _check(*_kv(k, rng.normal(size=n), vvalid=rng.random(n) > 0.2), ["k"])


def test_nullable_int_nan_and_signed_zero_float_keys(rng):
    n = 4000
    ki = rng.integers(-3, 3, n)
    kf = rng.choice([0.5, -1.25, np.nan, -np.nan, 2.0, 0.0, -0.0], n)
    spec = [("ki", "int64", True), ("kf", "float64", False),
            ("v", "float64", True)]
    arrays = {"ki": ki, "kf": kf, "v": rng.normal(size=n)}
    valids = {"ki": rng.random(n) > 0.2, "v": rng.random(n) > 0.15}
    got = _check(spec, arrays, valids, ["ki", "kf"])
    # NULL keys group together and sort first; NaN is one group, and
    # -0.0 and 0.0 are one group
    assert not got.columns["ki"].valid[0]
    kf_out = got.columns["kf"].data[got.columns["ki"].valid]
    assert np.isnan(kf_out).sum() == 6        # one NaN group per ki value
    assert (kf_out == 0).sum() == 6


def test_zero_rows():
    spec, arrays, valids = _kv(np.zeros(0, np.int64), np.zeros(0))
    got = _check(spec, arrays, valids, ["k"])
    assert got.length == 0


def test_filter_then_group(rng):
    n = 7000
    spec, arrays, valids = _kv(rng.integers(0, 300, n), rng.normal(size=n),
                               vvalid=rng.random(n) > 0.3)
    spec.append(("d", "int64", False))
    arrays["d"] = rng.integers(0, 100, n)
    _check(spec, arrays, valids, ["k"], filt=("d", 60))


def test_out_bound_sets_output_capacity(rng):
    n = 6000
    k = rng.integers(0, 90, n)
    _check(*_kv(k, rng.normal(size=n)), ["k"], out_bound=100)
    prog = _program(pir, pdt, ["k"], out_bound=100)
    _jb, pb = _blocks(*_kv(k, rng.normal(size=n)))
    from ydb_tpu_torch.ops.device import to_device
    out = torch_exec.run_on_device(prog, to_device(pb, torch.device("cpu")))
    assert out.capacity == 128


def test_carried_keys(rng):
    n = 5000
    k = rng.integers(0, 700, n)
    spec = [("k", "int64", False), ("kk", "int64", True),
            ("v", "float64", False)]
    arrays = {"k": k, "kk": k * 3 + 1, "v": rng.normal(size=n)}
    kv = (k % 5) != 0                # the carried key is NULL per group
    _check(spec, arrays, {"kk": kv}, ["k"], carry_keys=("kk",))


def test_integer_and_unsigned_values(rng):
    n = 5000
    spec = [("k", "int32", False), ("i", "int64", True),
            ("u", "uint64", False), ("h", "int32", False)]
    arrays = {"k": rng.integers(0, 800, n).astype(np.int32),
              "i": rng.integers(-(1 << 40), 1 << 40, n),
              "u": rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64),
              "h": rng.integers(-50, 50, n).astype(np.int32)}
    aggs = [("si", "sum", "i"), ("mni", "min", "i"), ("mxi", "max", "i"),
            ("mnu", "min", "u"), ("mxu", "max", "u"), ("su", "sum", "u"),
            ("mnh", "min", "h"), ("smh", "some", "h"), ("ci", "count", "i")]
    _check(spec, arrays, {"i": rng.random(n) > 0.1}, ["k"], aggs=aggs)


def test_unsigned_key_with_values_past_two_to_the_63(rng):
    # a hash-like u64 key: half its values are >= 2^63 and must order as
    # unsigned, as the reference's lax.sort orders uint64
    n = 3000
    base = rng.integers(0, 2 ** 64 - 1, 200, dtype=np.uint64)
    spec = [("k", "uint64", False), ("v", "float64", False)]
    arrays = {"k": base[rng.integers(0, 200, n)], "v": rng.normal(size=n)}
    got = _check(spec, arrays, {}, ["k"])
    keys = got.columns["k"].data
    assert (keys >= 2 ** 63).any() and (np.diff(keys) > 0).all()


# --------------------------------------------------------------------------
# K4: the medium-domain lane (513 to 65,535 buckets)
# --------------------------------------------------------------------------


MEDIUM = {
    "one_key_600": (("k",), (600,)),
    "two_keys_51051": (("k", "c"), (1000, 50)),
    "largest_65535": (("k",), (65534,)),
}


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("shape", list(MEDIUM))
def test_medium_domain(rng, shape, filtered, monkeypatch):
    keys, doms = MEDIUM[shape]
    n = 6000
    spec = [("k", "int64", True), ("c", "int32", False),
            ("v", "float64", True), ("d", "int64", False)]
    arrays = {"k": rng.integers(0, doms[0], n),
              "c": rng.integers(0, 50, n).astype(np.int32),
              "v": rng.normal(size=n), "d": rng.integers(0, 10, n)}
    valids = {"k": rng.random(n) > 0.1, "v": rng.random(n) > 0.2}
    calls = []
    lane = torch_exec._groupby_medium_domain
    monkeypatch.setattr(torch_exec, "_groupby_medium_domain",
                        lambda *a, **k: calls.append(1) or lane(*a, **k))
    perms = _count_bucket_perm(monkeypatch)
    _check(spec, arrays, valids, keys, filt=("d", 3) if filtered else None,
           key_domains=doms)
    assert calls, "the medium-domain lane did not run"
    assert perms, "the medium-domain lane did not call bucket_perm"


def _count_bucket_perm(monkeypatch) -> list:
    """The lane's calls of the `bucket_perm` wrapper (K4's counting
    sort), one entry each."""
    perms = []
    real = bindings.bucket_perm
    monkeypatch.setattr(bindings, "bucket_perm",
                        lambda *a, **k: perms.append(1) or real(*a, **k))
    return perms


def test_medium_domain_carried_keys(rng, monkeypatch):
    n = 5000
    k = rng.integers(0, 900, n)
    spec = [("k", "int64", False), ("kk", "int64", False),
            ("v", "float64", False)]
    arrays = {"k": k, "kk": k * 7, "v": rng.normal(size=n)}
    perms = _count_bucket_perm(monkeypatch)
    _check(spec, arrays, {}, ["k"], key_domains=(900,), carry_keys=("kk",))
    assert perms, "the medium-domain lane did not call bucket_perm"


# --------------------------------------------------------------------------
# the segment_agg plain version on its own
# --------------------------------------------------------------------------


def test_segment_agg_slots_past_ngroups_are_zero(rng):
    n = 1000
    key = torch.from_numpy(rng.integers(0, 10, n))
    active = torch.from_numpy(rng.random(n) > 0.5)
    perm = bindings.sort_perm([(~active).to(torch.int64), key], n, "cpu")
    ng, lead, pres, vals, cnts = bindings.segment_agg_plain(
        perm, [key], active, [("first", None, None, False),
                              ("sum", torch.ones(n, dtype=torch.float64),
                               None, False)], 64)
    g = int(ng)
    assert g == 10
    assert (pres[g:] == 0).all() and (lead[g:] == 0).all()
    assert all((v[g:] == 0).all() for v in vals)
    assert int(pres.sum()) == int(active.sum()) == int(vals[1].sum())
    # first = the smallest original row id of the group's active rows
    for j in range(g):
        rows = torch.nonzero(active & (key == key[lead[j]])).reshape(-1)
        assert int(vals[0][j]) == int(rows.min()) == int(lead[j])
