"""The port's device window lane (``ops/window_dev.py``, K13 through the
``window_scan`` kernel's plain version) against the JAX package's.

Random frames made with numpy from a seed go through both packages'
``compute_windows_device``; every function of ``DEVICE_FUNCS`` with
ROWS frames, NULLs, one partition, singleton partitions, the final sort
+ limit, and a declined spec. Integers, bools, null masks and row order
must match exactly, floats to rtol 1e-9.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from ydb_tpu.core import dtypes as jdt
from ydb_tpu.core.block import HostBlock as JBlock
from ydb_tpu.core.dictionary import Dictionary as JDict
from ydb_tpu.core.schema import Column as JColumn, Schema as JSchema
from ydb_tpu.ops import window_dev as jwin

from ydb_tpu_torch.core import dtypes as pdt
from ydb_tpu_torch.core.block import HostBlock as PBlock
from ydb_tpu_torch.core.dictionary import Dictionary as PDict
from ydb_tpu_torch.core.schema import Column as PColumn, Schema as PSchema
from ydb_tpu_torch.ops import window_dev as pwin
from ydb_tpu_torch.ops.cuda import bindings
from ydb_tpu_torch.storage.mvcc import WriteVersion
from tests import torch_threads  # noqa: F401,E402

RTOL = 1e-9
UNB_PRE = ("unbounded", -1)
UNB_FOL = ("unbounded", 1)


def _frame(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    tags = ["aa", "bb", "cc", "dd", "ee"]
    jd, pdict = JDict(), PDict()
    codes = rng.integers(0, len(tags), n)
    words = [tags[c] for c in codes]
    arrays = {
        "g": rng.integers(0, 12, n),
        "h": rng.integers(0, 4, n),
        "d": rng.integers(0, 1000, n),
        "u": np.arange(n),
        "v": np.round(rng.normal(100, 30, n), 3),
        "iv": rng.integers(-500, 500, n),
        "off2": np.full(n, 2),
        "b": rng.random(n) > 0.5,
    }
    valids = {"g": rng.random(n) > 0.1, "v": rng.random(n) > 0.15,
              "iv": rng.random(n) > 0.1}
    spec = [("g", "int64", True), ("h", "int64", False),
            ("d", "int64", False), ("u", "int64", False),
            ("v", "float64", True), ("iv", "int64", True),
            ("off2", "int64", False), ("b", "bool", False)]
    jb = JBlock.from_arrays(
        JSchema([JColumn(c, jdt.DType(jdt.Kind(k), nl)) for c, k, nl in spec]
                + [JColumn("s", jdt.DType(jdt.Kind.STRING, False))]),
        {**arrays, "s": jd.encode(words)}, valids, {"s": jd})
    pb = PBlock.from_arrays(
        PSchema([PColumn(c, pdt.DType(pdt.Kind(k), nl)) for c, k, nl in spec]
                + [PColumn("s", pdt.DType(pdt.Kind.STRING, False))]),
        {**arrays, "s": pdict.encode(words)}, valids, {"s": pdict})
    return jb, pb


def _w(func, args=(), part=("g",), order=(), asc=None, alias=None,
       frame=None):
    return ("win", {"func": func, "args": list(args), "part": list(part),
                    "order": list(order),
                    "asc": list(asc) if asc is not None
                    else [True] * len(order),
                    "alias": alias or f"w_{func}", "frame": frame})


CASES = {
    "ranking": [_w("row_number", order=("d", "u")),
                _w("rank", order=("h",)), _w("dense_rank", order=("h",))],
    "ranking_desc_two_keys": [
        _w("rank", part=("g", "h"), order=("d",), asc=(False,)),
        _w("dense_rank", part=("g", "h"), order=("h", "d"),
           asc=(True, False))],
    "running": [_w("sum", ("v",), order=("u",)),
                _w("count", ("v",), order=("u",)),
                _w("avg", ("v",), order=("u",)),
                _w("sum", ("iv",), order=("d", "u"), alias="w_isum"),
                _w("count", (), order=("u",), alias="w_star")],
    "whole_partition": [_w("sum", ("v",)), _w("min", ("v",)),
                        _w("max", ("iv",)), _w("count", ("iv",)),
                        _w("avg", ("iv",)), _w("count", (), alias="w_star")],
    "running_minmax": [_w("min", ("v",), order=("u",)),
                       _w("max", ("v",), order=("u",)),
                       _w("min", ("iv",), order=("d",), alias="w_imin"),
                       _w("max", ("b",), order=("u",), alias="w_bmax")],
    "rows_frames": [
        _w("sum", ("v",), order=("u",), frame=("rows", -2, 0)),
        _w("avg", ("v",), order=("u",), frame=("rows", -1, 1),
           alias="w_avg11"),
        _w("count", ("v",), order=("u",), frame=("rows", UNB_PRE, 0)),
        _w("sum", ("iv",), order=("u",), frame=("rows", 0, UNB_FOL),
           alias="w_isum"),
        _w("avg", ("v",), order=("u",), frame=("rows", 3, 5),
           alias="w_ahead")],
    "lead_lag": [_w("lead", ("v",), order=("u",)),
                 _w("lag", ("iv", "off2"), order=("d", "u")),
                 _w("lag", ("s",), order=("u",), alias="w_slag"),
                 _w("lead", ("b", "off2"), order=("u",), alias="w_blead")],
    "one_partition": [_w("row_number", part=(), order=("u",)),
                      _w("sum", ("v",), part=(), order=("u",)),
                      _w("max", ("iv",), part=()),
                      _w("lag", ("v",), part=(), order=("u",))],
    "singleton_partitions": [_w("row_number", part=("u",), order=("d",)),
                             _w("sum", ("v",), part=("u",)),
                             _w("lead", ("iv",), part=("u",),
                                order=("d",)),
                             _w("avg", ("v",), part=("u",), order=("d",),
                                frame=("rows", -1, 1))],
}


def _assert_same(jout, pout):
    assert set(jout) == set(pout)
    for name in jout:
        jv, jvalid, jdic = jout[name]
        pv, pvalid, pdic = pout[name]
        assert (jdic is None) == (pdic is None), name
        jm = np.ones(len(jv), bool) if jvalid is None else np.asarray(jvalid)
        pm = np.ones(len(pv), bool) if pvalid is None else np.asarray(pvalid)
        np.testing.assert_array_equal(pm, jm, err_msg=f"{name} valid")
        jv, pv = np.asarray(jv), np.asarray(pv)
        assert pv.dtype == jv.dtype, (name, pv.dtype, jv.dtype)
        if jdic is not None:
            assert list(pdic.decode(pv[pm])) == list(jdic.decode(jv[jm]))
        elif np.issubdtype(jv.dtype, np.floating):
            np.testing.assert_allclose(pv[pm], jv[jm], rtol=RTOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(pv[pm], jv[jm], err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_windows_device_matches_reference(case, monkeypatch):
    jb, pb = _frame(seed=len(case))
    outer = [("col", "u"), ("col", "v")] + CASES[case]
    calls = []
    real = bindings.window_scan_plain
    monkeypatch.setattr(bindings, "window_scan_plain",
                        lambda *a: calls.append(1) or real(*a))
    jout = jwin.compute_windows_device(jb, outer)
    pout = pwin.compute_windows_device(pb, outer, device="cpu")
    assert jout is not None and pout is not None
    _assert_same(jout, pout)
    assert calls                       # the lane went through window_scan


@pytest.mark.parametrize("final", [
    [("w_sum", True), ("u", True)],
    [("w_rank", False), ("v", True), ("u", False)],
    [("w_slag", True), ("u", True)],
])
def test_final_sort_and_limit_match_reference(final):
    jb, pb = _frame(seed=7)
    outer = [("col", "u"), ("col", "v"), ("col", "s"),
             _w("sum", ("v",), order=("u",)),
             _w("rank", order=("h",), alias="w_rank"),
             _w("lag", ("s",), order=("u",), alias="w_slag")]
    jout, jn = jwin.compute_windows_device(jb, outer, final_sort=final,
                                           limit=20, offset=5)
    pout, pn = pwin.compute_windows_device(pb, outer, final_sort=final,
                                           limit=20, offset=5, device="cpu")
    assert jn == pn == 25
    _assert_same(jout, pout)


@pytest.mark.parametrize("spec", [
    _w("min", ("v",), order=("u",), frame=("rows", -2, 0)),   # sliding min
    _w("ntile", ("h",), order=("u",)),
    _w("sum", ("s",)),                                          # string sum
    _w("lag", ("v", "d"), order=("u",)),                        # offset varies
])
def test_declined_spec_goes_to_the_host_lane_in_both(spec):
    jb, pb = _frame(seed=3)
    outer = [("col", "u"), spec]
    assert jwin.compute_windows_device(jb, outer) is None
    assert pwin.compute_windows_device(pb, outer, device="cpu") is None


def test_device_lane_exception_propagates(monkeypatch):
    """No silent fallback: an exception inside the device lane reaches the
    caller instead of sending the frame to pandas."""
    from ydb_tpu_torch.ops import window_dev
    from ydb_tpu_torch.query import QueryEngine
    from ydb_tpu_torch.utils.config import Config
    cfg = Config()
    cfg.window_device_min_rows = 0
    eng = QueryEngine(device="cpu", config=cfg)
    eng.execute("create table w (k Int64 not null, g Int64 not null, "
                "v Double, primary key (k))")
    eng.catalog.table("w").bulk_upsert(pd.DataFrame({
        "k": np.arange(50), "g": np.arange(50) % 3,
        "v": np.arange(50) * 0.5}), WriteVersion(1, 1))
    sql = "select k, sum(v) over (partition by g order by k) as s from w"
    assert len(eng.query(sql)) == 50

    def boom(*a, **kw):
        raise RuntimeError("device lane fault")
    monkeypatch.setattr(window_dev, "compute_windows_device", boom)
    with pytest.raises(RuntimeError, match="device lane fault"):
        eng.query(sql)
    # a frame below the threshold never reaches the device lane
    cfg.window_device_min_rows = 1 << 20
    assert len(eng.query(sql)) == 50
