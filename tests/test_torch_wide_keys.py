"""More key words than a kernel takes in one launch (ROADMAP Queue 3 F1).

The sort, segment_agg, window_scan and segments kernels read at most 16
key words (hash64 16 columns); past that their wrappers go through the
chains of `ops/cuda/bindings.py`, which hand each kernel a narrower input
computed on the card. Here each chain runs over the plain primitive
capped at 16 words, at 17, 33 and 40 words with nullable keys and many
duplicate rows, and must equal the uncapped plain version exactly. On
CUDA tensors made under `FakeTensorMode` (no card needed) the wrappers
take the chains and launch their kernels with at most 16 words. Last, a
GROUP BY over all 16 lineitem columns and the same columns under ORDER BY
... LIMIT (17 and 22 sort words) answer as the JAX engine does, at TPC-H
SF 0.001.
"""

import numpy as np
import pytest
import torch

from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.sort import encode_key
from tests import torch_threads  # noqa: F401,E402

WIDTHS = [17, 33, 40]
N = 3000


def _words(width: int, n: int, seed: int) -> list:
    """`width` key words as the sorted lanes encode them: a nullable key
    gives its validity word and its value word (zeroed where NULL), and
    every value comes from a small domain, so many rows are equal in
    every word."""
    rng = np.random.default_rng(seed)
    words = []
    while len(words) < width:
        vals = rng.integers(-2, 3, n)
        if len(words) % 3 == 0 and len(words) + 2 <= width:
            valid = rng.random(n) < 0.7
            words.append(encode_key(torch.from_numpy(valid.astype(np.int64))))
            vals = np.where(valid, vals, 0)
        words.append(encode_key(torch.from_numpy(vals)))
    return words[:width]


def _capped(fn, n_words, width: int = 16):
    """`fn` refusing more than `width` words, as the kernels do."""
    def call(*a, **k):
        assert n_words(*a) <= width, n_words(*a)
        return fn(*a, **k)
    return call


def _perm(words, n: int, seed: int):
    """The sorted lane's permutation: 10% of the rows inactive, the
    active rows first in key order. Returns (perm, active)."""
    active = torch.from_numpy(np.random.default_rng(seed).random(n) >= 0.1)
    inactive = encode_key((~active).to(torch.int64))
    return K.sort_perm_plain([inactive] + words, n, "cpu"), active


def _aggs(n: int, seed: int, B: int = 0) -> list:
    rng = np.random.default_rng(seed)
    shape = (B, n) if B else (n,)
    return [("sum", torch.from_numpy(rng.normal(size=shape)),
             torch.from_numpy(rng.random(shape) < 0.8), False),
            ("count", None, None, False),
            ("min", torch.from_numpy(rng.integers(-99, 99, shape)), None,
             False),
            ("first", None, torch.from_numpy(rng.random(shape) < 0.5),
             False)]


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("width", WIDTHS)
def test_sort_chain_equals_one_sort(width):
    words = _words(width, N, width)
    sort16 = _capped(K.sort_perm_plain, lambda keys, n, d: len(keys))
    got = K.sort_perm_chained(words, N, "cpu", sort16)
    _same(got, K.sort_perm_plain(words, N, "cpu"))
    # the one-group edge: exactly `width` words sort once
    _same(K.sort_perm_chained(words[:16], N, "cpu", sort16),
          K.sort_perm_plain(words[:16], N, "cpu"))


@pytest.mark.parametrize("width", WIDTHS)
def test_segment_agg_chain_equals_all_words(width):
    words = _words(width, N, 100 + width)
    perm, active = _perm(words, N, width)
    aggs = _aggs(N, width)
    agg16 = _capped(K.segment_agg_plain, lambda p, keys, *a: len(keys))
    for oc in (N, 64):                     # groups past oc are dropped
        got = K.segment_agg_chained(perm, words, active, aggs, oc, agg16)
        _same(got, K.segment_agg_plain(perm, words, active, aggs, oc))


@pytest.mark.parametrize("width", WIDTHS)
def test_segment_agg_batched_chain_equals_all_words(width):
    B = 3
    words = _words(width, N, 200 + width)
    rng = np.random.default_rng(width)
    masks = torch.from_numpy(rng.random((B, N)) < 0.6)
    masks[1] = False                       # a member with no row
    inactive = encode_key((~masks.any(0)).to(torch.int64))
    perm = K.sort_perm_plain([inactive] + words, N, "cpu")
    aggs = _aggs(N, width, B)
    agg16 = _capped(K.segment_agg_batched_plain,
                    lambda p, keys, *a: len(keys))
    got = K.segment_agg_chained(perm, words, masks, aggs, N, agg16)
    _same(got, K.segment_agg_batched_plain(perm, words, masks, aggs, N))


@pytest.mark.parametrize("width,n_part", [(17, 9), (33, 1), (40, 24),
                                          (20, 20)])
def test_window_scan_chain_equals_all_words(width, n_part):
    words = _words(width, N, 300 + width)
    pw, ow = words[:n_part], words[n_part:]
    perm = K.sort_perm_plain(words, N, "cpu")
    rng = np.random.default_rng(width)
    aggs = [("sum", torch.from_numpy(rng.normal(size=N)),
             torch.from_numpy(rng.random(N) < 0.8)),
            ("max", torch.from_numpy(rng.integers(-50, 50, N)), None)]
    scan16 = _capped(K.window_scan_plain,
                     lambda p, a, b, *r: len(a) + len(b))
    got = K.window_scan_chained(perm, pw, ow, aggs, scan16)
    want = K.window_scan_plain(perm, pw, ow, aggs)
    _same(list(got[:4]), list(want[:4]))
    for (gv, gc), (wv, wc) in zip(got[4], want[4]):
        _same(gc, wc)
        # the scans see the same partitions, so the sums fold alike
        _same(gv, wv)


@pytest.mark.parametrize("width", WIDTHS)
def test_hash_chain_equals_one_hash(width):
    rng = np.random.default_rng(width)
    cols = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, N))
            for _ in range(width)]
    pre = [bool(x) for x in rng.random(width) < 0.7]
    pre[0] = True
    hash16 = _capped(K.hash64_plain, lambda cols, pre: len(cols))
    _same(K.hash64_chained(cols, pre, hash16),
          K.hash64_plain(cols, pre))


@pytest.mark.parametrize("width", WIDTHS)
def test_segment_targets_chain_equals_the_plain_targets(width):
    rng = np.random.default_rng(400 + width)
    keys = []
    for i in range(width):
        d = torch.from_numpy(rng.integers(-3, 3, N)) if i % 3 else \
            torch.from_numpy(rng.normal(size=N) * 1e3)    # float keys
        v = torch.from_numpy(rng.random(N) < 0.8) if i % 2 else None
        keys.append((d, v))
    hash16 = _capped(K.hash64_plain, lambda cols, pre: len(cols))
    for ndev in (4, 7):
        targets = K.wide_targets(keys, ndev, hash16)
        _same(targets, K.segment_targets_plain(keys, ndev))
        cols = [(torch.from_numpy(rng.integers(0, 99, N)), None)]
        _same(K.segments_plain(N - 5, ndev, N, cols, targets=targets),
              K.segments_plain(N - 5, ndev, N, cols, keys=keys))


# ------------------------------------------------ the wrappers on CUDA tensors


def _fake_launch(monkeypatch):
    launched = []
    monkeypatch.setattr(K, "_launch", lambda name, *a:
                        launched.append((name, a)))
    monkeypatch.setattr(K, "_ptr", lambda t: 0)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    for name in ("sort_perm_plain", "segment_agg_plain", "window_scan_plain",
                 "segment_targets_plain", "segments_plain", "hash64_plain"):
        monkeypatch.setattr(K, name, lambda *a, _n=name, **k: pytest.fail(
            f"a CUDA tensor took {_n}"))
    return launched


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: real CUDA tensors launch the kernel")


@pytest.mark.parametrize("width,sorts", [(16, 1), (17, 2), (33, 3),
                                         (40, 3)])
def test_sort_perm_chains_sixteen_words_a_launch(monkeypatch, width, sorts):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    with FakeTensorMode():
        keys = [torch.empty(5000, dtype=torch.int64, device="cuda")
                for _ in range(width)]
        perm = K.sort_perm(keys, 5000, "cuda")
    assert perm.shape == (5000,) and perm.dtype == torch.int32
    assert [name for name, _a in launched] == ["sort"] * sorts
    # words a launch: the last 16 first, then each earlier group
    assert [a[1] for _n, a in launched] == \
        [16] * (width // 16) + ([width % 16] if width % 16 else [])


def test_segment_agg_and_window_scan_take_one_word(monkeypatch):
    """Past 16 words each wrapper calls itself once more with the folded
    words: a group word for segment_agg (and its member form), a
    partition-id and a dense-rank word for window_scan."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    _fake_launch(monkeypatch)
    calls = []
    real = {name: getattr(K, name) for name in
            ("segment_agg", "segment_agg_batched", "window_scan")}
    for name in real:
        monkeypatch.setattr(K, name, lambda perm, a, b, *r, _n=name:
                            calls.append((_n, len(a), len(b) if _n ==
                                          "window_scan" else None)))
    n = 4000
    with FakeTensorMode():
        cuda = dict(device="cuda")
        perm = torch.empty(n, dtype=torch.int32, **cuda)
        words = [torch.empty(n, dtype=torch.int64, **cuda) for _ in range(20)]
        active = torch.empty(n, dtype=torch.bool, **cuda)
        aggs = [("sum", torch.empty(n, dtype=torch.float64, **cuda), None,
                 False)]
        real["segment_agg"](perm, words, active, aggs, 128)
        masks = torch.empty((3, n), dtype=torch.bool, **cuda)
        real["segment_agg_batched"](perm, words, masks, aggs, 128)
        scan = [("sum", aggs[0][1], None)]
        real["window_scan"](perm, words[:5], words[5:], scan)
        real["window_scan"](perm, words[:17], [], scan)
    assert calls == [("segment_agg", 1, None),
                     ("segment_agg_batched", 1, None),
                     ("window_scan", 1, 1), ("window_scan", 1, 0)]


def test_segments_past_sixteen_keys_route_by_targets(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    n = 4000
    with FakeTensorMode():
        cuda = dict(device="cuda")
        keys = [(torch.empty(n, dtype=torch.int64, **cuda),
                 torch.empty(n, dtype=torch.bool, **cuda) if i % 2 else None)
                for i in range(20)]
        cols = [(torch.empty(n, dtype=torch.float64, **cuda), None)]
        K.segments(n, 4, n, cols, keys=keys)
        targets = K.segment_targets(keys, 4)
    assert targets.shape == (n,) and targets.dtype == torch.int32
    names = [name for name, _a in launched]
    # 20 columns: 16, then the running hash and 4 more; then the
    # segments launch over the targets (no key words)
    assert names == ["hash64", "hash64", "segments", "hash64", "hash64"]
    assert [a[1] for name, a in launched if name == "hash64"] == [16, 5] * 2
    assert launched[2][1][1] == 0


# ---------------------------------------------------- the 16-column queries

LINEITEM = ("l_orderkey, l_partkey, l_suppkey, l_linenumber, l_quantity, "
            "l_extendedprice, l_discount, l_tax, l_returnflag, l_linestatus, "
            "l_shipdate, l_commitdate, l_receiptdate, l_shipinstruct, "
            "l_shipmode, l_comment")
WIDE_SQL = {
    "group_by_16": f"select {LINEITEM}, count(*) as n from lineitem "
                   f"where l_quantity < 30 group by {LINEITEM}",
    "order_by_16": f"select {LINEITEM} from lineitem order by "
                   + ", ".join(f"{c.strip()} desc" if i % 2 else c.strip()
                               for i, c in enumerate(LINEITEM.split(",")))
                   + " limit 40",
}


@pytest.fixture(scope="module")
def tpch_engines():
    from ydb_tpu.bench.tpch_gen import load_tpch as jax_load_tpch
    from ydb_tpu.query import QueryEngine as JaxEngine

    from ydb_tpu_torch.bench import tpch_gen
    from ydb_tpu_torch.query import QueryEngine
    je = JaxEngine(block_rows=1 << 13)
    jax_load_tpch(je.catalog, sf=0.001)
    pe = QueryEngine(device="cpu", block_rows=1 << 13)
    tpch_gen.load_tpch(pe.catalog, sf=0.001)
    return je, pe


@pytest.mark.parametrize("name", sorted(WIDE_SQL))
def test_sixteen_column_queries_match_reference(tpch_engines, name):
    from tests.tpch_util import assert_frames_match
    je, pe = tpch_engines
    want = je.query(WIDE_SQL[name])
    got = pe.query(WIDE_SQL[name])
    assert len(got) > 0
    assert_frames_match(got, want, ordered=name == "order_by_16")
    assert pe.executor.last_path == je.executor.last_path
