"""The wrappers of K2 (keyless `bucket_agg`, one launch) and K6 xB
(`compact_batched`, one launch, no zero-fill): their host plans, and
their launches on CUDA tensors made under `FakeTensorMode` (no card
needed), never the plain versions.

`keyless_plan` takes the streaming body for counts and up to four sums
with no validity over aligned columns (`J` 16-byte loads a sum a lane a
step: 8 up to two sums, else 4), on a grid of at most 264 blocks, and
the folding body otherwise; a keyless call launches `bucket_agg_keyless`
once a chunk of 16 aggregates with the plan's grid and partials and one
ticket word per stream (a keyed call launches `bucket_agg`, K3).
`compact_batched` launches once a chunk of 24 columns over B x
tiles blocks of 32,768 rows, allocates its outputs empty (zeroed only
when asked), and keeps its look-back words per stream, zeroed once, with
a new epoch per call (the later chunks of one call reuse it); `compact`
(K6) is the same launch at B = 1 with zeroed outputs. The plain versions
are held against their definitions at small sizes.
"""

import ctypes

import numpy as np
import pytest
import torch

from ydb_tpu_torch.ops.cuda import bindings as K
from tests import torch_threads  # noqa: F401,E402

Q14 = 6 * (1 << 20)


@pytest.mark.parametrize("aggs,aligned,want", [
    # Q14: two float64 sums, no NULLs
    ([("sum", True, False)] * 2, True, ("stream", 8, 264)),
    # Q6: one sum and a count(*)-like count
    ([("sum", True, False), ("count", False, False)], True,
     ("stream", 8, 264)),
    ([("sum", True, False)] * 3, True, ("stream", 4, 264)),
    ([("sum", True, False)] * 4 + [("count", False, False)] * 5, True,
     ("stream", 4, 264)),
    ([], True, ("stream", 8, 264)),
    # a fifth sum, a validity, another func or unaligned columns: fold
    ([("sum", True, False)] * 5, True, ("fold", 0, 528)),
    ([("sum", True, True)], True, ("fold", 0, 528)),
    ([("count", False, True)], True, ("fold", 0, 528)),
    ([("min", True, False)], True, ("fold", 0, 528)),
    ([("first", False, False)], True, ("fold", 0, 528)),
    ([("sum", True, False)], False, ("fold", 0, 528)),
])
def test_keyless_plan(aggs, aligned, want):
    plan = K.keyless_plan(Q14, aggs, aligned)
    assert (plan["path"], plan["J"], plan["grid"]) == want
    assert plan["launches"] == 1


@pytest.mark.parametrize("n,J,grid", [(0, 8, 1), (1, 8, 1), (4096, 8, 1),
                                      (4097, 8, 2), (2048 * 264, 4, 264),
                                      (2048 * 264 + 1, 4, 264),
                                      (10_000, 4, 5)])
def test_keyless_plan_grid_follows_the_rows(n, J, grid):
    sums = 1 if J == 8 else 3
    plan = K.keyless_plan(n, [("sum", True, False)] * sums, True)
    assert (plan["J"], plan["grid"]) == (J, grid)
    # a block step is 8 warps x 64 x J rows: no block is left idle
    assert plan["grid"] == max(1, min(-(-n // (8 * 64 * J)), 264))


@pytest.mark.parametrize("n,B,tiles", [(0, 3, 1), (1, 1, 1), (32768, 8, 1),
                                       (32769, 8, 2), (2097152, 32, 64),
                                       (6291456, 8, 192)])
def test_compact_batched_plan(n, B, tiles):
    plan = K.compact_batched_plan(n, B)
    assert plan["tiles"] == tiles and plan["blocks"] == B * tiles
    assert plan["status_words"] == 1 + B * tiles and plan["launches"] == 1


# ------------------------------------------------ the wrappers on CUDA tensors


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: real CUDA tensors launch the kernel")


def _fake(monkeypatch):
    launched, allocated = [], []
    monkeypatch.setattr(K, "_launch", lambda name, *a:
                        launched.append((name, a)))
    monkeypatch.setattr(K, "_ptr", lambda t: None if t is None else 0)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    for name in ("bucket_agg_plain", "compact_batched_plain"):
        monkeypatch.setattr(K, name, lambda *a, _n=name, **k: pytest.fail(
            f"a CUDA tensor took {_n}"))
    real = {f: getattr(torch, f) for f in ("empty", "zeros")}

    def alloc(f):
        def make(*a, **k):
            t = real[f](*a, **k)
            allocated.append((f, tuple(t.shape)))
            return t
        return make
    for f in real:
        monkeypatch.setattr(torch, f, alloc(f))
    return launched, allocated


def test_keyless_bucket_agg_launches_once_a_chunk(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "_TICKETS", {})
    n = 1 << 20
    with FakeTensorMode():
        cuda = dict(device="cuda")
        active = torch.empty(n, dtype=torch.bool, **cuda)
        col = torch.empty(n, dtype=torch.float64, **cuda)
        valid = torch.empty(n, dtype=torch.bool, **cuda)
        launched, allocated = _fake(monkeypatch)
        two = [("sum", col, None, False)] * 2
        vals, cnts, pres = K.bucket_agg(None, 1, active, two)
        K.bucket_agg(None, 1, active, two)            # the same ticket
        wide = [("sum", col, valid, False)] * 17     # two chunks, folded
        K.bucket_agg(None, 1, active, wide)
    assert [v.shape for v in vals] == [(1,), (1,)]
    assert all(v.dtype == torch.float64 for v in vals)
    assert pres.shape == (1,) and cnts[0].dtype == torch.int64
    names = [name for name, _a in launched]
    assert names == ["bucket_agg_keyless"] * 4
    # (n, active, A, data, valid, funcs, types, cap, J, G, ...)
    got = [(a[2], a[8], a[9]) for _n, a in launched[:4]]
    assert got == [(2, 8, n // 4096), (2, 8, n // 4096), (16, 0, 528),
                   (1, 0, 528)]
    # one zeroed ticket word for the stream, made once
    assert [x for x in allocated if x[0] == "zeros"] == [("zeros", (1,))]


def test_compact_batched_launches_once_without_a_fill(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "_CM_STATUS", {})
    n, B = 2097152, 32
    with FakeTensorMode():
        cuda = dict(device="cuda")
        masks = torch.empty((B, n), dtype=torch.bool, **cuda)
        cols = [torch.empty(n, dtype=torch.int64, **cuda),
                torch.empty((B, n), dtype=torch.float64, **cuda)]
        launched, allocated = _fake(monkeypatch)
        outs, live, new_len, ovf = K.compact_batched(cols, masks, n, n, n, B)
        K.compact_batched(cols, masks, n, n, n, B)
        many = cols * 13                                # 26: two chunks
        K.compact_batched(many, masks, n - 5, n, 1024, B)
        K.compact_batched(cols, masks, n, n, 64, B, zero_tail=True)
    assert [o.shape for o in outs] == [(B, n), (B, n)]
    assert live.shape == new_len.shape == ovf.shape == (B,)
    names = [name for name, _a in launched]
    assert names == ["compact_batched"] * 5
    # (n, B, lengths, ls, length, mask, ms, new_cap, status, epoch, ...,
    #  n_cols, ..., count_pass, stream)
    epochs = [a[9] for _n, a in launched]
    assert epochs == [1, 2, 3, 3, 4]
    assert [(a[13], a[18]) for _n, a in launched] == [
        (2, 1), (2, 1), (24, 1), (2, 0), (2, 1)]
    assert launched[0][1][6] == n                        # the mask stride
    # a host length goes by value (no copy to the card, no wait)
    assert [(a[2], a[3], a[4]) for _n, a in launched[2:4]] == [
        (None, 0, n - 5)] * 2
    # the status words once (1 + B x tiles), the outputs empty unless
    # zero_tail asks for zeros
    zeros = [x for x in allocated if x[0] == "zeros"]
    assert zeros == [("zeros", (1 + B * 64,)), ("zeros", (B, 64)),
                     ("zeros", (B, 64))]


def test_compact_is_the_member_kernel_at_one_member(monkeypatch):
    """K6, the single query: one launch of the same entry with B = 1,
    counted as `compact`, outputs zeroed first (compact_env's zero
    tail), the (1, new_cap) rows returned as (new_cap,) columns."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "_CM_STATUS", {})
    monkeypatch.setattr(K, "compact_plain", lambda *a: pytest.fail(
        "a CUDA tensor took compact_plain"))
    n = 6 * (1 << 20)
    with FakeTensorMode():
        cuda = dict(device="cuda")
        mask = torch.empty(n, dtype=torch.bool, **cuda)
        length = torch.empty((), dtype=torch.int32, **cuda)
        cols = [torch.empty(n, dtype=torch.float64, **cuda),
                torch.empty(n, dtype=torch.int32, **cuda)]
        launched, allocated = _fake(monkeypatch)
        outs, live, new_len, ovf = K.compact(cols, mask, length, n, 81920)
    assert [o.shape for o in outs] == [(81920,), (81920,)]
    assert live.shape == new_len.shape == ovf.shape == ()
    assert [name for name, _a in launched] == ["compact"]
    a = launched[0][1]
    assert (a[1], a[3], a[6], a[7]) == (1, 0, 0, 81920)   # B, ls, ms, cap
    assert [x for x in allocated if x[0] == "zeros"] == [
        ("zeros", (1, 81920)), ("zeros", (1, 81920)), ("zeros", (1 + 192,))]


def test_launch_signatures_match_the_sources():
    """The ctypes argument lists of the two new entries have the C
    entries' arity and kinds."""
    import re
    from ydb_tpu_torch.ops.cuda import build
    for name, lib, sym in (("bucket_agg_keyless", "bucket_agg",
                            "bucket_agg_keyless_launch"),
                           ("compact_batched", "compact", "compact_launch"),
                           ("compact", "compact", "compact_launch")):
        src = (build.CSRC / f"{lib}.cu").read_text()
        m = re.search(r'extern "C" int ' + sym + r"\((.*?)\)\s*\{", src,
                      re.S)
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(K._SIGS[name][2]), name
        for p, t in zip(params, K._SIGS[name][2]):
            if "*" in p:
                assert t in (K._P, K._PI64, K._PI32), (name, p)
            elif "int64_t" in p:
                assert t is K._I64, (name, p)
            else:
                assert t is ctypes.c_int, (name, p)


# ------------------------------------------------------- the plain versions


def test_keyless_plain_sums_the_active_rows():
    rng = np.random.default_rng(5)
    n = 5000
    active = torch.from_numpy(rng.random(n) < 0.7)
    x = torch.from_numpy(rng.normal(size=n))
    i = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n))
    vals, cnts, pres = K.bucket_agg(None, 1, active, [
        ("sum", x, None, False), ("sum", i, None, False),
        ("count", None, None, False)])
    a = active.numpy()
    np.testing.assert_allclose(float(vals[0][0]), x.numpy()[a].sum(),
                               rtol=1e-12)
    assert int(vals[1][0]) == int(i.numpy()[a].sum())
    assert int(vals[2][0]) == int(a.sum()) == int(pres[0])
    assert all(int(c[0]) == int(a.sum()) for c in cnts)


def test_compact_batched_plain_live_prefix_and_zero_tail():
    rng = np.random.default_rng(6)
    n, B = 700, 4
    masks = torch.from_numpy(rng.random((B, n)) < 0.3)
    col = torch.from_numpy(rng.integers(0, 1000, n))
    for zero_tail in (False, True):
        outs, live, new_len, ovf = K.compact_batched(
            [col], masks, n - 9, n, 128, B, zero_tail=zero_tail)
        for b in range(B):
            rows = np.nonzero(masks[b].numpy()[:n - 9])[0]
            assert int(live[b]) == len(rows)
            assert int(new_len[b]) == min(len(rows), 128)
            assert bool(ovf[b]) == (len(rows) > 128)
            k = int(new_len[b])
            assert np.array_equal(outs[0][b, :k].numpy(),
                                  col.numpy()[rows[:k]])
            assert not outs[0][b, k:].any()
