"""K9's permutation (`sort_perm`) and K13's wrapper (`window_scan`): the
plain versions against numpy, and the CUDA wrappers' checks, host pass
lists and scratch buffers.

`sort_perm_plain` must equal `numpy.lexsort` of the words taken as
unsigned 64-bit keys, most significant first, with the row id last, at
n = 0, 1, 1,023, 1,024, 1,025 and 2^16 + 333, with all words equal, one
live bit, words >= 2^63, 16 words, `encode_key` of floats with -0.0,
NaN and +-inf, and the member form's leading member word. The wrappers
take the plain version for CPU tensors only: CUDA tensors (made here
under `FakeTensorMode`, which needs no card) with a wrong dtype, length
or device raise (past 16 words too), and right ones go to the launch
with the pass list
and scratch sizes of `sort_plan`, never to the plain version;
`window_scan` launches once per chunk of aggregates, with status words
zeroed once per stream and kept (the last launch leaves them zero), the
look-back words per call, the partition ends marked on the first launch
and filled after the last.
"""

import ctypes

import numpy as np
import pytest
import torch

from ydb_tpu_torch.ops import sort as psort
from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.sort import encode_key
from tests import torch_threads  # noqa: F401,E402

SIZES = [0, 1, 1023, 1024, 1025, (1 << 16) + 333]


def _lexsort(words: list, n: int) -> np.ndarray:
    """numpy's order of the rows: the words as uint64, the first most
    significant, the row id last."""
    cols = [np.arange(n)] + [w.numpy().view(np.uint64)
                             for w in reversed(words)]
    return np.lexsort(cols).astype(np.int32)


def _check(words: list, n: int) -> None:
    perm = K.sort_perm_plain(words, n, "cpu")
    assert perm.dtype == torch.int32 and perm.shape == (n,)
    assert np.array_equal(perm.numpy(), _lexsort(words, n))
    assert torch.equal(K.sort_perm(words, n, "cpu"), perm)


def _rng_words(rng, n: int) -> list:
    """A dropped rank, a small-domain int and a float key, as the
    ORDER BY lane encodes them."""
    return [encode_key(torch.from_numpy(rng.integers(0, 2, n))),
            encode_key(torch.from_numpy(rng.integers(-1000, 1000, n))),
            encode_key(torch.from_numpy(rng.normal(size=n)))]


@pytest.mark.parametrize("n", SIZES)
def test_plain_equals_lexsort_of_unsigned_words(n):
    _check(_rng_words(np.random.default_rng(n), n), n)


@pytest.mark.parametrize("n", SIZES)
def test_all_words_equal_give_the_identity(n):
    words = [torch.full((n,), 7, dtype=torch.int64)] * 3
    _check(words, n)
    assert np.array_equal(K.sort_perm_plain(words, n, "cpu").numpy(),
                          np.arange(n))


def test_one_live_bit():
    rng = np.random.default_rng(1)
    n = 5000
    words = [torch.from_numpy(rng.integers(0, 2, n) << 41),
             torch.full((n,), -3, dtype=torch.int64)]
    _check(words, n)


def test_words_at_or_past_two_to_the_63():
    rng = np.random.default_rng(2)
    n = 4000
    hi = rng.integers(-(1 << 62), 1 << 62, n)
    hi[rng.random(n) < 0.5] |= np.int64(-(1 << 63))   # half >= 2^63
    hi[:5] = [-1, 0, np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1]
    _check([torch.from_numpy(hi), torch.from_numpy(rng.integers(0, 3, n))],
           n)


def test_sixteen_words():
    rng = np.random.default_rng(3)
    n = 3000
    # narrow domains, so that every word decides some ties
    _check([torch.from_numpy(rng.integers(0, 3, n)) for _ in range(16)], n)


def test_encoded_floats_with_signed_zeros_nans_and_infinities():
    rng = np.random.default_rng(4)
    n = 2000
    x = rng.normal(size=n)
    special = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf])
    x[rng.integers(0, n, 600)] = special[rng.integers(0, 6, 600)]
    words = [encode_key(torch.from_numpy(x))]
    _check(words, n)
    perm = K.sort_perm_plain(words, n, "cpu").numpy()
    s = x[perm]
    # lax.sort's total order: -inf first, -0.0 equal to 0.0 (row order),
    # every NaN equal and after +inf
    ordered = s[~np.isnan(s)]
    assert np.all(ordered[1:] >= ordered[:-1])
    assert not np.any(np.isnan(s[:ordered.size]))
    zeros = np.flatnonzero(x[perm] == 0)
    assert np.all(np.diff(perm[zeros]) > 0)


@pytest.mark.parametrize("B", [3, 8])
def test_member_form_leading_member_word(B):
    rng = np.random.default_rng(10 + B)
    cap = 1500
    member = np.repeat(np.arange(B), cap)
    active = rng.random(B * cap) < 0.4
    words = [encode_key(torch.from_numpy(member)),
             encode_key(torch.from_numpy((~active).astype(np.int64))),
             encode_key(torch.from_numpy(rng.integers(0, 50, B * cap)))]
    _check(words, B * cap)
    perm = K.sort_perm_plain(words, B * cap, "cpu").numpy()
    # each member's rows stay in its own run of cap rows
    assert np.array_equal(perm.reshape(B, cap) // cap,
                          np.repeat(np.arange(B), cap).reshape(B, cap))


def test_member_sort_env_uses_one_flattened_sort(monkeypatch):
    """`ops/sort.py _sort_members` sorts the B·cap rows once with the
    member id as the leading word."""
    seen = []
    real = K.sort_perm

    def recording(keys, n, device):
        seen.append((len(keys), n))
        return real(keys, n, device)
    monkeypatch.setattr(K, "sort_perm", recording)
    rng = np.random.default_rng(5)
    B, cap = 4, 300
    arrays = {"k": torch.from_numpy(rng.integers(0, 9, (B, cap)))}
    out, _v, lens = psort.sort_env(arrays, {}, torch.tensor(
        [cap, 10, 0, 200], dtype=torch.int32), None, (("k", True, True),),
        ("k",))
    assert seen == [(3, B * cap)]
    for b, L in enumerate((cap, 10, 0, 200)):
        got = out["k"][b, :L].numpy()
        assert np.array_equal(got, np.sort(arrays["k"][b, :L].numpy(),
                                           kind="stable"))
    assert lens.tolist() == [cap, 10, 0, 200]


# ------------------------------------------------------------ host plan

@pytest.mark.parametrize("n", SIZES + [4096, 8192, 8193, 6 * (1 << 20)])
@pytest.mark.parametrize("n_keys", [1, 3, 16])
def test_sort_plan(n, n_keys):
    plan = K.sort_plan(n, n_keys)
    if n == 0:
        assert plan == {"path": "none", "launches": 0}
        return
    rows = 1 << (n - 1).bit_length()
    if n <= 8192:
        assert plan == {"path": "block", "block_rows": rows,
                        "smem": rows * 26 + 8192, "launches": 1}
        assert rows >= n and plan["smem"] <= 232_448   # one H100 block
        return
    tiles = -(-n // 4096)
    assert plan["path"] == "radix" and plan["tiles"] == tiles
    # the maximal list: 8 digits a word, least significant first, from
    # the last word up
    assert plan["passes"] == [(w, d) for w in reversed(range(n_keys))
                              for d in range(8)]
    assert plan["launches"] == 1 + 8 * n_keys
    assert plan["key_scratch"] == 2 * n and plan["row_scratch"] == 2 * n
    ints = n_keys * 8 * 256 + 8 * n_keys + 1 + 8 * 8 * n_keys
    assert plan["ctl_words"] == tiles * 256 + (ints + 1) // 2


@pytest.mark.parametrize("B,cap", [(8, 1 << 17), (32, 1 << 16)])
def test_sort_plan_member_form(B, cap):
    plan = K.sort_plan(B * cap, 3)
    assert plan["path"] == "radix"
    assert plan["tiles"] == B * cap // 4096
    assert plan["passes"][:8] == [(2, d) for d in range(8)]
    assert plan["passes"][-8:] == [(0, d) for d in range(8)]
    assert plan["key_scratch"] == 2 * B * cap


# ------------------------------------------------------------ CUDA wrappers

def _fake_launch(monkeypatch):
    """Record the launches' names and arguments instead of running them
    (pointers as 0)."""
    launched = []
    monkeypatch.setattr(K, "_launch", lambda name, *a:
                        launched.append((name, a)))
    monkeypatch.setattr(K, "_ptr", lambda t: 0)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    return launched


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: real CUDA tensors launch the kernel")


def test_sort_perm_checks_cuda_tensors(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "sort_perm_plain", lambda *a: pytest.fail(
        "a CUDA tensor took the plain version"))
    with FakeTensorMode():
        good = torch.empty(64, dtype=torch.int64, device="cuda")
        with pytest.raises(ValueError, match="dtype"):
            K.sort_perm([good, torch.empty(64, dtype=torch.int32,
                                           device="cuda")], 64, "cuda")
        with pytest.raises(ValueError, match="shape"):
            K.sort_perm([torch.empty(63, dtype=torch.int64, device="cuda")],
                        64, "cuda")
        with pytest.raises(ValueError, match="dtype"):   # past 16 words too
            K.sort_perm([good] * 17 + [torch.empty(64, dtype=torch.int32,
                                                   device="cuda")], 64,
                        "cuda")
        with pytest.raises(ValueError, match="on cpu"):
            K.sort_perm([torch.empty(64, dtype=torch.int64)], 64, "cuda")


@pytest.mark.parametrize("n", SIZES + [8193])
def test_sort_perm_launches_with_the_plan(monkeypatch, n):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "sort_perm_plain", lambda *a: pytest.fail(
        "a CUDA tensor took the plain version"))
    launched = _fake_launch(monkeypatch)
    allocated = []
    real_empty, real_zeros = torch.empty, torch.zeros

    def empty(*a, **k):
        t = real_empty(*a, **k)
        allocated.append(("empty", t.dtype, t.numel()))
        return t

    def zeros(*a, **k):
        t = real_zeros(*a, **k)
        allocated.append(("zeros", t.dtype, t.numel()))
        return t
    with FakeTensorMode():
        keys = [torch.empty(n, dtype=torch.int64, device="cuda")
                for _ in range(3)]
        monkeypatch.setattr(torch, "empty", empty)
        monkeypatch.setattr(torch, "zeros", zeros)
        perm = K.sort_perm(keys, n, "cuda")
        monkeypatch.setattr(torch, "empty", real_empty)
        monkeypatch.setattr(torch, "zeros", real_zeros)
    assert perm.device.type == "cuda" and perm.dtype == torch.int32
    assert perm.shape == (n,)
    plan = K.sort_plan(n, 3)
    if n == 0:
        assert launched == [] and allocated == [("empty", torch.int32, 0)]
        return
    assert [name for name, _a in launched] == ["sort"]
    (_n, n_keys, _ptrs, block_rows, _perm, kbuf, rbuf, ctl, ctl_words,
     _s) = launched[0][1]
    assert (_n, n_keys) == (n, 3)
    if plan["path"] == "block":
        assert block_rows == plan["block_rows"] and ctl_words == 0
        assert (kbuf, rbuf, ctl) == (None, None, None)
        assert allocated == [("empty", torch.int32, n)]
    else:
        assert block_rows == 0 and ctl_words == plan["ctl_words"]
        # (torch.zeros allocates through torch.empty)
        assert [a for a in allocated if a[0] == "empty"][:3] == [
            ("empty", torch.int32, n), ("empty", torch.int64, 2 * n),
            ("empty", torch.int32, 2 * n)]
        assert [a for a in allocated if a[0] == "zeros"] == [
            ("zeros", torch.int64, plan["ctl_words"])]


def test_sort_perm_without_keys_sorts_one_equal_word(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    with FakeTensorMode():
        K.sort_perm([], 100, "cuda")
    assert [name for name, _a in launched] == ["sort"]
    assert launched[0][1][1] == 1
    assert np.array_equal(K.sort_perm_plain([], 5, "cpu").numpy(),
                          np.arange(5))


def _window_inputs(n: int, n_aggs: int):
    cuda = dict(device="cuda")
    perm = torch.empty(n, dtype=torch.int32, **cuda)
    pw = [torch.empty(n, dtype=torch.int64, **cuda)]
    ow = [torch.empty(n, dtype=torch.int64, **cuda)]
    aggs = [("sum" if a % 3 else "max",
             torch.empty(n, dtype=torch.float64 if a % 2 else torch.int64,
                         **cuda),
             torch.empty(n, dtype=torch.bool, **cuda) if a % 4 else None)
            for a in range(n_aggs)]
    return perm, pw, ow, aggs


@pytest.mark.parametrize("n,n_aggs,chunks", [
    (82_881, 1, 1), (2_880_000, 3, 1), (1000, 14, 1), (1000, 15, 2),
    ((1 << 20) + 333, 18, 2), (0, 2, 1), (5, 0, 1)])
def test_window_scan_launches_per_chunk(monkeypatch, n, n_aggs, chunks):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "window_scan_plain", lambda *a: pytest.fail(
        "a CUDA tensor took the plain version"))
    monkeypatch.setattr(K, "_SCAN_STATUS", {})
    launched = _fake_launch(monkeypatch)
    zeroed = []
    real_zeros = torch.zeros

    def zeros(*a, **k):
        t = real_zeros(*a, **k)
        zeroed.append(tuple(t.shape))
        return t
    with FakeTensorMode():
        perm, pw, ow, aggs = _window_inputs(n, n_aggs)
        monkeypatch.setattr(torch, "zeros", zeros)
        out = K.window_scan(perm, pw, ow, aggs)
        K.window_scan(perm, pw, ow, aggs)      # the same status words
        monkeypatch.setattr(torch, "zeros", real_zeros)
    T = max(-(-n // 1024), 1)
    # status words for every launch (T tiles' flags and the ticket),
    # zeroed once per stream: the last launch leaves them zero again
    assert zeroed == [(chunks * (T + 1),)]
    assert [name for name, _a in launched] == ["window_scan"] * 2 * chunks
    launched = launched[:chunks]
    seen = 0
    for c, (_name, a) in enumerate(launched):
        nq = a[5]
        assert a[0] == n and a[2] == 1 and a[3] == 2
        assert a[12] == T
        assert (a[14], a[15]) == (c, chunks)   # ends first, reset last
        assert nq == 3 + 2 * min(14, n_aggs - seen)
        srcs = list(a[8])[:nq]
        assert srcs[:3] == [0, 1, 2] and srcs[3:] == [3, 4] * (nq // 2 - 1)
        seen += (nq - 3) // 2
    assert seen == n_aggs
    assert len(out[4]) == n_aggs and all(o.shape == (n,) for o in out[:4])


def test_window_scan_drops_status_words_after_a_failed_launch(
        monkeypatch):
    """A launch that raises may leave the status words dirty: they are
    not kept for the next call, which zeroes new ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "_SCAN_STATUS", {})
    monkeypatch.setattr(K, "_ptr", lambda t: 0)
    monkeypatch.setattr(K, "_stream", lambda: 0)

    def failing(name, *a):
        raise RuntimeError("CUDA kernel window_scan failed: cudaError 1")
    monkeypatch.setattr(K, "_launch", failing)
    with FakeTensorMode():
        perm, pw, ow, aggs = _window_inputs(2000, 2)
        with pytest.raises(RuntimeError, match="window_scan"):
            K.window_scan(perm, pw, ow, aggs)
    assert K._SCAN_STATUS == {}


def test_window_scan_checks_cuda_tensors(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    _fake_launch(monkeypatch)
    with FakeTensorMode():
        perm, pw, ow, aggs = _window_inputs(100, 2)
        with pytest.raises(ValueError, match="dtype"):
            K.window_scan(perm.to(torch.int64), pw, ow, aggs)
        with pytest.raises(ValueError, match="shape"):
            K.window_scan(perm, [torch.empty(99, dtype=torch.int64,
                                             device="cuda")], ow, aggs)
        with pytest.raises(ValueError, match="partition"):
            K.window_scan(perm, [], ow, aggs)
        with pytest.raises(ValueError, match="dtype"):
            K.window_scan(perm, pw, ow, [("sum", torch.empty(
                100, dtype=torch.float32, device="cuda"), None)])


def test_launch_signatures_match_the_sources():
    """The ctypes argument lists of the two entries have the C entries'
    arity (sort.cu sort_launch, window_scan.cu window_scan_launch)."""
    import re
    from ydb_tpu_torch.ops.cuda import build
    for name, lib, sym in (("sort", "sort", "sort_launch"),
                           ("window_scan", "window_scan",
                            "window_scan_launch")):
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
