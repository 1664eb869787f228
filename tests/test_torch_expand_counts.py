"""K8's counts (`expand_counts`) as one launch.

The host plan (`expand_counts_plan`): tiles of 2,048 probe rows drawn by
ticket over a persistent grid of at most 264 blocks. The wrapper on CUDA
tensors made under `FakeTensorMode` (no card needed): one launch a call,
never the plain version, with the plan's grid, a new epoch every call
and the look-back flags zeroed once per stream (a larger call makes them
anew). The plain version against the reference's `_expand_counts`:
LEFT, NULL keys, float keys with the `+inf` padding, `length < n` and one
hot key matching most of the build.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydb_tpu.ops import join as jjoin

from ydb_tpu_torch.ops.cuda import bindings as K
from tests import torch_threads  # noqa: F401,E402


@pytest.mark.parametrize("n,tiles,grid", [(0, 1, 1), (1, 1, 1), (2048, 1, 1),
                                          (2049, 2, 2), (1 << 20, 512, 264),
                                          (264 * 2048, 264, 264),
                                          (3_000_000, 1465, 264)])
def test_expand_counts_plan(n, tiles, grid):
    plan = K.expand_counts_plan(n)
    assert (plan["tiles"], plan["grid"]) == (tiles, grid)
    assert plan["status_words"] == 1 + tiles and plan["launches"] == 1
    assert plan["grid"] <= plan["tiles"]


def test_expand_counts_launches_once_a_call(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: real CUDA tensors launch the kernel")
    monkeypatch.setattr(K, "_EX_STATUS", {})
    launched, allocated = [], []
    monkeypatch.setattr(K, "_launch", lambda name, *a:
                        launched.append((name, a)))
    monkeypatch.setattr(K, "_ptr", lambda t: None if t is None else 0)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    monkeypatch.setattr(K, "expand_counts_plain", lambda *a: pytest.fail(
        "a CUDA tensor took expand_counts_plain"))
    real = torch.zeros

    def zeros(*a, **k):
        t = real(*a, **k)
        allocated.append(tuple(t.shape))
        return t
    monkeypatch.setattr(torch, "zeros", zeros)
    n = 1 << 20
    with FakeTensorMode():
        cuda = dict(device="cuda")
        key = torch.empty(n, dtype=torch.int64, **cuda)
        fkey = torch.empty(n, dtype=torch.float64, **cuda)
        valid = torch.empty(n, dtype=torch.bool, **cuda)
        keys = torch.empty(8192, dtype=torch.int64, **cuda)
        fkeys = torch.empty(1 << 20, dtype=torch.float64, **cuda)
        length = torch.empty((), dtype=torch.int32, **cuda)
        lo, m, off, tot = K.expand_counts(key, None, length, keys, 4809,
                                          False)
        K.expand_counts(key, valid, length, keys, 4809, True)
        K.expand_counts(fkey, valid, length, fkeys, 600_000, True)
        K.expand_counts(key.narrow(0, 0, 1000), None, length, keys, 4809,
                        False)
        K.expand_counts(torch.empty(3 << 20, dtype=torch.int64, **cuda),
                        None, length, keys, 4809, False)
        with pytest.raises(ValueError):
            K.expand_counts(key, None, length, keys.narrow(0, 0, 5000), 4809,
                            False)
    assert (lo.shape, m.shape, off.shape, tot.shape) == ((n,), (n,), (n,),
                                                         ())
    assert (lo.dtype, m.dtype, off.dtype) == (torch.int32, torch.int32,
                                              torch.int64)
    assert [name for name, _a in launched] == ["expand_counts"] * 5
    # (n, key, f64, kvalid, length, keys, kcap, n_build, left, lo,
    #  mcounts, offsets, total, flags, sums, prefixes, epoch, grid, stream)
    got = [(a[0], a[2], a[6], a[8], a[16], a[17]) for _n, a in launched]
    assert got == [(n, 0, 8192, 0, 1, 264), (n, 0, 8192, 1, 2, 264),
                   (n, 1, 1 << 20, 1, 3, 264), (1000, 0, 8192, 0, 4, 1),
                   (3 << 20, 0, 8192, 0, 1, 264)]
    # the flags zeroed once for the stream, again (and the epochs from 1)
    # only when a call needs more tiles
    assert [x for x in allocated if len(x) == 1] == [(1 + 512,),
                                                     (1 + 1536,)]


def _reference(probe, valid, length, keys, nb, left):
    lo, m, _c, off, tot = jjoin._expand_counts(
        {"k": jnp.asarray(probe)},
        {} if valid is None else {"k": jnp.asarray(valid)},
        jnp.int32(length), jnp.int32(nb), jnp.asarray(keys), "k", left)
    return np.asarray(lo), np.asarray(m), np.asarray(off), int(tot)


def _padded(build, dtype):
    build = np.sort(build.astype(dtype))
    kcap = max(128, 1 << int(len(build) - 1).bit_length())
    fill = np.inf if dtype == np.float64 else np.iinfo(np.int64).max
    return np.concatenate([build, np.full(kcap - len(build), fill,
                                          dtype=dtype)]), len(build)


@pytest.mark.parametrize("left", [False, True])
@pytest.mark.parametrize("case", ["ints", "null_keys", "floats", "short",
                                  "hot_key", "no_rows"])
def test_expand_counts_plain_matches_reference(case, left):
    rng = np.random.default_rng(len(case) + 7 * left)
    n = 5000
    dtype = np.float64 if case == "floats" else np.int64
    build = rng.integers(0, 600, 1500)
    if case == "hot_key":
        # one key matching most of the build, the rest 0 to 3 rows each
        build = np.concatenate([np.full(3000, 5),
                                np.repeat(np.arange(100, 700),
                                          rng.integers(0, 4, 600))])
    if case == "floats":
        build = build / 4.0
    keys, nb = _padded(build, dtype)
    probe = rng.integers(-10, 720, n).astype(dtype)
    if case == "floats":
        probe = np.round(probe) / 4.0
        probe[::97] = np.inf                    # matches only the padding
    if case == "hot_key":
        probe[rng.random(n) < 0.01] = 5
    valid = rng.random(n) > 0.1 if case in ("null_keys", "floats") else None
    length = {"short": n - 777, "no_rows": 0}.get(case, n)
    want = _reference(probe, valid, length, keys, nb, left)
    got = K.expand_counts(torch.from_numpy(probe),
                          None if valid is None else torch.from_numpy(valid),
                          length, torch.from_numpy(keys), nb, left)
    for g, w, what in zip(got[:3], want[:3], ("lo", "mcounts", "offsets")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    assert int(got[3]) == want[3]
    if case == "hot_key":
        assert got[1].numpy().max() == 3000
    if case == "no_rows":
        assert int(got[3]) == 0


def test_expand_counts_plain_no_probes():
    keys, nb = _padded(np.arange(10), np.int64)
    for left in (False, True):
        lo, m, off, tot = K.expand_counts(torch.zeros(0, dtype=torch.int64),
                                          None, 0, torch.from_numpy(keys),
                                          nb, left)
        assert lo.shape == m.shape == off.shape == (0,) and int(tot) == 0
