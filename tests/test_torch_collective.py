"""The mesh exchange's building blocks (K15) against the reference's.

`ydb_tpu_torch.parallel.collective` and `ydb_tpu.parallel.collective`
take the same inputs, made from a seeded numpy generator: the target
shard of every row (`bucket_of`: splitmix64 / hash_combine of the keys
mod ndev as uint64), the send segments (`bucket_segments`, and the port's
one-pass `route_segments`), and the compaction of received segments
(`compact_segments`). Targets, counts, the overflow flag and every live
slot (data and valid) must be equal bit for bit; the exchange over an
8-shard mesh must hand each shard what the reference's `all_to_all`
does. On the CPU the port runs the plain versions of the `segments` and
`compact` kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydb_tpu.parallel import collective as RC

from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.torch_ns import to_tensor
from ydb_tpu_torch.parallel import collective as PC
from ydb_tpu_torch.parallel import make_mesh
from tests import torch_threads  # noqa: F401,E402

CAP = 1024

# every column kind of core/dtypes as its storage dtype
DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8,
          np.uint16, np.uint32, np.uint64, np.float32, np.float64]


def _column(rng, dt, n):
    dt = np.dtype(dt)
    if dt == np.bool_:
        return rng.random(n) < 0.5
    if dt.kind == "f":
        return (rng.normal(size=n) * 1e3).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def _keys(rng, nkeys, nulls):
    """int64 keys with negative values, some NULL when `nulls`."""
    out = []
    for i in range(nkeys):
        d = rng.integers(-(1 << 40), 1 << 40, CAP).astype(np.int64)
        d[:7] = [0, -1, 1, np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                 -12345, 12345]
        v = (rng.random(CAP) < 0.8) if nulls else None
        out.append((f"k{i}", d, v))
    return out


def _envs(cols):
    """The same columns as a reference env and a port env."""
    ref, port = {}, {}
    for name, d, v in cols:
        ref[name] = (jnp.asarray(d), None if v is None else jnp.asarray(v))
        port[name] = (to_tensor(d, "cpu"),
                      None if v is None else to_tensor(v, "cpu"))
    return ref, port


def _host(t, like):
    """A port tensor as the reference's host array (storage dtypes
    restored)."""
    a = t.numpy()
    like = np.dtype(like)
    if like == np.uint64:
        return a.view(np.uint64)
    return a.astype(like)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("ndev", [3, 4, 8])
@pytest.mark.parametrize("nkeys", [1, 2, 3])
def test_bucket_of_matches_reference(nkeys, ndev, nulls):
    rng = np.random.default_rng(100 * nkeys + 10 * ndev + nulls)
    cols = _keys(rng, nkeys, nulls)
    ref, port = _envs(cols)
    names = [c[0] for c in cols]
    want = np.asarray(RC.bucket_of(ref, names, ndev))
    got = PC.bucket_of(port, names, ndev)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == set(range(ndev))


def test_bucket_of_float_and_code_keys():
    """Float keys route by their value converted to int64 as XLA converts
    it (truncated; NaN to 0; ±inf and values past ±2^63 saturated), and
    dictionary codes (int32) by their value."""
    rng = np.random.default_rng(7)
    f = rng.normal(size=CAP) * 1e6
    f[:11] = [-0.5, 0.5, -2.75, 3.25, np.nan, np.inf, -np.inf, 1e300,
              -1e300, 9.3e18, -0.0]
    codes = rng.integers(-1, 500, CAP).astype(np.int32)
    cols = [("f", f, None), ("c", codes, rng.random(CAP) < 0.9)]
    ref, port = _envs(cols)
    for names in (["f"], ["c"], ["f", "c"]):
        want = np.asarray(RC.bucket_of(ref, names, 4))
        np.testing.assert_array_equal(
            PC.bucket_of(port, names, 4).numpy(), want)


def test_hashes_past_two_to_the_63_and_uint64_modulo():
    """Half the splitmix64 hashes are >= 2^63: the port's uint64 `%` on
    int64 bits equals numpy's uint64 remainder for every ndev."""
    rng = np.random.default_rng(3)
    x = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 4096)
    h = K.splitmix64_plain(torch.from_numpy(x))
    hu = h.numpy().view(np.uint64)
    assert (hu >= np.uint64(1 << 63)).mean() > 0.4
    for n in (3, 4, 5, 7, 8, 256):
        np.testing.assert_array_equal(
            K.umod64_plain(h, n).numpy(), (hu % np.uint64(n)).astype(
                np.int64))


def _segment_case(rng, ndev, length):
    keys = _keys(rng, 2, True)
    data = [(f"c{i}", _column(rng, dt, CAP),
             (rng.random(CAP) < 0.7) if i % 2 else None)
            for i, dt in enumerate(DTYPES)]
    return keys, data


def _assert_segments_equal(got, want, names, counts, dtypes):
    (gd, gv, gc, go), (wd, wv, wc, wo) = got, want
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert bool(go) == bool(wo)
    wd, wv = jax.device_get((wd, wv))
    for n, dt in zip(names, dtypes):
        for t, c in enumerate(counts):
            np.testing.assert_array_equal(_host(gd[n][t][:c], dt),
                                          wd[n][t][:c])
            np.testing.assert_array_equal(gv[n][t][:c].numpy(),
                                          wv[n][t][:c])
        # past each count: zero, and not valid
        for t, c in enumerate(counts):
            assert not gv[n][t][c:].any()
            assert not gd[n][t][c:].to(torch.float64).any()


@pytest.mark.parametrize("clamped", [False, True])
@pytest.mark.parametrize("ndev", [3, 4, 8])
def test_bucket_segments_matches_reference(ndev, clamped):
    """Every column dtype; `seg` below the largest count clamps the
    counts and raises the overflow flag, as the reference's does."""
    rng = np.random.default_rng(20 * ndev + clamped)
    length = 901
    keys, data = _segment_case(rng, ndev, length)
    ref, port = _envs(keys + data)
    knames = [k[0] for k in keys]
    names = [c[0] for c in data]
    bucket_r = RC.bucket_of(ref, knames, ndev)
    live = np.bincount(np.asarray(bucket_r)[:length], minlength=ndev)
    seg = int(live.max()) - 3 if clamped else CAP
    want = RC.bucket_segments(ref, bucket_r, jnp.int32(length), CAP, seg,
                              ndev, names)
    got = PC.bucket_segments(port, PC.bucket_of(port, knames, ndev),
                             length, CAP, seg, ndev, names)
    counts = np.minimum(live, seg)
    assert bool(want[3]) == clamped
    _assert_segments_equal(got, want, names, counts, DTYPES)
    # the one-pass form (the kernel hashes as it bins) gives the same
    one = PC.route_segments(port, knames, length, CAP, seg, ndev, names)
    _assert_segments_equal(one, want, names, counts, DTYPES)


@pytest.mark.parametrize("length", [0, CAP])
def test_bucket_segments_at_the_edges(length):
    rng = np.random.default_rng(length + 1)
    keys, data = _segment_case(rng, 4, length)
    ref, port = _envs(keys + data)
    knames = [k[0] for k in keys]
    names = [c[0] for c in data]
    bucket_r = RC.bucket_of(ref, knames, 4)
    want = RC.bucket_segments(ref, bucket_r, jnp.int32(length), CAP, CAP,
                              4, names)
    got = PC.route_segments(port, knames, length, CAP, CAP, 4, names)
    counts = np.bincount(np.asarray(bucket_r)[:length], minlength=4)
    assert counts.sum() == length
    _assert_segments_equal(got, want, names, counts, DTYPES)


@pytest.mark.parametrize("ndev", [3, 4, 8])
def test_compact_segments_matches_reference(ndev):
    rng = np.random.default_rng(ndev)
    seg = 64
    counts = rng.integers(0, seg + 1, ndev).astype(np.int32)
    counts[0] = 0
    d = rng.integers(-1000, 1000, (ndev, seg)).astype(np.int64)
    v = rng.random((ndev, seg)) < 0.8
    want_env, want_n = RC.compact_segments(
        {"x": jnp.asarray(d)}, {"x": jnp.asarray(v)}, jnp.asarray(counts),
        seg, ndev, ["x"])
    got_env, got_n = PC.compact_segments(
        {"x": torch.from_numpy(d)}, {"x": torch.from_numpy(v)},
        torch.from_numpy(counts), seg, ndev, ["x"])
    n = int(want_n)
    assert int(got_n) == n == counts.sum()
    np.testing.assert_array_equal(got_env["x"][0][:n].numpy(),
                                  np.asarray(want_env["x"][0])[:n])
    np.testing.assert_array_equal(got_env["x"][1][:n].numpy(),
                                  np.asarray(want_env["x"][1])[:n])


def test_exchange_over_an_eight_shard_mesh_matches_all_to_all():
    """route → exchange → compact on every shard of an 8-shard mesh
    equals the reference's bucket → segments → all_to_all → compact
    under shard_map on its 8-device mesh."""
    from jax.sharding import PartitionSpec as P

    from ydb_tpu.parallel import make_mesh as ref_mesh
    from ydb_tpu.parallel._compat import shard_map

    ndev, cap, seg = 8, 256, 96
    rng = np.random.default_rng(8)
    k = rng.integers(-500, 500, (ndev, cap)).astype(np.int64)
    x = rng.normal(size=(ndev, cap))
    xv = rng.random((ndev, cap)) < 0.9
    lengths = rng.integers(0, cap + 1, ndev).astype(np.int32)
    names = ["k", "x"]

    def body(k, x, xv, ln):
        env = {"k": (k[0], None), "x": (x[0], xv[0])}
        b = RC.bucket_of(env, ["k"], ndev)
        sd, sv, c, ovf = RC.bucket_segments(env, b, ln[0], cap, seg, ndev,
                                            names)
        rd, rv, rc = RC.exchange_segments(sd, sv, c, names)
        env2, tot = RC.compact_segments(rd, rv, rc, seg, ndev, names)
        return (env2["k"][0][None], env2["x"][0][None], env2["x"][1][None],
                tot[None], ovf[None])

    fn = jax.jit(shard_map(
        body, mesh=ref_mesh(ndev), in_specs=(P("shards", None),) * 3
        + (P("shards"),), out_specs=(P("shards", None),) * 3
        + (P("shards"), P("shards")), check_vma=False))
    wk, wx, wxv, wtot, wovf = jax.device_get(fn(k, x, xv, lengths))
    assert not wovf.any()

    mesh = make_mesh(ndev, device="cpu")
    devices = list(mesh.devices.flat)
    sends = []
    for s in range(ndev):
        env = {"k": (torch.from_numpy(k[s]), None),
               "x": (torch.from_numpy(x[s]), torch.from_numpy(xv[s]))}
        sd, sv, c, ovf = PC.route_segments(env, ["k"], int(lengths[s]),
                                           cap, seg, ndev, names)
        assert not bool(ovf)
        sends.append((sd, sv, c))
    for t, (rd, rv, rc) in enumerate(PC.exchange_segments(sends, names,
                                                          devices)):
        env2, tot = PC.compact_segments(rd, rv, rc, seg, ndev, names)
        n = int(tot)
        assert n == wtot[t]
        np.testing.assert_array_equal(env2["k"][0][:n].numpy(), wk[t][:n])
        np.testing.assert_array_equal(env2["x"][0][:n].numpy(), wx[t][:n])
        np.testing.assert_array_equal(env2["x"][1][:n].numpy(), wxv[t][:n])


def test_exchange_across_devices_equals_one_device():
    """Shards on different devices take the per-segment copies; the
    result equals the one-device exchange (CPU devices 'cpu' and 'cpu:0'
    compare unequal, so the mesh below has no shared device)."""
    rng = np.random.default_rng(11)
    ndev, seg = 4, 16
    devices = [torch.device("cpu", 0) if i % 2 else torch.device("cpu")
               for i in range(ndev)]
    sends = [({"a": torch.from_numpy(rng.integers(0, 99, (ndev, seg)))},
              {"a": torch.from_numpy(rng.random((ndev, seg)) < 0.5)},
              torch.from_numpy(rng.integers(0, seg + 1, ndev)
                               .astype(np.int32)))
             for _ in range(ndev)]
    one = PC.exchange_segments(sends, ["a"], [torch.device("cpu")] * ndev)
    many = PC.exchange_segments(sends, ["a"], devices)
    for (d1, v1, c1), (d2, v2, c2) in zip(one, many):
        assert torch.equal(d1["a"], d2["a"]) and torch.equal(v1["a"],
                                                             v2["a"])
        assert torch.equal(c1, c2)


def test_gather_all_receives_every_shard():
    rng = np.random.default_rng(5)
    ndev, seg = 4, 32
    devices = list(make_mesh(ndev, device="cpu").devices.flat)
    per_dev, want = [], []
    for s in range(ndev):
        d = torch.from_numpy(rng.integers(0, 100, seg))
        c = int(rng.integers(0, seg + 1))
        per_dev.append(({"a": d}, {"a": torch.ones(seg, dtype=torch.bool)},
                        torch.tensor(c, dtype=torch.int32)))
        want.append(d[:c].numpy())
    outs = PC.gather_all(per_dev, seg, ["a"], devices)
    assert len(outs) == ndev
    for env, tot in outs:
        n = int(tot)
        np.testing.assert_array_equal(env["a"][0][:n].numpy(),
                                      np.concatenate(want))


def test_segment_pad_account_matches_reference():
    args = ("shuffle_segments", 8, 128, 700, 17.0)
    assert PC.segment_pad_account(*args) == RC.segment_pad_account(*args)


def test_make_mesh_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: make_mesh() takes its cards")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(4)
    mesh = make_mesh(4, device="cpu")
    assert mesh.devices.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
