"""K16's bucket plane and K15d's quantizer as their CUDA kernels compute
them, on the CPU.

The plain versions (`dq_bucket_plane_plain`, `quantize_blocked_plain`)
against the JAX package at the shapes the kernels find hard: caps that
are odd or not a multiple of 8 (1, 7, 70,001), lengths of 0, of one row
and of a partial last tile, a valid mask, dictionary codes through a
LUT, ndev 1, 3, 4, 5 and 1,024; float32 and float64 blocks with NaN,
+-inf, exact ties, all-zero and subnormal values. (XLA's CPU flushes
subnormals, float64 ones too, so a block of them is held against the
IEEE formula instead: the parity difference ROADMAP Queue 3 records.)

Then emulations of the kernels' arithmetic, held against the plain
versions bit for bit: the plane's grid of (row tiles, producer), its
head row, row pairs at even flat rows, pairs past the length stored
without a load, pairs across it row by row, and the modulo as a mask or
%; the quantizer's persistent walk over `qgrid`'s grid (every quant
block once), a warp's lane layout (float64 pairs at a 64-value stride),
the max-abs and the float64 lanes' code trade before their 32-bit
stores. The plane's `#define`s against `bindings.py`, the quantizer's
read from `quant.cu` by the walk. On fake CUDA tensors
(`FakeTensorMode`, no card) the
wrappers launch and never take the plain versions, and refuse views
whose storage offset breaks the vector accesses.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydb_tpu.cluster.exchange import key_buckets
from ydb_tpu.parallel import collective as RC
from ydb_tpu.utils.hashing import splitmix64
from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.cuda import build
from tests import torch_threads  # noqa: F401,E402

NPROD = 4
WARP_ROWS = 256                  # rows of a warp: 4 pairs at a 64-row stride


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: real CUDA tensors launch the kernel")


# ------------------------------------------------------------ the plane


def _lengths(cap: int) -> np.ndarray:
    """0, one row, a partial last tile (or the cap less one) and the cap."""
    tile = K._PLANE_THREADS * K._PLANE_ROWS
    partial = cap - 1 if cap <= tile else cap - tile // 2 - 4
    return np.array([0, min(1, cap), max(partial, 0), cap], np.int32)


def _keys(cap: int, seed: int):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(1 << 63), (1 << 63) - 1, size=(NPROD, cap),
                        dtype=np.int64)
    flat = keys.reshape(-1)
    edge = np.array([0, -1, 1, (1 << 63) - 1, -(1 << 63), 2, 3, 4],
                    np.int64)
    flat[:min(len(edge), flat.size)] = edge[:flat.size]
    valid = rng.random((NPROD, cap)) > 0.25
    return keys, valid


def _reference_plane(keys, valid, lengths, ndev: int) -> np.ndarray:
    """The JAX package's bucket plane (dq/ici.py:763-783)."""
    h = splitmix64(jnp, jnp.asarray(keys))
    bucket = np.asarray((h % jnp.uint64(ndev)).astype(jnp.int32))
    active = np.arange(keys.shape[1])[None, :] < lengths[:, None]
    if valid is not None:
        active = active & valid
    return np.where(active, bucket, -1).astype(np.int32)


CAPS = [1, 7, 70_001]
NDEVS = [1, 3, 4, 5, 1024]


@pytest.mark.parametrize("with_valid", [False, True], ids=["novalid",
                                                           "valid"])
@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("cap", CAPS)
def test_plane_plain_equals_reference(cap, ndev, with_valid):
    keys, valid = _keys(cap, seed=cap + ndev)
    valid = valid if with_valid else None
    lengths = _lengths(cap)
    got = K.dq_bucket_plane(
        torch.from_numpy(keys),
        None if valid is None else torch.from_numpy(valid),
        torch.from_numpy(lengths), ndev).numpy()
    want = _reference_plane(keys, valid, lengths, ndev)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # the host plane routes the live rows the same way
    live = got[NPROD - 1] >= 0
    assert np.array_equal(
        got[NPROD - 1][live],
        key_buckets(keys[NPROD - 1][live], ndev, "int").astype(np.int32))


@pytest.mark.parametrize("cap", CAPS)
def test_plane_codes_plain_equals_reference(cap):
    """Dictionary codes through a LUT, as the JAX package takes them
    (`jnp.take(blut, clip(code, 0, len - 1))`), codes below 0 and past
    the LUT included."""
    rng = np.random.default_rng(cap)
    codes = rng.integers(-3, 40, size=(NPROD, cap)).astype(np.int32)
    blut = rng.integers(0, 5, size=37).astype(np.int32)
    lengths = _lengths(cap)
    got = K.dq_bucket_plane(torch.from_numpy(codes), None,
                            torch.from_numpy(lengths), 5,
                            torch.from_numpy(blut)).numpy()
    bucket = np.asarray(jnp.take(jnp.asarray(blut), jnp.clip(
        jnp.asarray(codes), 0, len(blut) - 1)))
    active = np.arange(cap)[None, :] < lengths[:, None]
    assert np.array_equal(got, np.where(active, bucket, -1))


def _splitmix(k: np.ndarray) -> np.ndarray:
    u = k.view(np.uint64).copy()
    u = (u ^ (u >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    u = (u ^ (u >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return u ^ (u >> np.uint64(31))


def _plane_emulation(keys, valid, lengths, ndev, lut=None):
    """dq_counts.cu's bucket_plane_kernel: per producer (blockIdx.y) its
    length clamped to [0, cap], a head row where p * cap is odd, then
    the pairs of rows at even flat rows (a thread's 4 pairs at a 64-row
    stride cover a tile's rows once); a pair inside the length is one
    vector load and store, one past it a store of -1 with no load, one
    across it (or a last lone row) row by row. Returns the plane and the
    rows whose key was loaded; asserts every row is written once and
    every vector access sits at an even flat row."""
    nprod, cap = keys.shape
    plan = K.bucket_plane_plan(nprod, cap)
    tiles, grid_y = plan["grid"]
    tile = plan["tile"]
    assert grid_y == nprod and tile == K._PLANE_THREADS * K._PLANE_ROWS
    # the pair starts of a tile, thread by thread: warp w, lane l, pair j
    t = np.arange(K._PLANE_THREADS)
    j = np.arange(K._PLANE_ROWS // 2)
    in_tile = ((t // 32) * WARP_ROWS + 2 * (t % 32))[:, None] + 64 * j
    assert np.array_equal(np.sort(in_tile.reshape(-1)),
                          np.arange(0, tile, 2))
    pow2 = ndev & (ndev - 1) == 0
    out = np.full((nprod, cap), 0x5A5A5A5A, np.int64)   # as empty leaves it
    writes = np.zeros((nprod, cap), np.int64)
    loaded = np.zeros((nprod, cap), bool)

    def route(k):
        if lut is not None:
            return lut[np.clip(k, 0, len(lut) - 1)].astype(np.int64)
        h = _splitmix(k.astype(np.int64))
        b = h & np.uint64(ndev - 1) if pow2 else h % np.uint64(ndev)
        return b.astype(np.int64)

    for p in range(nprod):
        base = p * cap
        head = base & 1
        assert plan["heads"][p] == head
        ln = int(min(max(int(lengths[p]), 0), cap))
        live = np.ones(cap, bool) if valid is None else valid[p].copy()

        def rows(rs, p=p, ln=ln, live=live):   # one row at a time
            rs = rs[rs < cap]
            on = rs[(rs < ln)]
            on = on[live[on]]
            loaded[p, on] = True
            out[p, rs] = -1
            out[p, on] = route(keys[p, on])
            writes[p, rs] += 1
        if head:
            rows(np.array([0]))
        r = (head + np.arange(tiles)[:, None] * tile
             + in_tile.reshape(-1)[None, :]).reshape(-1)
        full = r + 2 <= ln
        dead = (r >= ln) & (r + 2 <= cap)
        edge = ~full & ~dead
        for rr in (r[full], r[dead]):
            assert ((base + rr) % 2 == 0).all()
        f = r[full]
        loaded[p, f] = loaded[p, f + 1] = True
        for off in (0, 1):
            out[p, f + off] = np.where(live[f + off],
                                       route(keys[p, f + off]), -1)
            out[p, r[dead] + off] = -1
            writes[p, f + off] += 1
            writes[p, r[dead] + off] += 1
        rows(r[edge])
        rows(r[edge] + 1)
    assert (writes == 1).all()
    return out.astype(np.int32), loaded


@pytest.mark.parametrize("with_valid", [False, True], ids=["novalid",
                                                           "valid"])
@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("cap", CAPS + [2048 * 3 + 1])
def test_plane_emulation_is_the_plain_version(cap, ndev, with_valid):
    keys, valid = _keys(cap, seed=7 * cap + ndev)
    valid = valid if with_valid else None
    lengths = _lengths(cap)
    got, loaded = _plane_emulation(keys, valid, lengths, ndev)
    want = K.dq_bucket_plane_plain(
        torch.from_numpy(keys),
        None if valid is None else torch.from_numpy(valid),
        torch.from_numpy(lengths), ndev).numpy()
    assert np.array_equal(got, want)
    # nothing loaded past a producer's length
    past = np.arange(cap)[None, :] >= lengths[:, None]
    assert not (loaded & past).any()


def test_plane_emulation_codes_and_clamped_lengths():
    """Codes through a LUT, and lengths outside [0, cap] clamped."""
    rng = np.random.default_rng(3)
    cap = 2048 + 3
    codes = rng.integers(-3, 40, size=(3, cap)).astype(np.int32)
    lut = rng.integers(0, 3, size=37).astype(np.int32)
    lengths = np.array([-5, cap + 100, 2049], np.int32)
    got, loaded = _plane_emulation(codes, None, lengths, 3, lut)
    want = K.dq_bucket_plane_plain(
        torch.from_numpy(codes), None,
        torch.from_numpy(np.clip(lengths, 0, cap)), 3,
        torch.from_numpy(lut)).numpy()
    assert np.array_equal(got, want)
    assert not loaded[0].any() and loaded[1].all()


def test_bucket_plane_plan_at_the_recorded_shape():
    """q5's lineitem edge: [4, 1,572,864] keys, 768 tiles of 2,048 rows
    a producer, no head (cap even)."""
    plan = K.bucket_plane_plan(4, 1_572_864)
    assert plan["grid"] == (768, 4) and plan["rows_per_thread"] == 8
    assert plan["heads"] == [0, 0, 0, 0] and plan["launches"] == 1
    assert K.bucket_plane_plan(4, 70_001)["heads"] == [0, 1, 0, 1]
    assert K.bucket_plane_plan(3, 1)["grid"] == (1, 3)


# ------------------------------------------------------------ the quantizer


def _quant_inputs(shape, dtype, seed, subnormal=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 13.0).astype(dtype)
    flat = x.reshape(-1)
    blocks = flat.size // 128
    if blocks == 0:
        return x
    flat[:128] = (np.arange(128) - 64 + 0.5).astype(dtype)   # exact ties
    flat[127] = 127.0
    if blocks > 1:
        flat[130], flat[131] = np.nan, np.inf
    if blocks > 2:
        flat[256:384] = 0.0                  # all zero: scale 1
    if blocks > 3:
        flat[389], flat[390] = -np.inf, np.nan
    if blocks > 4:
        flat[512:640] = np.nan               # all NaN
    if blocks > 5:
        flat[640:768] *= (1e-300 if dtype == np.float64 else 1e-35)
        flat[640:644] = 0.0                  # zeros over an underflown scale
    if blocks > 6:
        flat[768:896] = -0.0
        flat[800] = 2.5                      # one value, -0.0 beside it
    if subnormal and blocks > 7:
        tiny = np.finfo(dtype).smallest_subnormal
        flat[896:1024] = tiny * rng.integers(-40, 41, size=128)
    return x


QSHAPES = [(4, 1024), (1, 128), (4, 0), (3, 896), (2, 128 * 33)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", QSHAPES,
                         ids=[f"{a}x{b}" for a, b in QSHAPES])
def test_quantize_plain_equals_reference(dtype, shape):
    x = _quant_inputs(shape, dtype, seed=shape[1] + (dtype == np.float32))
    rq, rs = RC.quantize_blocked(jnp.asarray(x))
    pq, ps = K.quantize_blocked_plain(torch.from_numpy(x))
    assert np.array_equal(pq.numpy(), np.asarray(rq))
    assert np.array_equal(ps.numpy().view(np.int32),
                          np.asarray(rs).view(np.int32))


def _ieee_quantize(x: np.ndarray):
    """The codec's formula in IEEE numpy arithmetic (no flush)."""
    T = x.dtype.type
    xb = x.reshape(-1, 128)
    nan = np.isnan(xb)
    mag = np.where(nan, T(0), np.abs(xb)).max(axis=1)
    with np.errstate(all="ignore"):
        scale = np.where(mag > 0, mag / T(127), T(1)).astype(np.float32)
        q = np.rint(xb / scale[:, None].astype(x.dtype))
    q = np.where(np.isnan(q), 0, np.clip(q, -127, 127))
    q = np.where(nan, -128, q)
    return q.astype(np.int8).reshape(x.shape), \
        scale.reshape(x.shape[:-1] + (x.shape[-1] // 128,))


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_quantize_subnormal_blocks(dtype):
    """Subnormal blocks: the plain version keeps IEEE arithmetic (as the
    kernel does); the JAX package on XLA's CPU flushes them to zero."""
    tiny = np.finfo(dtype).smallest_subnormal
    x = np.concatenate([tiny * np.arange(-64, 64),
                        np.linspace(-1, 1, 128) * tiny * 1e6]).astype(
        dtype)[None]
    pq, ps = K.quantize_blocked_plain(torch.from_numpy(x))
    wq, ws = _ieee_quantize(x)
    assert np.array_equal(pq.numpy(), wq)
    assert np.array_equal(ps.numpy().view(np.int32), ws.view(np.int32))
    rq, rs = RC.quantize_blocked(jnp.asarray(x))
    assert (np.asarray(rs) == 1.0).all() and not np.asarray(rq).any()


def _define(name: str, src: str) -> int:
    return int(re.search(r"#define " + name + r" (\d+)", src).group(1))


QUANT_SRC = (build.CSRC / "quant.cu").read_text()
QWARPS = _define("QWARPS", QUANT_SRC)
QSM = {np.float64: _define("QSM64", QUANT_SRC),
       np.float32: _define("QSM32", QUANT_SRC)}
H100_SMS = 132                   # an H100 SXM's SMs, for the walk's sizes


def _qgrid(nb: int, bps: int, sms: int) -> int:
    """quant.cu's qgrid: a quant block a warp, at most bps CUDA blocks of
    QWARPS warps an SM."""
    return min(-(-nb // QWARPS), bps * sms)


def _walk(n: int, bps: int, sms: int = H100_SMS) -> None:
    """The persistent grid's walk: warp w of block blk takes quant blocks
    blk * QWARPS + w, then every grid * QWARPS blocks on; every quant
    block is taken once, and the warps' loads of the next block never
    reach past the last."""
    nb = n // 128
    grid = _qgrid(nb, bps, sms)
    warps = grid * QWARPS
    seen = np.zeros(nb, np.int64)
    for blk in range(grid):
        for w in range(QWARPS):
            mine = np.arange(blk * QWARPS + w, nb, warps)
            assert mine.size <= -(-nb // warps)
            seen[mine] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("bps", [1, 5, 8])
@pytest.mark.parametrize("nb", [1, 7, 8 * 132 + 5, 49_152])
def test_quantize_walk_takes_every_block_once(bps, nb):
    _walk(nb * 128, bps)


def _quantize_emulation(x: np.ndarray):
    """quant.cu's quantize_kernel: the persistent walk, a warp a quant
    block, a lane's 4 values (float32 4l..4l+3; float64 2l, 2l+1 and
    64+2l, 65+2l), the max-abs over the lanes, the scale, the codes in
    the lane's order, the float64 lanes' trade by two shuffles, one
    32-bit word a lane."""
    T = x.dtype.type
    n = x.size
    nb = n // 128
    _walk(n, QSM[x.dtype.type])
    xb = x.reshape(nb, 128)
    lane = np.arange(32)
    if x.dtype == np.float64:
        idx = np.stack([2 * lane, 2 * lane + 1, 64 + 2 * lane,
                        65 + 2 * lane], axis=1)
    else:
        idx = 4 * lane[:, None] + np.arange(4)[None, :]
    assert np.array_equal(np.sort(idx.reshape(-1)), np.arange(128))
    v = xb[:, idx]                                   # (nb, lane, 4)
    a = np.where(np.isnan(v), T(0), np.abs(v)).max(axis=2).max(axis=1)
    with np.errstate(all="ignore"):
        # 127 / 127 for an all-zero block; a zero divides nothing
        scale = (np.where(a > 0, a, T(127)) / T(127)).astype(np.float32)
        q = np.rint(v / scale[:, None, None].astype(x.dtype))
    c = np.where(np.isnan(q), 0, np.clip(q, -127, 127))
    c = np.where(v == 0, 0, c)
    c = np.where(np.isnan(v), -128, c).astype(np.int8).view(np.uint8)
    c = c.astype(np.uint32)
    word = c[..., 0] | c[..., 1] << 8 | c[..., 2] << 16 | c[..., 3] << 24
    if x.dtype == np.float64:
        u = word[:, (2 * lane) & 31]
        w = word[:, (2 * lane + 1) & 31]
        word = np.where(lane < 16, (u & 0xFFFF) | (w << 16) & 0xFFFFFFFF,
                        (u >> 16) | (w & 0xFFFF0000))
    codes = np.ascontiguousarray(word, np.uint32).view(np.int8).reshape(
        x.shape)
    return codes, scale.reshape(x.shape[:-1] + (x.shape[-1] // 128,))


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", QSHAPES + [(4, 128 * 1100)],
                         ids=[f"{a}x{b}" for a, b in QSHAPES]
                         + ["4x140800"])
def test_quantize_emulation_is_the_plain_version(dtype, shape):
    x = _quant_inputs(shape, dtype, seed=3 * shape[1], subnormal=True)
    codes, scales = _quantize_emulation(x)
    pq, ps = K.quantize_blocked_plain(torch.from_numpy(x))
    assert np.array_equal(codes, pq.numpy())
    assert np.array_equal(scales.view(np.int32), ps.numpy().view(np.int32))


def test_quantize_grid_at_the_recorded_shape():
    """q5's lineitem send stack: 49,152 quant blocks over 132 SMs' 660
    (float64) or 1,056 (float32) blocks of 8 warps; a small input gets no
    more blocks than it fills. The launcher's qgrid reads as `_qgrid`."""
    nb = 4 * 1_572_864 // 128
    assert QWARPS == 8 and QSM == {np.float64: 5, np.float32: 8}
    assert _qgrid(nb, QSM[np.float64], H100_SMS) == 660
    assert _qgrid(nb, QSM[np.float32], H100_SMS) == 1056
    for bps in QSM.values():
        assert _qgrid(1, bps, H100_SMS) == 1
        assert _qgrid(17, bps, H100_SMS) == 3
    body = re.search(r"static unsigned qgrid\(.*?\n\}", QUANT_SRC,
                     re.S).group(0)
    assert "(nblocks + QWARPS - 1) / QWARPS" in body
    assert "want < (int64_t)bps * sms ? want : (int64_t)bps * sms" in body
    assert QUANT_SRC.count("qgrid(nblocks, QSM64, sms)") == 1
    assert QUANT_SRC.count("qgrid(nblocks, QSM32, sms)") == 1


# --------------------------------------------------------- the sources


def test_source_constants_match_the_bindings():
    define = _define
    dq = (build.CSRC / "dq_counts.cu").read_text()
    assert define("PLANE_THREADS", dq) == K._PLANE_THREADS
    assert define("PLANE_ROWS", dq) == K._PLANE_ROWS
    assert define("PLANE_PAIRS", dq) * 2 == K._PLANE_ROWS
    assert define("PLANE_THREADS", dq) // 32 * WARP_ROWS \
        == K._PLANE_THREADS * K._PLANE_ROWS
    assert define("MAX_TARGETS", dq) == K._DQ_MAX_TARGETS
    assert define("QBLOCK", QUANT_SRC) == K.QUANT_BLOCK


# ------------------------------------------------- fake CUDA tensors


def _fake_launch(monkeypatch):
    launched = []
    monkeypatch.setattr(K, "_launch", lambda name, *a:
                        launched.append((name, a)))
    monkeypatch.setattr(K, "_ptr", lambda t: 0 if t is None else id(t))
    monkeypatch.setattr(K, "_stream", lambda: 0)
    for name in ("dq_bucket_plane_plain", "quantize_blocked_plain"):
        monkeypatch.setattr(K, name, lambda *a, _n=name, **k: pytest.fail(
            f"a CUDA tensor took {_n}"))
    return launched


@pytest.mark.parametrize("kind", ["int", "int_valid", "codes"])
def test_bucket_plane_launches_on_cuda_tensors(monkeypatch, kind):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    cap = 70_001
    with FakeTensorMode():
        cuda = dict(device="cuda")
        lut = valid = None
        if kind == "codes":
            keys = torch.empty((NPROD, cap), dtype=torch.int32, **cuda)
            lut = torch.empty(37, dtype=torch.int32, **cuda)
        else:
            keys = torch.empty((NPROD, cap), dtype=torch.int64, **cuda)
        if kind == "int_valid":
            valid = torch.empty((NPROD, cap), dtype=torch.bool, **cuda)
        lengths = torch.empty(NPROD, dtype=torch.int32, **cuda)
        plane = K.dq_bucket_plane(keys, valid, lengths, 3, lut)
    (name, a), = launched
    assert name == "dq_bucket_plane" and plane.shape == (NPROD, cap)
    assert a[:3] == (cap, NPROD, int(kind == "codes"))
    assert a[3] == id(keys) and a[5] == id(lengths) and a[9] == id(plane)
    assert a[4] == (0 if valid is None else id(valid))
    assert a[7] == (37 if kind == "codes" else 0) and a[8] == 3


def test_quantize_launches_on_cuda_tensors(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    with FakeTensorMode():
        x = torch.empty((4, 1024), dtype=torch.float64, device="cuda")
        codes, scales = K.quantize_blocked(x)
        y = torch.empty(256 + 4, dtype=torch.float32, device="cuda")
        K.quantize_blocked(y.narrow(0, 4, 256))   # 16 bytes in: aligned
    assert [n for n, _a in launched] == ["quantize_blocked"] * 2
    a = launched[0][1]
    assert a[:2] == (4096, 0) and a[2] == id(x)
    assert a[3] == id(codes) and a[4] == id(scales)
    assert codes.shape == (4, 1024) and scales.shape == (4, 8)


def test_misaligned_views_are_refused(monkeypatch):
    """A contiguous view with a storage offset off the kernels' vector
    accesses raises; nothing is launched and no plain version runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    cap = 7
    with FakeTensorMode():
        cuda = dict(device="cuda")
        lengths = torch.empty(NPROD, dtype=torch.int32, **cuda)
        buf = torch.empty(NPROD * cap + 2, dtype=torch.int64, **cuda)
        keys = buf.narrow(0, 1, NPROD * cap).view(NPROD, cap)
        with pytest.raises(ValueError, match="keys: storage offset 1"):
            K.dq_bucket_plane(keys, None, lengths, 4)
        ok = buf.narrow(0, 2, NPROD * cap).view(NPROD, cap)
        vbuf = torch.empty(NPROD * cap + 1, dtype=torch.bool, **cuda)
        valid = vbuf.narrow(0, 1, NPROD * cap).view(NPROD, cap)
        with pytest.raises(ValueError, match="valid: storage offset 1"):
            K.dq_bucket_plane(ok, valid, lengths, 4)
        cbuf = torch.empty(NPROD * cap + 1, dtype=torch.int32, **cuda)
        codes = cbuf.narrow(0, 1, NPROD * cap).view(NPROD, cap)
        lut = torch.empty(5, dtype=torch.int32, **cuda)
        with pytest.raises(ValueError, match="keys: storage offset 1"):
            K.dq_bucket_plane(codes, None, lengths, 4, lut)
        xbuf = torch.empty(256 + 2, dtype=torch.float32, **cuda)
        with pytest.raises(ValueError, match="x: storage offset 2"):
            K.quantize_blocked(xbuf.narrow(0, 2, 256))
        dbuf = torch.empty(256 + 1, dtype=torch.float64, **cuda)
        with pytest.raises(ValueError, match="x: storage offset 1"):
            K.quantize_blocked(dbuf.narrow(0, 1, 256))
        K.dq_bucket_plane(ok, None, lengths, 4)          # even: taken
    assert [n for n, _a in launched] == ["dq_bucket_plane"]
