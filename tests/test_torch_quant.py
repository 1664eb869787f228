"""K15d, the DQ plane's int8 block codec: the port's `quantize_blocked` /
`dequantize_blocked` (`ydb_tpu_torch/parallel/collective.py` over the
`quant` kernel's wrappers; their plain versions on the CPU) against the
reference's JAX functions (`ydb_tpu/parallel/collective.py`) on the same
seeded numpy inputs: codes and scales bit for bit, the dequantized
values bit for bit (NaN for NaN), for float64 and float32, over [ndev,
seg] shapes with NaN, +-inf, all-zero blocks, exact half-way ties,
the smallest normal magnitudes and 0 rows."""

import numpy as np
import pytest
import torch

from ydb_tpu.parallel import collective as RC
from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.parallel import collective as PC
from tests import torch_threads  # noqa: F401,E402


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 13.0).astype(dtype)
    if x.size == 0:
        return x
    flat = x.reshape(-1)
    blocks = flat.size // 128
    # ties: values whose quotient by the block's scale lands on k + 1/2
    flat[:128] = (np.arange(128) - 64 + 0.5).astype(dtype)
    flat[127] = 127.0
    if blocks > 1:
        flat[130] = np.nan
        flat[131] = np.inf                  # an inf block: scale inf
    if blocks > 2:
        flat[256:384] = 0.0                 # an all-zero block: scale 1
    if blocks > 3:
        flat[384 + 5] = -np.inf
        flat[384 + 6] = np.nan
    if blocks > 4:
        flat[512:640] = np.nan              # an all-NaN block
    if blocks > 5:
        # the smallest normal magnitudes (subnormals: see
        # test_subnormal_f32_inputs_stay_exact_where_xla_cpu_flushes)
        tiny = 1e-300 if dtype == np.float64 else 1e-35
        flat[640:768] = tiny * np.where(rng.random(128) < 0.5, -1, 1) \
            * (1.0 + rng.random(128))
    return x


SHAPES = [(4, 1024), (1, 128), (4, 0), (3, 896)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"{a}x{b}" for a, b in SHAPES])
def test_codec_bit_equal_to_reference(dtype, shape):
    import jax.numpy as jnp
    x = _inputs(shape, dtype, seed=sum(shape) + (dtype == np.float32))
    rq, rs = RC.quantize_blocked(jnp.asarray(x))
    pq, ps = PC.quantize_blocked(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert np.array_equal(pq.numpy(), np.asarray(rq))
    assert tuple(ps.shape) == tuple(rs.shape)
    assert np.array_equal(ps.numpy().view(np.int32),
                          np.asarray(rs).view(np.int32))
    rb = np.asarray(RC.dequantize_blocked(rq, rs, dtype))
    pb = PC.dequantize_blocked(pq, ps, dtype).numpy()
    assert pb.dtype == rb.dtype
    assert np.array_equal(np.isnan(pb), np.isnan(rb))
    assert np.array_equal(pb[~np.isnan(pb)].view(np.uint8),
                          rb[~np.isnan(rb)].view(np.uint8))


def test_inf_block_codes_are_zero_and_decode_to_nan():
    """A block holding +-inf has an inf scale: its finite values divide
    to 0 and its infinities to NaN, which XLA's float -> int8 conversion
    makes 0; every value of the block decodes to NaN (0 * inf)."""
    x = np.full((1, 128), 3.0)
    x[0, 0], x[0, 1] = np.inf, -np.inf
    q, s = K.quantize_blocked_plain(torch.from_numpy(x))
    assert float(s[0, 0]) == np.inf
    assert (q == 0).all()
    assert torch.isnan(K.dequantize_blocked_plain(q, s, torch.float64)).all()


def test_subnormal_f32_inputs_stay_exact_where_xla_cpu_flushes():
    """A parity difference by design (ROADMAP Queue 3): XLA's CPU
    flushes float32 subnormals to zero, so the reference encodes a block
    of them as zeros with scale 1; the port divides them as IEEE numbers
    on the CPU and on the card alike, so they round-trip within the
    block's step."""
    import jax.numpy as jnp
    x = (np.linspace(-1, 1, 128) * 1e-40).astype(np.float32)[None]
    rq, rs = RC.quantize_blocked(jnp.asarray(x))
    assert float(np.asarray(rs)[0, 0]) == 1.0
    assert not np.asarray(rq).any()
    q, s = PC.quantize_blocked(torch.from_numpy(x))
    assert 0 < float(s[0, 0]) < 1e-41
    back = PC.dequantize_blocked(q, s, np.float32).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=float(s[0, 0]))


def test_quantize_blocked_roundtrip_with_nan():
    """The reference's `test_quantize_blocked_roundtrip_with_nan`,
    ported: NaN survives, the all-zero block decodes to zeros, every
    other value within half a quantization step of its block."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 256)) * 13.0
    x[1, 3] = np.nan
    x[2, :] = 0.0                             # all-zero block: scale 1
    q, s = PC.quantize_blocked(torch.from_numpy(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == (4, 2)
    back = PC.dequantize_blocked(q, s, np.float64).numpy()
    assert np.isnan(back[1, 3]) and not np.isnan(back[1, 4])
    finite = ~np.isnan(x)
    np.testing.assert_allclose(back[finite], x[finite],
                               atol=float(np.nanmax(np.abs(x)) / 127))
    assert (back[2, :] == 0).all()


def test_wrappers_take_the_plain_version_on_the_cpu_only(monkeypatch):
    """On CPU tensors the wrappers run their plain versions; nothing
    else does (the kernel path is the card's)."""
    x = torch.from_numpy(_inputs((2, 256), np.float64, 3))
    q, s = K.quantize_blocked(x)
    pq, ps = K.quantize_blocked_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    calls = []
    real = K.dequantize_blocked_plain
    monkeypatch.setattr(K, "dequantize_blocked_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    K.dequantize_blocked(q, s, torch.float64)
    assert calls == [1]


def test_counts_plain_equals_reference_counts_program():
    """The count exchange's plain version against the reference's
    compiled count programs (`dq/ici.py _build_counts_fn`,
    `_build_counts_batched_fn`) on planes with -1 rows."""
    import jax.numpy as jnp
    from ydb_tpu.dq import ici as RI
    rng = np.random.default_rng(9)
    planes = rng.integers(-1, 4, size=(2, 4, 1000)).astype(np.int32)
    want = np.asarray(RI._build_counts_batched_fn(4, 2, 1000)(
        jnp.asarray(planes)))
    got = K.dq_counts(torch.from_numpy(planes), 4).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    solo = np.asarray(RI._build_counts_fn(4, 1000)(jnp.asarray(planes[1])))
    assert np.array_equal(K.dq_counts(torch.from_numpy(planes[1:]), 4)[0]
                          .numpy(), solo)


def test_bucket_plane_plain_routes_like_the_host_plane():
    """The bucket plane's plain version: splitmix64 mod ndev as the host
    plane's `key_buckets` routes ints, a LUT for dictionary codes, -1
    past each producer's length and on NULL keys."""
    from ydb_tpu_torch.cluster.exchange import key_buckets
    rng = np.random.default_rng(4)
    keys = rng.integers(-(1 << 62), 1 << 62, size=(3, 500))
    valid = rng.random((3, 500)) > 0.2
    lengths = np.array([500, 17, 0], np.int32)
    got = K.dq_bucket_plane(torch.from_numpy(keys), torch.from_numpy(valid),
                            torch.from_numpy(lengths), 5).numpy()
    for p in range(3):
        want = key_buckets(keys[p], 5, "int").astype(np.int32)
        act = (np.arange(500) < lengths[p]) & valid[p]
        assert np.array_equal(got[p], np.where(act, want, -1))
    codes = rng.integers(-3, 12, size=(2, 64)).astype(np.int32)
    lut = torch.tensor([3, 1, 0, 2, 2, 1, 0, 3, 1, 1], dtype=torch.int32)
    got = K.dq_bucket_plane(torch.from_numpy(codes), None,
                            torch.tensor([64, 64], dtype=torch.int32), 4,
                            lut).numpy()
    assert np.array_equal(got, lut.numpy()[np.clip(codes, 0, 9)])
