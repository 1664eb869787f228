"""K16's count exchange (`dq_counts`, ``ops/cuda/csrc/dq_counts.cu``) as
its one-launch kernel computes it, on the CPU.

- The plain version (`dq_counts_plain`) against the JAX package's
  `_build_counts_fn` (one channel) and `_build_counts_batched_fn` (the
  channels of a stage) at ragged caps, ndev 1, 3, 4, 8, 9, 32, 33 and
  1,024 (every counting mode and its edges), 1 to 3 channels, planes of
  only -1 and values >= ndev (which count nowhere).
- A numpy emulation of the kernel, held against the plain version: the
  grid of `dq_counts_plan`, each row's head before its first 16-byte
  boundary, its whole vectors taken by the blocks in steps of
  COUNT_THREADS x COUNT_LOADS, its tail; every value read once; the
  counting modes (counters in registers past ndev discarded, the
  shared histogram's valid values); the partials in
  (target, block) order written by every block; the ticket of each row
  drawn in a random order, the last block folding the row and leaving
  its word zero; partials poisoned as `torch.empty` leaves them.
- The plan at the recorded shapes, the `#define`s against the bindings,
  the C entry's parameters against the ctypes signature, and no shared
  atomic a row left in the source.
- On fake CUDA tensors (`FakeTensorMode`, no card) the wrapper makes one
  launch a call with no zero fill of its output (the ticket words are
  zeroed once a stream, shared with the keyless aggregate's and grown
  when too few), and never takes the plain version.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydb_tpu.dq import ici as rici
from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.cuda import build
from tests import torch_threads  # noqa: F401,E402

SRC = (build.CSRC / "dq_counts.cu").read_text()
NPROD = 4
NDEVS = [1, 3, 4, 8, 9, 32, 33, 1024]
CAPS = [0, 1, 7, 4_099, 70_001]
SEED = 20261018


def _define(name: str) -> int:
    return int(re.search(r"#define " + name + r" (\d+)", SRC).group(1))


def _planes(nch: int, cap: int, ndev: int, seed: int,
            kind: str = "mixed") -> np.ndarray:
    """[nch, NPROD, cap] int32: targets, -1 rows and values >= ndev; or
    only -1."""
    rng = np.random.default_rng([seed, nch, cap, ndev])
    if kind == "empty":
        return np.full((nch, NPROD, cap), -1, np.int32)
    p = rng.integers(-1, ndev + 3, size=(nch, NPROD, cap)).astype(np.int32)
    flat = p.reshape(-1)
    edge = np.array([np.iinfo(np.int32).max, np.iinfo(np.int32).min, ndev,
                     ndev - 1, 0, -1], np.int32)
    flat[:min(edge.size, flat.size)] = edge[:flat.size]
    # a producer's tail past its length routes nowhere
    for c in range(nch):
        for q in range(NPROD):
            p[c, q, rng.integers(0, cap + 1):] = -1
    return p


# ---------------------------------------------- the plain version


@pytest.mark.parametrize("kind", ["mixed", "empty"])
@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("cap", [1, 7, 4_099])
def test_counts_plain_equals_reference(cap, ndev, kind):
    planes = _planes(1, cap, ndev, SEED, kind)
    want = np.asarray(rici._build_counts_fn(ndev, cap)(
        jnp.asarray(planes[0])))
    got = K.dq_counts_plain(torch.from_numpy(planes), ndev).numpy()
    assert got.dtype == np.int32 and got.shape == (1, NPROD, ndev)
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("ndev", [3, 4, 33])
@pytest.mark.parametrize("nch", [2, 3])
def test_batched_counts_plain_equals_reference(nch, ndev):
    cap = 70_001
    planes = _planes(nch, cap, ndev, SEED)
    want = np.asarray(rici._build_counts_batched_fn(ndev, nch, cap)(
        jnp.asarray(planes)))
    got = K.dq_counts_plain(torch.from_numpy(planes), ndev).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------- the kernel, emulated

THREADS = K._COUNT_THREADS
LOADS = K._COUNT_LOADS
STEP = THREADS * LOADS           # 16-byte vectors a block a step
MOST = K._COUNT_SM_BLOCKS * K._SMS   # blocks over a launch


def _block_counts(vals: np.ndarray, ndev: int, plan: dict) -> np.ndarray:
    """One block's counts of the values it read (-1 where a lane had
    none), by the plan's mode: REG_TARGETS counters a thread (a value in
    [ndev, REG_TARGETS) lands in a counter that is never written), or
    the shared histogram (valid values only)."""
    if plan["mode"] == "registers":
        D = K._REG_TARGETS
        assert ndev <= D
        c = np.bincount(vals[(vals >= 0) & (vals < D)], minlength=D)
        return c[:ndev]
    assert plan["mode"] == "shared" and ndev > K._REG_TARGETS
    ok = (vals >= 0) & (vals < ndev)
    return np.bincount(vals[ok], minlength=ndev)


def emulate(planes: np.ndarray, ndev: int, offset: int = 0, seed: int = 0):
    """dq_counts.cu's counts_kernel over [nch, nprod, cap] planes whose
    first value lies `offset` int32s past a 16-byte boundary. Returns
    (counts, tickets after the launch)."""
    nch, nprod, cap = planes.shape
    plan = K.dq_counts_plan(nch, nprod, cap, ndev)
    G = plan["blocks"]
    assert plan["grid"] == (G, nprod, nch)
    assert G <= max(1, MOST // (nch * nprod))
    flat = planes.reshape(-1)
    rng = np.random.default_rng(seed)
    # torch.empty's partials: garbage until a block writes them
    part = rng.integers(-(1 << 31), 1 << 31, plan["part_words"],
                        dtype=np.int64).astype(np.int32)
    written = np.zeros(plan["part_words"], bool)
    tickets = np.zeros(plan["tickets"], np.int64)
    counts = np.full((nch, nprod, ndev), -7, np.int32)
    for cp in range(nch * nprod):
        base = cp * cap
        row = flat[base:base + cap]
        addr = 4 * (offset + base)
        head = min(((16 - addr % 16) % 16) // 4, cap)
        nv = (cap - head) // 4
        tail = head + 4 * nv
        assert cap - tail < 4 and (addr + 4 * head) % 16 == 0 or nv == 0
        seen = np.zeros(cap, np.int64)
        order = rng.permutation(G)            # blocks finish in any order
        for g in range(G):
            vals = []
            if g == 0:                         # warp 0: the head and tail
                lane = np.arange(32)
                r = np.where(lane < head, lane, tail + lane - head)
                take = (lane < head) | (r < cap)
                vals.append(np.where(take, row[np.minimum(r, max(cap - 1,
                                                                 0))], -1)
                            if cap else np.full(32, -1))
                seen[r[take]] += 1
            steps = 0
            for s0 in range(g * STEP, nv, G * STEP):
                steps += 1
                q = s0 + np.arange(LOADS)[:, None] * THREADS \
                    + np.arange(THREADS)[None, :]
                q = q[q < nv]
                idx = (head + 4 * q[:, None] + np.arange(4)).reshape(-1)
                vals.append(row[idx])
                seen[idx] += 1
            assert steps <= plan["steps_per_block"]
            v = np.concatenate(vals) if vals else np.zeros(0, np.int32)
            c = _block_counts(v.astype(np.int64), ndev, plan)
            at = (cp * ndev + np.arange(ndev)) * G + g
            part[at] = c
            written[at] = True
        assert (seen == 1).all(), "a value read twice or never"
        for k, g in enumerate(order):          # the tickets, in turn
            t = tickets[cp]
            tickets[cp] += 1
            last = t == G - 1
            assert last == (k == G - 1)
            if last:
                tickets[cp] = 0
                for d in range(ndev):
                    pd = (cp * ndev + d) * G + np.arange(G)
                    assert written[pd].all()
                    counts.reshape(-1, ndev)[cp, d] = part[pd].astype(
                        np.int64).sum()
    return counts, tickets


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("cap", CAPS)
def test_emulation_is_the_plain_version(cap, ndev):
    for nch in (1, 2, 3):
        planes = _planes(nch, cap, ndev, SEED + 1)
        got, tickets = emulate(planes, ndev, offset=nch - 1, seed=nch)
        want = K.dq_counts_plain(torch.from_numpy(planes), ndev).numpy()
        np.testing.assert_array_equal(got, want)
        assert not tickets.any(), "a ticket word left drawn"


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_emulation_at_every_alignment(offset):
    """A view whose first value is off a 16-byte boundary: every row's
    head and tail shift, and each value is still counted once."""
    planes = _planes(2, 70_001, 4, SEED + 2)
    got, _t = emulate(planes, 4, offset=offset, seed=offset)
    np.testing.assert_array_equal(
        got, K.dq_counts_plain(torch.from_numpy(planes), 4).numpy())


def test_emulation_of_only_minus_one_and_many_blocks():
    """Planes of only -1 count zero everywhere, and a cap past
    the launch's most blocks x STEP x 4 rows gives every block several
    steps."""
    cap = MOST * STEP * 4 // NPROD + 12_345
    planes = _planes(1, cap, 4, SEED + 3)
    planes[0, 1] = -1
    got, _t = emulate(planes, 4)
    np.testing.assert_array_equal(
        got, K.dq_counts_plain(torch.from_numpy(planes), 4).numpy())
    assert not got[0, 1].any()
    plan = K.dq_counts_plan(1, NPROD, cap, 4)
    assert plan["steps_per_block"] >= 2


def test_plan_at_the_recorded_shapes():
    """q5's lineitem edge and the two-output stage (PERF.md's K16 row):
    every block the same number of steps, all resident at once."""
    edge = K.dq_counts_plan(1, 4, 1_572_864, 4)
    assert edge["grid"] == (192, 4, 1) and edge["steps_per_block"] == 2
    two = K.dq_counts_plan(2, 4, 393_216, 4)
    assert two["grid"] == (96, 4, 2) and two["steps_per_block"] == 1
    for plan in (edge, two):
        assert plan["steps"] % plan["blocks"] == 0
        assert plan["blocks"] * 4 * plan["grid"][2] <= MOST == 1056
        assert plan["mode"] == "registers" and plan["launches"] == 1
    modes = {n: K.dq_counts_plan(1, 4, 10, n)["mode"] for n in NDEVS}
    assert modes == {1: "registers", 3: "registers", 4: "registers",
                     8: "shared", 9: "shared", 32: "shared",
                     33: "shared", 1024: "shared"}
    assert K.dq_counts_plan(1, 4, 0, 4)["blocks"] == 1


# --------------------------------------------------------- the source


def test_source_constants_and_signature_match_the_bindings():
    assert _define("COUNT_THREADS") == K._COUNT_THREADS
    assert _define("COUNT_LOADS") == K._COUNT_LOADS
    assert _define("COUNT_SM_BLOCKS") == K._COUNT_SM_BLOCKS
    assert _define("REG_TARGETS") == K._REG_TARGETS
    # two instantiations: registers and the histogram
    assert len(re.findall(r"counts_kernel<(true|false)><<<", SRC)) == 2
    assert _define("MAX_TARGETS") == K._DQ_MAX_TARGETS
    assert "#define COUNT_STEP (COUNT_THREADS * COUNT_LOADS)" in SRC
    lib, sym, argtypes = K._SIGS["dq_counts"]
    assert lib == "dq_counts"
    params = re.search(r'extern "C" int ' + sym + r"\((.*?)\)", SRC,
                       re.S).group(1).split(",")
    assert len(params) == len(argtypes)
    for p, a in zip(params, argtypes):
        want = {"int64_t": K._I64, "int": K._I32}.get(p.split()[0], K._P)
        assert a is want, (p, a)
    # no shared atomic a row: the histogram's atomics are one a distinct
    # value a warp, and nothing zeroes the output before the launch
    assert "atomicAdd(&bins[d], 1)" not in SRC
    assert "atomicAdd(&bins[v], __popc(peers))" in SRC
    assert "atomicAdd(&out[" not in SRC


# -------------------------------------------------- fake CUDA tensors


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: real CUDA tensors launch the kernel")


@pytest.mark.parametrize("ndev", [4, 33])
def test_counts_launch_once_without_a_fill(monkeypatch, ndev):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched, zeros = [], []
    monkeypatch.setattr(K, "_launch", lambda name, *a:
                        launched.append((name, a)))
    monkeypatch.setattr(K, "_ptr", lambda t: 0 if t is None else id(t))
    monkeypatch.setattr(K, "_stream", lambda: 12345)
    monkeypatch.setattr(K, "_TICKETS", {})
    monkeypatch.setattr(K, "dq_counts_plain", lambda *a: pytest.fail(
        "a CUDA tensor took dq_counts_plain"))
    real_zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: zeros.append(a)
                        or real_zeros(*a, **k))
    with FakeTensorMode():
        planes = torch.empty((2, NPROD, 70_001), dtype=torch.int32,
                             device="cuda")
        first = K.dq_counts(planes, ndev)
        n_zeros = len(zeros)
        second = K.dq_counts(planes, ndev)
    assert n_zeros == 1 and len(zeros) == 1, "a fill on a later call"
    assert [n for n, _a in launched] == ["dq_counts"] * 2
    plan = K.dq_counts_plan(2, NPROD, 70_001, ndev)
    for (_n, a), out in zip(launched, (first, second)):
        assert a[:5] == (70_001, 2, NPROD, ndev, plan["blocks"])
        assert a[5] == id(planes) and a[8] == id(out)
        assert out.shape == (2, NPROD, ndev) and out.dtype == torch.int32
    # the same ticket words on the same stream
    assert launched[0][1][7] == launched[1][1][7]


def test_failed_launch_drops_the_ticket_words(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()

    def broken(name, *a):
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError 700")

    monkeypatch.setattr(K, "_launch", broken)
    monkeypatch.setattr(K, "_ptr", lambda t: 0 if t is None else id(t))
    monkeypatch.setattr(K, "_stream", lambda: 777)
    monkeypatch.setattr(K, "_TICKETS", {})
    with FakeTensorMode():
        planes = torch.empty((1, NPROD, 99), dtype=torch.int32,
                             device="cuda")
        with pytest.raises(RuntimeError, match="cudaError 700"):
            K.dq_counts(planes, 4)
    assert not K._TICKETS


def test_ticket_words_are_shared_and_grow(monkeypatch):
    """One set of ticket words a stream for every kernel that draws
    them: kept while large enough, made anew (zeroed) when too few."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "_stream", lambda: 4242)
    monkeypatch.setattr(K, "_TICKETS", {})
    dev = torch.device("cuda", 0)
    with FakeTensorMode():
        one = K._ticket(dev)
        assert K._ticket(dev, 1) is one and one.numel() == 1
        more = K._ticket(dev, 12)
        assert more is not one and more.numel() == 12
        assert K._ticket(dev) is more and K._ticket(dev, 8) is more
    assert list(K._TICKETS) == [("cuda", 0, 4242)]


def test_counts_refuse_bad_shapes(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "_launch", lambda name, *a: pytest.fail(
        "launched"))
    with FakeTensorMode():
        cuda = dict(device="cuda")
        with pytest.raises(ValueError, match="targets"):
            K.dq_counts(torch.empty((1, 4, 8), dtype=torch.int32, **cuda),
                        1025)
        with pytest.raises(ValueError, match="int32"):
            K.dq_counts(torch.empty((1, 4, 8), dtype=torch.int64, **cuda),
                        4)
        with pytest.raises(ValueError, match="nch, nprod, cap"):
            K.dq_counts(torch.empty((4, 8), dtype=torch.int32, **cuda), 4)
