"""K4's permutation: `bucket_perm`, the medium-domain lane's counting sort
by bucket id, against the comparison sort it replaces.

On its active prefix, `bucket_perm_plain(kid, active, nbuckets)` must
equal `sort_perm_plain([encode_key(~active), encode_key(kid)])` — the
active rows in (bucket id, row id) order — for uniform, skewed,
2%-active, all-inactive and 0-row inputs at 513 and 65,535 buckets; the
member form (B, cap) must equal the comparison sort of the B·cap rows
with the member id as the leading word, at B = 3 and B = 8; the shared
bucket id of a batch is sorted once over the union of the masks. The
wrapper takes the plain version for CPU tensors only: CUDA tensors (made
here under `FakeTensorMode`, which needs no card) with a wrong dtype or
length raise, and right ones go to the launch, never to the plain
version. The medium-domain lane's cases in `test_torch_groupby.py` and
`test_torch_slice.py` assert that the lane called `bucket_perm`.
"""

import numpy as np
import pytest
import torch

from ydb_tpu_torch.ops import torch_exec
from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.sort import encode_key
from tests import torch_threads  # noqa: F401,E402

N = 20_000


def _inputs(kind: str, nbuckets: int, n: int = N, seed: int = 9):
    rng = np.random.default_rng(seed)
    kid = rng.integers(0, nbuckets, n)
    active = rng.random(n) < 0.7
    if kind == "skewed":               # half the rows in one bucket
        kid[rng.random(n) < 0.5] = nbuckets // 3
    elif kind == "sparse":             # 2% of the rows active
        active = rng.random(n) < 0.02
    elif kind == "all_inactive":
        active[:] = False
    return (torch.from_numpy(kid.astype(np.int32)),
            torch.from_numpy(active))


def _comparison_prefix(words: list, active):
    n = active.numel()
    flat = active.reshape(-1)
    perm = K.sort_perm_plain([encode_key((~flat).to(torch.int64))] + words,
                             n, "cpu")
    return perm[:int(flat.sum())]


@pytest.mark.parametrize("nbuckets", [513, 65535])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "sparse",
                                  "all_inactive", "zero_rows"])
def test_active_prefix_equals_the_comparison_sort(kind, nbuckets):
    kid, active = _inputs(kind, nbuckets, 0 if kind == "zero_rows" else N)
    perm = K.bucket_perm_plain(kid, active, nbuckets)
    assert perm.dtype == torch.int32 and perm.shape == (kid.numel(),)
    assert torch.equal(torch.sort(perm).values,
                       torch.arange(kid.numel(), dtype=torch.int32))
    live = int(active.sum())
    want = _comparison_prefix([encode_key(kid.to(torch.int64))], active)
    assert torch.equal(perm[:live], want)
    assert not bool(active[perm[live:].long()].any())
    assert torch.equal(K.bucket_perm(kid, active, nbuckets), perm)


@pytest.mark.parametrize("B", [3, 8])
def test_member_form_orders_by_member_then_bucket(B):
    rng = np.random.default_rng(B)
    cap, nbuckets = 2_500, 40_000
    kid = torch.from_numpy(rng.integers(0, nbuckets, (B, cap))
                           .astype(np.int32))
    masks = torch.from_numpy(rng.random((B, cap)) < 0.5)
    masks[1] = False                   # a member with no active row
    perm = K.bucket_perm_plain(kid, masks, nbuckets)
    member = torch.arange(B, dtype=torch.int64).repeat_interleave(cap)
    want = _comparison_prefix(
        [encode_key(member), encode_key(kid.reshape(-1).to(torch.int64))],
        masks)
    assert torch.equal(perm[:want.numel()], want)
    assert torch.equal(K.bucket_perm(kid, masks, nbuckets), perm)


@pytest.mark.parametrize("B", [3, 8])
def test_shared_bucket_id_sorts_the_union_once(B):
    rng = np.random.default_rng(100 + B)
    cap, nbuckets = 4_000, 700
    kid = torch.from_numpy(rng.integers(0, nbuckets, cap).astype(np.int32))
    masks = torch.from_numpy(rng.random((B, cap)) < 0.1)
    union = masks.any(0)
    perm = K.bucket_perm_plain(kid, union, nbuckets)
    want = _comparison_prefix([encode_key(kid.to(torch.int64))], union)
    assert torch.equal(perm[:want.numel()], want)


@pytest.mark.parametrize("B", [3, 8])
def test_member_key_groups_through_bucket_perm(B):
    """The lane's per-member form: `_member_key_groups` over the bucket
    order gives what it gives over the comparison sort."""
    rng = np.random.default_rng(200 + B)
    cap, nbuckets = 3_000, 1_200
    kid = torch.from_numpy(rng.integers(0, nbuckets, (B, cap))
                           .astype(np.int32))
    masks = torch.from_numpy(rng.random((B, cap)) < 0.4)
    words = [encode_key(kid.to(torch.int64))]
    v = torch.from_numpy(rng.normal(size=(B, cap)))
    aggs = [("sum", v, None, False), ("count", None, None, False),
            ("first", None, None, False)]

    def by_bucket(_w, act, _n, _d):
        return K.bucket_perm(kid, act.reshape(kid.shape), nbuckets)
    got = torch_exec._member_key_groups(words, masks, aggs, cap, 1024,
                                        "cpu", by_bucket)
    want = torch_exec._member_key_groups(words, masks, aggs, cap, 1024,
                                         "cpu")
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    for g, w in zip(got[3] + got[4], want[3] + want[4]):
        assert torch.equal(g, w)


def test_cuda_tensors_are_checked_and_never_take_the_plain_version(
        monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: real CUDA tensors launch the kernel")
    monkeypatch.setattr(K, "bucket_perm_plain", lambda *a: pytest.fail(
        "a CUDA tensor took the plain version"))
    with FakeTensorMode():
        active = torch.empty(64, dtype=torch.bool, device="cuda")
        with pytest.raises(ValueError, match="dtype"):
            K.bucket_perm(torch.empty(64, dtype=torch.int64, device="cuda"),
                          active, 600)
        with pytest.raises(ValueError, match="shape"):
            K.bucket_perm(torch.empty(63, dtype=torch.int32, device="cuda"),
                          active, 600)
        kid = torch.empty(64, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="buckets"):
            K.bucket_perm(kid, active, 70_000)
        with pytest.raises(ValueError, match="shape"):
            K.bucket_perm(torch.empty((3, 64), dtype=torch.int32,
                                      device="cuda"),
                          torch.empty((2, 64), dtype=torch.bool,
                                      device="cuda"), 600)
        # right inputs go on to the launch
        launched = []
        monkeypatch.setattr(K, "_launch", lambda name, *a:
                            launched.append(name))
        monkeypatch.setattr(K, "_ptr", lambda t: 0)
        monkeypatch.setattr(K, "_stream", lambda: 0)
        perm = K.bucket_perm(kid, active, 600)
        assert launched == ["bucket_perm"]
        assert perm.device.type == "cuda" and perm.dtype == torch.int32
