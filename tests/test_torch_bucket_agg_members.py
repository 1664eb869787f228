"""K3 and K2/K3 xB: the keyed and member-axis bodies of `bucket_agg`.

The host plans (`bucket_agg_plan`, `keyless_members_plan`, `fold_slots`):
the fold order's parameters (P accumulator copies, F tile groups) follow
the rows, buckets and distinct aggregates alone, never B, so a batch's
member folds as a single query over its mask does; block rows and the
final pass follow the shared memory a row takes. The wrappers' launches
on CUDA tensors made under `FakeTensorMode` (no card needed): one launch
a chunk of 16 distinct aggregates for the single query (`bucket_agg`),
the keyed member form (`bucket_agg_batched`) and the keyless streaming
member form (`bucket_agg_keyless_batched`), never a plain version; the
ctypes signatures against the `.cu` sources. Then the plain versions:
`bucket_agg_batched_plain` against the JAX package's vmap of
`_groupby_small_domain` and `_groupby_global` (shared and per-member ids
and values, NULLs, every function, B in {1, 3, 8}), and member b of it
equal to `bucket_agg_plain` over member b's mask.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydb_tpu.core import dtypes as jdt
from ydb_tpu.core.schema import Column as JColumn, Schema as JSchema
from ydb_tpu.ops import ir as jir, xla_exec

from ydb_tpu_torch.ops.cuda import bindings as K
from tests import torch_threads  # noqa: F401,E402

RTOL = 1e-9          # float sums: another summation order than XLA's
SF1 = 6 * (1 << 20)  # lineitem's superblock at SF1


# ----------------------------------------------------------------- the plans


@pytest.mark.parametrize("n,nb,A,want", [
    # Q1: 12 buckets, 6 distinct sums: four copies, three blocks a SM, a
    # warp an output in the final pass
    (SF1, 12, 6, dict(P=4, F=396, final="lanes")),
    # the lane's limit: 512 buckets x 16 aggregates, one copy, two
    # blocks a SM, a thread an output
    (SF1, 512, 16, dict(P=1, F=264, final="threads")),
    (SF1, 512, 4, dict(P=2, F=396, final="threads")),
    (SF1, 300, 3, dict(P=4, F=396, final="lanes")),
    (SF1, 64, 4, dict(P=4, F=396, final="lanes")),
    # keyless members off the streaming body: one bucket
    (SF1, 1, 5, dict(P=4, F=396, final="lanes")),
    # few rows: a tile group a tile
    (5000, 12, 2, dict(P=4, F=5, final="lanes")),
    (0, 12, 2, dict(P=4, F=1, final="lanes")),
])
def test_keyed_plan(n, nb, A, want):
    plan = K.bucket_agg_plan(n, nb, A)
    assert {k: plan[k] for k in want} == want
    assert plan["launches"] == 1
    assert plan["smem"] <= K._KT_MAX_SMEM
    # the single query holds every slot of its member in one block row
    assert (plan["Y"], plan["SR"]) == (1, A + 1)


@pytest.mark.parametrize("nb,A", [(12, 6), (12, 10), (512, 16), (300, 3),
                                  (1, 1), (40, 16)])
@pytest.mark.parametrize("shared", [True, False])
def test_keyed_plan_fold_order_does_not_follow_b(nb, A, shared):
    one = K.bucket_agg_plan(SF1 + 333, nb, A)
    for B in (1, 3, 8, 32):
        plan = K.bucket_agg_plan(SF1 + 333, nb, A, B, shared_ids=shared)
        assert (plan["P"], plan["F"], plan["final"]) == (
            one["P"], one["F"], one["final"])
        assert plan["smem"] <= K._KT_MAX_SMEM
        S1 = A + 1
        if shared:
            # every member's slots, block rows of SR
            assert plan["rpm"] == 0
            assert plan["Y"] * plan["SR"] >= S1 * B
            assert (plan["Y"] - 1) * plan["SR"] < S1 * B
        else:
            # per-member ids: a member's slots in rpm rows of its own
            assert plan["rpm"] * plan["SR"] >= S1
            assert plan["Y"] == B * plan["rpm"]
        assert plan["partial_bytes"] == plan["F"] * S1 * B * nb * 12


def test_keyed_plan_sizes_partials_by_the_grid():
    # 512 x 16 x 8: 264 tile groups of partials (220 MB), where 528
    # blocks of full-size partials per member came to 553 MB
    plan = K.bucket_agg_plan(SF1, 512, 16, 8)
    assert plan["partial_bytes"] == 264 * 17 * 8 * 512 * 12
    assert plan["partial_bytes"] < 553_000_000 / 2
    assert (plan["Y"], plan["SR"]) == (8, 17)
    # Q1 x 8: one block row, every member's slots in it
    q1 = K.bucket_agg_plan(SF1, 12, 6, 8)
    assert (q1["Y"], q1["SR"], q1["P"]) == (1, 56, 4)


@pytest.mark.parametrize("aggs,aligned,want", [
    # Q6, Q14, Q19's member scans: shared sums, no NULLs
    ([("sum", True, False, True)], True, ("stream", 8, 4, 1)),
    ([("sum", True, False, True)] * 2, True, ("stream", 8, 2, 1)),
    ([("sum", True, False, True), ("count", False, False, True)], True,
     ("stream", 8, 4, 1)),
    ([("sum", True, False, True)] * 3, True, ("stream", 4, 2, 2)),
    ([("sum", True, False, True)] * 4, True, ("stream", 4, 2, 2)),
    ([("count", False, False, True)], True, ("stream", 8, 4, 1)),
    ([], True, ("stream", 8, 4, 1)),
    # a fifth sum, a validity, another function, a per-member column or
    # unaligned inputs: the keyed body with one bucket
    ([("sum", True, False, True)] * 5, True, ("keyed",)),
    ([("sum", True, True, True)], True, ("keyed",)),
    ([("min", True, False, True)], True, ("keyed",)),
    ([("first", False, False, True)], True, ("keyed",)),
    ([("sum", True, False, False)], True, ("keyed",)),
    ([("sum", True, False, True)], False, ("keyed",)),
])
def test_keyless_members_plan(aggs, aligned, want):
    plan = K.keyless_members_plan(SF1, 8, aggs, aligned)
    got = (plan["path"],) + ((plan["members"], plan["J"], plan["rows"])
                             if plan["path"] == "stream" else ())
    assert got == want
    assert plan["launches"] == 1
    if plan["path"] == "keyed":
        assert plan["P"] == K.bucket_agg_plan(SF1, 1, len(aggs))["P"]


@pytest.mark.parametrize("n,B,grid,rows", [(0, 8, 1, 1), (2048, 3, 1, 1),
                                           (2049, 8, 2, 1), (SF1, 8, 264, 1),
                                           (SF1, 32, 264, 4),
                                           (SF1 + 1, 9, 264, 2)])
def test_keyless_members_plan_grid_follows_the_rows(n, B, grid, rows):
    plan = K.keyless_members_plan(n, B, [("sum", True, False, True)], True)
    assert (plan["grid"], plan["rows"]) == (grid, rows)
    # a block step is 8 warps x 64 x J rows
    assert plan["grid"] == max(1, min(-(-n // (8 * 64 * 4)), 264))


def test_fold_slots_dedupes_and_counts_rows():
    a = torch.zeros(4, dtype=torch.float64)
    b = torch.zeros(4, dtype=torch.float64)
    i = torch.zeros(4, dtype=torch.int64)
    v = torch.ones(4, dtype=torch.bool)
    specs = [("sum", a, None, False, 0, 0), ("sum", b, None, False, 0, 0),
             ("count", None, None, False, 0, 0),       # the row count
             ("sum", a, None, False, 0, 0),            # sum(a) again
             ("count", None, v, False, 0, 0),
             ("min", i, None, False, 0, 0), ("min", i, None, True, 0, 0),
             ("first", None, None, False, 0, 0),
             ("first", None, None, False, 0, 0),
             ("sum", a, None, False, 4, 0),            # a per-member view
             ("count", None, None, False, 0, 0)]
    distinct, slots = K.fold_slots(specs)
    assert slots == [0, 1, -1, 0, 2, 3, 4, 5, 5, 6, -1]
    assert distinct == [0, 1, 4, 5, 6, 7, 9]


# ------------------------------------------- the wrappers on CUDA tensors


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: real CUDA tensors launch the kernel")


def _fake(monkeypatch):
    launched, allocated = [], []
    monkeypatch.setattr(K, "_launch", lambda name, *a:
                        launched.append((name, a)))
    monkeypatch.setattr(K, "_ptr", lambda t: None if t is None else 0)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    for name in ("bucket_agg_plain", "bucket_agg_batched_plain"):
        monkeypatch.setattr(K, name, lambda *a, _n=name, **k: pytest.fail(
            f"a CUDA tensor took {_n}"))
    real = {f: getattr(torch, f) for f in ("empty", "zeros")}

    def alloc(f):
        def make(*a, **k):
            t = real[f](*a, **k)
            allocated.append((f, tuple(t.shape), t.dtype))
            return t
        return make
    for f in real:
        monkeypatch.setattr(torch, f, alloc(f))
    return launched, allocated


def _plan_arg(args):
    """The plan array of a bucket_agg_members_launch call: (F, Y, P, SR,
    rpm, lanes)."""
    return tuple(args[15])


def test_single_keyed_query_launches_the_member_kernel_once_a_chunk(
        monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    n = SF1
    with FakeTensorMode():
        cuda = dict(device="cuda")
        kid = torch.empty(n, dtype=torch.int32, **cuda)
        active = torch.empty(n, dtype=torch.bool, **cuda)
        cols = [torch.empty(n, dtype=torch.float64, **cuda)
                for _ in range(6)]
        valid = torch.empty(n, dtype=torch.bool, **cuda)
        launched, allocated = _fake(monkeypatch)
        # Q1's spec: six distinct sums (one twice) and three counts
        q1 = [("sum", c, None, False) for c in cols] \
            + [("sum", cols[0], None, False)] \
            + [("count", None, None, False)] * 3
        vals, cnts, pres = K.bucket_agg(kid, 12, active, q1)
        # 20 distinct aggregates: two chunks
        wide = [("sum", cols[i % 6], valid, False) if i < 6 else
                ("count", None, torch.empty(n, dtype=torch.bool, **cuda),
                 False) for i in range(20)]
        K.bucket_agg(kid, 512, active, wide)
    assert [v.shape for v in vals] == [(12,)] * 10
    assert [v.dtype for v in vals] == [torch.float64] * 7 + [torch.int64] * 3
    assert pres.shape == (12,) and cnts[0].shape == (12,)
    # a count with no validity is the row count
    assert vals[7]._base is pres._base and cnts[8]._base is pres._base
    assert [name for name, _a in launched] == ["bucket_agg"] * 3
    # (n, nb, kid, kid stride, B, masks, mask stride, n_aggs, ...)
    a = launched[0][1]
    assert (a[1], a[3], a[4], a[6], a[7]) == (12, 0, 1, 0, 6)
    assert _plan_arg(a) == (396, 1, 4, 7, 0, 1)
    assert [(x[1][7], _plan_arg(x[1])[:4]) for x in launched[1:]] == [
        (16, (264, 1, 1, 17)), (4, (396, 1, 2, 5))]
    # the partials: F x 7 slots x 12 buckets, 8-byte values, 4-byte counts
    assert ("empty", (396 * 7 * 12,), torch.int32) in allocated
    assert not [x for x in allocated if x[0] == "zeros"]


def test_batched_keyed_and_keyless_launches(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "_TICKETS", {})
    n, B = SF1, 8
    with FakeTensorMode():
        cuda = dict(device="cuda")
        kid = torch.empty(n, dtype=torch.int32, **cuda)
        kid_pm = torch.empty((B, n), dtype=torch.int32, **cuda)
        masks = torch.empty((B, n), dtype=torch.bool, **cuda)
        col = torch.empty(n, dtype=torch.float64, **cuda)
        ints = torch.empty(n, dtype=torch.int64, **cuda)
        per = torch.empty((B, n), dtype=torch.float64, **cuda)
        valid = torch.empty(n, dtype=torch.bool, **cuda)
        launched, allocated = _fake(monkeypatch)
        q1 = [("sum", col, None, False), ("sum", ints, None, False),
              ("count", None, None, False)]
        vals, cnts, pres = K.bucket_agg_batched(kid, 12, masks, q1)
        K.bucket_agg_batched(kid_pm, 12, masks, q1)
        wide = [("min", col, valid, False)] + [
            ("count", None, torch.empty(n, dtype=torch.bool, **cuda), False)
            for _ in range(16)]
        K.bucket_agg_batched(kid, 512, masks, wide)
        # keyless: the streaming body for Q6's spec, the keyed body with
        # one bucket for a validity or a per-member column
        kv, kc, kp = K.bucket_agg_batched(None, 1, masks,
                                          [("sum", col, None, False)])
        K.bucket_agg_batched(None, 1, masks, [("sum", col, valid, False)])
        K.bucket_agg_batched(None, 1, masks, [("sum", per, None, False)])
    assert [v.shape for v in vals] == [(B, 12)] * 3
    assert vals[2] is pres and pres.shape == (B, 12)
    assert [v.shape for v in kv] == [(B, 1)] and kp.shape == (B, 1)
    names = [name for name, _a in launched]
    assert names == ["bucket_agg_batched"] * 4 + [
        "bucket_agg_keyless_batched"] + ["bucket_agg_batched"] * 2
    shared, pm, w1, w2 = (launched[i][1] for i in range(4))
    assert (shared[3], shared[4], shared[6]) == (0, B, n)  # ks, B, ms
    assert _plan_arg(shared) == (396, 1, 4, 24, 0, 1)
    assert pm[3] == n and _plan_arg(pm) == (396, B, 4, 3, 1, 1)
    # 17 distinct aggregates: 16, then one (two slots a member)
    assert [_plan_arg(x)[:4] for x in (w1, w2)] == [(264, 8, 1, 17),
                                                    (396, 4, 4, 4)]
    # keyless streaming: (n, B, masks, ms, n_aggs, data, funcs, types, G,
    # rows, ...), one ticket word per stream
    st = launched[4][1]
    assert (st[1], st[3], st[4], st[8], st[9]) == (B, n, 1, 264, 1)
    assert [x for x in allocated if x[0] == "zeros"] == [
        ("zeros", (1,), torch.int32)]
    assert _plan_arg(launched[5][1])[:4] == (396, 1, 4, 16)


def test_launch_signatures_match_the_sources():
    """The ctypes argument lists of the new entries have the C entries'
    arity and kinds."""
    import re
    from ydb_tpu_torch.ops.cuda import build
    for name, lib, sym in (
            ("bucket_agg", "bucket_agg", "bucket_agg_members_launch"),
            ("bucket_agg_batched", "bucket_agg",
             "bucket_agg_members_launch"),
            ("bucket_agg_keyless_batched", "bucket_agg",
             "bucket_agg_keyless_batched_launch"),
            ("bucket_agg_keyless", "bucket_agg", "bucket_agg_keyless_launch"),
            ("expand_counts", "expand", "expand_counts_launch")):
        src = (build.CSRC / f"{lib}.cu").read_text()
        m = re.search(r'extern "C" int ' + sym + r"\((.*?)\)\s*\{", src,
                      re.S)
        assert m, sym
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(K._SIGS[name][2]), name
        for p, t in zip(params, K._SIGS[name][2]):
            if "*" in p:
                assert t in (K._P, K._PI64, K._PI32), (name, p)
            elif "int64_t" in p:
                assert t is K._I64, (name, p)
            else:
                assert t is ctypes.c_int, (name, p)


def test_source_constants_match_the_plans():
    """The plans' constants are the kernel's."""
    import re
    from ydb_tpu_torch.ops.cuda import build
    src = (build.CSRC / "bucket_agg.cu").read_text()

    def define(name):
        return int(re.search(r"#define " + name + r" (\d+)", src).group(1))
    assert define("KT_CHUNKS") * 32 == K._KT_TILE
    assert define("KT_MAX_SMEM") == K._KT_MAX_SMEM
    assert define("KL_MAX_SUMS") == K._KL_MAX_SUMS
    assert K._KM_GRID <= define("KM_MAX_G")
    assert "KT_TILE * 7" in src and K._KT_TILE_BYTES == 7 * K._KT_TILE


# ------------------------------------------------------- the plain versions


def _spec_cols(rng, n, B):
    """Columns for the reference and the port: shared and per-member
    values with NULLs, an unsigned column, bucket keys."""
    x = rng.normal(size=n) * 100
    xv = rng.random(n) > 0.1
    i = rng.integers(-(1 << 40), 1 << 40, n)
    iv = rng.random(n) > 0.05
    u = rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, n, dtype=np.uint64)
    px = rng.normal(size=(B, n)) * 10
    pv = rng.random((B, n)) > 0.2
    return dict(x=(x, xv), i=(i, iv), u=(u, None), px=(px, pv))


AGGS = [("n", "count_all", None), ("cx", "count", "x"), ("sx", "sum", "x"),
        ("si", "sum", "i"), ("minx", "min", "x"), ("maxi", "max", "i"),
        ("minu", "min", "u"), ("maxu", "max", "u"), ("somex", "some", "x"),
        ("spx", "sum", "px"), ("mpx", "max", "px"), ("cpx", "count", "px")]


def _port_specs(cols, B):
    """The port's kernel specs for AGGS (count_all is the row count)."""
    specs = []
    for _out, func, arg in AGGS:
        if func == "count_all":
            continue
        d, v = cols[arg]
        vt = None if v is None else torch.from_numpy(v)
        if func == "count":
            specs.append(("count", None, vt, False))
        elif func == "some":
            specs.append(("first", None, vt, False))
        else:
            dt = torch.from_numpy(d.view(np.int64) if d.dtype == np.uint64
                                  else d)
            specs.append((func, dt, vt, d.dtype == np.uint64))
    return specs


def _reference(cols, masks, kid_cols, grouped):
    """The JAX package's vmap over members of `_groupby_small_domain`
    (grouped) or `_groupby_global`: returns its new_env and lengths."""
    B, n = masks.shape
    names = list(cols)
    per = {k for k, (d, _v) in cols.items() if d.ndim == 2}
    kind = {np.float64: "float64", np.int64: "int64", np.uint64: "uint64"}
    sch = [JColumn(k, jdt.DType(jdt.Kind(kind[cols[k][0].dtype.type]),
                                cols[k][1] is not None)) for k in names]
    if grouped:
        sch.append(JColumn("g", jdt.DType(jdt.Kind("int32"), True)))
    schema = JSchema(sch)
    cmd = jir.GroupBy(keys=("g",) if grouped else (),
                      aggs=tuple(jir.Agg(o, f, a) for o, f, a in AGGS),
                      key_domains=(kid_cols[2],) if grouped else ())
    iota = jnp.arange(n, dtype=jnp.int32)

    def one(sel, member_cols, g, gv):
        env = {}
        for k in names:
            d, v = member_cols[k] if k in per else cols[k]
            env[k] = (jnp.asarray(d), None if v is None else jnp.asarray(v))
        if grouped:
            env["g"] = (g, gv)
            return xla_exec._groupby_small_domain(cmd, env, schema, sel,
                                                  jnp.int32(n), n)
        return xla_exec._groupby_global(cmd, env, sel, iota)[0], n

    member_cols = {k: cols[k] for k in per}
    g, gv, _dom, g_per = kid_cols if grouped else (None, None, 0, False)
    gax = 0 if grouped and g_per else None
    out = jax.vmap(one, in_axes=(0, 0, gax, gax))(
        jnp.asarray(masks),
        {k: (jnp.asarray(d), jnp.asarray(v)) for k, (d, v)
         in member_cols.items()},
        None if g is None else jnp.asarray(g),
        None if gv is None else jnp.asarray(gv))
    return out


def _check_member(ref_env, ref_len, b, vals, cnts, present, buckets, cols,
                  n):
    """Member b of the port's plain batched results at `buckets` (its
    present ones, ascending) against the reference's rows of member b."""
    assert int(ref_len) == len(buckets)
    rows = slice(0, len(buckets))
    specs = iter(zip(vals, cnts))
    for out, func, arg in AGGS:
        d, v = ref_env[out]
        d = np.asarray(d)[b][rows]
        rv = None if v is None else np.asarray(v)[b][rows]
        if func == "count_all":
            np.testing.assert_array_equal(d, present[b, buckets].numpy())
            continue
        val, cnt = next(specs)
        val, cnt = val[b, buckets].numpy(), cnt[b, buckets].numpy()
        if func == "count":
            np.testing.assert_array_equal(d, val, err_msg=out)
            continue
        np.testing.assert_array_equal(rv, cnt > 0, err_msg=out)
        if func == "some":
            src = cols[arg][0]
            src = src[b] if src.ndim == 2 else src
            got = src[np.clip(val, 0, n - 1)]
            np.testing.assert_array_equal(d[rv], got[rv], err_msg=out)
        elif d.dtype == np.float64:
            np.testing.assert_allclose(d[rv], val[rv], rtol=RTOL, err_msg=out)
        else:
            np.testing.assert_array_equal(d[rv], val.view(d.dtype)[rv]
                                          if d.dtype == np.uint64
                                          else val[rv], err_msg=out)


def _port(kid, nb, masks, cols, B):
    specs = _port_specs(cols, B)
    return K.bucket_agg_batched(kid, nb, torch.from_numpy(masks), specs), \
        specs


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("ids", ["shared", "per_member"])
def test_batched_plain_matches_reference_small_domain(B, ids):
    rng = np.random.default_rng(100 + B)
    n, dom = 1500, 9
    cols = _spec_cols(rng, n, B)
    masks = rng.random((B, n)) < 0.7
    masks[-1, :] &= rng.random(n) < 0.05       # a sparse member
    shape = (n,) if ids == "shared" else (B, n)
    g = rng.integers(-1, dom, shape).astype(np.int32)
    gv = rng.random(shape) > 0.1
    ref_env, ref_len = _reference(cols, masks, (g, gv, dom, ids != "shared"),
                                  grouped=True)
    # the port's bucket ids, as _bucket_ids makes them: code + 1, NULL 0
    kid = np.where(gv, np.clip(g + 1, 0, dom), 0).astype(np.int32)
    (vals, cnts, present), _specs = _port(torch.from_numpy(kid), dom + 1,
                                          masks, cols, B)
    assert present.shape == (B, dom + 1)
    for b in range(B):
        buckets = np.nonzero(present[b].numpy() > 0)[0]
        _check_member(ref_env, ref_len[b], b, vals, cnts, present, buckets,
                      cols, n)


@pytest.mark.parametrize("B", [1, 3, 8])
def test_batched_plain_matches_reference_keyless(B):
    rng = np.random.default_rng(200 + B)
    n = 1300
    cols = _spec_cols(rng, n, B)
    masks = rng.random((B, n)) < 0.6
    masks[0] = False                              # a member with no row
    ref_env, _n = _reference(cols, masks, None, grouped=False)
    (vals, cnts, present), _specs = _port(None, 1, masks, cols, B)
    assert present.shape == (B, 1)
    for b in range(B):
        # the reference's one output row exists even with no active row
        ref = {k: (np.asarray(d), None if v is None else np.asarray(v))
               for k, (d, v) in ref_env.items()}
        _check_member(ref, 1, b, vals, cnts, present, np.array([0]), cols,
                      n)


@pytest.mark.parametrize("nb", [1, 12, 300])
@pytest.mark.parametrize("per_member", [False, True])
def test_batched_plain_member_is_a_single_call(nb, per_member):
    rng = np.random.default_rng(nb)
    n, B = 2000, 5
    cols = _spec_cols(rng, n, B)
    masks = torch.from_numpy(rng.random((B, n)) < 0.5)
    kid = None if nb == 1 else torch.from_numpy(rng.integers(
        0, nb, (B, n) if per_member else n).astype(np.int32))
    specs = _port_specs(cols, B)
    vals, cnts, present = K.bucket_agg_batched(kid, nb, masks, specs)
    for b in range(B):
        one = [(f, None if d is None else (d[b] if d.dim() == 2 else d),
                None if v is None else (v[b] if v.dim() == 2 else v), u)
               for (f, d, v, u) in specs]
        kb = None if kid is None else (kid[b] if kid.dim() == 2 else kid)
        sv, sc, sp = K.bucket_agg(kb, nb, masks[b], one)
        assert torch.equal(present[b], sp)
        for i in range(len(specs)):
            assert torch.equal(cnts[i][b], sc[i])
            # the same rows in the same order: equal bit for bit
            x, y = vals[i][b], sv[i]
            if x.dtype == torch.float64:
                x, y = x.view(torch.int64), y.view(torch.int64)
            assert torch.equal(x, y), i
