"""The batched serving lane of the port against the reference.

(a) `Executor.execute_fused_batched` through both packages on the same
    members — the eight shapes of the reference's lane tests over a
    500-row table, and TPC-H Q1, Q6, Q12, Q14 and Q19 with their
    parameters drawn as qgen draws them (`bench/serving.py`) at SF 0.01:
    the answers agree (floats rtol 1e-9, everything else exact, row
    order included), and the port declines (returns None) exactly where
    the reference does.
(b) The reference's `tests/test_batch_lane.py` cases through the port's
    engine (tables filled through `ydb_tpu_torch.interop`; the port has
    no INSERT): a storm equals the lane-off engine, one admission
    reservation per sealed group, groups split on data identity and on
    build params, identical texts dedup, the joined shape, zero-literal
    LIMIT variants; and a failure inside a batched execution reaches
    every member. The EXPLAIN ANALYZE case is left out: the port has no
    EXPLAIN ANALYZE.
(c) Each member-axis plain version against B calls of the single-query
    plain version, and `_eval` of every function of `ops/kernels.py`
    with a per-member param against B single evaluations.
(d) The serving templates at B = 8 with `compact_batched_plain`'s tails
    poisoned where the kernel leaves them undefined: the answers equal
    the clean lane's and the reference's.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from ydb_tpu.query import QueryEngine as JaxEngine
from ydb_tpu.sql import parse as jax_parse

from ydb_tpu_torch import interop
from ydb_tpu_torch.bench import serving
from ydb_tpu_torch.query import QueryEngine as PortEngine
from ydb_tpu_torch.sql import parse as port_parse
from ydb_tpu_torch.utils.metrics import GLOBAL

from tests.tpch_util import assert_frames_match
from tests import torch_threads  # noqa: F401,E402

ROWS = 500


def _fill_reference(eng, rows: int = ROWS):
    eng.execute("create table t (k Int64 not null, a Int64, b Double, "
                "s Utf8, d Date, primary key (k))")
    eng.execute("insert into t (k, a, b, s, d) values "
                + ", ".join(
                    f"({i}, {i % 7}, {i * 0.5}, "
                    f"'tag{i % 5}', date '2024-01-{i % 28 + 1:02d}')"
                    for i in range(rows)))
    eng.execute("create table dim (a Int64 not null, nm Utf8, w Int64, "
                "primary key (a))")
    eng.execute("insert into dim (a, nm, w) values "
                + ", ".join(f"({i}, 'n{i}', {i * 100})" for i in range(7)))
    eng.execute("create table dup (x Int64 not null, a Int64, w Int64, "
                "primary key (x))")
    eng.execute("insert into dup (x, a, w) values "
                + ", ".join(f"({i}, {i % 3}, {i})" for i in range(9)))
    eng.execute("create table empty (k Int64 not null, a Int64, "
                "primary key (k))")
    # 600 distinct strings: a group-by domain past the 512-bucket lane
    eng.execute("create table m (k Int64 not null, g Utf8, v Double, "
                "primary key (k))")
    eng.execute("insert into m (k, g, v) values "
                + ", ".join(f"({i}, 'g{(i * 7) % 600}', {i * 0.25})"
                            for i in range(1200)))


def _port_engine(je):
    pe = PortEngine(device="cpu", block_rows=1 << 12)
    interop.load_tables(pe.catalog, interop.export_tables(je.catalog))
    return pe


@pytest.fixture(scope="module")
def engines():
    je = JaxEngine(block_rows=1 << 12)
    _fill_reference(je)
    return je, _port_engine(je)


def _strip_prune(plan):
    pipe = plan.pipeline
    return dataclasses.replace(plan, pipeline=dataclasses.replace(
        pipe, scan=dataclasses.replace(pipe.scan, prune=[])))


def _batched(eng, parse, texts):
    plans = [eng.planner.plan_select(parse(q)) for q in texts]
    assert all(p.lift_sig == plans[0].lift_sig for p in plans), texts
    out = eng.executor.execute_fused_batched(
        _strip_prune(plans[0]), [(p, dict(p.params)) for p in plans],
        eng.snapshot())
    return out, eng.executor


def _both(engines, texts):
    je, pe = engines
    want, _ = _batched(je, jax_parse, texts)
    got, _ = _batched(pe, port_parse, texts)
    return want, got


def _assert_blocks_match(got, want, texts):
    assert (got is None) == (want is None), texts
    if want is None:
        return
    assert len(got) == len(want)
    for g, w, q in zip(got, want, texts):
        gf, wf = g.to_pandas(), w.to_pandas()
        assert list(gf.columns) == list(wf.columns), q
        assert_frames_match(gf, wf, ordered=True)


# -- (a) execute_fused_batched through both packages -----------------------

SHAPES = {
    "point": [f"select a, b from t where k = {i}" for i in (3, 17, 250, 9)],
    "keyless": [f"select count(*) as c, sum(b) as sb from t where b > {x}"
                for x in (1.5, 42.25, 99.0, 200.0)],
    "small_groupby": [f"select s, sum(b) as sb, count(*) as c from t "
                      f"where k >= {i} group by s order by s"
                      for i in (0, 5, 100, 480)],
    "int_groupby": [f"select a, sum(b) as sb, count(*) as c from t "
                    f"where k >= {i} group by a order by a"
                    for i in (0, 5, 100, 480)],
    "groupby_limit": [f"select k, sum(b) as sb from t where a = {i} "
                      f"group by k order by k limit 5" for i in (1, 2, 3, 6)],
    "topk": [f"select k, b from t where a <> {i} order by b desc limit 7"
             for i in (0, 2, 4, 6)],
    "broadcast_join": [f"select w from t join dim on t.a = dim.a "
                       f"where k = {i}" for i in (1, 2, 30, 77)],
    "string_eq": [f"select k from t where s = 'tag{i}' order by k limit 6"
                  for i in (0, 1, 3, 4)],
    "date_range": [f"select count(*) as c from t where d >= "
                   f"date '2024-01-{i:02d}'" for i in (1, 10, 15, 28)],
    # the medium-domain lane (513 to 65,535 buckets) and a group key
    # that depends on a member's param
    "medium_groupby": [f"select g, sum(v) as sv, count(*) as c from m "
                       f"where k >= {i} group by g order by g"
                       for i in (0, 7, 300, 1100)],
    "member_key_groupby": [f"select a + {i} as g, count(*) as c, "
                           f"sum(b) as sb from t group by a + {i} "
                           f"order by g" for i in (0, 3, 10, 100)],
}

# the member-axis entry each shape's batched run goes through
SHAPE_KERNELS = {
    "keyless": "bucket_agg_batched", "small_groupby": "bucket_agg_batched",
    "date_range": "bucket_agg_batched",
    "groupby_limit": "segment_agg_batched",
    "int_groupby": "segment_agg_batched",
    "medium_groupby": "segment_agg_batched",
    "point": "compact_batched", "topk": "compact_batched",
    "string_eq": "compact_batched", "broadcast_join": "compact_batched",
    # one sort and one segment_agg over the B·cap rows, the member id
    # the leading key word
    "member_key_groupby": "segment_agg",
}


@pytest.fixture
def entry_calls(monkeypatch):
    """Calls of the member-axis kernel entries and of segment_agg (their
    plain versions run here, on the CPU)."""
    from ydb_tpu_torch.ops.cuda import bindings as K
    calls = {}
    for name in ("bucket_agg_batched", "segment_agg_batched",
                 "compact_batched", "segment_agg"):
        real = getattr(K, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(K, name, counted)
    return calls


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_batched_shape_matches_reference(engines, entry_calls, shape):
    texts = SHAPES[shape]
    want, got = _both(engines, texts)
    assert want is not None
    _assert_blocks_match(got, want, texts)
    assert entry_calls.get(SHAPE_KERNELS[shape]), entry_calls


DECLINES = {
    # integer IN lists of different lengths: the array params' shapes
    # differ, which the shape signature cannot see
    "in_list_drift": ["select k from t where a in (1, 2) order by k limit 4",
                      "select k from t where a in (1, 2, 3) order by k "
                      "limit 4"],
    # a non-unique inner build (the expanding probe is portioned-only)
    "nonunique_build": [f"select t.k, dup.w from t join dup on t.a = dup.a "
                        f"where t.b > {x}" for x in (1.5, 2.5)],
    "empty_scan": [f"select a from empty where k = {i}" for i in (1, 2)],
}


@pytest.mark.parametrize("case", sorted(DECLINES))
def test_batched_declines_where_the_reference_does(engines, case):
    texts = DECLINES[case]
    je, pe = engines
    want = je.executor.execute_fused_batched(
        *_members(je, jax_parse, texts))
    got = pe.executor.execute_fused_batched(
        *_members(pe, port_parse, texts))
    assert want is None and got is None


def _members(eng, parse, texts):
    plans = [eng.planner.plan_select(parse(q)) for q in texts]
    return (_strip_prune(plans[0]), [(p, dict(p.params)) for p in plans],
            eng.snapshot())


@pytest.fixture(scope="module")
def tpch_engines():
    from ydb_tpu.bench.tpch_gen import load_tpch as jax_load_tpch
    from ydb_tpu_torch.bench import tpch_gen as port_gen
    je = JaxEngine(block_rows=1 << 13)
    jax_load_tpch(je.catalog, sf=0.01, shards=2, portion_rows=1 << 13)
    pe = PortEngine(device="cpu", block_rows=1 << 13)
    port_gen.load_tpch(pe.catalog, sf=0.01, shards=2, portion_rows=1 << 13)
    return je, pe


@pytest.mark.parametrize("name", ["q1", "q6", "q12", "q14", "q19"])
def test_tpch_variants_match_reference(tpch_engines, entry_calls, name):
    texts = serving.variants(name, 4, seed=7)
    assert len(set(texts)) == 4
    want, got = _both(tpch_engines, texts)
    assert want is not None
    _assert_blocks_match(got, want, texts)
    assert entry_calls.get("bucket_agg_batched"), entry_calls


# -- (b) the lane through the port's engine --------------------------------


@pytest.fixture(scope="module")
def tables(engines):
    """The reference's table set as plain data, for fresh port engines."""
    je, _pe = engines
    return interop.export_tables(je.catalog)


def _lane_engine(monkeypatch, tables, window: int, max_batch: int = 64):
    monkeypatch.setenv("YDB_TPU_BATCH_WINDOW", str(window))
    monkeypatch.setenv("YDB_TPU_BATCH_MAX", str(max_batch))
    pe = PortEngine(device="cpu", block_rows=1 << 12)
    interop.load_tables(pe.catalog, tables)
    return pe


def _storm(eng, texts):
    results, errs = {}, []
    barrier = threading.Barrier(len(texts))

    def one(i, sql):
        try:
            barrier.wait()
            results[i] = eng.query(sql)
        except Exception as e:             # noqa: BLE001 — collected
            errs.append((i, e))
    threads = [threading.Thread(target=one, args=(i, q))
               for i, q in enumerate(texts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errs


def _equal_frames(got, want, texts):
    for i, q in enumerate(texts):
        assert list(got[i].columns) == list(want[i].columns), q
        for c in want[i].columns:
            assert np.array_equal(got[i][c].to_numpy(),
                                  want[i][c].to_numpy()), (q, c)


def test_storm_equals_lane_off(monkeypatch, tables):
    texts = [f"select a, b from t where k = {i}" for i in range(12)]
    base = _lane_engine(monkeypatch, tables, 0)
    want = {i: base.query(q) for i, q in enumerate(texts)}
    eng = _lane_engine(monkeypatch, tables, 500, 12)
    eng.query(texts[0])
    b0 = GLOBAL.get("batch/batches")
    q0 = GLOBAL.get("batch/coalesced_queries")
    got, errs = _storm(eng, texts)
    assert not errs, errs[:3]
    _equal_frames(got, want, texts)
    c = eng.counters()
    assert c["batch/batches"] - b0 >= 1
    assert c["batch/coalesced_queries"] - q0 >= len(texts) - 2
    assert c["batch/max_size"] >= 2


def test_one_admission_reservation_per_sealed_group(monkeypatch, tables):
    from ydb_tpu_torch.query.admission import batch_reservation_bytes
    assert batch_reservation_bytes(10 << 20, 8) == 8 * (10 << 20)
    assert batch_reservation_bytes(100, 8) == 100 + 7 * (1 << 20)
    assert batch_reservation_bytes(10 << 20, 1) == 10 << 20
    eng = _lane_engine(monkeypatch, tables, 500, 8)
    eng.query("select a, b from t where k = 0")
    before = {k: GLOBAL.get(k) for k in ("batch/reservations",
                                         "batch/batches", "batch/singles",
                                         "batch/fallbacks")}
    _got, errs = _storm(eng, [f"select a, b from t where k = {i}"
                              for i in range(8)])
    assert not errs, errs[:3]
    d = {k: GLOBAL.get(k) - v for k, v in before.items()}
    assert d["batch/batches"] >= 1
    groups = d["batch/batches"] + d["batch/singles"] + d["batch/fallbacks"]
    assert d["batch/reservations"] == groups
    assert groups < 8, "8 members must not make 8 solo reservations"
    assert eng.admission.in_flight == 0
    assert eng.admission.active == 0


def test_groups_split_on_data_identity_and_build_params(monkeypatch,
                                                        tables):
    from ydb_tpu_torch.core.block import HostBlock
    from ydb_tpu_torch.storage.mvcc import WriteVersion
    eng = _lane_engine(monkeypatch, tables, 50)
    plan = eng.planner.plan_select(port_parse("select b from t where k = 1"))
    lane = eng._batch_lane
    k1 = lane._group_key(plan, eng.snapshot(), 1 << 20)
    assert k1 is not None
    # a commit changes the table's visible sources, and the key with them
    t = eng.catalog.table("t")
    block = HostBlock.from_arrays(
        t.schema, {"k": np.array([9001]), "a": np.array([1]),
                   "b": np.array([1.0]), "s": np.array([0], np.int32),
                   "d": np.array([19754], np.int32)},
        dictionaries=dict(t.dictionaries))
    t.commit(t.write(block), WriteVersion(2, 1))
    k2 = lane._group_key(plan, eng.snapshot(), 1 << 20)
    assert k2 is not None and k2 != k1
    # members whose BUILD literals differ split too
    pa = eng.planner.plan_select(port_parse(
        "select w from t join dim on t.a = dim.a where dim.w > 15 "
        "and k = 1"))
    pb = eng.planner.plan_select(port_parse(
        "select w from t join dim on t.a = dim.a where dim.w > 25 "
        "and k = 1"))
    assert pa.lift_sig == pb.lift_sig
    ka = lane._group_key(pa, eng.snapshot(), 1 << 20)
    kb = lane._group_key(pb, eng.snapshot(), 1 << 20)
    assert ka is not None and kb is not None and ka != kb


def test_identical_texts_run_once(monkeypatch, tables):
    eng = _lane_engine(monkeypatch, tables, 500, 6)
    sql = "select a, sum(b) as sb from t group by a order by a"
    want = eng.query(sql)
    b0 = GLOBAL.get("batch/batches")
    got, errs = _storm(eng, [sql] * 6)
    assert not errs, errs[:3]
    for i in range(6):
        assert np.array_equal(got[i].sb.to_numpy(), want.sb.to_numpy())
    assert GLOBAL.get("batch/batches") - b0 >= 1


def test_joined_shape_coalesces(monkeypatch, tables):
    texts = [f"select w from t join dim on t.a = dim.a where k = {i}"
             for i in range(8)]
    base = _lane_engine(monkeypatch, tables, 0)
    want = {i: base.query(q) for i, q in enumerate(texts)}
    eng = _lane_engine(monkeypatch, tables, 500, 8)
    eng.query(texts[0])
    q0 = GLOBAL.get("batch/coalesced_queries")
    got, errs = _storm(eng, texts)
    assert not errs, errs[:3]
    _equal_frames(got, want, texts)
    assert GLOBAL.get("batch/coalesced_queries") - q0 >= 2


def test_build_param_divergence_and_shape_drift(monkeypatch, tables):
    texts = [f"select w from t join dim on t.a = dim.a "
             f"where dim.nm in ('n{i}', 'n{i + 1}') and k = {i + 1}"
             for i in range(4)]
    texts.append("select k from t where a in (1, 2) order by k limit 4")
    texts.append("select k from t where a in (1, 2, 3) order by k limit 4")
    base = _lane_engine(monkeypatch, tables, 0)
    want = {i: base.query(q) for i, q in enumerate(texts)}
    eng = _lane_engine(monkeypatch, tables, 500, len(texts))
    for q in texts:
        eng.query(q)
    got, errs = _storm(eng, texts)
    assert not errs, errs[:3]
    _equal_frames(got, want, texts)


def test_zero_literal_limit_variants(monkeypatch, tables):
    texts = ["select k from t order by k limit 3",
             "select k from t order by k limit 5",
             "select k from t order by k limit 4 offset 2",
             "select k from t order by k limit 3"]
    base = _lane_engine(monkeypatch, tables, 0)
    want = {i: base.query(q) for i, q in enumerate(texts)}
    assert [len(w) for w in want.values()] == [3, 5, 4, 3]
    eng = _lane_engine(monkeypatch, tables, 500, 4)
    for q in texts:
        eng.query(q)
    q0 = GLOBAL.get("batch/coalesced_queries")
    got, errs = _storm(eng, texts)
    assert not errs, errs[:3]
    _equal_frames(got, want, texts)
    assert GLOBAL.get("batch/coalesced_queries") - q0 >= 2


def test_batched_failure_reaches_every_member(monkeypatch, tables):
    """Nothing in the port's batched execution is traced, so a failure
    there is a fault: it reaches every member's caller instead of a
    per-member rerun (no `batch/trace_errors` fallback)."""
    from ydb_tpu_torch.ops.cuda import bindings as K
    eng = _lane_engine(monkeypatch, tables, 500, 4)
    texts = [f"select k from t where a = {i} order by k limit 5"
             for i in range(4)]
    for q in texts:
        eng.query(q)

    def broken(*_a, **_k):
        raise RuntimeError("CUDA kernel compact_batched failed: cudaError 700")
    monkeypatch.setattr(K, "compact_batched", broken)
    f0 = GLOBAL.get("batch/fallbacks")
    got, errs = _storm(eng, texts)
    assert not got
    assert len(errs) == 4
    assert all("compact_batched failed" in str(e) for _i, e in errs)
    assert GLOBAL.get("batch/fallbacks") == f0


# -- (c) member-axis plain versions and `_eval` ------------------------------

B, N = 5, 700


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _agg_inputs(rng, per_member: bool):
    shape = (B, N) if per_member else (N,)
    f = _t(rng.normal(size=shape) * 1e3)
    i = _t(rng.integers(-(1 << 40), 1 << 40, shape))
    u = _t(rng.integers(-(1 << 62), 1 << 62, shape))      # uint64 bits
    v = _t(rng.random(shape) < 0.8)
    return [("sum", f, None, False), ("sum", i, v, False),
            ("min", f, v, False), ("max", i, None, False),
            ("min", u, None, True), ("max", u, v, True),
            ("count", None, v, False), ("first", None, v, False),
            ("first", None, None, False)]


def _member(x, b):
    return None if x is None else (x[b] if x.dim() == 2 else x)


def _assert_close(got, want):
    if want.dtype.is_floating_point:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("per_member", [False, True])
@pytest.mark.parametrize("nb", [1, 12, 512])
def test_bucket_agg_batched_plain_is_b_single_calls(nb, per_member):
    from ydb_tpu_torch.ops.cuda import bindings as K
    rng = _rng(nb + per_member)
    masks = _t(rng.random((B, N)) < 0.6)
    masks[2] = False                       # a member with no live row
    aggs = _agg_inputs(rng, per_member)
    kid = None
    if nb > 1:
        kid = _t(rng.integers(0, nb, (B, N) if per_member else (N,))
                 .astype(np.int32))
    vals, cnts, pres = K.bucket_agg_batched_plain(kid, nb, masks, aggs)
    for b in range(B):
        one = [(f, _member(d, b), _member(v, b), u) for f, d, v, u in aggs]
        wv, wc, wp = K.bucket_agg_plain(_member(kid, b), nb, masks[b], one)
        assert torch.equal(pres[b], wp)
        for a in range(len(aggs)):
            _assert_close(vals[a][b], wv[a])
            assert torch.equal(cnts[a][b], wc[a])


@pytest.mark.parametrize("per_member", [False, True])
def test_segment_agg_batched_plain_is_b_single_sorts(per_member):
    """One sort over the union of the masks serves every member: each
    member's groups, leads and folds equal a sort of its rows alone."""
    from ydb_tpu_torch.ops.cuda import bindings as K
    from ydb_tpu_torch.ops.sort import encode_key
    rng = _rng(11 + per_member)
    masks = _t(rng.random((B, N)) < 0.3)
    masks[1] = False
    masks[3] = masks[0]                    # identical members
    words = [encode_key(_t(rng.integers(0, 40, N))),
             encode_key(_t(rng.integers(0, 3, N)))]
    aggs = _agg_inputs(rng, per_member)
    oc = 256
    union = masks.any(0)
    perm = K.sort_perm_plain([encode_key((~union).to(torch.int64))] + words,
                             N, "cpu")
    ng, lead, pres, vals, cnts = K.segment_agg_batched_plain(
        perm, words, masks, aggs, oc)
    for b in range(B):
        pb = K.sort_perm_plain(
            [encode_key((~masks[b]).to(torch.int64))] + words, N, "cpu")
        one = [(f, _member(d, b), _member(v, b), u) for f, d, v, u in aggs]
        wn, wl, wp, wv, wc = K.segment_agg_plain(pb, words, masks[b], one,
                                                 oc)
        assert int(ng[b]) == int(wn)
        assert torch.equal(lead[b], wl)
        assert torch.equal(pres[b], wp)
        for a in range(len(aggs)):
            _assert_close(vals[a][b], wv[a])
            assert torch.equal(cnts[a][b], wc[a])


@pytest.mark.parametrize("shared_len", [False, True])
def test_compact_batched_plain_is_b_single_calls(shared_len):
    from ydb_tpu_torch.ops.cuda import bindings as K
    rng = _rng(3 + shared_len)
    masks = _t(rng.random((B, N)) < 0.5)
    masks[4] = False
    lengths = 650 if shared_len else _t(rng.integers(0, N + 1, B)
                                        .astype(np.int32))
    cols = [_t(rng.integers(0, 1 << 40, N)), _t(rng.normal(size=(B, N))),
            _t(rng.integers(0, 100, (B, N)).astype(np.int32)),
            _t(rng.random(N) < 0.5)]
    for new_cap in (N, 64):
        outs, live, new_len, ovf = K.compact_batched_plain(
            cols, masks, lengths, N, new_cap, B)
        for b in range(B):
            ln = lengths if shared_len else lengths[b]
            wo, wl, wn, wv = K.compact_plain([_member(c, b) for c in cols],
                                             masks[b], ln, N, new_cap)
            assert int(live[b]) == int(wl) and int(new_len[b]) == int(wn)
            assert bool(ovf[b]) == bool(wv)
            for o, w in zip(outs, wo):
                assert torch.equal(o[b], w)


def test_member_key_groups_equal_b_single_sorts():
    """Group keys that differ per member: one sort of the B·cap rows
    with the member id leading, split back into each member's groups."""
    from ydb_tpu_torch.ops import torch_exec as X
    from ydb_tpu_torch.ops.cuda import bindings as K
    from ydb_tpu_torch.ops.sort import encode_key
    rng = _rng(5)
    masks = _t(rng.random((B, N)) < 0.4)
    masks[0] = False
    words = [encode_key(_t(rng.integers(0, 30, (B, N))))]
    aggs = _agg_inputs(rng, False)
    oc = 128
    ng, lead, pres, vals, cnts = X._member_key_groups(words, masks, aggs, N,
                                                      oc, "cpu")
    for b in range(B):
        wb = [w[b].contiguous() for w in words]
        pb = K.sort_perm_plain(
            [encode_key((~masks[b]).to(torch.int64))] + wb, N, "cpu")
        wn, wl, wp, wv, wc = K.segment_agg_plain(pb, wb, masks[b], aggs, oc)
        assert int(ng[b]) == int(wn)
        assert torch.equal(lead[b], wl)
        assert torch.equal(pres[b], wp)
        for a in range(len(aggs)):
            _assert_close(vals[a][b], wv[a])
            assert torch.equal(cnts[a][b], wc[a])


def _kernel_exprs():
    """One expression per function of `ops/kernels.py`, each reading the
    per-member param `p` (or the per-member LUT `lut`)."""
    from ydb_tpu_torch.core import dtypes as dt
    from ydb_tpu_torch.ops import ir
    from ydb_tpu_torch.ops.kernels import KERNELS
    i64 = dt.DType(dt.Kind.INT64, False)
    p = ir.Param("p", i64)
    pf = ir.call("cast", p, to="float64")
    x, y, f = ir.Col("x"), ir.Col("y"), ir.Col("f")
    unary_int = {"neg", "abs", "year", "month", "day_of_month",
                 "hour_of_day", "minute_of_hour", "second_of_minute",
                 "hash64", "is_null", "is_not_null", "typed_null"}
    unary_float = {"floor", "ceil", "round", "sqrt", "exp", "ln"}
    exprs = {}
    for op in sorted(KERNELS):
        if op in unary_int:
            e = ir.call(op, ir.call("add", x, p))
        elif op in unary_float:
            e = ir.call(op, ir.call("mul", f, pf))
        elif op in ("and", "or", "xor"):
            e = ir.call(op, ir.call("gt", x, p), ir.call("lt", y, p))
        elif op == "not":
            e = ir.call(op, ir.call("gt", x, p))
        elif op == "if":
            e = ir.call(op, ir.call("gt", x, p), y, p)
        elif op == "coalesce":
            e = ir.call(op, ir.call("typed_null", p), y)
        elif op == "cast":
            e = ir.call(op, ir.call("add", x, p), to="float64")
        elif op == "pow":
            e = ir.call(op, f, ir.call("div", pf, ir.Const(7.0, dt.DType(
                dt.Kind.FLOAT64, False))))
        elif op == "take_lut":
            e = ir.call(op, ir.Col("code"), ir.Param("lut", i64,
                                                     is_array=True))
        elif op == "hash_combine":
            e = ir.call(op, ir.call("hash64", x),
                        ir.call("hash64", ir.call("add", y, p)))
        else:                                  # binary arithmetic / compare
            e = ir.call(op, x, p)
        exprs[op] = e
    return exprs


@pytest.mark.parametrize("op", sorted(_kernel_exprs()))
def test_eval_with_per_member_param_is_b_single_evals(op):
    from ydb_tpu_torch.ops.torch_exec import PerMember, _eval
    rng = _rng(sorted(_kernel_exprs()).index(op))
    cap = 64
    env = {"x": (_t(rng.integers(-50, 10 ** 6, cap)), _t(rng.random(cap)
                                                         < 0.9)),
           "y": (_t(rng.integers(1, 50, cap)), None),
           "f": (_t(rng.random(cap) * 10), None),
           "code": (_t(rng.integers(-1, 6, cap).astype(np.int32)), None)}
    ps = rng.integers(1, 40, B)
    luts = rng.integers(-3, 100, (B, 6))
    expr = _kernel_exprs()[op]
    params = {"p": PerMember(_t(ps)), "lut": PerMember(_t(luts))}
    d, v = _eval(expr, env, params, cap, "cpu")
    for b in range(B):
        wd, wv = _eval(expr, env, {"p": np.int64(ps[b]), "lut": _t(luts[b])},
                       cap, "cpu")
        db = d[b] if d.dim() == 2 else d
        if wd.dtype.is_floating_point:
            np.testing.assert_allclose(db.numpy(), wd.numpy(), rtol=1e-12,
                                       equal_nan=True)
        else:
            assert torch.equal(db, wd), b
        if wv is None:
            assert v is None or bool((v[b] if v.dim() == 2 else v).all())
        else:
            vb = v[b] if v.dim() == 2 else v
            assert torch.equal(vb, wv), b


# -- (d) the lane's consumers of an undefined compaction tail ---------------
#
# On the card `compact_batched` writes only each member's live prefix
# [0, new_len); the rest of a (B, cap) output holds whatever the memory
# held. Here its plain version's tails are poisoned (NaN, -1 and the
# integer extremes, True) wherever the wrapper leaves them undefined, and
# every serving template must still answer as the lane without the
# patch and as the JAX engine do: nothing after a compaction reads a
# tail as a value that reaches an answer, as an index or as a length.

POISON_TEMPLATES = ("q1", "q6", "q12", "q14", "q19", "point", "c36", "c37",
                    "c40", "c42")
POISON_B = 8
POISON_COMPACTS = ("q1", "q12", "point", "c36", "c37")


def _poisoned(real):
    def compact_batched_plain(cols, masks, lengths, n, new_cap, B,
                              zero_tail=False):
        outs, live, new_len, ovf = real(cols, masks, lengths, n, new_cap, B)
        if zero_tail:                     # the wrapper zeroes these
            return outs, live, new_len, ovf
        slot = torch.arange(new_cap)
        tail = slot[None, :] >= new_len.to(torch.int64)[:, None]
        bad = []
        for o in outs:
            if o.dtype == torch.bool:
                fill = torch.ones_like(o)
            elif o.dtype.is_floating_point:
                fill = torch.full_like(o, float("nan"))
            else:
                info = torch.iinfo(o.dtype)
                cyc = torch.tensor([-1, info.min, info.max], dtype=o.dtype)
                fill = cyc[slot % 3].expand_as(o)
            bad.append(torch.where(tail, fill, o))
        return bad, live, new_len, ovf
    return compact_batched_plain


@pytest.fixture(scope="module")
def hits_engines():
    from ydb_tpu.bench.clickbench_gen import load_hits as jax_load_hits
    from ydb_tpu_torch.bench.clickbench_gen import load_hits
    je = JaxEngine(block_rows=1 << 13)
    jax_load_hits(je.catalog, n_rows=20_000, shards=2, portion_rows=1 << 12)
    pe = PortEngine(device="cpu", block_rows=1 << 13)
    load_hits(pe.catalog, n_rows=20_000, shards=2, portion_rows=1 << 12)
    return je, pe


def _template_texts(name, pe):
    if name == "point":
        keys = pe.query("select o_orderkey from orders")["o_orderkey"]
        return serving.point_variants(np.asarray(keys), POISON_B, seed=5)
    return serving.variants(name, POISON_B, seed=5)


@pytest.mark.parametrize("name", POISON_TEMPLATES)
def test_poisoned_compaction_tails_change_no_answer(
        request, monkeypatch, entry_calls, name):
    from ydb_tpu_torch.ops.cuda import bindings as K
    je, pe = request.getfixturevalue(
        "hits_engines" if name.startswith("c") else "tpch_engines")
    texts = _template_texts(name, pe)
    assert len(set(texts)) == POISON_B
    want, _ = _batched(je, jax_parse, texts)
    clean, _ = _batched(pe, port_parse, texts)
    calls = dict(entry_calls)
    monkeypatch.setattr(K, "compact_batched_plain",
                        _poisoned(K.compact_batched_plain))
    got, _ = _batched(pe, port_parse, texts)
    assert want is not None and clean is not None
    _assert_blocks_match(clean, want, texts)
    _assert_blocks_match(got, clean, texts)
    # the templates whose batch compacts through compact_batched (q6,
    # q14 and q19 are keyless; c40 and c42 compact inside
    # segment_agg_batched, which zeroes its tails)
    compacted = entry_calls.get("compact_batched", 0) > calls.get(
        "compact_batched", 0)
    assert compacted == (name in POISON_COMPACTS), entry_calls
