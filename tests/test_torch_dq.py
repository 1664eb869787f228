"""The DQ task-graph runtime of the port (`ydb_tpu_torch/dq/`,
`ydb_tpu_torch/cluster/`): ports of `tests/test_dq.py`'s in-process
tests — lowering shapes and refusals, channel discipline (seq-dedup
idempotence, flow control and retry), a hand-built broadcast graph,
stage retry, permanent failure, dropping half-delivered frames and the
LocalWorker surface — and TPC-H at SF 0.002 over 4 port workers (lineitem
and orders split by the reference router's INSERT rule, the other six
tables replicated): every query that runs equals the pandas oracle, the
others raise `ClusterError` where the reference's cluster refuses; the
1-worker graph equals the port's own fused path; Q1 and a shuffle query
equal the reference's cluster on the same split.
"""

import re

import numpy as np
import pandas as pd
import pytest

from tests.torch_dq_util import cluster
from ydb_tpu_torch.bench.cluster_load import load_tpch_cluster
from ydb_tpu_torch.bench.tpch_oracle import (QUERIES, assert_frames_match,
                                             oracle)
from ydb_tpu_torch.cluster import ShardedCluster
from ydb_tpu_torch.cluster.exchange import ChannelWriter, ExchangeBuffer
from ydb_tpu_torch.cluster.router import ClusterError
from ydb_tpu_torch.dq.graph import (BROADCAST, HASH_SHUFFLE, UNION_ALL,
                                    Channel, Stage, StageGraph)
from ydb_tpu_torch.dq.lower import DqLowerError, DqTopology, lower_select
from ydb_tpu_torch.dq.runner import DqTaskRunner, LocalWorker
from ydb_tpu_torch.errors import NotPorted
from ydb_tpu_torch.query import QueryEngine
from ydb_tpu_torch.sql import parse
from ydb_tpu_torch.utils.metrics import GLOBAL
from tests import torch_threads  # noqa: F401,E402

SF = 0.002
NW = 4
REPLICATED = {"customer", "nation", "region", "part", "partsupp",
              "supplier"}
KEYS = {"lineitem": ["l_orderkey", "l_linenumber"],
        "orders": ["o_orderkey"]}
# the queries whose stage graph the reference's cluster answers: q7, q8
# and q9 lower but their join stage refers to a derived table's aliases
# (`unknown column`), in both packages
ANSWERED = ("q1", "q3", "q5", "q6", "q10", "q12", "q14", "q19")
JOIN_STAGE_FAILS = ("q7", "q8", "q9")


def _unknown_column(e) -> str:
    """The column an `unknown column` error names."""
    m = re.search(r"unknown column:? *'?([\w.]+)", str(e))
    return m.group(1) if m else str(e)


# -- lowering --------------------------------------------------------------


def _cols(table):
    return {"t": ["id", "k", "v"], "u": ["uid", "k2", "w"],
            "d": ["k", "tag"]}[table]


def _topo(n=2, sharded=("t", "u"), replicated=("d",)):
    return DqTopology(n_workers=n, replicated=set(replicated),
                      key_columns={t: ["id"] for t in sharded})


def test_lower_agg_two_stages():
    g = lower_select(parse("select k, sum(v) as s from t group by k "
                           "order by s desc limit 3"),
                     _topo(sharded=("t",)), _cols)
    assert [s.on for s in g.stages] == ["workers", "router"]
    (ch,) = g.channels.values()
    assert ch.kind == UNION_ALL and ch.router_bound
    assert g.stages[1].merge_sel is not None
    assert g.stages[1].merge_sel.limit == 3


def test_lower_scan_merge_channel():
    g = lower_select(parse("select id, v from t where k = 1 "
                           "order by v desc limit 7 offset 2"),
                     _topo(sharded=("t",)), _cols)
    (ch,) = g.channels.values()
    assert ch.kind == "merge"
    assert "limit 9" in g.stages[0].sql
    assert g.stages[1].post["limit"] == 7
    assert g.stages[1].post["offset"] == 2


def test_lower_shuffle_join_graph():
    g = lower_select(parse("select k, sum(w) as s from t, u "
                           "where id = uid and v > 1 group by k"),
                     _topo(), _cols)
    kinds = [c.kind for c in g.channels.values()]
    assert kinds.count(HASH_SHUFFLE) == 2 and kinds.count(UNION_ALL) == 1
    hash_chs = [c for c in g.channels.values() if c.kind == HASH_SHUFFLE]
    assert {c.key for c in hash_chs} == {"id", "uid"}
    for c in hash_chs:
        assert c.table.startswith("__xj_dq")
        assert c.dst_stage == "s2"
    join = g.stage("s2")
    assert set(join.inputs) == {c.id for c in hash_chs}


def test_lower_replicated_only_single_task():
    g = lower_select(parse("select count(*) as c from d"), _topo(), _cols)
    assert g.stages[0].on == "worker0"


def test_lower_refusals():
    with pytest.raises(DqLowerError, match="sharded tables"):
        lower_select(parse("select k from t, u where v > w"),
                     _topo(), _cols)
    with pytest.raises(DqLowerError, match="subquer"):
        lower_select(parse("select k from t where id in "
                           "(select uid from u)"),
                     _topo(sharded=("t",)), _cols)


# -- channel discipline ----------------------------------------------------


def test_exchange_buffer_seq_dedup():
    buf = ExchangeBuffer()
    df = pd.DataFrame({"a": [1, 2]})
    assert buf.put("ch", df, 10, src="t0", seq=0)
    assert not buf.put("ch", df, 10, src="t0", seq=0)   # retried frame
    assert buf.put("ch", df, 10, src="t1", seq=0)       # other producer
    assert buf.dup_frames == 1
    assert len(buf.take("ch")) == 4
    assert buf.put("ch", df, 10, src="t0", seq=0)       # a new epoch


def test_channel_writer_flow_control_and_retry():
    from ydb_tpu_torch.cluster.exchange import unpack_frame
    sent = []
    fails = {"n": 2}

    def send(peer, frame):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient put failure")
        sent.append((peer, frame))

    w = ChannelWriter("ch", "task0.a0", send, n_peers=2, frame_rows=10,
                      inflight_bytes=1 << 16, retries=3)
    df = pd.DataFrame({"a": np.arange(35)})
    w.ship(0, df)
    w.ship(1, df.iloc[:0])          # an empty partition still ships
    w.close()
    assert len(sent) == 5 and w.frames_sent == 5
    assert 0 < w.peak_inflight <= 1 << 16
    buf = ExchangeBuffer()
    for (_p, frame) in sent:
        h, part = unpack_frame(frame)
        assert h["src"] == "task0.a0" and isinstance(h["seq"], int)
        buf.put(h["channel"], part, len(frame), src=h["src"], seq=h["seq"])
    got = buf.take("ch")
    assert list(got.a[:35].sort_values()) == list(range(35))


def test_channel_writer_raises_after_retries():
    def send(peer, frame):
        raise OSError("dead peer")
    w = ChannelWriter("ch", "t.a0", send, n_peers=1, retries=1)
    w.ship(0, pd.DataFrame({"a": [1]}))
    with pytest.raises(OSError):
        w.close()


# -- in-process graphs -----------------------------------------------------


def _t_tables(rows):
    i = np.arange(rows)
    return {"t": ([("id", "int64", False), ("k", "int64", False),
                   ("v", "float64", False)], ["id"],
                  {"id": i.astype(np.int64), "k": (i % 7).astype(np.int64),
                   "v": i * 0.5}, {})}


def _mini(nw, rows=120, with_u=False):
    from tests.torch_dq_util import port_engines
    tables = _t_tables(rows)
    if with_u:
        j = np.arange(7)
        tables["u"] = ([("uid", "int64", False), ("w", "float64", False)],
                       ["uid"], {"uid": j.astype(np.int64),
                                 "w": j.astype(np.float64)}, {})
    return port_engines(tables, nw)


def test_broadcast_channel_hand_built_graph(monkeypatch):
    """A hand-built graph with a host-plane Broadcast edge: every worker
    ends up holding both workers' stage-0 rows."""
    engines = _mini(2, rows=40)
    workers = [LocalWorker(e, name=f"w{i}") for i, e in enumerate(engines)]
    ch = Channel(id="dqc_b_1", kind=BROADCAST, src_stage="s0",
                 dst_stage="s1", columns=["id", "v"],
                 table="__xj_dq_bcast_t")
    out = Channel(id="dqc_b_2", kind=UNION_ALL, src_stage="s1")
    g = StageGraph(
        stages=[Stage(id="s0", sql="select id, v from t", outputs=[ch.id]),
                Stage(id="s1", sql=f"select count(*) as c from {ch.table}",
                      inputs=[ch.id], outputs=[out.id]),
                Stage(id="merge", inputs=[out.id], on="router",
                      merge_sel=None)],
        channels={ch.id: ch, out.id: out}, tag="b")
    n0 = GLOBAL.get("hostsync/to_pandas_in_plan")
    got = DqTaskRunner(workers, engines[0]).run(g)
    assert list(got.c) == [40, 40]
    assert GLOBAL.get("hostsync/to_pandas_in_plan") > n0


class _FlakyWorker(LocalWorker):
    def __init__(self, engine, fail_times):
        super().__init__(engine)
        self.fail_times = fail_times

    def dq_run_task(self, **kw):
        if self.fail_times > 0:
            self.fail_times -= 1
            raise RuntimeError("injected channel failure")
        return super().dq_run_task(**kw)


def test_stage_retry_on_transient_failure():
    (eng,) = _mini(1)
    c = ShardedCluster([_FlakyWorker(eng, fail_times=1)], merge_engine=eng)
    c.key_columns["t"] = ["id"]
    before = GLOBAL.get("dq/tasks_retried")
    got = c.query("select sum(v) as s, count(*) as n from t")
    assert int(got.n[0]) == 120
    assert float(got.s[0]) == sum(i * 0.5 for i in range(120))
    assert GLOBAL.get("dq/tasks_retried") > before


def test_permanent_failure_is_clean_error():
    (eng,) = _mini(1)
    c = ShardedCluster([_FlakyWorker(eng, fail_times=99)], merge_engine=eng)
    c.key_columns["t"] = ["id"]
    with pytest.raises(ClusterError, match="failed after"):
        c.query("select sum(v) as s from t")


def test_stage_retry_drops_half_delivered_frames(monkeypatch):
    """A host-plane shuffle stage that dies AFTER shipping its frames
    must not leave them to double-count on the retry."""

    class _ShipThenDie(LocalWorker):
        def __init__(self, engine):
            super().__init__(engine)
            self.armed = True

        def dq_run_task(self, **kw):
            resp = super().dq_run_task(**kw)
            if self.armed and any(o["kind"] == "hash_shuffle"
                                  for o in kw["outputs"]):
                self.armed = False
                raise RuntimeError("reply lost after delivery")
            return resp

    monkeypatch.setenv("YDB_TPU_DQ_PLANE", "host")
    engines = _mini(2, rows=60, with_u=True)
    c = ShardedCluster([_ShipThenDie(engines[0]), LocalWorker(engines[1])],
                       merge_engine=engines[0])
    c.key_columns.update({"t": ["id"], "u": ["uid"]})
    got = c.query("select count(*) as n, sum(w) as s from t, u "
                  "where k = uid")
    li = pd.DataFrame({"k": [i % 7 for i in range(60)]})
    u = pd.DataFrame({"uid": range(7), "w": [float(i) for i in range(7)]})
    j = li.merge(u, left_on="k", right_on="uid")
    assert int(got.n[0]) == len(j)
    assert float(got.s[0]) == float(j.w.sum())


def test_local_worker_surface():
    """The worker surface the runner drives: execute's result payload,
    the task table's snapshot semantics; health and shard adoption wait
    for the cluster tooling (ROADMAP Queue 1 item 8)."""
    (eng,) = _mini(1, rows=3)
    w = LocalWorker(eng)
    assert w.device == eng.device
    resp = w.execute("select id, v from t order by id")
    assert resp["columns"] == ["id", "v"]
    assert resp["rows"] == [[0, 0.0], [1, 0.5], [2, 1.0]]
    assert w.dq_tasks() == {}
    w.dq_run_task("t1", "s0", "select * from t", [], src="w0")
    tasks = w.dq_tasks()
    assert tasks["t1"]["state"] == "finished"
    assert tasks["t1"]["attempts"] == 1
    tasks["t1"]["state"] = "mangled"
    assert w.dq_tasks()["t1"]["state"] == "finished"
    assert w.ping() and "engine/plan_cache_size" in w.counters()
    with pytest.raises(NotPorted):
        w.health()
    with pytest.raises(NotPorted):
        w.hive_adopt_shard("/nowhere")


def test_router_refuses_what_the_port_lacks():
    (eng,) = _mini(1, rows=3)
    c = ShardedCluster([LocalWorker(eng)], merge_engine=eng)
    c.key_columns["t"] = ["id"]
    with pytest.raises(NotPorted):
        c.execute("insert into t (id, k, v) values (1, 2, 3.0)")
    with pytest.raises(NotPorted):
        ShardedCluster(["localhost:1"], merge_engine=eng)
    with pytest.raises(ClusterError, match="unknown distribution"):
        c.query("select count(*) as n from t, d where t.k = d.k")


def test_create_table_broadcasts():
    engines = [QueryEngine(device="cpu", block_rows=1 << 10)
               for _ in range(2)]
    c = ShardedCluster([LocalWorker(e) for e in engines],
                       merge_engine=engines[0])
    c.execute("create table z (id Int64 not null, v Double, "
              "primary key (id))", replicated=True)
    assert all(e.catalog.has("z") for e in engines)
    assert c.key_columns["z"] == ["id"] and "z" in c.replicated


# -- TPC-H over 4 port workers ---------------------------------------------


@pytest.fixture(scope="module")
def tpch():
    engines = [QueryEngine(device="cpu", block_rows=1 << 12)
               for _ in range(NW)]
    data, rep, keys = load_tpch_cluster([e.catalog for e in engines], SF)
    assert rep == REPLICATED and keys == KEYS
    c = cluster("port", engines, keys, replicated=rep, name="tw")
    return c, data, {}


def _reference_cluster(tpch):
    """The reference's 4-worker cluster over the same split (built once
    per module)."""
    memo = tpch[2]
    if "ref" not in memo:
        from tests.torch_dq_util import ref_engines
        from ydb_tpu_torch.bench.tpch_gen import TPCH_SCHEMAS
        data = tpch[1]
        tables = {}
        for tn, (schema, pk) in TPCH_SCHEMAS.items():
            cols = [(c.name, c.dtype.kind.value, c.dtype.nullable)
                    for c in schema]
            tables[tn] = (cols, pk, data.tables[tn], {})
        memo["ref"] = cluster("ref", ref_engines(tables, NW, REPLICATED),
                              KEYS, replicated=REPLICATED, name="rt")
    return memo["ref"]


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 23)])
def test_tpch_over_four_workers(monkeypatch, tpch, q):
    c, data, _m = tpch
    monkeypatch.setenv("YDB_TPU_DQ_PLANE", "auto")
    if q not in ANSWERED:
        with pytest.raises(ClusterError):
            c.query(QUERIES[q])
        return
    b0 = GLOBAL.get("dq/ici_bytes")
    f0 = GLOBAL.get("dq/ici_fallbacks")
    got = c.query(QUERIES[q])
    assert_frames_match(got, oracle(q, data), ordered=True)
    assert GLOBAL.get("dq/ici_fallbacks") == f0
    shuffles = [ch for ch in c.plan(QUERIES[q]).channels.values()
                if ch.kind == HASH_SHUFFLE]
    assert (GLOBAL.get("dq/ici_bytes") > b0) == bool(shuffles)


def test_tpch_refusals_equal_the_reference(tpch):
    """The queries the port's cluster refuses are the reference's: its
    lowering refuses the same eleven, and its cluster fails q7, q8 and
    q9 in their join stage as the port's does."""
    from ydb_tpu.dq.lower import DqLowerError as RefLowerError
    from ydb_tpu.dq.lower import DqTopology as RefTopology
    from ydb_tpu.dq.lower import lower_select as ref_lower
    from ydb_tpu.sql import parse as ref_parse
    c = tpch[0]
    topo = RefTopology(n_workers=NW, replicated=set(REPLICATED),
                       key_columns=dict(KEYS), ici_devices=NW)
    lowered = set()
    for i in range(1, 23):
        q = f"q{i}"
        try:
            ref_lower(ref_parse(QUERIES[q]), topo, c._table_columns)
            lowered.add(q)
        except RefLowerError:
            with pytest.raises(ClusterError):
                c.plan(QUERIES[q])
    assert lowered == set(ANSWERED) | set(JOIN_STAGE_FAILS)


@pytest.mark.parametrize("q", JOIN_STAGE_FAILS)
def test_tpch_join_stage_failure_equals_the_reference(monkeypatch, tpch,
                                                      q):
    """q7, q8 and q9 lower in both packages and fail at run time in the
    same join stage, with the same `unknown column` message."""
    from ydb_tpu.cluster.router import ClusterError as RefClusterError
    monkeypatch.setenv("YDB_TPU_DQ_PLANE", "auto")
    ref = _reference_cluster(tpch)
    with pytest.raises(RefClusterError, match="unknown column") as want:
        ref.query(QUERIES[q])
    with pytest.raises(ClusterError, match="unknown column") as got:
        tpch[0].query(QUERIES[q])
    assert _unknown_column(got.value) == _unknown_column(want.value)


@pytest.mark.parametrize("q", ["q1", "q12"])
def test_tpch_equals_the_reference_cluster(monkeypatch, tpch, q):
    monkeypatch.setenv("YDB_TPU_DQ_PLANE", "auto")
    ref = _reference_cluster(tpch)
    want = ref.query(QUERIES[q])
    got = tpch[0].query(QUERIES[q])
    assert_frames_match(got, want, ordered=True)


def test_one_worker_degenerate_matches_fused_tpch():
    """The SAME statements through the DQ graph on ONE LocalWorker and
    through the port's own fused path, including the shuffle-join
    lowering (lineitem and orders sharded). Non-float columns exact,
    floats to 1e-9 relative (the stage chain sums partials in another
    order)."""
    eng = QueryEngine(device="cpu", block_rows=1 << 12)
    _data, rep, keys = load_tpch_cluster([eng.catalog], SF)
    c = ShardedCluster([LocalWorker(eng)], merge_engine=eng)
    c.key_columns.update(keys)
    c.replicated = rep
    stmts = [
        QUERIES["q1"], QUERIES["q6"],
        "select o_orderpriority, count(*) as n, sum(l_extendedprice) as s "
        "from lineitem, orders where l_orderkey = o_orderkey "
        "and l_discount > 0.02 group by o_orderpriority "
        "order by o_orderpriority",
        "select l_orderkey, l_extendedprice from lineitem "
        "where l_quantity > 45 order by l_extendedprice desc, l_orderkey "
        "limit 13",
    ]
    for sql in stmts:
        got = c.query(sql)
        want = eng.query(sql)
        assert list(got.columns) == list(want.columns), sql
        assert len(got) == len(want), sql
        for col in got.columns:
            a, b = got[col].to_numpy(), want[col].to_numpy()
            if a.dtype.kind == "f" or b.dtype.kind == "f":
                assert np.allclose(a.astype(np.float64),
                                   b.astype(np.float64), rtol=1e-9,
                                   atol=1e-9, equal_nan=True), (sql, col)
            else:
                assert np.array_equal(a, b), (sql, col)


def test_loader_splits_by_the_router_rule():
    """lineitem and orders land co-partitioned on the order key by the
    reference router's INSERT rule; the other tables whole."""
    from ydb_tpu.utils.hashing import splitmix64 as ref_splitmix64
    from ydb_tpu_torch.bench.cluster_load import worker_of
    keys = np.array([0, 1, -5, 1 << 62, 12345678901], np.int64)
    want = [int(ref_splitmix64(np, np.array([v], np.int64))[0]) % 3
            for v in keys]
    assert worker_of(keys, 3).tolist() == want
    engines = [QueryEngine(device="cpu") for _ in range(3)]
    data, _rep, _keys = load_tpch_cluster([e.catalog for e in engines],
                                          0.001)
    ok = data.tables["orders"]["o_orderkey"]
    per = [e.catalog.table("orders").num_rows for e in engines]
    assert sum(per) == len(ok)
    assert per == np.bincount(worker_of(ok, 3), minlength=3).tolist()
    li = [e.catalog.table("lineitem").num_rows for e in engines]
    assert li == np.bincount(worker_of(
        data.tables["lineitem"]["l_orderkey"], 3), minlength=3).tolist()
    assert all(e.catalog.table("nation").num_rows == 25 for e in engines)
