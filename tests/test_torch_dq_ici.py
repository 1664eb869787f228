"""The DQ channel ICI plane of the port (`ydb_tpu_torch/dq/ici.py`)
against the reference's (`ydb_tpu/dq/ici.py`): ports of
`tests/test_dq_ici.py` and `tests/test_dq_spine.py` on their t/u harness
(`tests/torch_dq_util.py`, filled by the port's loader and by the
reference's catalog calls with the same split).

Every query runs through `ShardedCluster.query` over in-process
`LocalWorker`s on the CPU, with `YDB_TPU_DQ_PLANE=host` (frames through
the exchange buffers) as the byte-equal oracle of the ICI plane, and the
reference cluster's answer beside it. Quantization
(`YDB_TPU_DQ_QUANT=1`): SUM/AVG within the reference's declared 2e-2,
keys and COUNT/MIN/MAX exact, non-quantizable columns refused. The
exchange itself is held against the reference's on the same producer
inputs: the bucket planes, the count matrices (solo and batched), the
landed rows and the stats dict.

Not ported here: the reference's `test_plane_visible_in_explain_and_
sysview`, which also reads `.sys/dq_stage_stats`; system views wait for
ROADMAP Queue 1 item 4. The router's EXPLAIN lines are held in
`tests/test_torch_explain.py`.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from tests.torch_dq_util import (JOIN_SQL, NW, ROWS, cluster, frames_equal,
                                 port_engines, ref_engines, tu_tables)
from ydb_tpu_torch.cluster.router import ShardedCluster as PortCluster
from ydb_tpu_torch.dq.graph import (BROADCAST, HASH_SHUFFLE, UNION_ALL,
                                    Channel, Stage, StageGraph)
from ydb_tpu_torch.dq.lower import DqLowerError, DqTopology, lower_select
from ydb_tpu_torch.dq.runner import DqTaskRunner, LocalWorker
from ydb_tpu_torch.sql import parse
from ydb_tpu_torch.utils.metrics import GLOBAL
from tests import torch_threads  # noqa: F401,E402

# the reference's declared quantization tolerance (tests/test_dq_ici.py)
QUANT_RTOL = 2e-2
KEYS = {"t": ["id"], "u": ["uid"]}


@pytest.fixture(scope="module")
def clusters():
    tables = tu_tables()
    port = cluster("port", port_engines(tables, NW), KEYS, name="pw")
    ref = cluster("ref", ref_engines(tables, NW), KEYS, name="rw")
    return port, ref, {}


def _ref_answer(clusters, monkeypatch, sql, **env):
    """The reference cluster's answer under `env` (cached per module)."""
    _port, ref, memo = clusters
    key = (sql, tuple(sorted(env.items())))
    if key not in memo:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        memo[key] = ref.query(sql)
    return memo[key]


def _plane(monkeypatch, c, sql, plane, quant="0"):
    monkeypatch.setenv("YDB_TPU_DQ_PLANE", plane)
    monkeypatch.setenv("YDB_TPU_DQ_QUANT", quant)
    return c.query(sql)


# -- lowering: plane selection ---------------------------------------------


def _cols(table):
    return {"t": ["id", "k", "v", "tag", "nv"],
            "u": ["uid", "w", "x"]}[table]


def _topo(ici_devices):
    return DqTopology(n_workers=2, key_columns=dict(KEYS),
                      ici_devices=ici_devices)


def test_lowering_picks_ici_for_colocated_edges():
    g = lower_select(parse(JOIN_SQL), _topo(ici_devices=2), _cols)
    planes = {ch.kind: ch.plane for ch in g.channels.values()}
    assert planes["hash_shuffle"] == "ici"
    assert planes["union_all"] == "host"
    assert "plane=ici" in g.explain()


def test_lowering_keeps_host_without_devices(monkeypatch):
    g = lower_select(parse(JOIN_SQL), _topo(ici_devices=0), _cols)
    assert all(ch.plane == "host" for ch in g.channels.values())
    monkeypatch.setenv("YDB_TPU_DQ_PLANE", "host")
    g = lower_select(parse(JOIN_SQL), _topo(ici_devices=2), _cols)
    assert all(ch.plane == "host" for ch in g.channels.values())
    monkeypatch.setenv("YDB_TPU_DQ_PLANE", "ici")
    with pytest.raises(DqLowerError, match="device-colocated"):
        lower_select(parse(JOIN_SQL), _topo(ici_devices=0), _cols)


def test_router_offers_one_device_per_in_process_worker(clusters):
    port, _ref, _m = clusters
    assert port._ici_devices() == NW
    g = port.plan(JOIN_SQL)
    assert {ch.plane for ch in g.channels.values()
            if ch.kind == HASH_SHUFFLE} == {"ici"}


def test_lowering_proves_quant_tolerance():
    g = lower_select(parse(
        "select k, sum(w) as s, avg(x) as a, min(w) as mn from t, u "
        "where k = uid group by k"), _topo(2), _cols)
    by_key = {ch.key: ch for ch in g.channels.values()
              if ch.kind == "hash_shuffle"}
    assert by_key["uid"].quant_cols == ["x"]
    assert by_key["k"].quant_cols == []


def test_graph_validate_rejects_ici_router_bound():
    ch = Channel(id="c1", kind=UNION_ALL, src_stage="s0", plane="ici")
    g = StageGraph(stages=[Stage(id="s0", sql="x", outputs=["c1"]),
                           Stage(id="merge", inputs=["c1"],
                                 on="router")],
                   channels={"c1": ch}, tag="v")
    with pytest.raises(ValueError, match="ICI-plane and router-bound"):
        g.validate()


# -- execution: ICI vs host plane, port vs reference -----------------------

STRING_SQL = ("select tag, count(*) as n, sum(v) as s, sum(nv) as sn "
              "from t, u where k = uid group by tag order by tag")


@pytest.mark.parametrize("sql", [JOIN_SQL, STRING_SQL],
                         ids=["join", "strings_and_nulls"])
def test_ici_byte_equal_to_host_and_reference(monkeypatch, clusters, sql):
    port, _ref, _m = clusters
    want = _plane(monkeypatch, port, sql, "host")
    b0 = GLOBAL.get("dq/ici_bytes")
    cb0 = GLOBAL.get("dq/channel_bytes")
    f0 = GLOBAL.get("dq/ici_frames")
    got = _plane(monkeypatch, port, sql, "auto")
    frames_equal(got, want)
    # the edges' bytes moved planes: a device exchange, no npz frames
    assert GLOBAL.get("dq/ici_bytes") > b0
    assert GLOBAL.get("dq/channel_bytes") == cb0
    assert GLOBAL.get("dq/ici_frames") - f0 >= 2 * NW * NW
    frames_equal(got, _ref_answer(clusters, monkeypatch, sql,
                                  YDB_TPU_DQ_PLANE="auto",
                                  YDB_TPU_DQ_QUANT="0"))


@pytest.mark.parametrize("sql", [
    "select k, count(*) as n, sum(w) as s from t, u "
    "where k = uid and v < -1 group by k order by k",
    "select k, count(*) as n, sum(w) as s from t, u "
    "where k = uid and k = 3 group by k order by k"],
    ids=["zero_rows", "one_key"])
def test_zero_row_and_skewed_shapes(monkeypatch, clusters, sql):
    port, _ref, _m = clusters
    want = _plane(monkeypatch, port, sql, "host")
    frames_equal(_plane(monkeypatch, port, sql, "auto"), want)


def test_planned_join_is_free_of_in_plan_readbacks(monkeypatch, clusters):
    port, _ref, _m = clusters
    _plane(monkeypatch, port, JOIN_SQL, "auto")          # warm
    n0 = GLOBAL.get("hostsync/to_pandas_in_plan")
    h0 = GLOBAL.get("devlink/handoffs")
    _plane(monkeypatch, port, JOIN_SQL, "auto")
    assert GLOBAL.get("hostsync/to_pandas_in_plan") == n0
    assert GLOBAL.get("devlink/handoffs") > h0


@pytest.mark.parametrize("keys", [[5] * ROWS,
                                  [3 if i % 10 else i % 7
                                   for i in range(ROWS)]],
                         ids=["one_bucket", "heavy_skew"])
def test_planned_skew_byte_equal(monkeypatch, keys):
    c = cluster("port", port_engines(tu_tables(keys=keys), NW), KEYS)
    want = _plane(monkeypatch, c, JOIN_SQL, "host")
    frames_equal(_plane(monkeypatch, c, JOIN_SQL, "auto"), want)


def test_single_worker_degenerate(monkeypatch):
    c = cluster("port", port_engines(tu_tables(), 1), KEYS)
    assert c._ici_devices() == 1
    want = _plane(monkeypatch, c, JOIN_SQL, "host")
    frames_equal(_plane(monkeypatch, c, JOIN_SQL, "auto"), want)


def test_forged_low_bound_overflow_rerun(monkeypatch, clusters):
    port, _ref, _m = clusters
    want = _plane(monkeypatch, port, JOIN_SQL, "host")
    orig = PortCluster._lower

    def forged(self, stmt):
        g = orig(self, stmt)
        for ch in g.channels.values():
            if ch.kind == HASH_SHUFFLE:
                ch.out_bound = 1
        return g

    monkeypatch.setattr(PortCluster, "_lower", forged)
    r0 = GLOBAL.get("dq/planned_overflow_reruns")
    got = _plane(monkeypatch, port, JOIN_SQL, "auto")
    assert GLOBAL.get("dq/planned_overflow_reruns") > r0
    frames_equal(got, want)


@pytest.mark.parametrize("sql", [JOIN_SQL, STRING_SQL],
                         ids=["join", "strings_and_nulls"])
def test_lever_off_runs_the_legacy_exchange(monkeypatch, clusters, sql):
    port, _ref, _m = clusters
    want = _plane(monkeypatch, port, sql, "host")
    monkeypatch.setenv("YDB_TPU_DQ_PLANNED", "0")
    n0 = GLOBAL.get("hostsync/to_pandas_in_plan")
    b0 = GLOBAL.get("dq/ici_bytes")
    got = _plane(monkeypatch, port, sql, "auto")
    frames_equal(got, want)
    assert GLOBAL.get("hostsync/to_pandas_in_plan") > n0
    assert GLOBAL.get("dq/ici_bytes") > b0


# -- quantization ----------------------------------------------------------

QUANT_SQL = ("select k, count(*) as n, sum(x) as s, avg(x) as a from t, u "
             "where k = uid group by k order by k")


def test_quant_within_declared_tolerance(monkeypatch, clusters):
    port, _ref, _m = clusters
    want = _plane(monkeypatch, port, QUANT_SQL, "auto", quant="0")
    q0 = GLOBAL.get("dq/quant_bytes_saved")
    got = _plane(monkeypatch, port, QUANT_SQL, "auto", quant="1")
    frames_equal(got, want, rtol=QUANT_RTOL, loose_cols=("s", "a"))
    assert GLOBAL.get("dq/quant_bytes_saved") > q0
    # the reference's quantized answer: the same declared tolerance (the
    # reference's segments carry other rows past their counts into the
    # block scales, the port's zeros; ROADMAP Queue 3)
    ref = _ref_answer(clusters, monkeypatch, QUANT_SQL,
                      YDB_TPU_DQ_PLANE="auto", YDB_TPU_DQ_QUANT="1")
    frames_equal(got, ref, rtol=QUANT_RTOL, loose_cols=("s", "a"))


def test_quant_never_touches_keys_count_min_max(monkeypatch, clusters):
    port, _ref, _m = clusters
    want = _plane(monkeypatch, port, JOIN_SQL, "auto", quant="0")
    got = _plane(monkeypatch, port, JOIN_SQL, "auto", quant="1")
    frames_equal(got, want, rtol=QUANT_RTOL, loose_cols=("s",))
    for col in ("k", "n", "mn", "mx"):
        assert np.array_equal(got[col].to_numpy(), want[col].to_numpy())


def test_quant_refused_on_unquantizable_column(monkeypatch, clusters):
    port, _ref, _m = clusters
    sql = ("select k, sum(nv) as sn from t, u where k = uid "
           "group by k order by k")
    want = _plane(monkeypatch, port, sql, "auto", quant="0")
    r0 = GLOBAL.get("dq/quant_refused")
    got = _plane(monkeypatch, port, sql, "auto", quant="1")
    assert GLOBAL.get("dq/quant_refused") > r0
    frames_equal(got, want)


# -- failure: what falls back and what reaches the caller ------------------


class _DieOnIciLand(LocalWorker):
    """A worker whose device plane 'dies' mid-exchange: the first landed
    partition raises a transport error."""

    def __init__(self, engine, name=""):
        super().__init__(engine, name=name)
        self.armed = True

    def ici_land(self, channel, df, nbytes, src="ici", seq=None):
        if self.armed:
            self.armed = False
            raise ConnectionError("worker lost mid-collective")
        return super().ici_land(channel, df, nbytes, src=src, seq=seq)


def _port_cluster_of(workers, engines):
    c = PortCluster(workers, merge_engine=engines[0])
    c.key_columns.update(KEYS)
    return c


def test_mid_collective_death_falls_back_to_host(monkeypatch, clusters):
    engines = port_engines(tu_tables(), NW)
    c = _port_cluster_of([_DieOnIciLand(engines[0], name="die0"),
                          LocalWorker(engines[1], name="ok1")], engines)
    f0 = GLOBAL.get("dq/ici_fallbacks")
    got = _plane(monkeypatch, c, JOIN_SQL, "auto")
    assert GLOBAL.get("dq/ici_fallbacks") > f0
    frames_equal(got, _plane(monkeypatch, clusters[0], JOIN_SQL, "host"))


def test_kernel_failure_in_exchange_propagates(monkeypatch):
    """A failure inside a DQ kernel wrapper is a fault, not a decline:
    it reaches `ShardedCluster.query`, and no edge falls back."""
    from ydb_tpu_torch.ops.cuda import bindings
    engines = port_engines(tu_tables(), NW)
    c = _port_cluster_of([LocalWorker(e, name=f"k{i}")
                          for i, e in enumerate(engines)], engines)

    def broken(*a, **k):
        raise RuntimeError("CUDA kernel dq_counts failed: cudaError 700")

    monkeypatch.setattr(bindings, "dq_counts", broken)
    f0 = GLOBAL.get("dq/ici_fallbacks")
    monkeypatch.setenv("YDB_TPU_DQ_PLANE", "auto")
    with pytest.raises(RuntimeError, match="cudaError 700"):
        c.query(JOIN_SQL)
    assert GLOBAL.get("dq/ici_fallbacks") == f0


def test_kernel_library_oserror_in_exchange_propagates(monkeypatch):
    """An OSError from a DQ kernel wrapper (a library that failed to
    build or load) is a fault too, not a lost link: it reaches the
    caller and no edge falls back."""
    from ydb_tpu_torch.ops.cuda import bindings
    engines = port_engines(tu_tables(), NW)
    c = _port_cluster_of([LocalWorker(e, name=f"o{i}")
                          for i, e in enumerate(engines)], engines)

    def broken(*a, **k):
        raise OSError("libquant.so: cannot open shared object file")

    monkeypatch.setattr(bindings, "dq_counts", broken)
    f0 = GLOBAL.get("dq/ici_fallbacks")
    monkeypatch.setenv("YDB_TPU_DQ_PLANE", "auto")
    with pytest.raises(OSError, match="cannot open shared object"):
        c.query(JOIN_SQL)
    assert GLOBAL.get("dq/ici_fallbacks") == f0


def test_kernel_library_load_failure_raises_runtime_error(monkeypatch):
    """`bindings._fn` turns a build's or a load's OSError into a
    RuntimeError naming the library."""
    from ydb_tpu_torch.ops.cuda import bindings, build

    def no_build(names, verbose=False):
        raise OSError("nvcc: Permission denied")

    monkeypatch.setattr(build, "build_all", no_build)
    monkeypatch.setattr(bindings, "_LIBS", {})
    with pytest.raises(RuntimeError, match="dq_counts failed to build"):
        bindings._fn("dq_counts")


def test_broadcast_edge_rides_ici():
    """A hand-built Broadcast edge on the ICI plane: every consumer
    lands EVERY producer's rows."""
    engines = port_engines(tu_tables(), NW)
    workers = [LocalWorker(e, name=f"bc{i}") for i, e in enumerate(engines)]
    ch = Channel(id="dqc_ici_b1", kind=BROADCAST, src_stage="s0",
                 dst_stage="s1", columns=["id", "v"],
                 table="__xj_dq_ici_bcast", plane="ici")
    out = Channel(id="dqc_ici_b2", kind=UNION_ALL, src_stage="s1")
    g = StageGraph(
        stages=[Stage(id="s0", sql="select id, v from t",
                      outputs=[ch.id]),
                Stage(id="s1",
                      sql=f"select count(*) as c, sum(v) as s "
                          f"from {ch.table}",
                      inputs=[ch.id], outputs=[out.id]),
                Stage(id="merge", inputs=[out.id], on="router",
                      merge_sel=None)],
        channels={ch.id: ch, out.id: out}, tag="icib")
    b0 = GLOBAL.get("dq/ici_bytes")
    got = DqTaskRunner(workers, engines[0]).run(g)
    want_s = sum(i * 0.5 for i in range(ROWS))
    assert list(got.c) == [ROWS, ROWS]
    assert list(got.s) == [want_s, want_s]
    assert GLOBAL.get("dq/ici_bytes") > b0
    assert ch.plane == "ici"


# -- the exchange against the reference's, on the same producer inputs ----


def _producers(pkg: str, n: int, seed: int):
    """`n` producer blocks of (k int64 with NULLs, s string, f float64,
    g int32) in `pkg`'s HostBlock."""
    if pkg == "port":
        from ydb_tpu_torch.core.block import HostBlock
        from ydb_tpu_torch.core.dictionary import Dictionary
        from ydb_tpu_torch.core.dtypes import DType, Kind
        from ydb_tpu_torch.core.schema import Column, Schema
    else:
        from ydb_tpu.core.block import HostBlock
        from ydb_tpu.core.dictionary import Dictionary
        from ydb_tpu.core.dtypes import DType, Kind
        from ydb_tpu.core.schema import Column, Schema
    schema = Schema([Column("k", DType(Kind.INT64, True)),
                     Column("s", DType(Kind.STRING, False)),
                     Column("f", DType(Kind.FLOAT64, False)),
                     Column("g", DType(Kind.INT32, False))])
    rng = np.random.default_rng(seed)
    out = []
    for p in range(n):
        m = int(rng.integers(0, 700))
        d = Dictionary()
        codes = d.encode_bulk(np.array(
            [f"v{x}" for x in rng.integers(p, p + 40, m)], dtype=object))
        out.append(HostBlock.from_arrays(
            schema,
            {"k": rng.integers(-(1 << 40), 1 << 40, m),
             "s": codes.astype(np.int32),
             "f": rng.normal(size=m) * 100.0 + 1000.0,
             "g": rng.integers(0, 50, m).astype(np.int32)},
            valids={"k": rng.random(m) > 0.1},
            dictionaries={"s": d}))
    return out


def _channel(pkg: str, key: str, cid: str, quant=()):
    if pkg == "port":
        from ydb_tpu_torch.dq.graph import Channel as C
    else:
        from ydb_tpu.dq.graph import Channel as C
    return C(id=cid, kind=HASH_SHUFFLE, src_stage="s0", dst_stage="s1",
             key=key, columns=["k", "s", "f", "g"], table=f"__x_{cid}",
             plane="ici", quant_cols=list(quant))


@pytest.mark.parametrize("key,quant", [("k", "0"), ("s", "0"), ("k", "1")],
                         ids=["int_key", "string_key", "int_key_quant"])
def test_exchange_blocks_equal_to_reference(monkeypatch, key, quant):
    from ydb_tpu.dq import ici as rici
    from ydb_tpu_torch.dq import ici as pici
    from ydb_tpu_torch.ops.cuda import bindings as K
    monkeypatch.setenv("YDB_TPU_DQ_QUANT", quant)
    n = 4
    pb, rb = _producers("port", n, 11), _producers("ref", n, 11)
    pch, rch = (_channel("port", key, "c", quant=["f"]),
                _channel("ref", key, "c", quant=["f"]))
    devs = [torch.device("cpu")] * n
    # the bucket planes and the count matrix
    pst = pici._prepare_exchange(pch, pb, None, None, devs)
    rst = rici._prepare_exchange(rch, rb, None, None)
    assert pst["cap"] == rst["cap"]
    want_plane = np.asarray(rst["bucket"])
    got_plane = pst["plane"].numpy()
    assert np.array_equal(got_plane, want_plane)
    want_counts = np.asarray(rici._build_counts_fn(n, rst["cap"])(
        rst["bucket"]))
    assert np.array_equal(pici._exchange_counts(pst), want_counts)
    assert np.array_equal(
        K.dq_counts_plain(torch.from_numpy(want_plane.copy())[None], n)[0].numpy(),
        want_counts)
    # the landed rows and the stats dict
    pout, pstats = pici.exchange_blocks(pch, pb, devices=devs)
    rout, rstats = rici.exchange_blocks(rch, rb)
    assert pstats == rstats
    loose = ()
    if quant == "1":
        assert pstats["quant_cols"] == ["f"]
        # a segment's slots past its count are zero in the port and hold
        # other rows in the reference (ROADMAP Queue 3), so a block that
        # straddles the count gets another scale: the dequantized values
        # agree to the declared tolerance, the codec itself bit for bit
        # (tests/test_torch_quant.py)
        loose = ("f",)
        monkeypatch.setenv("YDB_TPU_DQ_QUANT", "0")
        exact, _s = pici.exchange_blocks(pch, pb, devices=devs)
        for p, e in zip(pout, exact):
            frames_equal(p.to_pandas(), e.to_pandas(), rtol=QUANT_RTOL,
                         loose_cols=loose)
    for p, r in zip(pout, rout):
        assert p.length == r.length
        frames_equal(p.to_pandas(), r.to_pandas(), rtol=QUANT_RTOL,
                     loose_cols=loose)


def test_batched_counts_equal_solo_counts():
    from ydb_tpu.dq import ici as rici
    from ydb_tpu_torch.dq import ici as pici
    from ydb_tpu_torch.ops.cuda import bindings as K
    n = 4
    pb, rb = _producers("port", n, 5), _producers("ref", n, 5)
    devs = [torch.device("cpu")] * n
    chans = [_channel("port", "k", "c1"), _channel("port", "s", "c2")]
    c0 = GLOBAL.get("dq/count_exchange_batched")
    batched = pici.exchange_blocks_batched(chans, pb, counters=GLOBAL,
                                           devices=devs)
    assert GLOBAL.get("dq/count_exchange_batched") == c0 + 1
    rbatched = rici.exchange_blocks_batched(
        [_channel("ref", "k", "c1"), _channel("ref", "s", "c2")], rb)
    for ch, (out, stats), (rout, rstats) in zip(chans, batched, rbatched):
        solo_out, solo = pici.exchange_blocks(ch, pb, devices=devs)
        assert stats == solo == rstats
        for a, b, r in zip(out, solo_out, rout):
            frames_equal(a.to_pandas(), b.to_pandas())
            frames_equal(a.to_pandas(), r.to_pandas())
    # the nch = 2 count launch, slice by slice
    sts = [pici._prepare_exchange(ch, pb, None, None, devs) for ch in chans]
    cap = max(st["cap"] for st in sts)
    planes = torch.stack([
        torch.nn.functional.pad(st["plane"], (0, cap - st["cap"]), value=-1)
        for st in sts])
    both = K.dq_counts(planes, n)
    for i, st in enumerate(sts):
        assert torch.equal(both[i], torch.from_numpy(
            pici._exchange_counts(st)))


def test_device_stage_block_projects_without_readback():
    from ydb_tpu_torch.core.dtypes import FLOAT64, INT64
    from ydb_tpu_torch.core.schema import Column, Schema
    from ydb_tpu_torch.ops.device import DeviceBlock, DeviceStageBlock
    dev = DeviceBlock(Schema([Column("a", INT64), Column("b", FLOAT64)]),
                      {"a": torch.arange(8), "b": torch.ones(8,
                                                             dtype=torch
                                                             .float64)},
                      {"a": torch.arange(8) % 2 == 0}, 5, 8)
    blk = DeviceStageBlock(dev, 5)
    p = blk.project([("a", "x"), ("b", "x")])
    assert not blk.materialized and not p.materialized
    assert list(p.schema.names) == ["x", "x_2"]
    assert p.live_nbytes() == 5 * 8 + 5 + 5 * 8
    df = p.to_pandas()
    assert p.materialized and len(df) == 5
    assert df["x"].tolist() == [0, None, 2, None, 4]
    assert pd.isna(df["x"]).sum() == 2
