"""The port's tracer, histograms, critical path and resource ledger.

- The pure cases of the reference's `test_profiling.py` (histogram
  math), `test_observability.py` (tracer exception safety) and
  `test_critpath.py` (the blocking-chain math on hand-built span DAGs),
  each run over both packages' modules.
- Engine cases on the CPU (tables through `ydb_tpu_torch.interop`):
  sampling at rate 0 records no span and returns a byte-equal answer,
  fractional sampling is deterministic, a slow statement is traced on
  its next run, the phases and the profile ring, the latency
  histograms, nested statements counted once, the ledger's peak beside
  the reference's.
- The card's clock: with CUDA events stood in by a recording fake, a
  sampled statement records two events and its `device-execute` span
  carries their elapsed time; an unsampled one makes no event. A K1
  build inside a dispatch stamps `compile_ms` on the dispatch span.
"""

import importlib

import numpy as np
import pytest
import torch

from ydb_tpu_torch import interop
from ydb_tpu_torch.query import QueryEngine as PortEngine

from tests import torch_threads  # noqa: F401,E402

PACKAGES = ["ydb_tpu", "ydb_tpu_torch"]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.utils.{name}")


# -- histogram math (reference: test_profiling.py) --------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_histogram_single_sample(pkg):
    h = mod(pkg, "metrics").Histogram()
    h.record(3.7)
    s = h.snapshot()
    assert s["count"] == 1
    assert s["p50"] == s["p95"] == s["p99"] == s["max"] == 3.7


@pytest.mark.parametrize("pkg", PACKAGES)
def test_histogram_quantile_ordering_and_bounds(pkg):
    h = mod(pkg, "metrics").Histogram()
    for i in range(1000):
        h.record(0.1 * (i + 1))
    s = h.snapshot()
    assert s["count"] == 1000
    assert s["p50"] <= s["p95"] <= s["p99"] <= s["max"]
    assert 25 <= s["p50"] <= 75
    assert 50 <= s["p99"] <= 100.0
    assert s["max"] == 100.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_histogram_overflow_bucket(pkg):
    H = mod(pkg, "metrics").Histogram
    h = H()
    h.record(1.0)
    big = H.BASE * H.GROWTH ** (H.N_BUCKETS + 3)
    h.record(big)
    assert h.quantile(0.99) == big
    assert h.counts[H.N_BUCKETS] == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_histogram_zero_and_empty(pkg):
    h = mod(pkg, "metrics").Histogram()
    assert h.snapshot() == {"count": 0, "p50": 0.0, "p95": 0.0,
                            "p99": 0.0, "max": 0.0}
    h.record(0.0)
    assert h.quantile(0.5) == 0.0


def test_histogram_snapshots_equal_across_packages():
    rng = np.random.default_rng(7)
    vals = rng.lognormal(0.0, 2.0, 500)
    snaps = []
    for pkg in PACKAGES:
        h = mod(pkg, "metrics").Histogram()
        for v in vals:
            h.record(float(v))
        snaps.append((h.snapshot(), h.cumulative()))
    assert snaps[0] == snaps[1]


# -- tracer (reference: test_observability.py) ------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_tracer_force_closes_leaked_spans(pkg):
    t = mod(pkg, "tracing").Tracer()
    t.begin_trace()
    sp = t.span("leaky").__enter__()        # never exited
    t.span("inner-leak").__enter__()
    out = t.end_trace()
    assert t._stack == []
    assert all(s.dur_ms > 0 for s in out)
    t.begin_trace()
    with t.span("fresh"):
        pass
    out2 = t.end_trace()
    assert out2[0].parent_id is None
    assert out2[0].trace_id != sp.trace_id


@pytest.mark.parametrize("pkg", PACKAGES)
def test_tracer_exit_is_order_robust(pkg):
    t = mod(pkg, "tracing").Tracer()
    t.begin_trace()
    with t.span("outer"):
        t.span("leaked").__enter__()
    assert [s.name for s in t._stack] == []
    t.end_trace()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_phase_breakdown_pulls_compile_out_of_dispatch(pkg):
    tr = mod(pkg, "tracing")
    spans = [tr.Span("device-dispatch", 1, 1, None, 0.0, 50.0,
                     attrs={"compile_ms": 40.0}),
             tr.Span("device-execute", 1, 2, None, 50.0, 7.0),
             tr.Span("readout-transfer", 1, 3, None, 57.0, 1.0)]
    assert tr.phase_breakdown(spans) == {
        "dispatch_ms": 10.0, "compile_ms": 40.0, "device_ms": 7.0,
        "readout_ms": 1.0}


# -- critical path (reference: test_critpath.py) ----------------------------


def _sp(pkg, name, sid, parent, start, dur, **attrs):
    return mod(pkg, "tracing").Span(name, 1, sid, parent, float(start),
                                    float(dur), attrs=dict(attrs))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_diamond_takes_the_longer_parallel_branch(pkg):
    cp = mod(pkg, "critpath").extract([
        _sp(pkg, "dq-query", 1, None, 0, 100),
        _sp(pkg, "task-exec", 2, 1, 0, 40),
        _sp(pkg, "task-exec", 3, 1, 0, 70),
        _sp(pkg, "device-execute", 4, 1, 70, 30)])
    ids = [s["span_id"] for s in cp["segments"]]
    assert 3 in ids and 4 in ids and 2 not in ids
    assert cp["connected"]
    assert cp["classes"]["host_lane"] == pytest.approx(70, abs=0.1)
    assert cp["classes"]["device_execute"] == pytest.approx(30, abs=0.1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_fully_hidden_channel_wait_stays_off_the_path(pkg):
    cp = mod(pkg, "critpath").extract([
        _sp(pkg, "execute", 1, None, 0, 100),
        _sp(pkg, "device-execute", 2, 1, 0, 100),
        _sp(pkg, "input-wait", 3, 1, 20, 30)])
    assert "channel_wait" not in cp["classes"]
    assert cp["classes"]["device_execute"] == pytest.approx(100, abs=0.1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_serial_compile_then_execute_chain_splits_classes(pkg):
    cp = mod(pkg, "critpath").extract([
        _sp(pkg, "statement", 1, None, 0, 90),
        _sp(pkg, "device-dispatch", 2, 1, 0, 50, compile_ms=40.0),
        _sp(pkg, "device-execute", 3, 1, 50, 40)])
    assert cp["classes"]["compile"] == pytest.approx(40, abs=0.1)
    assert cp["classes"]["device_execute"] == pytest.approx(50, abs=0.1)
    assert cp["connected"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_zero_and_single_span_queries(pkg):
    cpm = mod(pkg, "critpath")
    empty = cpm.extract([])
    assert empty["segments"] == [] and empty["wall_ms"] == 0.0
    one = cpm.extract([_sp(pkg, "device-execute", 1, None, 5, 10)])
    assert one["classes"] == {"device_execute": 10.0}
    assert one["dominant_class"] == "device_execute"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_failed_attempt_does_not_extend_the_path(pkg):
    cp = mod(pkg, "critpath").extract([
        _sp(pkg, "dq-stage", 1, None, 0, 100),
        _sp(pkg, "dq-task", 2, 1, 0, 40, state="failed", attempt=1),
        _sp(pkg, "task-exec", 3, 2, 5, 30),
        _sp(pkg, "dq-task", 4, 1, 45, 50, state="finished", attempt=2),
        _sp(pkg, "task-exec", 5, 4, 47, 45)])
    ids = {s["span_id"] for s in cp["segments"]}
    assert 2 not in ids and 3 not in ids and 5 in ids
    assert cp["classes"]["scheduler_gap"] > 0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_zero_duration_mid_window_span_terminates(pkg):
    cp = mod(pkg, "critpath").extract([
        _sp(pkg, "statement", 1, None, 0, 10),
        _sp(pkg, "input-wait", 2, 1, 5, 0),
        _sp(pkg, "plan", 3, 1, 9.9995, 0.0004)])
    assert cp["classes"]["host_lane"] == pytest.approx(10, abs=0.1)
    assert cp["connected"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_forest_without_root_gets_virtual_root_and_gap(pkg):
    cp = mod(pkg, "critpath").extract([
        _sp(pkg, "parse", 1, None, 0, 10),
        _sp(pkg, "plan", 2, None, 20, 10)])
    assert cp["wall_ms"] == pytest.approx(30)
    assert cp["classes"]["scheduler_gap"] == pytest.approx(10, abs=0.1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_memory_join_rides_along(pkg):
    cpm = mod(pkg, "critpath")
    cp = cpm.extract([_sp(pkg, "device-execute", 1, None, 0, 10)],
                     memory={"transfer_bytes": 1234, "transfers": 3,
                             "waste_bytes": 999, "pad_efficiency": 0.5,
                             "to_pandas_in_plan": 1})
    assert cp["memory"]["transfer_bytes"] == 1234
    assert any("host transfers" in ln for ln in cpm.render_lines(cp))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_query_stats_render_kinds(pkg):
    """QueryStats.render over the same record gives the same text in
    both packages."""
    QS = mod(pkg, "metrics").QueryStats
    s = QS(sql="x", kind="select", parse_ms=0.1, plan_ms=0.2,
           execute_ms=1.0, total_ms=1.3, rows_out=4, fused=True,
           batching={"coalesced": 3, "leader": True, "batched": True},
           phases={"dispatch_ms": 0.5, "device_ms": 0.25},
           memory={"peak_bytes": 1 << 21, "transfers": 1,
                   "transfer_bytes": 64, "admission_est_bytes": 1 << 20,
                   "est_error_pct": 50.0})
    assert s.render() == mod("ydb_tpu", "metrics").QueryStats(
        **{f: getattr(s, f) for f in s.__dataclass_fields__}).render()


# -- the engine on the CPU --------------------------------------------------


def _tables(rows: int = 50) -> dict:
    i = np.arange(rows)
    return {"t": {
        "columns": [("id", "int64", False), ("v", "float64", False),
                    ("g", "int64", False)],
        "data": {"id": i.astype(np.int64), "v": i + 0.5,
                 "g": (i % 5).astype(np.int64)},
        "valid": {}, "dictionaries": {}, "primary_key": ["id"],
        "shards": 1, "portion_rows": 1 << 12}}


def mk_engine(**kw) -> PortEngine:
    e = PortEngine(device="cpu", block_rows=1 << 12, **kw)
    interop.load_tables(e.catalog, _tables())
    return e


SQL = "select g, sum(v) as s, count(*) as n from t group by g order by g"


def test_sample_rate_zero_records_nothing_and_matches():
    base = mk_engine()
    want = base.query(SQL)
    assert len(base.last_trace) > 0
    quiet = mk_engine()
    quiet.trace_sample = 0.0
    got = quiet.query(SQL)
    assert quiet.last_trace == []
    assert quiet.last_stats.phases == {}
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        assert got[c].to_numpy().tobytes() == want[c].to_numpy().tobytes()
    df = quiet.query("explain analyze select count(*) as c from t")
    assert "-- trace:" in "\n".join(df.plan)


def test_fractional_sampling_is_deterministic():
    e = mk_engine()
    e.query("select count(*) as c from t")
    e.slow_query_ms = float("inf")
    e._slow_sqls.clear()
    e.trace_sample = 0.25
    traced = 0
    for _ in range(16):
        e.query("select count(*) as c from t")
        traced += bool(e.last_trace)
    assert traced == 4


def test_slow_query_forces_next_trace_and_counters():
    from ydb_tpu_torch.utils.metrics import GLOBAL
    e = mk_engine()
    e.trace_sample = 0.0
    e.slow_query_ms = 0.0
    before = GLOBAL.get("slow_query/count")
    sql = "select sum(v) as s from t"
    e.query(sql)
    assert GLOBAL.get("slow_query/count") > before
    assert sql in e._slow_sqls
    e.query(sql)
    assert e.last_trace


def test_phases_and_profile_ring():
    e = mk_engine()
    e.query("select sum(v) as s from t where id > 3")
    ph = e.last_stats.phases
    assert ph.get("dispatch_ms", 0) > 0
    assert "readout_ms" in ph and "device_ms" in ph
    assert "compile_ms" not in ph        # no NVRTC build on the CPU
    prof = e.profiles[-1]
    assert prof["sql"].startswith("select sum")
    assert prof["n_spans"] == len(prof["spans"])
    assert prof["phases"] == ph
    assert prof["critical_path"]["coverage"] > 0.9


@pytest.mark.parametrize("sql", [
    SQL, "select sum(v) as s from t where id > 3",
    "select count(*) as c from t where g = 2"])
def test_one_critical_path_extraction_a_statement(monkeypatch, sql):
    """A sampled SELECT extracts its critical path once, over its closed
    trace and ledger: the profile ring, the critical-path ring and
    `last_stats.critical_path` all come from that one extraction, and
    equal a fresh extraction over the finished trace."""
    from ydb_tpu_torch.utils import critpath
    calls = []
    real = critpath.extract

    def counted(spans, memory=None):
        calls.append((spans, memory))
        return real(spans, memory=memory)

    monkeypatch.setattr(critpath, "extract", counted)
    e = mk_engine()
    for _ in range(3):
        calls.clear()
        e.query(sql)
        assert len(calls) == 1, calls
        spans, memory = calls[0]
        assert spans is e.last_trace
        prof, row = e.profiles[-1], e.critpath_stats[-1]
        cp = prof["critical_path"]
        assert real(e.last_trace, memory=memory) == cp
        assert e.last_stats.critical_path == critpath.summarize(cp)
        assert row["trace_id"] == prof["trace_id"]
        assert (row["wall_ms"], row["coverage"], row["dominant_span"]) \
            == (cp["wall_ms"], cp["coverage"], cp["dominant_span"])
        assert {k: row[f"{k}_ms"] for k in critpath.CLASSES} == \
            {k: cp["classes"].get(k, 0.0) for k in critpath.CLASSES}
    # a nested statement (EXPLAIN ANALYZE) extracts over its own window,
    # and the outer statement once over its trace; a write extracts once
    calls.clear()
    e.query("explain analyze " + sql)
    assert len(calls) == 2, calls
    e.execute("create table w (id Int64 not null, primary key (id))")
    calls.clear()
    e.execute("insert into w (id) values (1)")
    assert len(calls) == 1 and e.profiles[-1]["kind"] == "insert"


def test_latency_histograms_and_counters():
    from ydb_tpu.utils.metrics import ALWAYS_VISIBLE, HIST_FAMILIES
    e = mk_engine()
    c0 = e.counters()
    for fam in HIST_FAMILIES:
        assert f"hist/{fam}/p99" in c0
    assert set(ALWAYS_VISIBLE) <= set(c0)
    n0 = c0["hist/query/latency_ms/count"]
    s0 = c0.get("engine/statements", 0)
    e.query("select count(*) as c from t")
    c = e.counters()
    assert c["hist/query/latency_ms/count"] == n0 + 1
    assert c["engine/statements"] == s0 + 1
    assert c["trace/sample_rate"] == 1.0


def test_nested_statements_do_not_double_count_latency():
    from ydb_tpu_torch.utils.metrics import GLOBAL_HIST
    e = mk_engine()
    e.query("select count(*) as c from t")
    before = GLOBAL_HIST.get("query/latency_ms").count
    e.query("explain analyze select count(*) as c from t")
    assert GLOBAL_HIST.get("query/latency_ms").count - before <= 1
    e.trace_sample = 0.5
    e._trace_acc = 0.0
    e.slow_query_ms = float("inf")
    e._slow_sqls.clear()
    traced = 0
    for _ in range(8):
        e.query("explain select count(*) as c from t")
        e.query("select count(*) as c from t")
        traced += bool(e.last_trace)
    assert traced == 4


def test_tracer_exception_safety_statement():
    e = mk_engine()
    with pytest.raises(Exception):
        e.query("select no_such_column from t")
    assert e.tracer._stack == []
    e.query("select count(*) as n from t")
    spans = e.last_trace
    root = spans[0]
    assert root.name == "statement" and root.parent_id is None
    ids = {s.span_id for s in spans}
    assert all(s.parent_id in ids for s in spans[1:])


def test_ledger_peak_and_admission_equal_reference():
    """The ledger is shape arithmetic in both packages: over the same
    tables a fused statement's peak and admission estimate agree."""
    from ydb_tpu.query import QueryEngine as RefEngine
    from ydb_tpu.core.block import HostBlock
    from ydb_tpu.core.schema import Column, Schema
    from ydb_tpu.core.dtypes import DType, Kind
    from ydb_tpu.storage.mvcc import WriteVersion
    ref = RefEngine(block_rows=1 << 12)
    spec = _tables()["t"]
    schema = Schema([Column(n, DType(Kind(k), nl))
                     for (n, k, nl) in spec["columns"]])
    t = ref.catalog.create_table("t", schema, ["id"], portion_rows=1 << 12)
    t.commit(t.write(HostBlock.from_arrays(schema, spec["data"])),
             WriteVersion(1, 1))
    t.indexate()
    port = mk_engine()
    for eng in (ref, port):
        eng.query(SQL)
    a, b = ref.last_stats.memory, port.last_stats.memory
    for k in ("peak_bytes", "admission_est_bytes", "padded_bytes",
              "live_bytes"):
        assert b[k] == a[k], k
    assert port.memory_stats[-1]["peak_bytes"] == b["peak_bytes"]


# -- the card's clock, with a stand-in for CUDA events ----------------------


class _FakeEvent:
    """A timing CUDA event's stand-in: `record` stamps the fake card
    clock `now` (ms), which a test moves on as the card would."""
    made: list = []
    now = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None
        self.synced = False
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        self.at = _FakeEvent.now

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, other):
        assert self.at is not None and other.at is not None
        assert any(e.synced for e in _FakeEvent.made)
        return other.at - self.at


@pytest.fixture
def fake_cuda(monkeypatch):
    _FakeEvent.made = []
    _FakeEvent.now = 0.0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    return _FakeEvent


def _card_body(ms):
    def body(x):
        _FakeEvent.now += ms             # the card runs the launches
        return x + 1
    return body


def _nested(sp, parent):
    return parent.start_ms <= sp.start_ms \
        and sp.start_ms + sp.dur_ms <= parent.start_ms + parent.dur_ms


@pytest.mark.parametrize("sampled", [True, False])
def test_device_execute_takes_the_cards_time(fake_cuda, sampled):
    from ydb_tpu_torch.utils.tracing import phase_breakdown
    e = mk_engine()
    ex = e.executor
    ex.device = torch.device("cuda")     # the helpers only, no launch
    tr = e.tracer
    tr.begin_trace(sampled=sampled)
    out, clock = ex._dispatch("device-dispatch", _card_body(2.5), (1,))
    with tr.span("readout"):
        ex._device_execute(clock)
    spans = tr.end_trace()
    assert out == 2
    if not sampled:
        assert clock is None and fake_cuda.made == [] and spans == []
        return
    assert len(fake_cuda.made) == 2 and fake_cuda.made[1].synced
    disp, readout, sp = spans
    assert disp.name == "device-dispatch" and "compile_ms" not in disp.attrs
    assert sp.name == "device-execute" and sp.attrs["card_ms"] == 2.5
    assert sp.attrs["timer"] == "cuda-events"
    assert "build_wait_ms" not in sp.attrs
    assert sp.parent_id == readout.span_id and _nested(sp, readout)
    assert phase_breakdown([sp]) == {"device_ms": 2.5}


def test_k1_build_leaves_the_cards_time(fake_cuda, monkeypatch, tmp_path):
    """A fresh expression: its NVRTC build inside the eager body is
    host work the card waits on. The build's own pair of events takes
    that wait out of the card's time, so `device` holds the launches
    alone and `compile` the build, counted once; the `device-execute`
    span stays inside its parent."""
    import time as _time
    from ydb_tpu_torch.ops.cuda import nvrtc
    from ydb_tpu_torch.utils.tracing import phase_breakdown

    def compile_cubin(source, name):
        _time.sleep(0.02)
        _FakeEvent.now += 100.0          # the card idles meanwhile
        return b"cubin"

    class _Driver:
        def cuModuleLoadData(self, *a):
            return 0

        def cuModuleGetFunction(self, *a):
            return 0
    monkeypatch.setattr(nvrtc, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(nvrtc, "_KERNELS", {})
    monkeypatch.setattr(nvrtc, "_CUBINS", {})
    monkeypatch.setattr(nvrtc, "compile_cubin", compile_cubin)
    monkeypatch.setattr(nvrtc, "_cuda", lambda: _Driver())
    monkeypatch.setattr(nvrtc, "_context", lambda index: None)

    def body(x):
        _FakeEvent.now += 1.0            # launches before the build
        nvrtc.kernel("extern \"C\" __global__ void k() {}", "k", 0)
        _FakeEvent.now += 1.5            # the built kernel and the rest
        return x + 1

    e = mk_engine()
    ex = e.executor
    ex.device = torch.device("cuda")
    tr = e.tracer
    tr.begin_trace(sampled=True)
    with tr.span("statement"):
        _out, clock = ex._dispatch("device-dispatch", body, (1,))
        with tr.span("readout"):
            ex._device_execute(clock)
    spans = tr.end_trace()
    by = {x.name: x for x in spans}
    disp, sp, readout = (by["device-dispatch"], by["device-execute"],
                         by["readout"])
    assert len(clock[2]) == 1 and len(fake_cuda.made) == 4
    assert sp.attrs["build_wait_ms"] == 100.0
    assert sp.attrs["card_ms"] == 2.5
    assert disp.attrs["compile_ms"] >= 20.0
    assert _nested(sp, readout)
    ph = phase_breakdown(spans)
    assert ph["device_ms"] == 2.5
    assert ph["compile_ms"] == disp.attrs["compile_ms"]
    assert ph["dispatch_ms"] < disp.dur_ms
    # outside a watched body a build leaves no events
    assert nvrtc.watch_builds(None) is None
    nvrtc.kernel("extern \"C\" __global__ void k2() {}", "k2", 0)
    assert len(fake_cuda.made) == 4


def test_no_event_without_a_tracer(fake_cuda):
    from ydb_tpu_torch.query.executor import Executor
    ex = Executor(mk_engine().catalog, torch.device("cuda"))
    _out, clock = ex._dispatch("device-dispatch", lambda: None, ())
    assert ex.tracer is None and clock is None
    assert fake_cuda.made == []


def test_k1_build_stamps_compile_on_the_dispatch_span(monkeypatch):
    """An NVRTC build inside the eager body (stood in here: the plain
    body on the CPU builds nothing) lands as `compile_ms` on the
    dispatch span, and the phases pull it out of dispatch."""
    from ydb_tpu_torch.ops import fused as F
    from ydb_tpu_torch.ops.cuda import nvrtc
    real = F.build_fused_fn

    def building(*a, **k):
        fn, box = real(*a, **k)

        def body(*args):
            nvrtc._TLS.build_ms = nvrtc.thread_build_ms() + 12.5
            return fn(*args)
        return body, box
    monkeypatch.setattr(F, "build_fused_fn", building)
    e = mk_engine()
    e.query("select sum(v) as s from t")
    disp = [s for s in e.last_trace if s.name == "device-dispatch"]
    assert disp[-1].attrs["compile_ms"] == 12.5
    ph = e.last_stats.phases
    assert ph["compile_ms"] == 12.5
    text = e.last_stats.render()
    assert "-- phases: compile 12.5ms" in text
