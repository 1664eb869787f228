"""EXPLAIN, EXPLAIN ANALYZE and the statement stats of the port against
the reference.

The same tables go into both engines: the reference's generators fill
the reference's catalog and `ydb_tpu_torch.interop` carries its tables
into the port's (TPC-H at SF 0.002 over 2 shards, the 43 ClickBench
queries over 5,000 rows).

- `explain(sql)` and the `EXPLAIN` frame equal the reference's text.
- EXPLAIN ANALYZE has the reference's lines: the plan text exactly, then
  the same `-- <kind>:` lines in the same order, with equal `rows out`
  and `path`, then the same span tree (names and nesting; times and
  attributes are masked). Left out of the comparison, as ROADMAP
  Queue 3 lists: the `-- programs:` block (no program roofline yet), and
  the `-- groupby trace:` / `-- bounds:` lines, which the reference
  prints only when it traces a fresh shape and the port prints every
  time its eager body runs a group-by (held by
  `test_groupby_window_reports_every_run`).
- `last_stats`'s kind, tables, rows out and plan-cache hit equal the
  reference's over a repeated statement.
- The router's EXPLAIN of q3 and q5 over 4 workers lists the reference's
  stage and channel lines, and its ANALYZE one task row per (stage,
  worker).
"""

import re

import pytest

from ydb_tpu.bench.clickbench_gen import load_hits as ref_load_hits
from ydb_tpu.bench.tpch_gen import load_tpch as ref_load_tpch
from ydb_tpu.query import QueryEngine as RefEngine

from ydb_tpu_torch import interop
from ydb_tpu_torch.query import QueryEngine as PortEngine

from tests.clickbench_util import QUERIES as CB_QUERIES
from tests.tpch_util import QUERIES
from tests import torch_threads  # noqa: F401,E402

SF = 0.002
CB_ROWS = 5_000
TPCH = [f"q{i}" for i in range(1, 23)]

# stats lines the comparison leaves out (ROADMAP Queue 3)
_MASKED = ("-- groupby trace:", "-- bounds:", "-- programs:", "--   ")


def _pair(load_ref):
    ref = RefEngine(block_rows=1 << 13)
    load_ref(ref.catalog)
    port = PortEngine(device="cpu", block_rows=1 << 13)
    interop.load_tables(port.catalog, interop.export_tables(ref.catalog))
    return ref, port


@pytest.fixture(scope="module")
def tpch():
    return _pair(lambda c: ref_load_tpch(c, sf=SF, shards=2,
                                         portion_rows=1 << 13))


@pytest.fixture(scope="module")
def clickbench():
    return _pair(lambda c: ref_load_hits(c, n_rows=CB_ROWS, shards=2,
                                         portion_rows=1 << 12))


def _explain_both(ref, port, sql):
    """(reference, port) of `explain(sql)` and the EXPLAIN frame; an
    exception stands for its class name."""
    out = []
    for eng in (ref, port):
        got = []
        for f in (lambda: eng.explain(sql),
                  lambda: list(eng.query("explain " + sql)["plan"])):
            try:
                got.append(f())
            except Exception as e:       # noqa: BLE001 — compared
                got.append(type(e).__name__)
        out.append(got)
    return out


@pytest.mark.parametrize("name", TPCH)
def test_tpch_explain_text_equals_reference(tpch, name):
    want, got = _explain_both(*tpch, QUERIES[name])
    assert got == want


@pytest.mark.parametrize("name", list(CB_QUERIES))
def test_clickbench_explain_text_equals_reference(clickbench, name):
    want, got = _explain_both(*clickbench, CB_QUERIES[name])
    assert got == want


_SPAN = re.compile(r"^(\s*)- ([\w-]+): ")
_STATS = re.compile(r"rows out (\d+) \| path (.+)$")


def analyze_shape(lines: list) -> tuple:
    """(plan lines, stats line kinds, (rows out, path), span tree) of an
    EXPLAIN ANALYZE frame: kinds are the `-- <kind>` prefixes of the
    stats lines (masked ones dropped); the tree keeps each span's depth
    and name."""
    i = next(k for k, ln in enumerate(lines) if ln.startswith("-- stats:"))
    plan, rest = lines[:i], lines[i:]
    rows_path = _STATS.search(rest[0]).groups()
    kinds, tree, in_trace = [], [], False
    for ln in rest:
        if in_trace:
            m = _SPAN.match(ln)
            if m:
                tree.append(m.group(1) + m.group(2))
            continue
        if ln == "-- trace:":
            in_trace = True
        if not ln.startswith(_MASKED):
            kinds.append(ln.split(":")[0])
    return plan, kinds, rows_path, tree


@pytest.mark.parametrize("name", TPCH)
def test_tpch_explain_analyze_matches_reference(tpch, name):
    ref, port = tpch
    sql = "explain analyze " + QUERIES[name]
    want = analyze_shape(list(ref.query(sql)["plan"]))
    got = analyze_shape(list(port.query(sql)["plan"]))
    assert got[0] == want[0]                       # plan text
    assert got[1] == want[1]                       # stats line kinds
    assert got[2] == want[2]                       # rows out, path
    assert got[3] == want[3]                       # span tree
    assert "-- phases" in got[1] and "-- trace" in got[1]


@pytest.mark.parametrize("name", ["c0", "c8", "c20", "c33"])
def test_clickbench_explain_analyze_matches_reference(clickbench, name):
    ref, port = clickbench
    sql = "explain analyze " + CB_QUERIES[name]
    want = analyze_shape(list(ref.query(sql)["plan"]))
    got = analyze_shape(list(port.query(sql)["plan"]))
    assert got == want


@pytest.mark.parametrize("name", ["q1", "q3", "q6", "q13", "q18"])
def test_last_stats_equal_reference_over_a_repeat(tpch, name):
    ref, port = tpch
    sql = QUERIES[name] + "\n"          # a text of its own: a cold cache
    for run in range(2):
        want, got = [], []
        for eng, out in ((ref, want), (port, got)):
            eng.query(sql)
            s = eng.last_stats
            out.append((s.kind, s.tables, s.rows_out, s.plan_cache_hit,
                        s.sql))
        assert got == want, run
    assert port.query_history[-1] is port.last_stats


def test_groupby_window_reports_every_run(tpch):
    """Parity difference (ROADMAP Queue 3): the port's sorted group-by
    runs, and is reported, on every execution; the reference reports
    only a freshly traced shape."""
    _ref, port = tpch
    sql = QUERIES["q3"]
    for _ in range(2):
        port.query(sql)
        g = port.last_stats.groupby
        assert g["traces"] >= 1 and g["tiles"] >= 1
        assert g["gather_ops_total"] > 0
        text = port.last_stats.render()
        assert "-- groupby trace: tiles" in text


def test_explain_of_constant_and_materialized_selects(tpch):
    ref, port = tpch
    for sql in ("select 1 + 1 as x",
                "with a as (select n_nationkey from nation) "
                "select count(*) as n from a"):
        for prefix in ("explain ", "explain analyze "):
            want = list(ref.query(prefix + sql)["plan"])
            got = list(port.query(prefix + sql)["plan"])
            assert got[0] == want[0]
            if prefix == "explain ":
                assert got == want
            else:
                assert analyze_shape(got)[1:3] == analyze_shape(want)[1:3]


def test_explain_refuses_what_the_reference_refuses(tpch):
    ref, port = tpch
    from ydb_tpu.query.engine import QueryError as RefQueryError
    from ydb_tpu_torch.query.engine import QueryError
    with pytest.raises(RefQueryError):
        ref.explain("create table z (id Int64 not null, primary key (id))")
    with pytest.raises(QueryError):
        port.explain("create table z (id Int64 not null, primary key (id))")


# -- the router's EXPLAIN over 4 workers -----------------------------------


_UUID = re.compile(r"dqc_[0-9a-f]+_")


@pytest.fixture(scope="module")
def clusters():
    from tests.test_torch_dq import KEYS, NW, REPLICATED
    from tests.torch_dq_util import cluster, ref_engines
    from ydb_tpu_torch.bench.cluster_load import load_tpch_cluster
    from ydb_tpu_torch.bench.tpch_gen import TPCH_SCHEMAS
    engines = [PortEngine(device="cpu", block_rows=1 << 12)
               for _ in range(NW)]
    data, rep, keys = load_tpch_cluster([e.catalog for e in engines], SF)
    port = cluster("port", engines, keys, replicated=rep, name="xw")
    tables = {}
    for tn, (schema, pk) in TPCH_SCHEMAS.items():
        cols = [(c.name, c.dtype.kind.value, c.dtype.nullable)
                for c in schema]
        tables[tn] = (cols, pk, data.tables[tn], {})
    ref = cluster("ref", ref_engines(tables, NW, REPLICATED), KEYS,
                  replicated=REPLICATED, name="xr")
    return ref, port, NW


def _graph_lines(lines):
    """The stage graph's lines, channel ids masked (a fresh id a
    lowering)."""
    return [_UUID.sub("dqc_", ln) for ln in lines
            if ln.startswith(("DQ stage graph:", "  stage ", "  channel "))]


@pytest.mark.parametrize("name", ["q3", "q5"])
def test_router_explain_stage_lines_equal_reference(clusters, name):
    ref, port, _nw = clusters
    sql = "explain " + QUERIES[name]
    want = _graph_lines(list(ref.query(sql)["plan"]))
    got = _graph_lines(list(port.query(sql)["plan"]))
    assert got == want
    assert got[0].startswith("DQ stage graph:")


@pytest.mark.parametrize("name", ["q3"])
def test_router_explain_analyze_tasks_and_tree(clusters, name,
                                               monkeypatch):
    ref, port, nw = clusters
    monkeypatch.setenv("YDB_TPU_DQ_PLANE", "auto")
    sql = "explain analyze " + QUERIES[name]
    want = list(ref.query(sql)["plan"])
    got = list(port.query(sql)["plan"])
    assert _graph_lines(got) == _graph_lines(want)
    rows = [ln for ln in got if ln.startswith("-- rows out:")]
    assert rows == [ln for ln in want if ln.startswith("-- rows out:")]
    tasks = [m.group(1) for m in
             (re.match(r"^  (s\w*@local:\w+): ", ln) for ln in got) if m]
    stages = {t.split("@")[0] for t in tasks}
    assert len(tasks) == len(set(tasks)) == len(stages) * nw
    tree = [m.group(1) + m.group(2) for m in map(_SPAN.match, got) if m]
    assert tree[0] == "dq-query"
    names = {t.strip() for t in tree}
    assert {"dq-stage", "dq-task", "task-exec", "ici-exchange",
            "device-dispatch", "statement"} <= names
    assert sum(1 for ln in got if ln.startswith("-- critical path:")) >= 2
