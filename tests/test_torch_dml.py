"""INSERT, UPSERT, UPDATE, DELETE and DDL of the port against the
reference.

Every statement runs through `ydb_tpu.query.QueryEngine` and the port's
`QueryEngine(device="cpu")` (`tests/torch_dml_util.Pair`), and a SELECT
after every statement holds the two equal: integers, null masks and row
order exact, floats to rtol 1e-9, with `last_rows_affected` and the
error texts equal too. Each case runs on column tables and row tables,
and on the fused and the portioned lane.

Drop-then-re-add of a column is the one place the port follows the
documented contract where the reference does not (`storage/table.py`
`drop_column`: "a later re-ADD of the same name must see nulls, not
stale bytes"): on a portion with delete marks, and on the portioned
lane, the reference serves the dropped column's bytes (ROADMAP
Queue 3). Those cases hold the port against the contract, and the rest
of the table against the reference.
"""

import pytest

from tests import torch_threads  # noqa: F401,E402
from tests.torch_dml_util import Pair, assert_frames_equal

STORES = ["column", "row"]
LANES = [True, False]                 # fused, portioned

_T = ("create table t (id Int64 not null, tag Utf8, g Int64 not null, "
      "v Double, primary key (id)) with (store = {store})")
_ALL = "select id, tag, g, v from t order by id"


@pytest.mark.parametrize("fused", LANES, ids=["fused", "portioned"])
@pytest.mark.parametrize("store", STORES)
def test_dml_statements(store, fused):
    p = Pair(fused=fused)
    p.run(_T.format(store=store))
    for sql in [
        "insert into t (id, tag, g, v) values (1, 'a', 0, 1.5), "
        "(2, 'b', 1, 2.5), (3, null, 0, null), (4, 'a', 1, 4.25)",
        "insert into t (id, g) values (5, 2)",
        "update t set v = 9.75 where g = 0",
        "update t set v = v * 2 + g, tag = 'z' where id >= 3",
        "update t set tag = null where id = 1",
        "update t set v = 0.0 where id = 999",
        "delete from t where g = 1",
        "insert into t (id, tag, g, v) select id + 10, tag, g + 5, v "
        "from t where id < 5",
        "upsert into t (id, tag, g, v) select id, 'u', g, v from t "
        "where id > 10",
        "upsert into t (id, tag, g, v) values (2, 'b2', 7, 0.5)",
        "replace into t (id, g) values (40, 8)",
        "delete from t where id = 999",
        "insert into t (tag, g, id) values ('late', 3, 6)",
    ]:
        p.run(sql)
        p.run(_ALL)
    p.run("select g, count(*) as n, sum(v) as s, min(tag) as m from t "
          "group by g order by g")
    p.run("delete from t")
    p.run(_ALL)
    p.run("insert into t (id, tag, g, v) values (1, 'again', 0, 1.0)")
    p.run(_ALL)


@pytest.mark.parametrize("store", STORES)
def test_dml_guards(store):
    p = Pair()
    p.run(_T.format(store=store))
    p.run("insert into t (id, tag, g, v) values (1, 'a', 0, 1.5)")
    p.error("update t set id = 5 where id = 1", "primary key")
    p.error("insert into t (id, g) values (2)", "arity")
    p.error("insert into t (id, tag) values (2, 'x')", "NOT NULL")
    # a column table refuses an explicit NULL in a NOT NULL column; a
    # row table checks only missing columns (both packages alike)
    p.run("insert into t (id, g, v) values (3, null, 1.0)")
    p.error("insert into t (id, g) select id, g, v from t", "arity")
    p.error("insert into nope (id) values (1)", "nope")
    p.error("update nope set v = 1", "nope")
    p.error("delete from nope", "nope")
    p.error("insert into t (id, g) values (1 + g, 0)", "constant")
    if store == "row":
        p.error("insert into t (id, g) values (1, 0)", "duplicate")
        p.run("insert into t (id, g) select id + 1, g from t")
    p.run(_ALL)


def test_insert_select_from_column_into_row_and_back():
    p = Pair()
    p.run(_T.format(store="column"))
    p.run("create table r (id Int64 not null, tag Utf8, g Int64 not null, "
          "v Double, primary key (id)) with (store = row)")
    p.run("insert into t (id, tag, g, v) values "
          + ", ".join(f"({i}, 't{i % 7}', {i % 5}, {i * 0.5})"
                      for i in range(200)))
    p.run("insert into r select * from t where g < 3")
    p.run("select * from r order by id")
    p.run("update r set v = v + 1000.0, tag = 'hot' where g = 1")
    p.run("delete from t where id in (select id from r where g = 2)")
    p.run(_ALL)
    p.run("insert into t (id, tag, g, v) select id + 1000, tag, g, v "
          "from r where g = 1")
    p.run("select g, count(*) as n, sum(v) as s from t group by g "
          "order by g")


@pytest.mark.parametrize("store", STORES)
def test_serial_columns(store):
    p = Pair()
    p.run("create table s (id Serial not null, name Utf8, primary key "
          f"(id)) with (store = {store})")
    p.run("insert into s (name) values ('a'), ('b')")
    p.run("insert into s (id, name) values (10, 'ten')")
    p.run("insert into s (name) values ('after')")
    p.run("create table src (k Int64 not null, n Utf8, primary key (k))")
    p.run("insert into src (k, n) values (1, 'x'), (2, 'y')")
    p.run("insert into s (name) select n from src")
    p.run("select id, name from s order by id")
    assert p.port.catalog.table("s").serial_next == \
        p.ref.catalog.table("s").serial_next
    p.error("alter table s add column id2 Serial", "Serial")


@pytest.mark.parametrize("store", STORES)
def test_ttl(store):
    p = Pair()
    p.run("create table e (id Int64 not null, d Date, ts Int64, primary "
          "key (id)) with (store = " + store + ", ttl_column = d, "
          "ttl_days = 30)")
    p.run("create table u (id Int64 not null, ts Int64, primary key (id)) "
          "with (ttl_column = ts, ttl_days = 1)")
    p.run("insert into e (id, d, ts) values (1, date '2020-01-01', 0), "
          "(2, date '2020-03-01', 0), (3, date '2020-03-20', 0), "
          "(4, null, 0)")
    p.run("insert into u (id, ts) values (1, 1000), (2, 90000), "
          "(3, 200000)")
    now = 1584662400.0                      # 2020-03-20 00:00 UTC
    for t in (now, now + 86400 * 20, now + 86400 * 90):
        got = p.port.run_ttl(now=t)
        want = p.ref.run_ttl(now=t)
        assert got == want, (t, got, want)
        p.run("select id, d from e order by id")
        p.run("select id, ts from u order by id")
    p.error("create table x (id Int64 not null, primary key (id)) with "
            "(ttl_days = 3)", "ttl_column")
    p.error("create table x (id Int64 not null, primary key (id)) with "
            "(ttl_column = nope, ttl_days = 3)", "TTL column")
    p.error("create table x (id Int64 not null, s Utf8, primary key (id)) "
            "with (ttl_column = s, ttl_days = 3)", "Date or Int64")
    p.error("create table x (id Int64 not null, d Date, primary key (id)) "
            "with (ttl_column = d, ttl_days = 0)", "positive")
    p.error("alter table e drop column d", "TTL column")
    assert not p.port.catalog.has("x")


@pytest.mark.parametrize("fused", LANES, ids=["fused", "portioned"])
@pytest.mark.parametrize("store", STORES)
def test_alter_table(store, fused):
    p = Pair(fused=fused)
    p.run(_T.format(store=store))
    p.run("insert into t (id, tag, g, v) values (1, 'a', 0, 1.5), "
          "(2, 'b', 1, 2.5)")
    p.run("alter table t add column w Int64")
    p.run("select id, tag, g, v, w from t order by id")
    p.run("insert into t (id, g, w) values (3, 2, 30)")
    p.run("alter table t add column s Utf8")
    p.run("update t set s = 'new' where id >= 2")
    p.run("select * from t order by id")
    p.run("alter table t drop column tag")
    p.run("select * from t order by id")
    p.error("alter table t add column w Int64", "already exists")
    p.error("alter table t drop column nope", "unknown column")
    p.error("alter table t drop column id", "key/partition")
    p.error("alter table nope add column x Int64", "unknown table")
    p.error("alter table t add column nn Int64 not null", "NOT NULL")
    p.run("select * from t order by id")


def test_add_not_null_column_to_empty_column_table():
    p = Pair()
    p.run(_T.format(store="column"))
    p.run("alter table t add column nn Int64 not null")
    p.run("insert into t (id, g, nn) values (1, 0, 5)")
    p.run("select id, nn from t order by id")


def _reread_nulls(eng):
    return eng.query("select id, v, w from t order by id")


@pytest.mark.parametrize("marks", [False, True], ids=["plain", "marks"])
@pytest.mark.parametrize("fused", LANES, ids=["fused", "portioned"])
def test_drop_then_re_add_reads_nulls(fused, marks):
    """The contract: a column dropped and added back under its name
    reads nulls, never the dropped column's bytes, on both lanes and on
    a portion with delete marks. The reference serves stale bytes on the
    portioned lane and through a portion with marks (ROADMAP Queue 3);
    the port holds the contract, and its other columns equal the
    reference's."""
    p = Pair(fused=fused)
    p.run("create table t (id Int64 not null, v Double, w Int64, "
          "primary key (id))")
    p.run("insert into t (id, v, w) values (1, 1.5, 7), (2, 2.5, 8), "
          "(3, 3.5, 9)")
    if marks:
        p.run("delete from t where id = 1")
    # the dropped column is resident on the device before the DROP
    p.run("select id, v, w from t order by id")
    for e in (p.ref, p.port):
        e.execute("alter table t drop column w")
        e.execute("alter table t add column w Int64")
    got = _reread_nulls(p.port)
    want = p.ref.query("select id, v from t order by id")
    assert_frames_equal(got[["id", "v"]], want, "other columns")
    assert got.w.isna().all(), got
    # a value written after the re-ADD reads back
    p.port.execute("update t set w = 42 where id = 3")
    got = _reread_nulls(p.port)
    assert got.w.isna().tolist() == [True] * (len(got) - 1) + [False]
    assert int(got.w.iloc[-1]) == 42


def test_index_ddl_and_guards():
    p = Pair()
    p.run(_T.format(store="row"))
    p.run("insert into t (id, tag, g, v) values (1, 'a', 0, 1.5), "
          "(2, 'b', 1, 2.5), (3, 'a', 2, 3.5)")
    p.run("create index ix_tag on t (tag)")
    p.run("select id, g from t where tag = 'a' order by id")
    p.run("update t set tag = 'c' where id = 1")
    p.run("select id, g from t where tag = 'a' order by id")
    p.error("create index ix_tag on t (g)", "already exists")
    p.error("alter table t drop column tag", "indexed")
    p.run("drop index ix_tag on t")
    p.error("drop index ix_tag on t", "unknown index")
    p.error("create index ix on nope (g)", "unknown table")
    p.run("create table c (id Int64 not null, g Int64, primary key (id))")
    p.error("create index ix_g on c (g)", "row-store only")
    p.run("alter table t drop column tag")
    p.run("select * from t order by id")


@pytest.mark.parametrize("store", STORES)
def test_drop_table(store):
    p = Pair()
    p.run(_T.format(store=store))
    p.run("insert into t (id, g) values (1, 0)")
    p.error(_T.format(store=store), "already exists")
    p.run("create table if not exists t (id Int64 not null, "
          "primary key (id))")
    p.run("drop table t")
    p.error("select * from t", "")
    p.run("drop table if exists t")
    p.error("drop table t", "")
    p.run(_T.format(store=store))
    p.run(_ALL)


@pytest.mark.parametrize("fused", LANES, ids=["fused", "portioned"])
@pytest.mark.parametrize("store", STORES)
def test_time_travel(store, fused):
    """A plan run at a snapshot taken before each write
    (`executor.execute(plan, old)`) returns the rows as they were, on
    both lanes, after INSERT, UPDATE and DELETE."""
    p = Pair(fused=fused)
    p.run(_T.format(store=store))
    p.run("insert into t (id, tag, g, v) values "
          + ", ".join(f"({i}, 'k{i % 3}', {i % 4}, {i * 1.25})"
                      for i in range(300)))
    q = "select g, count(*) as n, sum(v) as s, max(tag) as m from t " \
        "group by g order by g"
    rows_q = "select id, tag, v from t order by id"
    # a plan made before the writes, over numbers only (a plan holds
    # the string dictionaries' domains as they were when it was made)
    early = p.plan_pair("select g, count(*) as n, sum(v) as s from t "
                        "group by g order by g")

    def held():
        # a snapshot kept across writes is registered as a read in
        # flight: auto-compaction folds delete marks and restamps merged
        # portions only up to the oldest registered read
        snaps = p.snapshots()
        p.ref._enter_read(snaps[0].plan_step)
        p.port._enter_read(snaps[1].plan_step)
        return snaps

    history = [(held(), p.run(q), p.run(rows_q))]
    for sql in ["delete from t where g = 1",
                "update t set v = -v, tag = 'neg' where id < 50",
                "insert into t (id, tag, g, v) values (1000, 'n', 9, 9.0)",
                "delete from t where id >= 250"]:
        p.run(sql)
        history.append((held(), p.run(q), p.run(rows_q)))
    plans, rows = p.plan_pair(q), p.plan_pair(rows_q)
    for snaps, agg, full in history:
        assert_frames_equal(p.at(plans, snaps, "agg"), agg, "agg at old")
        assert_frames_equal(p.at(rows, snaps, "rows"), full, "rows at old")
        assert_frames_equal(p.at(early, snaps, "early plan"),
                            agg[["g", "n", "s"]], "early plan at old")
    for snaps, _agg, _full in history:
        p.ref._exit_read(snaps[0].plan_step)
        p.port._exit_read(snaps[1].plan_step)
    assert not p.port._active_reads
    # with no read held, the next write's compaction may fold the marks
    # a dropped snapshot needed: both packages alike
    p.run("insert into t (id, tag, g, v) values (2000, 'x', 0, 1.0)")
    for snaps, _agg, _full in history:
        p.at(plans, snaps, "unheld")


def test_no_write_statement_raises_not_ported():
    from ydb_tpu_torch.errors import NotPorted
    from ydb_tpu_torch.query import QueryEngine
    e = QueryEngine(device="cpu")
    for sql in ["create table a (id Int64 not null, primary key (id))",
                "insert into a (id) values (1)", "upsert into a (id) "
                "values (2)", "update a set id = id where id = 0",
                "delete from a where id = 1", "alter table a add column "
                "x Int64", "begin", "commit", "begin", "rollback",
                "drop table a"]:
        try:
            e.execute(sql)
        except NotPorted as err:          # pragma: no cover — the check
            raise AssertionError(f"{sql}: {err}")
        except Exception:                 # noqa: BLE001 — QueryError ok
            pass
    with pytest.raises(NotPorted, match="item 3"):
        QueryEngine(device="cpu", data_dir="unused")
    with pytest.raises(NotPorted, match="item 6"):
        e.execute("create materialized view mv as select 1 as x")
