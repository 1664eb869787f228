"""Sessions and interactive transactions of the port against the
reference: the in-memory cases of `tests/test_tx.py` and
`tests/test_column_dml.py`, run as differential cases.

Every statement, in every session, runs through both packages
(`tests/torch_dml_util.Pair`): each SELECT's frame, `last_rows_affected`
and each error's type and text are held equal. The randomized
serializability case runs one seeded interleaving of sessions on one
thread in both packages; their committed histories and their aborts
must be equal, and a serial replay of the committed transfers must give
the final balances. The durable cases (`data_dir`) wait for the
durability slice (ROADMAP Queue 1 item 3).
"""

import numpy as np
import pytest

from tests import torch_threads  # noqa: F401,E402
from tests.torch_dml_util import Pair

_BAL = "select id, bal from acct order by id"


@pytest.fixture
def p():
    pair = Pair()
    pair.run("create table acct (id Int64 not null, bal Int64 not null, "
             "primary key (id)) with (store = row)")
    pair.run("insert into acct (id, bal) values (1, 100), (2, 100), "
             "(3, 100)")
    return pair


def _col(p, rows=1000):
    pair = Pair(block_rows=1 << 10)
    pair.run("create table t (id Int64 not null, g Int64 not null, "
             "v Double not null, primary key (id)) with (store = column)")
    pair.run("insert into t (id, g, v) values "
             + ",".join(f"({i},{i % 4},{i * 1.0})" for i in range(rows)))
    return pair


def test_tx_atomic_commit(p):
    s = p.session()
    s.run("begin")
    s.run("update acct set bal = bal - 30 where id = 1")
    s.run("update acct set bal = bal + 30 where id = 2")
    other = p.run("select sum(bal) as t, min(bal) as lo from acct")
    assert other.t[0] == 300 and other.lo[0] == 100
    s.run("commit")
    assert list(p.run(_BAL).bal) == [70, 130, 100]


def test_tx_rollback_discards(p):
    s = p.session()
    s.run("begin")
    s.run("update acct set bal = 0 where id = 1")
    s.run("delete from acct where id = 2")
    assert list(s.run("select bal from acct order by id").bal) == [0, 100]
    s.run("rollback")
    df = p.run(_BAL)
    assert list(df.id) == [1, 2, 3] and list(df.bal) == [100] * 3


def test_tx_reads_own_writes_and_snapshot(p):
    s = p.session()
    s.run("begin")
    s.run("upsert into acct (id, bal) values (4, 50)")
    assert s.run("select count(*) as n from acct").n[0] == 4
    p.run("upsert into acct (id, bal) values (5, 77)")
    assert s.run("select count(*) as n from acct").n[0] == 4
    assert p.run("select count(*) as n from acct").n[0] == 4
    s.run("rollback")
    assert p.run("select count(*) as n from acct").n[0] == 4


def test_tx_optimistic_lock_conflict(p):
    s1, s2 = p.session(), p.session()
    s1.run("begin")
    assert s1.run("select bal from acct where id = 1").bal[0] == 100
    s2.run("update acct set bal = 999 where id = 3")
    s1.run("update acct set bal = bal - 10 where id = 1")
    assert s1.run("commit") is None           # both raise the same error
    assert list(p.run(_BAL).bal) == [100, 100, 999]


def test_tx_errors(p):
    s = p.session()
    for sql in ["commit", "rollback"]:
        assert s.run(sql) is None             # no open transaction
    s.run("begin")
    assert s.run("begin") is None             # already open
    assert s.run("create table x (id Int64 not null, primary key (id))") \
        is None                               # DDL inside a transaction
    for sql in ["drop table acct", "alter table acct add column x Int64",
                "create index ix on acct (bal)", "drop index ix on acct"]:
        assert s.run(sql) is None
    s.run("rollback")
    assert not p.port.catalog.has("x")


def test_tx_no_conflict_on_unrelated_table(p):
    p.run("create table other (id Int64 not null, primary key (id)) "
          "with (store = row)")
    s1 = p.session()
    s1.run("begin")
    s1.run("update acct set bal = 1 where id = 1")
    p.run("insert into other (id) values (1)")
    s1.run("commit")
    assert p.run("select bal from acct where id = 1").bal[0] == 1


def test_tx_column_table_insert_and_rollback(p):
    p.run("create table log (id Int64 not null, primary key (id))")
    s = p.session()
    s.run("begin")
    s.run("insert into log (id) values (1), (2)")
    assert s.run("select count(*) as n from log").n[0] == 2
    assert p.run("select count(*) as n from log").n[0] == 0
    s.run("commit")
    assert p.run("select count(*) as n from log").n[0] == 2
    s.run("begin")
    s.run("insert into log (id) values (3)")
    s.run("rollback")
    assert p.run("select count(*) as n from log").n[0] == 2


def test_randomized_serializability(p):
    """One seeded interleaving of transfer transactions over sessions on
    one thread, in both packages at once. The histories are equal by
    construction of the pair (each statement's success or error text is
    held equal); the committed set must replay serially to the final
    balances, and the total stays 300 after every step."""
    rng = np.random.default_rng(7)
    committed, aborted, open_ = [], 0, []
    for _ in range(60):
        if rng.random() < 0.4:
            s = p.session()
            src, dst = rng.choice([1, 2, 3], 2, replace=False)
            amt = int(rng.integers(1, 20))
            s.run("begin")
            s.run(f"update acct set bal = bal - {amt} where id = {src}")
            s.run(f"update acct set bal = bal + {amt} where id = {dst}")
            s.run("commit")
            committed.append([(int(src), int(dst), amt)])
        elif open_ and rng.random() < 0.6:
            s, plan = open_.pop(rng.integers(len(open_)))
            ok = True
            for (src, dst, amt) in plan:
                ok &= s.run(f"update acct set bal = bal - {amt} "
                            f"where id = {src}") is not None
                ok &= s.run(f"update acct set bal = bal + {amt} "
                            f"where id = {dst}") is not None
            if rng.random() < 0.8:
                if s.run("commit") is not None and ok:
                    committed.append(plan)
                else:
                    aborted += 1
            else:
                s.run("rollback")
        else:
            s = p.session()
            s.run("begin")
            src, dst = rng.choice([1, 2, 3], 2, replace=False)
            amt = int(rng.integers(1, 20))
            open_.append((s, [(int(src), int(dst), amt)]))
        assert p.run("select sum(bal) as t from acct").t[0] == 300
    for s, _plan in open_:
        s.run("rollback")
    bal = {1: 100, 2: 100, 3: 100}
    for plan in committed:
        for (src, dst, amt) in plan:
            bal[src] -= amt
            bal[dst] += amt
    assert list(p.run(_BAL).bal) == [bal[1], bal[2], bal[3]]
    assert len(committed) > 5 and aborted > 0
    assert p.port.coordinator.last_plan_step == \
        p.ref.coordinator.last_plan_step


def test_atomic_insert_batch_failure(p):
    p.error("insert into acct (id, bal) values (9, 1), (1, 2)", "duplicate")
    assert p.run("select count(*) as n from acct").n[0] == 3
    s = p.session()
    s.run("begin")
    assert s.run("insert into acct (id, bal) values (8, 1), (8, 2)") is None
    s.run("commit")
    assert p.run("select count(*) as n from acct").n[0] == 3


def test_tx_staged_column_write_invalidates_plan_cache(p):
    p.run("create table c (id Int64 not null, s Utf8 not null, "
          "primary key (id))")
    p.run("insert into c (id, s) values (1, 'alpha'), (2, 'beta')")
    q = "select s, count(*) as n from c group by s order by s"
    assert list(p.run(q).s) == ["alpha", "beta"]
    s = p.session()
    s.run("begin")
    s.run("insert into c (id, s) values (3, 'zeta')")
    df = s.run(q)
    assert list(df.s) == ["alpha", "beta", "zeta"]
    assert list(df.n) == [1, 1, 1]
    s.run("rollback")
    assert list(p.run(q).s) == ["alpha", "beta"]


def test_insert_select_column_subset(p):
    p.run("create table src (k Int64 not null, primary key (k))")
    p.run("insert into src (k) values (1), (2)")
    p.run("create table dst (k Int64 not null, v Double, primary key (k))")
    p.run("insert into dst (k) select k from src")
    df = p.run("select k, v from dst order by k")
    assert list(df.k) == [1, 2] and df.v.isna().all()


def test_compaction_respects_pinned_snapshots(p):
    p.run("create table cc (id Int64 not null, primary key (id)) "
          "with (partitions = 1)")
    for i in range(5):
        p.run(f"insert into cc (id) values ({i})")
    s = p.session()
    s.run("begin")
    assert s.run("select count(*) as n from cc").n[0] == 5
    for i in range(5, 16):
        p.run(f"insert into cc (id) values ({i})")
    assert s.run("select count(*) as n from cc").n[0] == 5
    s.run("rollback")
    assert p.run("select count(*) as n from cc").n[0] == 16
    p.run("insert into cc (id) values (99)")
    n = [len(e.catalog.table("cc").shards[0].portions)
         for e in (p.ref, p.port)]
    assert n[0] == n[1] < 17


def test_read_watermark_trails_apply(p):
    for eng in (p.ref, p.port):
        coord = eng.coordinator
        before = coord.read_snapshot().plan_step
        v = coord.propose(0)
        assert coord.read_snapshot().plan_step == before
        assert coord.safe_watermark() <= before
        assert eng._maintenance_watermark() <= before
        coord.publish(v.plan_step)
        assert coord.read_snapshot().plan_step == v.plan_step
        v1, v2 = coord.propose(0), coord.propose(0)
        coord.publish(v2.plan_step)
        assert coord.read_snapshot().plan_step == v.plan_step
        coord.publish(v1.plan_step)
        assert coord.read_snapshot().plan_step == v2.plan_step


def test_read_registry_bounds_the_watermark(p):
    for eng in (p.ref, p.port):
        snap = eng._register_read()
        eng.execute("upsert into acct (id, bal) values (1, 100)")
        assert eng._maintenance_watermark() == snap.plan_step
        eng._exit_read(snap.plan_step)
        assert eng._maintenance_watermark() == eng.snapshot().plan_step
        assert not eng._active_reads


def test_blind_upserts(p):
    p.run("create table wkv (id Int64 not null, v Int64 not null, "
          "primary key (id)) with (store = row)")
    s1, s2 = p.session(), p.session()
    s1.run("begin")
    s2.run("begin")
    s1.run("upsert into wkv (id, v) values (1, 10), (2, 20)")
    s2.run("upsert into wkv (id, v) values (3, 30), (4, 40)")
    s1.run("commit")
    s2.run("commit")
    df = p.run("select count(*) as n, sum(v) as s from wkv")
    assert int(df.n[0]) == 4 and int(df.s[0]) == 100
    s1.run("begin")
    s2.run("begin")
    s1.run("upsert into wkv (id, v) values (7, 1)")
    s2.run("upsert into wkv (id, v) values (7, 2)")
    s1.run("commit")
    assert s2.run("commit") is None           # write-write conflict
    assert int(p.run("select v from wkv where id = 7").v[0]) == 1
    s3 = p.session()
    s3.run("begin")
    s3.run("select count(*) as n from wkv")
    p.run("upsert into wkv (id, v) values (99, 9)")
    s3.run("upsert into wkv (id, v) values (50, 5)")
    assert s3.run("commit") is None           # optimistic lock


def test_insert_select_self_reference_stays_table_granular(p):
    p.run("create table isr (id Int64 not null, v Int64 not null, "
          "primary key (id)) with (store = row)")
    p.run("insert into isr (id, v) values (1, 10), (2, 20)")
    s = p.session()
    s.run("begin")
    s.run("insert into isr (id, v) select id + 100, v from isr")
    p.run("upsert into isr (id, v) values (2, 999)")
    assert s.run("commit") is None
    p.run("select * from isr order by id")


# -- column tables: MVCC delete marks (tests/test_column_dml.py) ------------

def test_column_delete_preserves_time_travel():
    p = _col(None)
    plans = p.plan_pair("select count(*) as c from t")
    old = p.snapshots()
    p.run("delete from t where g = 1")
    assert int(p.run("select count(*) as c from t").c[0]) == 750
    assert int(p.at(plans, old).iloc[0, 0]) == 1000
    assert int(p.run("select count(*) as c from t").c[0]) == 750
    p.run("select sum(v) as s from t")


def test_column_update_inside_transaction():
    p = _col(None)
    s = p.session()
    s.run("begin")
    s.run("update t set v = v + 1000 where g = 2")
    assert int(s.run("select count(*) as c from t where v >= 1000")
               .c[0]) == 250
    assert int(p.run("select count(*) as c from t where v >= 1000")
               .c[0]) == 0
    s.run("commit")
    assert int(p.run("select count(*) as c from t where v >= 1000")
               .c[0]) == 250
    assert int(p.run("select count(*) as c from t").c[0]) == 1000


def test_column_delete_rollback_and_conflict():
    p = _col(None)
    s = p.session()
    s.run("begin")
    s.run("delete from t where g = 0")
    assert int(s.run("select count(*) as c from t").c[0]) == 750
    assert int(p.run("select count(*) as c from t").c[0]) == 1000
    s.run("rollback")
    assert int(p.run("select count(*) as c from t").c[0]) == 1000
    s1, s2 = p.session(), p.session()
    s1.run("begin")
    s1.run("delete from t where g = 3")
    s2.run("begin")
    s2.run("update t set v = 0 where id = 0")
    s2.run("commit")
    assert s1.run("commit") is None           # optimistic lock
    assert int(p.run("select count(*) as c from t").c[0]) == 1000


def test_column_delete_marks_fold_at_compaction():
    p = _col(None)
    p.run("delete from t where g = 1")
    folded = [e.catalog.table("t").compact(e._maintenance_watermark())
              for e in (p.ref, p.port)]
    assert folded[0] == folded[1] >= 1
    t = p.port.catalog.table("t")
    assert sum(len(q.deletes) for s in t.shards for q in s.portions) == 0
    assert sum(q.num_rows for s in t.shards for q in s.portions) == 750
    assert int(p.run("select count(*) as c from t").c[0]) == 750


def test_own_tx_staged_rows_refuse_dml():
    p = _col(None)
    s = p.session()
    s.run("begin")
    s.run("insert into t (id, g, v) values (5000, 1, 1.0)")
    assert s.run("delete from t where id = 5000") is None
    assert s.run("update t set v = 2.0 where id = 5000") is None
    s.run("rollback")
    p.run("delete from t where id = 7")
    p.run("insert into t (id, g, v) values (7, 9, 77.0)")
    df = p.run("select g, v from t where id = 7")
    assert len(df) == 1 and int(df.g[0]) == 9 and float(df.v[0]) == 77.0


def test_row_table_count_follows_every_change():
    """A row table's `num_rows` (kept as its commits change it) equals a
    walk of its version chains after autocommit writes, staged writes,
    commits, rollbacks, aborts and ALTERs."""
    from ydb_tpu_torch.storage.mvcc import MAX_SNAPSHOT
    p = Pair()
    p.run("create table kv (id Int64 not null, v Int64, primary key (id)) "
          "with (store = row)")
    t = p.port.catalog.table("kv")

    def walked():
        return sum(1 for chain in t.rows.values()
                   if t._visible(chain, MAX_SNAPSHOT) is not None)

    rng = np.random.default_rng(3)
    sessions = [p.session() for _ in range(3)]
    for step in range(120):
        r = rng.random()
        k = int(rng.integers(0, 30))
        if r < 0.3:
            p.run(f"upsert into kv (id, v) values ({k}, {step}), "
                  f"({(k + 7) % 30}, null)")
        elif r < 0.45:
            p.run(f"delete from kv where id >= {k} and id < {k + 4}")
        elif r < 0.55:
            p.run(f"insert into kv (id, v) values ({k}, 1)")
        elif r < 0.65:
            p.run(f"update kv set v = v + 1 where id < {k}")
        else:
            s = sessions[int(rng.integers(0, 3))]
            op = rng.integers(0, 4)
            if op == 0:
                s.run("begin")
            elif op == 1:
                s.run(f"upsert into kv (id, v) values ({k}, -1)")
                s.run(f"delete from kv where id = {(k + 1) % 30}")
            elif op == 2:
                s.run("commit")
            else:
                s.run("rollback")
        assert t.num_rows == walked(), step
        if step == 60:
            p.run("alter table kv add column w Int64")
    p.run("select count(*) as n from kv")
    assert t.num_rows == walked() == \
        int(p.port.query("select count(*) as n from kv").n[0])


def test_foreign_staged_write_breaks_a_read_lock(p):
    """A read lock validates the table's `data_version`, which a foreign
    STAGED write (and its rollback) bumps as a commit does: two
    interleaved transfers on one table both abort though neither
    committed, in both packages. Under eight concurrent sessions this is
    the abort share `chip_smoke.py`'s transfer loop measures."""
    s1, s2 = p.session(), p.session()
    s1.run("begin")
    s2.run("begin")
    s1.run("update acct set bal = bal - 1 where id = 1")
    s2.run("update acct set bal = bal + 1 where id = 2")
    assert s1.run("commit") is None
    assert s2.run("commit") is None
    assert list(p.run(_BAL).bal) == [100, 100, 100]
