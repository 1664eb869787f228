"""The port's device-side caches across writes.

The superblock cache, the per-portion column cache, the build cache, the
plan cache and the batch lane's groups are keyed on what a commit
changes (`data_version`, the visible scan sources, the snapshot). Each
case writes between two reads and holds the port's answers to the
reference's (`tests/torch_dml_util.Pair`) or to the serial states the
reference went through:

- a commit changes the superblock's key, and a read at the snapshot
  before it still gets the old rows, through the old stack;
- a join whose build side is written between two reads rebuilds;
- the plan cache misses after a write or an ALTER to a table the
  statement reads, and hits after a write to another;
- the batch lane never coalesces members from either side of a commit;
- reader threads beside a writer (with auto-compaction restamping
  portions) each see one serial state;
- evicting a cache entry leaves a tensor a read still holds intact.
"""

import threading

import numpy as np
import pytest

from tests import torch_threads  # noqa: F401,E402
from tests.torch_dml_util import Pair, assert_frames_equal


def _fill(p, rows=2000, store="column"):
    p.run("create table f (id Int64 not null, k Int64 not null, "
          "v Double not null, primary key (id)) with (store = "
          f"{store})")
    p.run("insert into f (id, k, v) values "
          + ", ".join(f"({i}, {i % 50}, {i * 0.5})" for i in range(rows)))


def _sb_keys(eng, table):
    uid = eng.catalog.table(table).uid
    return {k[1] for k in eng.executor.device_cache._entries
            if k[0] == "sbc" and k[1][0] == uid}


def test_superblock_key_moves_with_commits_and_old_snapshot_reads_old():
    p = Pair()
    _fill(p)
    q = "select k, count(*) as n, sum(v) as s from f group by k order by k"
    plans = p.plan_pair(q)
    before = p.run(q)
    assert p.port.executor.last_path == "fused"
    keys0 = _sb_keys(p.port, "f")
    assert len(keys0) == 1
    old = p.snapshots()
    p.ref._enter_read(old[0].plan_step)
    p.port._enter_read(old[1].plan_step)
    for sql in ["delete from f where k < 10",
                "update f set v = v + 1 where k = 20",
                "insert into f (id, k, v) values (5000, 7, 1.0)"]:
        p.run(sql)
        after = p.run(q)
        keys = _sb_keys(p.port, "f")
        assert len(keys) > len(keys0), "a commit must restack"
        keys0 = keys
        # the snapshot before every write still reads the old rows
        assert_frames_equal(p.at(plans, old), before, "old snapshot")
    assert not after.equals(before)
    # the stacks of the old snapshots stay resident until the LRU
    # drops them (the restack-after-write gap, PERF.md)
    assert len(_sb_keys(p.port, "f")) >= 4
    p.ref._exit_read(old[0].plan_step)
    p.port._exit_read(old[1].plan_step)


def test_join_build_side_written_between_reads_rebuilds():
    p = Pair()
    _fill(p)
    p.run("create table d (k Int64 not null, name Utf8 not null, "
          "w Double not null, primary key (k))")
    p.run("insert into d (k, name, w) values "
          + ", ".join(f"({i}, 'n{i % 7}', {i * 2.0})" for i in range(50)))
    q = ("select d.name, count(*) as n, sum(f.v * d.w) as s from f join d "
         "on f.k = d.k where d.w > 10 group by d.name order by d.name")
    bc = p.port.executor.build_cache
    p.run(q)
    m0, h0 = bc.misses, bc.hits
    p.run(q)
    assert bc.hits > h0 and bc.misses == m0, "a warm join reuses its build"
    for sql in ["update d set w = w * 3 where k < 20",
                "delete from d where k = 30",
                "insert into d (k, name, w) values (60, 'new', 99.0)",
                "insert into f (id, k, v) values (9000, 60, 2.0)"]:
        p.run(sql)
        m1 = bc.misses
        p.run(q)
        if sql.startswith("insert into f"):
            assert bc.misses == m1, "a probe-side write keeps the build"
        else:
            assert bc.misses > m1, "a build-side write must rebuild"


@pytest.mark.parametrize("store", ["column", "row"])
def test_plan_cache_misses_after_write_or_alter(store):
    p = Pair()
    _fill(p, rows=200, store=store)
    p.run("create table other (id Int64 not null, primary key (id))")
    q = "select k, sum(v) as s from f where k < 5 group by k order by k"

    def hit():
        p.run(q)
        return p.port.last_stats.plan_cache_hit, \
            p.ref.last_stats.plan_cache_hit

    assert hit() == (False, False)
    assert hit() == (True, True)
    p.run("insert into other (id) values (1)")
    assert hit() == (True, True), "another table's write keeps the plan"
    for sql in ["update f set v = v + 1 where k = 3",
                "insert into f (id, k, v) values (9000, 1, 1.0)",
                "delete from f where id = 9000",
                "alter table f add column extra Int64",
                "alter table f drop column extra"]:
        p.run(sql)
        assert hit() == (False, False), sql
        assert hit() == (True, True), sql


def test_batch_lane_never_coalesces_across_a_commit(monkeypatch):
    """Four point SELECTs enter the lane's window, a commit lands, four
    more arrive: every member's answer equals the reference's at its own
    side of the commit, the commit changed every member's row, and the
    members of each group share one snapshot's scan sources."""
    from ydb_tpu.query import QueryEngine as RefEngine
    from ydb_tpu_torch.query import QueryEngine
    from ydb_tpu_torch.utils.metrics import GLOBAL
    monkeypatch.setenv("YDB_TPU_BATCH_WINDOW", "400")
    monkeypatch.setenv("YDB_TPU_BATCH_MAX", "8")
    eng = QueryEngine(device="cpu", block_rows=1 << 12)
    ref = RefEngine(block_rows=1 << 12)
    setup = ["create table t (k Int64 not null, a Int64 not null, "
             "b Double not null, primary key (k))",
             "insert into t (k, a, b) values "
             + ", ".join(f"({i}, {i * 3}, {i * 0.25})" for i in range(400))]
    update = "update t set b = b + 1000.0 where k < 8"
    for sql in setup:
        eng.execute(sql)
        ref.execute(sql)
    texts = [f"select a, b from t where k = {i}" for i in range(8)]
    for sql in texts:
        eng.query(sql)                      # warm every text once
    pre = {i: ref.query(q) for i, q in enumerate(texts)}
    ref.execute(update)
    assert ref.last_rows_affected == 8
    post = {i: ref.query(q) for i, q in enumerate(texts)}
    for i in range(8):
        assert not post[i].equals(pre[i]), texts[i]
    lane = eng._batch_lane
    seen, mu = [], threading.Lock()
    real_key = lane._group_key

    def group_key(plan, snap, est, *a, **k):
        key = real_key(plan, snap, est, *a, **k)
        with mu:
            seen.append((snap.plan_step, key))
        return key

    monkeypatch.setattr(lane, "_group_key", group_key)
    snaps, results, errs = {}, {}, []
    first, second = threading.Barrier(5), threading.Barrier(5)
    real_register = eng._register_read

    def register():
        snap = real_register()
        snaps[threading.get_ident()] = snap.plan_step
        return snap

    monkeypatch.setattr(eng, "_register_read", register)
    b0 = GLOBAL.get("batch/batches")

    def reader(i, gate):
        try:
            gate.wait()
            df = eng.query(texts[i])
            results[i] = (snaps[threading.get_ident()], df)
        except Exception as e:              # noqa: BLE001 — collected
            errs.append((i, e))

    threads = [threading.Thread(target=reader, args=(i, first if i < 4
                                                     else second))
               for i in range(8)]
    for th in threads:
        th.start()
    first.wait()
    import time
    time.sleep(0.05)                        # the first four are queued
    eng.execute(update)
    affected = eng.last_rows_affected
    step = eng.snapshot().plan_step
    second.wait()
    for th in threads:
        th.join()
    assert not errs, errs
    assert affected == 8
    sides = set()
    for i, (snap_step, df) in results.items():
        want = post[i] if snap_step >= step else pre[i]
        sides.add(snap_step >= step)
        assert_frames_equal(df, want, texts[i])
    assert sides == {False, True}, "the commit must split the storm"
    by_key: dict = {}
    for snap_step, key in seen:
        if key is not None:
            by_key.setdefault(key, set()).add(snap_step >= step)
    assert all(len(s) == 1 for s in by_key.values()), by_key
    assert GLOBAL.get("batch/batches") > b0, "the lane must coalesce"


def test_readers_beside_a_writer_see_serial_states():
    """Reader threads scan while a writer commits inserts, deletes and
    updates with auto-compaction on: every read equals one of the serial
    states the reference passes through."""
    from ydb_tpu.query import QueryEngine as RefEngine
    from ydb_tpu_torch.query import QueryEngine
    setup = ["create table t (id Int64 not null, g Int64 not null, "
             "v Double not null, primary key (id))"]
    setup += [f"insert into t (id, g, v) values ({i * 10}, {i % 3}, "
              f"{i * 1.5})" for i in range(6)]
    writes = [f"insert into t (id, g, v) values ({1000 + i}, {i % 3}, "
              f"{i * 0.5})" for i in range(10)]
    writes += ["delete from t where g = 1",
               "update t set v = v * 2 where g = 2",
               "delete from t where id >= 1005"]
    writes += [f"insert into t (id, g, v) values ({2000 + i}, 0, 1.0)"
               for i in range(6)]
    q = "select count(*) as n, sum(v) as s, min(id) as lo from t"
    ref = RefEngine(block_rows=1 << 10)
    for sql in setup:
        ref.execute(sql)
    states = [ref.query(q)]
    for sql in writes:
        ref.execute(sql)
        states.append(ref.query(q))
    want = {(int(s.n[0]), round(float(s.s[0]), 6), int(s.lo[0]))
            for s in states}
    eng = QueryEngine(device="cpu", block_rows=1 << 10)
    for sql in setup:
        eng.execute(sql)
    got, errs, stop = [], [], threading.Event()

    def reader():
        try:
            while not stop.is_set():
                df = eng.query(q)
                got.append((int(df.n[0]), round(float(df.s[0]), 6),
                            int(df.lo[0])))
        except Exception as e:              # noqa: BLE001 — collected
            errs.append(e)

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for th in threads:
        th.start()
    for sql in writes:
        eng.execute(sql)
    stop.set()
    for th in threads:
        th.join()
    assert not errs, errs
    assert got and set(got) <= want, set(got) - want
    assert not eng._active_reads
    final = eng.query(q)
    assert (int(final.n[0]), round(float(final.s[0]), 6),
            int(final.lo[0])) == \
        (int(states[-1].n[0]), round(float(states[-1].s[0]), 6),
         int(states[-1].lo[0]))


def test_eviction_leaves_a_held_tensor_intact():
    from ydb_tpu_torch.query import QueryEngine
    eng = QueryEngine(device="cpu", block_rows=1 << 10)
    eng.execute("create table t (id Int64 not null, v Double not null, "
                "primary key (id))")
    eng.execute("insert into t (id, v) values "
                + ", ".join(f"({i}, {i * 1.0})" for i in range(100)))
    eng.query("select sum(v) as s from t")
    dc = eng.executor.device_cache
    held = [ent[0] for ent in dc._entries.values()]
    copies = [h.clone() for h in held]
    dc.reserve(1 << 62)                     # evict everything
    assert not dc._entries and dc.bytes == 0
    for h, c in zip(held, copies):
        assert np.array_equal(h.numpy(), c.numpy())
