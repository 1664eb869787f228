"""Interactive transactions — BEGIN / COMMIT / ROLLBACK with optimistic
locks.

The reference's session actor holds per-session tx state
(`ydb/core/kqp/session_actor/kqp_session_actor.cpp`), acquires optimistic
locks during reads (`ydb/core/tx/locks/`), and commits through the
coordinator plan-step protocol with lock validation at commit time.

v0 semantics (snapshot isolation + table-granular optimistic locks):

  * BEGIN captures the coordinator's read snapshot; every statement in the
    tx reads at that snapshot PLUS the tx's own uncommitted writes
    (`Snapshot.tx_view`);
  * writes stage against storage tagged with the tx id — row tables get
    unstamped version-chain entries, column tables uncommitted insert-table
    writes — invisible to every other session;
  * each table READ records (uid, data_version-at-snapshot) in the lock
    set and validates TABLE-granular at commit (any foreign bump since
    BEGIN → TxAborted); own staged writes bump data_version, so the
    lock remembers how many bumps were self-inflicted;
  * tables only ever WRITTEN validate finer (the row/range-lock
    refinement of `ydb/core/tx/locks/`): row-store blind writes take
    pk-granular write locks — commit aborts only when a foreign commit
    newer than the snapshot touched one of OUR keys — and column-store
    blind inserts are commuting appends (no conflict possible without a
    read);
  * COMMIT validates every lock, then takes one coordinator plan step
    and stamps all staged writes at it — atomically visible, since
    readers order by plan step;
  * ROLLBACK (or abort) removes every staged write.

Reads stay table-granular (no predicate locks), which keeps the
protocol sound: serializable over row tables, snapshot-write isolation
over column tables.
"""

from __future__ import annotations

from typing import Optional

from ydb_tpu_torch.storage.mvcc import Snapshot


class TxAborted(Exception):
    """Optimistic lock broken: a conflicting commit landed since BEGIN."""


class TxCommitTorn(Exception):
    """Internal error: a multi-table COMMIT failed mid-apply. Tables
    whose apply already landed keep their writes (stamped versions
    cannot be recalled); everything not yet applied was force-aborted
    and the session's transaction is cleared. Deliberately NOT a
    `TxAborted` subclass: the standard `except TxAborted: retry` idiom
    is only safe when nothing landed, and a torn commit re-run would
    double-apply the tables that did — clients must handle it
    explicitly (operator attention, not retry)."""


class Transaction:
    def __init__(self, tx_id: int, snapshot: Snapshot,
                 begin_versions: dict):
        self.tx_id = tx_id
        self.snapshot = Snapshot(snapshot.plan_step, snapshot.tx_id,
                                 tx_view=tx_id)
        # data_version of every table AS OF BEGIN — the lock baseline
        # (first-touch versions would miss commits landing between BEGIN
        # and the first read, which the tx's snapshot cannot see)
        self.begin_versions = begin_versions
        # uid -> [table, baseline version, self bumps since]
        self.locks: dict = {}
        # READ-locked tables validate table-granular; tables only ever
        # WRITTEN validate at pk granularity (row stores) or commute
        # (column inserts are pure appends) — concurrent blind upserts
        # to disjoint keys stop aborting spuriously (the row/range-lock
        # refinement of `ydb/core/tx/locks/`, point-write granularity)
        self.read_locked: set = set()
        self.write_pks: dict = {}      # uid -> set of pk tuples
        self.row_writes: list = []     # (table, ops) in apply order
        self.col_writes: list = []     # (table, [(shard, wid)])
        self.col_deletes: list = []    # (table, [delete-mark handles])

    def lock(self, table, read: bool = True) -> None:
        if read:
            self.read_locked.add(table.uid)
        if table.uid not in self.locks:
            seen = self.begin_versions.get(table.uid, table.data_version)
            self.locks[table.uid] = [table, seen, 0]

    def note_self_bump(self, table, n: int = 1,
                       write_pks=None) -> None:
        self.lock(table, read=False)
        self.locks[table.uid][2] += n
        if write_pks is not None:
            self.write_pks.setdefault(table.uid, set()).update(write_pks)

    def validate(self) -> None:
        for uid, (table, seen, self_bumps) in self.locks.items():
            if uid in self.read_locked:
                if table.data_version - self_bumps != seen:
                    raise TxAborted(
                        f"optimistic lock broken on table {table.name!r}")
                continue
            # write-only: point conflicts on the touched keys only
            pks = self.write_pks.get(uid)
            check = getattr(table, "max_committed_step", None)
            if pks and check is not None \
                    and check(pks) > self.snapshot.plan_step:
                raise TxAborted(
                    f"write-write conflict on table {table.name!r}")
            # write-only column-table appends commute: no check


class Session:
    """One interactive session over a shared engine (the session-actor
    analog). Sessions share catalog/executor/coordinator; each holds at
    most one open transaction."""

    def __init__(self, engine):
        import threading
        self.engine = engine
        self.tx: Optional[Transaction] = None
        # one statement at a time per session: a client pipelining e.g.
        # SELECT and COMMIT on the same session must not race on self.tx
        # (the reference rejects with SESSION_BUSY; here the second
        # statement queues). The engine-wide default session skips this —
        # anonymous autocommit reads are the concurrent path.
        self._mu = threading.RLock()

    # -- statement entry ---------------------------------------------------

    def execute(self, sql: str):
        return self.engine.execute(sql, session=self)

    def query(self, sql: str):
        return self.engine.execute(sql, session=self).to_pandas()

    # -- tx control --------------------------------------------------------

    def begin(self) -> None:
        if self.tx is not None:
            raise TxAborted("transaction already open")
        coord = self.engine.coordinator
        begin_versions = {t.uid: t.data_version
                          for t in self.engine.catalog.tables.values()}
        self.tx = Transaction(coord.begin_tx(), coord.read_snapshot(),
                              begin_versions)
        coord.pin_snapshot(self.tx.tx_id, self.tx.snapshot.plan_step)

    def commit(self) -> None:
        tx = self._require_tx()
        try:
            tx.validate()
        except TxAborted:
            self._abort(tx)
            raise
        coord = self.engine.coordinator
        version = coord.propose(tx.tx_id)
        # group column writes + delete marks PER TABLE: one commit call
        # carries both through one intent-journal record (an UPDATE's
        # deletes and re-inserts must survive a crash together)
        col_tables: dict = {}
        for table, writes in tx.col_writes:
            ent = col_tables.setdefault(id(table), [table, [], []])
            ent[1].extend(writes)
        for table, handles in tx.col_deletes:
            ent = col_tables.setdefault(id(table), [table, [], []])
            ent[2].extend(handles)
        # keys are id(table) for BOTH kinds (col_tables is keyed that
        # way too). A table is "landed" once its apply call returned;
        # the table whose apply call is IN FLIGHT when an exception hits
        # is in-doubt: stamp_tx stamps chains before its WAL append and
        # table.commit's durable record (store.commit_table) precedes
        # its dictionary/state saves — either may have landed, so the
        # poison path must never roll an in-doubt table back (a WAL
        # abort for committed wids would drop the rows at the next
        # replay — silent durable loss); un-landed staged writes heal
        # at boot.
        landed: set = set()
        in_doubt_key = None
        try:
            for table, ops in tx.row_writes:
                in_doubt_key = id(table)
                table.stamp_tx(tx.tx_id, version, ops_for_wal=ops)
                landed.add(id(table))
                in_doubt_key = None
            for key, (table, writes, handles) in col_tables.items():
                hits = [(shard, portion, mark.rows)
                        for (shard, portion, mark) in handles]
                for (_shard, portion, mark) in handles:
                    portion.drop_delete(mark)  # replaced by committed marks
                in_doubt_key = key
                table.commit(writes, version, deletes=hits)
                landed.add(key)
                in_doubt_key = None
        except Exception as e:         # noqa: BLE001 — poison, don't tear
            keep = set(landed)
            if in_doubt_key is not None:
                keep.add(in_doubt_key)
            self._poison_torn_commit(tx, col_tables, keep, version, e)
        # indexation is maintenance, not part of commit atomicity: run it
        # only once every table's apply landed, and never let it poison a
        # fully-committed transaction (the next commit/indexate retries)
        for (table, _writes, _handles) in col_tables.values():
            try:
                table.indexate()
            except Exception:          # noqa: BLE001 — best-effort
                pass
        # read watermark advances only once every shard's apply landed
        # (lock-free readers must never see a torn cross-table commit)
        coord.publish(version.plan_step)
        if self.engine.catalog.store is not None:
            self.engine.catalog.store.save_state(version.plan_step)
        self.engine.coordinator.unpin_snapshot(tx.tx_id)
        self.tx = None

    def _poison_torn_commit(self, tx: Transaction, col_tables: dict,
                            keep: set, version,
                            cause: Exception) -> None:
        """A multi-table apply failed partway. The r5 `finally` published
        the half-applied step and left the tx open — readers saw a torn
        cross-table commit forever and a retry double-applied. Instead:
        force-abort everything not yet applied (`keep` holds the landed
        tables — stamped versions cannot be recalled — plus the table
        whose apply call was in flight: its stamps/durable record may
        have landed, so rolling it back could destroy committed data),
        publish the step so the read watermark never wedges behind it,
        clear the session's tx, and surface a distinct internal error
        naming what did (or may have) landed."""
        applied = sorted({t.name for t, _ops in tx.row_writes
                          if id(t) in keep}
                         | {ent[0].name for k, ent in col_tables.items()
                            if k in keep})
        for table, _ops in tx.row_writes:
            if id(table) in keep:
                continue
            try:
                table.rollback_tx(tx.tx_id)
            except Exception:          # noqa: BLE001 — best-effort abort
                pass
        for key, (table, writes, handles) in col_tables.items():
            if key in keep:
                continue
            try:
                table.rollback_deletes(handles)
            except Exception:          # noqa: BLE001
                pass
            try:
                table.rollback(writes)
            except Exception:          # noqa: BLE001
                pass
        coord = self.engine.coordinator
        coord.publish(version.plan_step)
        coord.unpin_snapshot(tx.tx_id)
        self.tx = None
        if not keep:
            # nothing landed and nothing is in doubt: every write was
            # cleanly force-aborted, so the safe-retry contract of a
            # plain TxAborted still holds — don't escalate to the
            # must-not-retry torn error
            raise TxAborted(
                f"commit failed before any write landed "
                f"({type(cause).__name__}: {cause}); transaction "
                "force-aborted cleanly — safe to retry") from cause
        raise TxCommitTorn(
            f"internal: multi-table commit torn at plan step "
            f"{version.plan_step} ({type(cause).__name__}: {cause}); "
            f"applied (or in-doubt) tables: {applied or 'none'}; "
            "everything else force-aborted") from cause

    def rollback(self) -> None:
        tx = self._require_tx()
        self._abort(tx)

    def _abort(self, tx: Transaction) -> None:
        for table, _ops in tx.row_writes:
            table.rollback_tx(tx.tx_id)
        for table, handles in tx.col_deletes:
            table.rollback_deletes(handles)
        for table, writes in tx.col_writes:
            table.rollback(writes)
        self.engine.coordinator.unpin_snapshot(tx.tx_id)
        self.tx = None

    def _require_tx(self) -> Transaction:
        if self.tx is None:
            raise TxAborted("no open transaction")
        return self.tx

    # -- engine integration ------------------------------------------------

    @property
    def snapshot(self) -> Optional[Snapshot]:
        return self.tx.snapshot if self.tx is not None else None
