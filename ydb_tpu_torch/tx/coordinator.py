"""Transaction coordinator — plan-step allocation and commit ordering.

The reference's coordinator tablet (`ydb/core/tx/coordinator/
coordinator_impl.h:209`, `coordinator__plan_step.cpp`) assigns global plan
steps that order distributed transactions across shards; the mediator
(`ydb/core/tx/mediator/`) fans each step out to per-shard execute queues,
and TimeCast (`time_cast/time_cast.h:70`) tells shards the safe watermark
for MVCC reads.

In-process v0: one Coordinator owns the monotonic (plan_step, tx_id)
space. `propose` is the plan-step grant; because all shards live in this
process, mediator fan-out degenerates to the caller applying the commit
synchronously — the protocol boundary (propose → stamped version →
per-shard apply) is kept so a networked mediator can slot in.
"""

from __future__ import annotations

from ydb_tpu_torch.storage.mvcc import Snapshot, WriteVersion


class Coordinator:
    def __init__(self, start_step: int = 1):
        import threading
        self._mu = threading.Lock()
        self._plan_step = max(1, start_step)
        # read watermark: the highest plan step whose commit has finished
        # APPLYING (stamps + delete marks in memory). propose() grants a
        # step but does not publish it — lock-free readers snapshotting
        # mid-commit must not observe a torn multi-shard apply (partial
        # inserts, or an UPDATE's re-inserts without its delete marks).
        self._published = self._plan_step
        self._proposed: set[int] = set()    # granted, not yet published
        self._next_tx = 1
        self._pinned: dict[int, int] = {}   # open tx id -> snapshot step

    def begin_tx(self) -> int:
        """Allocate a transaction id (the TxProxy tx-allocator analog)."""
        with self._mu:
            tx = self._next_tx
            self._next_tx += 1
            return tx

    def propose(self, tx_id: int = 0) -> WriteVersion:
        """Grant the next plan step to a committing transaction. The step
        becomes readable only after `publish(step)` — callers must publish
        once the commit's in-memory apply completes (or aborts)."""
        with self._mu:
            self._plan_step += 1
            self._proposed.add(self._plan_step)
            return WriteVersion(self._plan_step, tx_id)

    def publish(self, plan_step: int) -> None:
        """Mark a granted plan step fully applied; advances the read
        watermark past every contiguous applied step (the mediator's
        step-complete acknowledgement, `coordinator__plan_step.cpp`)."""
        with self._mu:
            self._proposed.discard(plan_step)
            self._published = (min(self._proposed) - 1) if self._proposed \
                else self._plan_step

    def read_snapshot(self) -> Snapshot:
        """Safe MVCC read watermark (the TimeCast analog): everything
        published so far is visible, nothing mid-apply is."""
        with self._mu:
            return Snapshot(self._published, 2 ** 62)

    # -- pinned snapshots (open interactive txs) --------------------------

    def pin_snapshot(self, tx_id: int, plan_step: int) -> None:
        with self._mu:
            self._pinned[tx_id] = plan_step

    def unpin_snapshot(self, tx_id: int) -> None:
        with self._mu:
            self._pinned.pop(tx_id, None)

    def safe_watermark(self) -> int:
        """Highest plan step no pinned snapshot is behind — background
        maintenance (compaction re-stamps merged portions) must not touch
        versions newer than this, or pinned readers lose rows. Bounded by
        the published watermark: restamping into a mid-apply step would
        outrun every current reader's snapshot."""
        with self._mu:
            if self._pinned:
                return min(min(self._pinned.values()), self._published)
            return self._published

    @property
    def last_plan_step(self) -> int:
        return self._plan_step
