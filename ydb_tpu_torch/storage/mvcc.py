"""MVCC versions — the (plan step, tx id) pair.

Mirrors the reference's snapshot model (`ydb/core/tx/columnshard`: writes are
committed at a coordinator-assigned plan step; scans read "as of" a snapshot
`TSnapshot{PlanStep, TxId}`). The coordinator/mediator machinery lives in
ydb_tpu/tx (`tx/coordinator.py` plan-step allocation, `tx/session.py`
interactive transactions); storage only orders versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering
from typing import Optional


@total_ordering
@dataclass(frozen=True)
class WriteVersion:
    plan_step: int
    tx_id: int

    def __lt__(self, other: "WriteVersion") -> bool:
        return (self.plan_step, self.tx_id) < (other.plan_step, other.tx_id)


@dataclass(frozen=True)
class Snapshot:
    plan_step: int
    tx_id: int
    # an open interactive transaction reading its OWN uncommitted writes:
    # storage makes entries tagged with this tx id visible in addition to
    # everything the (plan_step, tx_id) watermark includes (the DataShard
    # "immediate tx sees its accumulated effects" semantics)
    tx_view: Optional[int] = None

    def includes(self, v: WriteVersion) -> bool:
        return (v.plan_step, v.tx_id) <= (self.plan_step, self.tx_id)


MAX_SNAPSHOT = Snapshot(2**62, 2**62)
