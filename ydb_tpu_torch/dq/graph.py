"""Stage graph — the physical distribution plan.

The analog of the reference's `TDqTasksGraph` (`dq_tasks_graph.h:43-165`):
a query lowers to *stages* (each owning one program — here a rendered
stage SQL the worker engine compiles to its `ir.Program` pipelines, or a
router-side merge select) connected by typed *channels*:

  hash_shuffle  every producer routes each row to hash(key) % n_workers
                (the HashShuffle connection — co-partitions join sides);
  broadcast     every producer ships its full output to every consumer
                (the Broadcast connection — replicated build sides);
  union_all     producers ship everything to the single consumer, order
                irrelevant (the UnionAll connection — partial-agg gather);
  merge         union_all whose producers emit sorted streams; the
                consumer restores the total order (Merge connection).

union_all / merge channels with an empty dst are *router-bound*: their
frames return in the task response and the final router stage merges
them locally. Worker-bound channels land in each consumer's exchange
buffer and materialize as transient `__xj_*` tables before the consumer
stage runs (the stage barrier).

Every channel additionally carries a *data plane* — which wire its rows
actually cross:

  host   npz frames over the workers' gRPC front (`cluster/exchange.py`
         ChannelWriter → ExchangePut), the DCN seam; always available;
  ici    device-resident redistribution over the JAX mesh
         (`ydb_tpu/dq/ici.py`: bucketize + `lax.all_to_all` + compact,
         broadcast as all-gather), chosen at lowering time when BOTH
         endpoints' tasks run on devices of the same mesh — no npz, no
         gRPC, bytes counted on `dq/ici_bytes` instead of
         `dq/channel_bytes`. A failed ICI exchange falls back to
         re-running the edge on the host plane.

`quant_cols` lists the columns the planner PROVED aggregation-tolerant
(pure SUM/AVG inputs behind a final reduction — EQuARX, arxiv
2506.17615): the ICI plane may block-quantize exactly these (int8 +
per-block scale) under `YDB_TPU_DQ_QUANT=1`; keys and group-by columns
are never listed, so they always cross exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

HASH_SHUFFLE = "hash_shuffle"
BROADCAST = "broadcast"
UNION_ALL = "union_all"
MERGE = "merge"

CHANNEL_KINDS = (HASH_SHUFFLE, BROADCAST, UNION_ALL, MERGE)

PLANE_HOST = "host"
PLANE_ICI = "ici"
CHANNEL_PLANES = (PLANE_HOST, PLANE_ICI)

# consumer-side temp tables must live inside the shuffle-temp namespace
# the channel RPCs enforce (`server/service.py` SHUFFLE_TMP_PREFIX)
DQ_TMP_PREFIX = "__xj_dq"


@dataclass
class Channel:
    id: str
    kind: str                       # one of CHANNEL_KINDS
    src_stage: str
    dst_stage: str = ""             # "" = router-bound (collected)
    key: str = ""                   # hash_shuffle: routing column
    columns: list = field(default_factory=list)   # produced column names
    table: str = ""                 # consumer-side temp table name
    plane: str = PLANE_HOST         # host (gRPC frames) | ici (mesh)
    # columns proven aggregation-tolerant by the lowering — the ONLY
    # candidates for block quantization on the ICI plane
    quant_cols: list = field(default_factory=list)
    # bounds lattice: proven upper bound on rows any ONE producer ships
    # over this channel (0 = unknown). Stamped by the lowering (LIMIT
    # pushdown today). Planned redistribution (`dq/ici.exchange_blocks`)
    # consumes it: the bound caps the count-exchange segment sizing, so
    # a proven-small channel never compiles a full-capacity collective
    # even before the exchanged counts arrive. The legacy 2x exchange
    # routes materialized frames and still ignores it.
    out_bound: int = 0

    @property
    def router_bound(self) -> bool:
        return not self.dst_stage


@dataclass
class Stage:
    """One stage: the same program runs as one task per worker (or a
    single task for `on="worker0"`), or router-locally for the final
    merge stage (`on="router"`)."""
    id: str
    sql: str = ""                   # worker stage program (rendered SQL)
    inputs: list = field(default_factory=list)    # channel ids consumed
    outputs: list = field(default_factory=list)   # channel ids produced
    on: str = "workers"             # workers | worker0 | router
    # router merge stage: SELECT over the gathered frame registered as a
    # temp table — relation is TableRef(INPUT_TABLE), swapped at run time
    merge_sel: Optional[object] = None
    # router stage host-side tail: {"distinct", "order", "limit",
    # "offset"} applied via apply_order_limit (scan-shape merges whose
    # ORDER BY refers to output columns)
    post: Optional[dict] = None
    dedup_input: bool = False       # drop cross-worker duplicate rows
    # partial-aggregate merge stage: its merge_sel GROUP BY re-plans
    # through the engine and rides the tiled sorted group-by like any
    # statement (counted as dq/merge_groupby_stages)
    groupby_merge: bool = False

INPUT_TABLE = "__dq_partial__"      # merge_sel relation placeholder


@dataclass
class StageGraph:
    """Stages in topological order (lowering emits producers first) +
    the channel table. Exactly one router stage, last, produces the
    statement result."""
    stages: list = field(default_factory=list)
    channels: dict = field(default_factory=dict)
    tag: str = ""
    # Hive placement epoch this graph was lowered against (0 = static
    # topology) — a failover re-lowers, so a rerun graph carries the
    # epoch whose worker set it actually tasks
    placement_epoch: int = 0

    def stage(self, sid: str) -> Stage:
        for s in self.stages:
            if s.id == sid:
                return s
        raise KeyError(sid)

    def validate(self) -> None:
        seen: set = set()
        routers = [s for s in self.stages if s.on == "router"]
        if len(routers) != 1 or self.stages[-1].on != "router":
            raise ValueError("StageGraph needs exactly one router stage, "
                             "last")
        for ch in self.channels.values():
            if ch.kind not in CHANNEL_KINDS:
                raise ValueError(f"bad channel kind {ch.kind!r}")
            if ch.kind in (HASH_SHUFFLE, BROADCAST) and ch.router_bound:
                raise ValueError(f"{ch.kind} channel {ch.id} cannot be "
                                 "router-bound")
            if ch.plane not in CHANNEL_PLANES:
                raise ValueError(f"bad channel plane {ch.plane!r}")
            if ch.plane == PLANE_ICI and ch.router_bound:
                # router-bound channels collect in the task response;
                # there is no device edge to ride
                raise ValueError(f"channel {ch.id} cannot be ICI-plane "
                                 "and router-bound")
            if not ch.router_bound and not ch.table.startswith("__xj_"):
                raise ValueError(f"channel temp {ch.table!r} outside the "
                                 "__xj_* namespace")
        for s in self.stages:
            for cid in s.inputs:
                ch = self.channels[cid]
                if ch.src_stage not in seen:
                    raise ValueError(
                        f"stage {s.id} consumes {cid} before its producer "
                        f"{ch.src_stage} (not topological)")
            seen.add(s.id)

    def explain(self) -> str:
        lines = []
        for s in self.stages:
            outs = ", ".join(
                f"{c}:{self.channels[c].kind}"
                + (f"({self.channels[c].key})"
                   if self.channels[c].key else "")
                + (f" plane={self.channels[c].plane}"
                   if self.channels[c].plane != PLANE_HOST else "")
                for c in s.outputs)
            lines.append(f"stage {s.id} on={s.on}"
                         + (f" inputs={s.inputs}" if s.inputs else "")
                         + (f" -> {outs}" if outs else " -> result"))
            if s.sql:
                lines.append(f"  {s.sql}")
        return "\n".join(lines)
