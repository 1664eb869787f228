"""DQ task-graph runtime — the generic stage/task/channel execution layer.

The reference distributes every query through one abstraction: a task
graph of *stages* connected by *channels* (`dq_tasks_graph.h:43-165`),
executed as one task per (stage, partition) with data streamed over
output channels (`dq_output_channel.cpp:31`). This package is that
abstraction for the cluster seam:

  * `graph`  — StageGraph / Stage / Channel dataclasses (UnionAll,
    HashShuffle, Broadcast, Merge edges);
  * `lower`  — SELECT AST + shard topology → StageGraph (the planner's
    lowering pass; subsumes the router's per-shape rewrites);
  * `task`   — worker-side task execution: run the stage program, route
    the output over its channels (hash/broadcast/collect);
  * `runner` — the control plane: one task per (stage, worker), a
    pending→running→finished/failed state machine, stage-level retry on
    channel failure, and the router-side merge stage. `LocalWorker`
    makes the in-process engine the 1-worker degenerate case.
"""

from ydb_tpu_torch.dq.graph import Channel, Stage, StageGraph  # noqa: F401
from ydb_tpu_torch.dq.lower import DqLowerError, DqTopology, lower_select  # noqa: F401
from ydb_tpu_torch.dq.runner import DqError, DqTaskRunner, LocalWorker  # noqa: F401
