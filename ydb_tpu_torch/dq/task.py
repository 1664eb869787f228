"""Worker-side task execution — the DQ compute-actor seat (port of
``ydb_tpu/dq/task.py``).

One *task* = (stage, worker): run the stage program through the local
engine, then route the result over the stage's output channels —
hash-partitioned to peers, broadcast to every peer, collected back to
the runner for a router-bound channel, or handed to the runner by
reference for a device-resident (ICI) edge. `LocalWorker`
(`dq/runner.py`) drives it in-process.

Profiling: a task that arrives with a trace context ({trace_id,
parent_span_id, sampled}) adopts it on the worker engine's tracer,
records its task-exec / output-flush spans (with the engine's own
statement and device sub-spans nested inside), and ships the finished
span list back in the response (`resp["profile"]["spans"]`) for the
runner to `ingest()` into the router's tree. Per-channel producer stats
(frames, rows, bytes, backpressure wait) and the worker's clock stamps
ship back with every response.
"""

from __future__ import annotations

import time

from ydb_tpu_torch.utils.metrics import GLOBAL


def run_task(engine, sql: str, outputs: list, src: str, send,
             counters=None, trace=None) -> dict:
    """Execute one task. `outputs`: [{"channel", "kind", "key",
    "n_peers"[, "plane"]}] specs; `send(out, peer_idx, frame_bytes)` is
    the transport for worker-bound channels; `trace`: the propagated
    context (or None). Returns {"ok", "rows_in", "dtypes",
    "bytes_shipped", "frames_shipped", "profile"[, "collected_df",
    "ici_block", "ici_key_kinds"]}."""
    counters = counters or GLOBAL
    tracer = getattr(engine, "tracer", None)
    # clock-alignment stamps (this worker's tracer clock at receive and
    # at response build): the runner pairs them with its own send and
    # receive times to rebase the worker's spans onto its timebase
    w_recv = tracer._now() if tracer is not None else None
    adopt = trace is not None and tracer is not None
    sampled = bool(adopt and trace.get("sampled"))
    if adopt:
        # adopt the router's decision either way: an UNSAMPLED context
        # still opens an (unsampled) trace so the stage statement runs
        # nested and is not sampled again as a user statement
        tracer.begin_trace(sampled=sampled,
                           trace_id=trace.get("trace_id"),
                           parent_id=trace.get("parent_span_id"))
    spans = []
    try:
        resp = _run_task_body(engine, engine.executor, sql, outputs, src,
                              send, counters, tracer, sampled)
    finally:
        if adopt:
            # end_trace force-closes anything a raising path left open
            spans = tracer.end_trace()
    if sampled:
        resp["profile"]["spans"] = [s.to_dict() for s in spans]
    if w_recv is not None:
        resp["profile"]["clock"] = {"recv_ms": round(w_recv, 3),
                                    "send_ms": round(tracer._now(), 3)}
    return resp


def _key_kind(block, key: str):
    """The hash route of a shuffle key from the SCHEMA, not the pandas
    dtype: nullable int keys widen to object dtype in pandas and would
    otherwise string-hash on one producer while a NOT NULL producer
    int-hashes — the same key landing on two consumers silently drops
    sharded-join matches."""
    if not key or not block.schema.has(key):
        return None
    dt = block.schema.dtype(key)
    return "string" if dt.is_string else "float" if dt.is_float else "int"


def _run_task_body(engine, executor, sql, outputs, src, send, counters,
                   tracer=None, sampled=False):
    from contextlib import nullcontext

    from ydb_tpu_torch.cluster.exchange import ChannelWriter, hash_partition

    def span(name, **attrs):
        return tracer.span(name, **attrs) if sampled else nullcontext()

    channel_stats: list = []
    t0 = time.perf_counter()
    with span("task-exec", src=src):
        executor.dq_stage_depth += 1
        executor.dq_device_capture = True
        try:
            block = engine.execute(sql)
        finally:
            executor.dq_stage_depth -= 1
            executor.dq_device_capture = False
    exec_ms = (time.perf_counter() - t0) * 1000.0
    # the device-resident stage spine: the block stays wherever the
    # engine produced it (a `DeviceStageBlock` for fused plans, still on
    # the device). pandas materializes LAZILY below: only a host-plane
    # egress pays the readback; ICI edges ship the block BY REFERENCE.
    resp = {"ok": True, "rows_in": int(block.length),
            "dtypes": _schema_dtypes(block)}
    df_box: list = []
    debt_box: list = []

    def df_for(debt: bool):
        """Materialize pandas ONCE for host-plane egress. `debt=True`
        lanes (a worker-bound edge on the host plane) count the readback
        on `hostsync/to_pandas_in_plan`; the router-bound collection is
        the worker's result egress and stays uncounted."""
        if not df_box:
            df = block.to_pandas()
            resp["dtypes"] = {c: str(df[c].dtype) for c in df.columns}
            df_box.append(df)
        if debt and not debt_box:
            debt_box.append(True)
            GLOBAL.inc("hostsync/to_pandas_in_plan")
        return df_box[0]

    total_bytes = total_frames = 0
    t0 = time.perf_counter()
    with span("output-flush", channels=len(outputs),
              channel_ids=",".join(str(o["channel"]) for o in outputs)):
        for out in outputs:
            kind = out["kind"]
            if kind in ("union_all", "merge"):
                resp["collected_df"] = df_for(debt=False)
                channel_stats.append({
                    "channel": out["channel"], "frames": 0,
                    "rows": int(block.length), "bytes": 0,
                    "backpressure_wait_ms": 0.0})
                continue
            if out.get("plane") == "ici":
                # device-resident edge: NO frames leave this task — the
                # runner collects every producer's stage output and runs the
                # redistribution as one exchange (`dq/ici.py`). The BLOCK
                # ships by reference, with the schema's hash-kind verdict for
                # the routing key (the signal the host plane feeds
                # `hash_partition`).
                resp["ici_block"] = block
                kkinds = resp.setdefault("ici_key_kinds", {})
                kk = _key_kind(block, out.get("key", ""))
                if kk is not None:
                    kkinds[out["channel"]] = kk
                channel_stats.append({
                    "channel": out["channel"], "frames": 0,
                    "rows": int(block.length), "bytes": 0, "plane": "ici",
                    "backpressure_wait_ms": 0.0})
                continue
            n_peers = int(out["n_peers"])
            if kind == "hash_shuffle":
                parts = hash_partition(df_for(debt=True), out["key"], n_peers,
                                       kind=_key_kind(block, out["key"]))
            elif kind == "broadcast":
                parts = [df_for(debt=True)] * n_peers
            else:
                raise ValueError(f"bad output channel kind {kind!r}")
            writer = ChannelWriter(
                out["channel"], src,
                lambda p, frame, _o=out: send(_o, p, frame),
                n_peers, counters=counters)
            try:
                for p in range(n_peers):
                    writer.ship(p, parts[p])
            finally:
                writer.close()
            total_bytes += writer.bytes_sent
            total_frames += writer.frames_sent
            channel_stats.append(writer.stats())
    flush_ms = (time.perf_counter() - t0) * 1000.0
    resp["bytes_shipped"] = total_bytes
    resp["frames_shipped"] = total_frames
    resp["profile"] = {
        "exec_ms": round(exec_ms, 3),
        "flush_ms": round(flush_ms, 3),
        "channels": channel_stats,
    }
    counters.inc("dq/tasks")
    if total_frames:
        counters.inc("dq/frames", total_frames)
        counters.inc("dq/channel_bytes", total_bytes)
    return resp


def _schema_dtypes(block) -> dict:
    """The pandas dtype `to_pandas` WOULD render, derived from the
    schema WITHOUT materializing host arrays: strings and NULL-bearing
    columns widen to object, everything else keeps its numpy dtype
    name. For a device-resident block a still-on-device validity mask
    reads as nullable (collapsing an all-valid mask to None is host
    knowledge the spine refuses to sync for); every host-plane egress
    lane overwrites these hints with exact pandas dtypes."""
    import numpy as np
    dev = getattr(block, "device", None)
    use_dev = dev is not None and not block.materialized
    out = {}
    for c in block.schema:
        masked = (c.name in dev.valids) if use_dev \
            else (block.columns[c.name].valid is not None)
        out[c.name] = "object" if (c.dtype.is_string or masked) \
            else np.dtype(c.dtype.np).name
    return out


def materialize_device_channel(engine, block, table: str) -> dict:
    """ChannelOpen, device-resident: register a landed
    `DeviceStageBlock` as the transient channel table WITHOUT
    materializing host arrays — the consumer stage's fused scan stacks
    the device columns directly (`storage/device_cache.py` superblock
    fast path), so a multi-stage plan never leaves the accelerator
    between stages. `indexate()` is deliberately skipped: portion
    min/max stats are host readbacks, and a committed-but-unindexed
    insert entry is a first-class scan source."""
    import time

    from ydb_tpu_torch.storage.mvcc import WriteVersion
    t0 = time.perf_counter()
    if engine.catalog.has(table):
        old = engine.catalog.table(table)
        if not getattr(old, "transient", False):
            raise ValueError(f"refusing to replace non-transient table "
                             f"{table!r}")
        engine.catalog.drop_table(table)
    t = engine.catalog.create_table(
        table, block.schema, [block.schema.names[0]], transient=True)
    # the landed block's dictionaries BECOME the table's (same contract
    # as the host-plane materialize below)
    t.dictionaries = dict(block.device.dictionaries)
    t.commit(t.write(block), WriteVersion(1, 1))
    return {"rows": block.length, "bytes": block.live_nbytes(),
            "wait_ms": round((time.perf_counter() - t0) * 1000.0, 3)}


def materialize_channel(engine, exchange, channel: str, table: str,
                        columns=None) -> dict:
    """Drain a channel's frames into a transient local table — the stage
    barrier's consumer side (ChannelOpen). `columns`: [(name, dtype)] so
    a worker that received no partitions still registers a typed temp.
    Namespace/auth policy stays with the caller (the servicer).
    Returns {"rows", "bytes", "wait_ms"} — the consumer-side channel
    stat (input drain + table build time) the runner attributes as the
    stage's input-wait."""
    import time

    from ydb_tpu_torch.core.block import HostBlock
    from ydb_tpu_torch.storage.mvcc import WriteVersion
    t0 = time.perf_counter()
    df, nbytes = exchange.take2(channel)
    if df.empty and columns:
        df = empty_typed_frame(columns)
    block = HostBlock.from_pandas(df)
    if engine.catalog.has(table):
        # drop-and-recreate only ever replaces a transient temp: a
        # durable table that happens to sit in the namespace is not ours
        # to clobber
        old = engine.catalog.table(table)
        if not getattr(old, "transient", False):
            raise ValueError(f"refusing to replace non-transient table "
                             f"{table!r}")
        engine.catalog.drop_table(table)
    t = engine.catalog.create_table(
        table, block.schema, [block.schema.names[0]], transient=True)
    # the block's dictionaries BECOME the table's: the binder reads
    # table-level dictionaries for group-by domains and rank LUTs —
    # leaving the fresh empty ones in place makes every string key
    # decode to code 0
    t.dictionaries = {n: cd.dictionary
                      for n, cd in block.columns.items()
                      if cd.dictionary is not None}
    t.commit(t.write(block), WriteVersion(1, 1))
    t.indexate()
    return {"rows": block.length, "bytes": int(nbytes),
            "wait_ms": round((time.perf_counter() - t0) * 1000.0, 3)}


def empty_typed_frame(columns):
    """Zero-row frame with the stage schema's dtypes — a worker whose
    channel received no partitions still registers a typed temp table."""
    import numpy as np
    import pandas as pd
    cols = {}
    for (name, dtype) in columns:
        if dtype in ("object", "str"):
            cols[name] = np.empty(0, dtype=object)
        else:
            cols[name] = np.empty(0, dtype=np.dtype(dtype))
    return pd.DataFrame(cols)
