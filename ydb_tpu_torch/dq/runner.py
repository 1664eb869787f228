"""DQ task runner — the executer over a StageGraph (port of
``ydb_tpu/dq/runner.py``).

Walks the graph in topological order; each worker stage runs as one task
per worker, tracked through a pending → running → finished/failed state
machine, the tasks of a stage on a thread pool. Channel failures retry at
STAGE granularity: the stage's output channels are dropped everywhere
reachable and every task re-runs with the SAME frame src — stage
programs are deterministic, so a first attempt that is still running
ships frames with identical (src, seq) identities and payloads, and the
receiver's (src, seq)-keyed dedup absorbs whichever lands second.

A stage's ICI edges run after its tasks as one exchange per channel over
every producer's stage output (`dq/ici.py`). Only the plane's declines
(`IciPlaneError`) and a lost worker (a transport error, `DqWorkerLost`)
re-run the edge on the host plane; any other exception, a kernel's
included, reaches the caller.

`LocalWorker` adapts an in-process `QueryEngine` to the worker surface
the runner drives, so a 1-worker graph is the degenerate case of the
distributed code path.

Profiling: the whole graph runs under the merge engine's tracer and one
resource ledger. Each stage is a `dq-stage` span, each ICI exchange an
`ici-exchange` span, each task attempt a `dq-task` span under which the
worker's own spans (its engine's statement and device spans) are
ingested, rebased onto the router's clock by the offset that each
call's clock stamps give. The port has no gRPC transport.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time

import pandas as pd

from ydb_tpu_torch.cluster.exchange import ExchangeBuffer
from ydb_tpu_torch.dq.graph import StageGraph
from ydb_tpu_torch.sql import ast, render
from ydb_tpu_torch.utils.metrics import GLOBAL


class DqError(Exception):
    pass


class DqWorkerLost(DqError):
    """A task's worker is gone at the TRANSPORT level (connection
    refused or reset, a deadline): its shard cannot re-run anywhere
    without re-placement, so the runner surfaces the loss at once
    instead of burning `stage_retries` against a corpse."""


def _is_transport_error(e) -> bool:
    """Transport-level failure (the worker or its link, not the query):
    socket-level exceptions. In-band worker errors arrive as other
    exceptions and are NOT transport — they retry on the same worker."""
    return isinstance(e, (ConnectionError, TimeoutError, OSError))


def _ici_declined(e) -> bool:
    """An ICI exchange failure that falls back to the host plane: the
    plane's own declines and a lost worker (a dropped connection or a
    deadline). Anything else is a fault and reaches the caller: a
    kernel's error, and a bare OSError too, which in this in-process
    exchange is a kernel library that failed to build or load, not a
    link."""
    from ydb_tpu_torch.dq.ici import IciPlaneError
    return isinstance(e, (IciPlaneError, DqWorkerLost, ConnectionError,
                          TimeoutError))


# clock alignment per worker handle: each task call brackets the
# worker's receive/respond stamps on its own tracer clock
# (`resp["profile"]["clock"]`), and the midpoint difference is the
# router-minus-worker offset with ±RTT/2 uncertainty, EWMA-smoothed per
# worker handle

_CLOCK_ALPHA = 0.3


def observe_clock(worker, t_send: float, t_recv: float,
                  w_recv: float, w_send: float):
    """One offset sample at an RPC boundary, folded into the worker's
    EWMA. All times in ms on their respective tracer clocks. Returns
    (offset_ms, err_ms): router_time ≈ worker_time + offset_ms."""
    sample = ((t_send + t_recv) / 2.0) - ((w_recv + w_send) / 2.0)
    err = max(0.0, ((t_recv - t_send) - (w_send - w_recv)) / 2.0)
    prev = getattr(worker, "_clock_ewma", None)
    if prev is None:
        off = (sample, err)
    else:
        off = (_CLOCK_ALPHA * sample + (1 - _CLOCK_ALPHA) * prev[0],
               _CLOCK_ALPHA * err + (1 - _CLOCK_ALPHA) * prev[1])
    worker._clock_ewma = off
    return off


class DqTaskRunner:
    def __init__(self, workers: list, engine, counters=None,
                 stage_retries: int = 1):
        self.workers = list(workers)
        self.engine = engine                 # router-side merge engine
        self.counters = counters or GLOBAL
        self.stage_retries = stage_retries
        # per-(stage, worker) execution stats for THIS graph run, and one
        # row per ICI channel (state "channel")
        self.stage_stats: list = []
        self._input_waits: dict = {}         # (stage id, widx) -> ms
        # per-stage device-plane wire accounting (filled by the ICI
        # exchanges): stage id -> {"ici_bytes", "ici_frames", ...}
        self._ici_stage_stats: dict = {}
        # endpoints whose last call died at the transport level: later
        # attempts and stages skip them (reroute single-task stages,
        # raise DqWorkerLost for per-shard ones)
        self.transport_failed: set = set()
        # the graph run's closed ledger summary (None when the ledger is
        # off or an enclosing statement owns it)
        self.mem_summary = None
        for w in self.workers:
            if hasattr(w, "bind_peers"):
                try:
                    w.bind_peers(self.workers)
                except Exception as e:       # noqa: BLE001 — a worker
                    # already dead at bind time is an early transport
                    # failure, surfaced when its first task runs
                    if _is_transport_error(e):
                        self.transport_failed.add(w.endpoint)
                    else:
                        raise

    # -- tracing helpers ----------------------------------------------------

    @property
    def tracer(self):
        return getattr(self.engine, "tracer", None)

    def _span(self, name: str, **attrs):
        from contextlib import nullcontext
        t = self.tracer
        return t.span(name, **attrs) if t is not None else nullcontext()

    @staticmethod
    def _trace_ctx(base_ctx, parent_span) -> dict:
        """Propagation context for a task RPC: the router trace's id,
        the task span to parent under, and the sampling bit. `base_ctx`
        MUST be captured on the trace-owning thread (`tracer.current()`
        is thread-local) — task RPCs fire from pool threads."""
        if base_ctx is None:
            return None
        if parent_span is not None:
            return dict(base_ctx, parent_span_id=parent_span.span_id)
        return dict(base_ctx)

    # -- public -------------------------------------------------------------

    def run(self, graph: StageGraph) -> pd.DataFrame:
        graph.validate()
        self._dtypes: dict = {}              # channel id -> {col: dtype}
        self._collected: dict = {}           # channel id -> {widx: frame}
        # resource ledger for the whole graph run: a router-driven DQ
        # query never passes through engine.execute() at this level, so
        # the runner owns the statement ledger — the nested router-merge
        # statement then contributes to it instead of opening its own
        from ydb_tpu_torch.utils import memledger
        led = memledger.open_statement()
        try:
            for stage in graph.stages:
                if stage.on == "router":
                    return self._run_router_stage(graph, stage)
                self._run_worker_stage(graph, stage)
            raise DqError("stage graph ended without a router stage")
        finally:
            if led is not None:
                memledger.close_statement(led)
                self.mem_summary = led.summary()
                rm = getattr(self.engine, "_record_memory", None)
                if rm is not None:
                    rm(f"dq-graph:{graph.tag}", "dq", led)
            self._cleanup(graph)

    # -- worker stages ------------------------------------------------------

    def _task_workers(self, stage) -> list:
        """Workers to task for a stage, honoring transport-dead skips.
        A single-task stage (`worker0`: replicated-only data, every
        worker holds a full copy) REROUTES onto the first live worker. A
        per-shard stage must task every worker; a dead one among them is
        a worker-lost condition, not a reroute."""
        if stage.on == "worker0":
            for (i, w) in enumerate(self.workers):
                if w.endpoint not in self.transport_failed:
                    return [(i, w)]
            raise DqWorkerLost(
                f"stage {stage.id}: no live worker for single-task "
                f"stage (all {len(self.workers)} transport-failed)")
        return list(enumerate(self.workers))

    def _run_worker_stage(self, graph, stage) -> None:
        from ydb_tpu_torch.utils.metrics import GLOBAL_HIST
        self.counters.inc("dq/stages")
        if self._stage_ici_channels(graph, stage) \
                and not all(hasattr(w, "ici_land") for w in self.workers):
            # defense in depth: the lowering promised in-process workers
            # the runner's worker set cannot honor — the host plane is
            # always correct
            self._flip_to_host(graph, stage,
                               "workers are not in-process")
        t_stage = time.perf_counter()
        with self._span("dq-stage", stage=stage.id,
                        tasks=len(self._task_workers(stage))):
            self._materialize_inputs(graph, stage)
            results, tasks = self._run_stage_attempts(
                graph, stage, self._output_specs(graph, stage))
            ici_chs = self._stage_ici_channels(graph, stage)
            if ici_chs:
                try:
                    self._run_ici_exchanges(graph, stage, ici_chs,
                                            results)
                except Exception as e:       # noqa: BLE001 — classified
                    if not _ici_declined(e):
                        raise
                    # a declined exchange or a worker lost mid-exchange:
                    # the edge re-runs on the host plane — same stage
                    # programs, fresh host frames, the receivers' (src,
                    # seq) dedup guards the overlap
                    self._flip_to_host(graph, stage,
                                       f"{type(e).__name__}: {e}")
                    self._drop_outputs(graph, stage)
                    results, tasks = self._run_stage_attempts(
                        graph, stage, self._output_specs(graph, stage))
        # success-only, matching the router stage and query/latency_ms
        GLOBAL_HIST.observe("dq/stage_ms",
                            (time.perf_counter() - t_stage) * 1000.0)

        for (i, resp, _e) in results:
            for cid in stage.outputs:
                ch = graph.channels[cid]
                self._dtypes.setdefault(cid, {}).update(
                    resp.get("dtypes") or {})
                if ch.router_bound:
                    frame = self._collected_frame(resp)
                    if frame is not None:
                        self._collected.setdefault(cid, {})[i] = frame
            self.counters.inc("dq/channel_bytes",
                              resp.get("bytes_shipped", 0))
            self.counters.inc("dq/frames", resp.get("frames_shipped", 0))
            self._note_task_stats(graph, stage, tasks[i], resp, i)

    # -- channel planes ------------------------------------------------------

    def _output_specs(self, graph, stage) -> list:
        specs = []
        for cid in stage.outputs:
            ch = graph.channels[cid]
            spec = {"channel": ch.id, "kind": ch.kind, "key": ch.key,
                    "n_peers": len(self.workers),
                    "peers": [w.endpoint for w in self.workers]}
            if ch.plane == "ici":
                spec["plane"] = "ici"
            specs.append(spec)
        return specs

    @staticmethod
    def _stage_ici_channels(graph, stage) -> list:
        return [graph.channels[cid] for cid in stage.outputs
                if graph.channels[cid].plane == "ici"]

    def _flip_to_host(self, graph, stage, reason: str) -> None:
        """Re-lower this stage's ICI edges onto the host plane (the
        always-available data plane) — counted so operators see every
        edge that did NOT go device-resident as planned."""
        for ch in self._stage_ici_channels(graph, stage):
            ch.plane = "host"
            self.counters.inc("dq/ici_fallbacks")
        self._ici_stage_stats.pop(stage.id, None)

    def _run_ici_exchanges(self, graph, stage, ici_chs, results) -> None:
        """Execute the stage's device-resident edges: ONE exchange per
        channel over every producer's stage output (`dq/ici.py`), over
        the workers' devices, the per-consumer partitions landing
        straight in each worker — no npz, no exchange buffer. Bytes count
        on `dq/ici_bytes` (`dq/channel_bytes` stays untouched for these
        edges)."""
        from ydb_tpu_torch.dq import ici
        by_idx = {i: resp for (i, resp, _e) in results}
        blocks = []
        for i in range(len(self.workers)):
            resp = by_idx.get(i)
            if resp is None or "ici_block" not in resp:
                raise ici.IciPlaneError(
                    f"stage {stage.id}: task w{i} shipped no device "
                    "frame")
            blocks.append(resp["ici_block"])
        devices = [getattr(w, "device", None) for w in self.workers]
        if any(d is None for d in devices):
            raise ici.IciPlaneError("a worker has no device")
        planned = ici.planned_enabled()
        dfs = hint = None
        if not planned:
            # YDB_TPU_DQ_PLANNED=0 comparison lane: the legacy exchange
            # routes pandas, so materialize each producer ONCE here and
            # overwrite the schema dtype hints with the exact pandas
            # dtypes
            dfs, hint = [], {}
            for i, b in enumerate(blocks):
                df = b.to_pandas()
                self.counters.inc("hostsync/to_pandas_in_plan")
                dts = {c: str(df[c].dtype) for c in df.columns}
                by_idx[i]["dtypes"] = dts
                hint.update(dts)
                dfs.append(df)
        agg = self._ici_stage_stats.setdefault(
            stage.id, {"ici_bytes": 0, "ici_frames": 0,
                       "quant_bytes_saved": 0,
                       "pad_live_bytes": 0, "pad_padded_bytes": 0,
                       "count_exchange_bytes": 0})
        kkinds = {}
        for ch in ici_chs:
            kkind = None
            for resp in by_idx.values():
                kkind = (resp.get("ici_key_kinds") or {}).get(ch.id) \
                    or kkind
            kkinds[ch.id] = kkind
        batched = None
        if planned and len(ici_chs) > 1:
            # a multi-edge stage computes ALL its sizing counts in one
            # launch and one readout (`dq/count_exchange_batched`)
            with self._span("ici-exchange-batched", stage=stage.id,
                            channels=len(ici_chs)):
                batched = ici.exchange_blocks_batched(
                    ici_chs, blocks,
                    key_kinds=[kkinds[ch.id] for ch in ici_chs],
                    counters=self.counters, devices=devices)
        for ci, ch in enumerate(ici_chs):
            kkind = kkinds[ch.id]
            with self._span("ici-exchange", channel=ch.id, kind=ch.kind):
                if batched is not None:
                    out_parts, stats = batched[ci]
                elif planned:
                    out_parts, stats = ici.exchange_blocks(
                        ch, blocks, key_kind=kkind,
                        counters=self.counters, devices=devices)
                else:
                    out_parts, stats = ici.exchange(
                        ch, dfs, key_kind=kkind, dtypes_hint=hint,
                        counters=self.counters, devices=devices)
            share = max(1, stats["ici_bytes"] // len(self.workers))
            for i, w in enumerate(self.workers):
                w.ici_land(ch.id, out_parts[i], share,
                           src=f"ici.{ch.id}", seq=i)
            self.counters.inc("dq/ici_bytes", stats["ici_bytes"])
            self.counters.inc("dq/ici_frames", stats["ici_frames"])
            if stats["quant_bytes_saved"] > 0:
                self.counters.inc("dq/quant_bytes_saved",
                                  stats["quant_bytes_saved"])
            for k in ("ici_bytes", "ici_frames", "quant_bytes_saved",
                      "pad_live_bytes", "pad_padded_bytes",
                      "count_exchange_bytes"):
                agg[k] += max(0, stats.get(k) or 0)
            # per-CHANNEL pad accounting row (worker='' marks it): the
            # exchange's padded/live is a per-edge property
            live = int(stats.get("pad_live_bytes") or 0)
            padded = int(stats.get("pad_padded_bytes") or 0)
            self.stage_stats.append(self._stage_row(
                graph, stage, "", "channel", 1, channel=ch.id,
                plane="ici", ici_bytes=int(stats["ici_bytes"]),
                seg=int(stats.get("seg") or 0),
                pad_live_bytes=live, pad_padded_bytes=padded,
                pad_efficiency=round(live / padded, 3) if padded
                else 0.0))

    def _run_stage_attempts(self, graph, stage, specs):
        """The pending → running → finished/failed attempt loop, the
        tasks of an attempt on a thread pool. Returns (results, tasks).
        The worker set is re-resolved per attempt: a transport-dead
        worker is skipped (a single-task stage reroutes onto a live one,
        counted `dq/retry_rerouted`). Every ATTEMPT of every task gets its
        own `dq-task` span in the router's tree (`attach_span`: the span
        lives on the trace-owning thread, pool threads stamp its
        duration and outcome), and a finished task's worker-recorded
        spans are ingested under it."""
        from concurrent.futures import ThreadPoolExecutor
        tracer = self.tracer
        # propagation context captured HERE, on the trace-owning thread
        # (the pool threads below have no thread-local trace open)
        base_ctx = tracer.current() if tracer is not None else None
        tasks: dict = {}
        prev_eps = None
        for attempt in range(self.stage_retries + 1):
            tws = self._task_workers(stage)
            eps = {w.endpoint for (_i, w) in tws}
            if (prev_eps is not None and eps - prev_eps) or \
                    (attempt == 0 and stage.on == "worker0"
                     and tws[0][0] != 0):
                # this attempt runs on workers the last one would not
                # have — the single-task stage rerouted off a dead worker
                self.counters.inc("dq/retry_rerouted",
                                  max(1, len(eps - (prev_eps or set()))))
            prev_eps = eps
            for (i, w) in tws:
                if i not in tasks:
                    tasks[i] = {"task": f"{graph.tag}.{stage.id}.w{i}",
                                "stage": stage.id, "worker": w.endpoint,
                                "state": "pending", "attempts": 0}
            task_spans = {}
            if tracer is not None:
                for (i, w) in tws:
                    task_spans[i] = tracer.attach_span(
                        "dq-task", task=tasks[i]["task"],
                        worker=w.endpoint, attempt=attempt + 1)

            clock_offsets: dict = {}     # widx -> (offset_ms, err_ms)

            def one(iw):
                i, w = iw
                t = tasks[i]
                t["state"] = "running"
                t["attempts"] = t.get("attempts", 0) + 1
                self.counters.inc("dq/tasks")
                sp = task_spans.get(i)
                t_send = tracer._now() if tracer is not None else None
                t0 = time.perf_counter()
                try:
                    # src is attempt-INDEPENDENT on purpose: the stage
                    # program is deterministic, so a first attempt still
                    # running beside the retry ships frames with the same
                    # (src, seq) identities and payloads — the receiver's
                    # dedup drops them instead of double-landing rows
                    resp = w.dq_run_task(
                        task_id=t["task"], stage=stage.id, sql=stage.sql,
                        outputs=specs, src=t["task"],
                        trace=self._trace_ctx(base_ctx, sp))
                    t["state"] = "finished"
                    clk = (resp.get("profile") or {}).get("clock")
                    if tracer is not None and clk is not None:
                        off, cerr = observe_clock(
                            w, t_send, tracer._now(),
                            float(clk["recv_ms"]), float(clk["send_ms"]))
                        clock_offsets[i] = (off, cerr)
                        if sp is not None:
                            sp.attrs["clock_offset_ms"] = round(off, 3)
                            sp.attrs["clock_err_ms"] = round(cerr, 3)
                    if sp is not None:
                        sp.dur_ms = (time.perf_counter() - t0) * 1000.0
                        sp.attrs["state"] = "finished"
                    return (i, resp, None)
                except Exception as e:       # noqa: BLE001 — per-task
                    t["state"] = "failed"
                    t["error"] = f"{type(e).__name__}: {e}"
                    if sp is not None:
                        sp.dur_ms = (time.perf_counter() - t0) * 1000.0
                        sp.attrs["state"] = "failed"
                        sp.attrs["error"] = f"{type(e).__name__}"
                    return (i, None, e)

            with ThreadPoolExecutor(max_workers=len(tws)) as pool:
                results = list(pool.map(one, tws))
            if tracer is not None:
                # worker-recorded spans join the tree under their
                # attempt's task span, rebased onto the router's clock
                for (i, resp, _e) in results:
                    spans = ((resp or {}).get("profile") or {}) \
                        .get("spans")
                    if spans:
                        sp = task_spans.get(i)
                        off = clock_offsets.get(i)
                        tracer.ingest(
                            spans, parent_id=sp.span_id
                            if sp is not None else None,
                            offset_ms=off[0] if off is not None
                            else None)
            failed = [(i, e) for (i, _r, e) in results if e is not None]
            if not failed:
                return results, tasks
            transport = [(i, e) for (i, e) in failed
                         if _is_transport_error(e)]
            for (i, _e) in transport:
                self.transport_failed.add(tasks[i]["worker"])
            if transport and stage.on != "worker0":
                # a per-shard stage lost a worker: its shard cannot
                # re-run elsewhere without re-placement — surface the
                # loss NOW instead of resending into the corpse
                names = ", ".join(f"{tasks[i]['worker']} "
                                  f"({tasks[i].get('error', '?')[:120]})"
                                  for (i, _e) in transport)
                raise DqWorkerLost(
                    f"stage {stage.id} failed after {attempt + 1} "
                    f"attempt(s) on: {names} — worker lost (transport); "
                    f"needs re-placement")
            # stage-level retry: drop the half-delivered output channels
            # everywhere reachable, then re-run every task of the stage
            if attempt < self.stage_retries:
                self.counters.inc("dq/tasks_retried", len(tws))
                self._drop_outputs(graph, stage)
                time.sleep(0.1)
                continue
            names = ", ".join(f"{tasks[i]['worker']} "
                              f"({tasks[i].get('error', '?')[:120]})"
                              for (i, _e) in failed)
            raise DqError(
                f"stage {stage.id} failed after "
                f"{self.stage_retries + 1} attempt(s) on: {names}")
        raise AssertionError("unreachable: the attempt loop returns on "
                             "success or raises on exhausted retries")

    def _stage_row(self, graph, stage, worker: str, state: str,
                   attempts: int, **stats) -> dict:
        """One stage-stats row — ONE literal for worker tasks, ICI
        channels and the router stage."""
        row = {"graph": graph.tag, "stage": stage.id, "worker": worker,
               "state": state, "attempts": int(attempts),
               "channel": "",
               "rows": 0, "bytes": 0, "frames": 0,
               "plane": "host", "ici_bytes": 0,
               "pad_live_bytes": 0, "pad_padded_bytes": 0,
               "pad_efficiency": 0.0,
               "exec_ms": 0.0, "flush_ms": 0.0,
               "input_wait_ms": 0.0, "backpressure_wait_ms": 0.0}
        row.update(stats)
        return row

    def _note_task_stats(self, graph, stage, task, resp, widx) -> None:
        """One stage-stats row per finished task."""
        prof = resp.get("profile") or {}
        chans = prof.get("channels") or []
        ici = self._ici_stage_stats.get(stage.id)
        nw = len(self.workers)
        self.stage_stats.append(self._stage_row(
            graph, stage, task["worker"], task["state"],
            task["attempts"],
            rows=int(resp.get("rows_in", 0)),
            bytes=int(resp.get("bytes_shipped", 0)),
            frames=int(resp.get("frames_shipped", 0)),
            plane="ici" if ici else
                  ("host" if stage.outputs else "-"),
            ici_bytes=int(ici["ici_bytes"] // nw) if ici else 0,
            pad_live_bytes=int(ici["pad_live_bytes"] // nw) if ici else 0,
            pad_padded_bytes=int(ici["pad_padded_bytes"] // nw)
            if ici else 0,
            pad_efficiency=round(ici["pad_live_bytes"]
                                 / ici["pad_padded_bytes"], 3)
            if ici and ici["pad_padded_bytes"] else 0.0,
            exec_ms=float(prof.get("exec_ms", 0.0)),
            flush_ms=float(prof.get("flush_ms", 0.0)),
            input_wait_ms=float(
                self._input_waits.get((stage.id, widx), 0.0)),
            backpressure_wait_ms=float(
                sum(c.get("backpressure_wait_ms", 0.0) for c in chans))))

    def _materialize_inputs(self, graph, stage) -> None:
        """Stage barrier, consumer side: every producer task finished (the
        runner only reaches this stage afterwards), so drain each input
        channel into its typed transient table on every task worker.
        Each open's {rows, bytes, wait_ms} reply accrues into the
        consuming task's stage-stats row and an `input-wait` span."""
        from concurrent.futures import ThreadPoolExecutor

        from ydb_tpu_torch.utils.metrics import GLOBAL_HIST
        for cid in stage.inputs:
            ch = graph.channels[cid]
            dtypes = self._dtypes.get(cid, {})
            cols = [(c, dtypes.get(c, "float64")) for c in ch.columns]
            tws = self._task_workers(stage)

            def open_one(iw, _ch=ch, _cols=cols):
                i, w = iw
                try:
                    return (i, w.endpoint,
                            w.channel_open(_ch.id, _ch.table,
                                           columns=_cols))
                except Exception as e:       # noqa: BLE001 — one surface:
                    # a worker lost at the barrier raises DqError so the
                    # router maps it to ClusterError like every other
                    # failure mode
                    msg = (f"channel {_ch.id} barrier failed on "
                           f"{w.endpoint}: {type(e).__name__}: "
                           f"{str(e)[:200]}")
                    if _is_transport_error(e):
                        self.transport_failed.add(w.endpoint)
                        raise DqWorkerLost(msg) from e
                    raise DqError(msg) from e
            with ThreadPoolExecutor(max_workers=len(tws)) as pool:
                opens = list(pool.map(open_one, tws))
            for (i, endpoint, resp) in opens:
                wait = float(resp.get("wait_ms", 0.0) or 0.0)
                key = (stage.id, i)
                self._input_waits[key] = self._input_waits.get(key, 0.0) \
                    + wait
                if wait:
                    GLOBAL_HIST.observe("dq/channel_wait_ms", wait)
                sp = self.tracer.attach_span(
                    "input-wait", channel=ch.id, worker=endpoint,
                    rows=int(resp.get("rows", 0)),
                    bytes=int(resp.get("bytes", 0))) \
                    if self.tracer is not None else None
                if sp is not None:
                    # the wait already HAPPENED — rewind start so the
                    # span occupies its true interval
                    sp.start_ms = round(sp.start_ms - wait, 3)
                    sp.dur_ms = wait

    def _drop_outputs(self, graph, stage) -> None:
        chans = list(stage.outputs)
        for cid in chans:
            self._collected.pop(cid, None)
        for w in self.workers:
            try:
                w.channel_close(channels=chans)
            except Exception:                # noqa: BLE001 — best effort
                pass

    @staticmethod
    def _collected_frame(resp):
        return resp.get("collected_df")

    # -- router (merge) stage ----------------------------------------------

    def _run_router_stage(self, graph, stage) -> pd.DataFrame:
        from ydb_tpu_torch.utils.metrics import GLOBAL_HIST
        t_stage = time.perf_counter()
        ok = False
        try:
            with self._span("dq-stage", stage=stage.id, on="router"):
                out = self._router_stage_body(graph, stage)
            ok = True
            return out
        finally:
            ms = (time.perf_counter() - t_stage) * 1000.0
            if ok:
                # success-only, like the worker stages above
                GLOBAL_HIST.observe("dq/stage_ms", ms)
            self.stage_stats.append(self._stage_row(
                graph, stage, "router",
                "finished" if ok else "failed", 1,
                plane="-",
                rows=sum(len(f) for got in
                         (self._collected.get(cid, {})
                          for cid in stage.inputs)
                         for f in got.values()),
                exec_ms=round(ms, 3)))

    def _router_stage_body(self, graph, stage) -> pd.DataFrame:
        from ydb_tpu_torch.query.window import apply_order_limit
        self.counters.inc("dq/stages")
        if getattr(stage, "groupby_merge", False):
            self.counters.inc("dq/merge_groupby_stages")
        frames = []
        for cid in stage.inputs:
            got = self._collected.get(cid, {})
            frames.extend(f for (_i, f) in sorted(got.items()))
        if not frames:
            raise DqError(f"router stage {stage.id} collected no frames")
        df = pd.concat(frames, ignore_index=True) if len(frames) > 1 \
            else frames[0].reset_index(drop=True)
        if stage.dedup_input:
            df = df.drop_duplicates(ignore_index=True)
        if stage.merge_sel is not None:
            return self._merge_over_temp(stage.merge_sel, df)
        if stage.post is not None:
            if stage.post.get("distinct"):
                # per-worker DISTINCT leaves cross-worker duplicates
                df = df.drop_duplicates(ignore_index=True)
            try:
                return apply_order_limit(df, stage.post.get("order") or [],
                                         stage.post.get("limit"),
                                         stage.post.get("offset"))
            except ValueError as e:
                raise DqError(str(e)) from e
        return df

    def _merge_over_temp(self, merge_sel: ast.Select,
                         df: pd.DataFrame) -> pd.DataFrame:
        from ydb_tpu_torch.core.block import HostBlock
        eng = self.engine
        temps: list = []
        try:
            tname = eng._register_temp(HostBlock.from_pandas(df), temps)
            final = dataclasses.replace(merge_sel,
                                        relation=ast.TableRef(tname))
            try:
                return eng.query(render.select(final))
            except Exception as e:           # noqa: BLE001 — one surface
                raise DqError(f"router merge stage failed: "
                              f"{type(e).__name__}: {e}") from e
        finally:
            for tn in temps:
                if eng.catalog.has(tn):
                    eng.catalog.drop_table(tn)

    # -- cleanup ------------------------------------------------------------

    def _cleanup(self, graph) -> None:
        tables = [ch.table for ch in graph.channels.values() if ch.table]
        chans = list(graph.channels)
        if not tables and not chans:
            return
        for w in self.workers:
            try:
                w.channel_close(tables=tables, channels=chans)
            except Exception:                # noqa: BLE001 — best effort
                pass


def frame_order(src: str, seq) -> tuple:
    """Where a landed frame goes in its channel's drain: by producer,
    numbers in its name compared as numbers (task `...w2` before
    `...w10`), then by the producer's frame sequence."""
    parts = re.split(r"(\d+)", src)
    return (tuple(int(t) if i % 2 else t for i, t in enumerate(parts)),
            -1 if seq is None else int(seq))


class OrderedExchangeBuffer(ExchangeBuffer):
    """An `ExchangeBuffer` whose channels drain by (producer, seq)
    (`frame_order`), not in the order their frames landed. Producer tasks
    run on the runner's thread pool and ship frames from a pool of their
    own, so the landing order changes from run to run; a consumer stage's
    float sum over the drained rows changed its last bits with it. The
    drain order is the ICI plane's, which lands producers' rows in worker
    order, so the two planes give the same bits."""

    def __init__(self, budget_bytes: int = 1 << 30):
        super().__init__(budget_bytes)
        # outside the base's lock, always taken before it
        self._order_mu = threading.Lock()
        self._order: dict = {}            # guarded-by: _order_mu

    def put(self, channel: str, df: pd.DataFrame, nbytes: int,
            src: str = "", seq=None) -> bool:
        with self._order_mu:
            landed = super().put(channel, df, nbytes, src=src, seq=seq)
            if landed:
                self._order.setdefault(channel, []).append(
                    frame_order(src, seq))
            return landed

    def take2(self, channel: str):
        with self._order_mu:
            keys = self._order.pop(channel, [])
            with self._mu:
                frames = self._frames.get(channel)
                if frames:
                    # stable: a producer's unsequenced frames keep their
                    # landing order
                    rank = sorted(range(len(frames)), key=keys.__getitem__)
                    frames[:] = [frames[i] for i in rank]
            return super().take2(channel)

    def drop(self, channel: str) -> None:
        with self._order_mu:
            self._order.pop(channel, None)
            super().drop(channel)


class LocalWorker:
    """In-process worker: the control surface the runner drives
    (execute / dq_run_task / ici_land / channel_open / channel_close /
    dq_tasks / counters) over a local QueryEngine, with an in-process
    exchange buffer that drains by producer and sequence
    (`OrderedExchangeBuffer`) — the 1-worker degenerate case, and
    N-engine single-process clusters. `device` is the engine's device:
    the ICI plane's exchange runs over the workers' devices."""

    def __init__(self, engine, name: str = ""):
        from ydb_tpu_torch.utils.metrics import Counters
        self.engine = engine
        self.endpoint = f"local:{name or hex(id(engine))[2:]}"
        self.exchange = OrderedExchangeBuffer()
        # device-resident channel landings (the planned ICI exchange):
        # channel → DeviceStageBlock, with the same (src, seq)
        # idempotency the frame path gets from ExchangeBuffer.put
        self._device_landed: dict = {}
        self._device_seen: set = set()
        self._peers = [self]
        # task table: mutated by the runner's pool threads while
        # dq_tasks() snapshots it
        self._tasks_mu = threading.Lock()
        self.tasks: dict = {}            # guarded-by: _tasks_mu
        # worker-side task counters go to a private sink: runner and
        # worker share GLOBAL in-process, so counting on both sides
        # would report 2x the real dq/tasks|frames|channel_bytes
        self.task_counters = Counters()

    @property
    def device(self):
        return getattr(self.engine, "device", None)

    def bind_peers(self, peers: list) -> None:
        self._peers = list(peers)

    # -- data plane ---------------------------------------------------------

    def _land(self, frame: bytes) -> None:
        from ydb_tpu_torch.cluster.exchange import unpack_frame
        header, df = unpack_frame(frame)
        self.exchange.put(header["channel"], df, len(frame),
                          src=header.get("src", ""),
                          seq=header.get("seq"))

    # -- worker surface -----------------------------------------------------

    def execute(self, sql: str) -> dict:
        from ydb_tpu_torch.server.service import _result_payload
        block = self.engine.execute(sql)
        return _result_payload(block, getattr(self.engine, "last_stats",
                                              None))

    def dq_run_task(self, task_id: str, stage: str, sql: str,
                    outputs: list, src: str, trace=None) -> dict:
        from ydb_tpu_torch.dq import task as dq_task
        with self._tasks_mu:
            rec = self.tasks.setdefault(task_id, {"stage": stage,
                                                  "attempts": 0})
            rec["state"] = "running"
            rec["attempts"] += 1
        try:
            resp = dq_task.run_task(
                self.engine, sql, outputs, src,
                send=lambda _o, p, frame: self._peers[p]._land(frame),
                counters=self.task_counters, trace=trace)
            with self._tasks_mu:
                rec["state"] = "finished"
            return resp
        except Exception as e:
            with self._tasks_mu:
                rec["state"], rec["error"] = "failed", str(e)
            raise

    def ici_land(self, channel: str, df, nbytes: int,
                 src: str = "ici", seq=None) -> None:
        """Land one ICI-exchanged partition — the device plane's
        replacement for a frame put (the same (src, seq) idempotency, no
        npz). A pandas frame (the legacy exchange) goes into the exchange
        buffer; a block (the planned exchange — a `DeviceStageBlock`
        still on the device) lands BY REFERENCE in the device store."""
        from ydb_tpu_torch.core.block import HostBlock
        if isinstance(df, HostBlock):
            key = (channel, src, seq)
            if seq is not None and key in self._device_seen:
                return
            self._device_seen.add(key)
            self._device_landed[channel] = df
            GLOBAL.inc("devlink/handoffs")
            return
        self.exchange.put(channel, df, int(nbytes), src=src, seq=seq)

    def channel_open(self, channel: str, table: str,
                     columns=None) -> dict:
        from ydb_tpu_torch.dq.task import (materialize_channel,
                                           materialize_device_channel)
        blk = self._device_landed.get(channel)
        if blk is not None:
            # kept (not popped) until channel_close: a consumer-stage
            # retry re-opens the channel and must find the landing again
            stats = materialize_device_channel(self.engine, blk, table)
        else:
            stats = materialize_channel(self.engine, self.exchange,
                                        channel, table, columns)
        return {"ok": True, **stats}

    def channel_close(self, tables=(), channels=()) -> dict:
        for name in tables:
            if self.engine.catalog.has(name) and \
                    getattr(self.engine.catalog.table(name), "transient",
                            False):
                self.engine.catalog.drop_table(name)
        for ch in channels:
            self.exchange.drop(ch)
            self._device_landed.pop(ch, None)
            self._device_seen = {k for k in self._device_seen
                                 if k[0] != ch}
        return {"ok": True}

    def dq_tasks(self) -> dict:
        """Task-table snapshot (per-record copies UNDER the lock, so a
        caller can't observe a record mid-mutation from a running task
        thread)."""
        with self._tasks_mu:
            return {k: dict(v) for k, v in self.tasks.items()}

    def counters(self) -> dict:
        return self.engine.counters()

    def health(self) -> dict:
        from ydb_tpu_torch.errors import NotPorted
        raise NotPorted("worker health (server/service.py health_snapshot, "
                        "ROADMAP Queue 1 item 8)")

    def hive_adopt_shard(self, root: str, tables=None) -> dict:
        from ydb_tpu_torch.errors import NotPorted
        raise NotPorted("Hive shard adoption (hive/adopt.py, ROADMAP "
                        "Queue 1 item 8)")

    def ping(self) -> bool:
        return True
