"""Critical-path extraction over assembled span trees — *which chain of
work actually bounds this query's wall clock*.

The tracer gives every query an assembled cross-worker span tree and the
resource ledger gives it bytes; both stop at *attribution* (how much
time/bytes each phase consumed, summed). This module answers the
scheduling question instead: starting from the query's end, walk
backwards through the span DAG (parent/child nesting plus channel
send→recv edges, with clock-rebased cross-worker timestamps —
`Tracer.ingest(offset_ms=...)`) and keep only the chain of segments that
was actually *blocking* at each instant. A channel wait fully hidden
under a longer device execution never appears; two parallel stages
contribute only the longer one; a failed task attempt (state=failed) is
excluded outright — its retry is the blocking chain.

Every critical-path segment is classified into one of `CLASSES`:

  device_execute  on-chip program execution (incl. dispatch enqueue)
  compile         K1's NVRTC builds inside a dispatch (split out of
                  dispatch spans by their `compile_ms` attr)
  host_transfer   D2H/H2D movement (upload, readout, future drain)
  host_lane       host-side CPU work (parse/plan/builds/pandas lanes —
                  the q13 class)
  channel_wait    DQ channel production/drain + ICI exchanges
  admission_wait  queueing behind the memory-admission budget
  scheduler_gap   structural self-time nothing below accounts for

and the per-class milliseconds become EXPLAIN ANALYZE `-- critical
path:` lines, `QueryStats.critical_path`, the `.sys/query_critical_path`
ring and the `crit/*` counters — a machine-generated worklist of the
non-device time. `YDB_TPU_CRITPATH=0` disables extraction
and export entirely (byte-equal results, counters frozen), matching the
MEMLEDGER / TRACE_SAMPLE lever convention.
"""

from __future__ import annotations

import os

from ydb_tpu_torch.utils.tracing import Span, span_from_dict

CLASSES = ("device_execute", "compile", "host_transfer", "host_lane",
           "channel_wait", "admission_wait", "scheduler_gap")

# leaf-span classification; spans not listed here fall back by shape:
# STRUCTURAL self-time is a scheduler gap, any other unknown leaf is
# host work (conservative: unclassified time must not masquerade as
# device time — the whole point is ranking the NON-device share)
CLASS_BY_NAME = {
    "device-execute": "device_execute",
    "tiled-scan": "device_execute",
    "shuffle-join": "device_execute",
    "spill-merge": "device_execute",
    "compile": "compile",
    "superblock-upload": "host_transfer",
    "readout-transfer": "host_transfer",
    # the engine's drain phase: on the fused path its device-execute /
    # readout-transfer children carry the time (self ~0); on the
    # portioned path the self-time IS the host-driven per-portion
    # streaming loop — host work, not transfer
    "readout": "host_lane",
    "parse": "host_lane",
    "plan": "host_lane",
    "join-builds": "host_lane",
    "task-exec": "host_lane",
    "window-device": "device_execute",
    "window-host-lane": "host_lane",
    "setop-host-lane": "host_lane",
    "input-wait": "channel_wait",
    "output-flush": "channel_wait",
    "ici-exchange": "channel_wait",
    "admission-wait": "admission_wait",
}

# spans whose self-time is pure orchestration/waiting (their children
# are the work): gaps on the critical path inside these classify
# scheduler_gap. Engine-side spans (statement/execute/fused-attempt)
# are NOT here: their self-time is real host CPU work — binder, temp
# materialization, pandas conversions — i.e. the q13 host-lane class,
# and it must rank as host_lane, not hide as a gap.
STRUCTURAL = {"dq-query", "dq-stage", "dq-task", "query"}

# dispatch spans absorb K1's NVRTC builds; the `compile_ms`
# attr marks how much of the span's front is compile, split out below
_DISPATCH = ("device-dispatch", "device-dispatch-batched")

_EPS = 5e-4          # ms — timestamps round to 3 decimals


def enabled() -> bool:
    """`YDB_TPU_CRITPATH` lever: 0 = extraction and export disabled
    (results byte-equal; `crit/*` counters frozen)."""
    return os.environ.get("YDB_TPU_CRITPATH", "1").strip() != "0"


def _as_spans(spans) -> list:
    return [span_from_dict(s) if isinstance(s, dict) else s
            for s in (spans or [])]


def _drop_failed_subtrees(spans: list) -> list:
    """A failed task attempt must not extend the path — its *retry* is
    the blocking chain. Remove every span whose `state` attr is
    `failed`, plus all descendants."""
    failed = {s.span_id for s in spans
              if s.attrs.get("state") == "failed"}
    if not failed:
        return spans
    by_parent: dict = {}
    for s in spans:
        by_parent.setdefault(s.parent_id, []).append(s)
    frontier = list(failed)
    while frontier:
        pid = frontier.pop()
        for c in by_parent.get(pid, ()):
            if c.span_id not in failed:
                failed.add(c.span_id)
                frontier.append(c.span_id)
    return [s for s in spans if s.span_id not in failed]


def _classify(span: Span) -> str:
    cls = CLASS_BY_NAME.get(span.name)
    if cls is not None:
        return cls
    if span.name in _DISPATCH:
        return "device_execute"
    if span.name in STRUCTURAL:
        return "scheduler_gap"
    return "host_lane"


def lane_of(span: Span, by_id: dict, memo: dict) -> str:
    """Worker lane: the `worker` attr of the nearest enclosing dq-task
    span, else 'router' — the ONE lane-resolution rule, shared with the
    timeline exporter (`utils/chrometrace.py`) so Perfetto tracks and
    critical-path segment workers can never disagree."""
    sid = span.span_id
    got = memo.get(sid)
    if got is not None:
        return got
    if span.name == "dq-task" and span.attrs.get("worker"):
        lane = str(span.attrs["worker"])
    else:
        p = by_id.get(span.parent_id)
        lane = lane_of(p, by_id, memo) if p is not None else "router"
    memo[sid] = lane
    return lane


def _pieces(span: Span, a: float, b: float) -> list:
    """Class pieces of the self-time interval [a, b] of `span`. A
    dispatch span's `compile_ms` front is split out as `compile`."""
    if span.name in _DISPATCH:
        c = float(span.attrs.get("compile_ms") or 0.0)
        if c > _EPS:
            cut = min(span.start_ms + c, b)
            out = []
            if cut - a > _EPS:
                out.append(("compile", a, min(cut, b)))
            if b - cut > _EPS:
                out.append(("device_execute", max(cut, a), b))
            return out or [("device_execute", a, b)]
    return [(_classify(span), a, b)]


def extract(spans, memory: dict = None) -> dict:
    """Extract the critical path of one assembled trace.

    `spans`: Span objects or their `to_dict()` payloads — the full tree
    (a statement window without its root also works; a virtual root is
    synthesized over the forest). `memory`: the statement's closed
    MemLedger summary — its transfer/padding bytes ride along so
    padded bytes on the critical path are costed next to the
    milliseconds.

    Returns {classes, pct, segments, wall_ms, total_ms, coverage,
    connected, non_device_ms, dominant_*, top_spans, memory} — segments
    chronological, each labeled with one of `CLASSES`."""
    spans = _drop_failed_subtrees(_as_spans(spans))
    spans = [s for s in spans if s.dur_ms >= 0.0]
    if not spans:
        return {"classes": {}, "pct": {}, "segments": [],
                "wall_ms": 0.0, "total_ms": 0.0, "coverage": 0.0,
                "connected": True, "non_device_ms": 0.0,
                "dominant_span": "", "dominant_class": "",
                "dominant_ms": 0.0, "top_spans": {},
                "memory": _memory_join(memory)}
    by_id = {s.span_id: s for s in spans}
    t_lo = min(s.start_ms for s in spans)
    t_hi = max(s.start_ms + s.dur_ms for s in spans)
    # virtual root over the forest: a statement window (no root span)
    # and a full tree (one root) walk the same code path, and any gap
    # between top-level spans becomes honest scheduler_gap self-time
    root = Span("query", spans[0].trace_id, -1, None, t_lo,
                max(0.0, t_hi - t_lo))
    children: dict = {-1: []}
    for s in spans:
        pid = s.parent_id if s.parent_id in by_id else -1
        children.setdefault(pid, []).append(s)
        children.setdefault(s.span_id, [])
    by_id[-1] = root
    lane_memo: dict = {-1: "router"}

    def end_of(s: Span) -> float:
        return s.start_ms + s.dur_ms

    segments: list = []

    def emit(span: Span, a: float, b: float) -> None:
        if b - a <= _EPS:
            return
        for (cls, pa, pb) in _pieces(span, a, b):
            segments.append({
                "span": span.name, "span_id": span.span_id,
                "class": cls,
                "worker": lane_of(span, by_id, lane_memo),
                "start_ms": round(pa, 3), "end_ms": round(pb, 3),
                "ms": round(pb - pa, 3)})

    def walk(span: Span, hi: float, lo: float = None) -> None:
        # `lo` clamps this subtree into its ancestors' window: a clock-
        # rebased child may nominally start a hair before its parent,
        # and letting it cover time the grandparent also fills would
        # double-count (overlapping, "disconnected-looking" segments)
        lo = span.start_ms if lo is None else max(span.start_ms, lo)
        t = hi
        kids = children.get(span.span_id, ())
        while t - lo > _EPS:
            best = None
            for c in kids:
                ce = end_of(c)
                # the blocking child at instant t: finished by t, not
                # already fully before the window floor, and actually
                # OCCUPYING time strictly below t — zero-duration spans
                # (rounded-away sub-µs work, 0ms input-waits) and spans
                # starting at t cannot be blocking, and skipping them
                # guarantees every iteration moves t strictly down
                # (choosing one would leave t unchanged and spin this
                # loop forever)
                if ce <= t + _EPS and ce - lo > _EPS \
                        and ce - c.start_ms > _EPS \
                        and c.start_ms < t - _EPS:
                    if best is None or ce > end_of(best):
                        best = c
            if best is None:
                emit(span, lo, t)
                return
            ce = min(end_of(best), t)
            if t - ce > _EPS:
                emit(span, ce, t)          # parent self-time gap
            walk(best, ce, lo)
            t = min(t, max(best.start_ms, lo))

    walk(root, end_of(root))
    # the walk runs backwards in time (and a split dispatch emits its
    # pieces forwards): chronological order by sort, not reversal
    segments.sort(key=lambda s: (s["start_ms"], s["end_ms"]))

    classes: dict = {}
    top_spans: dict = {}
    for seg in segments:
        classes[seg["class"]] = classes.get(seg["class"], 0.0) + seg["ms"]
        if seg["span"] != "query":
            top_spans[seg["span"]] = \
                top_spans.get(seg["span"], 0.0) + seg["ms"]
    classes = {k: round(v, 3) for k, v in classes.items()}
    total = round(sum(classes.values()), 3)
    wall = round(max(0.0, t_hi - t_lo), 3)
    connected = all(
        segments[i + 1]["start_ms"] - segments[i]["end_ms"] <= 0.01
        for i in range(len(segments) - 1))
    dom = max((s for s in segments if s["class"] != "scheduler_gap"),
              key=lambda s: s["ms"], default=None)
    # compile is host-side work: it counts as non-device time (the gap
    # classes a 10× target has to eliminate), so only device_execute
    # subtracts
    non_device = round(total - classes.get("device_execute", 0.0), 3)
    return {
        "classes": classes,
        "pct": {k: round(100.0 * v / wall, 1) if wall else 0.0
                for k, v in classes.items()},
        "segments": segments,
        "wall_ms": wall,
        "total_ms": total,
        "coverage": round(total / wall, 4) if wall else 0.0,
        "connected": connected,
        "non_device_ms": max(0.0, non_device),
        "dominant_span": dom["span"] if dom else "",
        "dominant_class": dom["class"] if dom else "",
        "dominant_ms": round(top_spans.get(dom["span"], 0.0), 3)
        if dom else 0.0,
        "top_spans": {k: round(v, 3) for k, v in sorted(
            top_spans.items(), key=lambda kv: -kv[1])},
        "memory": _memory_join(memory),
    }


def _memory_join(memory) -> dict:
    """The ledger's byte companions of the critical-path milliseconds:
    host-transfer traffic and the padding tax of the same statement."""
    if not memory:
        return {}
    return {
        "transfer_bytes": int(memory.get("transfer_bytes", 0)),
        "transfers": int(memory.get("transfers", 0)),
        "waste_bytes": int(memory.get("waste_bytes", 0)),
        "pad_efficiency": memory.get("pad_efficiency"),
        "to_pandas_in_plan": int(memory.get("to_pandas_in_plan", 0)),
    }


def summarize(cp: dict) -> dict:
    """The compact per-statement form (`QueryStats.critical_path`,
    bench records): everything except the segment list."""
    return {k: v for k, v in cp.items() if k != "segments"}


def record_counters(cp: dict) -> None:
    """Roll one extraction into the `crit/*` counter families. Guarded
    by the caller on `enabled()` — with the lever off these counters
    stay frozen (the differential test pins that)."""
    from ydb_tpu_torch.utils.metrics import GLOBAL, GLOBAL_HIST
    GLOBAL.inc("crit/extractions")
    if not cp["connected"]:
        GLOBAL.inc("crit/disconnected")
    GLOBAL.inc("crit/non_device_ms", cp["non_device_ms"])
    for cls, ms in cp["classes"].items():
        GLOBAL.inc(f"crit/{cls}_ms", ms)
    GLOBAL_HIST.observe("crit/coverage_pct", 100.0 * cp["coverage"])


def render_lines(cp: dict) -> list:
    """The EXPLAIN ANALYZE `-- critical path:` lines: per-class % of
    wall, then the dominant span."""
    if not cp or not cp.get("classes"):
        return []
    parts = " | ".join(
        f"{cls} {cp['pct'].get(cls, 0.0):.1f}%"
        for cls in CLASSES if cls in cp["classes"])
    lines = [f"-- critical path: {parts}"]
    lines.append(
        f"-- critical path: coverage {100.0 * cp['coverage']:.1f}% of "
        f"{cp['wall_ms']:.1f}ms wall"
        + ("" if cp["connected"] else " [DISCONNECTED]")
        + (f" | dominant {cp['dominant_span']} "
           f"({cp['dominant_class']}, {cp['dominant_ms']:.1f}ms)"
           if cp.get("dominant_span") else ""))
    mem = cp.get("memory") or {}
    if mem.get("transfer_bytes") or mem.get("waste_bytes"):
        lines.append(
            f"-- critical path: host transfers "
            f"{mem.get('transfer_bytes', 0) / (1 << 20):.2f}MB"
            + (f" | padded waste "
               f"{mem.get('waste_bytes', 0) / (1 << 20):.2f}MB "
               f"(pad eff {mem['pad_efficiency']:.2f})"
               if mem.get("pad_efficiency") is not None else ""))
    return lines
