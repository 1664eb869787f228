"""Distributed-tracing spans (the Wilson analog).

The reference threads `NWilson::TTraceId` through actor events and wraps
phases in `TSpan`s uploaded via OTLP (`ydb/library/actors/wilson/
wilson_span.h`, `wilson_uploader.cpp`), with per-request sampling decided
at admission (`ydb/core/jaeger_tracing/`). Here the span tree covers a
statement's phases (parse → plan → execute, with executor sub-spans for
build/upload/dispatch/device-execute/readout), and the SAME tree spans
processes: a DQ task runner forwards `(trace_id, parent_span_id,
sampled)` over the `DqRunTask` RPC, workers record their task spans
against the adopted trace id, and the runner `ingest()`s them back —
one assembled cross-worker span tree per query. The engine keeps the
last trace and can publish finished traces into a topic (the
OTLP-uploader seat) so a consumer can drain them like any changefeed.

Sampling is decided ONCE at statement admission (`begin_trace(sampled=
False)`): an unsampled statement records nothing — `span()` hands back
throwaway contexts, so the hot path costs one TLS read and one object
allocation per phase, and the output is byte-identical to tracing off.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Optional

# span/trace ids draw from one per-process counter salted per process:
# two worker processes contributing spans to the same assembled trace
# must never collide on span_id (both counting from 1 guaranteed they
# would). Layout keeps ids under 2^63 — they land in int64 sysview
# columns: high 30 bits = full pid (Linux pid_max caps at 2^22) + 8
# random bits (pid-reuse across worker restarts), low 33 bits = counter.
# (no |1 inside the salt: forcing the low bit would alias adjacent
# even/odd pids; pid >= 1 already guarantees a nonzero salt)
_ids = itertools.count(
    (((int.from_bytes(os.urandom(1), "big") << 22)
      | (os.getpid() & 0x3FFFFF)) << 33) | 1)


@dataclass
class Span:
    name: str
    trace_id: int
    span_id: int
    parent_id: Optional[int]
    start_ms: float
    dur_ms: float = 0.0
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_ms": round(self.start_ms, 3),
                "dur_ms": round(self.dur_ms, 3), "attrs": self.attrs}


def span_from_dict(d: dict) -> Span:
    return Span(d.get("name", "?"), int(d.get("trace_id", 0)),
                int(d.get("span_id", 0)), d.get("parent_id"),
                float(d.get("start_ms", 0.0)),
                float(d.get("dur_ms", 0.0)), dict(d.get("attrs") or {}))


# span names the per-phase breakdown rolls up (utils/metrics.QueryStats
# `.phases`, the bench artifact, `.sys/query_profiles` columns): every
# device-timeline segment of a fused/batched/DQ execution
PHASE_SPANS = {
    "join-builds": "build_ms",
    "superblock-upload": "upload_ms",
    "device-dispatch": "dispatch_ms",
    "device-dispatch-batched": "dispatch_ms",
    "device-execute": "device_ms",
    "readout-transfer": "readout_ms",
}


def phase_breakdown(spans) -> dict:
    """Sum the device-timeline spans of one trace into a flat
    {phase: ms} dict. Compile happens INSIDE the first dispatch of a
    fresh shape (the dispatch span's dur contains it, stamped as the
    `compile_ms` attr), so it is pulled OUT of dispatch_ms here —
    the phases are disjoint and safe to sum. A compile-ahead build runs
    on the lane's worker thread CONCURRENTLY with planning: the span
    then carries `compile_wait_ms` (the portion of the build the
    dispatch actually blocked on), and only that much is pulled out —
    subtracting the full off-thread build would eat the real enqueue
    time the span also covers. A span timed on the card carries the
    card's own milliseconds as its `card_ms` attr, summed in place of
    its host time; they run beside the host's dispatch, so the card's
    `device_ms` does not add to the host's phases."""
    out: dict = {}
    in_dispatch = 0.0
    for s in spans:
        key = PHASE_SPANS.get(s.name)
        if key is not None:
            out[key] = out.get(key, 0.0) + s.attrs.get("card_ms", s.dur_ms)
        c = s.attrs.get("compile_ms")
        if c:
            out["compile_ms"] = out.get("compile_ms", 0.0) + float(c)
            w = s.attrs.get("compile_wait_ms")
            in_dispatch += float(c) if w is None else float(w)
    if in_dispatch and out.get("dispatch_ms"):
        out["dispatch_ms"] = max(0.0, out["dispatch_ms"] - in_dispatch)
    return {k: round(v, 3) for k, v in out.items()}


class Tracer:
    """Per-engine span recorder: a stack-scoped context-manager API.

    One trace per statement (`begin_trace`); `span(name)` nests under the
    innermost open span. Finished traces go to `sink` (a callable) when
    set — the engine wires this to a topic for export.

    Trace state is THREAD-LOCAL: concurrent sessions each build their own
    span tree (the reference threads TTraceId through per-request actor
    chains for the same reason)."""

    def __init__(self):
        import threading
        self._tls = threading.local()
        self._t0 = time.perf_counter()
        self.sink = None

    def _state(self):
        s = self._tls
        if not hasattr(s, "spans"):
            s.spans, s.stack, s.trace_id, s.depth = [], [], 0, 0
            s.sampled, s.root_parent = True, None
        return s

    @property
    def spans(self) -> list:
        return self._state().spans

    @property
    def _stack(self) -> list:
        return self._state().stack

    @property
    def _trace_id(self) -> int:
        return self._state().trace_id

    @property
    def sampled(self) -> bool:
        """Whether the CURRENT thread's open trace records spans."""
        s = self._state()
        return bool(s.sampled) if s.depth > 0 else False

    def _now(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0

    def begin_trace(self, sampled: bool = True, trace_id: int = None,
                    parent_id: int = None) -> int:
        """Open (or nest into) the thread's trace. `trace_id`/`parent_id`
        adopt a REMOTE context (a DQ worker joining the router's trace:
        its root spans parent under the router's task span); `sampled` is
        the admission-time decision — nested begin_trace calls (internal
        statements) inherit the outer decision."""
        s = self._state()
        s.depth += 1
        if s.depth == 1:
            s.trace_id = trace_id if trace_id is not None else next(_ids)
            s.spans = []
            s.stack = []
            s.sampled = bool(sampled)
            s.root_parent = parent_id
        return s.trace_id

    def current(self):
        """Propagation context of the thread's open trace:
        {trace_id, parent_span_id, sampled} — what rides the DqRunTask
        RPC and channel frame headers. None when no trace is open."""
        s = self._state()
        if s.depth == 0:
            return None
        return {"trace_id": s.trace_id,
                "parent_span_id": (s.stack[-1].span_id if s.stack
                                   else s.root_parent),
                "sampled": bool(s.sampled)}

    def span(self, name: str, **attrs):
        s = self._state()
        if s.depth > 0 and not s.sampled:
            return _NullSpanCtx()
        return _SpanCtx(self, name, attrs)

    def attach_span(self, name: str, parent_id: int = None,
                    **attrs) -> Optional[Span]:
        """Attach a span to the thread's open trace WITHOUT making it the
        innermost context — for spans whose lifetime is tracked from
        other threads (the DQ runner's per-attempt task spans run on a
        pool; the span object is allocated on the trace-owning thread,
        and the worker thread stamps `dur_ms`/attrs when done). Returns
        None when no sampled trace is open."""
        s = self._state()
        if s.depth == 0 or not s.sampled:
            return None
        if parent_id is None:
            parent_id = s.stack[-1].span_id if s.stack else s.root_parent
        sp = Span(name, s.trace_id, next(_ids), parent_id, self._now(),
                  attrs=dict(attrs))
        s.spans.append(sp)
        return sp

    def ingest(self, span_dicts, parent_id: int = None,
               offset_ms: float = None) -> list:
        """Merge REMOTE spans (worker `to_dict()` payloads shipped back
        in a task result) into the thread's open trace. Spans keep their
        ids and internal parent links; any whose parent is unknown in
        the combined batch re-roots under `parent_id` (default: the
        innermost open span), so a worker subtree hangs off the router's
        task span even if the worker recorded against a stale root.

        `offset_ms`: the measured LOCAL-minus-REMOTE clock offset for
        the batch's source (the DQ runner's RPC-boundary estimate,
        EWMA-smoothed per worker) — every ingested start_ms rebases by
        it, so spans from N workers land on ONE timebase (this tracer's)
        and cross-worker overlap/gaps are real. Without it the legacy
        parent-alignment fallback shifts the batch so its earliest span
        starts at the parent (honest ordering, no cross-worker
        comparability)."""
        s = self._state()
        if s.depth == 0 or not s.sampled or not span_dicts:
            return []
        if parent_id is None:
            parent_id = s.stack[-1].span_id if s.stack else s.root_parent
        known = {sp.span_id for sp in s.spans}
        batch = [span_from_dict(d) for d in span_dicts]
        if offset_ms is not None:
            # clock-aligned rebase: worker timestamps carry their own
            # tracer's epoch; adding the measured local-minus-remote
            # offset moves every one of them onto THIS tracer's clock
            for sp in batch:
                sp.start_ms = round(sp.start_ms + offset_ms, 3)
        else:
            # rebase the batch's epoch: worker start_ms is relative to
            # the WORKER tracer's process start — without shifting onto
            # the local epoch, a child could "start" hours before its
            # parent and timeline consumers of the profile would see
            # nonsense (only dur_ms is cross-process comparable;
            # relative offsets within the batch are preserved)
            parent_sp = next((sp for sp in s.spans
                              if sp.span_id == parent_id), None)
            if parent_sp is not None and batch:
                delta = parent_sp.start_ms - min(sp.start_ms
                                                 for sp in batch)
                for sp in batch:
                    sp.start_ms = round(sp.start_ms + delta, 3)
        known |= {sp.span_id for sp in batch}
        for sp in batch:
            sp.trace_id = s.trace_id
            if sp.parent_id is None or sp.parent_id not in known:
                sp.parent_id = parent_id
            s.spans.append(sp)
        return batch

    def end_trace(self) -> list[Span]:
        s = self._state()
        s.depth = max(0, s.depth - 1)
        if s.depth > 0:
            return s.spans
        # exception safety: a statement that raised past an open span
        # (or a code path that entered a span ctx it never exited) must
        # not leak stack state into the NEXT statement — force-close
        # whatever is still open, stamping elapsed-so-far
        while s.stack:
            sp = s.stack.pop()
            if sp.dur_ms == 0.0:
                sp.dur_ms = self._now() - sp.start_ms
        out = s.spans
        s.spans = []
        s.trace_id, s.root_parent, s.sampled = 0, None, True
        if self.sink is not None and out:
            try:
                self.sink([sp.to_dict() for sp in out])
            except Exception:                    # noqa: BLE001 — export
                pass                             # must never fail a query
        return out

    def render(self, spans=None) -> str:
        """Indented span tree (the EXPLAIN ANALYZE trace section).
        `spans`: render a finished trace (e.g. engine.last_trace) instead
        of the thread's in-flight one."""
        live = spans is None
        spans = self.spans if live else spans
        known = {s.span_id for s in spans}
        children: dict = {}
        roots = []
        for s in spans:
            if s.parent_id is None or s.parent_id not in known:
                roots.append(s)
            else:
                children.setdefault(s.parent_id, []).append(s)
        lines = []

        def walk(s: Span, depth: int):
            attrs = "".join(f" {k}={v}" for k, v in s.attrs.items())
            # still-open spans (EXPLAIN ANALYZE renders mid-statement)
            # show elapsed-so-far instead of a misleading 0.0
            dur = s.dur_ms if not (live and s in self._stack) \
                else self._now() - s.start_ms
            lines.append(f"{'  ' * depth}- {s.name}: "
                         f"{dur:.1f}ms{attrs}")
            for c in children.get(s.span_id, []):
                walk(c, depth + 1)
        for r in roots:
            walk(r, 0)
        return "\n".join(lines)


class _SpanCtx:
    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> Span:
        t = self.tracer
        st = t._state()
        parent = st.stack[-1].span_id if st.stack else st.root_parent
        self.s = Span(self.name, st.trace_id, next(_ids), parent,
                      t._now(), attrs=dict(self.attrs))
        st.spans.append(self.s)
        st.stack.append(self.s)
        return self.s

    def __exit__(self, exc_type, exc, _tb):
        self.s.dur_ms = self.tracer._now() - self.s.start_ms
        if exc_type is not None:
            self.s.attrs.setdefault("error", exc_type.__name__)
        stack = self.tracer._stack
        # remove THIS span wherever it sits: an inner span leaked open by
        # a raising code path must not make this pop corrupt the stack
        # for the rest of the statement. Leaked descendants removed here
        # still get their elapsed stamped — end_trace's force-close only
        # sees spans that are STILL on the stack.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self.s:
                for leaked in stack[i + 1:]:
                    if leaked.dur_ms == 0.0:
                        leaked.dur_ms = \
                            self.tracer._now() - leaked.start_ms
                del stack[i:]
                break
        return False


class _NullSpanCtx:
    """Unsampled statement: hand back a throwaway span so callers that
    set attrs on the yielded span keep working, record nothing."""

    __slots__ = ("s",)

    def __enter__(self) -> Span:
        self.s = Span("", 0, 0, None, 0.0)
        return self.s

    def __exit__(self, *exc):
        return False
