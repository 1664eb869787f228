"""Query-scoped resource ledger — bytes for the profiler's milliseconds
(port of ``ydb_tpu/utils/memledger.py``).

  * **device-memory accounting** — every instrumented allocation on the
    execution spine (superblock upload, DeviceBlock upload, fused
    dispatch outputs, the batched lane's outputs) records its
    shape×dtype bytes into the statement's ledger, whose running total
    and peak become `QueryStats.memory` and the EXPLAIN ANALYZE
    `-- memory:` line, and the `mem/*` counters. The peak stays shape
    arithmetic, as in the reference, so both packages compare on the
    CPU; `device_memory_snapshot()` reads the card's own allocator
    (`torch.cuda.memory_stats`) beside it.
  * **padding-waste accounting** — every padded structure (power-of-two
    capacity buckets, the batched lane's member axis) reports
    `live_rows/padded_rows` and `live_bytes/padded_bytes`.
  * **host-transfer flight recorder** — every device→host readback
    site calls `record_transfer(site, nbytes)`, `boundary=True` at the
    client egress; counters `hostsync/*` and a ring of recent
    transfers.

`YDB_TPU_MEMLEDGER=0` disables every record call (results byte-equal —
the ledger only ever *observes*; nothing here touches device values or
forces a sync: a tensor's bytes are `numel() * element_size()`, shape
arithmetic).

Attribution is thread-local like the tracer: the engine (or the DQ
runner) opens one ledger per outermost statement on the executing
thread; nested statements (EXPLAIN ANALYZE's inner run, the DQ router
merge) contribute to the enclosing ledger.
"""

from __future__ import annotations

import os
import threading
from collections import deque

import torch

from ydb_tpu_torch.utils.metrics import GLOBAL, GLOBAL_HIST

_TLS = threading.local()

# flight recorder: last-N device→host transfers, process-wide (worker
# threads serving DQ tasks record here even when no statement ledger is
# open on their thread) — the `.sys/device_transfers` source
TRANSFER_RING_LEN = int(os.environ.get("YDB_TPU_TRANSFER_RING", "256"))
_RING: deque = deque(maxlen=TRANSFER_RING_LEN)   # guarded-by: _RING_MU
_RING_MU = threading.Lock()
_RING_SEQ = [0]                                  # guarded-by: _RING_MU


def enabled() -> bool:
    """`YDB_TPU_MEMLEDGER` lever: 0 = every record call is a no-op
    (byte-equal — the ledger never influences execution either way)."""
    return os.environ.get("YDB_TPU_MEMLEDGER", "1").strip() != "0"


class MemLedger:
    """One statement's resource account. Thread-safe increments (the
    batched lane and DQ exchanges may record from the owning thread
    while channel stats arrive from task callbacks)."""

    __slots__ = ("cur_bytes", "peak_bytes", "alloc_bytes", "freed_bytes",
                 "by_category", "pad_kinds", "transfers", "transfer_bytes",
                 "boundary_transfers", "to_pandas_in_plan", "sites",
                 "admission_est_bytes", "_mu")

    def __init__(self):
        self.cur_bytes = 0
        self.peak_bytes = 0
        self.alloc_bytes = 0
        self.freed_bytes = 0
        self.by_category: dict = {}
        # kind -> [live_rows, padded_rows, live_bytes, padded_bytes]
        self.pad_kinds: dict = {}
        self.transfers = 0
        self.transfer_bytes = 0
        self.boundary_transfers = 0
        self.to_pandas_in_plan = 0
        self.sites: dict = {}          # site -> [count, bytes]
        self.admission_est_bytes = None
        self._mu = threading.Lock()

    # -- recording ---------------------------------------------------------

    def alloc(self, category: str, nbytes: int) -> None:
        with self._mu:
            self.cur_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.cur_bytes)
            self.alloc_bytes += nbytes
            self.by_category[category] = \
                self.by_category.get(category, 0) + nbytes

    def free(self, category: str, nbytes: int) -> None:
        with self._mu:
            self.cur_bytes = max(0, self.cur_bytes - nbytes)
            self.freed_bytes += nbytes

    def pad(self, kind: str, live_rows: int, padded_rows: int,
            live_bytes: int, padded_bytes: int) -> None:
        with self._mu:
            acc = self.pad_kinds.setdefault(kind, [0, 0, 0, 0])
            acc[0] += live_rows
            acc[1] += padded_rows
            acc[2] += live_bytes
            acc[3] += padded_bytes

    def transfer(self, site: str, nbytes: int, count: int,
                 boundary: bool, to_pandas_in_plan: bool) -> None:
        with self._mu:
            self.transfers += count
            self.transfer_bytes += nbytes
            if boundary:
                self.boundary_transfers += count
            if to_pandas_in_plan:
                self.to_pandas_in_plan += count
            acc = self.sites.setdefault(site, [0, 0])
            acc[0] += count
            acc[1] += nbytes

    # -- rollup ------------------------------------------------------------

    def summary(self) -> dict:
        with self._mu:
            live = sum(a[2] for a in self.pad_kinds.values())
            padded = sum(a[3] for a in self.pad_kinds.values())
            est = self.admission_est_bytes
            err = None
            if est is not None and self.peak_bytes > 0:
                err = round(abs(est - self.peak_bytes)
                            / self.peak_bytes * 100.0, 1)
            return {
                "peak_bytes": int(self.peak_bytes),
                "alloc_bytes": int(self.alloc_bytes),
                "freed_bytes": int(self.freed_bytes),
                "by_category": dict(self.by_category),
                "pad": {k: {"live_rows": a[0], "padded_rows": a[1],
                            "live_bytes": a[2], "padded_bytes": a[3]}
                        for k, a in self.pad_kinds.items()},
                "live_bytes": int(live),
                "padded_bytes": int(padded),
                "waste_bytes": int(max(0, padded - live)),
                "pad_efficiency": round(live / padded, 3) if padded else
                None,
                "transfers": int(self.transfers),
                "transfer_bytes": int(self.transfer_bytes),
                "boundary_transfers": int(self.boundary_transfers),
                "to_pandas_in_plan": int(self.to_pandas_in_plan),
                "sites": {s: {"count": a[0], "bytes": a[1]}
                          for s, a in self.sites.items()},
                "admission_est_bytes": est,
                "est_error_pct": err,
            }


# -- the thread-local statement stack --------------------------------------


def current():
    """The ledger of the innermost open statement on this thread, or
    None (disabled, or no statement open — e.g. a DQ task pool
    thread)."""
    return getattr(_TLS, "ledger", None)


def open_statement():
    """Open a ledger for an outermost statement. Returns the NEW ledger
    when this call owns it (caller must `close_statement` it), or None
    when disabled or a statement is already open on this thread (the
    nested statement contributes to the enclosing ledger)."""
    if not enabled() or getattr(_TLS, "ledger", None) is not None:
        return None
    led = MemLedger()
    _TLS.ledger = led
    return led


def close_statement(led) -> None:
    """Close an owned ledger: pop it and roll its totals into the
    global counter families (`mem/*` peaks + the peak-HBM histogram,
    the admission-calibration histogram)."""
    if getattr(_TLS, "ledger", None) is led:
        _TLS.ledger = None
    GLOBAL.inc("mem/ledgers")
    if led.peak_bytes > 0:
        GLOBAL.set_max("mem/peak_bytes", led.peak_bytes)
        GLOBAL_HIST.observe("mem/peak_mb", led.peak_bytes / (1 << 20))
    est = led.admission_est_bytes
    if est is not None and led.peak_bytes > 0:
        GLOBAL.inc("admission/calibrated")
        GLOBAL_HIST.observe(
            "admission/est_error_pct",
            abs(est - led.peak_bytes) / led.peak_bytes * 100.0)


def note_admission(est_bytes: int) -> None:
    """Stamp the admission reservation estimate onto the open ledger —
    the `estimate vs measured peak` calibration input."""
    led = current()
    if led is not None and led.admission_est_bytes is None:
        led.admission_est_bytes = int(est_bytes)


# -- module-level record API (cheap no-ops when disabled) ------------------


def record_alloc(category: str, nbytes: int) -> None:
    led = current()
    if led is None:
        return
    nbytes = int(nbytes)
    led.alloc(category, nbytes)
    GLOBAL.inc("mem/alloc_bytes", nbytes)


def record_free(category: str, nbytes: int) -> None:
    led = current()
    if led is None:
        return
    nbytes = int(nbytes)
    led.free(category, nbytes)
    GLOBAL.inc("mem/freed_bytes", nbytes)


def record_pad(kind: str, live_rows: int, padded_rows: int,
               live_bytes: int, padded_bytes: int) -> None:
    """One padded structure's live-vs-padded account. Counted globally
    even without an open ledger (DQ task pool threads report the
    padding their stage buffers carry)."""
    if not enabled():
        return
    live_bytes, padded_bytes = int(live_bytes), int(padded_bytes)
    GLOBAL.inc("pad/live_bytes", live_bytes)
    GLOBAL.inc("pad/padded_bytes", padded_bytes)
    GLOBAL.inc("pad/waste_bytes", max(0, padded_bytes - live_bytes))
    led = current()
    if led is not None:
        led.pad(kind, int(live_rows), int(padded_rows), live_bytes,
                padded_bytes)


def record_transfer(site: str, nbytes: int, count: int = 1,
                    boundary: bool = False,
                    to_pandas_in_plan: bool = False) -> None:
    """Flight-record one device→host readback. `boundary`: the site is
    an excused client/upload boundary; everything else is
    plan-interior debt."""
    if not enabled():
        return
    nbytes, count = int(nbytes), int(count)
    GLOBAL.inc("hostsync/transfers", count)
    GLOBAL.inc("hostsync/bytes", nbytes)
    if boundary:
        GLOBAL.inc("hostsync/boundary_transfers", count)
    if to_pandas_in_plan:
        GLOBAL.inc("hostsync/to_pandas_in_plan", count)
    with _RING_MU:
        _RING_SEQ[0] += 1
        _RING.append({"seq": _RING_SEQ[0], "site": site,
                      "bytes": nbytes, "count": count,
                      "boundary": bool(boundary),
                      "to_pandas_in_plan": bool(to_pandas_in_plan)})
    led = current()
    if led is not None:
        led.transfer(site, nbytes, count, boundary, to_pandas_in_plan)


def record_device_handoff(site: str, nbytes: int, count: int = 1) -> None:
    """Flight-record one device→device stage handoff (the stage spine's
    block-by-reference seam: fused capture, planned-exchange landing,
    channel-table device write). These are NOT host transfers — the
    bytes never cross the link — so they count under `devlink/*`, ride
    the same ring for `.sys/device_transfers` visibility (tagged
    `device_to_device`), and leave every `hostsync/*` counter flat. The
    classification is the regression surface: a handoff site that
    mistakenly calls `record_transfer` would count a host transfer
    that never happened."""
    if not enabled():
        return
    nbytes, count = int(nbytes), int(count)
    GLOBAL.inc("devlink/handoffs", count)
    GLOBAL.inc("devlink/bytes", nbytes)
    with _RING_MU:
        _RING_SEQ[0] += 1
        _RING.append({"seq": _RING_SEQ[0], "site": site,
                      "bytes": nbytes, "count": count,
                      "boundary": False, "to_pandas_in_plan": False,
                      "device_to_device": True})


def transfer_ring() -> list:
    """Snapshot of the recent-transfer ring (newest last) — the
    `.sys/device_transfers` payload."""
    with _RING_MU:
        return [dict(r) for r in _RING]


# -- byte helpers (shape arithmetic only — never a device sync) ------------


def deep_nbytes(obj) -> int:
    """Sum the bytes of a structure of tensors or arrays (dict / list /
    tuple / tensor / array / None): `numel() * element_size()` for a
    tensor, `.nbytes` for a numpy array — shape arithmetic, never a
    transfer."""
    if obj is None:
        return 0
    if isinstance(obj, torch.Tensor):
        return int(obj.numel() * obj.element_size())
    nb = getattr(obj, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(obj, dict):
        return sum(deep_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(deep_nbytes(v) for v in obj)
    return 0


def record_padded_buffers(kind: str, category: str, live_rows: int,
                          padded_rows: int, *buffer_trees) -> None:
    """Combined alloc + pad record for a padded device buffer set: the
    buffers' full (padded) bytes are allocated to `category`, and the
    live share is prorated by row count."""
    if not enabled() or padded_rows <= 0:
        return
    padded_bytes = sum(deep_nbytes(t) for t in buffer_trees)
    if padded_bytes <= 0:
        return
    live_bytes = int(padded_bytes * min(live_rows, padded_rows)
                     / padded_rows)
    record_alloc(category, padded_bytes)
    record_pad(kind, live_rows, padded_rows, live_bytes, padded_bytes)


def device_memory_snapshot(device) -> dict:
    """The card's own allocator counters for `device`
    (`torch.cuda.memory_stats`): bytes in use and their peak since the
    last `torch.cuda.reset_peak_memory_stats`; {} for a CPU device. The
    shape-arithmetic ledger never depends on this; it is what the
    ledger's peak is held against."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    ms = torch.cuda.memory_stats(device)
    return {str(device): {
        "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
    }}
