"""Worker↔worker data channels — the DQ output-channel analog.

The r4 cluster seam scattered SQL TEXT star-wise and merged in the
router; workers never exchanged data, so a join between two sharded
tables was impossible without replicating one side. This module is the
data plane the reference's DQ channels provide
(`ydb/library/yql/dq/runtime/dq_output_channel.cpp:31`, task graph
`dq_tasks_graph.h:43-165`): a *channel* is a named set of hash
partitions in flight between workers; a *frame* is one partition's rows
as an npz payload behind a JSON header, shipped over the workers' gRPC
front (DCN seam). Hash routing uses the shared splitmix64/crc32
definitions, so every producer routes a key to the same consumer
(`utils/hashing.py` — host and device agree bit-for-bit).

Frame wire format: 4-byte big-endian header length | header JSON
{channel, part, src, seq, n_rows} | npz bytes (one array per column;
object columns allow-pickle within the trusted cluster, the Interconnect
trust model).

The DQ runtime (`ydb_tpu/dq/`) adds two disciplines on top of the raw
frame plane:

  * idempotent delivery — every frame carries a (src, seq) pair unique
    within its channel; the receiving `ExchangeBuffer` drops duplicates,
    so a producer may RETRY a failed `ExchangePut` blindly (the reply
    may have been lost after the frame landed);
  * flow control — `ChannelWriter` splits a task's output into bounded
    frames and caps the bytes in flight per channel, so one fat shuffle
    cannot balloon sender memory or saturate a peer's buffer in one
    burst (the output-channel watermarks of `dq_output_channel.cpp`).
"""

from __future__ import annotations

import io
import json
import struct
import zlib

import numpy as np
import pandas as pd

from ydb_tpu_torch.utils.hashing import splitmix64


def hash_partition(df: pd.DataFrame, key: str, n_parts: int,
                   kind: str = None) -> list:
    """Split rows by key hash into n_parts frames (NULL keys drop — an
    inner-join shuffle never matches them).

    `kind` ("int" | "string" | None) is the TABLE SCHEMA's verdict on
    the key type, passed by the DQ task core (`ydb_tpu/dq/task.py
    run_task`) from the stage result's schema. Deciding from the pandas
    dtype alone (the r5 behavior) is
    wrong for nullable integer keys: `to_pandas` widens them to object
    dtype, so one producer hashed `str(7)` with crc32 while a NOT NULL
    producer hashed `7` with splitmix64 — the same key routed to two
    different consumers and sharded×sharded joins silently dropped
    matches. With kind="int", object-dtype values coerce to int64 and
    take the splitmix64 route every producer agrees on."""
    col = df[key]
    notna = col.notna()
    if not notna.all():
        df = df[notna]
        col = df[key]
    part = key_buckets(col.to_numpy(), n_parts, kind)
    return [df[part == p] for p in range(n_parts)]


def key_buckets(vals: np.ndarray, n_parts: int, kind: str = None
                ) -> np.ndarray:
    """Per-value consumer bucket for a NULL-free key array — the ONE
    routing function every channel plane shares. The host plane's
    `hash_partition` splits frames by it; the ICI plane
    (`ydb_tpu/dq/ici.py`) feeds the same buckets into the device
    all_to_all, so a key hashes to the same consumer no matter which
    plane its edge lowered to (and the two sides of a join agree even
    when their edges took different planes)."""
    if kind is None:                  # no schema available: dtype guess
        if vals.dtype == object or vals.dtype.kind in ("U", "S", "T"):
            kind = "string"
        elif vals.dtype.kind == "f":
            kind = "float"
        else:
            kind = "int"
    if kind == "float":
        raise ValueError("float join keys are not hash-partitionable "
                         "(equality on floats is ill-defined across the "
                         "wire)")
    if kind == "string":
        h = np.fromiter((zlib.crc32(str(v).encode()) for v in vals),
                        np.uint64, count=len(vals))
    else:
        # schema-int keys: nullable columns arrive as object (python
        # ints — exact, numpy raises on int64 overflow) or float64
        # (NaN-widened). Float widening is only exact up to 2^53: a
        # value that doesn't round-trip would hash differently than on
        # an int64-dtype producer — the exact misroute this path
        # exists to prevent — so refuse loudly instead
        arr = np.asarray(vals)
        if arr.dtype.kind == "f":
            # any |v| >= 2^53 may have COLLIDED during the int→float
            # widening (2^53 and 2^53+1 are the same float64) — the loss
            # happened upstream, so a round-trip check can't see it;
            # refuse by magnitude, plus round-trip for fractional values
            iv = arr.astype(np.int64)
            if (len(arr) and np.abs(arr).max() >= float(2**53)) \
                    or not np.array_equal(iv.astype(arr.dtype), arr):
                raise ValueError(
                    "int key column arrived float-widened with values "
                    "at or above 2^53 (or fractional) — not exactly "
                    "representable, cannot hash-partition consistently "
                    "across producers")
            arr = iv
        else:
            arr = arr.astype(np.int64)
        h = splitmix64(np, arr)
    return (h % np.uint64(n_parts)).astype(np.int64)


def pack_frame(header: dict, df: pd.DataFrame) -> bytes:
    buf = io.BytesIO()
    arrays = {}
    for c in df.columns:
        a = df[c].to_numpy()
        if a.dtype.kind in ("U", "S", "T"):
            a = a.astype(object)
        arrays[c] = a
    np.savez(buf, **arrays)
    header = dict(header, columns=list(df.columns), n_rows=len(df))
    hj = json.dumps(header).encode()
    return struct.pack("!I", len(hj)) + hj + buf.getvalue()


def unpack_header(data: bytes) -> dict:
    """Parse ONLY the JSON header — safe on untrusted bytes. Callers
    must authenticate against it BEFORE touching the npz payload
    (np.load with allow_pickle executes pickle payloads)."""
    (hlen,) = struct.unpack_from("!I", data, 0)
    return json.loads(data[4:4 + hlen].decode())


def unpack_frame(data: bytes):
    (hlen,) = struct.unpack_from("!I", data, 0)
    header = json.loads(data[4:4 + hlen].decode())
    z = np.load(io.BytesIO(data[4 + hlen:]), allow_pickle=True)
    cols = {c: z[c] for c in header["columns"]}
    df = pd.DataFrame(cols, columns=header["columns"])
    return header, df


class ExchangeBuffer:
    """Per-worker in-memory landing zone for incoming channel frames
    (the input-channel buffer of a DQ compute actor). Frames carrying a
    (src, seq) identity are deduplicated per channel, making a retried
    `ExchangePut` idempotent — the retry may race a first attempt whose
    reply was lost after the frame landed."""

    def __init__(self, budget_bytes: int = 1 << 30):
        import threading
        self._frames: dict = {}           # guarded-by: _mu
        self._seen: dict = {}             # guarded-by: _mu
        self.bytes = 0                    # guarded-by: _mu
        self.dup_frames = 0               # guarded-by: _mu
        self.budget = budget_bytes
        self._mu = threading.Lock()

    def put(self, channel: str, df: pd.DataFrame, nbytes: int,
            src: str = "", seq=None) -> bool:
        """Land one frame; returns False for a (src, seq) duplicate."""
        with self._mu:
            seen = None
            if seq is not None:
                seen = self._seen.setdefault(channel, set())
                if (src, seq) in seen:
                    self.dup_frames += 1
                    return False
            if self.bytes + nbytes > self.budget:
                # NOT marked seen: a budget-rejected frame never landed,
                # so the producer's retry must not dedup into a no-op
                raise MemoryError(
                    f"exchange buffer over budget "
                    f"({self.bytes + nbytes} > {self.budget})")
            if seen is not None:
                seen.add((src, seq))
            self._frames.setdefault(channel, []).append((df, nbytes))
            self.bytes += nbytes
            return True

    def take(self, channel: str) -> pd.DataFrame:
        """Drain and concatenate every frame of a channel."""
        df, _nb = self.take2(channel)
        return df

    def take2(self, channel: str):
        """`take` plus the drained byte count — the consumer-side channel
        stat (`dq_input_channel` bytes) the profile subsystem records."""
        with self._mu:
            frames = self._frames.pop(channel, [])
            self._seen.pop(channel, None)
            nbytes = sum(nb for (_f, nb) in frames)
            self.bytes -= nbytes
        if not frames:
            return pd.DataFrame(), 0
        return (pd.concat([f for (f, _nb) in frames], ignore_index=True),
                nbytes)

    def drop(self, channel: str) -> None:
        with self._mu:
            frames = self._frames.pop(channel, None)
            self._seen.pop(channel, None)
            if frames:
                self.bytes -= sum(nb for (_f, nb) in frames)


class ChannelWriter:
    """Producer side of one output channel: splits DataFrames into
    bounded frames, stamps each with (src, seq), and ships them with a
    cap on in-flight bytes plus per-frame retry (safe — the receiver
    dedups on (src, seq)).

    `send(peer_idx, frame_bytes)` is the transport (gRPC ExchangePut to
    a real peer, a direct buffer put for in-process workers)."""

    def __init__(self, channel: str, src: str, send, n_peers: int,
                 token: str = "", frame_rows: int = None,
                 inflight_bytes: int = None, retries: int = 2,
                 counters=None, trace=None):
        import itertools
        import os
        import threading
        from concurrent.futures import ThreadPoolExecutor
        self.channel = channel
        self.src = src
        self.token = token
        self._send = send
        self.frame_rows = frame_rows or int(os.environ.get(
            "YDB_TPU_DQ_FRAME_ROWS", 1 << 16))
        self.inflight_budget = inflight_bytes or int(os.environ.get(
            "YDB_TPU_DQ_INFLIGHT_BYTES", 32 << 20))
        self.retries = retries
        self._counters = counters
        # trace context carried in every frame header ({trace_id,
        # parent_span_id} — utils/tracing): a consumer-side debugger can
        # attribute any landed frame back to its query's span tree
        self._trace = {k: trace[k] for k in ("trace_id", "parent_span_id")
                       if trace and trace.get(k) is not None} \
            if trace else {}
        self._seq = itertools.count()
        self._inflight = 0
        self.peak_inflight = 0
        self.bytes_sent = 0
        self.frames_sent = 0
        self.rows_sent = 0
        self.wait_ms = 0.0               # backpressure: flow-control stalls
        self._cv = threading.Condition()
        self._pool = ThreadPoolExecutor(
            max_workers=min(8, max(2, n_peers)))
        self._futures: list = []

    def ship(self, peer: int, df: pd.DataFrame) -> None:
        """Queue one peer's partition, split into flow-controlled frames.
        An empty partition still ships one frame: the consumer learns the
        channel's columns even when it received no rows."""
        nrows = len(df)
        lo = 0
        while True:
            chunk = df.iloc[lo:lo + self.frame_rows]
            seq = next(self._seq)
            frame = pack_frame({"channel": self.channel, "part": peer,
                                "src": self.src, "seq": seq,
                                "token": self.token, **self._trace}, chunk)
            self._acquire(len(frame))
            self._futures.append(
                self._pool.submit(self._send_one, peer, frame))
            self.rows_sent += len(chunk)
            lo += self.frame_rows
            if lo >= nrows:
                break

    def _acquire(self, nbytes: int) -> None:
        import time
        with self._cv:
            # a frame larger than the whole budget still passes alone
            if self._inflight and \
                    self._inflight + nbytes > self.inflight_budget:
                t0 = time.perf_counter()
                while self._inflight and \
                        self._inflight + nbytes > self.inflight_budget:
                    self._cv.wait()
                self.wait_ms += (time.perf_counter() - t0) * 1000.0
            self._inflight += nbytes
            self.peak_inflight = max(self.peak_inflight, self._inflight)

    def stats(self) -> dict:
        """Per-channel producer stats (the dq_output_channel stats view):
        what run_task ships back for the cross-worker profile."""
        return {"channel": self.channel, "frames": self.frames_sent,
                "rows": self.rows_sent, "bytes": self.bytes_sent,
                "backpressure_wait_ms": round(self.wait_ms, 3)}

    def _send_one(self, peer: int, frame: bytes) -> None:
        import time
        try:
            last = None
            for attempt in range(self.retries + 1):
                try:
                    self._send(peer, frame)
                    break
                except Exception as e:       # noqa: BLE001 — retried
                    last = e
                    time.sleep(0.05 * (attempt + 1))
            else:
                raise last
            with self._cv:
                self.bytes_sent += len(frame)
                self.frames_sent += 1
        finally:
            with self._cv:
                self._inflight -= len(frame)
                self._cv.notify_all()

    def close(self) -> None:
        """Wait for every queued frame; raise the first transport error."""
        err = None
        for f in self._futures:
            try:
                f.result()
            except Exception as e:           # noqa: BLE001
                err = err or e
        self._pool.shutdown(wait=True)
        if self._counters is not None:
            self._counters.set_max("dq/channel_inflight_peak_bytes",
                                   self.peak_inflight)
        if err is not None:
            raise err
