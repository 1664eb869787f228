"""Device-resident blocks (port of ``ydb_tpu/ops/device.py``).

A ``DeviceBlock`` keeps a block's columns as torch tensors on one device
between operators. Host round-trips happen only at result egress, and
there as ONE device→host copy per result: every column (and the length)
is packed into a single byte buffer on the device, copied once, and
split back into numpy arrays on the host (`batched_to_host`). A
``DeviceStageBlock`` carries a DQ stage's result to the next stage
without that copy."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ydb_tpu_torch.core.block import ColumnData, HostBlock
from ydb_tpu_torch.core.schema import Schema
from ydb_tpu_torch.ops.torch_ns import to_tensor


def bucket_capacity(n: int, minimum: int = 8192) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclass
class DeviceBlock:
    schema: Schema
    arrays: dict                      # name -> tensor (len = capacity)
    valids: dict                      # name -> bool tensor (subset of names)
    length: object                    # 0-d int32 tensor or int
    capacity: int
    dictionaries: dict = field(default_factory=dict)  # name -> Dictionary


def to_device(block: HostBlock, device, capacity: Optional[int] = None
              ) -> DeviceBlock:
    """Upload a host block padded to a capacity bucket."""
    cap = capacity or bucket_capacity(max(block.length, 1))
    arrays, valids, dicts = {}, {}, {}
    pad = cap - block.length
    for c in block.schema:
        cd = block.columns[c.name]
        data = np.pad(cd.data, (0, pad)) if pad else cd.data
        arrays[c.name] = to_tensor(data, device)
        if cd.valid is not None:
            v = np.pad(cd.valid, (0, pad)) if pad else cd.valid
            valids[c.name] = to_tensor(v, device)
        if cd.dictionary is not None:
            dicts[c.name] = cd.dictionary
    length = torch.tensor(block.length, dtype=torch.int32, device=device)
    return DeviceBlock(block.schema, arrays, valids, length, cap, dicts)


def batched_to_host(tensors: list) -> list:
    """Copy `tensors` (any dtypes, one device) to host numpy arrays with
    ONE device→host transfer: the bytes are packed into one buffer on
    the device first."""
    if not tensors:
        return []
    flat = [t.contiguous().reshape(-1) for t in tensors]
    packed = torch.cat([f.view(torch.uint8) if f.dtype != torch.bool
                        else f.to(torch.uint8) for f in flat])
    host = packed.cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        nbytes = f.numel() * f.element_size()
        chunk = host[off:off + nbytes]
        off += nbytes
        if f.dtype == torch.bool:
            arr = chunk.astype(np.bool_)
        else:
            arr = chunk.view(_NUMPY_OF[f.dtype])
        out.append(arr.reshape(tuple(t.shape)))
    return out


_NUMPY_OF = {
    torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
    torch.int64: np.int64, torch.uint8: np.uint8,
    torch.float32: np.float32, torch.float64: np.float64,
}


def host_column(data, valid, dtype, dictionary) -> ColumnData:
    """Host materialization convention shared by every device→host path
    (`to_host`, the fused unpack): restore the schema dtype (unsigned
    columns arrive as their int64 bit patterns), collapse all-valid
    masks to None, reattach the dictionary."""
    d = np.asarray(data)
    want = np.dtype(dtype.np)
    if want == np.uint64 and d.dtype == np.int64:
        d = d.view(np.uint64)
    d = d.astype(want)
    v = valid
    if v is not None:
        v = np.asarray(v)
        if v.all():
            v = None
    return ColumnData(d, v, dictionary)


def to_host(dblock: DeviceBlock) -> HostBlock:
    n = int(dblock.length)
    names = [c.name for c in dblock.schema]
    vnames = [nm for nm in names if nm in dblock.valids]
    host = batched_to_host([dblock.arrays[nm][:n] for nm in names]
                           + [dblock.valids[nm][:n] for nm in vnames])
    host_a = dict(zip(names, host[:len(names)]))
    host_v = dict(zip(vnames, host[len(names):]))
    cols = {}
    for c in dblock.schema:
        cols[c.name] = host_column(host_a[c.name], host_v.get(c.name),
                                   c.dtype, dblock.dictionaries.get(c.name))
    return HostBlock(dblock.schema, cols, n)


class DeviceStageBlock(HostBlock):
    """A stage-boundary block whose columns still live on the device: the
    DQ stage spine's unit of flow between stages.

    It is a ``HostBlock`` to every consumer that reads only ``schema`` or
    ``length`` or calls the block protocol, but ``columns`` is a lazy
    property that reads the columns back ONCE (one `to_host`) the first
    time a host-only path touches it. Stage plumbing that stays on the
    device (the planned ICI exchange, the device landing in the channel
    table, the fused scan's superblock) reads ``.device`` directly and
    never triggers that readback.

    ``length`` is a host int (read at capture), so shape planning —
    segment sizing, the count exchange, channel stats — never syncs."""

    def __init__(self, device: DeviceBlock, length: int):
        # not the dataclass __init__: `columns` is a read-only property
        # here, not a field
        self.schema = device.schema
        self.device = device
        self.length = int(length)
        self._cols = None

    @property
    def columns(self) -> dict:
        if self._cols is None:
            self._cols = to_host(
                DeviceBlock(self.device.schema, self.device.arrays,
                            self.device.valids, self.length,
                            self.device.capacity,
                            self.device.dictionaries)).columns
        return self._cols

    @property
    def materialized(self) -> bool:
        """True once a host path has forced the readback."""
        return self._cols is not None

    def live_nbytes(self) -> int:
        """Live payload bytes (length x schema itemsizes + masks): shape
        arithmetic only, never a device sync."""
        n = 0
        for c in self.schema:
            n += self.length * int(np.dtype(c.dtype.np).itemsize)
            if c.name in self.device.valids:
                n += self.length
        return n

    def project(self, output: list) -> "DeviceStageBlock":
        """Device-side mirror of the executor's `_project_output` (rename
        and duplicate-label suffixing): tensor references move, no bytes
        do."""
        from ydb_tpu_torch.core.schema import Column

        arrays, valids, dicts = {}, {}, {}
        schema_cols = []
        used = set()
        for (internal, label) in output:
            lbl = label
            k = 2
            while lbl in used:
                lbl = f"{label}_{k}"
                k += 1
            used.add(lbl)
            arrays[lbl] = self.device.arrays[internal]
            if internal in self.device.valids:
                valids[lbl] = self.device.valids[internal]
            if internal in self.device.dictionaries:
                dicts[lbl] = self.device.dictionaries[internal]
            schema_cols.append(Column(lbl, self.schema.dtype(internal)))
        dev = DeviceBlock(Schema(schema_cols), arrays, valids,
                          self.device.length, self.device.capacity, dicts)
        return DeviceStageBlock(dev, self.length)


class DeviceResultFuture:
    """Handle to a dispatched device computation whose device→host
    readout is deferred until the result is consumed. torch launches
    asynchronously on the current stream, so the executor returns this
    right after enqueueing the query's kernels; `result()` runs the
    readout once and caches the block (or the exception)."""

    __slots__ = ("_fetch", "_value", "_exc", "_done")

    def __init__(self, fetch):
        self._fetch = fetch            # () -> HostBlock
        self._value = None
        self._exc = None
        self._done = False

    def result(self):
        if not self._done:
            try:
                self._value = self._fetch()
            except Exception as e:       # noqa: BLE001 — re-raised
                self._exc = e
            self._done = True
            self._fetch = None
        if self._exc is not None:
            raise self._exc
        return self._value

    @classmethod
    def completed(cls, value) -> "DeviceResultFuture":
        """A future already holding its result (paths that read their
        result back while they run: the tiled and spill lanes)."""
        fut = cls(None)
        fut._value = value
        fut._done = True
        return fut

    def map(self, fn) -> "DeviceResultFuture":
        return DeviceResultFuture(lambda: fn(self.result()))
