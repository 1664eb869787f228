"""The DQ channel ICI data plane: device-resident redistribution (port
of ``ydb_tpu/dq/ici.py``).

A host-plane channel serializes every partition to an npz frame and
ships it through the worker's exchange buffer (`cluster/exchange.py
ChannelWriter`). When the lowering marks an edge `plane="ici"` (every
worker is an in-process engine with a device — `dq/lower.py
_assign_planes`), the runner executes the redistribution here instead,
over the workers' devices as one `parallel.mesh.Mesh`:

  hash_shuffle   per producer: the bucket plane (`dq_bucket_plane`), the
                 send segments (`segments`, K15a, from the plane), the
                 exchange of segments and counts (copies between the
                 producers' devices, K15b) and the compaction of the
                 received rows (`compact`, K6); the segment size comes
                 from the count exchange (`dq_counts`, K16). A row routes
                 by the SAME hash the host plane uses
                 (`cluster/exchange.key_buckets`), so a key lands on the
                 same consumer on either plane;
  broadcast      every producer's rows to every consumer (`gather_all`).

On top, optional block quantization: columns the lowering PROVED
aggregation-tolerant (`Channel.quant_cols`, pure SUM/AVG inputs behind a
final reduction) cross as int8 codes with a float32 scale per 128 rows
(`quantize_blocked` / `dequantize_blocked`, K15d) when
`YDB_TPU_DQ_QUANT=1`; keys, group-bys and every other exact-context
column always ship verbatim. A quant request the runtime cannot honor
(a non-float or masked column) is REFUSED loudly — counted on
`dq/quant_refused`, shipped exact — never silently lossy.

What this plane cannot express (an exotic dtype, mixed object columns, a
float shuffle key, fewer than 2 producers, a missing column) raises
`IciPlaneError`, and the runner re-runs the edge on the host plane. A
failure of a kernel or its wrapper is not a decline: it reaches the
caller.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import pandas as pd
import torch

from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.torch_ns import torch_dtype
from ydb_tpu_torch.parallel.collective import (QUANT_BLOCK,
                                               compact_segments,
                                               dequantize_blocked,
                                               exchange_segments,
                                               gather_all, quantize_blocked)
from ydb_tpu_torch.parallel.mesh import Mesh


class IciPlaneError(Exception):
    """This edge cannot run device-resident; the runner falls back to
    the host plane."""


def quant_enabled() -> bool:  # lint: tuning-provider
    """`YDB_TPU_DQ_QUANT` lever: 0/unset = off (byte-equal frames)."""
    return os.environ.get("YDB_TPU_DQ_QUANT", "0").strip() == "1"


def planned_enabled() -> bool:  # lint: tuning-provider
    """`YDB_TPU_DQ_PLANNED` lever: 1/unset = planned redistribution
    (`exchange_blocks` — device blocks by reference, count-exchange
    segment sizing on the fine ladder); 0 = the legacy pandas exchange
    with 2x power-of-two segments and the device overflow probe."""
    return os.environ.get("YDB_TPU_DQ_PLANNED", "1").strip() != "0"


def _mesh(devices) -> Mesh:
    """The producers' devices as one mesh (a device may repeat: workers
    that share a card)."""
    if devices is None or len(devices) < 2:
        raise IciPlaneError(
            f"ICI plane needs at least 2 producer devices, got "
            f"{0 if devices is None else len(devices)}")
    return Mesh(list(devices))


# -- column codecs ---------------------------------------------------------
#
# Every landed column must be indistinguishable from the host plane's
# npz round trip: plain numeric dtypes pass through; object columns
# (how `to_pandas` renders NULL-bearing numerics and strings) ride as
# typed arrays + valid masks (+ a shared dictionary for strings) and
# decode back to object-with-None.

_NUM = "num"
_MASK_INT = "maskint"
_MASK_FLOAT = "maskfloat"
_DICT = "dict"


def _classify(series_per_dev: list, col: str, hint: str):
    """One codec per column, decided over ALL producers (the same
    column can be int64 on a NULL-free shard and object on another)."""
    dts = {str(s.dtype) for s in series_per_dev if len(s)}
    if not dts:
        dts = {hint or "float64"}
    objish = {"object", "str", "string"}
    if not (dts & objish):
        if len(dts) > 1:
            raise IciPlaneError(f"column {col!r}: producers disagree on "
                                f"dtype ({sorted(dts)})")
        np_dt = np.dtype(next(iter(dts)))
        if np_dt.kind not in "iufb":
            raise IciPlaneError(f"column {col!r}: dtype {np_dt} is not "
                                "ICI-encodable")
        return (_NUM, np_dt)
    vals = [v for s in series_per_dev for v in s.dropna().tolist()]
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
           for v in vals):
        return (_MASK_INT, np.dtype(np.int64))
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, bool) for v in vals):
        return (_MASK_FLOAT, np.dtype(np.float64))
    if all(isinstance(v, str) for v in vals):
        # shared dictionary across every producer: codes agree on all
        # devices, values ship once host-side (metadata, not row bytes)
        values = sorted(set(vals))
        return (_DICT, np.dtype(np.int32), values)
    raise IciPlaneError(f"column {col!r}: mixed object values are not "
                        "ICI-encodable")


def _encode(series: pd.Series, spec, cap: int):
    """→ (data[cap], valid[cap]) numpy arrays for one producer."""
    n = len(series)
    valid = np.ones(cap, np.bool_)
    valid[n:] = False
    if spec[0] == _NUM:
        data = np.zeros(cap, spec[1])
        data[:n] = series.to_numpy(dtype=spec[1], copy=False)
        return data, valid
    notna = series.notna().to_numpy() if n else np.zeros(0, np.bool_)
    valid[:n] = notna
    data = np.zeros(cap, spec[1])
    if spec[0] == _DICT:
        code_of = {v: i for i, v in enumerate(spec[2])}
        vals = series.to_numpy()
        data[:n] = [code_of[v] if m else 0
                    for v, m in zip(vals, notna)]
    elif n:
        if series.dtype != object:        # NULL-free numeric producer
            data[:n] = series.to_numpy(dtype=spec[1], copy=False)
        else:
            vals = series.to_numpy()
            data[:n] = [spec[1].type(v) if m else 0
                        for v, m in zip(vals, notna)]
    return data, valid


def _decode(spec, data: np.ndarray, valid: np.ndarray):
    """Per-consumer column: device output rows (already transferred —
    the caller batches every column through ONE device→host copy) → the
    pandas column the host plane's npz round trip would have landed."""
    if spec[0] == _NUM:
        return data.astype(spec[1], copy=False)
    if spec[0] == _DICT:
        # lint: transfer-ok(string pool is host metadata, never a device value)
        pool = np.asarray(spec[2], dtype=object)
        out = np.array(
            pool[np.clip(data.astype(np.int64), 0,
                         max(len(pool) - 1, 0))]
            if len(pool) else np.zeros(len(data), object),
            dtype=object)
    else:
        out = data.astype(spec[1], copy=False).astype(object)
    out[~valid] = None
    return out


def _wire_bytes_per_row(spec, quantized: bool) -> float:
    """Bytes one row of this column occupies on the interconnect (data
    + valid mask; quantized columns ride int8 codes + amortized
    per-block scale)."""
    if quantized:
        return 1 + 4.0 / QUANT_BLOCK + 1
    return spec[1].itemsize + 1

# -- the device programs ----------------------------------------------------


def _run_shuffle(mesh, seg, names, dtypes, quant_names, arrays, valids,
                 plane, lengths):
    """The shuffle program of one edge, per producer p on its device:
    the send segments of its rows by row p of the `[ndev, cap]` bucket
    `plane` (K15a; a plane value of -1 routes nowhere), the quantized columns' int8 codes and scales
    (K15d), then the exchange of segments, counts and scales (K15b), the
    dequantization and the compaction of each consumer's received rows
    (K15c). `arrays[n][p]` / `valids[n][p]` (None: no mask) are producer
    p's `[cap]` columns. Returns per consumer `(out_d, out_v, total,
    overflow)`: `[ndev * seg]` columns, a 0-d live count and the 0-d
    flag of some producer's target overflowing `seg`."""
    devices = list(mesh.devices.flat)
    ndev = len(devices)
    per_dev, scales, ovfs = [], [], []
    for p in range(ndev):
        cols = [(arrays[n][p], valids[n][p]) for n in names]
        outs, counts, ovf = K.segments(int(lengths[p]), ndev, seg, cols,
                                       targets=plane[p].to(devices[p]))
        stacked_d = {n: d for n, (d, _v) in zip(names, outs)}
        stacked_v = {n: v for n, (_d, v) in zip(names, outs)}
        sc = {}
        for n in quant_names:
            stacked_d[n], sc[n] = quantize_blocked(stacked_d[n])
        per_dev.append((stacked_d, stacked_v, counts))
        scales.append(sc)
        ovfs.append(ovf)
    recv = exchange_segments(per_dev, names, devices)
    out = []
    for t, (recv_d, recv_v, recv_c) in enumerate(recv):
        # the scale stacks' all_to_all: producer s's row t → consumer t
        for n in quant_names:
            recv_s = torch.stack([scales[s][n][t].to(devices[t])
                                  for s in range(ndev)])
            recv_d[n] = dequantize_blocked(recv_d[n], recv_s, dtypes[n])
        env2, tot = compact_segments(recv_d, recv_v, recv_c, seg, ndev,
                                     names)
        out_d = {n: env2[n][0] for n in names}
        out_v = {n: (env2[n][1] if env2[n][1] is not None
                     else torch.ones_like(out_d[n], dtype=torch.bool))
                 for n in names}
        out.append((out_d, out_v, tot, ovfs[t]))
    return out


def _run_broadcast(mesh, cap, names, arrays, valids, lengths):
    """The broadcast program: every producer's `[cap]` buffer to every
    consumer, compacted to its live rows (`gather_all`). Returns per
    consumer `(out_d, out_v, total)` over `[ndev * cap]`."""
    devices = list(mesh.devices.flat)
    per_dev = []
    for p, dev in enumerate(devices):
        per_dev.append(
            ({n: arrays[n][p] for n in names},
             {n: (valids[n][p] if valids[n][p] is not None
                  else torch.ones(cap, dtype=torch.bool, device=dev))
              for n in names},
             torch.tensor(int(lengths[p]), dtype=torch.int32, device=dev)))
    out = []
    for env2, tot in gather_all(per_dev, cap, names, devices):
        out_d = {n: env2[n][0] for n in names}
        out_v = {n: (env2[n][1] if env2[n][1] is not None
                     else torch.ones_like(out_d[n], dtype=torch.bool))
                 for n in names}
        out.append((out_d, out_v, tot))
    return out


def _string_lut(values, ndev: int, device) -> torch.Tensor:
    """The bucket of every union-dictionary value: the host plane's crc32
    of the value mod ndev (`key_buckets`), as an int32 LUT."""
    lut = np.array([int(np.uint64(zlib.crc32(str(v).encode()))
                        % np.uint64(ndev)) for v in values], np.int32) \
        if len(values) else np.zeros(1, np.int32)
    return torch.from_numpy(lut).to(device)


def _bucket_plane(keys: list, valids: list, lengths, ndev: int, kind: str,
                  devices: list, values=None) -> torch.Tensor:
    """The `[ndev, cap]` bucket plane of the shuffle key on the first
    device, row p producer p's (-1 past its length or where the key is
    NULL): one `dq_bucket_plane` launch over the producers stacked
    there."""
    dev0 = devices[0]
    cap = int(keys[0].shape[0])
    if kind == "string":
        k = torch.stack([x.to(dev0).to(torch.int32) for x in keys])
        lut = _string_lut(values, ndev, dev0)
    else:
        k = torch.stack([x.to(dev0).to(torch.int64) for x in keys])
        lut = None
    v = None
    if any(x is not None for x in valids):
        v = torch.stack([x.to(dev0) if x is not None
                         else torch.ones(cap, dtype=torch.bool, device=dev0)
                         for x in valids])
    lens = torch.tensor([int(n) for n in lengths], dtype=torch.int32,
                        device=dev0)
    return K.dq_bucket_plane(k.contiguous(), v, lens, ndev, lut)


# -- the legacy exchange (YDB_TPU_DQ_PLANNED=0) -----------------------------


def exchange(ch, dfs: list, key_kind: str = None,
             dtypes_hint: dict = None, counters=None,
             devices=None) -> tuple:
    """Execute one ICI-plane channel over its producers' stage outputs.

    `dfs[d]` is device d's stage output (one per worker, worker order),
    `devices[d]` that worker's device. Returns `(out_dfs, stats)`: the
    per-consumer landed frames and `{"ici_bytes", "ici_frames",
    "quant_bytes_saved", "quant_cols", "quant_refused"}`. Raises
    `IciPlaneError` when the edge cannot run device-resident (the caller
    falls back to the host plane)."""
    from ydb_tpu_torch.cluster.exchange import key_buckets
    from ydb_tpu_torch.dq.graph import BROADCAST, HASH_SHUFFLE
    from ydb_tpu_torch.ops.device import batched_to_host, bucket_capacity
    from ydb_tpu_torch.ops.torch_ns import to_tensor

    ndev = len(dfs)
    if ndev < 2:
        raise IciPlaneError("ICI plane needs at least 2 producers")
    mesh = _mesh(devices)
    devs = list(mesh.devices.flat)
    if ch.kind not in (HASH_SHUFFLE, BROADCAST):
        raise IciPlaneError(f"channel kind {ch.kind!r} has no ICI form")

    columns = None
    for df in dfs:
        if list(df.columns):
            columns = list(df.columns)
            break
    if columns is None:
        columns = list(ch.columns)
    if not columns:
        raise IciPlaneError(f"channel {ch.id}: no columns to exchange")

    if ch.kind == HASH_SHUFFLE:
        # host-plane parity: NULL join keys drop (inner semantics), and
        # the bucket per row is the SAME hash the host plane routes by
        dropped = []
        buckets = []
        for df in dfs:
            keep = df[ch.key].notna()
            df = df[keep] if not keep.all() else df
            dropped.append(df)
            try:
                buckets.append(
                    key_buckets(df[ch.key].to_numpy(), ndev, key_kind)
                    if len(df) else np.zeros(0, np.int64))
            except ValueError as e:
                raise IciPlaneError(f"channel {ch.id} key {ch.key!r}: "
                                    f"{e}") from e
        dfs = dropped

    hints = dtypes_hint or {}
    specs = {c: _classify([df[c] for df in dfs], c, hints.get(c))
             for c in columns}

    # quantization: only lowering-proven columns, only plain floats,
    # only with the lever on. A declared column the runtime cannot
    # quantize is refused LOUDLY and shipped exact.
    quant_names: list = []
    refused: list = []
    if quant_enabled():
        for c in ch.quant_cols:
            spec = specs.get(c)
            if spec is not None and spec[0] == _NUM \
                    and spec[1].kind == "f":
                quant_names.append(c)
            elif spec is not None:
                refused.append(c)
        if refused and counters is not None:
            counters.inc("dq/quant_refused", len(refused))

    cap = bucket_capacity(max(max((len(df) for df in dfs), default=0),
                              1), minimum=QUANT_BLOCK)
    arrays, valids = {}, {}
    for c in columns:
        enc = [_encode(df[c] if c in df.columns
                       else pd.Series(np.zeros(0, specs[c][1])),
                       specs[c], cap) for df in dfs]
        arrays[c] = [to_tensor(d, devs[p]) for p, (d, _v) in enumerate(enc)]
        valids[c] = [to_tensor(v, devs[p]) for p, (_d, v) in enumerate(enc)]
    lengths = np.array([len(df) for df in dfs], np.int32)

    names = tuple(columns)
    if ch.kind == HASH_SHUFFLE:
        plane = np.full((ndev, cap), -1, np.int32)
        for p, b in enumerate(buckets):
            plane[p, :len(b)] = b.astype(np.int32)
        plane = to_tensor(plane, devs[0])
        # segment sizing: uniform hashing sends ~rows/ndev to each
        # target, so 2× that (power-of-two) usually fits; a skewed edge
        # overflows on the device and reruns ONCE with seg = cap, which
        # cannot overflow (a target receives at most one producer's full
        # row count)
        max_rows = max((len(df) for df in dfs), default=0)
        seg = min(cap, bucket_capacity(
            max(1, (2 * max_rows + ndev - 1) // ndev),
            minimum=QUANT_BLOCK))
        dtypes = {c: specs[c][1] for c in names}
        while True:
            res = _run_shuffle(mesh, seg, names, dtypes, quant_names,
                               arrays, valids, plane, lengths)
            flags = batched_to_host([r[3].reshape(1).to(devs[0])
                                     for r in res])
            if not any(bool(f[0]) for f in flags):
                break
            assert seg < cap, "full-capacity segments cannot overflow"
            seg = cap
    else:
        seg = cap                      # broadcast gathers full buffers
        res = _run_broadcast(mesh, cap, names, arrays, valids, lengths)

    # one device→host copy per consumer for every column and the length
    out_dfs = []
    for d in range(ndev):
        out_d, out_v, tot = res[d][:3]
        host = batched_to_host([out_d[c] for c in columns]
                               + [out_v[c] for c in columns]
                               + [tot.reshape(1)])
        n = int(host[-1][0])
        cols = {c: _decode(specs[c], host[i][:n],
                           host[len(columns) + i][:n])
                for i, c in enumerate(columns)}
        out_dfs.append(pd.DataFrame(cols, columns=columns))

    # wire accounting: what the collective moved — every (src, dst) pair
    # carries one seg-row segment per column (payload + valid mask;
    # broadcast replicates each producer's full cap-row buffer to every
    # device), plus the per-segment row counts
    per_row = sum(_wire_bytes_per_row(specs[c], c in quant_names)
                  for c in columns)
    exact_row = sum(_wire_bytes_per_row(specs[c], False)
                    for c in columns)
    segs = ndev * ndev
    live_rows = int(sum(len(df) for df in out_dfs))
    padded_wire = int(segs * seg * per_row + segs * 4)
    live_wire = int(live_rows * per_row)
    stats = {
        "ici_bytes": padded_wire,
        "ici_frames": segs,
        "quant_bytes_saved": int(segs * seg * (exact_row - per_row)),
        "quant_cols": list(quant_names),
        "quant_refused": list(refused),
        "pad_live_bytes": live_wire,
        "pad_padded_bytes": padded_wire,
        "pad_efficiency": round(live_wire / padded_wire, 3)
        if padded_wire else None,
    }
    return out_dfs, stats


# -- planned redistribution (device blocks by reference) -------------------


def _device_specs(ch, blocks, columns):
    """One (codec_tag, numpy dtype) per column, decided over every
    producer SCHEMA (no pandas, no sync) — the planned twin of
    `_classify`. Strings ride as int32 dictionary codes (`_DICT`),
    everything else as its schema dtype (`_NUM`); validity always rides
    as a mask plane next to the data."""
    specs = {}
    for c in columns:
        dts, is_str = set(), False
        for b in blocks:
            if b.schema.has(c):
                dt = b.schema.dtype(c)
                is_str = is_str or dt.is_string
                dts.add(np.dtype(dt.np).str)
        if not dts:
            raise IciPlaneError(f"channel {ch.id}: column {c!r} missing "
                                "from every producer")
        if len(dts) > 1:
            raise IciPlaneError(f"column {c!r}: producers disagree on "
                                f"dtype ({sorted(dts)})")
        np_dt = np.dtype(next(iter(dts)))
        if np_dt.kind not in "iufb":
            raise IciPlaneError(f"column {c!r}: dtype {np_dt} is not "
                                "ICI-encodable")
        specs[c] = (_DICT, np.dtype(np.int32)) if is_str \
            else (_NUM, np_dt)
    return specs


def _union_dictionaries(ch, columns, specs, devs):
    """Shared consumer dictionaries for string columns: one union
    `Dictionary` per column over every producer's values (host METADATA
    — never a device readback), plus per-producer code-remap LUTs
    (old code → union code) applied device-side as a torch gather."""
    from ydb_tpu_torch.core.dictionary import Dictionary
    unions, luts = {}, {}
    for c in columns:
        if specs[c][0] != _DICT:
            continue
        u = Dictionary()
        per = []
        for (dev, n) in devs:
            d = dev.dictionaries.get(c)
            if d is None:
                if n > 0 and c in dev.arrays:
                    raise IciPlaneError(
                        f"channel {ch.id}: string column {c!r} has rows "
                        "but no dictionary on a producer")
                per.append(None)
                continue
            vals = d.values_array()
            per.append(u.encode_bulk(vals).astype(np.int32) if len(vals)
                       else np.zeros(0, np.int32))
        unions[c] = u
        luts[c] = per
    return unions, luts


def exchange_blocks(ch, blocks: list, key_kind: str = None,
                    counters=None, devices=None) -> tuple:
    """Planned device-resident redistribution — the stage spine's data
    plane. Producers and consumers speak device blocks BY REFERENCE:
    `blocks[d]` is worker d's stage output on `devices[d]` (a
    `DeviceStageBlock` stays on the device; a plain `HostBlock` from a
    non-fused stage is uploaded once), and the landed per-consumer
    partitions come back as `DeviceStageBlock`s — no pandas, no npz.

    Segment sizing is PLANNED: the count exchange (`dq_counts`) gives
    the per-(producer, target) live-row counts ([ndev, ndev] int32 — the
    one small readout before any row moves), and the segment size is
    the measured max bucketed UP onto the fine quarter-octave ladder
    (`progstore/buckets.bucket_segment`). `Channel.out_bound` caps the
    sizing; a bound that undercuts the measured counts takes the
    overflow escape hatch — ONE run at full capacity, which cannot
    overflow. The device overflow flag is never read: the sizing is
    known on the host before the exchange runs.

    Returns `(out_blocks, stats)`; raises `IciPlaneError` when the edge
    cannot run device-resident (the runner falls back to the host
    plane)."""
    st = _prepare_exchange(ch, blocks, key_kind, counters, devices)
    counts_host, ce_bytes = None, 0
    if st["plane"] is not None:
        counts_host = _exchange_counts(st)
        ce_bytes = st["ndev"] * st["ndev"] * 4
    return _finish_exchange(st, counts_host, ce_bytes, counters)


def exchange_blocks_batched(chans: list, blocks: list, key_kinds=None,
                            counters=None, devices=None) -> list:
    """Stage-level batched count exchange: prepare EVERY outgoing ICI
    edge of the stage, compute ALL their sizing counts in ONE
    `dq_counts` launch over `[nch, ndev, cap]` planes and one readout
    of the `[nch, ndev, ndev]` matrix — one host round trip per STAGE
    instead of one per channel — then finish each edge with its own
    counts slice. Planes pad to the widest channel's capacity with -1,
    and pad rows route nowhere, so each slice equals the channel's solo
    counts exactly. Broadcast edges need no counts and ride along; a
    stage with at most one shuffle edge degenerates to the solo count
    exchange. Any preparation failure raises `IciPlaneError` for the
    WHOLE stage (the runner's host-plane fallback re-runs every edge).

    Returns `[(out_blocks, stats)]` in channel order."""
    kks = list(key_kinds) if key_kinds is not None \
        else [None] * len(chans)
    sts = [_prepare_exchange(ch, blocks, kk, counters, devices)
           for ch, kk in zip(chans, kks)]
    shuf = [st for st in sts if st["plane"] is not None]
    if len(shuf) > 1:
        ndev = shuf[0]["ndev"]
        capmax = max(st["cap"] for st in shuf)
        stacked = torch.stack([
            torch.nn.functional.pad(st["plane"], (0, capmax - st["cap"]),
                                    value=-1) for st in shuf])
        all_counts = K.dq_counts(stacked, ndev).cpu().numpy()
        if counters is not None:
            counters.inc("dq/count_exchange_batched")
        for st, cm in zip(shuf, all_counts):
            st["_counts"] = cm
    elif shuf:
        shuf[0]["_counts"] = _exchange_counts(shuf[0])
    out = []
    for st in sts:
        ce = st["ndev"] * st["ndev"] * 4 \
            if st["plane"] is not None else 0
        out.append(_finish_exchange(st, st.pop("_counts", None), ce,
                                    counters))
    return out


def _prepare_exchange(ch, blocks: list, key_kind: str = None,
                      counters=None, devices=None) -> dict:
    """Align every producer's buffers on its device and compute the
    hash-shuffle bucket plane — everything `exchange_blocks` does BEFORE
    the count exchange, so the solo and the batched count exchange run
    the same preparation."""
    from ydb_tpu_torch.dq.graph import BROADCAST, HASH_SHUFFLE
    from ydb_tpu_torch.ops.device import DeviceStageBlock, to_device
    from ydb_tpu_torch.progstore.buckets import bucket_segment

    ndev = len(blocks)
    if ndev < 2:
        raise IciPlaneError("ICI plane needs at least 2 producers")
    mesh = _mesh(devices)
    devs = list(mesh.devices.flat)
    if len(devs) != ndev:
        raise IciPlaneError(f"{ndev} producers on {len(devs)} devices")
    if ch.kind not in (HASH_SHUFFLE, BROADCAST):
        raise IciPlaneError(f"channel kind {ch.kind!r} has no ICI form")

    columns = None
    for b in blocks:
        if list(b.schema.names):
            columns = list(b.schema.names)
            break
    if columns is None:
        columns = list(ch.columns)
    if not columns:
        raise IciPlaneError(f"channel {ch.id}: no columns to exchange")
    specs = _device_specs(ch, blocks, columns)

    # quantization: the legacy path's contract — only lowering-proven
    # columns, only plain (mask-free) floats, lever-gated; refusals are
    # loud, never silently lossy
    quant_names: list = []
    refused: list = []

    # producer buffer capacity on the fine ladder (not the legacy pow2)
    max_len = max(max((b.length for b in blocks), default=0), 1)
    cap = bucket_segment(max_len, minimum=1)

    dblocks = []                        # (DeviceBlock view, host length)
    for b, dev in zip(blocks, devs):
        if isinstance(b, DeviceStageBlock) and not b.materialized:
            dblocks.append((b.device, b.length))
        else:
            dblocks.append((to_device(b, dev, capacity=max(cap, b.length)),
                            b.length))

    def _masked(c):
        return any(c in dv.valids for (dv, _n) in dblocks)

    if quant_enabled():
        for c in ch.quant_cols:
            spec = specs.get(c)
            if spec is not None and spec[0] == _NUM \
                    and spec[1].kind == "f" and not _masked(c):
                quant_names.append(c)
            elif spec is not None:
                refused.append(c)
        if refused and counters is not None:
            counters.inc("dq/quant_refused", len(refused))
    if quant_names:
        cap = -(-cap // QUANT_BLOCK) * QUANT_BLOCK

    unions, luts = _union_dictionaries(ch, columns, specs, dblocks)

    def _fit(a, want):
        m = int(a.shape[0])
        if m == want:
            return a.contiguous()
        if m > want:
            return a[:want].contiguous()
        return torch.cat([a, torch.zeros(want - m, dtype=a.dtype,
                                         device=a.device)])

    lengths = np.array([n for (_dv, n) in dblocks], np.int32)
    arrays, valids = {}, {}
    for c in columns:
        want_dt = torch_dtype(specs[c][1])
        per_d, per_v = [], []
        for di, (dv, n) in enumerate(dblocks):
            if c not in dv.arrays:
                raise IciPlaneError(f"channel {ch.id}: column {c!r} "
                                    f"missing on producer {di}")
            a = dv.arrays[c]
            if specs[c][0] == _DICT:
                lut_np = luts[c][di]
                if lut_np is not None and len(lut_np):
                    # the union-dictionary remap: a gather of the codes
                    lut = torch.from_numpy(lut_np).to(a.device)
                    a = lut[a.to(torch.int64).clamp(0, len(lut_np) - 1)]
            if a.dtype != want_dt:
                a = a.to(want_dt)
            a = _fit(a, cap)
            if c in quant_names:
                # zero the inactive tail: capture-time pad rows may hold
                # garbage whose magnitude would poison the block scales
                a = torch.where(torch.arange(cap, device=a.device) < n, a,
                                torch.zeros_like(a))
            per_d.append(a)
            v = dv.valids.get(c)
            per_v.append(None if v is None else _fit(v, cap))
        arrays[c] = per_d
        valids[c] = per_v

    names = tuple(columns)
    plane = None
    if ch.kind == HASH_SHUFFLE:
        key = ch.key
        if not key or key not in columns:
            raise IciPlaneError(f"channel {ch.id}: shuffle key {key!r} "
                                "is not an exchanged column")
        kspec = specs[key]
        kind = key_kind or ("string" if kspec[0] == _DICT
                            else "float" if kspec[1].kind == "f"
                            else "int")
        if kind == "float":
            raise IciPlaneError(
                f"channel {ch.id} key {key!r}: float join keys are not "
                "hash-partitionable")
        # the bucket plane: the SAME per-row route the host plane's
        # `key_buckets` computes — splitmix64 for ints, the crc32 of the
        # union values for strings — with NULL/pad rows at -1 (dropped:
        # inner-shuffle semantics)
        plane = _bucket_plane(
            arrays[key], valids[key], lengths, ndev, kind, devs,
            unions[key].values_array() if kind == "string" else None)

    return {
        "ch": ch, "blocks": blocks, "mesh": mesh, "devices": devs,
        "ndev": ndev, "columns": columns, "specs": specs,
        "quant_names": quant_names, "refused": refused, "cap": cap,
        "lengths": lengths, "arrays": arrays, "valids": valids,
        "unions": unions, "names": names, "plane": plane,
        "masked": {c: _masked(c) for c in columns},
    }


def _exchange_counts(st: dict):
    """The solo count exchange of ONE prepared hash-shuffle edge: one
    `dq_counts` launch and one readout of the [ndev, ndev] int32
    matrix."""
    return K.dq_counts(st["plane"][None], st["ndev"])[0] \
        .cpu().numpy()


def _finish_exchange(st: dict, counts_host, ce_bytes: int,
                     counters=None) -> tuple:
    """Size and run the exchange from prepared state plus the sizing
    counts, then build the landed consumer blocks and the wire/padding
    account. `counts_host` is None exactly for broadcast edges (they
    gather full buffers, no sizing message)."""
    from ydb_tpu_torch.core.schema import Column, Schema
    from ydb_tpu_torch.ops.device import DeviceBlock, DeviceStageBlock
    from ydb_tpu_torch.progstore.buckets import bucket_segment

    ch, blocks, mesh = st["ch"], st["blocks"], st["mesh"]
    ndev, cap = st["ndev"], st["cap"]
    columns, specs, names = st["columns"], st["specs"], st["names"]
    quant_names = st["quant_names"]
    arrays, valids = st["arrays"], st["valids"]
    lengths, unions = st["lengths"], st["unions"]
    if st["plane"] is not None:
        max_pair = int(counts_host.max()) if counts_host.size else 0
        seg = bucket_segment(max(max_pair, 1), minimum=1)
        bound = getattr(ch, "out_bound", None)
        if bound:
            bseg = bucket_segment(int(bound), minimum=1)
            if bseg < seg:
                seg = bseg
        if max_pair > seg:
            # an unsound (or forged) bound undercut the measured counts:
            # the overflow escape hatch — ONE run at full capacity, which
            # cannot overflow (a target receives at most one producer's
            # full row count)
            if counters is not None:
                counters.inc("dq/planned_overflow_reruns")
            seg = cap
        if quant_names:
            seg = -(-seg // QUANT_BLOCK) * QUANT_BLOCK
        seg = min(seg, cap)
        dtypes = {c: specs[c][1] for c in names}
        res = _run_shuffle(mesh, seg, names, dtypes, quant_names, arrays,
                           valids, st["plane"], lengths)
        # the totals and overflow flags are never read: the landed
        # totals and the no-overflow verdict are known from the counts
        landed = [int(counts_host[:, d].sum()) for d in range(ndev)]
        out_cap = ndev * seg
    else:
        seg = cap                       # broadcast gathers full buffers
        res = _run_broadcast(mesh, cap, names, arrays, valids, lengths)
        landed = [int(lengths.sum())] * ndev
        out_cap = ndev * cap

    # landed per-consumer blocks: tensor REFERENCES into the exchange's
    # output, with host-known lengths — the consumer stage's fused scan
    # stacks them without any readback
    out_cols, out_dicts = [], {}
    for c in columns:
        sdt = next(b.schema.dtype(c) for b in blocks if b.schema.has(c))
        out_cols.append(Column(c, sdt))
        if c in unions:
            out_dicts[c] = unions[c]
    out_schema = Schema(out_cols)
    masked = st["masked"]
    out_blocks = []
    for d in range(ndev):
        out_d, out_v = res[d][0], res[d][1]
        dev = DeviceBlock(
            out_schema, {c: out_d[c] for c in columns},
            {c: out_v[c] for c in columns if masked[c]},
            landed[d], out_cap, dict(out_dicts))
        out_blocks.append(DeviceStageBlock(dev, landed[d]))

    # wire + padding account: planned segments on the ladder vs the live
    # rows that crossed, plus the sizing messages (per-segment counts and
    # the count exchange itself)
    per_row = sum(_wire_bytes_per_row(specs[c], c in quant_names)
                  for c in columns)
    exact_row = sum(_wire_bytes_per_row(specs[c], False)
                    for c in columns)
    segs = ndev * ndev
    live_rows = int(sum(landed))
    padded_wire = int(segs * seg * per_row + segs * 4 + ce_bytes)
    live_wire = int(live_rows * per_row)
    stats = {
        "ici_bytes": padded_wire,
        "ici_frames": segs,
        "quant_bytes_saved": int(segs * seg * (exact_row - per_row)),
        "quant_cols": list(quant_names),
        "quant_refused": list(st["refused"]),
        "pad_live_bytes": live_wire,
        "pad_padded_bytes": padded_wire,
        "pad_efficiency": round(live_wire / padded_wire, 3)
        if padded_wire else None,
        "planned": True,
        "seg": int(seg),
        "count_exchange_bytes": ce_bytes,
    }
    return out_blocks, stats
