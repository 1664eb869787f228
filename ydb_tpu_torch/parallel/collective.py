"""The mesh exchange's building blocks (port of
``ydb_tpu/parallel/collective.py``).

One implementation of the bucketize → segment → exchange → compact
redistribution, and of its broadcast sibling (gather + compact), used by
`parallel/shuffle.py` (two-phase aggregation) and
`parallel/shuffle_join.py` (the probe-row exchange). Everything keeps
the reference's static shapes: each shard sends `ndev` segments of
`seg` rows with their row counts, and an overflow (a target with more
than `seg` rows) is flagged on the device.

On the card, `route_segments` computes the targets and builds the
segments in one pass of the `segments` kernel (K15a); `bucket_of` and
`bucket_segments` launch the same kernel for their halves.
`compact_segments` compacts the received rows with the `compact` kernel
(K6). `exchange_segments` and `gather_all` are the collectives: copies
between the shards' devices, one batched copy per column when every
shard shares a device. `quantize_blocked` / `dequantize_blocked` are
the int8 block codec of collective payloads (K15d, the `quant` kernel),
used by the DQ channel plane's quantized columns. On CPU tensors the
wrappers run their plain versions.
"""

from __future__ import annotations

import torch

from ydb_tpu_torch.ops.cuda import bindings as K

# block granularity of the payload codec: one float32 scale per
# QUANT_BLOCK int8 codes (4 / QUANT_BLOCK bytes a row on top of the code)
QUANT_BLOCK = K.QUANT_BLOCK


def bucket_of(env, key_names, ndev):
    """Target shard of every row (int32, the whole capacity): the
    splitmix64 / hash_combine hash of the keys (each as int64, 0 where
    NULL) mod `ndev` as uint64 — the host shard routing's hash family.
    None without keys."""
    if not key_names:
        return None
    return K.segment_targets([env[k] for k in key_names], ndev)


def bucket_segments(env, bucket, length, cap, seg, ndev, names):
    """The send segments of one shard's rows, `bucket[cap]` giving each
    row's target. Returns `(stacked_d, stacked_v, counts, overflow)`:
    per column `[ndev, seg]` data and valid stacks, the per-target row
    counts `[ndev]` (clamped to `seg`) and the overflow flag (a target
    held more than `seg` rows — the caller reruns with full-capacity
    segments, which cannot overflow)."""
    outs, counts, ovf = K.segments(length, ndev, seg, _cols(env, names),
                                   targets=bucket)
    return _unpack(outs, names) + (counts, ovf)


def route_segments(env, key_names, length, cap, seg, ndev, names):
    """`bucket_segments(env, bucket_of(env, key_names, ndev), ...)` in
    one pass: the kernel hashes the keys as it bins the rows."""
    outs, counts, ovf = K.segments(length, ndev, seg, _cols(env, names),
                                   keys=[env[k] for k in key_names])
    return _unpack(outs, names) + (counts, ovf)


def _cols(env, names):
    return [(env[n][0].contiguous(),
             None if env[n][1] is None else env[n][1].contiguous())
            for n in names]


def _unpack(outs, names):
    return ({n: d for n, (d, _v) in zip(names, outs)},
            {n: v for n, (_d, v) in zip(names, outs)})


def exchange_segments(per_dev: list, names, devices: list) -> list:
    """The all_to_all: segment t of shard s → shard t's segment s, for
    every column's data and valid stacks and the row counts.
    `per_dev[s] = (stacked_d, stacked_v, counts)` on `devices[s]`;
    returns the same triple per receiving shard, on its device. When
    every shard shares one device the exchange is one stacking copy per
    stack (`torch.stack(..., dim=1)` puts source s at column s of each
    target's row); across devices each segment is copied to its
    receiver."""
    ndev = len(devices)
    first = devices[0]
    if all(d == first for d in devices):
        def swap(ts):
            return list(torch.stack(ts, dim=1).unbind(0))
        recv_d = {n: swap([p[0][n] for p in per_dev]) for n in names}
        recv_v = {n: swap([p[1][n] for p in per_dev]) for n in names}
        recv_c = swap([p[2] for p in per_dev])
        return [({n: recv_d[n][t] for n in names},
                 {n: recv_v[n][t] for n in names}, recv_c[t])
                for t in range(ndev)]
    out = []
    for t, dev in enumerate(devices):
        def take(ts):
            return torch.stack([x[t].to(dev, non_blocking=True)
                                for x in ts])
        out.append(({n: take([p[0][n] for p in per_dev]) for n in names},
                    {n: take([p[1][n] for p in per_dev]) for n in names},
                    take([p[2] for p in per_dev])))
    return out


def compact_segments(recv_d, recv_v, recv_c, seg, ndev, names):
    """Flatten received `[ndev, seg]` stacks and compact the live rows
    (the first `recv_c[s]` of each segment s) to the front. Returns
    `(env, total)` over `[ndev * seg]` buffers."""
    from ydb_tpu_torch.ops.torch_exec import compress
    flat = ndev * seg
    dev = recv_c.device
    jrow = torch.arange(seg, dtype=torch.int32, device=dev)
    seg_mask = (jrow[None, :] < recv_c[:, None]).reshape(-1)
    env = {n: (recv_d[n].reshape(-1), recv_v[n].reshape(-1))
           for n in names}
    return compress(env, flat, seg_mask, flat, dev)


def gather_all(per_dev: list, seg, names, devices: list,
               receivers=None) -> list:
    """The broadcast sibling of the shuffle: each receiving shard gets
    every shard's `[seg]` buffer and compacts the live rows.
    `per_dev[s] = (data, valid, count)` — dicts of `[seg]` tensors and a
    0-d count — on `devices[s]`. `receivers` (default: every device —
    the all-gather) lists the receiving devices. Returns `(env, total)`
    over `[ndev * seg]` per receiver."""
    ndev = len(devices)
    out = []
    for dev in (devices if receivers is None else receivers):
        def cat(ts):
            return torch.stack([x.to(dev, non_blocking=True) for x in ts])
        recv_d = {n: cat([p[0][n] for p in per_dev]) for n in names}
        recv_v = {n: cat([p[1][n] for p in per_dev]) for n in names}
        recv_c = cat([p[2].reshape(()) for p in per_dev])
        out.append(compact_segments(recv_d, recv_v, recv_c, seg, ndev,
                                    names))
    return out


# -- padding-waste accounting ----------------------------------------------
#
# Every exchange built from these blocks ships fixed-capacity segments, so
# the wire carries ndev² · seg rows whatever number of them is live.


def segment_pad_account(kind: str, ndev: int, seg: int, live_rows: int,
                        bytes_per_row: float) -> dict:
    """The live-vs-padded account of one fixed-capacity segment exchange:
    `ndev²` segments of `seg` rows each on the wire, `live_rows` of them
    real. (The reference also records it in its resource ledger,
    `utils/memledger.py`, which the port does not carry yet.)"""
    padded_rows = ndev * ndev * seg
    live_bytes = int(live_rows * bytes_per_row)
    padded_bytes = int(padded_rows * bytes_per_row)
    return {"live_rows": live_rows, "padded_rows": padded_rows,
            "live_bytes": live_bytes, "padded_bytes": padded_bytes,
            "efficiency": round(live_bytes / padded_bytes, 3)
            if padded_bytes else None}


# -- block quantization (collective payload codec) --------------------------


def quantize_blocked(x):
    """Per-block symmetric int8 quantization of a float tensor whose last
    axis is a multiple of QUANT_BLOCK. Returns `(codes int8, scales
    float32)` with `scales.shape = x.shape[:-1] + (last // QUANT_BLOCK,)`.
    NaN encodes as the reserved code -128 and survives the round trip; a
    block's scale comes from its NaN-masked max-abs."""
    return K.quantize_blocked(x.contiguous())


def dequantize_blocked(codes, scales, dtype):
    """Inverse of `quantize_blocked`: int8 codes + per-block scales →
    float tensor of `dtype` (a numpy or torch dtype; reserved code -128
    → NaN)."""
    from ydb_tpu_torch.ops.torch_ns import torch_dtype
    return K.dequantize_blocked(codes.contiguous(), scales.contiguous(),
                                torch_dtype(dtype))
