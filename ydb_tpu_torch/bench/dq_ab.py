"""A/B of the DQ plane's kernels (K16's bucket plane and counts, K15d's
quantizer) on one GPU, in one process.

    python3 -m ydb_tpu_torch.bench.dq_ab [--other PATH ...] [--sass] [--dq]

Builds the tree's ``ops/cuda/csrc/dq_counts.cu`` and ``quant.cu`` and,
with each ``--other``, one more side: a ``dq_counts.cu`` or ``quant.cu``
of the same C interface, or a directory holding either or both (a
parent's ``csrc`` from ``git archive``, say); the side's sources take the
tree's place, the rest stays the tree's. Every side runs through the
tree's wrappers on seeded inputs of the shapes ``chip_smoke.py``
records on the DQ path: q5's lineitem edge, a [4, 1,572,864] int64 key
plane at ndev 4 (also at ndev 3, with a valid mask, and as dictionary
codes through a LUT), and its send stack, [4, 1,572,864] float64 (also
float32), random and with each target's segment zero past its ~24% of
live rows, as the path sends it; and the count exchange over that
edge's plane, [1, 4, 1,572,864] at ndev 4, and over the two-output
stage's [2, 4, 393,216] planes (and over [1, 4, 4], one vector a row:
what a launch costs beside its bytes). A side whose ``dq_counts.cu`` has no
``dq_counts_ticket_launch`` (a parent's, before its counts took one
launch) runs its counts through its own interface: a zeroed output,
then ``dq_counts_launch``. Each side must equal the plain version bit
for bit, twice.
Times are CUDA-event medians (``chip_smoke.time_ms``) in four rounds
that alternate which side runs first (``bench/ab.py``); the counts also
with the L2 cache flushed before each call (``cold_ms``: a 128 MB
``zero_`` first, as a plane the card wrote long before), beside the byte
bound and a floor (the plane: ``fill_(-1)`` of the plane, the store
alone; the quantizer: the blocks' max-abs alone; the counts have none:
torch's reductions of the planes take longer than the kernel).

``--sass`` prints, per side and kernel function of the two kernels, its
SASS instructions and calls (``cuobjdump -sass``: a 64-bit division or
remainder is a called routine on this card). ``--dq`` then runs the DQ
path (TPC-H SF1 over 4 worker engines, q3, q5 and q12 on the ICI
plane, q5 also quantized) per visit of a side once cold and twice warm
under torch.profiler, visits in the order A B B A A B, and prints the
device ms of its composition per visit (the plane, the counts, the
segments, the codec, the compaction, the copies between the workers'
devices, and the rest), beside the warm walls.

Prints the card, a line per case and the times as JSON on the last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

from ydb_tpu_torch.bench import ab

LIBS = {"dq_counts": "dq_bucket_plane_launch",
        "quant": "quantize_blocked_launch"}
CAP = 1_572_864
LENGTHS = [1_501_852, 1_497_905, 1_504_718, 1_495_934]
SEG_LIVE = [374_491, 375_102, 373_880, 374_960]
CAP2 = 393_216                   # the two-output stage's planes


def side_counts(B, planes, ndev: int):
    """`dq_counts` through the side in use: the tree's wrapper, or, for a
    ``dq_counts.cu`` without the one-launch entry, its own interface (a
    zeroed output, then ``dq_counts_launch``)."""
    import torch
    lib = B._LIBS["dq_counts"]
    if hasattr(lib, "dq_counts_ticket_launch"):
        return B.dq_counts(planes, ndev)
    fn = lib.dq_counts_launch
    fn.argtypes = [ctypes.c_int64] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    nch, nprod, cap = planes.shape
    counts = torch.zeros((nch, nprod, ndev), dtype=torch.int32,
                         device=planes.device)
    rc = fn(cap, nch, nprod, ndev, planes.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dq_counts_launch: cudaError {rc}")
    return counts


def sass(path: str, cuobjdump: str) -> list:
    """Per kernel function of the two kernels: (name, instructions,
    calls and their targets)."""
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = [m.group(1), 0, []]
            out.append(cur)
        elif cur is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            cur[1] += 1
            m = re.search(r"\bCALL\.\S+\s+(.*?)\s*;", line)
            if m:
                cur[2].append(m.group(1))
    return [f for f in out if "bucket_plane" in f[0] or "quantize" in f[0]]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    help="a dq_counts.cu, a quant.cu or a directory of "
                    "them: one more side (other1, other2, ... in order)")
    ap.add_argument("--sass", action="store_true",
                    help="print each side's SASS instructions and calls")
    ap.add_argument("--dq", action="store_true",
                    help="also time the DQ path's composition per side")
    args = ap.parse_args()
    cs = ab.start("dq_ab")
    if cs is None:
        return 2
    import torch

    from ydb_tpu_torch.ops.cuda import bindings as B
    from ydb_tpu_torch.ops.cuda import build

    sides = ab.build_sides(cs, LIBS, args.other)
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()),
                                 "cuobjdump")
        for name, libs in sides.items():
            for lib, path in libs.items():
                if name != "tree" and path == sides["tree"][lib]:
                    continue
                for fn, n, calls in sass(path, cuobjdump):
                    print(f"sass {name} {lib} {fn}: instructions={n} "
                          f"calls={len(calls)} {sorted(set(calls))}",
                          flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    keys = torch.randint(-(1 << 62), 1 << 62, (4, CAP), generator=g,
                         device=dev)
    valid = torch.rand((4, CAP), generator=g, device=dev) < 0.95
    codes = torch.randint(0, 2000, (4, CAP), generator=g, device=dev,
                          dtype=torch.int32)
    lut = torch.randint(0, 4, (2000,), generator=g, device=dev,
                        dtype=torch.int32)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    x = torch.randn((4, CAP), generator=g, device=dev,
                    dtype=torch.float64).mul_(1e4)
    x32 = x.to(torch.float32)
    # a send stack as the DQ path makes it: each target's segment holds
    # its live rows first, zeros after (about q5's 24% live)
    xz = x.clone()
    for t, live_t in enumerate(SEG_LIVE):
        xz[t, live_t:] = 0
    xz32 = xz.to(torch.float32)
    n = 4 * CAP
    # q5's edge plane, -1 past each producer's length, and the two-output
    # stage's planes (random targets, -1 past ~95% of the rows)
    planes1 = B.dq_bucket_plane_plain(keys, None, lengths, 4)[None]
    planes2 = torch.randint(0, 4, (2, 4, CAP2), generator=g, device=dev,
                            dtype=torch.int32)
    lens2 = torch.randint(CAP2 * 9 // 10, CAP2, (2, 4, 1), generator=g,
                          device=dev)
    planes2[torch.arange(CAP2, device=dev) >= lens2] = -1
    plane_out = torch.empty((4, CAP), dtype=torch.int32, device=dev)
    cases = {
        "plane ndev=4": (lambda: B.dq_bucket_plane(keys, None, lengths, 4),
                         lambda: B.dq_bucket_plane_plain(keys, None,
                                                         lengths, 4),
                         cs.plane_bytes(keys, None, lengths),
                         lambda: plane_out.fill_(-1)),
        "plane ndev=3": (lambda: B.dq_bucket_plane(keys, None, lengths, 3),
                         lambda: B.dq_bucket_plane_plain(keys, None,
                                                         lengths, 3),
                         cs.plane_bytes(keys, None, lengths),
                         lambda: plane_out.fill_(-1)),
        "plane ndev=4 valid": (
            lambda: B.dq_bucket_plane(keys, valid, lengths, 4),
            lambda: B.dq_bucket_plane_plain(keys, valid, lengths, 4),
            cs.plane_bytes(keys, valid, lengths),
            lambda: plane_out.fill_(-1)),
        "plane codes": (
            lambda: B.dq_bucket_plane(codes, None, lengths, 4, lut),
            lambda: B.dq_bucket_plane_plain(codes, None, lengths, 4, lut),
            cs.plane_bytes(codes, None, lengths, lut),
            lambda: plane_out.fill_(-1)),
        "quantize float64": (
            lambda: B.quantize_blocked(x), lambda: B.quantize_blocked_plain(x),
            n * 9 + n // 128 * 4,
            lambda: x.reshape(-1, 128).abs().amax(dim=1)),
        "quantize float32": (
            lambda: B.quantize_blocked(x32),
            lambda: B.quantize_blocked_plain(x32), n * 5 + n // 128 * 4,
            lambda: x32.reshape(-1, 128).abs().amax(dim=1)),
        "quantize float64 zero tails": (
            lambda: B.quantize_blocked(xz),
            lambda: B.quantize_blocked_plain(xz), n * 9 + n // 128 * 4,
            lambda: xz.reshape(-1, 128).abs().amax(dim=1)),
        "quantize float32 zero tails": (
            lambda: B.quantize_blocked(xz32),
            lambda: B.quantize_blocked_plain(xz32), n * 5 + n // 128 * 4,
            lambda: xz32.reshape(-1, 128).abs().amax(dim=1)),
    }
    tiny = planes1[:, :, :4].contiguous()
    for tag, pl in (("q5 edge", planes1), ("two-output stage", planes2),
                    ("one vector a row", tiny)):
        cases[f"counts {tag}"] = (
            lambda pl=pl: side_counts(B, pl, 4),
            lambda pl=pl: B.dq_counts_plain(pl, 4),
            pl.numel() * 4 + pl.shape[0] * pl.shape[1] * 4 * 4, None)

    out = {}
    for name, (run, plain, nbytes, floor) in cases.items():
        want = plain()
        ab.check_sides(cs, sides, run, lambda got: cs.same_bits(got, want),
                       name)
        row = dict(ab.alternate(cs, sides, run, iters=15, warmup=3),
                   floor_ms=None if floor is None else cs.time_ms(floor),
                   bound_ms=cs.bound_ms(nbytes))
        if name.startswith("counts"):
            row["cold_ms"] = {}
            for side, libs in sides.items():
                ab.use(libs)
                row["cold_ms"][side] = cold_ms(cs, run)
        out[name] = row
        print(f"dq_ab {name}: " + " ".join(f"{k}={v}" for k, v in
                                           row.items()), flush=True)
    ab.use(sides["tree"])
    if args.dq:
        out["dq"] = dq_composition(cs, sides)
    ab.release(LIBS)
    print(json.dumps(out))
    return 0


def cold_ms(cs, fn, iters: int = 9) -> float:
    """`fn`'s median device time with the L2 cache flushed before each
    call (a 128 MB `zero_`, then the spin kernel and the events)."""
    import statistics

    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cs.SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# the DQ composition's kernels by name (torch.profiler's device events)
KINDS = (("plane", "bucket_plane_kernel"), ("counts", "counts_kernel"),
         ("segments", "seg_scatter"), ("quantize", "quantize_kernel"),
         ("dequantize", "dequantize_kernel"), ("compact", "compact"),
         ("copies", "Memcpy"))


def dq_composition(cs, sides: dict) -> dict:
    """The DQ path's composition device ms per side (see the module
    docstring): per visit of a side, each query cold once, then twice
    warm under torch.profiler, the device time of the composition's
    kernels summed by kind (``KINDS``; "rest" is the queries' own work)
    with their counts, beside the warm walls. Visits go A B B A A B, so a
    trend over the call falls on both sides alike."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ydb_tpu_torch.bench.cluster_load import load_tpch_cluster
    from ydb_tpu_torch.bench.tpch_oracle import QUERIES
    from ydb_tpu_torch.cluster import ShardedCluster
    from ydb_tpu_torch.dq.runner import LocalWorker
    from ydb_tpu_torch.query import QueryEngine

    t0 = time.perf_counter()
    engines = [QueryEngine() for _ in range(cs.DQ_WORKERS)]
    for e in engines:
        e.executor.device_cache.budget = cs.DQ_CACHE_BUDGET
    _d, replicated, keys = load_tpch_cluster([e.catalog for e in engines],
                                             1.0)
    cluster = ShardedCluster([LocalWorker(e, name=f"dq{i}")
                              for i, e in enumerate(engines)],
                             merge_engine=engines[0])
    cluster.replicated, cluster.key_columns = replicated, keys
    print(f"dq_ab dq: TPC-H SF1 over {cs.DQ_WORKERS} workers, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs = [("q3", "0"), ("q5", "0"), ("q5", "1"), ("q12", "0")]
    names = list(sides)
    order = names + names[::-1] + names
    visits = {side: [] for side in sides}
    os.environ["YDB_TPU_DQ_PLANE"] = "auto"
    try:
        for side in order:
            ab.use(sides[side])
            for q, quant in runs:               # cold, untraced
                os.environ["YDB_TPU_DQ_QUANT"] = quant
                cluster.query(QUERIES[q])
            torch.cuda.synchronize()
            wall = 0.0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    for q, quant in runs:
                        os.environ["YDB_TPU_DQ_QUANT"] = quant
                        t = time.perf_counter()
                        cluster.query(QUERIES[q])
                        wall += time.perf_counter() - t
                torch.cuda.synchronize()
            ms, n = {"rest": 0.0}, {"rest": 0}
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA:
                    continue
                us = float(getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0) or 0)
                kind = next((k for k, pat in KINDS if pat in e.key), "rest")
                ms[kind] = ms.get(kind, 0.0) + us / 2e3     # a warm pass
                n[kind] = n.get(kind, 0) + e.count / 2
            ms["wall"] = wall * 1e3 / 2
            visits[side].append((ms, n))
            print(f"dq_ab dq visit {side}: ms a warm pass " + " ".join(
                f"{k}={v:.4f}({n.get(k, '-')})" for k, v in ms.items()),
                flush=True)
    finally:
        os.environ.pop("YDB_TPU_DQ_PLANE", None)
        os.environ.pop("YDB_TPU_DQ_QUANT", None)
    out = {}
    for side, vs in visits.items():
        kinds = sorted({k for ms, _n in vs for k in ms})
        out[side] = {k: [round(ms.get(k, 0.0), 4) for ms, _n in vs]
                     for k in kinds}
        print(f"dq_ab dq {side}: ms a warm pass of "
              f"{[q + ('+quant' if u == '1' else '') for q, u in runs]} "
              f"per visit: {json.dumps(out[side])}", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
