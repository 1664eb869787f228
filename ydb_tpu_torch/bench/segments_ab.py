"""A/B of the segments kernel (K15a) on one GPU, in one process.

    python3 -m ydb_tpu_torch.bench.segments_ab [--other OTHER.cu ...]

Builds the tree's ``ops/cuda/csrc/segments.cu`` and, with each
``--other``, another source of the same C interface (the tree's with
other launch constants, say). Every side runs through the tree's
wrapper on seeded inputs of the two shapes ``chip_smoke.py`` records on
the mesh path: the shuffle join's probe-row routing (2,097,152 rows, all
live, one int64 key with a valid, 4 targets, seg = n, five 8-byte and
two 4-byte columns, each with a valid) and q18's partial aggregate
(2,097,152 rows, 524,088 live, the key its first column, two 8-byte
columns with valids, 4 targets, seg = n). Each side must equal the
plain version bit for bit, twice. Times are CUDA-event medians
(``chip_smoke.time_ms``) taken in four rounds that alternate which side
runs first, beside the byte bound, a write floor (``zero_`` of every
output plane: the card's store rate for the bytes the outputs hold) and
the tree's call once more under torch.profiler (device ms by kernel).
Prints the card, a line per case and the times as JSON on the last
line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    help="another segments.cu with the same C interface, "
                    "one more side (other1, other2, ... in order)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ydb_tpu_torch.ops.cuda import bindings as B
    from ydb_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        print("segments_ab: no CUDA device")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = {"tree": build.build_all(("segments",))["segments"]["path"]}
    procs = {}
    for i, src in enumerate(args.other, 1):   # one nvcc a side, all at once
        name = f"other{i}"
        print(f"side {name}: {src}", flush=True)
        path = os.path.join(str(build.BUILD_DIR), f"libsegments-{name}.so")
        procs[name] = (path, subprocess.Popen(
            [build.nvcc_path(), build.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(build.CSRC),
             "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name}: nvcc failed\n{log}")
        for fn in cs.ptxas_functions(log):
            print(f"  ptxas {name} {fn}", flush=True)
        libs[name] = path

    def load(path):
        lib = ctypes.CDLL(path)
        _lib, sym, argtypes = B._SIGS["segments"]
        getattr(lib, sym).argtypes = argtypes
        getattr(lib, sym).restype = ctypes.c_int
        return lib
    libs = {side: load(p) for side, p in libs.items()}

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    sync = torch.cuda.synchronize

    def words(m, dtype=torch.int64):
        return torch.randint(-(1 << 31), 1 << 31, (m,), generator=g,
                             device=dev, dtype=dtype)

    def valid(m):
        return torch.rand((m,), generator=g, device=dev) < 0.95

    n = 2_097_152
    jkey = (words(n), valid(n))
    join_cols = [jkey] + [(words(n), valid(n)) for _ in range(4)] + [
        (words(n, torch.int32), valid(n)) for _ in range(2)]
    qkey = (words(n), valid(n))
    q18_cols = [qkey, (words(n), valid(n))]
    cases = {
        "join routing": (torch.tensor(n, dtype=torch.int32, device=dev), 4,
                         n, join_cols, [jkey]),
        "q18 partial": (torch.tensor(524_088, dtype=torch.int32,
                                     device=dev), 4, n, q18_cols, [qkey])}

    def trace(fn) -> dict:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        out = {}
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0) or 0)
            if us > 0 and e.device_type == DeviceType.CUDA:
                out[e.key[:40]] = us / 1e3
        return out

    out = {}
    for name, (length, ndev, seg, cols, keys) in cases.items():
        want = B.segments_plain(length, ndev, seg, cols, keys=keys)
        for side, lib in libs.items():
            B._LIBS["segments"] = lib
            for _ in range(2):
                got = B.segments(length, ndev, seg, cols, keys=keys)
                sync()
                cs.check(torch.equal(got[1], want[1]) and all(
                    torch.equal(cs.bits(a), cs.bits(b))
                    and torch.equal(av, bv)
                    for (a, av), (b, bv) in zip(got[0], want[0])),
                    f"{name} {side}: not the plain version")
        times = {side: [] for side in libs}
        for rnd in range(4):
            for side in (list(libs)[::-1] if rnd % 2 == 0 else list(libs)):
                B._LIBS["segments"] = libs[side]
                times[side].append(cs.time_ms(
                    lambda: B.segments(length, ndev, seg, cols, keys=keys),
                    iters=9, warmup=2))
        B._LIBS.pop("segments", None)
        planes = [t for d, v in want[0] for t in (d, v)]
        row = dict(times,
                   write_floor_ms=cs.time_ms(lambda: [t.zero_()
                                                      for t in planes]),
                   bound_ms=cs.bound_ms(cs.segments_bytes(keys, cols, ndev,
                                                          seg)),
                   device_items=trace(lambda: B.segments(
                       length, ndev, seg, cols, keys=keys)))
        out[name] = row
        print(f"segments {name}: " + " ".join(
            f"{k}={v}" for k, v in row.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
