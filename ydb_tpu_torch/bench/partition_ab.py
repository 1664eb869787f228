"""A/B of the partition kernel (K14) on one GPU, in one process.

    python3 -m ydb_tpu_torch.bench.partition_ab [--other OTHER.cu ...]

Builds the tree's ``ops/cuda/csrc/partition.cu`` and, with each
``--other``, another source of the same C interface (a parent commit's,
or the tree's with other launch constants). Every side runs through
the tree's wrapper (no ids, as the paths call it) on seeded inputs of
the two shapes ``chip_smoke.py`` times: the beyond-budget path's largest
spill feed (q21: 1,048,576 rows, 262,430 live, 16 partitions, three
8-byte columns and two bool ones, 26 bytes a row) and a GraceJoin
routing of lineitem (6,291,456 rows, 6,000,409 live, 8 partitions, four
8-byte columns and a bool, into 2n rows); the hashes are random 64-bit
words. Each side must equal the plain version bit for bit, twice. Times
are CUDA-event medians (``chip_smoke.time_ms``) taken in four rounds
that alternate which side runs first, beside the stable ``sort`` +
``index_select`` floor and the byte bound; then the tree's call once
more under torch.profiler (device ms by kernel). Prints the card, a
line per case and the times as JSON on the last line.
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
                    help="another partition.cu with the same C interface, "
                    "one more side (other1, other2, ... in order)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ydb_tpu_torch.ops.cuda import bindings as B
    from ydb_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        print("partition_ab: no CUDA device")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = {"tree": build.build_all(("partition",))["partition"]["path"]}
    procs = {}
    for i, src in enumerate(args.other, 1):   # one nvcc a side, all at once
        name = f"other{i}"
        print(f"side {name}: {src}", flush=True)
        path = os.path.join(str(build.BUILD_DIR), f"libpartition-{name}.so")
        procs[name] = (path, subprocess.Popen(
            [build.nvcc_path(), build.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name}: nvcc failed\n{log}")
        libs[name] = path

    def load(path):
        lib = ctypes.CDLL(path)
        _lib, sym, argtypes = B._SIGS["partition"]
        getattr(lib, sym).argtypes = argtypes
        getattr(lib, sym).restype = ctypes.c_int
        return lib
    libs = {side: load(p) for side, p in libs.items()}

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(14)

    def words(m):
        return torch.randint(-(1 << 63), (1 << 63) - 1, (m,), generator=g,
                             device=dev)

    def case(n, live, nparts, n_wide, out_rows):
        cols = [words(n) for _ in range(n_wide)] + [
            torch.rand((n,), generator=g, device=dev) < 0.5
            for _ in range(5 - n_wide)]
        length = torch.tensor(live, dtype=torch.int32, device=dev)
        return words(n), length, nparts, cols, out_rows

    def trace(fn) -> dict:
        """The tree's call once more under torch.profiler: device ms by
        kernel (and the memset of the control words)."""
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

    sync = torch.cuda.synchronize
    n = 6_291_456
    cases = {"spill feed (q21)": case(1 << 20, 262_430, 16, 3, 1 << 20),
             "routing (lineitem)": case(n, 6_000_409, 8, 4, 2 * n)}
    out = {}
    for name, (h, length, nparts, cols, out_rows) in cases.items():
        want = B.partition_plain(h, length, nparts, cols, out_rows,
                                 ids=False)
        for side, lib in libs.items():
            B._LIBS["partition"] = lib
            for _ in range(2):
                got = B.partition(h, length, nparts, cols, out_rows,
                                  ids=False)
                sync()
                cs.check(torch.equal(got[1], want[1]) and all(
                    torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                    for x, y in zip(got[2], want[2])),
                    f"{name} {side}: not the plain version")
        times = {side: [] for side in libs}
        for rnd in range(4):
            for side in (list(libs)[::-1] if rnd % 2 == 0 else list(libs)):
                B._LIBS["partition"] = libs[side]
                times[side].append(cs.time_ms(
                    lambda: B.partition(h, length, nparts, cols, out_rows,
                                        ids=False), iters=9, warmup=2))
        B._LIBS.pop("partition", None)
        pid = B.partition_plain(h, length, nparts, [], out_rows)[0]

        def lib_call():
            order = torch.sort(pid, stable=True).indices
            return [c.index_select(0, order) for c in cols]
        row = dict(times, library_ms=cs.time_ms(lib_call),
                   bound_ms=cs.bound_ms(cs.partition_bytes(
                       h.shape[0], cols, nparts, out_rows)),
                   device_items=trace(lambda: B.partition(
                       h, length, nparts, cols, out_rows, ids=False)))
        out[name] = row
        print(f"partition {name}: " + " ".join(
            f"{k}={v}" for k, v in row.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
