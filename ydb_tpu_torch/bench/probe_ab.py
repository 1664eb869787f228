"""A/B of the probe kernel (K7) on one GPU, in one process, at the
shapes the TPC-H path gives it.

    python3 -m ydb_tpu_torch.bench.probe_ab [--other OTHER.cu ...]
        [--sweep K ...] [--sf SF]

Loads TPC-H at ``--sf`` into a ``QueryEngine()`` on the card and runs q9
and q18 once each, recording every ``probe`` call: the largest
sorted-keys call is q9's probe of partsupp (a composite key: no LUT).
Builds the tree's ``ops/cuda/csrc/probe.cu`` and, with each
``--other``, another source of the same C interface (a parent commit's,
say: its ``probe_launch`` lacks the three trailing table arguments,
which the call then passes unread; or the tree's with other launch
constants), all with one ``nvcc`` each, started together. Every side
runs through the tree's wrapper on every recorded call's inputs, on the
LUT shape of ``chip_smoke.py`` (Q14's l_partkey into part's LUT over
the superblock rows) and, with ``--sweep``, on searches over kcap = 2^K
synthetic sorted keys (three quarters real, the rest the int64
sentinel). Each
side must equal the plain version on every output and the tree's
kernel must repeat itself bit for bit. Times are CUDA-event medians
(``chip_smoke.time_ms``) taken in four rounds that alternate which side
runs first, beside the plain version, ``torch.searchsorted`` on the
same keys and the byte bound. Then q9's and q18's warm runs are traced
with torch.profiler (the tree's kernel): the device time of their probe
kernels. Prints the card, one line per case and the times as JSON on
the last line.
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
                    help="another probe.cu with the same C interface, "
                    "one more side (other1, other2, ... in order)")
    ap.add_argument("--sweep", type=int, nargs="*", default=[],
                    help="log2 kcap of more sorted-keys searches to time")
    ap.add_argument("--sf", type=float, default=1.0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ydb_tpu_torch.bench.tpch_gen import load_tpch
    from ydb_tpu_torch.bench.tpch_oracle import QUERIES
    from ydb_tpu_torch.ops.cuda import bindings as B
    from ydb_tpu_torch.ops.cuda import build
    from ydb_tpu_torch.ops.device import bucket_capacity
    from ydb_tpu_torch.progstore.buckets import bucket_sources
    from ydb_tpu_torch.query import QueryEngine

    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    built = build.build_all(("probe",), verbose=True)
    for k, v in built.items():
        for fn in cs.ptxas_functions(v["log"]):
            print(f"ptxas {k} {fn['name']}: registers={fn['registers']} "
                  f"stack_frame={fn['stack']} "
                  f"spill_stores={fn['spill_stores']} "
                  f"spill_loads={fn['spill_loads']}", flush=True)
    libs = {"tree": built["probe"]["path"]}
    procs = {}
    for i, src in enumerate(args.other, 1):   # one nvcc a side, all at once
        name = f"other{i}"
        print(f"side {name}: {src}", flush=True)
        path = os.path.join(str(build.BUILD_DIR), f"libprobe-{name}.so")
        procs[name] = (path, subprocess.Popen(
            [build.nvcc_path(), build.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name}: nvcc failed\n{log}")
        for fn in cs.ptxas_functions(log):
            print(f"ptxas {name} {fn['name']}: registers={fn['registers']} "
                  f"stack_frame={fn['stack']} "
                  f"spill_stores={fn['spill_stores']}", flush=True)
        libs[name] = path

    def load(path):
        lib = ctypes.CDLL(path)
        _lib, sym, argtypes = B._SIGS["probe"]
        getattr(lib, sym).argtypes = argtypes
        getattr(lib, sym).restype = ctypes.c_int
        return lib
    libs = {side: load(p) for side, p in libs.items()}

    eng = QueryEngine()
    load_tpch(eng.catalog, sf=args.sf)
    li = eng.catalog.table("lineitem")
    portions = [p for s in li.shards for p in s.portions]
    n = bucket_sources(len(portions)) * max(
        bucket_capacity(max(p.num_rows, 1)) for p in portions)

    # q9's and q18's probes, recorded through the wrapper
    B._LIBS["probe"] = libs["tree"]
    recorded = {q: cs.record_probes(B, eng, QUERIES[q]) for q in ("q9", "q18")}
    torch.cuda.synchronize()
    search = [c for c in recorded["q9"] if c[3]["lut"] is None]
    cs.check(search, "q9 made no sorted-keys probe")
    for q, calls in recorded.items():
        for i, (key, kvalid, sel, kw) in enumerate(calls):
            print(f"{q} probe call {i}: n={key.shape[0]} dtype={key.dtype} "
                  f"lut={'none' if kw['lut'] is None else kw['lut'].shape[0]} "
                  f"kcap={kw['keys_sorted'].shape[0]} n_build={kw['n_build']} "
                  f"kind={kw['kind']} payloads={len(kw['payloads'])} "
                  f"kvalid={kvalid is not None} "
                  f"active={int(sel.sum())}", flush=True)
    q9 = max(search, key=lambda c: c[0].shape[0])

    # the LUT shape of chip_smoke's kernel phase
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    n_part = eng.catalog.table("part").num_rows
    span = bucket_capacity(n_part, minimum=1024)
    lut = torch.full((span,), -1, dtype=torch.int32, device=dev)
    lut[:n_part] = torch.randperm(n_part, generator=g,
                                  device=dev).to(torch.int32)
    lkey = torch.randint(1, n_part + 5000, (n,), generator=g, device=dev)
    lvalid = torch.rand((n,), generator=g, device=dev) > 0.01
    lsel = torch.rand((n,), generator=g, device=dev) < 0.0125
    lkw = dict(lut=lut, lut_base=1,
               keys_sorted=torch.arange(1, span + 1, device=dev),
               n_build=n_part, pcap=span, kind="inner", not_in=False,
               has_null=False, payloads=[])
    cases = {"q9 sorted keys": q9,
             "lut": (lkey, lvalid, lsel, lkw)}
    # every other call of the two queries, at its own shape
    for q, calls in recorded.items():
        for i, c in enumerate(calls):
            if c is not q9:
                cases[f"{q} call {i}"] = c
    # the search at other build sizes: kcap sorted int64 keys, three
    # quarters of them real, probed by the superblock's rows
    for k in args.sweep:
        kcap = 1 << k
        nb = 3 * kcap // 4
        real = torch.unique(torch.randint(0, 1 << 40, (nb + nb // 8 + 16,),
                                          generator=g, device=dev))[:nb]
        nb = real.shape[0]
        keys = torch.cat([real, torch.full((kcap - nb,),
                                           torch.iinfo(torch.int64).max,
                                           device=dev)])
        probes = torch.where(
            torch.rand((n,), generator=g, device=dev) < 0.5,
            keys[torch.randint(0, nb, (n,), generator=g, device=dev)],
            torch.randint(0, 1 << 40, (n,), generator=g, device=dev))
        cases[f"search kcap=2^{k}"] = (probes, None, lsel, dict(
            lut=None, lut_base=0, keys_sorted=keys, n_build=nb, pcap=kcap,
            kind="inner", not_in=False, has_null=False, payloads=[]))
    sync = torch.cuda.synchronize
    out = {}
    for name, (key, kvalid, sel, kw) in cases.items():
        want = B.probe_plain(key, kvalid, sel, **kw)
        for side, lib in libs.items():
            B._LIBS["probe"] = lib
            got = B.probe(key, kvalid, sel, **kw)
            sync()
            cs.check(all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
                     and all(torch.equal(a, c) and torch.equal(b, d)
                             for (a, b), (c, d) in zip(got[3], want[3])),
                     f"{name} {side}: not the plain version")
        B._LIBS["probe"] = libs["tree"]
        a, b = B.probe(key, kvalid, sel, **kw), B.probe(key, kvalid, sel,
                                                        **kw)
        sync()
        cs.check(all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])),
                 f"{name}: tree kernel not repeatable")
        times = {side: [] for side in libs}
        for rnd in range(4):
            for side in (list(libs)[::-1] if rnd % 2 == 0 else list(libs)):
                B._LIBS["probe"] = libs[side]
                times[side].append(cs.time_ms(
                    lambda: B.probe(key, kvalid, sel, **kw), iters=9,
                    warmup=2))
        B._LIBS["probe"] = libs["tree"]
        ks = kw["keys_sorted"] if kw["lut"] is None else kw["lut"]
        ref = kw["keys_sorted"]
        row = dict(times, n=key.shape[0], kcap=ks.shape[0],
                   n_build=kw["n_build"],
                   plain_ms=cs.time_ms(lambda: B.probe_plain(
                       key, kvalid, sel, **kw)),
                   library_ms=cs.time_ms(
                       lambda: torch.searchsorted(ref, key.to(ref.dtype))),
                   bound_ms=cs.bound_ms(cs.probe_bytes(
                       key, kvalid, sel, ks.shape[0], kw["payloads"])))
        out[name] = row
        print(f"probe {name}: " + " ".join(f"{k}={v}" for k, v in
                                           row.items()), flush=True)

    # q9's and q18's probe kernels in a traced warm run
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) or 0)
    for q in ("q9", "q18"):
        eng.query(QUERIES[q])
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.query(QUERIES[q])
            sync()
        evs = [e for e in prof.key_averages() if dev_us(e) > 0
               and e.device_type == DeviceType.CUDA and "probe" in e.key]
        tot = sum(dev_us(e) for e in evs) / 1e3
        out[f"traced {q}"] = {"probe_ms": tot,
                              "launches": sum(e.count for e in evs)}
        print(f"traced {q}: probe_kernel_ms={tot:.4f} x"
              f"{sum(e.count for e in evs)} "
              + "; ".join(f"{e.key[:40]}={dev_us(e) / 1e3:.4f}ms x{e.count}"
                          for e in evs), flush=True)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
