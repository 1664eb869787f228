"""A/B of K1's generated stages (``ops/k1.py``) on one GPU, in one
process.

    python3 -m ydb_tpu_torch.bench.k1_ab [--other PATH ...]

Loads TPC-H at SF1 into one engine and records the stages that q1,
q6 and q19 hand to ``k1.run_stage`` on the fused path (late
materialization on), q19's batched stages at B = 8
(``serving.variants``) and the orders point lookups' batched stages at
the B the serving lane's gates admit (up to 64; ``chip_smoke.
admitted_batch``). Each ``--other`` is another generator: an
``ops/k1.py`` (a parent's from ``git archive``, say), loaded as a
module of its own, with the prelude beside its file
(``cuda/csrc/k1_prelude.cuh``). Every side generates its own source for
every stage, built by NVRTC, and launches it over the same inputs: a
kernel that takes ``members`` runs on a 1-D grid and loops over the
members itself; one that does not runs a grid row per member, as K1 did
before its member loop. Each side's outputs must equal the plain
version (``k1.run_stage_plain``) bit for bit.

Times are CUDA-event medians (``chip_smoke.time_ms``) in four rounds
that alternate which side runs first (``bench/ab.py``), per stage and
summed per group, beside the byte bound (``chip_smoke._k1_bytes``: each
distinct input once, each output once). Prints the card, a line per
stage and per group, and the times as JSON on the last line.

``--sass DIR`` writes each side's SASS of every stage over members
(``cuobjdump -sass`` of the NVRTC cubin) to DIR and prints its
instruction count and commonest opcodes.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time

from ydb_tpu_torch.bench import ab

SINGLE = ("q1", "q6", "q19")
BATCH = 8                          # q19's batch, as the serving path's
POINT_MAX = 64                     # the point lookups' batch, at most


def load_side(path: str, name: str):
    """An ``ops/k1.py`` as a module of its own (its memos its own)."""
    spec = importlib.util.spec_from_file_location(
        f"ydb_tpu_torch_k1_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


class SideLauncher:
    """A side's launcher: each program's kernel built by NVRTC on first
    use, launched on torch's current stream. A kernel whose last
    argument is ``members`` runs on ``(ceil(n / THREADS), 1)`` blocks;
    any other on ``(ceil(n / THREADS), members)``, a grid row a member."""

    def __init__(self, mod):
        self.mod = mod
        self.kernels: dict = {}
        self.launched: list = []          # (kernel, source), in order

    def launch(self, prog, args: list, n: int, members: int,
               device) -> None:
        import ctypes

        import torch

        from ydb_tpu_torch.ops.cuda import nvrtc
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        kern = self.kernels.get(id(prog))
        if kern is None:
            kern = self.kernels[id(prog)] = (
                nvrtc.kernel(prog.source, self.mod.ENTRY, index), prog,
                looped(prog.source, self.mod.ENTRY))
        fn, _prog, loop = kern
        self.launched.append((fn, prog.source))
        threads = self.mod.THREADS
        blocks = (n + threads - 1) // threads
        extra = [ctypes.c_int64(n)]
        grid = (blocks, members, 1)
        if loop:
            extra.append(ctypes.c_int64(members))
            grid = (blocks, 1, 1)
        fn.launch(grid, (threads, 1, 1), args + extra,
                  torch.cuda.current_stream(index).cuda_stream,
                  getattr(prog, "smem_per_member", 0) * members)


def registers(kern) -> int:
    """A loaded kernel's registers a thread (libcuda's
    CU_FUNC_ATTRIBUTE_NUM_REGS)."""
    import ctypes

    from ydb_tpu_torch.ops.cuda import nvrtc
    fn = nvrtc._cuda().cuFuncGetAttribute
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    v = ctypes.c_int()
    return v.value if fn(ctypes.byref(v), 4, kern.function) == 0 else -1


def sass(source: str, entry: str, path: str) -> collections.Counter:
    """The source's cubin disassembled into `path`; its opcodes."""
    from ydb_tpu_torch.ops.cuda import build, nvrtc
    cubin = path + ".cubin"
    with open(cubin, "wb") as f:
        f.write(nvrtc.cubin(source, entry))
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    with open(path, "w") as f:
        f.write(text)
    ops = collections.Counter()
    op = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
    for line in text.splitlines():
        m = op.search(line)
        if m:
            ops[m.group(1)] += 1
    return ops


def looped(source: str, entry: str) -> bool:
    """Whether the generated kernel takes the member count (and loops
    over the members inside a thread)."""
    head = source[source.index(f"void {entry}("):]
    return head[:head.index(")")].rstrip().endswith("members")


def record(cs, eng, queries: dict, order_keys) -> dict:
    """{group: [(stage, env, params, sel, cap)]}: the stages each run
    hands over, recorded on a warm run."""
    from ydb_tpu_torch.bench import serving
    os.environ["YDB_TPU_LATE_MAT"] = "1"
    groups = {}
    for q in SINGLE:
        eng.query(queries[q])
        with cs.StageCapture() as cap:
            eng.query(queries[q])
        groups[q] = cap.stages
    texts = serving.variants("q19", BATCH, cs.SERVING_SEED)
    pb, _est, _g = cs.admitted_batch(
        eng, serving.point_variants(order_keys, 1, cs.SERVING_SEED)[0],
        POINT_MAX)
    points = serving.point_variants(order_keys, pb, cs.SERVING_SEED)
    for name, ts in ((f"q19 batched B={BATCH}", texts),
                     (f"point batched B={pb}", points)):
        cs._batched_call(eng, ts)
        with cs.StageCapture() as cap:
            cs.check(cs._batched_call(eng, ts) is not None,
                     f"{name}: the batch was declined")
        groups[name] = cap.stages
    return groups


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    help="an ops/k1.py: one more side (other1, other2, "
                    "... in order)")
    ap.add_argument("--sass", default=None,
                    help="a directory for the SASS of the member stages")
    args = ap.parse_args()
    cs = ab.start("k1_ab")
    if cs is None:
        return 2
    import torch

    from ydb_tpu_torch.bench.tpch_gen import load_tpch
    from ydb_tpu_torch.bench.tpch_oracle import QUERIES
    from ydb_tpu_torch.ops import k1
    from ydb_tpu_torch.query import QueryEngine

    sides = {"tree": k1}
    for i, path in enumerate(args.other, 1):
        sides[f"other{i}"] = load_side(path, f"other{i}")
        print(f"side other{i}: {path}", flush=True)
    launchers = {s: SideLauncher(m) for s, m in sides.items()}
    t0 = time.perf_counter()
    eng = QueryEngine()
    data = load_tpch(eng.catalog, sf=1.0)
    groups = record(cs, eng, QUERIES,
                    data.tables["orders"]["o_orderkey"])
    print("k1_ab: TPC-H SF1, "
          f"{sum(len(v) for v in groups.values())} stages recorded, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")

    def runner(side, stage, env, params, sel, n):
        return lambda: sides[side].run_stage_compiled(
            stage, dict(env), params, sel, n, dev, launchers[side])

    out = {}
    for group, stages in groups.items():
        tot = {s: 0.0 for s in sides} | {"bound_ms": 0.0}
        for i, (stage, env, params, sel, n) in enumerate(stages):
            want, ws = cs._k1_run(stage, env, params, sel, n, dev, True)
            flat_w = [t for pair in want for t in pair] + [ws]
            regs = {}
            for side in sides:
                launchers[side].launched = []
                for _ in range(2):
                    e = dict(env)
                    gs = sides[side].run_stage_compiled(
                        stage, e, params, sel, n, dev, launchers[side])
                    got = [e[c.name] for c in stage
                           if type(c).__name__ == "Assign"]
                    torch.cuda.synchronize()
                    _err, bits = cs._k1_compare(
                        [t for pair in got for t in pair] + [gs], flat_w,
                        f"k1_ab {group} stage {i} {side}")
                    cs.check(bits, f"k1_ab {group} stage {i} {side}: "
                             "not bit-equal to the plain version")
                regs[side] = sorted({registers(k)
                                     for k, _s in launchers[side].launched})
            rounds = {}
            for rnd in range(4):
                order = list(sides)[::-1] if rnd % 2 == 0 else list(sides)
                for side in order:
                    rounds.setdefault(side, []).append(cs.time_ms(
                        runner(side, stage, env, params, sel, n), iters=9,
                        warmup=2))
            bound = cs.bound_ms(cs._k1_bytes(stage, env, params, sel, want,
                                             ws))
            mid = {s: statistics.median(v) for s, v in rounds.items()}
            for s in sides:
                tot[s] += mid[s]
            tot["bound_ms"] += bound
            members = max([t.shape[0] for pair in want for t in pair
                           if t is not None and t.dim() == 2]
                          + [ws.shape[0] if ws is not None
                             and ws.dim() == 2 else 1])
            print(f"k1_ab {group} stage {i}: rows={n} members={members} "
                  + " ".join(f"{s}_ms={mid[s]:.4f}" for s in sides)
                  + " registers=" + json.dumps(regs)
                  + f" bound_ms={bound:.4f} rounds="
                  + json.dumps({s: [round(x, 4) for x in v]
                                for s, v in rounds.items()}), flush=True)
            if args.sass and members > 1:
                os.makedirs(args.sass, exist_ok=True)
                for side in sides:
                    for j, (_k, src) in enumerate(dict.fromkeys(
                            launchers[side].launched)):
                        tag = re.sub(r"\W+", "_", f"{group}_{i}_{j}_{side}")
                        ops = sass(src, sides[side].ENTRY,
                                   os.path.join(args.sass, tag + ".sass"))
                        print(f"k1_ab sass {group} stage {i} {side}: "
                              f"instructions={sum(ops.values())} "
                              + json.dumps(dict(ops.most_common(16))),
                              flush=True)
        out[group] = {k: round(v, 4) for k, v in tot.items()}
        print(f"k1_ab {group}: stages={len(stages)} " + " ".join(
            f"{k}={v:.4f}" for k, v in tot.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
