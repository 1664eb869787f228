"""What the kernels' A/B tools share (``segments_ab``, ``probe_ab``,
``partition_ab``, ``bucket_agg_ab``, ``dq_ab``), each on one GPU in one
process: the card's line; the sides, that is the tree's libraries and,
for each ``--other``, the libraries built from its sources (one ``nvcc``
a source, all started together; a library it does not give stays the
tree's); a side swapped in under the tree's wrappers; the sides held to
the plain version; CUDA-event times in rounds that alternate which side
runs first; and a call's device ms by kernel under torch.profiler.

A tool calls ``start`` first, which puts the repo on ``sys.path`` (for
``chip_smoke``) and returns ``None`` where there is no card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def start(tool: str):
    """The card's name and power limit, printed; ``chip_smoke`` as a
    module (its checks and timers), or None, printed, without a card."""
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device")
        return None
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return cs


def sources(path: str, libs: dict) -> dict:
    """{library: source} of one ``--other``: a directory gives each
    ``<library>.cu`` it holds (a parent's ``csrc`` from ``git archive``,
    say); a file, the library whose entry point (``libs``' C symbol) it
    defines, or the tool's one library."""
    p = Path(path)
    if p.is_dir():
        out = {lib: p / f"{lib}.cu" for lib in libs
               if (p / f"{lib}.cu").exists()}
    elif len(libs) == 1:
        out = {next(iter(libs)): p}
    else:
        text = p.read_text()
        out = {lib: p for lib, sym in libs.items() if f"int {sym}(" in text}
    if not out:
        raise SystemExit(f"{path}: none of {[f'{k}.cu' for k in libs]}")
    return out


def _print_ptxas(cs, side: str, lib: str, log: str) -> None:
    for fn in cs.ptxas_functions(log):
        print(f"  ptxas {side} {lib} {fn['name']}: registers="
              f"{fn['registers']} stack_frame={fn['stack']} spill_stores="
              f"{fn['spill_stores']} spill_loads={fn['spill_loads']}",
              flush=True)


def build_sides(cs, libs: dict, others: list) -> dict:
    """{side: {library: path}}: "tree", then other1, other2, ... in the
    order of ``others`` (``--other`` paths, see ``sources``). Prints each
    build's ptxas lines; a failed build fails the run."""
    from ydb_tpu_torch.ops.cuda import build

    built = build.build_all(tuple(libs), verbose=True)
    sides = {"tree": {lib: built[lib]["path"] for lib in libs}}
    for lib in libs:
        _print_ptxas(cs, "tree", lib, built[lib]["log"])
    procs = []
    for i, path in enumerate(others, 1):
        name = f"other{i}"
        sides[name] = dict(sides["tree"])
        for lib, src in sources(path, libs).items():
            print(f"side {name}: {lib} from {src}", flush=True)
            out = os.path.join(str(build.BUILD_DIR), f"lib{lib}-{name}.so")
            procs.append((name, lib, out, subprocess.Popen(
                [build.nvcc_path(), build.ARCH, "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
                 str(src.parent), "-I", str(build.CSRC), "-o", out,
                 str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, lib, out, proc in procs:
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name} {lib}: nvcc failed\n{log}")
        _print_ptxas(cs, name, lib, log)
        sides[name][lib] = out
    return sides


_LOADED: dict = {}


def load(path: str):
    """A library, loaded once."""
    if path not in _LOADED:
        _LOADED[path] = ctypes.CDLL(path)
    return _LOADED[path]


def use(libs: dict) -> None:
    """Swap a side's libraries in under the tree's wrappers (which set
    each entry point's argument types at every call)."""
    from ydb_tpu_torch.ops.cuda import bindings as B
    for lib, path in libs.items():
        B._LIBS[lib] = load(path)


def release(libs) -> None:
    """Leave the wrappers to build and load the tree's libraries again."""
    from ydb_tpu_torch.ops.cuda import bindings as B
    for lib in libs:
        B._LIBS.pop(lib, None)


def check_sides(cs, sides: dict, run, ok, what: str, repeat: int = 2):
    """Each side's `run()`, `repeat` times, must satisfy `ok`."""
    import torch
    for side, libs in sides.items():
        use(libs)
        for _ in range(repeat):
            got = run()
            torch.cuda.synchronize()
            cs.check(ok(got), f"{what} {side}: not the plain version")


def alternate(cs, sides: dict, run, rounds: int = 4, iters: int = 9,
              warmup: int = 2) -> dict:
    """{side: [ms a round]}: `run`'s CUDA-event median per side, in
    rounds that alternate which side runs first, so a drift over the
    call falls on every side alike."""
    names = list(sides)
    times = {side: [] for side in names}
    for rnd in range(rounds):
        for side in (names[::-1] if rnd % 2 == 0 else names):
            use(sides[side])
            times[side].append(cs.time_ms(run, iters=iters, warmup=warmup))
    return times


def device_ms(fn) -> dict:
    """`fn` once more under torch.profiler (after a warm call): device
    ms by kernel (and memset or copy)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0) or 0)
        if us > 0 and e.device_type == DeviceType.CUDA:
            out[e.key[:40]] = us / 1e3
    return out
