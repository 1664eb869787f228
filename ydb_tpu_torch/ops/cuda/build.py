"""Build the CUDA kernels: one ``nvcc`` per source, all started together,
each into a shared library with a plain C interface.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

Libraries land in ``ydb_tpu_torch/_build/`` (ignored by git) under a name
that carries a hash of the source and of the local headers it includes
(``#include "x.cuh"``), so an edited kernel or header is rebuilt and a
built one is reused. Nothing here runs at import time."""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
KERNELS = ("bucket_agg", "compact", "probe", "sort", "segment_agg",
           "hash64", "window_scan", "expand", "partition", "segments",
           "quant", "dq_counts", "bucket_sort")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")


_LOCAL_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.MULTILINE)


def _source_bytes(path: Path, seen: set) -> bytes:
    """The source with every local header it includes, recursively."""
    if path in seen:
        return b""
    seen.add(path)
    src = path.read_bytes()
    return src + b"".join(_source_bytes(CSRC / inc.decode(), seen)
                          for inc in _LOCAL_INCLUDE.findall(src))


def library_path(name: str) -> Path:
    digest = hashlib.sha1(
        _source_bytes(CSRC / f"{name}.cu", set())).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=KERNELS, verbose: bool = False) -> dict:
    """Compile every kernel whose library is missing, in parallel.
    Returns {name: {"path", "seconds", "log"}}; raises if any nvcc fails.
    `verbose` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists() and not verbose:
            out[name] = {"path": str(lib), "seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = {"path": str(lib),
                     "seconds": round(time.perf_counter() - t0, 3),
                     "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out
