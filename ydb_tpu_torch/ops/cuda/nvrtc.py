"""Runtime compilation of generated CUDA C++ (K1's stages, ``ops/k1.py``)
with NVRTC, loaded and launched through the CUDA driver API; both
libraries are reached through ctypes.

K1 is a kernel per expression stage, as XLA's fusion is a program per
query: the suites run some hundreds of distinct stages. NVRTC compiles
each in-process, for ``sm_90a`` with ``--fmad=false``, with no compiler
process to start (the nine fixed kernel libraries keep their ``nvcc``
build, ``build.py``).

- **Compile:** ``nvrtcCreateProgram`` → ``nvrtcCompileProgram`` →
  ``nvrtcGetCUBIN``; a failure raises with NVRTC's log and the source.
- **Cache:** each cubin by a digest of its full source (the prelude
  included) and options, in memory and on disk under
  ``ydb_tpu_torch/_build/k1/<digest>.cubin`` (ignored by git).
- **Load:** ``cuModuleLoadData`` / ``cuModuleGetFunction`` in the
  primary context of torch's device, made current on the calling thread
  (a driver call through ctypes does not do that as the runtime does).
- **Launch:** ``cuLaunchKernel`` on ``torch.cuda.current_stream()``,
  without synchronising; a non-zero result raises. Each launch adds one
  to ``bindings.LAUNCHES["k1"]``.

Counters (``utils.metrics.GLOBAL``): ``k1/builds`` (NVRTC compilations),
``k1/build_ms`` (their milliseconds) and ``k1/cache_hits`` (sources
whose cubin was already built, in this process or on disk). Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import sys
import threading
import time
from pathlib import Path

import torch

from ydb_tpu_torch.ops.cuda import build
from ydb_tpu_torch.utils.metrics import GLOBAL

ARCH = "sm_90a"
OPTIONS = (f"--gpu-architecture={ARCH}", "--std=c++17", "--fmad=false")
CACHE_DIR = build.BUILD_DIR / "k1"

_MU = threading.Lock()
_TLS = threading.local()
_LIBS: dict = {}
_CTX: dict = {}                    # device index -> CUcontext
_KERNELS: dict = {}                # (digest, device index) -> Kernel


def _nvrtc_candidates() -> list:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    dirs = [os.path.join(home, "lib64"), os.path.join(home, "lib")]
    dirs += [os.path.join(p, "nvidia", "cuda_nvrtc", "lib") for p in sys.path
             if p and os.path.isdir(os.path.join(p, "nvidia"))]
    out = []
    for d in dirs:
        out += sorted(f for f in glob.glob(os.path.join(d, "libnvrtc.so*"))
                      if "builtins" not in f)
    return out


def _nvrtc():
    lib = _LIBS.get("nvrtc")
    if lib is not None:
        return lib
    for path in _nvrtc_candidates():
        # NVRTC opens its builtins library by name: load it from the
        # same directory first
        for b in sorted(glob.glob(os.path.join(os.path.dirname(path),
                                               "libnvrtc-builtins.so*"))):
            try:
                ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
                break
            except OSError:
                continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        _declare(lib, _NVRTC_SIGS)
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        _LIBS["nvrtc"] = lib
        return lib
    raise RuntimeError("libnvrtc not found (looked in $CUDA_HOME/lib64 and "
                       "the nvidia/cuda_nvrtc package)")


_P, _PP, _I, _U = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_int, ctypes.c_uint)
_PI, _PS = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_size_t)
_NVRTC_SIGS = {
    "nvrtcVersion": [_PI, _PI],
    "nvrtcGetErrorString": [_I],
    "nvrtcCreateProgram": [_PP, ctypes.c_char_p, ctypes.c_char_p, _I, _P,
                           _P],
    "nvrtcCompileProgram": [_P, _I, ctypes.POINTER(ctypes.c_char_p)],
    "nvrtcGetProgramLogSize": [_P, _PS],
    "nvrtcGetProgramLog": [_P, ctypes.c_char_p],
    "nvrtcGetCUBINSize": [_P, _PS],
    "nvrtcGetCUBIN": [_P, ctypes.c_char_p],
    "nvrtcDestroyProgram": [_PP],
}
_CUDA_SIGS = {
    "cuInit": [_U],
    "cuGetErrorString": [_I, ctypes.POINTER(ctypes.c_char_p)],
    "cuDeviceGet": [_PI, _I],
    "cuDevicePrimaryCtxRetain": [_PP, _I],
    "cuCtxSetCurrent": [_P],
    "cuModuleLoadData": [_PP, ctypes.c_char_p],
    "cuModuleGetFunction": [_PP, _P, ctypes.c_char_p],
    "cuLaunchKernel": [_P, _U, _U, _U, _U, _U, _U, _U, _P, _PP, _PP],
}


def _declare(lib, sigs: dict) -> None:
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def _cuda():
    lib = _LIBS.get("cuda")
    if lib is None:
        lib = _LIBS["cuda"] = ctypes.CDLL("libcuda.so.1")
        _declare(lib, _CUDA_SIGS)
        _check_cu(lib.cuInit(0), "cuInit")
    return lib


def _check_nvrtc(rc: int, what: str) -> None:
    if rc != 0:
        msg = _nvrtc().nvrtcGetErrorString(rc)
        raise RuntimeError(f"{what}: NVRTC error {rc} "
                           f"({msg.decode() if msg else '?'})")


def _check_cu(rc: int, what: str) -> None:
    if rc != 0:
        s = ctypes.c_char_p()
        _LIBS["cuda"].cuGetErrorString(rc, ctypes.byref(s))
        raise RuntimeError(f"{what}: CUDA driver error {rc} "
                           f"({s.value.decode() if s.value else '?'})")


def version() -> tuple:
    """NVRTC's (major, minor)."""
    major, minor = ctypes.c_int(), ctypes.c_int()
    _check_nvrtc(_nvrtc().nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def compile_cubin(source: str, name: str = "k1.cu") -> bytes:
    """NVRTC over `source` for ``sm_90a``; raises with the log and the
    source on failure."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), name.encode(), 0, None, None),
        "nvrtcCreateProgram")
    try:
        opts = (ctypes.c_char_p * len(OPTIONS))(*[o.encode()
                                                   for o in OPTIONS])
        rc = lib.nvrtcCompileProgram(prog, len(OPTIONS), opts)
        if rc != 0:
            size = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            buf = ctypes.create_string_buffer(size.value + 1)
            lib.nvrtcGetProgramLog(prog, buf)
            raise RuntimeError(
                f"NVRTC failed to compile {name}:\n"
                f"{buf.value.decode(errors='replace')}\n--- source ---\n"
                f"{source}")
        size = ctypes.c_size_t()
        _check_nvrtc(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        buf = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib.nvrtcGetCUBIN(prog, buf), "nvrtcGetCUBIN")
        return buf.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _context(index: int):
    """The primary context of device `index`, current on this thread."""
    cu = _cuda()
    ctx = _CTX.get(index)
    if ctx is None:
        dev, c = ctypes.c_int(), ctypes.c_void_p()
        _check_cu(cu.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
        _check_cu(cu.cuDevicePrimaryCtxRetain(ctypes.byref(c), dev),
                  "cuDevicePrimaryCtxRetain")
        ctx = _CTX[index] = c
    current = getattr(_TLS, "current", None)
    if current != index:
        _check_cu(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
        _TLS.current = index
    return ctx


class Kernel:
    """A loaded ``__global__`` function."""

    def __init__(self, module, function, index: int):
        self.module = module
        self.function = function
        self.index = index

    def launch(self, grid: tuple, block: tuple, args: list,
               stream: int) -> None:
        _context(self.index)
        params = (ctypes.c_void_p * max(len(args), 1))(
            *[ctypes.addressof(a) for a in args])
        _check_cu(_LIBS["cuda"].cuLaunchKernel(
            self.function, grid[0], grid[1], grid[2], block[0], block[1],
            block[2], 0, stream, params, None), "cuLaunchKernel")


def kernel(source: str, entry: str, index: int) -> Kernel:
    """The `entry` function of `source` on device `index`: compiled by
    NVRTC on first use (or loaded from the cubin cache) and memoized by
    the source's digest."""
    digest = hashlib.sha256(
        (source + "\0" + " ".join(OPTIONS) + "\0" + entry).encode()
    ).hexdigest()[:32]
    k = _KERNELS.get((digest, index))
    if k is not None:
        return k
    with _MU:
        k = _KERNELS.get((digest, index))
        if k is not None:
            return k
        path = CACHE_DIR / f"{digest}.cubin"
        cubin = _CUBINS.get(digest)
        if cubin is None and path.exists():
            cubin = path.read_bytes()
        if cubin is None:
            t0 = time.perf_counter()
            cubin = compile_cubin(source, f"{entry}_{digest[:8]}.cu")
            GLOBAL.inc("k1/builds")
            GLOBAL.inc("k1/build_ms", (time.perf_counter() - t0) * 1e3)
            _write_atomic(path, cubin)
        else:
            GLOBAL.inc("k1/cache_hits")
        _CUBINS[digest] = cubin
        cu = _cuda()
        _context(index)
        module, fn = ctypes.c_void_p(), ctypes.c_void_p()
        _check_cu(cu.cuModuleLoadData(ctypes.byref(module), cubin),
                  "cuModuleLoadData")
        _check_cu(cu.cuModuleGetFunction(ctypes.byref(fn), module,
                                         entry.encode()),
                  "cuModuleGetFunction")
        k = _KERNELS[(digest, index)] = Kernel(module, fn, index)
        return k


_CUBINS: dict = {}                 # digest -> cubin


def _write_atomic(path: Path, data: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


class _Launcher:
    """K1's launcher on the card: one program's kernel over `n` rows
    (and `grid_y` member rows) on torch's current stream."""

    def launch(self, prog, args: list, n: int, grid_y: int,
               device) -> None:
        from ydb_tpu_torch.ops import k1
        from ydb_tpu_torch.ops.cuda import bindings
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        kern = prog.kernels.get(index)
        if kern is None:
            kern = prog.kernels[index] = kernel(prog.source, k1.ENTRY, index)
        stream = torch.cuda.current_stream(index).cuda_stream
        kern.launch(((n + k1.THREADS - 1) // k1.THREADS, grid_y, 1),
                    (k1.THREADS, 1, 1), args + [ctypes.c_int64(n)], stream)
        bindings.count_launch("k1")


LAUNCHER = _Launcher()
