"""The slice of the numpy namespace that the scalar kernels use
(``ops/kernels.py``), over torch tensors.

The kernels take their array namespace as an argument (``xp``): numpy
for the host oracle, this shim for the port's device path. torch differs
from numpy where the kernels touch it: tensors have no ``astype``,
``maximum``/``clip`` take tensors where numpy takes scalars, and
``uint64`` arithmetic is partial — the port holds unsigned 64-bit
values as their int64 bit patterns (``torch_dtype``), which is exact
for the counts and sums the slice produces and is converted back to
``uint64`` at readback (``ops/device.host_column``)."""

from __future__ import annotations

import numpy as np
import torch

_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.int32,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.uint64): torch.int64,      # bit pattern (see module doc)
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dt) -> torch.dtype:
    """Storage dtype of a numpy dtype (or type, or torch dtype) in the port."""
    if isinstance(dt, torch.dtype):
        return dt
    if dt is bool:
        return torch.bool
    return _TORCH[np.dtype(dt)]


def storage_array(a: np.ndarray) -> np.ndarray:
    """A host array in its port storage dtype (unsigned 64/32/16-bit
    arrays are reinterpreted or widened)."""
    if a.dtype == np.uint64:
        return a.view(np.int64)
    if a.dtype in (np.uint32, np.uint16):
        return a.astype(np.int64 if a.dtype == np.uint32 else np.int32)
    return a


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """Host array → tensor on `device` in its port storage dtype."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(storage_array(a)).to(device)


def astype(xp, x, dt):
    """``x.astype(dt)`` in either namespace."""
    if xp is np:
        return x.astype(dt)
    return x.to(torch_dtype(dt))


class _TorchNS:
    """numpy-named functions over tensors (only those the kernels use)."""

    @staticmethod
    def is_integer(x) -> bool:
        return not x.dtype.is_floating_point and x.dtype != torch.bool

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def maximum(x, y):
        if isinstance(y, torch.Tensor):
            return torch.maximum(x, y)
        if isinstance(y, float) and not x.dtype.is_floating_point:
            x = x.to(torch.float64)     # numpy's and JAX's promotion
        return torch.clamp_min(x, y)

    @staticmethod
    def zeros_like(x, dtype=None):
        return torch.zeros_like(x, dtype=None if dtype is None
                                else torch_dtype(dtype))

    @staticmethod
    def ones_like(x, dtype=None):
        return torch.ones_like(x, dtype=None if dtype is None
                               else torch_dtype(dtype))

    @staticmethod
    def sqrt(x):
        return torch.sqrt(_inexact(x))

    @staticmethod
    def exp(x):
        return torch.exp(_inexact(x))

    @staticmethod
    def log(x):
        return torch.log(_inexact(x))

    abs = staticmethod(torch.abs)
    floor = staticmethod(torch.floor)
    ceil = staticmethod(torch.ceil)
    sign = staticmethod(torch.sign)
    power = staticmethod(torch.pow)


def _inexact(x):
    """JAX's float for an int operand of sqrt, exp and log: float64 for
    int64, float32 (torch's own choice) for narrower ints and bools."""
    return x.to(torch.float64) if x.dtype == torch.int64 else x


TXP = _TorchNS()
