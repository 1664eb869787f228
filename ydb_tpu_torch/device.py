"""Device choice for the port's entry points.

Entry points run on ``cuda``. A caller that wants the CPU (the tests,
which run the kernels' plain versions) asks for it with ``device="cpu"``;
without a GPU and without that request, ``resolve_device`` raises rather
than carrying on on the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (or implied)
    and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ydb_tpu_torch runs on CUDA and no GPU is available; pass "
            "device='cpu' to run the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
