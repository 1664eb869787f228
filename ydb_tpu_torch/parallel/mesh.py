"""The device mesh of the distributed lanes (replaces the reference's
``jax.sharding.Mesh`` and ``parallel/_compat.py``'s ``shard_map``).

A ``Mesh`` lists its shards' devices in ``devices``, a numpy object
array of ``torch.device``, so ``mesh.devices.size`` and
``mesh.devices.flat`` read as they do on a jax mesh. A per-device body
is a Python loop over ``devices.flat``: each shard's kernels run on its
device's current stream, and the collectives of ``parallel/collective.py``
are copies between the shards' devices.

``make_mesh(n)`` takes the first ``n`` CUDA cards, as the reference takes
``jax.devices()[:n]``. ``make_mesh(n, device="cuda:0")`` (or ``"cpu"``)
lists that one device ``n`` times: n shards that share one device, the
counterpart of the reference's virtual CPU mesh. Every shard's kernels
then do their own work on that device, and an exchange is a copy inside
its memory."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


class Mesh:
    """One axis of shards, each on a ``torch.device``."""

    def __init__(self, devices):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        arr = np.empty(len(devs), dtype=object)
        arr[:] = devs
        self.devices = arr

    @property
    def shared_device(self) -> Optional[torch.device]:
        """The one device every shard lives on, or None when the shards
        are on different devices."""
        first = self.devices.flat[0]
        return first if all(d == first for d in self.devices.flat) \
            else None

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """A mesh of `n_devices` shards: the first `n_devices` CUDA cards
    (all of them by default), or, with `device`, that one device listed
    `n_devices` times. Raises when CUDA is implied and no GPU is present,
    or when fewer cards exist than asked for."""
    if device is not None:
        from ydb_tpu_torch.device import resolve_device
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh([dev] * int(n_devices or 1))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ydb_tpu_torch runs on CUDA and no GPU is available; pass "
            "device='cpu' for a mesh of CPU shards")
    have = torch.cuda.device_count()
    n = n_devices or have
    if n > have:
        raise RuntimeError(f"a mesh of {n} cards asked for, {have} present; "
                           "pass device= to place every shard on one device")
    return Mesh([torch.device("cuda", i) for i in range(n)])
