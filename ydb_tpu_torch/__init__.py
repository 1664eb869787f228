"""ydb_tpu_torch — the PyTorch/CUDA port of ydb_tpu.

The same SQL surface, plans and answers as ``ydb_tpu``, with the data
plane in torch tensors on an NVIDIA GPU (Hopper, ``sm_90a``) instead of
jax arrays on a TPU. The package mirrors ``ydb_tpu``'s layout
(``core/``, ``ops/``, ``query/``, ``scheme/``, ``sql/``, ``storage/``,
``bench/``) so every module has an obvious counterpart; device-agnostic
modules are copies of the reference with the import prefix rewritten
(``tests/test_torch_drift.py`` keeps them equal).

It imports neither jax nor anything of ``ydb_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (``device.py``);
paths that are not ported yet raise ``errors.NotPorted``.
"""

# the reference's pandas setting, kept so both packages build identical
# result frames: pandas 3 defaults str columns to pyarrow-backed storage,
# whose construction off the main thread has crashed the reference's
# servers; numpy-backed str storage keeps the same dtype semantics.
import pandas as _pd

_pd.set_option("mode.string_storage", "python")

__version__ = "0.1.0"
