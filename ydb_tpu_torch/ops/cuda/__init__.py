"""Hand-written CUDA kernels of the port (``csrc/*.cu``, built for
``sm_90a`` by ``build.py`` and bound with ctypes in ``bindings.py``)."""
