"""The port stands alone: no jax and nothing of ydb_tpu at run time, and
no silent CPU fallback."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
from tests import torch_threads  # noqa: F401,E402

ROOT = Path(__file__).resolve().parent.parent
# `ydb_tpu_torch` starts with `ydb_tpu`: match the reference package only
_BAD_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|ydb_tpu(?!_torch)\b)",
    re.MULTILINE)


def _port_sources():
    files = sorted(p for p in (ROOT / "ydb_tpu_torch").rglob("*.py")
                   if "_build" not in p.parts)
    assert files
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_import(path):
    hits = _BAD_IMPORT.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, ydb_tpu_torch, ydb_tpu_torch.query, "
            "ydb_tpu_torch.interop, ydb_tpu_torch.ops.cuda.bindings, "
            "ydb_tpu_torch.utils.hashing, ydb_tpu_torch.bench.tpch_oracle, "
            "ydb_tpu_torch.bench.tpcds_oracle, ydb_tpu_torch.bench.tpcds_gen, "
            "ydb_tpu_torch.bench.clickbench_oracle, "
            "ydb_tpu_torch.bench.clickbench_gen, "
            "ydb_tpu_torch.ops.window_dev, ydb_tpu_torch.query.window, "
            "ydb_tpu_torch.ops.spill, "
            "ydb_tpu_torch.query.admission, ydb_tpu_torch.query.batch_lane, "
            "ydb_tpu_torch.bench.serving, "
            "ydb_tpu_torch.ops.k1, ydb_tpu_torch.ops.cuda.nvrtc, "
            "ydb_tpu_torch.bench.k1_sweep, "
            "ydb_tpu_torch.parallel, ydb_tpu_torch.parallel.shuffle_join, "
            "ydb_tpu_torch.utils.config, ydb_tpu_torch.dq, "
            "ydb_tpu_torch.dq.ici, ydb_tpu_torch.dq.task, "
            "ydb_tpu_torch.cluster, ydb_tpu_torch.cluster.exchange, "
            "ydb_tpu_torch.server.service, "
            "ydb_tpu_torch.bench.cluster_load\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib') or "
            "m == 'ydb_tpu' or m.startswith('ydb_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_engine_without_cuda_raises_instead_of_running_on_cpu():
    import torch
    from ydb_tpu_torch.query import QueryEngine
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine()
    assert QueryEngine(device="cpu").device.type == "cpu"


def test_cuda_tensor_never_takes_the_plain_version():
    """The wrappers choose the plain version by the device alone: asked
    for CUDA, a wrapper checks its inputs for the kernel launch and
    raises on CPU tensors instead of running the plain version."""
    import torch
    from ydb_tpu_torch.ops.cuda import bindings
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(ValueError, match="expected cuda"):
        bindings.sort_perm([torch.zeros(4, dtype=torch.int64)], 4, "cuda")


def test_hashing_on_tensors_goes_through_the_kernel_wrapper(monkeypatch):
    """The port's hashing has no jax branch left: on tensors it calls the
    hash64 wrapper (which launches the kernel for CUDA tensors), never a
    jax.numpy path."""
    import torch
    from ydb_tpu_torch.ops.cuda import bindings
    from ydb_tpu_torch.ops.torch_ns import TXP
    from ydb_tpu_torch.utils import hashing
    seen = []
    real = bindings.hash64
    monkeypatch.setattr(bindings, "hash64",
                        lambda cols, pre=None: seen.append(pre)
                        or real(cols, pre))
    x = torch.arange(8, dtype=torch.int64)
    hashing.hash_combine(TXP, hashing.splitmix64(TXP, x), x)
    assert seen == [None, [False, False]]
