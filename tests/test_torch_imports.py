"""The port stands alone: no module of raft_tpu_torch, and not
chip_smoke.py, imports jax or raft_tpu; entry points default to the card
and raise without one; kernel wrappers raise rather than fall back."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raft_tpu_torch
from raft_tpu_torch.core.error import CudaError
from raft_tpu_torch.core.resources import Resources, as_tensor, resolve_device
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops import fused_knn as fk
from raft_tpu_torch.ops import pq_scan as ps
from raft_tpu_torch.ops import stream_select as ss

ROOT = Path(__file__).resolve().parents[1]

_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(raft_tpu_torch.__path__,
                                          prefix="raft_tpu_torch."))


def test_module_list_covers_the_slice():
    for name in ("core.resources", "core.mdarray", "core.serialize",
                 "ops.fused_knn", "ops._build",
                 "ops.pq_scan", "neighbors.ivf_flat", "neighbors.ivf_pq",
                 "neighbors.refine", "cluster.kmeans_balanced",
                 "matrix.select_k", "distance.fused_l2_nn",
                 "ops.stream_select", "comms.topk_merge", "lifecycle.delete",
                 "lifecycle.compact", "core.retry", "core.logger",
                 "obs.trace", "serve.bucketing", "serve.cache",
                 "serve.hedge", "serve.scheduler", "serve.searcher",
                 "serve.stats", "util.telemetry", "comms.comms",
                 "comms.comms_test", "comms.health", "parallel.degraded",
                 "parallel.knn", "parallel.kmeans", "parallel.ivf",
                 "util.atomic_io", "comms.agree", "serve.recovery",
                 "testing.chaos", "lifecycle.wal", "lifecycle.elastic",
                 "obs.registry", "obs.recall"):
        assert f"raft_tpu_torch.{name}" in _MODULES


def test_no_module_imports_jax_or_raft_tpu():
    """Import every module (and chip_smoke) in a fresh interpreter where
    ``import jax`` and ``import raft_tpu`` fail."""
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['raft_tpu'] = None",
        f"for name in {_MODULES!r}:",
        "    importlib.import_module(name)",
        "import chip_smoke",
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'raft_tpu' or m.startswith('raft_tpu.')]",
        "assert all(sys.modules[m] is None for m in bad), bad",
        "print('ok', len(sys.modules))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_is_cuda():
    assert Resources.__init__.__defaults__ == (None,)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(CudaError, match="cuda"):
            resolve_device()
        with pytest.raises(CudaError):
            Resources()


def test_numpy_inputs_go_to_the_card_or_raise(rng):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: nothing to refuse")
    x = rng.standard_normal((20, 4)).astype(np.float32)
    with pytest.raises(CudaError):
        brute_force.knn(x, x, 3)
    with pytest.raises(CudaError):
        ivf_flat.build(ivf_flat.IndexParams(n_lists=2), x)
    with pytest.raises(CudaError):
        ivf_flat.index_from_numpy(x[:2], x[:2, None], np.zeros((2, 1),
                                                                np.int32),
                                  np.ones(2, np.int32), 0)
    with pytest.raises(CudaError):
        ivf_pq.build(ivf_pq.IndexParams(n_lists=2, pq_dim=2), x)
    # Tensors stay where they are; the CPU is chosen by asking for it.
    assert as_tensor(torch.ones(2)).device.type == "cpu"
    assert as_tensor(x, device="cpu").device.type == "cpu"
    assert Resources("cpu").device.type == "cpu"


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A CUDA request whose kernel cannot be built raises CudaError: no
    wrapper carries on with the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(CudaError):
        _build.load_library("fused_knn")
    q = torch.zeros((4, 8))
    with pytest.raises(CudaError):
        fk._fused_knn_cuda(q, q, 2, True, False, False)
    with pytest.raises(CudaError):
        fk._fused_batch_knn_cuda(q[None], q[None], torch.zeros((1, 4),
                                                              dtype=torch.bool),
                                 2, True, False, False)
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(CudaError):
        _build.load_library("pq_scan")
    with pytest.raises(CudaError):
        fk._fused_cells_knn_cuda(torch.zeros(1, dtype=torch.int32),
                                 q[None], q[None],
                                 torch.zeros((1, 4), dtype=torch.bool), 2,
                                 True, False, False)
    with pytest.raises(CudaError):
        ss._stream_extract_cuda(q)
    assert list((tmp_path / "build").iterdir()) == []


def test_library_name_follows_the_sources():
    path = _build._library_path("fused_knn")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libfused_knn-") and path.suffix == ".so"
    assert _build.sources() == ["batch_knn", "cells_knn", "fused_knn",
                                "pq_scan", "stream_select"]
    # Every library's name also follows the shared header.
    assert any(p.name == "knn_tile.cuh"
               for p in _build.CSRC_DIR.glob("*.cuh"))


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    """chip_smoke.py in a directory with nothing else of the repo exits
    non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_bytes(
        (ROOT / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
