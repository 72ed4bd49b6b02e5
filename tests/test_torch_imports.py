"""The port stands alone: no module of raft_tpu_torch or of its facades
(pylibraft_torch, raft_dask_torch), and not chip_smoke.py, imports jax,
raft_tpu, pylibraft or raft_dask; entry points default to the card and
raise without one; kernel wrappers raise rather than fall back."""

import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pylibraft_torch
import raft_dask_torch
import raft_tpu_torch
from raft_tpu_torch.core.error import CudaError
from raft_tpu_torch.core.resources import Resources, as_tensor, resolve_device
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops import pq_scan as ps
from raft_tpu_torch.ops import stream_select as ss

fk = importlib.import_module("raft_tpu_torch.ops.fused_knn")

ROOT = Path(__file__).resolve().parents[1]

_PACKAGES = (raft_tpu_torch, pylibraft_torch, raft_dask_torch)
_MODULES = sorted(
    m.name for pkg in _PACKAGES
    for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."))
# Top-level packages no module of the port may import (compared whole:
# pylibraft_torch starts with pylibraft).
_FORBIDDEN = ("jax", "raft_tpu", "pylibraft", "raft_dask")


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
                 "obs.registry", "obs.recall", "util.input_validation",
                 "util.itertools", "core.kvp", "core.operators", "core.math",
                 "core.nvtx", "core.interruptible", "core.checks",
                 "core.temporary_buffer", "core.compilation_cache",
                 "linalg.blas", "linalg.elementwise", "linalg.matrix_vector",
                 "linalg.norm", "linalg.reduce", "linalg.decomp",
                 "matrix.ops", "distance.kernels", "distance.masked_nn",
                 "random.rng", "random.make_blobs", "random.make_regression",
                 "random.rmat", "cluster.kmeans", "cluster.kmeans_types",
                 "stats.descriptive", "stats.classification",
                 "stats.regression", "stats.cluster_metrics",
                 "label.classlabels", "label.merge_labels", "_native",
                 "sparse.types", "sparse.convert", "sparse.op",
                 "sparse.linalg", "sparse.distance", "sparse.neighbors",
                 "sparse.solver.mst", "sparse.solver.lanczos",
                 "linalg.lanczos", "solver", "solver.linear_assignment",
                 "spectral", "spectral.partition", "neighbors.ball_cover",
                 "neighbors.epsilon_neighborhood", "spatial", "spatial.knn",
                 "cluster.single_linkage"):
        assert f"raft_tpu_torch.{name}" in _MODULES


def test_module_list_covers_the_facades():
    for name in ("common", "common.ai_wrapper", "common.cuda",
                 "common.device_ndarray", "common.handle",
                 "common.input_validation", "common.interruptible",
                 "common.outputs", "distance", "distance.pairwise_distance",
                 "distance.fused_l2_nn", "neighbors", "neighbors.common",
                 "neighbors.brute_force", "neighbors.ivf_flat",
                 "neighbors.ivf_pq", "neighbors.refine", "cluster",
                 "cluster.kmeans", "random",
                 "random.rmat_rectangular_generator"):
        assert f"pylibraft_torch.{name}" in _MODULES
    for name in ("common", "common.comms", "common.comms_utils"):
        assert f"raft_dask_torch.{name}" in _MODULES


def test_no_module_imports_jax_or_raft_tpu():
    """Import every module (and chip_smoke) in a fresh interpreter where
    ``import jax``, ``import raft_tpu``, ``import pylibraft`` and ``import
    raft_dask`` fail."""
    code = "\n".join([
        "import importlib, sys",
        f"for top in {_FORBIDDEN!r}:",
        "    sys.modules[top] = None",
        f"for name in {_MODULES!r}:",
        "    importlib.import_module(name)",
        "import chip_smoke",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r}]",
        "assert all(sys.modules[m] is None for m in bad), bad",
        "print('ok', len(sys.modules))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_each_package_imports_first():
    """Every package of the port imports in a fresh module table whatever
    was imported before it (the package exports leave no import cycle)."""
    packages = sorted(m.name for pkg in _PACKAGES
                      for m in pkgutil.walk_packages(
                          pkg.__path__, prefix=pkg.__name__ + ".")
                      if m.ispkg)
    packages += [pkg.__name__ for pkg in _PACKAGES[1:]]
    code = "\n".join([
        "import importlib, sys",
        f"for name in {packages!r}:",
        "    for mod in [m for m in sys.modules if m.split('.')[0] in",
        "                ('raft_tpu_torch', 'pylibraft_torch',",
        "                 'raft_dask_torch')]:",
        "        del sys.modules[mod]",
        "    importlib.import_module(name)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_is_cuda():
    # (device, other): no device means cuda; other is the copy source.
    assert Resources.__init__.__defaults__ == (None, None)
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


def test_last_modules_take_numpy_to_the_card_or_raise(rng):
    """solver/, ball cover, the epsilon neighborhood and single linkage
    move numpy inputs to ``cuda``, as every entry point does."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: nothing to refuse")
    from raft_tpu_torch.cluster import single_linkage
    from raft_tpu_torch.neighbors import ball_cover, eps_neighbors_l2sq
    from raft_tpu_torch.solver import LinearAssignmentProblem, lap

    x = rng.standard_normal((20, 3)).astype(np.float32)
    c = rng.random((4, 4)).astype(np.float32)
    for call in (lambda: lap(c), lambda: LinearAssignmentProblem(4).solve(c),
                 lambda: eps_neighbors_l2sq(x, x, 1.0),
                 lambda: ball_cover.build_index(x),
                 lambda: single_linkage(x, 2)):
        with pytest.raises(CudaError):
            call()
    assert lap(c, device="cpu")[0].device.type == "cpu"


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A CUDA request whose kernel cannot be built raises CudaError: no
    wrapper carries on with the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(CudaError):
        _build.load_library("knn_tf32")
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


@pytest.mark.parametrize("qsplit", [False, True])
def test_bf16_tiers_never_reach_the_fma_scan(monkeypatch, tmp_path, qsplit):
    """B1's bf16 tiers launch their tensor-core scan's library (knn_mma)
    alone: with the f32 tier's library (knn_tf32; B1 has no FMA scan left)
    loaded and knn_mma unbuildable, a bf16 request raises CudaError and
    never calls the f32 tier's entry."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = []

    def f32_entry(*args):
        calls.append(args)
        return 0

    f32_entry.argtypes = fk._TF32_ARGTYPES
    monkeypatch.setattr(_build, "_LOADED", {"knn_tf32": type(
        "Lib", (), {"fused_knn_tf32_launch": staticmethod(f32_entry)})()})
    q = torch.zeros((4, 8))
    before = fk.fused_knn.launches
    with pytest.raises(CudaError):
        fk._fused_knn_cuda(q, q, 2, True, True, qsplit)
    assert calls == []
    assert fk.fused_knn.launches == before


@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("k", [1, 10])
def test_f32_tier_never_reaches_an_fma_scan(monkeypatch, tmp_path, l2, k):
    """B1's f32 tier launches the 3xTF32 tensor-core scan's library
    (knn_tf32) alone, and no B1 FMA scan is left to take it: no kernel
    source is named fused_knn, and with knn_mma loaded and knn_tf32
    unbuildable an f32 request raises CudaError and never calls the bf16
    tiers' entry."""
    assert "fused_knn" not in _build.sources()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = []

    def mma_entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "_LOADED", {"knn_mma": type(
        "Lib", (), {"fused_knn_mma_launch": staticmethod(mma_entry)})()})
    q = torch.zeros((4, 8))
    before = (fk.fused_knn.launches, fk.fused_knn.tf32_launches)
    with pytest.raises(CudaError):
        fk._fused_knn_cuda(q, q, k, l2, False, False)
    assert calls == []
    assert (fk.fused_knn.launches, fk.fused_knn.tf32_launches) == before


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16,
                                   torch.uint8, torch.int8])
@pytest.mark.parametrize("qsplit", [False, True])
def test_b2_bf16_tiers_never_reach_the_fma_scan(monkeypatch, tmp_path,
                                                qsplit, store):
    """B2's bf16 tiers launch the bf16 tensor-core scan's library
    (cells_mma) alone, on every store: with the f32 tier's library
    (cells_tf32) loaded and cells_mma unbuildable, a bf16 request raises
    CudaError and never calls the f32 tier's entry, through B2's wrapper or
    B3's."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = []

    def tf32_entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "_LOADED", {"cells_tf32": type(
        "Lib", (), {"fused_cells_tf32_launch": staticmethod(tf32_entry)})()})
    q = torch.zeros((1, 4, 8))
    db = torch.zeros((1, 300, 8), dtype=store)
    invalid = torch.zeros((1, 300), dtype=torch.bool)
    c = fk.fused_cells_knn
    before = (c.launches, c.mma_launches, c.tf32_launches)
    with pytest.raises(CudaError):
        fk._fused_cells_knn_cuda(torch.zeros(1, dtype=torch.int32), q, db,
                                 invalid, 2, True, True, qsplit)
    with pytest.raises(CudaError):
        fk._fused_batch_knn_cuda(q, db, invalid, 2, True, True, qsplit)
    assert calls == []
    assert (c.launches, c.mma_launches, c.tf32_launches) == before


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 17])
def test_b2_f32_tier_never_reaches_an_fma_scan(monkeypatch, tmp_path, k,
                                               store):
    """B2's f32 tier launches the 3xTF32 tensor-core scan's library
    (cells_tf32) alone, and no B2 FMA scan is left to take it: no kernel
    source is named cells_knn, and with cells_mma loaded and cells_tf32
    unbuildable an f32 request raises CudaError and never calls the bf16
    tiers' entry, through B2's wrapper or B3's."""
    assert "cells_knn" not in _build.sources()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = []

    def mma_entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "_LOADED", {"cells_mma": type(
        "Lib", (), {"fused_cells_mma_launch": staticmethod(mma_entry)})()})
    q = torch.zeros((1, 4, 8))
    db = torch.zeros((1, 300, 8), dtype=store)
    invalid = torch.zeros((1, 300), dtype=torch.bool)
    c = fk.fused_cells_knn
    before = (c.launches, c.mma_launches, c.tf32_launches)
    with pytest.raises(CudaError):
        fk._fused_cells_knn_cuda(torch.zeros(1, dtype=torch.int32), q, db,
                                 invalid, k, True, False, False)
    with pytest.raises(CudaError):
        fk._fused_batch_knn_cuda(q, db, invalid, k, True, False, False)
    assert calls == []
    assert (c.launches, c.mma_launches, c.tf32_launches) == before


def test_library_name_follows_the_sources():
    path = _build._library_path("knn_tf32")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libknn_tf32-") and path.suffix == ".so"
    assert _build.sources() == ["batch_knn", "cells_mma", "cells_tf32",
                                "knn_mma", "knn_tf32", "pq_scan",
                                "stream_select"]
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
