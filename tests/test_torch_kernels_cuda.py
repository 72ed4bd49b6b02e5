"""The CUDA kernels on the card, held to their plain versions.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). The file imports neither JAX nor raft_tpu, so it also runs where
JAX is absent; there, skip the JAX-importing ``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Integer-valued data keeps every distance exact, so kernel and plain
version must agree bit for bit, ids and distances.
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.neighbors import brute_force, ivf_flat
from raft_tpu_torch.ops import fused_knn as fk
from test_torch_common import int_data, n

_TIERS = [(False, False), (True, False), (True, True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(42)


def _on(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bf16,qsplit", _TIERS)
@pytest.mark.parametrize("k", [1, 16, 256])
def test_fused_knn_kernel(dev, gen, metric, bf16, qsplit, k):
    q, db = _on(dev, int_data(gen, (70, 96)), int_data(gen, (3001, 96)))
    before = fk.fused_knn.launches
    d, i = fk.fused_knn(q, db, k, metric=metric, bf16=bf16, qsplit=qsplit)
    assert fk.fused_knn.launches == before + 1
    pd, pi = fk._fused_knn_plain(q, db, k, metric == "l2", bf16, qsplit)
    if metric == "ip":
        pd = -pd
    np.testing.assert_array_equal(n(i), n(pi))
    np.testing.assert_array_equal(n(d), n(pd))


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("bf16_db", [False, True])
def test_fused_cells_knn_kernel(dev, gen, l2, bf16_db):
    L, cap, d = 5, 300, 96
    db = int_data(gen, (L, cap, d))
    invalid = gen.random((L, cap)) < 0.3
    invalid[1, :] = True
    invalid[3, 4:] = True
    cells = np.array([0, 1, -1, 3, 2, 4, 3, -1], np.int32)
    q = int_data(gen, (cells.shape[0], 40, d))
    args = _on(dev, cells, q, db, invalid)
    if bf16_db:
        args[2] = args[2].to(torch.bfloat16)
    before = fk.fused_cells_knn.launches
    kd, ki = fk.fused_cells_knn(*args, 10, l2=l2, bf16=bf16_db,
                                qsplit=bf16_db)
    assert fk.fused_cells_knn.launches == before + 1
    pd, pi = fk._fused_cells_knn_plain(*args, 10, l2, bf16_db, bf16_db)
    np.testing.assert_array_equal(n(ki), n(pi))
    np.testing.assert_array_equal(n(kd), n(pd))
    assert (n(ki)[3, :, 4:] == -1).all() and (n(ki)[2] == -1).all()


@pytest.mark.cuda
def test_entry_points_launch_the_kernels(dev, gen):
    """brute force, the k-means of build, and search go through B1/B2."""
    X = int_data(gen, (9000, 32))
    Q = int_data(gen, (300, 32))
    b1, b2 = fk.fused_knn.launches, fk.fused_cells_knn.launches
    d, i = brute_force.knn(X, Q, 10)          # numpy -> the card
    assert d.device.type == "cuda" and fk.fused_knn.launches == b1 + 1
    sd, si = brute_force.knn(torch.as_tensor(X), torch.as_tensor(Q), 10,
                             method="scan")
    np.testing.assert_array_equal(n(i), n(si))
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=16,
                                                kmeans_n_iters=4), X)
    assert fk.fused_knn.launches > b1 + 1
    vd, vi = ivf_flat.search(ivf_flat.SearchParams(n_probes=16), index, Q,
                             10)
    assert fk.fused_cells_knn.launches == b2 + 1
    # All lists probed: the IVF search is exact.
    np.testing.assert_array_equal(n(vd), n(d))
