"""Parity of raft_tpu_torch brute-force kNN and fused L2 NN with raft_tpu.

Both port engines ("scan", and "kernel", whose plain version runs on CPU
tensors) are held to both reference engines (``method="xla"``, the
``lax.scan``, and ``method="pallas"``, the fused kernel in interpret mode).
Ids are bit-identical on integer-valued data; Gaussian distances agree to
``GAUSS_TOL``.
"""

import numpy as np
import pytest

from raft_tpu.distance.distance_types import DistanceType as JDistance
from raft_tpu.distance.fused_l2_nn import \
    fused_l2_nn_min_reduce as jfused_l2_nn
from raft_tpu.distance.pairwise import distance as jdistance
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_min_reduce
from raft_tpu_torch.distance.pairwise import distance
from raft_tpu_torch.neighbors import brute_force
from test_torch_common import GAUSS_TOL, gauss, int_data, n, t

_METRICS = ["L2Expanded", "L2SqrtExpanded", "InnerProduct"]


@pytest.mark.parametrize("metric", _METRICS)
@pytest.mark.parametrize("method", ["scan", "kernel"])
@pytest.mark.parametrize("jmethod", ["xla", "pallas"])
def test_knn_integer_data(rng, metric, method, jmethod):
    q = int_data(rng, (23, 24))
    db = int_data(rng, (900, 24))
    d, i = brute_force.knn(t(db), t(q), 7, metric=DistanceType[metric],
                           method=method)
    if jmethod == "xla":
        jd, ji = jbf.tiled_brute_force_knn(q, db, 7, JDistance[metric],
                                           tile_db=256, method="xla")
    else:
        jd, ji = jbf.tiled_brute_force_knn(q, db, 7, JDistance[metric],
                                           method="pallas")
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-6, atol=0)


@pytest.mark.parametrize("metric", _METRICS)
@pytest.mark.parametrize("method", ["scan", "kernel"])
def test_knn_gaussian_distances(rng, metric, method):
    q = gauss(rng, (31, 40))
    db = gauss(rng, (1200, 40))
    d, _ = brute_force.tiled_brute_force_knn(
        t(q), t(db), 9, DistanceType[metric], tile_db=500, method=method)
    jd, _ = jbf.tiled_brute_force_knn(q, db, 9, JDistance[metric],
                                      method="xla")
    np.testing.assert_allclose(n(d), n(jd), **GAUSS_TOL)


def test_auto_engine_on_cpu_is_the_scan(rng):
    q = int_data(rng, (5, 8))
    db = int_data(rng, (9000, 8))
    d, i = brute_force.knn(t(db), t(q), 4)
    jd, ji = jbf.knn(db, q, 4)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


def test_fused_l2_knn_and_offset(rng):
    q = int_data(rng, (6, 8))
    db = int_data(rng, (50, 8))
    d, i = brute_force.fused_l2_knn(t(db), t(q), 5, sqrt=True)
    jd, ji = jbf.fused_l2_knn(db, q, 5, sqrt=True)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-6)
    _, io = brute_force.knn(t(db), t(q), 5, global_id_offset=100)
    np.testing.assert_array_equal(n(io), n(i) + 100)
    _, ip = brute_force.knn([t(db)], t(q), 5)
    np.testing.assert_array_equal(n(ip), n(i))


def test_unported_paths_raise(rng):
    # L1 and cosine answer now, as the reference does; Precomputed is the
    # one metric neither package searches.
    x = int_data(rng, (10, 4))
    db = t(x)
    for metric in (DistanceType.L1, DistanceType.CosineExpanded):
        d, i = brute_force.knn([db, db], db, 2, metric=metric)
        jd, ji = jbf.knn([x, x], x, 2, metric=JDistance(metric.value))
        np.testing.assert_array_equal(n(i), n(ji))
        np.testing.assert_array_equal(n(d), n(jd))
    np.testing.assert_array_equal(n(distance(db, db, metric="cosine")),
                                  n(jdistance(x, x, JDistance.CosineExpanded)))
    with pytest.raises(LogicError):
        brute_force.knn(db, db, 2, metric=DistanceType.Precomputed)
    with pytest.raises(LogicError):
        distance(db, db, metric=DistanceType.Precomputed)


@pytest.mark.parametrize("metric", _METRICS)
def test_pairwise_expanded(rng, metric):
    from raft_tpu.distance.pairwise import distance as jdistance

    x = gauss(rng, (12, 16))
    y = gauss(rng, (30, 16))
    np.testing.assert_allclose(
        n(distance(t(x), t(y), DistanceType[metric])),
        n(jdistance(x, y, JDistance[metric])), **GAUSS_TOL)


@pytest.mark.parametrize("bf16", [None, "split", "full"])
@pytest.mark.parametrize("tile_n", [2048, 64])
def test_fused_l2_nn_tiers(rng, bf16, tile_n):
    x = int_data(rng, (200, 16))
    y = int_data(rng, (150, 16))
    # tile_n only shapes the reference's tiling; the port ignores it.
    d, i = fused_l2_nn_min_reduce(t(x), t(y), tile_n=tile_n, bf16=bf16)
    jd, ji = jfused_l2_nn(x, y, tile_n=tile_n, bf16=bf16)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(d), n(jd))


@pytest.mark.parametrize("bf16", [None, "split", "full"])
def test_fused_l2_nn_gaussian(rng, bf16):
    x = gauss(rng, (100, 24))
    y = gauss(rng, (90, 24))
    d, i = fused_l2_nn_min_reduce(t(x), t(y), sqrt=True, bf16=bf16)
    jd, ji = jfused_l2_nn(x, y, sqrt=True, bf16=bf16)
    np.testing.assert_allclose(n(d), n(jd), rtol=1e-4, atol=1e-4)
    assert (n(i) == n(ji)).mean() >= 0.98


def test_spatial_knn_aliases(rng):
    """The legacy ``spatial.knn`` names are the port's own objects (as
    tests/test_compat_namespaces.py holds the reference's), and its
    ``brute_force_knn`` answers as the reference's does."""
    from raft_tpu import spatial as jspatial
    from raft_tpu_torch import neighbors, spatial
    from raft_tpu_torch.neighbors import ball_cover, epsilon_neighborhood

    sk = spatial.knn
    assert sk.brute_force_knn is neighbors.brute_force.knn
    assert sk.knn_merge_parts is neighbors.brute_force.knn_merge_parts
    assert sk.fused_l2_knn is neighbors.brute_force.fused_l2_knn
    assert sk.rbc_build_index is ball_cover.build_index
    assert sk.rbc_knn_query is ball_cover.knn_query
    assert sk.rbc_all_knn_query is ball_cover.all_knn_query
    assert sk.rbc_eps_nn is ball_cover.eps_nn
    assert sk.BallCoverIndex is ball_cover.BallCoverIndex
    assert (sk.epsUnexpL2SqNeighborhood
            is epsilon_neighborhood.eps_neighbors_l2sq)
    assert sk.ivf_pq is neighbors.ivf_pq and sk.ivf_flat is neighbors.ivf_flat
    assert sorted(sk.__all__) == sorted(jspatial.knn.__all__)
    assert spatial.__all__ == jspatial.__all__ == ["knn"]

    db = rng.normal(size=(64, 8)).astype(np.float32)
    q = rng.normal(size=(4, 8)).astype(np.float32)
    d, i = sk.brute_force_knn(t(db), t(q), k=3)
    truth = np.argsort(((q[:, None] - db[None]) ** 2).sum(-1), axis=1)[:, :3]
    np.testing.assert_array_equal(n(i), truth)
    jd, ji = jspatial.knn.brute_force_knn(db, q, k=3)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_allclose(n(d), n(jd), **GAUSS_TOL)
