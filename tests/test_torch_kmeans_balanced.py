"""Balanced k-means of raft_tpu_torch against raft_tpu's.

Deterministic stages are held to the reference directly: the balancing EM
from the same initial centroids, and ``build_clusters`` for 64 < k <= 256,
whose strided initialisation draws no random numbers. Stages that draw
random numbers (k-means++ seeding, the hierarchical ``fit``) use a
``torch.Generator`` in the port and ``jax.random`` in the reference, so
they are held by quality: inertia within a stated margin of the
reference's on the same data, and comparable cluster-size balance.

Centroid tolerance: rtol 1e-5, atol 1e-4 (means of the same members,
summed in another order).
"""

import jax
import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans as jkmeans
from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu.cluster.kmeans_types import \
    KMeansBalancedParams as JKMeansBalancedParams
from raft_tpu_torch.cluster import kmeans, kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.random.rng_state import RngState
from test_torch_common import blobs, cluster_sizes, inertia, n, t

CENTROID_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_clusters,n_iters", [(8, 1), (20, 5), (40, 3)])
def test_balanced_em_from_same_start(rng, n_clusters, n_iters):
    X = blobs(rng, 1500, 12, n_blobs=15, std=1.5)
    c0 = X[rng.choice(X.shape[0], n_clusters, replace=False)]
    c = kmeans_balanced._balanced_em(t(X), t(c0), n_iters, n_clusters)
    jc = jkb._balanced_em(X, c0, n_iters, n_clusters, False)
    np.testing.assert_allclose(n(c), n(jc), **CENTROID_TOL)


def test_balanced_em_reseeds_like_the_reference(rng):
    """Start with every centroid on one blob (its ten rows nearest to
    row 0): the small clusters must be re-seeded to the same high-cost
    samples."""
    X = blobs(rng, 1000, 8, n_blobs=10, std=0.5)
    c0 = X[np.argsort(((X - X[0]) ** 2).sum(1))[:10]]
    c = kmeans_balanced._balanced_em(t(X), t(c0), 2, 10)
    jc = jkb._balanced_em(X, c0, 2, 10, False)
    np.testing.assert_allclose(n(c), n(jc), **CENTROID_TOL)


def test_build_clusters_strided_init(rng):
    X = blobs(rng, 3000, 16, n_blobs=100, std=1.0)
    params = KMeansBalancedParams(n_iters=4)
    c = kmeans_balanced.build_clusters(params, t(X), 100)
    jc = jkb.build_clusters(JKMeansBalancedParams(n_iters=4), X, 100)
    np.testing.assert_allclose(n(c), n(jc), **CENTROID_TOL)
    labels = kmeans_balanced.predict(params, c, t(X))
    jlabels = jkb.predict(JKMeansBalancedParams(), jc, X)
    assert (n(labels) == n(jlabels)).mean() >= 0.999


def test_hierarchical_fit_quality(rng):
    """n_clusters > 256 takes the hierarchical path. Margins: inertia at
    most 10% above the reference's; the largest cluster at most 1.5x the
    reference's largest."""
    X = blobs(rng, 3000, 8, n_blobs=60, std=2.0)
    params = KMeansBalancedParams(n_iters=8, rng_state=RngState(seed=1))
    c = kmeans_balanced.fit(params, t(X), 300)
    jc = jkb.fit(JKMeansBalancedParams(n_iters=8), X, 300)
    assert n(c).shape == (300, 8) and np.isfinite(n(c)).all()
    assert inertia(X, n(c)) <= 1.10 * inertia(X, n(jc))
    sizes, jsizes = cluster_sizes(X, n(c)), cluster_sizes(X, n(jc))
    assert sizes.max() <= 1.5 * jsizes.max()
    assert (sizes == 0).sum() <= max(3, 2 * (jsizes == 0).sum())


def test_fit_predict_small_k(rng):
    X = blobs(rng, 800, 6, n_blobs=5, std=0.5)
    params = KMeansBalancedParams(n_iters=10)
    c, labels = kmeans_balanced.fit_predict(params, t(X), 5)
    jc, jlabels = jkb.fit_predict(JKMeansBalancedParams(n_iters=10), X, 5)
    assert inertia(X, n(c)) <= 1.05 * inertia(X, n(jc))
    assert np.bincount(n(labels), minlength=5).min() > 0
    assert labels.dtype == torch.int32


def test_init_plus_plus_quality(rng):
    """k-means++ seeds from the two packages' generators: the port's seed
    inertia within 2x of the reference's (both find most blobs)."""
    X = blobs(rng, 2000, 4, n_blobs=12, std=0.3)
    g = torch.Generator().manual_seed(3)
    c = kmeans.init_plus_plus(g, t(X), 12)
    jc = jkmeans.init_plus_plus(jax.random.key(3), X, 12)
    assert inertia(X, n(c)) <= 2.0 * inertia(X, n(jc))
    # Every seed is a data row.
    assert all((X == row).all(1).any() for row in n(c))
