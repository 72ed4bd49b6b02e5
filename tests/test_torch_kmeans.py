"""raft_tpu_torch.cluster.kmeans (Lloyd) against raft_tpu.cluster.kmeans.

Mirrors tests/test_cluster.py's Lloyd cases. From ``InitMethod.Array``
both packages run the same iterations on the same numpy inputs:

* labels bit for bit on well-separated blobs (every row far from a tie);
* centroids within rtol 1e-5 (the two sum in different orders);
* distances, costs and inertia within rtol 1e-5 plus the rounding of the
  expanded L2 form |x|^2 + |c|^2 - 2 x.c that both packages use: 2e-6 of
  |x|^2 + |c|^2 for each distance (``chip_smoke.REL_NORM_TOL``), summed
  over the rows for an inertia; square roots are compared squared, since
  the root of a rounded zero is not small;
* ``n_iter`` equal;
* ``find_k`` returns the reference's k on the same blobs.

The seeded inits (k-means++, random) draw from different generators, so
they are held to quality (label accuracy, spread), not to values.
"""

import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans as jk
from raft_tpu.cluster.kmeans_types import InitMethod as JInit
from raft_tpu.cluster.kmeans_types import KMeansParams as JParams
from raft_tpu.distance.distance_types import DistanceType as JDist
from raft_tpu.random import make_blobs as j_make_blobs
from raft_tpu_torch.cluster import InitMethod, KMeansParams
from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.random import RngState
from test_torch_common import n, t

TOL = dict(rtol=1e-5, atol=1e-5)
REL_NORM = 2e-6


def _dist_tol(X, c) -> float:
    """The expanded form's rounding bound for one distance."""
    return REL_NORM * float((X.astype(np.float64) ** 2).sum(1).max()
                            + (np.asarray(c, np.float64) ** 2).sum(1).max())


def _close_inertia(got, want, X, c, w=None):
    rows = (X.astype(np.float64) ** 2).sum(1) + float(
        (np.asarray(c, np.float64) ** 2).sum(1).max())
    if w is not None:
        rows = rows * w
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                               atol=REL_NORM * float(rows.sum()))


def _blobs(n_rows=600, d=8, k=5, seed=7, std=0.4):
    X, y = j_make_blobs(n_rows, d, n_clusters=k, cluster_std=std, seed=seed)
    return np.asarray(X), np.asarray(y)


def _accuracy(labels, truth, k):
    cont = np.zeros((k, k))
    np.add.at(cont, (n(labels).astype(int), n(truth).astype(int)), 1)
    return cont.max(axis=1).sum() / len(n(labels))


def _init(X, y, k, shift=0.5):
    """Well-separated starting centroids: each blob's mean moved off it."""
    return np.stack([X[y == c].mean(0) + shift for c in range(k)]).astype(
        np.float32)


def _params(k, **kw):
    return (JParams(n_clusters=k, init=JInit.Array, **kw),
            KMeansParams(n_clusters=k, init=InitMethod.Array,
                         **{key: (DistanceType[v.name]
                                  if isinstance(v, JDist) else v)
                            for key, v in kw.items()}))


@pytest.mark.parametrize("k,d,std", [(5, 8, 0.4), (3, 4, 0.3), (12, 16, 1.0)])
def test_fit_from_array_equals_reference(k, d, std):
    X, y = _blobs(n_rows=900, d=d, k=k, std=std)
    c0 = _init(X, y, k)
    jp, tp = _params(k, max_iter=50)
    rc, ri, rn = jk.fit(jp, X, centroids_init=c0)
    c, inertia, it = kmeans.fit(tp, t(X), centroids_init=c0)
    np.testing.assert_allclose(n(c), np.asarray(rc), **TOL)
    _close_inertia(inertia, ri, X, rc)
    assert it == int(rn)
    rl, rinert = jk.predict(jp, rc, X)
    labels, pinert = kmeans.predict(tp, c, t(X))
    np.testing.assert_array_equal(n(labels), np.asarray(rl))
    assert labels.dtype == torch.int32
    _close_inertia(pinert, rinert, X, rc)


def test_fit_predict_equals_reference():
    X, y = _blobs()
    c0 = _init(X, y, 5)
    jp, tp = _params(5, max_iter=100)
    rc, rl, ri, rn = jk.fit_predict(jp, X, centroids_init=c0)
    c, labels, inertia, it = kmeans.fit_predict(tp, t(X), centroids_init=c0)
    np.testing.assert_array_equal(n(labels), np.asarray(rl))
    np.testing.assert_allclose(n(c), np.asarray(rc), **TOL)
    _close_inertia(inertia, ri, X, rc)
    assert it == int(rn)
    assert _accuracy(labels, y, 5) > 0.95


def test_fit_with_sample_weight_equals_reference():
    X, y = _blobs()
    w = np.random.default_rng(3).uniform(0.5, 2.0, X.shape[0]).astype(
        np.float32)
    c0 = _init(X, y, 5)
    jp, tp = _params(5, max_iter=100)
    rc, ri, rn = jk.fit(jp, X, sample_weight=w, centroids_init=c0)
    c, inertia, it = kmeans.fit(tp, t(X), sample_weight=w, centroids_init=c0)
    np.testing.assert_allclose(n(c), np.asarray(rc), **TOL)
    _close_inertia(inertia, ri, X, rc, w)
    assert it == int(rn)
    rl, rinert = jk.predict(jp, rc, X, sample_weight=w)
    labels, pinert = kmeans.predict(tp, c, t(X), sample_weight=w)
    np.testing.assert_array_equal(n(labels), np.asarray(rl))
    _close_inertia(pinert, rinert, X, rc, w)


def test_empty_clusters_reseed_as_the_reference():
    """Two starting centroids on one spot: the duplicate starves (ties go
    to the lower index) and both packages re-seed it at the same
    highest-cost row."""
    X, y = _blobs(k=4)
    c0 = _init(X, y, 4)
    c0 = np.concatenate([c0, c0[:1], c0[2:3]])       # 6 centroids, 2 dupes
    jp, tp = _params(6, max_iter=30)
    rc, ri, rn = jk.fit(jp, X, centroids_init=c0)
    c, inertia, it = kmeans.fit(tp, t(X), centroids_init=c0)
    np.testing.assert_allclose(n(c), np.asarray(rc), **TOL)
    _close_inertia(inertia, ri, X, rc)
    assert it == int(rn)


def test_non_l2_metric_equals_reference():
    X, y = _blobs(k=4)
    c0 = _init(X, y, 4)
    jp, tp = _params(4, max_iter=30, metric=JDist.L1)
    rc, ri, rn = jk.fit(jp, X, centroids_init=c0)
    c, inertia, it = kmeans.fit(tp, t(X), centroids_init=c0)
    np.testing.assert_allclose(n(c), np.asarray(rc), **TOL)
    np.testing.assert_allclose(float(inertia), float(ri), rtol=1e-5)
    assert it == int(rn)


def test_transform_and_cluster_cost_equal_reference():
    X, _ = _blobs(n_rows=100, d=4, k=3)
    c = X[:3]
    jp, tp = _params(3)
    np.testing.assert_allclose(n(kmeans.transform(tp, t(c), t(X))),
                               np.asarray(jk.transform(jp, c, X)),
                               rtol=1e-5, atol=_dist_tol(X, c))
    _close_inertia(kmeans.cluster_cost(t(X), t(c)), jk.cluster_cost(X, c),
                   X, c)


@pytest.mark.parametrize("metric", ["L2Expanded", "L2SqrtExpanded",
                                    "L2Unexpanded", "L1"])
def test_min_cluster_and_distance_equals_reference(metric):
    X, _ = _blobs(n_rows=300, d=6, k=4)
    c = X[::50][:6]
    rl, rd = jk.min_cluster_and_distance(X, c, JDist[metric])
    labels, d = kmeans.min_cluster_and_distance(t(X), t(c),
                                                DistanceType[metric])
    np.testing.assert_array_equal(n(labels), np.asarray(rl))
    power = 2 if "Sqrt" in metric else 1
    tol = dict(rtol=1e-5, atol=_dist_tol(X, c) if "L2" in metric else 1e-5)
    np.testing.assert_allclose(n(d) ** power, np.asarray(rd) ** power, **tol)
    d2 = kmeans.min_cluster_distance(t(X), t(c), DistanceType[metric])
    np.testing.assert_array_equal(n(d2), n(d))


@pytest.mark.parametrize("weighted", [False, True])
def test_update_centroids_equals_reference(weighted):
    X, y = _blobs(n_rows=200, d=4, k=4)
    labels = y.astype(np.int32)
    labels[labels == 3] = 2                  # cluster 3 is empty
    old = np.full((4, 4), 7.0, np.float32)
    w = (np.random.default_rng(1).uniform(0.5, 2, 200).astype(np.float32)
         if weighted else None)
    rc, rn = jk.update_centroids(X, labels, 4, centroids_old=old,
                                 sample_weight=w)
    c, cnt = kmeans.update_centroids(t(X), t(labels), 4, centroids_old=old,
                                     sample_weight=w)
    np.testing.assert_allclose(n(c), np.asarray(rc), **TOL)
    np.testing.assert_allclose(n(cnt), np.asarray(rn), **TOL)
    np.testing.assert_array_equal(n(c)[3], old[3])


def test_compute_new_centroids_equals_reference():
    X, _ = _blobs(n_rows=100, d=4, k=3)
    c = X[:3].copy()
    np.testing.assert_allclose(
        n(kmeans.compute_new_centroids(t(X), t(c))),
        np.asarray(jk.compute_new_centroids(X, c)), **TOL)
    labels = (np.arange(100) % 3).astype(np.int32)
    np.testing.assert_allclose(
        n(kmeans.compute_new_centroids(t(X), t(c), labels=t(labels))),
        np.asarray(jk.compute_new_centroids(X, c, labels=labels)), **TOL)


# -- seeded inits: quality, not values ------------------------------------


def test_plus_plus_fit_recovers_blobs():
    X, y = _blobs()
    p = KMeansParams(n_clusters=5, max_iter=100, rng_state=RngState(seed=1))
    centroids, labels, inertia, it = kmeans.fit_predict(p, t(X))
    assert centroids.shape == (5, X.shape[1])
    assert _accuracy(labels, y, 5) > 0.95
    assert float(inertia) > 0 and it >= 1


def test_random_init_with_restarts():
    X, y = _blobs()
    p = KMeansParams(n_clusters=5, init=InitMethod.Random, n_init=3,
                     rng_state=RngState(seed=3))
    centroids, _, _ = kmeans.fit(p, t(X))
    labels, _ = kmeans.predict(p, centroids, t(X))
    assert _accuracy(labels, y, 5) > 0.9
    assert p.rng_state.base_subsequence == 3     # one draw per restart


def test_inertia_close_to_the_blobs_spread():
    X, _ = _blobs(n_rows=400, d=4, k=3, std=0.3)
    _, inertia, _ = kmeans.fit(KMeansParams(n_clusters=3,
                                            rng_state=RngState(seed=2)),
                               t(X))
    assert float(inertia) / X.shape[0] < 4 * X.shape[1] * 0.3 ** 2


def test_init_random_and_sample_centroids_pick_distinct_rows():
    X, _ = _blobs(n_rows=50, d=3, k=2)
    g = torch.Generator().manual_seed(0)
    c = kmeans.init_random(g, t(X), 20)
    rows = {tuple(r) for r in n(c)}
    assert len(rows) == 20 and rows <= {tuple(r) for r in X}
    s = kmeans.sample_centroids(g, t(X), 7)
    assert s.shape == (7, 3)


def test_init_plus_plus_spread():
    X, _ = _blobs(n_rows=300, d=4, k=5, std=0.2)
    c = n(kmeans.init_plus_plus(torch.Generator().manual_seed(0), t(X), 5))
    d = np.linalg.norm(c[:, None] - c[None], axis=2)
    np.fill_diagonal(d, np.inf)
    assert d.min() > 1.0


def test_fit_refusals():
    X, _ = _blobs(n_rows=20, d=2, k=2)
    with pytest.raises(LogicError):
        kmeans.fit(KMeansParams(n_clusters=21), t(X))
    with pytest.raises(LogicError):
        kmeans.fit(KMeansParams(n_clusters=2, init=InitMethod.Array), t(X))
    bad = X.copy()
    bad[3, 1] = np.nan
    with pytest.raises(LogicError):
        kmeans.fit(KMeansParams(n_clusters=2), t(bad))


# -- find_k --------------------------------------------------------------


@pytest.mark.parametrize("n_blobs,seed", [(5, 3), (4, 1), (7, 5)])
def test_find_k_equals_reference(n_blobs, seed):
    X, _ = j_make_blobs(1200, 8, n_clusters=n_blobs, cluster_std=0.3,
                        seed=seed)
    X = np.asarray(X)
    rk, _, _ = jk.find_k(X, kmax=12, kmin=2, max_iter=40)
    k, inertia, it = kmeans.find_k(t(X), kmax=12, kmin=2, max_iter=40)
    assert k == rk == n_blobs
    assert float(inertia) > 0 and it >= 1


def test_find_k_runs_log_many_fits(monkeypatch):
    X, _ = j_make_blobs(600, 6, n_clusters=4, cluster_std=0.3, seed=1)
    calls = []
    orig = kmeans._fit

    def counting_fit(p, data, *a, **kw):
        calls.append(p.n_clusters)
        return orig(p, data, *a, **kw)

    monkeypatch.setattr(kmeans, "_fit", counting_fit)
    kmeans.find_k(t(np.asarray(X)), kmax=32, kmin=2, max_iter=30)
    assert len(calls) <= 3 * (2 + 5), len(calls)


def test_find_k_refusals():
    X = t(np.zeros((10, 2), np.float32))
    with pytest.raises(LogicError):
        kmeans.find_k(X, kmax=1)
    with pytest.raises(LogicError):
        kmeans.find_k(X, kmax=11)
    with pytest.raises(LogicError):
        kmeans.find_k(X, kmax=4, kmin=5)


def test_params_defaults_equal_reference():
    import dataclasses

    ref = {f.name: f.default for f in dataclasses.fields(JParams)
           if f.name not in ("rng_state", "init", "metric")}
    got = {f.name: f.default for f in dataclasses.fields(KMeansParams)
           if f.name not in ("rng_state", "init", "metric")}
    assert got == ref
    assert KMeansParams().init.name == JParams().init.name
    assert KMeansParams().metric.name == JParams().metric.name
    assert [m.name for m in InitMethod] == [m.name for m in JInit]
    assert [m.value for m in InitMethod] == [m.value for m in JInit]
