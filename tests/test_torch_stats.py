"""raft_tpu_torch.stats against raft_tpu.stats.

Mirrors tests/test_stats.py and tests/test_stats_properties.py: the same
seeded numpy inputs through both packages (the port on CPU tensors), with
scikit-learn / scipy as the outside oracle where the reference's tests use
it. Values within rtol 1e-5 (atol 1e-5 for entries near zero; the two sum
in different orders); counts, contingency tables and min / max bit for
bit.
"""

import numpy as np
import pytest
import scipy.stats
import sklearn.metrics
import torch
from sklearn.manifold import trustworthiness as sk_trustworthiness

import raft_tpu.stats as js
import raft_tpu_torch.stats as ts
from raft_tpu.stats.regression import InformationCriterionType as JIC
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.stats.classification import make_monotonic_bounds
from raft_tpu_torch.stats.regression import InformationCriterionType
from test_torch_common import n, t

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    got, want = n(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **(tol or TOL))


def _same(got, want):
    got, want = n(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _labels(rng, size=200, k=5):
    return rng.integers(0, k, size), rng.integers(0, k, size)


# -- descriptive ------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_mean_sum_meanvar_stddev_vars(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(int(rng.integers(3, 400)),
                          int(rng.integers(1, 60)))) * 3 + 1).astype(
        np.float32)
    for axis in (0, 1):
        for sample in (False, True):
            _close(ts.mean(t(x), sample, axis), js.mean(x, sample, axis))
            mu, var = ts.meanvar(t(x), sample, axis)
            rmu, rvar = js.meanvar(x, sample, axis)
            _close(mu, rmu)
            _close(var, rvar)
            _close(ts.vars_(t(x), sample=sample, axis=axis),
                   js.vars_(x, sample=sample, axis=axis))
            _close(ts.stddev(t(x), sample=sample, axis=axis),
                   js.stddev(x, sample=sample, axis=axis))
        _close(ts.sum(t(x), axis), js.sum(x, axis))
    mu = x.mean(0) + 0.5
    _close(ts.vars_(t(x), mu=mu), js.vars_(x, mu=mu))
    _close(ts.stddev(t(x), mu=t(mu)), js.stddev(x, mu=mu))


def test_mean_center_add(rng):
    x = rng.standard_normal((30, 4)).astype(np.float32)
    for axis in (0, 1):
        c = ts.mean_center(t(x), axis=axis)
        _close(c, js.mean_center(x, axis=axis))
        mu = x.mean(axis)
        _close(ts.mean_add(c, mu, axis=axis), js.mean_add(
            np.asarray(js.mean_center(x, axis=axis)), mu, axis=axis))
    _close(ts.mean_center(t(x), mu=np.ones(4, np.float32)),
           js.mean_center(x, mu=np.ones(4, np.float32)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("stable", [True, False])
def test_cov(seed, stable):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((int(rng.integers(3, 200)),
                             int(rng.integers(1, 20)))).astype(np.float32)
    for sample in (True, False):
        got = ts.cov(t(x), sample=sample, stable=stable)
        _close(got, js.cov(x, sample=sample, stable=stable),
               rtol=1e-5, atol=1e-5 if stable else 1e-4)
    np.testing.assert_allclose(n(ts.cov(t(x))), np.cov(x, rowvar=False)
                               .reshape(x.shape[1], x.shape[1]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_minmax_bit_for_bit(seed):
    rng = np.random.default_rng(10 + seed)
    x = rng.normal(size=(int(rng.integers(2, 300)),
                         int(rng.integers(1, 40)))).astype(np.float32)
    for axis in (0, 1):
        lo, hi = ts.minmax(t(x), axis)
        rlo, rhi = js.minmax(x, axis)
        _same(lo, rlo)
        _same(hi, rhi)


@pytest.mark.parametrize("seed", range(3))
def test_weighted_means(seed):
    rng = np.random.default_rng(40 + seed)
    nr, d = int(rng.integers(2, 100)), int(rng.integers(1, 30))
    x = rng.normal(size=(nr, d)).astype(np.float32)
    w_row = (np.abs(rng.normal(size=d)) + 0.1).astype(np.float32)
    w_col = (np.abs(rng.normal(size=nr)) + 0.1).astype(np.float32)
    _close(ts.row_weighted_mean(t(x), w_row), js.row_weighted_mean(x, w_row))
    _close(ts.col_weighted_mean(t(x), w_col), js.col_weighted_mean(x, w_col))
    _close(ts.weighted_mean(t(x), w_col, axis=0),
           js.weighted_mean(x, w_col, axis=0))
    _close(ts.weighted_mean(t(x), w_row, axis=1),
           js.weighted_mean(x, w_row, axis=1))
    _close(ts.weighted_mean(t(x[:, 0]), w_col), js.weighted_mean(x[:, 0],
                                                                  w_col))


@pytest.mark.parametrize("seed", range(4))
def test_histogram_bit_for_bit(seed):
    rng = np.random.default_rng(20 + seed)
    size = int(rng.integers(50, 3000))
    bins = int(rng.integers(2, 40))
    x = rng.normal(size=(size, 3)).astype(np.float32)
    lo, hi = float(x.min()), float(x.max()) + 1e-5
    _same(ts.histogram(t(x), bins, lower=lo, upper=hi),
          js.histogram(x, bins, lower=lo, upper=hi))
    _same(ts.histogram(t(x), bins), js.histogram(x, bins))
    _same(ts.histogram(t(x[:, 0]), bins, lower=-1.0, upper=1.0),
          js.histogram(x[:, 0], bins, lower=-1.0, upper=1.0))
    # Constant data: one bin holds everything.
    _same(ts.histogram(t(np.ones((7, 2), np.float32)), 4),
          js.histogram(np.ones((7, 2), np.float32), 4))


def test_histogram_against_numpy(rng):
    x = rng.random((100, 3)).astype(np.float32)
    h = n(ts.histogram(t(x), n_bins=8, lower=0.0, upper=1.0))
    for c in range(3):
        want, _ = np.histogram(x[:, c], bins=8, range=(0.0, 1.0))
        np.testing.assert_array_equal(h[:, c], want)


def test_dispersion(rng):
    centroids = rng.standard_normal((4, 3)).astype(np.float32)
    sizes = np.array([10, 20, 5, 15])
    _close(ts.dispersion(t(centroids), t(sizes)),
           js.dispersion(centroids, sizes))
    _close(ts.dispersion(t(centroids), t(sizes), n_points=60),
           js.dispersion(centroids, sizes, n_points=60))


# -- regression -------------------------------------------------------------


@pytest.mark.parametrize("size", [100, 101])
def test_r2_and_regression_metrics(rng, size):
    y = rng.standard_normal(size).astype(np.float32)
    yp = y + 0.1 * rng.standard_normal(size).astype(np.float32)
    _close(ts.r2_score(t(y), t(yp)), js.r2_score(y, yp))
    np.testing.assert_allclose(float(ts.r2_score(t(y), t(yp))),
                               sklearn.metrics.r2_score(y, yp), rtol=1e-4)
    for got, want in zip(ts.regression_metrics(t(yp), t(y)),
                         js.regression_metrics(yp, y)):
        _close(got, want)


def test_information_criterion():
    ll = np.array([-120.0, -80.0], dtype=np.float32)
    for ic in InformationCriterionType:
        got = ts.information_criterion(t(ll), ic, 3, 100)
        want = js.information_criterion(ll, JIC[ic.name], 3, 100)
        _close(got, want, rtol=1e-6)
        assert n(got).dtype == np.asarray(want).dtype
    assert [m.value for m in InformationCriterionType] == \
        [m.value for m in JIC]


# -- classification ---------------------------------------------------------


def test_accuracy_and_contingency(rng):
    a, b = _labels(rng)
    _close(ts.accuracy(t(a), t(b)), js.accuracy(a, b), rtol=1e-6)
    _same(ts.contingency_matrix(t(a), t(b)), js.contingency_matrix(a, b))
    np.testing.assert_array_equal(
        n(ts.contingency_matrix(t(a), t(b))),
        sklearn.metrics.cluster.contingency_matrix(a, b))
    assert make_monotonic_bounds(t(a)) == js.classification \
        .make_monotonic_bounds(a)


def test_contingency_drops_labels_out_of_range(rng):
    a, b = rng.integers(-2, 9, 300), rng.integers(-3, 10, 300)
    _same(ts.contingency_matrix(t(a), t(b), min_label=0, max_label=5),
          js.contingency_matrix(a, b, min_label=0, max_label=5))
    _same(ts.contingency_matrix(t(a), t(b)), js.contingency_matrix(a, b))


# -- cluster metrics --------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_pair_and_information_metrics(seed):
    rng = np.random.default_rng(seed)
    a, b = _labels(rng, k=int(rng.integers(2, 9)))
    for name in ("rand_index", "adjusted_rand_index", "mutual_info_score",
                 "homogeneity_score", "completeness_score", "v_measure"):
        _close(getattr(ts, name)(t(a), t(b)), getattr(js, name)(a, b),
               rtol=1e-5, atol=1e-6)
    _close(ts.v_measure(t(a), t(b), beta=2.0), js.v_measure(a, b, beta=2.0))
    _close(ts.entropy(t(a)), js.entropy(a))
    _close(ts.entropy(t(a), n_classes=12), js.entropy(a, n_classes=12))
    np.testing.assert_allclose(float(ts.rand_index(t(a), t(b))),
                               sklearn.metrics.rand_score(a, b), rtol=1e-5)
    np.testing.assert_allclose(float(ts.adjusted_rand_index(t(a), t(b))),
                               sklearn.metrics.adjusted_rand_score(a, b),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(ts.mutual_info_score(t(a), t(b))),
                               sklearn.metrics.mutual_info_score(a, b),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(ts.v_measure(t(a), t(b))),
                               sklearn.metrics.v_measure_score(a, b),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(ts.entropy(t(a))),
                               scipy.stats.entropy(np.bincount(a)),
                               rtol=1e-4)


def test_trivial_clusterings():
    a = np.zeros(50, np.int64)
    for name in ("adjusted_rand_index", "homogeneity_score",
                 "completeness_score", "v_measure", "rand_index"):
        _close(getattr(ts, name)(t(a), t(a)), getattr(js, name)(a, a))
    _close(ts.adjusted_rand_index(t(a), t(a)), 1.0)


def test_kl_divergence(rng):
    p = rng.random(50).astype(np.float32)
    q = rng.random(50).astype(np.float32)
    p[3] = 0.0
    q[7] = 0.0
    p /= p.sum()
    q /= q.sum()
    _close(ts.kl_divergence(t(p), t(q)), js.kl_divergence(p, q))


def _sil_case(rng):
    x = np.concatenate([rng.standard_normal((30, 4)) + 4 * i
                        for i in range(3)]).astype(np.float32)
    return x, np.repeat(np.arange(3), 30)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cityblock"])
@pytest.mark.parametrize("chunk", [16, 1024])
def test_silhouette_score_equals_reference(rng, metric, chunk):
    x, y = _sil_case(rng)
    y[5] = 3                                   # a singleton cluster
    _close(ts.silhouette_score(t(x), t(y), metric=metric, chunk=chunk),
           js.silhouette_score(x, y, metric=metric, chunk=chunk))


def test_silhouette_score_against_sklearn(rng):
    x, y = _sil_case(rng)
    np.testing.assert_allclose(
        float(ts.silhouette_score(t(x), t(y), metric="euclidean")),
        sklearn.metrics.silhouette_score(x, y), rtol=1e-3, atol=1e-4)
    x = rng.standard_normal((45, 3)).astype(np.float32)
    y = rng.integers(0, 4, 45)
    np.testing.assert_allclose(
        float(ts.silhouette_score(t(x), t(y), metric="euclidean", chunk=16)),
        sklearn.metrics.silhouette_score(x, y), rtol=1e-3, atol=1e-4)


def test_silhouette_empty_cluster_and_refusal(rng):
    x = rng.standard_normal((40, 3)).astype(np.float32)
    y = rng.integers(0, 2, 40) * 2             # cluster 1 empty
    _close(ts.silhouette_score(t(x), t(y), n_clusters=3, metric="euclidean"),
           js.silhouette_score(x, y, n_clusters=3, metric="euclidean"))
    with pytest.raises(LogicError, match="2 populated"):
        ts.silhouette_score(t(x), t(np.zeros(40, np.int64)))


@pytest.mark.parametrize("n_neighbors", [1, 5, 12])
def test_trustworthiness_equals_reference(rng, n_neighbors):
    x = rng.standard_normal((80, 10)).astype(np.float32)
    emb = x[:, :2] + 0.01 * rng.standard_normal((80, 2)).astype(np.float32)
    got = ts.trustworthiness_score(t(x), t(emb), n_neighbors=n_neighbors)
    _close(got, js.trustworthiness_score(x, emb, n_neighbors=n_neighbors))
    np.testing.assert_allclose(float(got),
                               sk_trustworthiness(x, emb,
                                                  n_neighbors=n_neighbors),
                               rtol=1e-3, atol=1e-3)


def test_trustworthiness_rank_rule_on_ties():
    """Integer points with many equal distances: both packages rank with a
    stable order and pick embedded neighbours lowest index first."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, (60, 4)).astype(np.float32)
    emb = rng.integers(0, 2, (60, 2)).astype(np.float32)
    _close(ts.trustworthiness_score(t(x), t(emb), 4),
           js.trustworthiness_score(x, emb, 4))


def test_outputs_stay_on_the_inputs_device():
    x = t(np.ones((4, 3), np.float32))
    for out in (ts.mean(x), ts.cov(x), ts.minmax(x)[0],
                ts.histogram(x, 2), ts.entropy(t(np.arange(4)))):
        assert out.device.type == "cpu"
    if not torch.cuda.is_available():
        from raft_tpu_torch.core.error import CudaError

        with pytest.raises(CudaError):
            ts.mean(np.ones((4, 3), np.float32))
