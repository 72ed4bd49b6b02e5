"""raft_tpu_torch.cluster.single_linkage against raft_tpu's.

Mirrors tests/test_graph.py's TestSingleLinkage and tests/test_native.py's
dendrogram case:

* both connectivities on integer-valued, well-separated blobs (every
  distance exact in f32, so the kNN graph, the component links, the MST
  and its tie breaks are the reference's): labels, children, distances
  and sizes bit for bit;
* the port's native dendrogram walk bit for bit against the reference's
  Python walk (its library switched off);
* scipy's single-linkage heights within rtol 1e-5 (test_graph.py holds
  the reference to 1e-4);
* the refusals: an invalid ``n_clusters``, non-finite MST weights.
"""

import importlib

import numpy as np
import pytest

from raft_tpu import _native as j_native
from raft_tpu.cluster import LinkageDistance as JLink
from raft_tpu.cluster import single_linkage as j_single_linkage
from raft_tpu_torch import _native as t_native
from raft_tpu_torch.cluster import LinkageDistance, LinkageOutput
from raft_tpu_torch.cluster import single_linkage
from raft_tpu_torch.core.error import LogicError
from test_torch_common import n, t

j_sl = importlib.import_module("raft_tpu.cluster.single_linkage")
t_sl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")


def _int_blobs(rng, rows, dim, n_blobs, spread=40):
    """Integer-valued blobs whose centers lie far apart."""
    centers = rng.integers(0, spread, (n_blobs, dim)) * 8
    y = np.arange(rows) % n_blobs
    X = centers[y] + rng.integers(-3, 4, (rows, dim))
    return X.astype(np.float32), y


def _same(got: LinkageOutput, want):
    assert got.n_clusters == want.n_clusters
    np.testing.assert_array_equal(n(got.labels), n(want.labels))
    for f in ("children", "distances", "sizes"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("rows,dim,n_blobs,clusters",
                         [(60, 2, 2, 2), (150, 5, 4, 4), (200, 3, 6, 3)])
def test_pairwise_bit_for_bit(rng, rows, dim, n_blobs, clusters):
    X, _ = _int_blobs(rng, rows, dim, n_blobs)
    got = single_linkage(t(X), clusters, dist_type=LinkageDistance.PAIRWISE)
    _same(got, j_single_linkage(X, clusters, dist_type=JLink.PAIRWISE))
    assert len(np.unique(n(got.labels))) == clusters


@pytest.mark.parametrize("rows,dim,n_blobs,c", [(100, 2, 2, 5),
                                                (300, 4, 5, 8),
                                                (400, 3, 8, 15)])
def test_knn_graph_bit_for_bit(rng, rows, dim, n_blobs, c):
    """The blobs leave the kNN graph in pieces, so the component links
    join it."""
    X, y = _int_blobs(rng, rows, dim, n_blobs)
    got = single_linkage(t(X), n_blobs, dist_type=LinkageDistance.KNN_GRAPH,
                         c=c)
    _same(got, j_single_linkage(X, n_blobs, dist_type=JLink.KNN_GRAPH, c=c))
    lab = n(got.labels)
    for b in range(n_blobs):
        assert len(np.unique(lab[y == b])) == 1


def test_small_input_takes_the_pairwise_graph(rng):
    X, _ = _int_blobs(rng, 12, 3, 2)
    got = single_linkage(t(X), 2, c=15)            # n <= c + 1
    _same(got, j_single_linkage(X, 2, c=15))


def test_squared_metric(rng):
    from raft_tpu.distance.distance_types import DistanceType as JD
    from raft_tpu_torch.distance.distance_types import DistanceType as TD

    X, _ = _int_blobs(rng, 80, 3, 3)
    got = single_linkage(t(X), 3, metric=TD.L2Expanded,
                         dist_type=LinkageDistance.PAIRWISE)
    _same(got, j_single_linkage(X, 3, metric=JD.L2Expanded,
                                dist_type=JLink.PAIRWISE))


def test_native_dendrogram_against_the_python_walk(rng, monkeypatch):
    """The port's native walk against the reference's Python body (its
    library switched off), on a random spanning tree with tied weights."""
    size = 600
    src = np.arange(1, size, dtype=np.int32)
    dst = rng.integers(0, src).astype(np.int32)
    w = rng.integers(0, 50, size - 1).astype(np.float32)
    monkeypatch.setattr(j_native, "get_lib", lambda: None)
    for clusters in (1, 7, size):
        got = t_sl._dendrogram(src, dst, w, size, clusters)
        want = j_sl._dendrogram(src, dst, w, size, clusters)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_matches_scipy_dendrogram_heights(rng):
    from scipy.cluster.hierarchy import linkage

    X = rng.normal(size=(25, 3)).astype(np.float32)
    out = single_linkage(t(X), 1, dist_type=LinkageDistance.PAIRWISE)
    ref = linkage(X.astype(np.float64), method="single", metric="euclidean")
    np.testing.assert_allclose(np.sort(out.distances), np.sort(ref[:, 2]),
                               rtol=1e-5)
    assert out.children.shape == (24, 2)
    assert int(out.sizes[-1]) == 25


def test_gaussian_against_the_reference(rng):
    """Gaussian rows: the two sum the squared differences in different
    orders, so the heights agree within rtol 1e-6 and the labels of
    well-separated blobs bit for bit."""
    X = np.concatenate([rng.normal(size=(40, 4)),
                        rng.normal(size=(40, 4)) + 30.0]).astype(np.float32)
    got = single_linkage(t(X), 2, dist_type=LinkageDistance.PAIRWISE)
    want = j_single_linkage(X, 2, dist_type=JLink.PAIRWISE)
    np.testing.assert_array_equal(n(got.labels), n(want.labels))
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-6)


def test_refusals(rng, monkeypatch):
    X = rng.normal(size=(20, 3)).astype(np.float32)
    for bad in (0, 21):
        with pytest.raises(LogicError):
            single_linkage(t(X), bad)
    src = np.array([0, 1], np.int32)
    dst = np.array([1, 2], np.int32)
    with pytest.raises(LogicError, match="finite"):
        t_sl._dendrogram(src, dst, np.array([1.0, np.nan]), 3, 1)
    with pytest.raises(LogicError, match="overflow"):
        t_sl._dendrogram(src, dst, np.array([1.0, 1e300]), 3, 1)

    def broken():
        raise t_native.NativeBuildError("no compiler")

    monkeypatch.setattr(t_native, "get_lib", broken)
    with pytest.raises(t_native.NativeBuildError):
        single_linkage(t(X), 2, dist_type=LinkageDistance.PAIRWISE)
