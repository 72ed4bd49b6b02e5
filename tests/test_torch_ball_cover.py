"""raft_tpu_torch.neighbors.ball_cover and epsilon_neighborhood against
raft_tpu's.

Mirrors tests/test_ball_cover.py. The landmark draws differ (a
``torch.Generator`` against ``jax.random``), so the parity cases hand the
port the reference's own permutation through ``_build_from_landmarks``:

* integer-grid rows (values in [0, 20)): every distance is exact in f32,
  so the index (landmarks, groups, member ids, sizes, radii) and the
  answers of ``knn_query`` / ``all_knn_query`` (distances and ids, tie
  order included) agree bit for bit, on both L2 metrics, through the
  probe widening and the dense fallback (forced by ``n_probes=1`` over 4
  landmarks);
* Gaussian rows: distances within the reference test's rtol / atol 1e-4
  of the reference's and of scipy's;
* haversine: distances within rtol 1e-5 / atol 1e-6 of the reference's,
  ids equal wherever the next distance is clear of it by 1e-5;
* chunked queries (a byte budget of one query) equal unchunked, bit for
  bit;
* ``eps_nn`` and ``eps_neighbors_l2sq``: adjacency and degrees bit for
  bit on integer rows.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

import jax

from raft_tpu.distance.distance_types import DistanceType as JD
from raft_tpu.neighbors import ball_cover as jb
from raft_tpu.neighbors.epsilon_neighborhood import eps_neighbors_l2sq as j_eps
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType as TD
from raft_tpu_torch.neighbors import ball_cover as tb
from raft_tpu_torch.neighbors import eps_neighbors_l2sq
from test_torch_common import int_data, n, t

L2 = ["L2SqrtUnexpanded", "L2Unexpanded", "L2Expanded", "L2SqrtExpanded"]


def _pair(X, metric, seed=3, n_landmarks=None):
    """The reference's index and the port's on the reference's draw."""
    ji = jb.build_index(X, getattr(JD, metric), n_landmarks=n_landmarks,
                        seed=seed)
    perm = jax.random.permutation(jax.random.key(seed), X.shape[0])
    perm = np.asarray(perm)[:ji.n_landmarks]
    ti = tb._build_from_landmarks(t(X), t(perm), getattr(TD, metric))
    return ji, ti


def _same(got, want):
    for g, w in zip(got, want):
        g, w = n(g), n(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _lat_lon(rng, rows):
    lat = rng.uniform(-np.pi / 2, np.pi / 2, size=(rows, 1))
    lon = rng.uniform(-np.pi, np.pi, size=(rows, 1))
    return np.concatenate([lat, lon], axis=1).astype(np.float32)


@pytest.mark.parametrize("metric", L2)
@pytest.mark.parametrize("dim", [2, 3])
def test_index_bit_for_bit(rng, metric, dim):
    X = int_data(rng, (400, dim), hi=20)
    ji, ti = _pair(X, metric)
    for f in ("landmarks", "groups", "group_indices", "group_sizes",
              "radii"):
        _same([getattr(ti, f)], [getattr(ji, f)])
    assert ti.n_landmarks == ji.n_landmarks == 20
    assert (ti.m, ti.n) == (ji.m, ji.n)


@pytest.mark.parametrize("metric,dim", [("L2SqrtUnexpanded", 2),
                                        ("L2Unexpanded", 3),
                                        ("L2SqrtExpanded", 3)])
@pytest.mark.parametrize("k", [1, 8])
def test_knn_query_bit_for_bit(rng, metric, dim, k):
    X = int_data(rng, (400, dim), hi=20)
    Q = int_data(rng, (64, dim), hi=20)
    ji, ti = _pair(X, metric)
    _same(tb.knn_query(ti, t(Q), k), jb.knn_query(ji, Q, k))


@pytest.mark.parametrize("dim", [2, 3])
def test_all_knn_query_bit_for_bit(rng, dim):
    X = int_data(rng, (400, dim), hi=20)
    ji, ti = _pair(X, "L2SqrtUnexpanded")
    _same(tb.all_knn_query(ti, 8), jb.all_knn_query(ji, 8))


@pytest.mark.parametrize("n_probes", [1, 2])
def test_widening_and_dense_fallback_bit_for_bit(rng, monkeypatch,
                                                 n_probes):
    """Four landmarks and one or two probes: the unresolved queries widen
    to two, then the rest take the dense scan."""
    X = int_data(rng, (400, 3), hi=20)
    Q = int_data(rng, (64, 3), hi=20)
    ji, ti = _pair(X, "L2SqrtUnexpanded", n_landmarks=4)
    calls = {"scan": 0, "dense": 0}
    scan, dense = tb._scan_probed, tb._dense

    def count_scan(*a):
        calls["scan"] += 1
        return scan(*a)

    def count_dense(*a):
        calls["dense"] += 1
        return dense(*a)

    monkeypatch.setattr(tb, "_scan_probed", count_scan)
    monkeypatch.setattr(tb, "_dense", count_dense)
    _same(tb.knn_query(ti, t(Q), 8, n_probes=n_probes),
          jb.knn_query(ji, Q, 8, n_probes=n_probes))
    assert calls["dense"] == 1
    assert calls["scan"] == (2 if n_probes == 1 else 1)


def test_chunked_equals_unchunked(rng, monkeypatch):
    X = rng.standard_normal((3000, 3)).astype(np.float32)
    Q = rng.standard_normal((120, 3)).astype(np.float32) * 1.5
    ti = tb.build_index(t(X), TD.L2SqrtUnexpanded, seed=1)
    whole = tb.knn_query(ti, t(Q), 12, n_probes=1)
    monkeypatch.setattr(tb, "_QUERY_BYTES", 1)
    assert tb._query_rows(ti, 1) == 1
    _same(tb.knn_query(ti, t(Q), 12, n_probes=1), whole)


@pytest.mark.parametrize("metric,dim", [("L2SqrtUnexpanded", 2),
                                        ("L2Unexpanded", 3)])
def test_gaussian_within_the_reference_tolerance(rng, metric, dim):
    X = rng.standard_normal((400, dim)).astype(np.float32)
    Q = rng.standard_normal((64, dim)).astype(np.float32)
    ji, ti = _pair(X, metric)
    td, ti_ = tb.knn_query(ti, t(Q), 8)
    jd, _ = jb.knn_query(ji, Q, 8)
    np.testing.assert_allclose(n(td), n(jd), rtol=1e-4, atol=1e-4)
    kind = "euclidean" if metric == "L2SqrtUnexpanded" else "sqeuclidean"
    ref = cdist(Q.astype(np.float64), X.astype(np.float64), kind)
    truth = np.sort(ref, axis=1)[:, :8]
    np.testing.assert_allclose(n(td), truth, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.take_along_axis(ref, n(ti_), 1), truth,
                               rtol=1e-4, atol=1e-4)


def test_haversine_against_the_reference(rng):
    X = _lat_lon(rng, 400)
    Q = X[:64] + 0.01
    ji, ti = _pair(X, "Haversine")
    for f in ("group_sizes", "group_indices"):
        _same([getattr(ti, f)], [getattr(ji, f)])
    np.testing.assert_allclose(n(ti.radii), n(ji.radii), rtol=1e-5,
                               atol=1e-6)
    td, tI = tb.knn_query(ti, t(Q), 8)
    jd, jI = jb.knn_query(ji, Q, 8)
    td, tI, jd, jI = n(td), n(tI), n(jd), n(jI)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    gap = np.diff(np.concatenate([jd, np.full((64, 1), np.inf)], 1), axis=1)
    prev = np.diff(np.concatenate([np.full((64, 1), -np.inf), jd], 1),
                   axis=1)
    clear = (gap > 1e-5) & (prev > 1e-5)
    np.testing.assert_array_equal(tI[clear], jI[clear])


def test_empty_query_set(rng):
    X = int_data(rng, (400, 2), hi=20)
    ji, ti = _pair(X, "L2SqrtUnexpanded")
    Q = np.zeros((0, 2), np.float32)
    _same(tb.knn_query(ti, t(Q), 5), jb.knn_query(ji, Q, 5))


def test_build_index_draw(rng):
    X = rng.standard_normal((900, 2)).astype(np.float32)
    a = tb.build_index(t(X), seed=4)
    b = tb.build_index(t(X), seed=4)
    _same([a.landmarks, a.group_indices], [b.landmarks, b.group_indices])
    assert a.n_landmarks == 30
    assert np.unique(n(a.landmarks), axis=0).shape[0] == 30
    members = n(a.group_indices)
    np.testing.assert_array_equal(np.sort(members[members >= 0]),
                                  np.arange(900))
    assert int(n(a.group_sizes).sum()) == 900


def test_eps_nn_bit_for_bit(rng):
    X = int_data(rng, (400, 2), hi=20)
    Q = int_data(rng, (64, 2), hi=20)
    ji, ti = _pair(X, "L2SqrtUnexpanded")
    got = tb.eps_nn(ti, t(Q), 3.0)
    _same(got, jb.eps_nn(ji, Q, 3.0))
    ref = cdist(Q, X) <= 3.0
    np.testing.assert_array_equal(n(got[0]), ref)
    np.testing.assert_array_equal(n(got[1]), ref.sum(1))


def test_refusals(rng):
    with pytest.raises(LogicError):
        tb.build_index(t(rng.standard_normal((100, 4)).astype(np.float32)))
    with pytest.raises(LogicError):
        tb.build_index(t(rng.standard_normal((100, 3)).astype(np.float32)),
                       TD.Haversine)
    with pytest.raises(LogicError):
        tb.build_index(t(rng.standard_normal((100, 2)).astype(np.float32)),
                       TD.L1)
    ti = tb.build_index(t(rng.standard_normal((100, 2)).astype(np.float32)))
    with pytest.raises(LogicError):
        tb.knn_query(ti, t(np.zeros((3, 3), np.float32)), 2)
    with pytest.raises(LogicError):
        tb.knn_query(ti, t(np.zeros((3, 2), np.float32)), 101)


@pytest.mark.parametrize("shape", [(60, 200, 5), (1, 7, 1), (33, 33, 16)])
def test_eps_neighbors_l2sq_bit_for_bit(rng, shape):
    m, nn, d = shape
    x = int_data(rng, (m, d))
    y = int_data(rng, (nn, d))
    eps_sq = float(d * 4)
    got = eps_neighbors_l2sq(t(x), t(y), eps_sq)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    _same(got, j_eps(x, y, eps_sq))
    assert int(got[1][-1]) == int(n(got[0]).sum())


def test_eps_neighbors_l2sq_blocks(rng, monkeypatch):
    """Row blocks of x change nothing (blocks of 3 rows here)."""
    from raft_tpu_torch.neighbors import epsilon_neighborhood as en

    x = rng.standard_normal((40, 8)).astype(np.float32)
    y = rng.standard_normal((90, 8)).astype(np.float32)
    whole = eps_neighbors_l2sq(t(x), t(y), 9.0)
    monkeypatch.setattr(en, "_BLOCK_ELEMS", 270)
    _same(eps_neighbors_l2sq(t(x), t(y), 9.0), whole)
    with pytest.raises(LogicError):
        eps_neighbors_l2sq(t(x), t(y[:, :4]), 9.0)
