"""raft_tpu_torch.sparse.neighbors against raft_tpu.sparse.neighbors.

``brute_force_knn`` is ``knn_blocked``; ``knn_graph`` and
``connect_components`` run on well-separated blobs, where no distance
ties, so edge ids are held bit for bit and squared distances within 2e-6
of |x|^2 + |y|^2 at their largest (the expanded form's rounding, the bar
of ``chip_smoke.norm_tol``); one ``knn_graph`` case runs through several
small query chunks with a ragged tail.
"""

import numpy as np
import pytest
import torch

from raft_tpu.sparse import neighbors as jn
from raft_tpu.sparse.types import csr_from_dense as j_csr_from_dense
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.sparse import neighbors as tn
from raft_tpu_torch.sparse.types import csr_from_dense
from test_torch_common import blobs, n

REL_NORM_TOL = 2e-6


def _same_edges(got, want, X, sqrt=True):
    assert got.shape == want.shape
    for f in ("rows", "cols"):
        g, w = n(getattr(got, f)), n(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    g, w = n(got.vals).astype(np.float64), n(want.vals).astype(np.float64)
    if sqrt:
        g, w = g * g, w * w
    tol = REL_NORM_TOL * 2 * float((np.asarray(X, np.float64) ** 2)
                                   .sum(1).max())
    np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("seed", range(3))
def test_brute_force_knn(seed):
    rng = np.random.default_rng(seed)
    a = rng.random((50, 10)).astype(np.float32)
    a[a > 0.2] = 0
    q = rng.random((30, 10)).astype(np.float32)
    q[q > 0.2] = 0
    a[:, 0] = q[:, 0] = 1.0      # no empty rows: no tied zero distances
    gd, gi = tn.brute_force_knn(csr_from_dense(a, device="cpu"),
                                csr_from_dense(q, device="cpu"), 5)
    wd, wi = jn.brute_force_knn(j_csr_from_dense(a), j_csr_from_dense(q), 5)
    np.testing.assert_array_equal(n(gi), n(wi))
    np.testing.assert_allclose(n(gd), n(wd), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", [DistanceType.L2SqrtExpanded,
                                    DistanceType.L2Expanded])
@pytest.mark.parametrize("k", [3, 8])
def test_knn_graph(k, metric):
    X = blobs(np.random.default_rng(1), 300, 8, 6)
    got = tn.knn_graph(torch.as_tensor(X), k, metric=metric)
    _same_edges(got, jn.knn_graph(X, k, metric=metric), X,
                metric == DistanceType.L2SqrtExpanded)
    rows, cols = n(got.rows), n(got.cols)
    assert (np.bincount(rows, minlength=300) == k).all()
    assert (rows != cols).all()


def test_knn_graph_numpy_input_takes_device():
    X = blobs(np.random.default_rng(2), 40, 4, 2)
    got = tn.knn_graph(X, 3, device="cpu")
    assert got.rows.device.type == "cpu"
    _same_edges(got, jn.knn_graph(X, 3), X)


def test_knn_graph_k_past_n():
    X = blobs(np.random.default_rng(3), 6, 4, 2)
    got = tn.knn_graph(torch.as_tensor(X), 10)
    _same_edges(got, jn.knn_graph(X, 10), X)
    assert got.nnz == 6 * 5


def test_knn_graph_through_several_chunks(monkeypatch):
    """Chunks of 64 queries over 300 rows: four full chunks and a ragged
    tail padded with the first rows, against the reference's one
    search."""
    monkeypatch.setattr(tn, "_KNN_GRAPH_CHUNK", 64)
    X = blobs(np.random.default_rng(4), 300, 8, 6)
    _same_edges(tn.knn_graph(torch.as_tensor(X), 5), jn.knn_graph(X, 5), X)


def _separated(rng, sizes, dim=4, gap=30.0):
    parts = [rng.standard_normal((s, dim)).astype(np.float32) + gap * i
             for i, s in enumerate(sizes)]
    labels = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)])
    return np.concatenate(parts), labels


@pytest.mark.parametrize("sizes", [(10, 10), (7, 20, 13, 1)])
def test_connect_components(sizes):
    X, labels = _separated(np.random.default_rng(5), sizes)
    got = tn.connect_components(torch.as_tensor(X), torch.as_tensor(labels))
    _same_edges(got, jn.connect_components(X, labels), X)
    r, c = n(got.rows), n(got.cols)
    assert (labels[r] != labels[c]).all()


def test_connect_components_several_chunks_and_tiles(monkeypatch):
    """Chunks of 16 rows against tiles of 8 (ragged both): the running
    arg-min across tiles keeps the first of equal minima."""
    monkeypatch.setattr(tn, "_CCOMP_XCHUNK", 16)
    monkeypatch.setattr(tn, "_CCOMP_YTILE", 8)
    X, labels = _separated(np.random.default_rng(6), (9, 14, 20))
    X = np.round(X)                # integer rows: exact distances, ties
    got = tn.connect_components(torch.as_tensor(X), torch.as_tensor(labels),
                                metric=DistanceType.L2Expanded)
    want = jn.connect_components(X, labels, metric=DistanceType.L2Expanded)
    _same_edges(got, want, X, sqrt=False)


def test_connect_components_one_component():
    X, labels = _separated(np.random.default_rng(7), (12,))
    got = tn.connect_components(torch.as_tensor(X), torch.as_tensor(labels))
    assert got.nnz == 0 == jn.connect_components(X, labels).nnz


def test_knn_graph_components_and_linking():
    """The slice as a whole: the kNN graph of separated blobs, its
    components, the linking edges and the MST over both, each against the
    reference."""
    import jax.numpy as jnp

    from raft_tpu.sparse import linalg as jlin
    from raft_tpu.sparse.solver import mst as j_mst
    from raft_tpu_torch.sparse import linalg as tlin
    from raft_tpu_torch.sparse.solver import mst as t_mst

    X, _ = _separated(np.random.default_rng(8), (30, 25, 40), dim=6)
    tg = tn.knn_graph(torch.as_tensor(X), 4)
    jg = jn.knn_graph(X, 4)
    ts, js = tlin.symmetrize(tg), jlin.symmetrize(jg)
    np.testing.assert_array_equal(n(ts.rows), n(js.rows))
    lab = tn.connected_components(ts.rows, ts.cols, X.shape[0])
    jlab = jn.connected_components(js.rows, js.cols, X.shape[0])
    np.testing.assert_array_equal(n(lab), n(jlab))
    assert len(np.unique(n(lab))) == 3
    tl = tn.connect_components(torch.as_tensor(X), lab)
    jl = jn.connect_components(X, np.asarray(jlab))
    _same_edges(tl, jl, X)
    rows = torch.cat([tg.rows, tl.rows])
    cols = torch.cat([tg.cols, tl.cols])
    w = torch.cat([tg.vals, tl.vals])
    got = t_mst(rows, cols, w, X.shape[0])
    want = j_mst(jnp.concatenate([jg.rows, jl.rows]),
                 jnp.concatenate([jg.cols, jl.cols]),
                 jnp.concatenate([jg.vals, jl.vals]), X.shape[0])
    assert got.n_edges == want.n_edges == X.shape[0] - 1
    np.testing.assert_array_equal(n(got.src), n(want.src))
    np.testing.assert_array_equal(n(got.dst), n(want.dst))


def test_numpy_inputs_go_to_the_card_or_raise():
    """Functions that build from dense rows or edge lists place numpy
    inputs on ``cuda`` unless told otherwise, and raise without a card."""
    from raft_tpu_torch.core.error import CudaError
    from raft_tpu_torch.sparse import convert
    from raft_tpu_torch.sparse.solver import mst as t_mst
    from raft_tpu_torch.sparse.types import coo_from_dense

    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    a = np.eye(4, dtype=np.float32)
    e = np.array([0, 1], np.int32)
    for call in (lambda: coo_from_dense(a), lambda: csr_from_dense(a),
                 lambda: convert.dense_to_coo(a),
                 lambda: convert.dense_to_csr(a),
                 lambda: tn.knn_graph(a, 2),
                 lambda: tn.connected_components(e, e[::-1], 4),
                 lambda: tn.connect_components(a, np.arange(4)),
                 lambda: t_mst(e, e[::-1], np.ones(2, np.float32), 4)):
        with pytest.raises(CudaError):
            call()
