"""raft_tpu_torch.sparse.solver and the sparse connected components
against raft_tpu's.

* ``mst``: the reference's three cases and seeded graphs, tied weights
  included (the float32 weight alteration is repeated operation for
  operation, so the same edges win): the edge set bit for bit, the
  weights equal.
* ``connected_components``: labels bit for bit.
* Lanczos: the reference draws its start vector and restart directions
  with ``jax.random``; the test makes the same draws and hands them to the
  port's basis routine, so alphas, betas and eigenvalues agree within
  1e-4 and the Ritz vectors within 1e-3 up to sign.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.sparse import neighbors as jn
from raft_tpu.sparse.linalg import laplacian as j_laplacian
from raft_tpu.sparse.solver import lanczos as jl
from raft_tpu.sparse.solver import mst as j_mst
from raft_tpu.sparse.types import csr_from_dense as j_csr_from_dense
from raft_tpu_torch.sparse import neighbors as tn
from raft_tpu_torch.sparse.linalg import laplacian as t_laplacian
from raft_tpu_torch.sparse.solver import lanczos as tl
from raft_tpu_torch.sparse.solver import mst as t_mst
from raft_tpu_torch.sparse.types import csr_from_dense
from test_torch_common import n


def _same_forest(rows, cols, w, nv):
    got = t_mst(rows, cols, w, nv, device="cpu")
    want = j_mst(rows, cols, w, nv)
    assert got.n_edges == want.n_edges
    for f in ("src", "dst", "weights"):
        g, r = n(getattr(got, f)), n(getattr(want, f))
        assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r, err_msg=f)
    return got


def test_mst_simple_graph():
    rows = np.array([0, 1, 2, 0, 1, 2, 3, 0], np.int32)
    cols = np.array([1, 2, 3, 2, 0, 1, 2, 3], np.int32)
    w = np.array([1.0, 2.0, 3.0, 10.0, 1.0, 2.0, 3.0, 10.0], np.float32)
    g = _same_forest(rows, cols, w, 4)
    assert g.n_edges == 3
    assert float(n(g.weights).sum()) == pytest.approx(6.0)


def test_mst_complete_graph_matches_scipy(rng):
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree

    nv = 30
    X = rng.normal(size=(nv, 3))
    d = ((X[:, None] - X[None]) ** 2).sum(-1)
    r, c = np.nonzero(np.ones((nv, nv)) - np.eye(nv))
    g = _same_forest(r.astype(np.int32), c.astype(np.int32),
                     d[r, c].astype(np.float32), nv)
    assert g.n_edges == nv - 1
    np.testing.assert_allclose(float(n(g.weights).sum()),
                               minimum_spanning_tree(csr_matrix(d)).sum(),
                               rtol=1e-4)


def test_mst_forest_disconnected():
    g = _same_forest(np.array([0, 2], np.int32), np.array([1, 3], np.int32),
                     np.array([1.0, 2.0], np.float32), 4)
    assert g.n_edges == 2


@pytest.mark.parametrize("levels", [None, 3, 1])
@pytest.mark.parametrize("seed", range(3))
def test_mst_seeded_graphs(seed, levels):
    """Random one-sided edge lists over several components; ``levels``
    rounds the weights to that many values (1: every weight tied)."""
    rng = np.random.default_rng(seed)
    nv, ne = 60, 150
    rows = rng.integers(0, nv, ne).astype(np.int32)
    cols = rng.integers(0, nv, ne).astype(np.int32)
    w = rng.random(ne).astype(np.float32) * 4
    if levels is not None:
        w = np.floor(w * levels / 4).astype(np.float32) + 1
    _same_forest(rows, cols, w, nv)


def test_mst_large_vertex_ids_round_the_edge_key():
    """Past 2^24 the reference's float32 edge key rounds; the port rounds
    it the same way, so tied edges break the same way."""
    rng = np.random.default_rng(11)
    nv = 5000
    rows = rng.integers(0, nv, 4000).astype(np.int32)
    cols = rng.integers(0, nv, 4000).astype(np.int32)
    w = np.ones(4000, np.float32)
    _same_forest(rows, cols, w, nv)


@pytest.mark.parametrize("seed", range(4))
def test_connected_components(seed):
    rng = np.random.default_rng(seed)
    nv = 200
    rows = rng.integers(0, nv, 150).astype(np.int32)
    cols = rng.integers(0, nv, 150).astype(np.int32)
    got = tn.connected_components(rows, cols, nv, device="cpu")
    want = jn.connected_components(jnp.asarray(rows), jnp.asarray(cols), nv)
    assert n(got).dtype == n(want).dtype
    np.testing.assert_array_equal(n(got), n(want))


def _random_path(nv):
    perm = np.random.default_rng(3).permutation(nv).astype(np.int32)
    return perm[:-1], perm[1:]


def test_connected_components_path_converges_under_the_cap():
    """A path through 200 vertices in random order takes 58 steps, under
    the cap of 64: one component, labelled 0, as the reference labels
    it."""
    rows, cols = _random_path(200)
    labels, steps = tn._connected_components(torch.as_tensor(rows),
                                             torch.as_tensor(cols), 200)
    assert 1 < steps < tn._CC_MAX_STEPS
    np.testing.assert_array_equal(n(labels), np.zeros(200, np.int32))
    np.testing.assert_array_equal(
        n(labels), n(jn.connected_components(rows, cols, 200)))


def test_connected_components_stops_at_the_cap_as_the_reference():
    """Through 500 vertices the propagation is cut at 64 steps before it
    converges, in the reference as in the port: the labels agree bit for
    bit, and both leave vertices of the one component unlabelled 0 (a
    reference defect the port keeps, ROADMAP C.2)."""
    rows, cols = _random_path(500)
    labels, steps = tn._connected_components(torch.as_tensor(rows),
                                             torch.as_tensor(cols), 500)
    want = n(jn.connected_components(rows, cols, 500))
    assert steps == tn._CC_MAX_STEPS
    np.testing.assert_array_equal(n(labels), want)
    assert (want != 0).any()


# ---------------------------------------------------------------------------
# Lanczos


def _path_laplacian(nv):
    a = np.zeros((nv, nv), np.float32)
    for i in range(nv - 1):
        a[i, i + 1] = a[i + 1, i] = 1.0
    return a


def _random_sym(nv, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((nv, nv)).astype(np.float32)
    a[a > 0.1] = 0
    a = (a + a.T) / 2
    np.fill_diagonal(a, 0)
    return a


def _ref_draws(seed, nv, ncv):
    key = jax.random.key(seed)
    v0 = jax.random.normal(key, (nv,), jnp.float32)
    rkey = jax.random.fold_in(key, 1)
    return v0, rkey, jax.random.normal(rkey, (ncv, nv), jnp.float32)


@pytest.mark.parametrize("nv,ncv,normalized", [(40, 40, False),
                                               (120, 48, True),
                                               (120, 64, False)])
def test_lanczos_basis(nv, ncv, normalized):
    a = _random_sym(nv, nv) if nv > 40 else _path_laplacian(nv)
    jL = j_laplacian(j_csr_from_dense(a), normalized)
    tL = t_laplacian(csr_from_dense(a, device="cpu"), normalized)
    v0, rkey, R = _ref_draws(5, nv, ncv)
    jV, ja, jb = jl._lanczos_basis(jL.row_ids(), jL.indices, jL.vals, v0,
                                   rkey, ncv)
    tV, ta, tb = tl._lanczos_basis(tL, torch.tensor(np.asarray(v0)),
                                   torch.tensor(np.asarray(R)), ncv)
    np.testing.assert_allclose(n(ta), n(ja), atol=1e-4)
    np.testing.assert_allclose(n(tb), n(jb), atol=1e-4)


@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("nv,k,normalized", [(40, 3, False), (150, 4, True),
                                             (150, 5, False)])
def test_lanczos_eigenpairs(nv, k, normalized, largest):
    a = _random_sym(nv, nv) if nv > 40 else _path_laplacian(nv)
    jL = j_laplacian(j_csr_from_dense(a), normalized)
    tL = t_laplacian(csr_from_dense(a, device="cpu"), normalized)
    seed = 1
    fn = "lanczos_largest_eigenpairs" if largest else \
        "lanczos_smallest_eigenpairs"
    jw, jU = getattr(jl, fn)(jL, k, seed=seed)
    ncv = tl._ncv(nv, k, None)
    v0, _, R = _ref_draws(seed, nv, ncv)
    tw, tU = tl._eigs_from(tL, k, ncv, torch.tensor(np.asarray(v0)),
                           torch.tensor(np.asarray(R)), largest)
    np.testing.assert_allclose(n(tw), n(jw), atol=1e-4)
    tU, jU = n(tU), n(jU)
    dense = n(tL.to_dense())
    for j in range(k):
        sign = np.sign(np.dot(tU[:, j], jU[:, j]))
        # A vector is fixed up to sign only where its eigenvalue is
        # simple; hold it where the gap to its neighbours is clear.
        gaps = np.abs(np.delete(n(tw), j) - n(tw)[j])
        if gaps.min() > 1e-2:
            np.testing.assert_allclose(sign * tU[:, j], jU[:, j], atol=1e-3)
        assert np.linalg.norm(dense @ tU[:, j] - n(tw)[j] * tU[:, j]) < 1e-2


def test_lanczos_public_entry_points():
    """The public entry points draw from a seeded generator: the path
    Laplacian's smallest eigenvalues (the reference test), largest
    against numpy, and two calls with one seed agree bit for bit."""
    a = _path_laplacian(40)
    L = t_laplacian(csr_from_dense(a, device="cpu"))
    dense = n(L.to_dense())
    want = np.linalg.eigvalsh(dense)
    w, U = tl.lanczos_smallest_eigenpairs(L, 3, seed=1)
    np.testing.assert_allclose(n(w), want[:3], atol=1e-2)
    for j in range(3):
        u = n(U)[:, j]
        assert np.linalg.norm(dense @ u - n(w)[j] * u) < 1e-2
    w2, U2 = tl.lanczos_smallest_eigenpairs(L, 3, seed=1)
    assert torch.equal(w, w2) and torch.equal(U, U2)
    wl, _ = tl.lanczos_largest_eigenpairs(L, 2, seed=4)
    np.testing.assert_allclose(n(wl), want[::-1][:2], atol=1e-2)


def test_lanczos_refusals():
    L = t_laplacian(csr_from_dense(_path_laplacian(10), device="cpu"))
    with pytest.raises(ValueError, match="n_components"):
        tl.lanczos_smallest_eigenpairs(L, 10)


def test_linalg_lanczos_reexports():
    mod = importlib.import_module("raft_tpu_torch.linalg.lanczos")
    ref = importlib.import_module("raft_tpu.linalg.lanczos")
    assert mod.__all__ == ref.__all__
    assert mod.lanczos_smallest_eigenpairs is tl.lanczos_smallest_eigenpairs
    assert mod.lanczos_largest_eigenpairs is tl.lanczos_largest_eigenpairs
