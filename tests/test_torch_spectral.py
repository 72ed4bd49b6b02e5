"""raft_tpu_torch.spectral against raft_tpu.spectral.

Mirrors tests/test_graph.py's TestSpectral and
tests/test_spectral_properties.py's planted partitions. The two packages
draw from different generators, so each case hands both the same random
numbers:

* Lanczos: the reference draws its start vector and restart directions
  with ``jax.random`` from ``EigenSolverConfig.seed``; the test makes the
  same draws and the port's ``partition`` runs ``_eigs_from`` on them;
* k-means: both start Lloyd from ``InitMethod.Array`` centroids, the rows
  of their own embedding at the same indices (one row of each planted
  block).

Tolerances: eigenvalues within 1e-5, eigenvectors within 1e-4 up to sign
(every planted eigenvalue is clear of its neighbours), ``partition``'s
labels bit for bit; ``modularity_maximization``'s eigenvalues within 1e-5
of the largest and its labels equal up to a permutation; both analyzers
within 1e-6 of the reference's.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest
import scipy.sparse
import torch
from sklearn.metrics import adjusted_rand_score

import jax
import jax.numpy as jnp

from raft_tpu.cluster.kmeans_types import InitMethod as JInit
from raft_tpu.sparse.types import CSR as JCSR
from raft_tpu_torch.cluster.kmeans_types import InitMethod
from raft_tpu_torch.sparse.solver import lanczos as tl
from raft_tpu_torch.sparse.types import CSR
from raft_tpu_torch.spectral import (
    ClusterSolverConfig,
    EigenSolverConfig,
    analyze_modularity,
    analyze_partition,
    modularity_maximization,
    partition,
)
from test_torch_common import n

# The packages export the function ``partition``, which shadows its
# module.
jp = importlib.import_module("raft_tpu.spectral.partition")
tp = importlib.import_module("raft_tpu_torch.spectral.partition")


def _planted(rng, n_blocks, block, p_in=0.4, p_out=0.01):
    """A planted-partition graph (scipy CSR, f32 weights 1), its blocks
    chained by one edge each so it is connected."""
    size = n_blocks * block
    same = (np.arange(size)[:, None] // block) == (np.arange(size) // block)
    a = rng.random((size, size)) < np.where(same, p_in, p_out)
    a = np.triu(a, 1)
    for b in range(n_blocks - 1):
        a[b * block, (b + 1) * block] = True
    a = (a | a.T).astype(np.float32)
    return scipy.sparse.csr_matrix(a)


def _both(sp):
    sp = sp.tocsr().astype(np.float32)
    j = JCSR(jnp.asarray(sp.indptr.astype(np.int32)),
             jnp.asarray(sp.indices.astype(np.int32)), jnp.asarray(sp.data),
             sp.shape)
    t = CSR(torch.as_tensor(sp.indptr.astype(np.int32)),
            torch.as_tensor(sp.indices.astype(np.int32)),
            torch.as_tensor(sp.data), sp.shape)
    return j, t


def _shared_init(module, monkeypatch, rows):
    """Lloyd from the embedding's rows ``rows`` in ``module``."""
    real = module.kmeans_mod

    def fit_predict(params, X, **kw):
        params = dataclasses.replace(params, init=type(params.init).Array)
        return real.fit_predict(params, X, centroids_init=X[rows])

    monkeypatch.setattr(module, "kmeans_mod",
                        types.SimpleNamespace(fit_predict=fit_predict))


def _shared_lanczos(monkeypatch, seed):
    """The port's Lanczos on the reference's draws for ``seed``."""

    def smallest(L, k, seed=seed):
        size = L.shape[0]
        ncv = tl._ncv(size, k, None)
        key = jax.random.key(seed)
        v0 = jax.random.normal(key, (size,), jnp.float32)
        R = jax.random.normal(jax.random.fold_in(key, 1), (ncv, size),
                              jnp.float32)
        return tl._eigs_from(L, k, ncv, torch.as_tensor(np.asarray(v0)),
                             torch.as_tensor(np.asarray(R)), False)

    monkeypatch.setattr(tp, "lanczos_smallest_eigenpairs", smallest)


def _same_vectors(got, want, tol):
    got, want = n(got), n(want)
    for j in range(got.shape[1]):
        sign = np.sign(np.dot(got[:, j], want[:, j]))
        np.testing.assert_allclose(sign * got[:, j], want[:, j], atol=tol)


@pytest.mark.parametrize("n_blocks,block,seed", [(2, 30, 0), (3, 40, 1),
                                                 (4, 30, 2)])
def test_partition_against_the_reference(monkeypatch, n_blocks, block, seed):
    rng = np.random.default_rng(100 + seed)
    jA, tA = _both(_planted(rng, n_blocks, block))
    rows = np.arange(n_blocks) * block
    _shared_init(jp, monkeypatch, rows)
    _shared_init(tp, monkeypatch, torch.as_tensor(rows))
    _shared_lanczos(monkeypatch, EigenSolverConfig().seed)
    jl, jw, jU = jp.partition(jA, n_blocks)
    tl_, tw, tU = partition(tA, n_blocks)
    np.testing.assert_allclose(n(tw), n(jw), atol=1e-5)
    _same_vectors(tU, jU, 1e-4)
    np.testing.assert_array_equal(n(tl_), n(jl))
    truth = np.repeat(np.arange(n_blocks), block)
    assert adjusted_rand_score(truth, n(tl_)) == 1.0


def test_partition_two_cliques():
    """The reference test's graph through the port alone (its own
    draws)."""
    a = np.zeros((20, 20), np.float32)
    a[:10, :10] = 1.0
    a[10:, 10:] = 1.0
    np.fill_diagonal(a, 0.0)
    a[0, 10] = a[10, 0] = 0.1
    _, tA = _both(scipy.sparse.csr_matrix(a))
    lab, w, U = partition(tA, 2)
    lab = n(lab)
    assert (lab[:10] == lab[0]).all() and (lab[10:] == lab[10]).all()
    assert lab[0] != lab[10]
    assert U.shape == (20, 2) and abs(float(w[0])) < 1e-4
    cut, cost = analyze_partition(tA, lab, 2)
    assert cut == pytest.approx(0.1, abs=1e-6)


@pytest.mark.parametrize("n_blocks,block,seed", [(2, 25, 3), (4, 30, 4)])
def test_modularity_against_the_reference(monkeypatch, n_blocks, block,
                                          seed):
    rng = np.random.default_rng(200 + seed)
    jA, tA = _both(_planted(rng, n_blocks, block, p_in=0.5, p_out=0.02))
    rows = np.arange(n_blocks) * block
    _shared_init(jp, monkeypatch, rows)
    _shared_init(tp, monkeypatch, torch.as_tensor(rows))
    jl, jw, jU = jp.modularity_maximization(jA, n_blocks)
    tl_, tw, tU = modularity_maximization(tA, n_blocks)
    np.testing.assert_allclose(n(tw), n(jw), atol=1e-5 * float(n(jw)[0]))
    assert adjusted_rand_score(n(jl), n(tl_)) == 1.0
    truth = np.repeat(np.arange(n_blocks), block)
    assert adjusted_rand_score(truth, n(tl_)) == 1.0
    assert float(analyze_modularity(tA, n(tl_))) > 0.3


@pytest.mark.parametrize("seed", range(3))
def test_analyzers_against_the_reference(seed):
    rng = np.random.default_rng(300 + seed)
    sp = _planted(rng, 3, 20, p_in=0.3, p_out=0.05)
    sp.data = rng.random(sp.nnz).astype(np.float32) + 0.5
    sp = ((sp + sp.T) * 0.5).tocsr()
    jA, tA = _both(sp)
    labels = rng.integers(0, 3, 60)
    got = analyze_partition(tA, torch.as_tensor(labels), 3)
    want = jp.analyze_partition(jA, labels, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(analyze_modularity(tA, labels),
                               jp.analyze_modularity(jA, labels), rtol=1e-6)


def test_configs_and_defaults():
    assert EigenSolverConfig() == EigenSolverConfig(2, 4000, 0, 1e-4, 1234567)
    assert ClusterSolverConfig() == ClusterSolverConfig(2, 100, 1e-4, 123456)
    assert InitMethod.Array.name == JInit.Array.name
