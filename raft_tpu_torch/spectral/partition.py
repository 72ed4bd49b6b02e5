"""Spectral partitioning and modularity maximisation, and their quality
measures.

Port of ``raft_tpu/spectral/partition.py`` (RAFT's
``spectral/partition.cuh``, ``modularity_maximization.cuh`` and the
analysis routines):

* :func:`partition`: the graph Laplacian (``sparse.linalg.laplacian``),
  its smallest eigenpairs by Lanczos (``sparse.solver``, seeded with
  ``EigenSolverConfig.seed``), the embedding's rows normalised, then Lloyd
  k-means (``cluster.kmeans.fit_predict``, whose assignments are kernel
  B1 at k=1 on ``cuda``) seeded with ``ClusterSolverConfig.seed``;
* :func:`modularity_maximization`: the dense modularity matrix
  B = A - d d^T / 2m and its largest eigenpairs by ``torch.linalg.eigh``
  (the reference's dense ``eigh``), then the same normalisation and
  k-means;
* :func:`analyze_partition` and :func:`analyze_modularity` count on the
  host in numpy over the graph's COO, as the reference does.

Both draw from ``torch.Generator`` s, so their random numbers differ from
the reference's ``jax.random`` ones; the tests hand both packages the
same Lanczos draws and initial centroids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans as kmeans_mod
from raft_tpu_torch.cluster.kmeans_types import KMeansParams
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.random.rng_state import RngState
from raft_tpu_torch.sparse import convert, linalg as slinalg
from raft_tpu_torch.sparse.solver import lanczos_smallest_eigenpairs
from raft_tpu_torch.sparse.types import CSR


@dataclass
class EigenSolverConfig:
    """The eigensolver's settings (``eigen_solver_config_t``); the port's
    Lanczos reads ``n_eigVecs`` and ``seed``, as the reference's does."""

    n_eigVecs: int = 2
    maxIter: int = 4000
    restartIter: int = 0
    tol: float = 1e-4
    seed: int = 1234567


@dataclass
class ClusterSolverConfig:
    """The k-means settings (``cluster_solver_config_t``)."""

    n_clusters: int = 2
    maxIter: int = 100
    tol: float = 1e-4
    seed: int = 123456


def _cluster_rows(U: torch.Tensor, cfg: ClusterSolverConfig
                  ) -> torch.Tensor:
    """Lloyd k-means labels of the row-normalised embedding ``U``."""
    emb = U / torch.clamp_min(torch.linalg.vector_norm(U, dim=1,
                                                       keepdim=True), 1e-12)
    params = KMeansParams(n_clusters=cfg.n_clusters, max_iter=cfg.maxIter,
                          tol=cfg.tol, rng_state=RngState(seed=cfg.seed))
    _, labels, _, _ = kmeans_mod.fit_predict(params, emb)
    return labels


@traced
def partition(
    adj: CSR,
    n_clusters: int,
    n_eig_vecs: int = 0,
    eig_config: EigenSolverConfig = None,
    cluster_config: ClusterSolverConfig = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spectral partition of an undirected graph on its device: the
    Laplacian's smallest eigenvectors, rows normalised, k-means. Returns
    ``(labels (n,), eigenvalues (k,), eigenvectors (n, k))``."""
    eig_config = eig_config or EigenSolverConfig(
        n_eigVecs=n_eig_vecs or n_clusters)
    cluster_config = cluster_config or ClusterSolverConfig(
        n_clusters=n_clusters)
    L = slinalg.laplacian(adj)
    evals, evecs = lanczos_smallest_eigenpairs(L, eig_config.n_eigVecs,
                                               seed=eig_config.seed)
    return _cluster_rows(evecs, cluster_config), evals, evecs


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def analyze_partition(adj: CSR, labels, n_clusters: int
                      ) -> Tuple[float, float]:
    """Edge cut (each undirected edge once) and cost, the sum over the
    clusters of cut(c) / size(c)."""
    coo = convert.csr_to_coo(adj)
    lab = _host(labels)
    r, c, w = _host(coo.rows), _host(coo.cols), _host(coo.vals)
    cross = lab[r] != lab[c]
    edge_cut = float(w[cross].sum()) / 2.0
    cost = 0.0
    for cl in range(n_clusters):
        size = max(int((lab == cl).sum()), 1)
        cut_c = float(w[cross & (lab[r] == cl)].sum())
        cost += cut_c / size
    return edge_cut, cost


@traced
def modularity_maximization(
    adj: CSR,
    n_clusters: int,
    eig_config: EigenSolverConfig = None,
    cluster_config: ClusterSolverConfig = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cluster by the largest eigenvectors of the modularity matrix
    B = A - d d^T / 2m, formed dense on the graph's device. Returns
    ``(labels, eigenvalues (largest first), eigenvectors)``."""
    eig_config = eig_config or EigenSolverConfig(n_eigVecs=n_clusters)
    cluster_config = cluster_config or ClusterSolverConfig(
        n_clusters=n_clusters)
    k = eig_config.n_eigVecs
    A = adj.to_dense()
    d = torch.sum(A, dim=1)
    two_m = torch.clamp_min(torch.sum(d), 1e-12)
    B = A - torch.outer(d, d) / two_m
    evals, evecs = torch.linalg.eigh(B)
    idx = torch.arange(B.shape[0] - 1, B.shape[0] - k - 1, -1,
                       device=B.device)
    w, U = evals[idx], evecs[:, idx]
    return _cluster_rows(U, cluster_config), w, U


def analyze_modularity(adj: CSR, labels) -> float:
    """Modularity Q of a labelling."""
    coo = convert.csr_to_coo(adj)
    lab = _host(labels)
    r, c, w = _host(coo.rows), _host(coo.cols), _host(coo.vals)
    two_m = max(w.sum(), 1e-12)
    deg = np.zeros(adj.shape[0])
    np.add.at(deg, r, w)
    same = lab[r] == lab[c]
    q = w[same].sum() / two_m
    for cl in np.unique(lab):
        dc = deg[lab == cl].sum()
        q -= (dc / two_m) ** 2
    return float(q)
