"""Multi-rank k-means: shard the samples, allreduce the sufficient
statistics.

Port of ``raft_tpu/parallel/kmeans.py`` (cuML's kmeans-MG recipe on the
comms primitives): each rank assigns its rows to the current centroids
with the fused L2 arg-min (kernel B1 with k=1 on the card), sums its
rows and counts per cluster (``index_add_``), and one allreduce gives
every rank the same new centroids. The entry points are collective: each
rank calls them with the same arguments (the whole matrix, or its
:class:`~raft_tpu_torch.parallel.knn.RowShard`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.cluster.kmeans_balanced import _segment_sum
from raft_tpu_torch.comms.comms import Comms, Mesh
from raft_tpu_torch.comms.topk_merge import resolve_merge_engine, topk_merge
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_float
from raft_tpu_torch.core.sentinels import worst_value
from raft_tpu_torch.distance.fused_l2_nn import _min_reduce
from raft_tpu_torch.matrix.select_k import stable_top_k
from raft_tpu_torch.parallel.degraded import expects_finite_all
from raft_tpu_torch.parallel.knn import RowShard, shard_database

# Clusters below this share of the mean population are re-seeded (the
# reference's balancing threshold).
_SMALL_RATIO = 0.25


def _em_step(comms: Comms, X, centroids):
    """One Lloyd step on this rank's rows: ``(new centroids, inertia)``,
    the same on every rank."""
    k = centroids.shape[0]
    dists, labels = _min_reduce(X, centroids)
    ones = torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
    sums = comms.allreduce(_segment_sum(X, labels, k))
    counts = comms.allreduce(_segment_sum(ones, labels, k))
    inertia = comms.allreduce(torch.sum(dists)[None])[0]
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where((counts > 0)[:, None], new, centroids), inertia


def _checked(mesh: Mesh, X, centroids=None):
    """This rank's shard and the centroids on the mesh's device, finite
    on every rank."""
    shard = shard_database(mesh, X)
    comms = Comms(mesh)
    ops = [shard.rows]
    if centroids is not None:
        centroids = as_float(centroids, device=mesh.device)
        expects(centroids.device == mesh.device,
                "centroids on %s, mesh on %s", centroids.device, mesh.device)
        expects(centroids.ndim == 2
                and centroids.shape[1] == shard.rows.shape[1],
                "centroids must be (k, %s)", shard.rows.shape[1])
        ops.append(centroids)
    expects_finite_all(comms, "sharded_kmeans", *ops)
    return comms, shard, centroids


def sharded_kmeans_step(mesh: Mesh, X, centroids
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EM step with the rows of ``X`` sharded over the mesh; returns
    the new (replicated) centroids and the global inertia."""
    comms, shard, centroids = _checked(mesh, X, centroids)
    return _em_step(comms, shard.rows, centroids)


def sharded_kmeans_fit(mesh: Mesh, X, centroids0, n_iters: int = 20
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distributed Lloyd fit: ``n_iters`` steps from ``centroids0``.
    Returns ``(centroids, inertia)``, both replicated."""
    comms, shard, centroids = _checked(mesh, X, centroids0)
    inertia = torch.tensor(worst_value(True), dtype=shard.rows.dtype,
                           device=mesh.device)
    for _ in range(n_iters):
        centroids, inertia = _em_step(comms, shard.rows, centroids)
    return centroids, inertia


def _fetch_rows(comms: Comms, shard: RowShard, gids) -> torch.Tensor:
    """Global rows ``gids`` on every rank: each row's owner contributes
    it, every other rank zeros, and one sum allreduce places them."""
    rows = shard.rows
    rel = gids.to(rows.device).long() - shard.offset
    owned = (rel >= 0) & (rel < rows.shape[0])
    local = rows[torch.clamp(rel, 0, rows.shape[0] - 1)]
    return comms.allreduce(torch.where(owned[:, None], local, 0.0))


def sharded_kmeans_balanced_fit(mesh: Mesh, X, n_clusters: int,
                                n_iters: int = 20,
                                merge_engine: str = "auto") -> torch.Tensor:
    """Distributed balanced k-means over row-sharded data, the center
    trainer of sharded IVF builds: a flat balancing EM from evenly strided
    global rows. Each iteration assigns locally, allreduces the
    statistics, and re-seeds the under-populated clusters from the GLOBAL
    highest-cost rows, picked by the merge engine over (cost, global row
    id) and fetched from their owners. Returns replicated (n_clusters,
    dim) centroids."""
    comms, shard, _ = _checked(mesh, X)
    n, n_dev = shard.n_total, mesh.size
    X_local = shard.rows
    n_local = X_local.shape[0]
    expects(n >= n_clusters, "need at least n_clusters rows")
    stride = max(n // n_clusters, 1)
    centroids = _fetch_rows(
        comms, shard, torch.arange(0, n, stride)[:n_clusters])
    engine = resolve_merge_engine(merge_engine, 1, n_clusters, n_dev)
    threshold = max(1.0, _SMALL_RATIO * n_local * n_dev / n_clusters)
    ones = torch.ones((n_local,), dtype=X_local.dtype, device=mesh.device)
    kk = min(n_clusters, n_local)
    for _ in range(n_iters):
        dists, labels = _min_reduce(X_local, centroids)
        sums = comms.allreduce(_segment_sum(X_local, labels, n_clusters))
        counts = comms.allreduce(_segment_sum(ones, labels, n_clusters))
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        new = torch.where((counts > 0)[:, None], new, centroids)
        # The global top-cost rows: merge (cost, global row id) pairs,
        # then fetch each winner from its owning shard.
        top_d, top_i = stable_top_k(dists[None], kk, select_min=False)
        _, win = topk_merge(top_d, top_i + shard.offset, n_clusters, comms,
                            select_min=False, engine=engine)
        seeds = _fetch_rows(comms, shard, win[0])
        order = torch.argsort(counts, stable=True)
        rank = torch.argsort(order, stable=True)
        reseed = rank < torch.sum(counts < threshold)
        centroids = torch.where(reseed[:, None], seeds[rank], new)
    return centroids
