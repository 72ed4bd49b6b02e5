"""Balanced hierarchical k-means, the trainer behind IVF indexes.

Port of ``raft_tpu/cluster/kmeans_balanced.py``:

* ``predict`` is the fused L2 arg-min (``distance/fused_l2_nn.py``), which
  runs kernel B1 with k=1 on ``cuda``;
* :func:`_balanced_em` runs the balancing EM: assign, recompute means
  (``index_add_`` for the reference's ``segment_sum``), then re-seed the
  under-populated clusters from the highest-cost samples, ranked with
  stable sorts as the reference's ``jnp.argsort`` ranks them;
* :func:`fit` trains sqrt(k) mesoclusters, splits their members into fine
  clusters in proportion to their populations with one masked EM
  (:func:`_hierarchical_fine_em`), then polishes with the balancing EM.

On ``cuda`` every EM assignment but the last runs on the split-bf16 tier of
B1, as the reference does on ``tpu`` (its ``fast`` flag). Integer inputs
map to float32 on entry.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.error import expects, expects_finite
from raft_tpu_torch.core.resources import as_float
from raft_tpu_torch.distance.distance_types import (
    DistanceType, value_form_select_min)
from raft_tpu_torch.distance.fused_l2_nn import _min_reduce
from raft_tpu_torch.distance.pairwise import distance as pairwise_distance_fn
from raft_tpu_torch.distance.pairwise import gram, row_norms_sq

# Clusters below this share of the mean population are re-seeded.
_SMALL_RATIO = 0.25


def _labels(X, centroids, metric: DistanceType) -> torch.Tensor:
    """Nearest-centroid labels: fused L2 arg-min for the L2 family,
    pairwise + arg-min/arg-max otherwise."""
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        _, labels = _min_reduce(X, centroids)
        return labels
    d = pairwise_distance_fn(X, centroids, metric=metric)
    lab = (torch.argmin(d, dim=1) if value_form_select_min(metric)
           else torch.argmax(d, dim=1))
    return lab.to(torch.int32)


def predict(params: KMeansBalancedParams, centroids, X,
            handle=None) -> torch.Tensor:
    """Nearest-centroid labels (int32). Rejects non-finite inputs."""
    X = as_float(X, handle)
    centroids = as_float(centroids, handle, X.device)
    expects_finite("kmeans_balanced.predict", X, centroids)
    return _labels(X, centroids, params.metric)


def _predict(params: KMeansBalancedParams, centroids,
             X: torch.Tensor) -> torch.Tensor:
    """:func:`predict` for the indexes' internal calls, on operands their
    entry points have checked."""
    return _labels(X, as_float(centroids, device=X.device), params.metric)


def _segment_sum(values, labels, n_segments: int) -> torch.Tensor:
    out = torch.zeros((n_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, labels.long(), values)


def _balanced_em(X, centroids0, n_iters: int, n_clusters: int,
                 fast: bool = False) -> torch.Tensor:
    """Balancing EM: each iteration assigns, recomputes means, then
    re-seeds the under-populated clusters: the i-th least populated
    cluster below the threshold takes the i-th highest-cost sample.
    ``fast`` runs every assignment but the last on the split-bf16 tier."""
    threshold = max(1.0, _SMALL_RATIO * X.shape[0] / n_clusters)
    ones = torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)

    def body(centroids, bf16):
        dists, labels = _min_reduce(X, centroids, bf16=bf16)
        sums = _segment_sum(X, labels, n_clusters)
        counts = _segment_sum(ones, labels, n_clusters)
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        new = torch.where((counts > 0)[:, None], new, centroids)
        order = torch.argsort(counts, stable=True)
        rank = torch.argsort(order, stable=True)
        n_small = torch.sum(counts < threshold)
        top_cost = torch.argsort(-dists, stable=True)[:n_clusters]
        reseed = rank < n_small
        seeds = X[top_cost[rank]]
        return torch.where(reseed[:, None], seeds, new)

    c = centroids0
    for it in range(n_iters):
        c = body(c, "split" if fast and it < n_iters - 1 else None)
    return c


def _predict_and_count(X, centroids, metric: DistanceType):
    """Labels + per-cluster populations."""
    labels = _labels(X, centroids, metric)
    counts = torch.bincount(labels.long(), minlength=centroids.shape[0])
    return labels, counts


# Row-block / centroid-tile caps of the masked assignment: the live
# distance tile is (block, ktile) f32 = 512 MB at most.
_ASSIGN_BLOCK = 65536
_ASSIGN_KTILE = 2048


def _hierarchical_fine_em(X, meso_labels, owner, seed_slots,
                          generator: torch.Generator, n_iters: int,
                          n_clusters: int) -> torch.Tensor:
    """Fine-cluster stage of the hierarchical build, all mesoclusters at
    once: masked k-means++ seeding (Gumbel-max sampling of each
    mesocluster's rank-r seed, one round per rank), then masked Lloyd
    iterations in which centroid j is visible only to samples of
    mesocluster ``owner[j]``. ``seed_slots`` is (max_quota, n_meso): the
    fine-centroid id of mesocluster m's rank-r seed, or -1."""
    n, d = X.shape
    n_meso = seed_slots.shape[1]
    dev = X.device
    rows = torch.arange(n, device=dev)
    meso = meso_labels.long()

    seeds = torch.zeros((n_clusters, d), dtype=X.dtype, device=dev)
    mind = torch.full((n,), 1e30, dtype=X.dtype, device=dev)
    for r in range(seed_slots.shape[0]):
        slot = seed_slots[r]
        valid = slot >= 0
        gumbel = -torch.log(torch.empty((n,), dtype=X.dtype, device=dev)
                            .exponential_(generator=generator))
        z = torch.log(torch.clamp_min(mind, 1e-12)) + gumbel
        segmax = torch.full((n_meso,), float("-inf"), dtype=X.dtype,
                            device=dev).scatter_reduce_(0, meso, z, "amax")
        cand = torch.where(z == segmax[meso], rows, n)
        pick = torch.full((n_meso,), n, dtype=rows.dtype, device=dev)
        pick = torch.clamp(pick.scatter_reduce_(0, meso, cand, "amin"),
                           0, n - 1)
        S = X[pick]
        seeds[slot[valid].long()] = S[valid]
        dnew = torch.sum((X - S[meso]) ** 2, dim=1)
        mind = torch.where(valid[meso], torch.minimum(mind, dnew), mind)

    owner = owner.long()

    def assign(C):
        cn = row_norms_sq(C)
        labels = torch.empty((n,), dtype=torch.long, device=dev)
        for b in range(0, n, _ASSIGN_BLOCK):
            xb = X[b:b + _ASSIGN_BLOCK]
            grp = meso[b:b + _ASSIGN_BLOCK]
            xn = row_norms_sq(xb)
            best_d = torch.full((xb.shape[0],), float("inf"),
                                dtype=X.dtype, device=dev)
            best_i = torch.zeros((xb.shape[0],), dtype=torch.long,
                                 device=dev)
            for t in range(0, n_clusters, _ASSIGN_KTILE):
                Ct = C[t:t + _ASSIGN_KTILE]
                dtile = torch.clamp_min(
                    xn[:, None] + cn[None, t:t + _ASSIGN_KTILE]
                    - 2.0 * gram(xb, Ct), 0.0)
                own = owner[None, t:t + _ASSIGN_KTILE] == grp[:, None]
                dtile = torch.where(own, dtile, float("inf"))
                td, ti = torch.min(dtile, dim=1)
                upd = td < best_d
                best_d = torch.where(upd, td, best_d)
                best_i = torch.where(upd, ti + t, best_i)
            labels[b:b + _ASSIGN_BLOCK] = best_i
        return labels

    ones = torch.ones((n,), dtype=X.dtype, device=dev)
    C = seeds
    for _ in range(n_iters):
        labels = assign(C)
        sums = _segment_sum(X, labels, n_clusters)
        cnts = _segment_sum(ones, labels, n_clusters)
        new = sums / torch.clamp_min(cnts, 1.0)[:, None]
        C = torch.where((cnts > 0)[:, None], new, C)
    return C


def build_clusters(params: KMeansBalancedParams, X, n_clusters: int,
                   generator: Optional[torch.Generator] = None,
                   handle=None) -> torch.Tensor:
    """Train ``n_clusters`` balanced centroids on X: k-means++ seeding for
    k <= 64, evenly strided samples otherwise, then the balancing EM."""
    X = as_float(X, handle)
    n = X.shape[0]
    expects(n >= n_clusters, "need at least n_clusters samples")
    if n_clusters <= 64:
        from raft_tpu_torch.cluster.kmeans import init_plus_plus

        if generator is None:
            generator = params.rng_state.next_generator(X.device)
        centroids0 = init_plus_plus(generator, X, n_clusters)
    else:
        stride = n // n_clusters
        centroids0 = X[::max(stride, 1)][:n_clusters]
    return _balanced_em(X, centroids0, params.n_iters, n_clusters,
                        X.device.type == "cuda")


def fit(params: KMeansBalancedParams, X, n_clusters: int,
        handle=None) -> torch.Tensor:
    """Train centroids, hierarchically for large k: sqrt(k) mesoclusters,
    a fine-cluster quota per mesocluster in proportion to its population,
    a masked fine EM, then a balancing polish over the full set. Rejects
    non-finite inputs."""
    X = as_float(X, handle)
    expects_finite("kmeans_balanced.fit", X)
    return _fit(params, X, n_clusters)


def _fit(params: KMeansBalancedParams, X: torch.Tensor,
         n_clusters: int) -> torch.Tensor:
    """:func:`fit` on a float tensor its caller has checked."""
    n = X.shape[0]
    expects(n >= n_clusters, "need at least n_clusters samples")
    if n_clusters <= 256 or n < 4 * n_clusters:
        return build_clusters(params, X, n_clusters)

    n_meso = int(math.ceil(math.sqrt(n_clusters)))
    meso_params = KMeansBalancedParams(
        n_iters=params.n_iters, metric=params.metric,
        rng_state=params.rng_state)
    meso_centroids = build_clusters(meso_params, X, n_meso)
    meso_labels, counts_dev = _predict_and_count(X, meso_centroids,
                                                 params.metric)
    counts = counts_dev.cpu().numpy()

    quota = np.maximum(1, np.floor(counts / n * n_clusters)).astype(np.int64)
    while quota.sum() < n_clusters:
        quota[np.argmax(counts / np.maximum(quota, 1))] += 1
    while quota.sum() > n_clusters:
        cand = np.where(quota > 1)[0]
        quota[cand[np.argmin(counts[cand] / quota[cand])]] -= 1

    owner_h = np.repeat(np.arange(n_meso), quota).astype(np.int32)
    rank_h = np.concatenate([np.arange(q) for q in quota]).astype(np.int32)
    seed_slots = np.full((int(quota.max()), n_meso), -1, np.int32)
    seed_slots[rank_h, owner_h] = np.arange(n_clusters, dtype=np.int32)
    centroids = _hierarchical_fine_em(
        X, meso_labels, torch.as_tensor(owner_h, device=X.device),
        torch.as_tensor(seed_slots, device=X.device),
        params.rng_state.next_generator(X.device), params.n_iters,
        n_clusters)
    return _balanced_em(X, centroids, max(2, params.n_iters // 2),
                        n_clusters, X.device.type == "cuda")


def fit_predict(params: KMeansBalancedParams, X, n_clusters: int,
                handle=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centroids and the labels of X. Rejects non-finite inputs."""
    X = as_float(X, handle)
    expects_finite("kmeans_balanced.fit_predict", X)
    centroids = _fit(params, X, n_clusters)
    return centroids, _labels(X, centroids, params.metric)
