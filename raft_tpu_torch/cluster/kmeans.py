"""Classic k-means (Lloyd) with k-means++ and random seeding.

Port of ``raft_tpu/cluster/kmeans.py``:

* the assignment step is the fused L2 arg-min (``distance/fused_l2_nn.py``),
  kernel B1 with k=1 on ``cuda``, its plain version on the CPU; other
  metrics take the pairwise distances and their first arg-min;
* the centroid update sums the members with ``linalg.reduce_rows_by_key``
  (the reference's ``segment_sum``); an empty cluster keeps its old
  centroid;
* the EM loop (:func:`_lloyd`) re-seeds the empty clusters at the
  highest-cost rows and stops when the squared centroid shift falls below
  ``tol`` or after ``max_iter`` iterations. On ``cuda`` its assignments
  run on B1's split-bf16 tier, as the reference's do on ``tpu`` and as the
  port's balanced k-means does; the assignment behind the returned labels
  and inertia is always f32.

Seeding draws from an explicit ``torch.Generator`` on the data's device
(``params.rng_state`` or the caller's), so seeds differ from the
reference's; from ``InitMethod.Array`` the two packages run the same
iterations. Public entry points reject non-finite inputs; the loop and
:func:`find_k` call the unchecked private forms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
from raft_tpu_torch.core.error import expects, expects_finite
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.core.resources import as_float, as_tensor
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.fused_l2_nn import _min_reduce
from raft_tpu_torch.distance.pairwise import distance as pairwise_distance_fn
from raft_tpu_torch.linalg.reduce import reduce_rows_by_key
from raft_tpu_torch.matrix.select_k import stable_top_k

_L2 = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded)


def _assign(X, centroids, metric: DistanceType = DistanceType.L2Expanded,
            bf16: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`min_cluster_and_distance` on float tensors, unchecked."""
    if metric in _L2:
        d, i = _min_reduce(X, centroids, sqrt=metric == _L2[1], bf16=bf16)
        return i, d
    dmat = pairwise_distance_fn(X, centroids, metric=metric)
    labels = torch.argmin(dmat, dim=1)
    return (labels.to(torch.int32),
            torch.gather(dmat, 1, labels[:, None])[:, 0])


def min_cluster_and_distance(X, centroids,
                             metric: DistanceType = DistanceType.L2Expanded,
                             bf16=None, handle=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sample's nearest centroid and its distance: ``(labels int32
    (n,), dists (n,))``, squared for L2Expanded. The L2 metrics take the
    fused arg-min (``bf16`` picks its tier); the others the pairwise
    distances and their first arg-min."""
    X = as_float(X, handle)
    centroids = as_float(centroids, handle, X.device)
    expects_finite("kmeans.min_cluster_and_distance", X, centroids)
    return _assign(X, centroids, metric, bf16)


def min_cluster_distance(X, centroids,
                         metric: DistanceType = DistanceType.L2Expanded,
                         handle=None) -> torch.Tensor:
    """The distance to the nearest centroid alone."""
    _, d = min_cluster_and_distance(X, centroids, metric=metric,
                                    handle=handle)
    return d


@traced
def cluster_cost(X, centroids, metric: DistanceType = DistanceType.L2Expanded,
                 handle=None) -> torch.Tensor:
    """Inertia: the sum of the distances to the nearest centroid."""
    return torch.sum(min_cluster_distance(X, centroids, metric, handle))


def _update(X, labels, n_clusters: int, centroids_old=None, w=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`update_centroids` on tensors on X's device."""
    sums = reduce_rows_by_key(X, labels, n_clusters, weights=w)
    counts = reduce_rows_by_key(torch.ones_like(X[:, :1]) if w is None
                                else w[:, None], labels, n_clusters)[:, 0]
    new = sums / torch.clamp_min(counts, 1e-12)[:, None]
    if centroids_old is not None:
        new = torch.where((counts > 0)[:, None], new, centroids_old)
    return new, counts


def update_centroids(X, labels, n_clusters: int, centroids_old=None,
                     sample_weight=None, handle=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each cluster's (weighted) member mean; with ``centroids_old`` an
    empty cluster keeps its old centroid. Returns ``(centroids (k, d),
    counts (k,))``."""
    X = as_float(X, handle)
    labels = as_tensor(labels, handle, X.device)
    old = (None if centroids_old is None
           else as_float(centroids_old, handle, X.device))
    w = (None if sample_weight is None
         else as_tensor(sample_weight, handle, X.device).to(X.dtype))
    return _update(X, labels, n_clusters, old, w)


def compute_new_centroids(X, centroids, labels=None, sample_weight=None,
                          handle=None) -> torch.Tensor:
    """One update step from ``centroids``: the labels are the nearest
    centroid's when not given."""
    X = as_float(X, handle)
    centroids = as_float(centroids, handle, X.device)
    if labels is None:
        labels, _ = min_cluster_and_distance(X, centroids)
    new, _ = update_centroids(X, labels, centroids.shape[0],
                              centroids_old=centroids,
                              sample_weight=sample_weight, handle=handle)
    return new


# ---------------------------------------------------------------------------
# Seeding


def init_random(generator: torch.Generator, X: torch.Tensor,
                n_clusters: int) -> torch.Tensor:
    """``n_clusters`` distinct samples drawn uniformly."""
    idx = torch.randperm(X.shape[0], generator=generator,
                         device=X.device)[:n_clusters]
    return X[idx]


def init_plus_plus(generator: torch.Generator, X: torch.Tensor,
                   n_clusters: int) -> torch.Tensor:
    """k-means++: sample each new center with probability proportional to
    the squared distance to the nearest center chosen so far. The
    distances and probabilities are f32 whatever the rows' dtype: an f16
    sum of squared distances overflows."""
    n, d = X.shape
    first = torch.randint(0, n, (1,), generator=generator, device=X.device)
    centroids = torch.zeros((n_clusters, d), dtype=X.dtype, device=X.device)
    centroids[0] = X[first[0]]
    Xf = X.float()
    mind = torch.sum((Xf - Xf[first[0]][None, :]) ** 2, dim=1)
    for i in range(1, n_clusters):
        total = torch.sum(mind)
        probs = torch.where(total > 0, mind / torch.clamp_min(total, 1e-30),
                            torch.full_like(mind, 1.0 / n))
        idx = torch.multinomial(probs, 1, generator=generator)[0]
        centroids[i] = X[idx]
        dnew = torch.sum((Xf - Xf[idx][None, :]) ** 2, dim=1)
        mind = torch.minimum(mind, dnew)
    return centroids


def sample_centroids(generator: torch.Generator, X, n_to_sample: int,
                     handle=None) -> torch.Tensor:
    """``n_to_sample`` candidate centroids drawn uniformly from X."""
    return init_random(generator, as_float(X, handle), n_to_sample)


# ---------------------------------------------------------------------------
# Lloyd EM


def _lloyd(X, centroids0, w, max_iter: int, tol: float,
           metric: DistanceType = DistanceType.L2Expanded,
           fast: bool = False):
    """The EM loop: assign, update, re-seed the empty clusters, test the
    shift. The i-th empty cluster (in index order) takes the i-th
    highest-cost row (ties to the lowest row), the reference's rule, so a
    duplicate centroid, starved by the lowest-index tie rule of the
    assignment, re-seeds on the next sweep. ``fast`` runs the loop's
    assignments on the split-bf16 tier; the final assignment, behind the
    returned labels and inertia, is f32. Returns ``(centroids, labels,
    inertia, n_iter)``."""
    n_clusters = centroids0.shape[0]
    centroids = centroids0
    it = 0
    shift = float("inf")
    while it < max_iter and shift >= tol:
        labels, dists = _assign(X, centroids, metric,
                                "split" if fast else None)
        new, counts = _update(X, labels, n_clusters, centroids, w)
        empty = counts == 0
        if bool(empty.any()):
            cost = dists if w is None else dists * w
            _, top_i = stable_top_k(cost, n_clusters, select_min=False)
            order = torch.clamp(torch.cumsum(empty.long(), 0) - 1, 0,
                                n_clusters - 1)
            new = torch.where(empty[:, None], X[top_i[order]], new)
        shift = float(torch.sum((new - centroids) ** 2))
        centroids = new
        it += 1
    labels, dists = _assign(X, centroids, metric)
    inertia = torch.sum(dists if w is None else dists * w)
    return centroids, labels, inertia, it


def _fit(params: KMeansParams, X: torch.Tensor, w=None, centroids_init=None):
    """:func:`fit` on a float tensor its caller has checked."""
    expects(X.ndim == 2, "X must be a matrix")
    expects(params.n_clusters <= X.shape[0],
            "n_clusters must be <= n_samples")
    best = None
    n_init = max(1, params.n_init) if centroids_init is None else 1
    for _ in range(n_init):
        generator = params.rng_state.next_generator(X.device)
        if centroids_init is not None or params.init == InitMethod.Array:
            expects(centroids_init is not None,
                    "InitMethod.Array requires centroids_init")
            c0 = centroids_init
        elif params.init == InitMethod.Random:
            c0 = init_random(generator, X, params.n_clusters)
        else:
            c0 = init_plus_plus(generator, X, params.n_clusters)
        centroids, _, inertia, it = _lloyd(
            X, c0, w, params.max_iter, params.tol, params.metric,
            fast=X.device.type == "cuda")
        if best is None or float(inertia) < float(best[1]):
            best = (centroids, inertia, it)
    return best


@traced
def fit(params: KMeansParams, X, sample_weight=None, centroids_init=None,
        handle=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Train k-means. Returns ``(centroids, inertia, n_iter)``; with
    ``n_init`` restarts the lowest-inertia model wins. Rejects non-finite
    inputs."""
    X = as_float(X, handle)
    w = (None if sample_weight is None
         else as_tensor(sample_weight, handle, X.device).to(X.dtype))
    c0 = (None if centroids_init is None
          else as_float(centroids_init, handle, X.device))
    expects_finite("kmeans.fit", *[t for t in (X, w, c0) if t is not None])
    return _fit(params, X, w, c0)


@traced
def predict(params: KMeansParams, centroids, X, normalize_weight: bool = True,
            sample_weight=None, handle=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign samples to trained centroids. Returns ``(labels,
    inertia)``. ``normalize_weight`` is accepted for parity and, as in the
    reference, not read."""
    labels, dists = min_cluster_and_distance(X, centroids, params.metric,
                                             handle=handle)
    if sample_weight is not None:
        dists = dists * as_tensor(sample_weight, handle,
                                  dists.device).to(dists.dtype)
    return labels, torch.sum(dists)


@traced
def fit_predict(params: KMeansParams, X, sample_weight=None,
                centroids_init=None, handle=None):
    """Returns ``(centroids, labels, inertia, n_iter)``."""
    X = as_float(X, handle)
    centroids, inertia, it = fit(params, X, sample_weight, centroids_init)
    labels, _ = predict(params, centroids, X)
    return centroids, labels, inertia, it


@traced
def transform(params: KMeansParams, centroids, X, handle=None
              ) -> torch.Tensor:
    """(n, k) sample-to-centroid distances under ``params.metric``."""
    X = as_float(X, handle)
    return pairwise_distance_fn(X, as_float(centroids, handle, X.device),
                                metric=params.metric)


@traced
def find_k(X, kmax: int, kmin: int = 1, max_iter: int = 100,
           tol: float = 1e-2, seed: int = 0, handle=None
           ) -> Tuple[int, torch.Tensor, int]:
    """Pick k by binary search on the Calinski-Harabasz objective
    ``(n - k) / (k - 1) * dispersion(k) / inertia(k)``: with the objective
    at [left, mid, right], a slope rising left of mid and falling right of
    it moves right to mid, anything else moves left to mid. A fit whose
    inertia lands above the left edge's is retried with the next seed, up
    to 3 fits, and the best is kept. Returns ``(best_k, inertia,
    n_iter)`` of the winning fit."""
    from raft_tpu_torch.random.rng_state import RngState
    from raft_tpu_torch.stats.descriptive import dispersion

    X = as_float(X, handle)
    expects_finite("kmeans.find_k", X)
    n = X.shape[0]
    expects(kmax <= n, "kmax must be <= number of rows in X")
    expects(kmax >= 2, "find_k needs kmax >= 2 (the Calinski-Harabasz "
            "objective is undefined at k=1)")
    expects(kmin <= kmax, f"kmin ({kmin}) must be <= kmax ({kmax})")
    left = max(kmin, 2)
    right = max(kmax, left)
    memo: dict = {}

    def run(k: int, floor_inertia=None):
        if k in memo:
            return memo[k]
        best = None
        for attempt in range(3):
            p = KMeansParams(n_clusters=int(k), max_iter=max_iter, tol=tol,
                             rng_state=RngState(seed=seed + attempt))
            centroids, inertia, it = _fit(p, X)
            inertia = float(inertia)
            if best is None or inertia < best[0]:
                labels, _ = _assign(X, centroids, p.metric)
                sizes = torch.bincount(labels.long(), minlength=int(k))
                disp = float(dispersion(centroids, sizes, n_points=n))
                best = (inertia, disp, it)
            if floor_inertia is None or best[0] <= floor_inertia:
                break
        memo[k] = best
        return best

    def objective(k: int) -> float:
        inertia, disp, _ = memo[k]
        return (n - k) / (k - 1) * disp / max(inertia, 1e-30)

    run(left)
    if right > left:
        run(right, floor_inertia=memo[left][0])
    while left < right - 1:
        mid = (left + right) // 2
        run(mid, floor_inertia=memo[left][0])
        slope_l = (objective(mid) - objective(left)) / (mid - left)
        slope_r = (objective(right) - objective(mid)) / (right - mid)
        if slope_l > 0 and slope_r < 0:
            right = mid
        else:
            left = mid
    best_k = right if objective(right) >= objective(left) else left
    inertia, _, it = memo[best_k]
    return best_k, torch.tensor(inertia, dtype=X.dtype, device=X.device), it
