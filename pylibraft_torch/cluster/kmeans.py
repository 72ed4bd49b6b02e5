"""k-means clustering, pylibraft surface.

Ref: python/pylibraft/pylibraft/cluster/kmeans.pyx: compute_new_centroids
(:54), init_plus_plus (:205), cluster_cost (:289), InitMethod (:375),
KMeansParams (:382), fit (:496). Backed by
``raft_tpu_torch.cluster.kmeans``: on the card, Lloyd's assignments are
k=1 launches of the fused kNN kernel.

``KMeansParams(seed=)`` and ``init_plus_plus(seed=)`` seed
``torch.Generator`` draws, so the centers they pick differ from the JAX
package's for the same seed; both follow the k-means++ law.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans as _impl
from raft_tpu_torch.cluster.kmeans_types import InitMethod as _InitMethod
from raft_tpu_torch.cluster.kmeans_types import KMeansParams as _Params
from raft_tpu_torch.core.resources import as_float
from raft_tpu_torch.distance.distance_types import DISTANCE_TYPES
from raft_tpu_torch.random.rng_state import RngState

from pylibraft_torch.common import auto_convert_output, auto_sync_handle, cai_wrapper
from pylibraft_torch.common.ai_wrapper import check_same_device
from pylibraft_torch.common.outputs import copy_into


class InitMethod(IntEnum):
    """Ref cluster/kmeans.pyx:375."""

    KMeansPlusPlus = 0
    Random = 1
    Array = 2


class KMeansParams:
    """Ref cluster/kmeans.pyx:382-492: optional-kwarg construction over the
    C++ defaults; same field names."""

    def __init__(self,
                 n_clusters: Optional[int] = None,
                 max_iter: Optional[int] = None,
                 tol: Optional[float] = None,
                 verbosity: Optional[int] = None,
                 seed: Optional[int] = None,
                 metric: Optional[str] = None,
                 init: Optional[InitMethod] = None,
                 n_init: Optional[int] = None,
                 oversampling_factor: Optional[float] = None,
                 batch_samples: Optional[int] = None,
                 batch_centroids: Optional[int] = None,
                 inertia_check: Optional[bool] = None):
        kwargs = {}
        if n_clusters is not None:
            kwargs["n_clusters"] = n_clusters
        if max_iter is not None:
            kwargs["max_iter"] = max_iter
        if tol is not None:
            kwargs["tol"] = tol
        if verbosity is not None:
            kwargs["verbosity"] = verbosity
        if seed is not None:
            kwargs["rng_state"] = RngState(seed=seed)
        if metric is not None:
            if metric not in DISTANCE_TYPES:
                raise ValueError(
                    f"Unknown metric '{metric}'. Valid values are: "
                    f"{list(DISTANCE_TYPES)}")
            kwargs["metric"] = DISTANCE_TYPES[metric]
        if init is not None:
            kwargs["init"] = _InitMethod(int(init))
        if n_init is not None:
            kwargs["n_init"] = n_init
        if oversampling_factor is not None:
            kwargs["oversampling_factor"] = oversampling_factor
        if batch_samples is not None:
            kwargs["batch_samples"] = batch_samples
        if batch_centroids is not None:
            kwargs["batch_centroids"] = batch_centroids
        if inertia_check is not None:
            kwargs["inertia_check"] = inertia_check
        self.params = _Params(**kwargs)

    @property
    def n_clusters(self):
        return self.params.n_clusters

    @property
    def max_iter(self):
        return self.params.max_iter

    @property
    def tol(self):
        return self.params.tol

    @property
    def verbosity(self):
        return self.params.verbosity

    @property
    def seed(self):
        return self.params.rng_state.seed

    @property
    def init(self):
        return InitMethod(self.params.init.value)

    @property
    def oversampling_factor(self):
        return self.params.oversampling_factor

    @property
    def batch_samples(self):
        return self.params.batch_samples

    @property
    def batch_centroids(self):
        return self.params.batch_centroids

    @property
    def inertia_check(self):
        return self.params.inertia_check


def _rows(a) -> int:
    return a.shape[0] if hasattr(a, "shape") else np.asarray(a).shape[0]


@auto_sync_handle
@auto_convert_output
def compute_new_centroids(X, centroids, labels, new_centroids,
                          sample_weights=None, weight_per_cluster=None,
                          handle=None):
    """Ref cluster/kmeans.pyx:54: one centroid-update step; writes
    ``new_centroids`` (and ``weight_per_cluster``, each cluster's summed
    sample weight) in place when it is a buffer and returns it."""
    x = cai_wrapper(X, handle)
    c = cai_wrapper(centroids, handle)
    lab = cai_wrapper(labels, handle)
    w = None if sample_weights is None else cai_wrapper(sample_weights,
                                                        handle)
    check_same_device(x, c, lab, *([] if w is None else [w]))
    w = None if w is None else w.array
    new = _impl.compute_new_centroids(x.array, c.array, lab.array, w,
                                      handle=handle)
    if weight_per_cluster is not None:
        # The aggregated per-cluster weight, filled like the reference
        # (kmeans.pyx:155 passes the buffer through to update_centroids).
        wvec = (torch.ones(x.shape[0], device=x.device) if w is None
                else w.reshape(-1).float())
        agg = torch.zeros(c.shape[0], device=x.device).index_add_(
            0, lab.array.reshape(-1).long(), wvec)
        copy_into(weight_per_cluster, agg.reshape(weight_per_cluster.shape))
    if new_centroids is None:
        return new
    return copy_into(new_centroids, new)


@auto_sync_handle
@auto_convert_output
def init_plus_plus(X, n_clusters=None, seed=None, handle=None,
                   centroids=None):
    """Ref cluster/kmeans.pyx:205: k-means++ seeding, drawn from a
    ``torch.Generator`` seeded with ``seed`` (0 when None) on X's device,
    the handle's for host input."""
    if (n_clusters is not None and centroids is not None
            and n_clusters != _rows(centroids)):
        raise RuntimeError(
            "Parameters 'n_clusters' and 'centroids' are exclusive")
    x = cai_wrapper(X, handle)
    if n_clusters is None:
        if centroids is None:
            raise RuntimeError("either n_clusters or centroids is required")
        n_clusters = _rows(centroids)
    generator = torch.Generator(device=x.device).manual_seed(
        0 if seed is None else int(seed))
    out = _impl.init_plus_plus(generator, as_float(x.array), int(n_clusters))
    if centroids is not None:
        return copy_into(centroids, out)
    return out


@auto_sync_handle
def cluster_cost(X, centroids, handle=None):
    """Ref cluster/kmeans.pyx:289: inertia of X against centroids."""
    x = cai_wrapper(X, handle)
    c = cai_wrapper(centroids, handle)
    check_same_device(x, c)
    return float(_impl.cluster_cost(x.array, c.array, handle=handle))


@auto_sync_handle
@auto_convert_output
def fit(params: KMeansParams, X, centroids=None, sample_weights=None,
        handle=None):
    """Ref cluster/kmeans.pyx:496: returns (centroids, inertia, n_iter).

    Examples
    --------
    >>> import numpy as np
    >>> from pylibraft_torch.cluster.kmeans import KMeansParams, fit
    >>> from pylibraft_torch.common import DeviceResources
    >>> X = np.array([[0.0], [0.1], [10.0], [10.1]], np.float32)
    >>> cen, inertia, n_iter = fit(KMeansParams(n_clusters=2, seed=0), X,
    ...                            handle=DeviceResources(device="cpu"))
    >>> [round(v, 2) for v in sorted(np.asarray(cen).ravel().tolist())]
    [0.05, 10.05]
    """
    x = cai_wrapper(X, handle)
    ops = [x]
    c0 = None
    if centroids is not None:
        c0 = cai_wrapper(centroids, handle)
        ops.append(c0)
    w = None
    if sample_weights is not None:
        w = cai_wrapper(sample_weights, handle)
        ops.append(w)
    check_same_device(*ops)
    cen, inertia, n_iter = _impl.fit(
        params.params, x.array,
        sample_weight=None if w is None else w.array,
        centroids_init=None if c0 is None else c0.array, handle=handle)
    return cen, float(inertia), int(n_iter)
