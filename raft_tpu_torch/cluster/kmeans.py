"""k-means++ seeding.

Port of ``init_plus_plus`` from ``raft_tpu/cluster/kmeans.py`` (the rest of
that module comes in a later slice). Draws come from an explicit
``torch.Generator`` on the data's device, so the seeds differ from the
reference's; tests hold the two to the same quality instead.
"""

from __future__ import annotations

import torch


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
