"""Single-linkage agglomerative clustering.

Port of ``raft_tpu/cluster/single_linkage.py`` (RAFT's
``cluster/single_linkage.cuh``): a connectivity graph (every pair, or the
kNN graph joined into one component), its minimum spanning tree, then
the dendrogram and the flat clusters.

* **PAIRWISE**: the rows stay on the device; the squared differences are
  summed unexpanded (as the reference's numpy broadcast sums them) in
  blocks of ``_PAIR_BLOCK_ELEMS`` broadcast entries, and the edges of
  the upper triangle come out in row-major order, as ``np.triu_indices``
  lists them, so the MST breaks ties on the same edge ids.
* **KNN_GRAPH**: ``sparse.neighbors.knn_graph`` (kernel B1 on ``cuda``),
  then at most ``ceil(log2 n) + 1`` rounds of ``connect_components``
  until the graph is connected; only the "is it connected yet" probe
  reaches the host.
* **The dendrogram** is the native host runtime's union-find walk
  (``_native.dendrogram_host``) over the MST's edges, as f32 weights; a
  failed build raises ``NativeBuildError``, with no Python fallback.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.core.resources import DeviceLike
from raft_tpu_torch.distance.distance_types import DistanceType

# sparse/ is imported inside single_linkage(): its kNN graph stands on
# neighbors/, whose IVF modules import cluster/.

# Broadcast (rows, n, d) entries per block of the pairwise distances
# (256 MB of f32).
_PAIR_BLOCK_ELEMS = 1 << 26


class LinkageDistance(enum.Enum):
    """How the connectivity graph is built."""

    PAIRWISE = 0
    KNN_GRAPH = 1


@dataclass
class LinkageOutput:
    """The dendrogram's children (n - 1, 2), merge distances and sizes
    (host numpy, as in the reference), and the flat labels (a tensor on
    the rows' device)."""

    labels: torch.Tensor
    children: np.ndarray
    distances: np.ndarray
    sizes: np.ndarray
    n_clusters: int


def _dendrogram(src, dst, w, n: int, n_clusters: int):
    """Union-find agglomeration over the weight-sorted MST edges in the
    native host runtime: ``(labels, children, distances, sizes)``. The
    weights must be finite, and finite as f32 (the walk sorts f32 keys)."""
    from raft_tpu_torch import _native

    w_in = np.asarray(w)
    expects(bool(np.isfinite(w_in).all()),
            "single_linkage: MST edge weights must be finite")
    with np.errstate(over="ignore"):
        w = w_in.astype(np.float32)
    expects(bool(np.isfinite(w).all()),
            "single_linkage: MST edge weights overflow float32 (the "
            "dendrogram walk sorts f32 keys); rescale the data")
    return _native.dendrogram_host(np.asarray(src, np.int32),
                                   np.asarray(dst, np.int32), w, n,
                                   n_clusters)


def _pairwise_edges(X: torch.Tensor, sqrt: bool):
    """Every pair i < j in row-major order with its unexpanded squared
    L2 (or L2) distance."""
    n, d = X.shape
    rows = max(1, _PAIR_BLOCK_ELEMS // max(n * d, 1))
    cols = torch.arange(n, device=X.device)
    rs, cs, ws = [], [], []
    for s in range(0, n, rows):
        xb = X[s:s + rows]
        db = torch.sum((xb[:, None, :] - X[None, :, :]) ** 2, dim=2)
        if sqrt:
            db = torch.sqrt(db)
        upper = cols[None, :] > cols[s:s + rows, None]
        r, c = torch.nonzero(upper, as_tuple=True)
        rs.append((r + s).int())
        cs.append(c.int())
        ws.append(db[r, c])
    return torch.cat(rs), torch.cat(cs), torch.cat(ws)


@traced
def single_linkage(
    X,
    n_clusters: int,
    metric: DistanceType = DistanceType.L2SqrtExpanded,
    dist_type: LinkageDistance = LinkageDistance.KNN_GRAPH,
    c: int = 15,
    device: DeviceLike = None,
) -> LinkageOutput:
    """Single-linkage clustering of dense rows; ``c`` is the kNN graph's
    degree. Returns a :class:`LinkageOutput`. A tensor stays on its
    device; other inputs go to ``device`` (``cuda`` by default)."""
    from raft_tpu_torch.sparse.neighbors import (connect_components,
                                                 connected_components,
                                                 knn_graph)
    from raft_tpu_torch.sparse.solver import mst as mst_solver

    X = as_array(X, device=device).float()
    n = X.shape[0]
    expects(1 <= n_clusters <= n, "invalid n_clusters")

    if dist_type == LinkageDistance.PAIRWISE or n <= c + 1:
        rows, cols, w = _pairwise_edges(
            X, metric == DistanceType.L2SqrtExpanded)
    else:
        g = knn_graph(X, min(c, n - 1), metric=metric)
        rows, cols, w = g.rows, g.cols, g.vals
        # Join the components: each round links every row to its nearest
        # row in another component.
        for _ in range(int(math.ceil(math.log2(max(n, 2)))) + 1):
            comp = connected_components(rows, cols, n)
            if bool((comp == comp[0]).all()):
                break
            extra = connect_components(X, comp, metric=metric)
            rows = torch.cat([rows, extra.rows])
            cols = torch.cat([cols, extra.cols])
            w = torch.cat([w, extra.vals])

    tree = mst_solver(rows, cols, w, n)
    labels, children, distances, sizes = _dendrogram(
        tree.src.cpu().numpy(), tree.dst.cpu().numpy(),
        tree.weights.cpu().numpy(), n, n_clusters)
    return LinkageOutput(labels=torch.as_tensor(labels, device=X.device),
                         children=children, distances=distances,
                         sizes=sizes, n_clusters=n_clusters)
