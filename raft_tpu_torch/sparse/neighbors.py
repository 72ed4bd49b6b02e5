"""Sparse kNN, the kNN graph and connected-component linking.

Port of ``raft_tpu/sparse/neighbors.py`` (RAFT's
``sparse/neighbors/{brute_force, knn_graph, connect_components}.cuh``):

* :func:`brute_force_knn` is :func:`sparse.distance.knn_blocked`;
* :func:`knn_graph` searches the dense rows against themselves with
  ``neighbors.brute_force.tiled_brute_force_knn`` in chunks of
  ``_KNN_GRAPH_CHUNK`` queries (the ragged tail padded with the first
  rows), so on ``cuda`` at n >= 8192 and k + 1 <= 128 every chunk is one
  launch of the fused kNN kernel; then each row's self match moves to the
  end by a stable sort and the last column is dropped;
* :func:`connected_components` propagates the minimum label along the
  edges with two pointer jumps a step, for at most 64 steps;
* :func:`connect_components` gives every row its nearest row in another
  component: a running arg-min over 2048-row tiles of X for each chunk of
  8192 rows, the other components' rows only, ties to the lowest id.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.core.resources import DeviceLike
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric
from raft_tpu_torch.linalg import blas  # noqa: F401  (full f32 products)
from raft_tpu_torch.neighbors.brute_force import tiled_brute_force_knn
from raft_tpu_torch.sparse.distance import knn_blocked
from raft_tpu_torch.sparse.types import COO, CSR

# Queries per kNN-graph search (the reference's chunk).
_KNN_GRAPH_CHUNK = 131072
# The label propagation's step cap.
_CC_MAX_STEPS = 64
# Masked cross-NN tiling: (x chunk, y tile) distance blocks of 64 MB.
_CCOMP_XCHUNK = 8192
_CCOMP_YTILE = 2048


@traced
def brute_force_knn(
    idx: CSR, query: CSR, k: int,
    metric: Union[str, DistanceType] = DistanceType.L2Expanded,
    metric_arg: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN between CSR row sets: ``(distances, ids)``
    (:func:`sparse.distance.knn_blocked`)."""
    return knn_blocked(idx, query, k, metric=metric, metric_arg=metric_arg)


@traced
def knn_graph(
    X, k: int,
    metric: Union[str, DistanceType] = DistanceType.L2SqrtExpanded,
    device: DeviceLike = None,
) -> COO:
    """The kNN graph of the dense rows of ``X``: a COO of the directed
    edges from each row to its min(k, n - 1) nearest other rows, in
    distance order. A tensor stays on its device; other inputs go to
    ``device`` (``cuda`` by default)."""
    X = as_array(X, device=device)
    n = X.shape[0]
    metric = resolve_metric(metric)
    kk = min(k + 1, n)      # k + 1, then the self match is dropped
    chunk = _KNN_GRAPH_CHUNK
    if n <= chunk:
        d, i = tiled_brute_force_knn(X, X, kk, metric=metric)
    else:
        pad = (-n) % chunk
        dps, ips = [], []
        for s in range(0, n + pad, chunk):
            q = X[s:s + chunk]
            if q.shape[0] < chunk:
                q = torch.cat([q, X[:pad]])
            dp, ip = tiled_brute_force_knn(q, X, kk, metric=metric)
            dps.append(dp)
            ips.append(ip)
        d = torch.cat(dps)[:n]
        i = torch.cat(ips)[:n]
    # A stable sort on the is-self flag moves the self match to the last
    # column and keeps the distance order; a row whose self match fell
    # outside the k + 1 drops its worst candidate instead.
    rows0 = torch.arange(n, dtype=torch.int32, device=X.device)
    is_self = (i == rows0[:, None]).to(torch.uint8)
    order = torch.argsort(is_self, dim=1, stable=True)
    d = torch.gather(d, 1, order)[:, :kk - 1]
    i = torch.gather(i, 1, order)[:, :kk - 1]
    rows = torch.repeat_interleave(rows0, kk - 1)
    return COO(rows, i.reshape(-1), d.reshape(-1), (n, n))


def _connected_components(rows: torch.Tensor, cols: torch.Tensor,
                          n: int) -> Tuple[torch.Tensor, int]:
    """Labels and the number of propagation steps taken."""
    r, c = rows.long(), cols.long()
    comp = torch.arange(n, dtype=torch.int32, device=rows.device)
    steps = 0
    while steps < _CC_MAX_STEPS:
        new = comp.scatter_reduce(0, r, comp[c], "amin")
        new = new.scatter_reduce(0, c, comp[r], "amin")
        new = torch.minimum(new, new[new.long()])
        new = torch.minimum(new, new[new.long()])
        steps += 1
        changed = bool(torch.any(new != comp))
        comp = new
        if not changed:
            break
    return comp, steps


def connected_components(rows, cols, n: int,
                         device: DeviceLike = None) -> torch.Tensor:
    """Connected-component labels (int32, each the smallest vertex id of
    its component) of an undirected edge list over ``n`` vertices. Tensors
    stay on their device; other inputs go to ``device``."""
    rows = as_array(rows, device=device).int()
    cols = as_array(cols, device=rows.device).int()
    return _connected_components(rows, cols, n)[0]


def _masked_cross_nn(Xc, labc, X, lab, sqrt: bool):
    """For each row of the chunk ``Xc``, the nearest row of ``X`` with
    another label: a running arg-min over tiles of ``_CCOMP_YTILE`` rows,
    the expanded squared L2 in f32, ties to the lowest id."""
    n = X.shape[0]
    xn = torch.sum(Xc * Xc, dim=1)
    best_d = torch.full((Xc.shape[0],), float("inf"), dtype=X.dtype,
                        device=X.device)
    best_i = torch.full((Xc.shape[0],), -1, dtype=torch.int32,
                        device=X.device)
    for base in range(0, n, _CCOMP_YTILE):
        yt = X[base:base + _CCOMP_YTILE]
        # (|x|^2 + |y|^2) - 2 x.y, the product in full f32, in place.
        dt = xn[:, None] + torch.sum(yt * yt, dim=1)[None, :]
        dt.addmm_(Xc, yt.T, alpha=-2.0).clamp_min_(0.0)
        dt.masked_fill_(lab[None, base:base + _CCOMP_YTILE] == labc[:, None],
                        float("inf"))
        ti = torch.argmin(dt, dim=1)
        td = torch.gather(dt, 1, ti[:, None])[:, 0]
        upd = td < best_d
        best_d = torch.where(upd, td, best_d)
        best_i = torch.where(upd, (ti + base).int(), best_i)
    return (torch.sqrt(best_d) if sqrt else best_d), best_i


@traced
def connect_components(
    X, labels, metric: DistanceType = DistanceType.L2SqrtExpanded,
    device: DeviceLike = None,
) -> COO:
    """The edge from every row to its nearest row outside its own
    component (a superset of the reference's min edge per component
    pair; the MST absorbs the rest), or no edge with one component.
    Tensors stay on their device; other inputs go to ``device``."""
    X = as_array(X, device=device).float()
    lab = as_array(labels, device=X.device).int()
    n = X.shape[0]
    if torch.unique(lab).numel() <= 1:
        empty = torch.zeros(0, dtype=torch.int32, device=X.device)
        return COO(empty, empty.clone(), X.new_zeros(0), (n, n))
    sqrt = metric == DistanceType.L2SqrtExpanded
    ds, is_ = [], []
    for s in range(0, n, _CCOMP_XCHUNK):
        bd, bi = _masked_cross_nn(X[s:s + _CCOMP_XCHUNK],
                                  lab[s:s + _CCOMP_XCHUNK], X, lab, sqrt)
        ds.append(bd)
        is_.append(bi)
    rows = torch.arange(n, dtype=torch.int32, device=X.device)
    return COO(rows, torch.cat(is_), torch.cat(ds), (n, n))
