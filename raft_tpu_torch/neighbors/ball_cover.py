"""Random ball cover: exact low-dimensional kNN through landmarks and the
triangle inequality.

Port of ``raft_tpu/neighbors/ball_cover.py`` (RAFT's
``neighbors/ball_cover.cuh``, ``BallCoverIndex``). L2 on 2-D / 3-D rows
and haversine on (lat, lon) rows, as in the reference.

* **build**: ``sqrt(m)`` landmarks drawn without replacement (a
  ``torch.Generator`` seeded with ``seed`` on the data's device, so the
  draw differs from the reference's ``jax.random`` one;
  :func:`_build_from_landmarks` takes the draw, which is how the tests
  hand both packages the same landmarks); every row goes to its nearest
  landmark (the pairwise layer's expanded L2 or haversine formula,
  first arg-min), the groups are packed into a capacity-padded
  ``(n_landmarks, cap, dim)`` tensor in (landmark, distance) order by two
  stable sorts, and each group's radius is its largest member distance.
  The capacity is the one host read.
* **query**: probe the ``n_probes`` nearest groups and take the top k
  (``matrix.select_k``); a landmark whose ball could still hold a closer
  row (``d(q, l) - radius(l) <= the k-th distance``) and was not probed
  leaves its query unresolved. The unresolved queries are re-scanned at
  twice the probes while that stays within half the landmarks, then any
  still unresolved take a dense scan of every row (the reference's
  schedule; the counts of unresolved queries are host reads, as there).
  The reference pads the re-scanned queries to a power of two to reuse
  its compilations; the port scans the unresolved ones only, which
  changes no answer.

Every step of a query depends on that query alone, so :func:`knn_query`
takes its queries in chunks, and each scan its queries in batches, under
the byte budget ``_QUERY_BYTES``: a widening at half of 1000 landmarks
of 10,000-row groups gathers ~100 MB a query. Chunked answers equal the
unchunked ones bit for bit: the distances are the pairwise layer's
expanded form with its sums taken over the (at most three) coordinates
one by one, elementwise, so a query's distances do not depend on the
batch it is computed in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.core.resources import DeviceLike
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import _haversine
from raft_tpu_torch.matrix.select_k import select_k

_SUPPORTED = (
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.Haversine,
)

# Bytes one scan step may gather and compute over (its queries' probed
# rows, ids and distances, or their dense distances).
_QUERY_BYTES = 1 << 30


def _dist_rows(q, db, metric: DistanceType) -> torch.Tensor:
    """Each query of ``q`` (b, d) against the rows ``db`` (b, r, d), or
    the rows (1, r, d) shared by all: (b, r) squared L2 or haversine
    distances. Haversine is the pairwise layer's. L2 is its expanded
    form |q|^2 + |y|^2 - 2 q.y with the sums taken coordinate by
    coordinate (d <= 3) in place of its gram product, so each entry is
    the same whatever the batch it is computed in."""
    if metric == DistanceType.Haversine:
        return _haversine(q[:, None, :], db)[:, 0, :]
    qn = q[:, 0] * q[:, 0]
    yn = db[..., 0] * db[..., 0]
    g = q[:, 0][:, None] * db[..., 0]
    for c in range(1, q.shape[1]):
        qn = qn + q[:, c] * q[:, c]
        yn = yn + db[..., c] * db[..., c]
        g += q[:, c][:, None] * db[..., c]
    g *= 2.0
    d = qn[:, None] + yn
    d -= g
    return d.clamp_min_(0.0)


def _dist(x, y, metric: DistanceType) -> torch.Tensor:
    """(m, d) x (n, d) -> (m, n) distances (:func:`_dist_rows`)."""
    return _dist_rows(x, y[None], metric)


def _needs_sqrt(metric: DistanceType) -> bool:
    return metric in (DistanceType.L2SqrtExpanded,
                      DistanceType.L2SqrtUnexpanded)


def _is_l2(metric: DistanceType) -> bool:
    return metric != DistanceType.Haversine


@dataclass
class BallCoverIndex:
    """The index (``BallCoverIndex``): the reference's CSR-like member
    lists as a capacity-padded group tensor (slot j of landmark l holds a
    member iff ``j < group_sizes[l]``)."""

    X: torch.Tensor              # (m, dim) the indexed rows
    metric: DistanceType
    landmarks: torch.Tensor      # (n_landmarks, dim)
    groups: torch.Tensor         # (n_landmarks, cap, dim)
    group_indices: torch.Tensor  # (n_landmarks, cap) int32 into X, -1 pad
    group_sizes: torch.Tensor    # (n_landmarks,) int32
    radii: torch.Tensor          # (n_landmarks,) largest member distance
    index_trained: bool = True

    @property
    def m(self) -> int:
        return self.X.shape[0]

    @property
    def n(self) -> int:
        return self.X.shape[1]

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]


def _as_rows(x, device: DeviceLike) -> torch.Tensor:
    x = as_array(x, device=device)
    return x if x.is_floating_point() else x.float()


def _build_from_landmarks(X: torch.Tensor, perm: torch.Tensor,
                          metric: DistanceType) -> BallCoverIndex:
    """The index of ``X`` on the landmarks ``X[perm]``."""
    L = perm.shape[0]
    m = X.shape[0]
    landmarks = X[perm.long()]
    # Each row's nearest landmark, over row blocks of (rows, L) distances.
    rows = max(1, _QUERY_BYTES // (L * 4 * 4))
    assign = torch.empty(m, dtype=torch.int64, device=X.device)
    nn_dist = torch.empty(m, dtype=X.dtype, device=X.device)
    for s in range(0, m, rows):
        d = _dist(X[s:s + rows], landmarks, metric)
        a = torch.argmin(d, dim=1)
        assign[s:s + rows] = a
        nn_dist[s:s + rows] = torch.gather(d, 1, a[:, None])[:, 0]
        del d
    if _is_l2(metric):
        nn_dist = torch.sqrt(nn_dist)     # radii in true distance
    sizes = torch.bincount(assign, minlength=L)
    cap = max(1, int(sizes.max()))
    # (landmark, distance) order, ties by row: two stable sorts.
    order = torch.argsort(nn_dist, stable=True)
    order = order[torch.argsort(assign[order], stable=True)]
    sorted_assign = assign[order]
    starts = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(m, device=X.device) - starts[sorted_assign]
    grp_idx = torch.full((L, cap), -1, dtype=torch.int32, device=X.device)
    grp_idx[sorted_assign, pos] = order.to(torch.int32)
    radii = torch.full((L,), float("-inf"), dtype=nn_dist.dtype,
                       device=X.device).scatter_reduce(
        0, assign, nn_dist, "amax", include_self=False)
    radii = torch.where(sizes > 0, radii, 0.0)
    groups = X[torch.clamp_min(grp_idx, 0).long()]   # (L, cap, dim)
    return BallCoverIndex(X=X, metric=metric, landmarks=landmarks,
                          groups=groups, group_indices=grp_idx,
                          group_sizes=sizes.to(torch.int32), radii=radii)


@traced
def build_index(
    dataset,
    metric: DistanceType = DistanceType.L2SqrtUnexpanded,
    n_landmarks: Optional[int] = None,
    seed: int = 0,
    handle=None,
    device: DeviceLike = None,
) -> BallCoverIndex:
    """Draw ``sqrt(m)`` landmarks (or ``n_landmarks``), assign every row
    to its nearest one, pack the groups and record their radii. A tensor
    stays on its device; other inputs go to ``device`` (``cuda`` by
    default)."""
    X = _as_rows(dataset, device)
    expects(X.ndim == 2, "dataset must be a matrix")
    expects(X.shape[1] <= 3, "only 2d and 3d vectors are supported")
    expects(metric in _SUPPORTED, f"unsupported ball-cover metric {metric!r}")
    if metric == DistanceType.Haversine:
        expects(X.shape[1] == 2, "haversine requires 2d (lat, lon) input")
    m = X.shape[0]
    L = int(n_landmarks) if n_landmarks else max(1, int(math.sqrt(m)))
    L = min(L, m)
    gen = torch.Generator(device=X.device).manual_seed(seed)
    perm = torch.randperm(m, generator=gen, device=X.device)[:L]
    return _build_from_landmarks(X, perm, metric)


def _starts(n: int, size: int) -> range:
    """Starts of the batches of ``size`` over ``n`` queries (one empty
    batch for none, so an empty query set answers with (0, k))."""
    return range(0, max(n, 1), size)


def _scan_bytes(rows: int, dim: int) -> int:
    """Bytes a scan over ``rows`` candidate rows takes per query: the
    gathered rows, their ids, validity and distance temporaries."""
    return rows * (dim + 6) * 4


def _scan_probed(index: BallCoverIndex, queries: torch.Tensor,
                 probe_ids: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact distances over each query's probed groups, then its top k;
    in batches of queries under ``_QUERY_BYTES``."""
    cap = index.groups.shape[1]
    n_probes = probe_ids.shape[1]
    per_query = _scan_bytes(n_probes * cap, index.n)
    batch = max(1, _QUERY_BYTES // per_query)
    slots = torch.arange(cap, device=queries.device)
    dks, iks = [], []
    for s in _starts(queries.shape[0], batch):
        pid = probe_ids[s:s + batch].long()
        b = pid.shape[0]
        flat = index.groups[pid].reshape(b, n_probes * cap, index.n)
        ids = index.group_indices[pid].reshape(b, n_probes * cap)
        valid = (slots[None, None, :]
                 < index.group_sizes[pid][:, :, None]).reshape(
            b, n_probes * cap)
        d = _dist_rows(queries[s:s + batch], flat, index.metric)
        d = torch.where(valid, d, float("inf"))
        dk, pos = select_k(d, k, select_min=True)
        dks.append(dk)
        iks.append(torch.gather(ids, 1, pos.long()))
    return torch.cat(dks), torch.cat(iks)


def _dense(index: BallCoverIndex, queries: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k over every indexed row, in batches of queries under
    ``_QUERY_BYTES``."""
    batch = max(1, _QUERY_BYTES // (index.m * 3 * 4))
    dks, iks = [], []
    for s in _starts(queries.shape[0], batch):
        d = _dist(queries[s:s + batch], index.X, index.metric)
        dk, ik = select_k(d, k, select_min=True)
        dks.append(dk)
        iks.append(ik)
    return torch.cat(dks), torch.cat(iks)


def _query_chunk(index: BallCoverIndex, Q: torch.Tensor, k: int,
                 n_probes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three passes for one chunk of queries (squared L2 or
    haversine distances)."""
    L = index.n_landmarks
    l2 = _is_l2(index.metric)
    # Pass 1: the nearest landmarks' groups bound the k-th distance.
    dl = _dist(Q, index.landmarks, index.metric)       # (q, L)
    _, probe_ids = select_k(dl, n_probes, select_min=True)
    dk, ik = _scan_probed(index, Q, probe_ids, k)
    true_dl = torch.sqrt(dl) if l2 else dl
    nq = Q.shape[0]
    probed = torch.zeros((nq, L), dtype=torch.bool, device=Q.device)
    probed.scatter_(1, probe_ids.long(), True)
    nonempty = (index.group_sizes > 0)[None, :]
    lower = true_dl - index.radii[None, :]

    def unresolved_of(dk_cur, mask):
        b = torch.sqrt(dk_cur[:, -1]) if l2 else dk_cur[:, -1]
        can = (lower <= b[:, None]) & nonempty
        return torch.any(can & ~mask, dim=1)

    # Pass 2: triangle-inequality pruning of the unprobed landmarks.
    unresolved = unresolved_of(dk, probed)
    n_bad = int(unresolved.sum())
    # Pass 3: widen the probes of the unresolved queries while that stays
    # within half the landmarks; a dense scan for the rest.
    w = n_probes
    while n_bad and 2 * w <= max(L // 2, n_probes):
        w = min(2 * w, L)
        bad = torch.nonzero(unresolved)[:, 0]
        _, pidb = select_k(dl[bad], w, select_min=True)
        dk[bad], ik[bad] = _scan_probed(index, Q[bad], pidb, k)
        probed[bad[:, None], pidb.long()] = True
        unresolved = unresolved_of(dk, probed)
        n_bad = int(unresolved.sum())
    if n_bad:
        bad = torch.nonzero(unresolved)[:, 0]
        dk[bad], ik[bad] = _dense(index, Q[bad], k)
    return dk, ik


def _query_rows(index: BallCoverIndex, n_probes: int) -> int:
    """Queries per chunk: the landmark distances, masks and the first
    scan of a chunk stay within ``_QUERY_BYTES``."""
    cap = index.groups.shape[1]
    per_query = (_scan_bytes(n_probes * cap, index.n)
                 + index.n_landmarks * 4 * 4)
    return max(1, _QUERY_BYTES // per_query)


@traced
def knn_query(
    index: BallCoverIndex,
    queries,
    k: int,
    n_probes: Optional[int] = None,
    handle=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN against the indexed rows: ``(distances (q, k), indices
    (q, k) int32)``, nearest first. Queries go to the index's device."""
    expects(index.index_trained, "index must be built first")
    Q = _as_rows(queries, index.X.device)
    expects(Q.ndim == 2 and Q.shape[1] == index.n, "query dim mismatch")
    expects(k <= index.m, "k must be <= number of indexed rows")
    L = index.n_landmarks
    if n_probes is None:
        # Enough groups that the first bound is usually tight.
        n_probes = min(L, max(2, int(math.ceil(k / max(1.0, index.m / L)))
                              + 2))
    n_probes = min(n_probes, L)
    chunk = _query_rows(index, n_probes)
    parts = [_query_chunk(index, Q[s:s + chunk], k, n_probes)
             for s in _starts(Q.shape[0], chunk)]
    dk = torch.cat([p[0] for p in parts])
    ik = torch.cat([p[1] for p in parts])
    if _needs_sqrt(index.metric):
        dk = torch.sqrt(dk)
    return dk, ik


@traced
def all_knn_query(
    index: BallCoverIndex,
    k: int,
    n_probes: Optional[int] = None,
    handle=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kNN graph of the indexed rows against themselves."""
    return knn_query(index, index.X, k, n_probes=n_probes)


@traced
def eps_nn(
    index: BallCoverIndex,
    queries,
    eps: float,
    handle=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every indexed row within ``eps`` (true distance) of each query:
    ``(adj (n_queries, m) bool, vd (n_queries,) int32)``. As in the
    reference, one dense distance pass, not pruned by the landmarks;
    queries go to the index's device."""
    expects(index.index_trained, "index must be built first")
    Q = _as_rows(queries, index.X.device)
    d = _dist(Q, index.X, index.metric)
    if _is_l2(index.metric):
        d = torch.sqrt(d)
    adj = d <= eps
    return adj, torch.sum(adj, dim=1).to(torch.int32)
