"""Compaction: reclaim tombstones, split hot lists, recluster drifted ones.

Port of ``raft_tpu/lifecycle/compact.py`` for the single-host indexes. A
pass:

1. reclaims tombstoned slots: live rows repack per list in their relative
   order, so pure reclamation leaves search results bit-identical;
2. (IVF-Flat) splits lists whose live occupancy exceeds ``split_above``
   times the mean, at the median of the members' principal-direction
   projection: the list keeps one child center, the other is appended;
3. (IVF-Flat) reclusters lists whose center drifted more than
   ``drift_threshold`` times the median nearest-center gap from their
   live-member mean: the center moves to the mean.

After a split or a recluster every live row is relabelled against the new
centers with ``kmeans_balanced.predict`` (kernel B1 on ``cuda``).

Publication is copy-on-write: the pass returns a successor index at
``epoch + 1`` and never writes the input, so a pass that raises leaves
nothing half done. IVF-PQ codes are residuals against their list's center
and cannot move lists without the source vectors, so IVF-PQ compaction
reclaims only, and drops the decode caches whose slot layout moved.

``shrink_capacity=False`` (the default) keeps the list capacity; True fits
it to the fullest list. The sharded placement balancer and the background
``Compactor`` wait for the sharding and serving slices.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_float
from raft_tpu_torch.core.sentinels import worst_value
from raft_tpu_torch.lifecycle.delete import _check_index
from raft_tpu_torch.neighbors import ivf_flat as _flat
from raft_tpu_torch.neighbors import ivf_pq as _pq

logger = logging.getLogger("raft_tpu_torch")


@dataclass(frozen=True)
class CompactionPolicy:
    """Knobs of one pass. ``shrink_capacity``: fit the list capacity to the
    fullest list. ``split_above`` / ``drift_threshold`` /
    ``min_split_rows``: the IVF-Flat model pass (None = off). The
    reference's ``trigger_frac`` comes with its only reader, the
    ``Compactor``."""

    shrink_capacity: bool = False
    split_above: Optional[float] = None
    drift_threshold: Optional[float] = None
    min_split_rows: int = 16

    def __post_init__(self):
        expects(self.split_above is None or self.split_above > 1.0,
                "split_above must be > 1 (a multiple of the mean load)")
        expects(self.drift_threshold is None or self.drift_threshold > 0,
                "drift_threshold must be > 0")


@dataclass(frozen=True)
class CompactionReport:
    """What one pass did."""

    reclaimed_slots: int
    live_rows: int
    lists_split: int
    lists_reclustered: int
    n_lists_before: int
    n_lists_after: int
    cap_before: int
    cap_after: int
    epoch: int            # the successor index's epoch


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: the mean of the two middle values
    of an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _repack(flat_rows, labels, flat_ids, n_lists: int, min_cap: int):
    """Scatter rows into capacity-padded lists; rows labelled ``n_lists``
    (dead slots) drop out. Stable in the flat slot order, so pure
    reclamation keeps each list's row order. Returns ``(store, ids,
    sizes, cap)``."""
    keep = labels < n_lists
    store, ids, sizes = _flat._pack_lists(flat_rows[keep], labels[keep],
                                          flat_ids[keep], n_lists, min_cap)
    return store, ids, sizes, store.shape[1]


def _live_slots(index) -> torch.Tensor:
    """Per-slot liveness: below the fill line and not tombstoned."""
    slot = torch.arange(index.indices.shape[-1], device=index.indices.device)
    live = slot < index.list_sizes[:, None]
    if index.deleted is not None:
        live &= ~index.deleted
    return live


def _reclaim_labels(live, n_lists: int) -> torch.Tensor:
    """Flat repack labels of pure reclamation: a live slot keeps its list,
    a dead one is labelled ``n_lists``."""
    lists = torch.arange(n_lists, device=live.device)[:, None]
    return torch.where(live, lists, n_lists).reshape(-1)


def _dense_live(store, indices, live):
    """The live rows and ids in slot order (one row at least, as the
    reference gathers)."""
    flat_live = live.reshape(-1)
    n_live = int(flat_live.sum())
    order = torch.argsort((~flat_live).to(torch.uint8),
                          stable=True)[:max(n_live, 1)]
    rows = store.reshape((-1,) + tuple(store.shape[2:]))[order]
    return rows, indices.reshape(-1)[order], n_live


def _split_two(rows):
    """Two child centers of one list's members, split at the median of
    their projection on the principal direction (8 power iterations from
    the ones vector): deterministic and about 50/50."""
    mean = torch.mean(rows, dim=0)
    X = rows - mean
    v = torch.ones((rows.shape[1],), dtype=rows.dtype, device=rows.device)
    for _ in range(8):
        v = X.T @ (X @ v)
        v = v / torch.clamp_min(torch.linalg.norm(v), 1e-12)
    proj = X @ v
    left = (proj <= _median(proj))[:, None].to(rows.dtype)
    n_left = torch.clamp_min(torch.sum(left), 1.0)
    n_right = torch.clamp_min(rows.shape[0] - torch.sum(left), 1.0)
    c0 = torch.sum(rows * left, dim=0) / n_left
    c1 = torch.sum(rows * (1.0 - left), dim=0) / n_right
    return c0, c1


def _flat_model_pass(index, policy: CompactionPolicy, live):
    """Recluster and split for IVF-Flat. Returns ``(centers, changed,
    n_split, n_reclustered, rows, ids)``, with the dense live rows and ids
    when the model changed."""
    centers = index.centers
    n_lists = index.n_lists
    dataf = as_float(index.data)
    livef = live.to(dataf.dtype)
    cnt = torch.sum(livef, dim=1)
    n_reclustered = 0
    changed = False

    if policy.drift_threshold is not None and n_lists > 1:
        sums = torch.einsum("lc,lcd->ld", livef, dataf)
        means = sums / torch.clamp_min(cnt, 1.0)[:, None]
        drift = torch.linalg.norm(centers - means, dim=1)
        cd = torch.linalg.norm(centers[:, None] - centers[None, :], dim=2)
        # Self-distance ranks last in the nearest-center minimum.
        cd = torch.where(torch.eye(n_lists, dtype=torch.bool,
                                   device=cd.device), worst_value(True), cd)
        scale = _median(torch.amin(cd, dim=1))
        drifted = (drift > policy.drift_threshold * scale) & (cnt > 0)
        n_reclustered = int(drifted.sum())
        if n_reclustered:
            centers = torch.where(drifted[:, None], means, centers)
            changed = True

    rows = ids = None
    n_split = 0
    if policy.split_above is not None or changed:
        rows, ids, n_live = _dense_live(index.data, index.indices, live)
        rowsf = as_float(rows)
        if policy.split_above is not None and n_live:
            kb = KMeansBalancedParams(metric=index.metric)
            labels = kmeans_balanced._predict(kb, centers, rowsf).long()
            counts = torch.bincount(labels,
                                    minlength=centers.shape[0]).cpu().numpy()
            mean_live = max(1.0, n_live / centers.shape[0])
            hot = np.flatnonzero((counts > policy.split_above * mean_live)
                                 & (counts >= policy.min_split_rows))
            for l in hot.tolist():
                c0, c1 = _split_two(rowsf[labels == l])
                centers = torch.cat([centers[:l], c0[None], centers[l + 1:],
                                     c1[None]])
            n_split = int(hot.size)
            changed = changed or n_split > 0
    return centers, changed, n_split, n_reclustered, rows, ids


def _compact_flat(index, policy: CompactionPolicy):
    live = _live_slots(index)
    cap = index.data.shape[1]
    min_cap = 0 if policy.shrink_capacity else cap
    centers, changed, n_split, n_recl, rows, ids = _flat_model_pass(
        index, policy, live)
    if changed:
        labels = kmeans_balanced._predict(
            KMeansBalancedParams(metric=index.metric), centers,
            as_float(rows)).long()
        data, idx, sizes, new_cap = _repack(rows.to(index.data.dtype), labels,
                                            ids, centers.shape[0], min_cap)
    else:
        data, idx, sizes, new_cap = _repack(
            index.data.reshape((-1,) + tuple(index.data.shape[2:])),
            _reclaim_labels(live, index.n_lists), index.indices.reshape(-1),
            index.n_lists, min_cap)
    new = dataclasses.replace(
        index, centers=centers, data=data, indices=idx, list_sizes=sizes,
        deleted=None, n_deleted=0, epoch=index.epoch + 1)
    return new, n_split, n_recl, cap, new_cap


def _compact_pq(index, policy: CompactionPolicy):
    if policy.split_above is not None or policy.drift_threshold is not None:
        logger.debug("split/recluster are IVF-Flat passes (PQ codes are "
                     "residuals against their list's center); ignored for "
                     "IVF-PQ")
    live = _live_slots(index)
    cap = index.pq_codes.shape[1]
    min_cap = 0 if policy.shrink_capacity else cap
    codes, idx, sizes, new_cap = _repack(
        index.pq_codes.reshape(-1, index.pq_codes.shape[2]),
        _reclaim_labels(live, index.n_lists), index.indices.reshape(-1),
        index.n_lists, min_cap)
    new = dataclasses.replace(
        index, pq_codes=codes, indices=idx, list_sizes=sizes, deleted=None,
        n_deleted=0, epoch=index.epoch + 1, _recon=None, _scan_ops=None,
        _scan_ops_i8=None)
    return new, cap, new_cap


def compact(index, policy: Optional[CompactionPolicy] = None, mesh=None):
    """Run one compaction pass: returns ``(successor at epoch + 1,
    report)``, or ``(index, None)`` when there is nothing to do (no
    tombstones, no model pass, no shrink). The input index is never
    written."""
    policy = policy or CompactionPolicy()
    _check_index(index, mesh)
    wants_model = (policy.split_above is not None
                   or policy.drift_threshold is not None)
    if (index.n_deleted == 0 and not wants_model
            and not policy.shrink_capacity):
        return index, None
    n_split = n_recl = 0
    if isinstance(index, _pq.Index):
        new, cap, new_cap = _compact_pq(index, policy)
    else:
        new, n_split, n_recl, cap, new_cap = _compact_flat(index, policy)
    report = CompactionReport(
        reclaimed_slots=index.n_deleted,
        live_rows=int(torch.sum(new.list_sizes)),
        lists_split=n_split,
        lists_reclustered=n_recl,
        n_lists_before=index.n_lists,
        n_lists_after=new.n_lists,
        cap_before=cap,
        cap_after=new_cap,
        epoch=new.epoch,
    )
    return new, report
