"""Tombstone delete and upsert for the IVF indexes.

Port of ``raft_tpu/lifecycle/delete.py``. A delete writes the per-slot
boolean mask ``Index.deleted``; the IVF-Flat and IVF-PQ engines fold it into
the ``invalid`` mask that already hides below-fill padding, so tombstoned
rows never rank and the results equal those of an index rebuilt without
them, before any compaction.

Epoch rules: :func:`delete` bumps ``index.epoch`` exactly when a slot was
newly tombstoned (a delete that hits nothing changes nothing);
:func:`upsert` writes its tombstones silently and lets its extend carry
the one bump, after validating every input, so no epoch shows half an
upsert. The mask is replaced, never written in place, so a tensor read off
the index before a delete keeps its contents.

A sharded index (:class:`~raft_tpu_torch.parallel.ivf.ShardedIvfFlat`,
:class:`~raft_tpu_torch.parallel.ivf.ShardedIvfPq`, either placement)
takes ``mesh=``: the calls are then collective (the same ids on every
rank), each rank tombstones its own part, and the count is summed over
the ranks, so every rank bumps its epoch together. Under a list
placement with replicas both copies of a row are masked (they must stay
identical) and the row counts once: only slots of primary copies are
counted (``parallel.ivf.routed_primary_mask``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects, expects_finite
from raft_tpu_torch.core.mdarray import expects_ids_fit
from raft_tpu_torch.core.resources import as_vectors
from raft_tpu_torch.neighbors import ivf_flat as _flat
from raft_tpu_torch.neighbors import ivf_pq as _pq
from raft_tpu_torch.parallel.ivf import (ShardedIvfFlat, ShardedIvfPq,
                                         routed_primary_mask)

_INDEX_KINDS = (_flat.Index, _pq.Index)
_SHARDED = (ShardedIvfFlat, ShardedIvfPq)


def _check_index(index, mesh) -> None:
    if isinstance(index, _SHARDED):
        expects(mesh is not None and mesh.size == index.n_dev,
                "a sharded index needs the mesh it is sharded over")
        return
    expects(mesh is None, "mesh= is for the indexes of the sharding slice "
            "(parallel.ShardedIvfFlat / ShardedIvfPq); this index is "
            "single-host")
    expects(isinstance(index, _INDEX_KINDS),
            "lifecycle ops support ivf_flat/ivf_pq indexes, got %s",
            type(index).__name__)


def _is_sharded(index) -> bool:
    return isinstance(index, _SHARDED)


def _global_count(index, mesh, n: int) -> int:
    """``n`` summed over the ranks of a sharded index's mesh."""
    if not isinstance(index, _SHARDED):
        return n
    from raft_tpu_torch.comms.comms import Comms

    return int(Comms(mesh).allreduce(torch.tensor([n]))[0])


def _id_tensor(ids, device) -> torch.Tensor:
    t = ids if isinstance(ids, torch.Tensor) else torch.as_tensor(
        np.asarray(ids))
    return t.reshape(-1).to(device)


def _prepare_ids(index, ids) -> Optional[torch.Tensor]:
    """The delete ids as a tensor of the index's id dtype and device, or
    None for an empty batch. Ids must be >= 0, so none matches the
    ``PAD_ID`` of an empty slot. An id past the range of the index's id
    dtype cannot be stored in it, and is dropped rather than wrapped onto
    another id."""
    t = _id_tensor(ids, index.indices.device)
    if t.numel() == 0:
        return None
    lo = int(t.min())
    expects(lo >= 0, "ids must be >= 0 (got %s)", lo)
    dtype = index.indices.dtype
    if t.dtype.itemsize > dtype.itemsize:
        t = t[t <= torch.iinfo(dtype).max]
    return t.to(dtype)


def _tombstone(indices, list_sizes, deleted, del_ids, primary=None
               ) -> Tuple[torch.Tensor, int]:
    """Slots whose id is in ``del_ids``, below their list's fill line and
    not yet deleted become tombstones. Returns ``(new mask, newly deleted
    count)``, the count over the lists where ``primary`` (per list) is
    set when it is given; the input mask is not written."""
    hit = torch.isin(indices, del_ids)
    slot = torch.arange(indices.shape[-1], device=indices.device)
    valid = slot < list_sizes[..., None]
    newly = hit & valid & ~deleted
    counted = newly if primary is None else newly & primary[:, None]
    return deleted | newly, int(counted.sum())


def _primary(index, mesh):
    """The per-slot primary-copy mask of a replicated list placement, or
    None (count every slot)."""
    if isinstance(index, _SHARDED):
        return routed_primary_mask(mesh, index)
    return None


def _blank_mask(index) -> torch.Tensor:
    return torch.zeros(index.indices.shape, dtype=torch.bool,
                       device=index.indices.device)


def _drop_derived(index) -> None:
    """Drop the caches that bake the validity mask in (the compressed-scan
    operands) or were measured on the old occupancy."""
    if isinstance(index, ShardedIvfPq):
        index._scan_cache = None
        return
    if isinstance(index, ShardedIvfFlat):
        return
    if isinstance(index, _pq.Index):
        index._scan_ops = None
        index._scan_ops_i8 = None
    index.reset_search_cache()


def enable_tombstones(index, mesh=None) -> None:
    """Attach an all-live mask ahead of the first delete. An all-False
    mask scores exactly as no mask, so the epoch stays."""
    _check_index(index, mesh)
    if index.deleted is None:
        index.deleted = _blank_mask(index)


def tombstone_frac(index) -> float:
    """Fraction of stored slots that are tombstoned, the compaction
    trigger statistic."""
    size = index.size
    return index.n_deleted / size if size else 0.0


def delete(index, ids, mesh=None) -> int:
    """Tombstone the rows whose stored id is in ``ids``; returns how many
    slots were newly tombstoned. Ids with no live slot are ignored, so a
    re-delete is a no-op. Bumps ``index.epoch`` only when something was
    deleted."""
    _check_index(index, mesh)
    del_ids = _prepare_ids(index, ids)
    if del_ids is None:
        return 0
    mask = index.deleted if index.deleted is not None else _blank_mask(index)
    new_mask, n = _tombstone(index.indices, index.list_sizes, mask, del_ids,
                             _primary(index, mesh))
    n = _global_count(index, mesh, n)
    if n == 0:
        return 0
    index.deleted = new_mask
    index.n_deleted += n
    _drop_derived(index)
    index.epoch += 1
    return n


def upsert(index, new_vectors, new_indices, mesh=None, *,
           donate: bool = True):
    """Replace or insert rows by explicit id: tombstone the live slots
    holding these ids, then extend with the new rows, under the one epoch
    bump of the extend. Ids must be unique within the batch. Every input
    is checked before the mask is written. A row-placed sharded index's
    rows divide the mesh size, and ``donate=False`` writes a sharded
    extend into copies. Returns the index."""
    _check_index(index, mesh)
    dev = index.centers.device
    ids = _id_tensor(new_indices, dev)
    X = as_vectors(new_vectors, device=dev).to(dev)
    expects(X.ndim == 2 and X.shape[0] == ids.numel(),
            "upsert needs (n, dim) vectors with one id per row, got %s rows "
            "/ %s ids", tuple(X.shape), ids.numel())
    expects(X.shape[1] == index.dim, "upsert dim %s != index dim %s",
            X.shape[1], index.dim)
    expects(torch.unique(ids).numel() == ids.numel(),
            "upsert ids must be unique within the batch")
    expects_finite("lifecycle.upsert", X)
    expects_ids_fit("lifecycle.upsert", ids, index.indices.dtype)
    sharded = isinstance(index, _SHARDED)
    # The list placement deals rows by list ownership (any count); only
    # the row placement's contiguous deal needs the divisibility.
    expects(not sharded or index.placement == "list"
            or X.shape[0] % index.n_dev == 0,
            "sharded upsert rows (%s) must divide the mesh axis (pad "
            "first)", X.shape[0])
    if ids.numel() == 0:
        return index
    del_ids = _prepare_ids(index, ids)
    mask = index.deleted if index.deleted is not None else _blank_mask(index)
    new_mask, n = _tombstone(index.indices, index.list_sizes, mask, del_ids,
                             _primary(index, mesh))
    index.deleted = new_mask
    index.n_deleted += _global_count(index, mesh, n)
    _drop_derived(index)
    if isinstance(index, ShardedIvfFlat):
        from raft_tpu_torch.parallel.ivf import sharded_ivf_flat_extend

        return sharded_ivf_flat_extend(mesh, index, X, ids, donate=donate)
    if isinstance(index, ShardedIvfPq):
        from raft_tpu_torch.parallel.ivf import sharded_ivf_pq_extend

        return sharded_ivf_pq_extend(mesh, index, X, ids, donate=donate)
    if isinstance(index, _pq.Index):
        return _pq._extend(index, X, ids, dev)
    return _flat._extend(index, X, ids)
