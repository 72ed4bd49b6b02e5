"""IVF-Flat: inverted-file index over raw vectors.

Port of ``raft_tpu/neighbors/ivf_flat.py``. Lists are one dense
capacity-padded tensor ``data (n_lists, cap, dim)``; slot j of list l is
valid iff ``j < list_sizes[l]`` and it is not tombstoned in ``deleted``.

* ``build`` trains the coarse centers with balanced k-means on a strided
  subsample (whose assignments run kernel B1 on ``cuda``) and fills the
  lists with ``extend``;
* ``extend`` packs an empty index in bulk, or appends in place at each
  list's fill offset, growing the capacity to the next power of two when a
  list overflows (``conservative_memory_allocation`` grows exactly);
* ``search`` probes the ``n_probes`` nearest centers, then scans the
  probed lists with one of two engines:

  - the packed-cells engine (kernel B2, ``ops/fused_knn.py``): the probe
    map is inverted into fixed-width query cells per list, every cell is
    scored against its list in one launch, and each pair's candidates are
    routed back for the final per-query selection. ``"auto"`` takes it on
    ``cuda`` when the probe load fills cells, as the reference does on
    ``tpu``; ``"bucketed"`` with ``bucket_cap=0`` forces it;
  - the legacy bucket-table engine (kernel B3, ``fused_batch_knn``): the
    probe map is inverted into one query bucket of ``bucket_cap`` slots
    per list (:func:`_pick_engine` measures the capacity when it is 0),
    every bucket is scored against its list in one batched launch, and
    overflowing pairs drop their farthest-centroid probes first. An
    explicit ``bucket_cap`` selects it, as does ``"bucketed"`` where the
    cells engine does not apply (k > 256, an oversized list block); on the
    card B3 holds k <= 256 and raises past it;
  - the scan engine (:func:`_probe_scan`): per probe rank, gather each
    query's list, score it, and merge into a running top-k, for what the
    other engines do not take (tiny probe loads, "scan");

* ids are int32 or int64 (``IndexParams.idx_dtype``). The kernels return
  int32 slots within a list; the engines translate them through
  ``indices``, in its dtype;
* ``save`` / ``load`` write and read the reference's npz layout
  (``SERIALIZATION_VERSION`` 3), so a file from either package loads in
  the other.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.error import expects, expects_finite
from raft_tpu_torch.core.mdarray import expects_ids_fit, validate_idx_dtype
from raft_tpu_torch.core.resources import (as_float, as_tensor, as_vectors,
                                           resolve_device)
from raft_tpu_torch.core.sentinels import PAD_ID, worst_value
from raft_tpu_torch.core.serialize import (from_numpy, read_npz, to_numpy,
                                           write_npz)
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric
from raft_tpu_torch.distance.pairwise import gram, row_norms_sq
from raft_tpu_torch.matrix.select_k import select_k, stable_top_k
from raft_tpu_torch.ops.fused_knn import fused_batch_knn, fused_cells_knn
from raft_tpu_torch.random.rng_state import RngState
from raft_tpu_torch.util.pow2 import next_pow2, round_up_safe

logger = logging.getLogger("raft_tpu_torch")


@dataclass
class IndexParams:
    """Same field names and defaults as raft_tpu's ``IndexParams``."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    metric_arg: float = 2.0
    add_data_on_build: bool = True
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    adaptive_centers: bool = False
    conservative_memory_allocation: bool = False
    idx_dtype: torch.dtype = torch.int32


@dataclass
class SearchParams:
    """``engine``: "auto" | "scan" | "bucketed"; ``bucket_cap`` other than
    0 selects the legacy bucket-table engine at that per-list query
    capacity (pairs beyond it drop their farthest-centroid probes)."""

    n_probes: int = 20
    engine: str = "auto"
    bucket_cap: int = 0


@dataclass
class Index:
    """Trained IVF-Flat index; data/indices are capacity-padded."""

    metric: DistanceType
    centers: torch.Tensor       # (n_lists, dim)
    data: torch.Tensor          # (n_lists, cap, dim)
    indices: torch.Tensor       # (n_lists, cap) int32 / int64 row ids
    list_sizes: torch.Tensor    # (n_lists,) int32
    adaptive_centers: bool = False
    conservative_memory_allocation: bool = False
    epoch: int = 0
    deleted: Optional[torch.Tensor] = None   # (n_lists, cap) bool
    n_deleted: int = 0
    _next_id: Optional[int] = None

    def __post_init__(self):
        expects(self.data.shape[0] == self.indices.shape[0]
                == self.list_sizes.shape[0] == self.centers.shape[0],
                "n_lists mismatch across index tensors")
        expects(self.data.shape[1] == self.indices.shape[1],
                "list capacity mismatch between data and indices")
        expects(self.data.shape[2] == self.centers.shape[1],
                "dim mismatch between data and centers")

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def capacity(self) -> int:
        return self.indices.shape[0] * self.indices.shape[1]

    @property
    def size(self) -> int:
        return int(torch.sum(self.list_sizes))

    @property
    def live_size(self) -> int:
        """Rows that answer queries: ``size`` minus tombstoned slots."""
        return self.size - self.n_deleted

    def reset_search_cache(self) -> None:
        """Drop the memoized auto bucket capacity (measured from the first
        query batch of each shape)."""
        self.__dict__.pop("_auto_cap_cache", None)


def index_from_numpy(centers, data, indices, list_sizes, metric,
                     deleted=None, device=None) -> Index:
    """A port ``Index`` from the arrays of a raft_tpu ``Index`` (as numpy;
    int32 or int64 ids; bf16 as 2-byte void arrays), on ``device``
    (``cuda`` by default). The arrays are copied."""
    dev = resolve_device(device)

    def t(a, dtype=None):
        return from_numpy(np.array(a), dev).to(dtype)

    ind = np.asarray(indices)
    validate_idx_dtype(ind.dtype)
    del_t = None if deleted is None else t(deleted, torch.bool)
    return Index(metric=resolve_metric(metric), centers=t(centers),
                 data=t(data), indices=t(ind),
                 list_sizes=t(list_sizes, torch.int32), deleted=del_t,
                 n_deleted=0 if del_t is None else int(del_t.sum()))


def _pack_lists(X, labels, ids, n_lists: int, min_cap: int = 0):
    """Scatter rows into (n_lists, cap, dim) storage: sort by list, in-list
    position from the offset prefix sums, one scatter."""
    n, d = X.shape
    labels = labels.long()
    counts = torch.bincount(labels, minlength=n_lists)
    cap = int(max(int(torch.max(counts)), 1, min_cap))
    order = torch.argsort(labels, stable=True)
    sl = labels[order]
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=X.device) - offsets[sl]
    data = torch.zeros((n_lists, cap, d), dtype=X.dtype, device=X.device)
    idx = torch.full((n_lists, cap), PAD_ID, dtype=ids.dtype,
                     device=X.device)
    data[sl, pos] = X[order]
    idx[sl, pos] = ids[order]
    return data, idx, counts.to(torch.int32)


def _train_centers(params: IndexParams, Xf: torch.Tensor) -> torch.Tensor:
    """Train the coarse centers on a strided ``kmeans_trainset_fraction``
    subsample."""
    n = Xf.shape[0]
    frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
    n_train = max(params.n_lists, int(n * frac)) if frac < 1.0 else n
    stride = max(1, n // n_train)
    # One contiguous copy: every k-means assignment reads it.
    trainset = Xf[::stride][:n_train].contiguous()
    kb = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                              metric=params.metric,
                              rng_state=RngState(seed=0))
    return kmeans_balanced._fit(kb, trainset, params.n_lists)


def _coarse_probe(Q, centers, n_probes: int, inner_is_l2: bool):
    """The ``n_probes`` best centers of each query (int32 list ids). As in
    the reference, bf16 / f16 centers have their norms summed in their
    own dtype and then promoted, and the product runs in f32."""
    cf = centers.float()
    if inner_is_l2:
        cd = (row_norms_sq(Q)[:, None] + row_norms_sq(centers).float()[None, :]
              - 2.0 * gram(Q, cf))
        _, probe_ids = select_k(cd, n_probes, select_min=True)
    else:
        _, probe_ids = select_k(gram(Q, cf), n_probes, select_min=False)
    return probe_ids


def build(params: IndexParams, dataset, handle=None) -> Index:
    """Train centers (balanced k-means on a subsample) and fill the lists
    (ids ``0..n-1`` in ``params.idx_dtype``)."""
    idx_dtype = validate_idx_dtype(params.idx_dtype)
    X = as_vectors(dataset, handle)
    expects(X.ndim == 2, "dataset must be (n_rows, dim)")
    n = X.shape[0]
    expects(n >= params.n_lists, "need at least n_lists rows")
    expects_finite("ivf_flat.build", X)
    centers = _train_centers(params, as_float(X))
    index = Index(
        metric=params.metric,
        centers=centers,
        data=torch.zeros((params.n_lists, 1, X.shape[1]), dtype=X.dtype,
                         device=X.device),
        indices=torch.full((params.n_lists, 1), PAD_ID, dtype=idx_dtype,
                           device=X.device),
        list_sizes=torch.zeros((params.n_lists,), dtype=torch.int32,
                               device=X.device),
        adaptive_centers=params.adaptive_centers,
        conservative_memory_allocation=params.conservative_memory_allocation,
    )
    if params.add_data_on_build:
        index = _extend(index, X, torch.arange(n, dtype=idx_dtype,
                                               device=X.device))
    return index


def _grown_cap(list_sizes, counts, cap: int, conservative: bool) -> int:
    """Capacity after an append: unchanged when everything fits, else the
    next power of two, or the exact need under conservative allocation."""
    need = int(torch.max(list_sizes + counts))
    if need <= cap:
        return cap
    return max(need, 1) if conservative else next_pow2(need)


def _append_in_place(store, ids, list_sizes, payload, new_ids, labels,
                     conservative: bool, adaptive: bool = False,
                     centers=None):
    """Grow if needed, then scatter the new rows at each list's fill
    offset. Writes into ``store``/``ids`` in place when they have room.
    Returns ``(store, ids, sizes, centers)``."""
    n_lists, cap = store.shape[0], store.shape[1]
    labels = labels.long()
    counts = torch.bincount(labels, minlength=n_lists)
    new_cap = _grown_cap(list_sizes, counts, cap, conservative)
    if new_cap > cap:
        store = torch.nn.functional.pad(store, (0, 0, 0, new_cap - cap))
        ids = torch.nn.functional.pad(ids, (0, new_cap - cap), value=PAD_ID)
    order = torch.argsort(labels, stable=True)
    sl = labels[order]
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(labels.shape[0], device=store.device) - offsets[sl]
    pos = list_sizes.long()[sl] + rank
    store[sl, pos] = payload[order].to(store.dtype)
    ids[sl, pos] = new_ids[order].to(ids.dtype)
    new_sizes = list_sizes + counts.to(torch.int32)
    if adaptive:
        # The size-weighted update keeps each center the mean of its
        # members without a pass over the existing rows.
        sums = torch.zeros_like(centers).index_add_(
            0, labels, as_float(payload).to(centers.dtype))
        tot = torch.clamp_min(new_sizes.to(centers.dtype), 1.0)
        upd = (centers * list_sizes.to(centers.dtype)[:, None] + sums) \
            / tot[:, None]
        centers = torch.where((counts > 0)[:, None], upd, centers)
    return store, ids, new_sizes, centers


def _auto_id_base(index: Index) -> int:
    """First free auto-assigned id: ``max(existing id) + 1``."""
    if index._next_id is not None:
        return index._next_id
    return int(torch.max(index.indices)) + 1


def _track_next_id(index: Index, new_indices, default_base=None,
                   n_new: int = 0) -> None:
    cur = _auto_id_base(index)
    if default_base is not None:
        index._next_id = max(cur, default_base + n_new)
    else:
        index._next_id = max(cur, int(torch.max(new_indices)) + 1)


def _pad_deleted(deleted, new_cap: int):
    """Grow the tombstone mask with the capacity: new slots are live."""
    if deleted is None or deleted.shape[-1] == new_cap:
        return deleted
    fresh = deleted.new_zeros(deleted.shape[:-1]
                              + (new_cap - deleted.shape[-1],))
    return torch.cat([deleted, fresh], dim=-1)


def extend(index: Index, new_vectors, new_indices=None,
           handle=None) -> Index:
    """Append vectors (ids default to ``max id + 1`` onwards). The index
    is mutated and returned; its storage is written in place when the
    lists have room. Tombstoned slots are not reclaimed. Rejects
    non-finite vectors, and ids the index's id dtype cannot hold."""
    dev = handle.device if handle is not None else index.centers.device
    X = as_vectors(new_vectors, device=dev)
    expects(X.ndim == 2 and X.shape[1] == index.dim, "dim mismatch")
    expects_finite("ivf_flat.extend", X)
    if new_indices is not None:
        new_indices = as_tensor(new_indices, device=dev)
        expects_ids_fit("ivf_flat.extend", new_indices, index.indices.dtype)
    return _extend(index, X, new_indices)


def _extend(index: Index, X: torch.Tensor, new_indices=None) -> Index:
    """:func:`extend` on checked vectors already on the index's device."""
    dev = X.device
    n_new = X.shape[0]
    if n_new == 0:
        return index
    default_base = None
    if new_indices is None:
        default_base = _auto_id_base(index)
        new_indices = torch.arange(default_base, default_base + n_new,
                                   dtype=index.indices.dtype, device=dev)
    else:
        new_indices = as_tensor(new_indices, device=dev).to(
            index.indices.dtype)

    labels = kmeans_balanced._predict(
        KMeansBalancedParams(metric=index.metric), index.centers,
        as_float(X))

    if not index.size:
        min_cap = 0
        if not index.conservative_memory_allocation:
            counts = torch.bincount(labels.long(), minlength=index.n_lists)
            min_cap = next_pow2(int(torch.max(counts)))
        data, ids, sizes = _pack_lists(X.to(index.data.dtype), labels,
                                       new_indices, index.n_lists, min_cap)
        centers = index.centers
        if index.adaptive_centers:
            sums = torch.zeros_like(centers).index_add_(
                0, labels.long(), as_float(X))
            cnt = torch.clamp_min(sizes.to(centers.dtype), 1.0)
            centers = torch.where((sizes > 0)[:, None], sums / cnt[:, None],
                                  centers)
        index.data, index.indices, index.list_sizes = data, ids, sizes
        index.centers = centers
        index.deleted = (None if index.deleted is None
                         else torch.zeros(ids.shape, dtype=torch.bool,
                                          device=dev))
        index.n_deleted = 0
    else:
        data, ids, sizes, centers = _append_in_place(
            index.data, index.indices, index.list_sizes, X, new_indices,
            labels, index.conservative_memory_allocation,
            index.adaptive_centers,
            index.centers if index.adaptive_centers else None)
        index.data, index.indices, index.list_sizes = data, ids, sizes
        index.deleted = _pad_deleted(index.deleted, data.shape[1])
        if index.adaptive_centers:
            index.centers = centers
    _track_next_id(index, new_indices, default_base, n_new)
    index.epoch += 1
    index.reset_search_cache()  # occupancy changed
    return index


def _probe_scan(queries, data, data_sq_norms, indices, list_sizes, k: int,
                inner_is_l2: bool, sqrt: bool, probe_ids, deleted=None):
    """Scan engine: for each probe rank, gather every query's list, score
    it, mask invalid and tombstoned slots to the worst value, and merge
    into the running top-k (stable: ties keep candidate position)."""
    q = queries.shape[0]
    cap = data.shape[1]
    qn = row_norms_sq(queries) if inner_is_l2 else None
    worst = worst_value(inner_is_l2)
    slot = torch.arange(cap, device=queries.device)[None, :]
    best_d = torch.full((q, k), worst, dtype=queries.dtype,
                        device=queries.device)
    best_i = torch.full((q, k), PAD_ID, dtype=indices.dtype,
                        device=queries.device)
    for j in range(probe_ids.shape[1]):
        lists = probe_ids[:, j].long()
        block = data[lists]                                 # (q, cap, d)
        invalid = slot >= list_sizes[lists][:, None]
        if deleted is not None:
            invalid = invalid | deleted[lists]
        g = torch.bmm(block, queries[:, :, None])[:, :, 0]
        if inner_is_l2:
            dt = torch.clamp_min(qn[:, None] + data_sq_norms[lists]
                                 - 2.0 * g, 0.0)
        else:
            dt = g
        dt = torch.where(invalid, worst, dt)
        cat_d = torch.cat([best_d, dt], dim=1)
        cat_i = torch.cat([best_i, indices[lists]], dim=1)
        best_d, pos = stable_top_k(cat_d, k, select_min=inner_is_l2)
        best_i = torch.gather(cat_i, 1, pos)
    if inner_is_l2 and sqrt:
        best_d = torch.sqrt(best_d)
    return best_d, best_i


def _chunked_over_queries(fn, Q, probe_ids, per_q_bytes: int, k: int,
                          id_dtype: torch.dtype,
                          budget: int = 64 * 1024 * 1024):
    """Run ``fn(Q_chunk, probe_ids_chunk)`` over query chunks sized so the
    per-probe gather stays under ``budget`` bytes. No queries give (0, k)
    results: distances in the queries' dtype, ids in ``id_dtype``."""
    nq = Q.shape[0]
    if nq == 0:
        return (Q.new_zeros((0, k)),
                torch.zeros((0, k), dtype=id_dtype, device=Q.device))
    chunk = max(1, min(nq, budget // max(per_q_bytes, 1)))
    outs = [fn(Q[s:s + chunk], probe_ids[s:s + chunk])
            for s in range(0, nq, chunk)]
    return (torch.cat([o[0] for o in outs], dim=0),
            torch.cat([o[1] for o in outs], dim=0))


def _sorted_probe_pairs(probe_ids, n_lists: int):
    """Flatten the (query, probe) pairs probe-rank-major, stable-sort them
    by list, and rank each pair within its list. Returns
    ``(sorted_lists, sorted_query, pos, order)``, all int64."""
    q, p = probe_ids.shape
    dev = probe_ids.device
    flat_lists = probe_ids.t().reshape(-1).long()
    flat_query = torch.arange(q, device=dev).repeat(p)
    order = torch.argsort(flat_lists, stable=True)
    sorted_lists = flat_lists[order]
    sorted_query = flat_query[order]
    starts = torch.searchsorted(sorted_lists,
                                torch.arange(n_lists, device=dev))
    pos = torch.arange(q * p, device=dev) - starts[sorted_lists]
    return sorted_lists, sorted_query, pos, order


# Memory budget of the bucketed engine's query-gather table (n_lists,
# bucket_cap, dim) f32: beyond it "auto" takes the scan engine instead.
_BUCKET_TABLE_BYTES = 512 * 1024 * 1024


def _auto_cap_cache(index) -> dict:
    """Per-index memo of the auto-measured bucket capacity, keyed on
    (n_queries, n_probes); extend() and reset_search_cache() clear it."""
    return index.__dict__.setdefault("_auto_cap_cache", {})


def _front_rank_contention(probe_ids, n_lists: int) -> Tuple[int, int]:
    """``(best_half_max, rank0_max)``: the largest per-list count of
    (query, probe) pairs whose probe rank is in the query's best half, and
    of rank-0 pairs alone."""
    half = max(1, probe_ids.shape[1] - probe_ids.shape[1] // 2)
    front = probe_ids[:, :half].reshape(-1).long()
    return (int(torch.max(torch.bincount(front, minlength=n_lists))),
            int(torch.max(torch.bincount(probe_ids[:, 0].long(),
                                         minlength=n_lists))))


def _pick_engine(engine: str, n_queries: int, n_probes: int, n_lists: int,
                 k: int, bucket_cap: int, dim: int, probe_ids,
                 device: torch.device, allow_bucketed: bool = True,
                 cap_cache=None) -> Tuple[str, int]:
    """Resolve ``engine`` ("auto" takes "bucketed" on ``cuda`` when the
    mean probe load per list fills buckets, as the reference does on
    ``tpu``) and the bucket capacity. A measured capacity covers every
    pair in each query's best half of probes, bounded at 8x the mean load
    but never below the rank-0 contention, rounded up to a power of two
    and memoized in ``cap_cache``. If it would overflow the bucket-table
    budget, "auto" takes the scan engine; an explicit "bucketed" is
    clamped to the budget with a warning."""
    expects(engine in ("auto", "scan", "bucketed"),
            f"unknown engine {engine!r} (auto|scan|bucketed)")
    cap_q = bucket_cap
    cap_clamp = max(8, _BUCKET_TABLE_BYTES // max(n_lists * dim * 4, 1))
    mean_load = max(1, (n_queries * n_probes) // n_lists)

    def measured_cap():
        key = (n_queries, n_probes)
        if cap_cache is not None and key in cap_cache:
            return cap_cache[key]
        front, rank0 = _front_rank_contention(probe_ids, n_lists)
        cap = next_pow2(max(front, 4 * mean_load, 8))
        bound = max(next_pow2(8 * mean_load), next_pow2(max(rank0, 1)))
        if cap > bound:
            logger.debug("auto bucket cap %d exceeds skew bound %d - "
                         "capping; deep-rank probes of contended lists may "
                         "drop", cap, bound)
            cap = bound
        cap = min(n_queries, cap)
        if cap_cache is not None:
            cap_cache[key] = cap
        return cap

    if engine == "auto":
        load = n_queries * n_probes / n_lists
        if (allow_bucketed and device.type == "cuda" and load >= 8
                and k <= 128):
            if cap_q == 0:
                cap_q = measured_cap()
                engine = "bucketed" if cap_q <= cap_clamp else "scan"
            else:
                engine = "bucketed"
        else:
            engine = "scan"
    elif engine == "bucketed" and cap_q == 0:
        cap_q = measured_cap()
        if cap_q > cap_clamp:
            logger.warning(
                "bucketed capacity clamped %d -> %d by the bucket-table "
                "memory budget; under heavy skew queries may lose "
                "best-rank probes (use engine='auto' or 'scan' for the "
                "drop-safe behavior)", cap_q, cap_clamp)
            cap_q = cap_clamp
    logger.debug("ivf search dispatch: engine=%s q=%d probes=%d lists=%d "
                 "k=%d cap_q=%d", engine, n_queries, n_probes, n_lists, k,
                 cap_q)
    return engine, cap_q


def _invert_probe_map(probe_ids, n_lists: int, bucket_cap: int):
    """Invert (query -> probed lists) into per-list query buckets of
    ``bucket_cap`` slots, rank-major, so overflow drops the farthest-
    centroid probes first. Returns ``(bucket (n_lists, bucket_cap) int64
    query ids, -1 = empty; route)``."""
    sorted_lists, sorted_query, pos, order = _sorted_probe_pairs(
        probe_ids, n_lists)
    keep = pos < bucket_cap
    bucket = torch.full((n_lists * bucket_cap,), -1, dtype=torch.int64,
                        device=probe_ids.device)
    bucket[(sorted_lists * bucket_cap + pos)[keep]] = sorted_query[keep]
    return (bucket.reshape(n_lists, bucket_cap),
            (sorted_lists, pos, keep, order))


def _route_candidates(bd_, gi, route, q: int, p: int, bucket_cap: int,
                      worst: float):
    """Send each (list, slot) pair's top-kk candidates back to its query:
    (q, p*kk) rows, probe-rank-major; dropped pairs give (worst, -1)."""
    sorted_lists, pos, keep, order = route
    kk = bd_.shape[2]
    ppos = torch.clamp_max(pos, bucket_cap - 1)
    cd = torch.where(keep[:, None], bd_[sorted_lists, ppos], worst)
    ci = torch.where(keep[:, None], gi[sorted_lists, ppos], PAD_ID)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    cd = cd[inv].reshape(p, q, kk).transpose(0, 1).reshape(q, p * kk)
    ci = ci[inv].reshape(p, q, kk).transpose(0, 1).reshape(q, p * kk)
    return cd, ci


def _bucketed_probe_scan(queries, data, indices, list_sizes, probe_ids,
                         k: int, inner_is_l2: bool, sqrt: bool,
                         bucket_cap: int, qsplit: bool = False,
                         deleted=None):
    """Bucket-table engine: invert the probe map into per-list query
    buckets, score every bucket against its own list in one batched B3
    launch, route each pair's candidates back and select per query."""
    q = queries.shape[0]
    n_lists, cap, _ = data.shape
    bucket, route = _invert_probe_map(probe_ids, n_lists, bucket_cap)
    Qb = queries[torch.clamp_min(bucket, 0)]          # (L, bucket_cap, d)
    invalid = (torch.arange(cap, device=queries.device)[None, :]
               >= list_sizes[:, None])
    if deleted is not None:
        invalid = invalid | deleted
    # Each bucket fills from slot 0 upward, and the routing reads only the
    # filled slots: B3 scans just those.
    live_rows = (bucket >= 0).sum(1).to(torch.int32)
    bd_, bi_ = fused_batch_knn(Qb, data, invalid, k,
                               metric="l2" if inner_is_l2 else "ip",
                               bf16=data.dtype == torch.bfloat16,
                               qsplit=qsplit, live_rows=live_rows)
    gi = indices[torch.arange(n_lists, device=queries.device)[:, None, None],
                 torch.clamp_min(bi_, 0).long()]
    gi = torch.where(bi_ < 0, PAD_ID, gi)
    cd, ci = _route_candidates(bd_, gi, route, q, probe_ids.shape[1],
                               bucket_cap, worst_value(inner_is_l2))
    best_d, best_i = select_k(cd, k, select_min=inner_is_l2, indices=ci)
    if inner_is_l2 and sqrt:
        best_d = torch.sqrt(best_d)
    return best_d, best_i


def _invert_probe_map_cells(probe_ids, n_lists: int, qrows: int):
    """Invert (query -> probed lists) into packed query cells: list l owns
    ``ceil(load_l / qrows)`` consecutive cells of ``qrows`` slots, so no
    pair is dropped. Returns ``(cell_list (max_cells,) int32, -1 = unused;
    bucket (max_cells, qrows) query ids, -1 = pad; route)``."""
    q, p = probe_ids.shape
    dev = probe_ids.device
    max_cells = (q * p) // qrows + n_lists
    sorted_lists, sorted_query, pos, order = _sorted_probe_pairs(
        probe_ids, n_lists)
    loads = torch.bincount(sorted_lists, minlength=n_lists)
    n_cells = (loads + qrows - 1) // qrows
    base_cell = torch.cumsum(n_cells, 0) - n_cells
    cell = base_cell[sorted_lists] + pos // qrows
    slot = pos % qrows
    bucket = torch.full((max_cells * qrows,), -1, dtype=torch.int64,
                        device=dev)
    bucket[cell * qrows + slot] = sorted_query
    cell_list = torch.full((max_cells,), -1, dtype=torch.int32, device=dev)
    cell_list[cell] = sorted_lists.to(torch.int32)
    return cell_list, bucket.reshape(max_cells, qrows), (cell, slot, order)


def _route_candidates_cells(bd_, gi, route, q: int, p: int):
    """Send each cell slot's top-kk candidates back to its query: (q,
    p*kk) candidate rows, probe-rank-major, for the final selection."""
    cell, slot, order = route
    kk = bd_.shape[2]
    cd = bd_[cell, slot]                                     # (p*q, kk)
    ci = gi[cell, slot]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    cd = cd[inv].reshape(p, q, kk).transpose(0, 1).reshape(q, p * kk)
    ci = ci[inv].reshape(p, q, kk).transpose(0, 1).reshape(q, p * kk)
    return cd, ci


# Query-slot width of one packed cell, the per-list data-block budget of
# the cells engine, and the widest top-k queue of kernel B2.
_CELL_QROWS = 64
_CELL_DB_BYTES = 6 * 1024 * 1024
_CELLS_MAX_K = 256


def _cells_eligible(engine: str, k: int, bucket_cap: int, cap: int, dim: int,
                    n_queries: int, n_probes: int, n_lists: int,
                    device: torch.device) -> bool:
    """The packed-cells dispatch gate: engine allows it, k within the B2
    queue, no explicit bucket_cap, one list's block within the budget,
    and for "auto" a ``cuda`` device with a probe load that fills cells."""
    if not (engine in ("auto", "bucketed") and k <= _CELLS_MAX_K
            and bucket_cap == 0):
        return False
    if round_up_safe(cap, 128) * round_up_safe(dim, 128) * 4 > _CELL_DB_BYTES:
        return False
    if engine == "bucketed":
        return True
    load = n_queries * n_probes / max(n_lists, 1)
    return device.type == "cuda" and load >= 8


def _cells_scan_probes(Q, probe_ids, data, indices, list_sizes, k: int,
                       inner_is_l2: bool, qrows: int, qsplit: bool,
                       deleted=None):
    """Scan the given probed lists with the packed-cells engine (kernel
    B2): best-first (q, k) candidates in true metric values, no sqrt."""
    q = Q.shape[0]
    cap = data.shape[1]
    cell_list, bucket, route = _invert_probe_map_cells(
        probe_ids, data.shape[0], qrows)
    Qc = Q[torch.clamp_min(bucket, 0)]             # (max_cells, qrows, d)
    invalid = (torch.arange(cap, device=Q.device)[None, :]
               >= list_sizes[:, None])
    if deleted is not None:
        invalid = invalid | deleted
    bd_, bi_ = fused_cells_knn(cell_list, Qc, data, invalid, k,
                               l2=inner_is_l2,
                               bf16=data.dtype == torch.bfloat16,
                               qsplit=qsplit)
    gi = indices[torch.clamp_min(cell_list, 0).long()[:, None, None],
                 torch.clamp_min(bi_, 0).long()]
    gi = torch.where(bi_ < 0, PAD_ID, gi)
    cd, ci = _route_candidates_cells(bd_, gi, route, q, probe_ids.shape[1])
    best_d, best_i = select_k(cd, k, select_min=True, indices=ci)
    if not inner_is_l2:
        best_d = -best_d
    return best_d, best_i


def search(params: SearchParams, index: Index, queries, k: int,
           handle=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the ``n_probes`` nearest centers, then scan the probed lists.
    Returns ``(distances (q, k), neighbors (q, k))``, the neighbors in the
    index's id dtype; fewer than k
    valid candidates leave (worst, -1) slots."""
    dev = handle.device if handle is not None else index.centers.device
    Q = as_float(queries, device=dev)
    expects(Q.ndim == 2 and Q.shape[1] == index.dim, "query dim mismatch")
    expects_finite("ivf_flat.search", Q)
    expects(params.engine in ("auto", "scan", "bucketed"),
            f"unknown engine {params.engine!r} (auto|scan|bucketed)")
    n_probes = min(params.n_probes, index.n_lists)
    k = min(k, max(index.capacity, 1))
    metric = index.metric
    inner_is_l2 = metric != DistanceType.InnerProduct
    sqrt = metric in (DistanceType.L2SqrtExpanded,
                      DistanceType.L2SqrtUnexpanded)
    probe_ids = _coarse_probe(Q, index.centers, n_probes, inner_is_l2)
    if index.data.dtype in (torch.uint8, torch.int8):
        # 8-bit values are exact in bf16: the kernels read bf16 rows and
        # keep f32 query precision with the split query.
        data, qsplit = index.data.to(torch.bfloat16), True
    else:
        data, qsplit = as_float(index.data), False

    if _cells_eligible(params.engine, k, params.bucket_cap,
                       index.data.shape[1], index.dim, Q.shape[0], n_probes,
                       index.n_lists, Q.device):
        best_d, best_i = _cells_scan_probes(
            Q, probe_ids, data, index.indices, index.list_sizes, k,
            inner_is_l2, min(_CELL_QROWS, max(8, Q.shape[0])), qsplit,
            index.deleted)
        if inner_is_l2 and sqrt:
            best_d = torch.sqrt(best_d)
        return best_d, best_i

    engine, cap_q = _pick_engine(params.engine, Q.shape[0], n_probes,
                                 index.n_lists, k, params.bucket_cap,
                                 index.dim, probe_ids, Q.device,
                                 cap_cache=_auto_cap_cache(index))
    if engine == "bucketed":
        return _bucketed_probe_scan(Q, data, index.indices,
                                    index.list_sizes, probe_ids, k,
                                    inner_is_l2, sqrt, cap_q, qsplit,
                                    index.deleted)
    # f32 scoring over every store dtype, as the reference's f32 einsum
    # promotes bf16 / f16 / 8-bit rows.
    dataf = index.data.float()
    norms = row_norms_sq(dataf) if inner_is_l2 else None
    return _chunked_over_queries(
        lambda q_, p_: _probe_scan(q_, dataf, norms, index.indices,
                                   index.list_sizes, k, inner_is_l2, sqrt,
                                   p_, index.deleted),
        Q, probe_ids, dataf.shape[1] * index.dim * 4, k, index.indices.dtype)


# ---------------------------------------------------------------------------
# Serialization: the reference's npz layout (one .npy payload per array).

SERIALIZATION_VERSION = 3


def save(filename, index: Index, retry=None) -> None:
    """Write ``index`` to ``filename`` (``.npz`` added) in the reference's
    layout: the version, metric and flags as scalars, then ``centers``,
    ``data``, ``indices`` and ``list_sizes``, and ``deleted`` only when a
    slot is tombstoned. The write runs under ``with_retry`` (``retry`` or
    ``DEFAULT_IO_RETRY``)."""
    payload = dict(
        version=np.int64(SERIALIZATION_VERSION),
        metric=np.int64(index.metric.value),
        adaptive_centers=np.bool_(index.adaptive_centers),
        conservative=np.bool_(index.conservative_memory_allocation),
        centers=to_numpy(index.centers),
        data=to_numpy(index.data),
        indices=to_numpy(index.indices),
        list_sizes=to_numpy(index.list_sizes),
    )
    if index.n_deleted:
        # Tombstones are index content: a reload must not resurrect them.
        payload["deleted"] = to_numpy(index.deleted)
    write_npz(filename, payload, retry)


def load(filename, retry=None, device=None) -> Index:
    """Read an index written by :func:`save` (or by the reference) onto
    ``device`` (``cuda`` by default; raises without a card). The read runs
    under ``with_retry``. The index has epoch 0 and no search caches."""
    dev = resolve_device(device)
    z = read_npz(filename, retry)
    version = int(z["version"])
    expects(version == SERIALIZATION_VERSION,
            "serialization version mismatch: %s", version)
    validate_idx_dtype(z["indices"].dtype)
    deleted = z.get("deleted")
    return Index(
        metric=DistanceType(int(z["metric"])),
        centers=from_numpy(z["centers"], dev),
        data=from_numpy(z["data"], dev),
        indices=from_numpy(z["indices"], dev),
        list_sizes=from_numpy(z["list_sizes"], dev),
        adaptive_centers=bool(z["adaptive_centers"]),
        conservative_memory_allocation=bool(z["conservative"]),
        deleted=None if deleted is None else from_numpy(deleted, dev),
        n_deleted=0 if deleted is None else int(deleted.sum()),
    )
