"""Multi-rank IVF-Flat: shard the rows of every list, search locally,
merge.

Port of ``raft_tpu/parallel/ivf.py``, the row placement
(``placement="row"``): one coarse model (the balanced k-means centers) is
replicated, and every rank holds the capacity-padded lists of ITS row
shard only, so the union of every rank's list l is the single-device list
l. Search is collective: each rank probes the shared centers with
``ivf_flat._coarse_probe``, scans its slice of the probed lists with the
single-card engine the gate picks (``ivf_flat._cells_eligible``: kernel
B2 on the card at a probe load that fills cells, else the scan engine),
and the merge engine combines the ranks' top-k. The probed candidate set
is the single-device one, so the results are those of one index built
from the same centers, up to the order of exact distance ties.

Every rank packs its lists at one common capacity (a MAX allreduce), as
the reference does. ``search`` takes a ``live_mask`` for degraded
serving (rank 0's is used), returning a per-query ``coverage``: live
probed rows over all probed rows.

The list placement (``placement="list"``, routed search) and the sharded
IVF-PQ wait for ROADMAP A.4b.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.comms.comms import Comms, Mesh, OpT
from raft_tpu_torch.comms.topk_merge import (merge_dispatch_stats,
                                             pipeline_chunk_bounds,
                                             resolve_merge_engine,
                                             resolve_pipeline_chunks)
from raft_tpu_torch.core.error import expects, expects_finite
from raft_tpu_torch.core.mdarray import expects_ids_fit, validate_idx_dtype
from raft_tpu_torch.core.resources import as_float, as_tensor
from raft_tpu_torch.core.sentinels import PAD_ID
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import row_norms_sq
from raft_tpu_torch.neighbors import ivf_flat as _flat
from raft_tpu_torch.parallel.degraded import (check_live_mask,
                                              expects_finite_all,
                                              probed_coverage,
                                              scan_merge_dispatch)
from raft_tpu_torch.parallel.kmeans import sharded_kmeans_balanced_fit
from raft_tpu_torch.parallel.knn import RowShard, _check_mesh, shard_database
from raft_tpu_torch.util.pow2 import next_pow2

_WAITS = "waits for ROADMAP A.4b"


@dataclass
class ShardedIvfFlat:
    """IVF-Flat with the rows of every list sharded over the ranks; the
    coarse centers are replicated. Each rank's object holds its own
    shard."""

    metric: DistanceType
    centers: torch.Tensor       # (n_lists, dim), the same on every rank
    data: torch.Tensor          # (n_lists, cap, dim): this rank's rows
    indices: torch.Tensor       # (n_lists, cap): their global ids
    list_sizes: torch.Tensor    # (n_lists,) int32: this rank's fill
    n_dev: int
    n_rows: int = 0             # rows over every shard
    # Bumped by every mutation: the serving layer's cache key.
    epoch: int = 0
    deleted: Optional[torch.Tensor] = None   # (n_lists, cap) bool
    n_deleted: int = 0          # over every shard
    _next_id: Optional[int] = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def size(self) -> int:
        return self.n_rows

    @property
    def live_size(self) -> int:
        """Rows that answer queries: ``size`` minus tombstoned slots."""
        return self.size - self.n_deleted


def _shard_pack(comms: Comms, rows, labels, ids, n_lists: int):
    """Pack this rank's rows into its lists at the capacity common to
    every rank (the next power of two of the fullest list anywhere)."""
    counts = torch.bincount(labels.long(), minlength=n_lists)
    most = comms.allreduce(torch.max(counts).reshape(1).cpu(), OpT.MAX)
    return _flat._pack_lists(rows, labels, ids, n_lists,
                             min_cap=next_pow2(int(most[0])))


def sharded_ivf_flat_build(mesh: Mesh, params: "_flat.IndexParams",
                           dataset, centers=None,
                           train_distributed: bool = False,
                           placement: str = "row") -> ShardedIvfFlat:
    """Build with the rows sharded over the mesh. Collective: every rank
    passes the same arguments (``dataset`` the whole matrix, or this
    rank's :class:`~raft_tpu_torch.parallel.knn.RowShard`; its rows
    divide the mesh size). ``centers`` injects a trained coarse model;
    otherwise rank 0 trains it as ``ivf_flat.build`` does and broadcasts
    it, or with ``train_distributed`` every rank trains it together with
    the sharded balancing EM (:func:`~raft_tpu_torch.parallel.kmeans.
    sharded_kmeans_balanced_fit`). Ids are the global row numbers."""
    expects(placement in ("row", "list"),
            "placement must be 'row' or 'list', got %r", placement)
    expects(placement == "row", "placement='list' (whole lists per shard, "
            "routed search) " + _WAITS)
    _check_mesh(mesh)
    comms = Comms(mesh)
    idx_dtype = validate_idx_dtype(params.idx_dtype)
    shard = shard_database(mesh, dataset)
    rows = shard.rows
    expects(shard.n_total >= params.n_lists, "need at least n_lists rows")
    expects_finite_all(comms, "sharded_ivf_flat_build", rows)
    if centers is not None:
        centers = as_float(centers, device=mesh.device).to(mesh.device)
        expects(centers.shape == (params.n_lists, rows.shape[1]),
                "centers must be (n_lists, dim)")
        expects_finite("sharded_ivf_flat_build", centers)
    elif train_distributed:
        centers = sharded_kmeans_balanced_fit(
            mesh, shard, params.n_lists, n_iters=params.kmeans_n_iters)
    else:
        expects(not isinstance(dataset, RowShard), "training from one "
                "rank's shard needs train_distributed=True or centers=")
        # One rank trains (a card's index_add_ is not bit-reproducible,
        # and every rank must hold the same model) and broadcasts.
        if mesh.rank == 0:
            full = as_float(dataset, device=mesh.device).to(mesh.device)
            centers = _flat._train_centers(params, full)
            del full
        else:
            centers = torch.empty((params.n_lists, rows.shape[1]),
                                  dtype=rows.dtype, device=mesh.device)
        centers = comms.bcast(centers)
    labels = kmeans_balanced._predict(
        KMeansBalancedParams(metric=params.metric), centers, rows)
    ids = torch.arange(shard.offset, shard.offset + rows.shape[0],
                       dtype=idx_dtype, device=mesh.device)
    data, idx, sizes = _shard_pack(comms, rows, labels, ids, params.n_lists)
    return ShardedIvfFlat(metric=params.metric, centers=centers, data=data,
                          indices=idx, list_sizes=sizes, n_dev=mesh.size,
                          n_rows=shard.n_total, _next_id=shard.n_total)


def _check_index(mesh: Mesh, index) -> Comms:
    _check_mesh(mesh)
    expects(isinstance(index, ShardedIvfFlat),
            "expected a ShardedIvfFlat (sharded IVF-PQ %s), got %s", _WAITS,
            type(index).__name__)
    expects(index.n_dev == mesh.size,
            "index sharded over %s ranks, mesh has %s", index.n_dev,
            mesh.size)
    return Comms(mesh)


def sharded_ivf_flat_search(mesh: Mesh, params: "_flat.SearchParams",
                            index: ShardedIvfFlat, queries, k: int,
                            merge_engine: str = "auto", live_mask=None,
                            pipeline_chunks: int = 0):
    """Search the sharded index (collective); returns replicated
    ``(distances, global ids)``. The per-rank engine follows the
    single-card gate with the per-shard list capacity: the packed-cells
    engine (B2 on the card) where it is eligible, else the scan engine.
    ``merge_engine``: "allgather" | "ring" | "ring_bf16" | "pipelined" |
    "pipelined_bf16" | "auto"; the pipelined engines scan the probes in
    ``pipeline_chunks`` column ranges (0 = the default split), each
    range's exchange overlapped with the next range's scan.

    ``live_mask`` (bool (n_dev,), rank 0's is used) enables degraded
    serving: dead shards' candidates are neutralized before the merge and
    a third output ``coverage`` (float32 (q,)) is the per-query fraction
    of probed rows searched; with every shard live the first two outputs
    are those of ``live_mask=None``."""
    comms = _check_index(mesh, index)
    live = (None if live_mask is None
            else check_live_mask(live_mask, comms))
    return _sharded_ivf_flat_search(mesh, params, index, queries, k,
                                    merge_engine, live, pipeline_chunks)


def _sharded_ivf_flat_search(mesh: Mesh, params: "_flat.SearchParams",
                             index: ShardedIvfFlat, queries, k: int,
                             merge_engine: str, live, pipeline_chunks: int):
    """:func:`sharded_ivf_flat_search` with ``live`` already agreed across
    the ranks (:func:`check_live_mask`'s output, or None): the sharded
    Searcher agrees it once to decide the degraded path and passes it
    here."""
    comms = _check_index(mesh, index)
    Q = as_float(queries, device=mesh.device)
    expects(Q.device == mesh.device, "queries on %s, mesh on %s", Q.device,
            mesh.device)
    expects(Q.ndim == 2 and Q.shape[1] == index.dim, "query dim mismatch")
    expects_finite("sharded_ivf_flat_search", Q)
    expects(params.engine in ("auto", "scan", "bucketed"),
            f"unknown engine {params.engine!r} (auto|scan|bucketed)")
    n_dev, n_lists = mesh.size, index.n_lists
    cap = index.indices.shape[1]
    n_probes = min(params.n_probes, n_lists)
    k = min(k, n_dev * n_lists * cap)
    inner_is_l2 = index.metric != DistanceType.InnerProduct
    sqrt = index.metric in (DistanceType.L2SqrtExpanded,
                            DistanceType.L2SqrtUnexpanded)
    use_cells = _flat._cells_eligible(params.engine, k, params.bucket_cap,
                                      cap, index.dim, Q.shape[0], n_probes,
                                      n_lists, Q.device)
    alive = None if live is None else bool(live[mesh.rank])
    engine = resolve_merge_engine(merge_engine, Q.shape[0], k, n_dev,
                                  n_probes=n_probes)
    chunks = tuple(pipeline_chunk_bounds(
        n_probes, resolve_pipeline_chunks(engine, n_probes, n_dev,
                                          requested=pipeline_chunks)))
    merge_dispatch_stats.record(
        engine, Q.shape[0], k, min(k, n_lists * cap), n_dev,
        idx_bytes=index.indices.element_size(),
        chunk_kks=([min(k, (hi - lo) * cap) for lo, hi in chunks]
                   if len(chunks) > 1 else None))
    probe_ids = _flat._coarse_probe(Q, index.centers, n_probes, inner_is_l2)
    if use_cells:
        qrows = min(_flat._CELL_QROWS, max(8, Q.shape[0]))
    else:
        # As the reference: norms summed in the store's dtype, then
        # promoted; the scores in f32.
        dataf = index.data.float()
        norms = row_norms_sq(index.data).float() if inner_is_l2 else None

    def scan_range(lo, hi, kk_c):
        pids = probe_ids[:, lo:hi]
        if use_cells:
            return _flat._cells_scan_probes(
                Q, pids, index.data, index.indices, index.list_sizes, kk_c,
                inner_is_l2, qrows, False, index.deleted)
        return _flat._chunked_over_queries(
            lambda q_, p_: _flat._probe_scan(
                q_, dataf, norms, index.indices, index.list_sizes, kk_c,
                inner_is_l2, False, p_, index.deleted),
            Q, pids, cap * index.dim * 4, kk_c, index.indices.dtype)

    out_d, out_i = scan_merge_dispatch(
        scan_range, chunks,
        chunk_width=lambda lo, hi: min(k, (hi - lo) * cap),
        full_kk=min(k, n_lists * cap), engine=engine, k=k, comms=comms,
        select_min=inner_is_l2, alive=alive)
    if inner_is_l2 and sqrt:
        out_d = torch.sqrt(out_d)
    if live is None:
        return out_d, out_i
    return out_d, out_i, probed_coverage(probe_ids, index.list_sizes, alive,
                                         comms)


def sharded_ivf_flat_extend(mesh: Mesh, index: ShardedIvfFlat, new_vectors,
                            new_indices=None, *,
                            donate: bool = True) -> ShardedIvfFlat:
    """Append rows to the sharded index (collective; the same arguments on
    every rank). The new rows are dealt contiguously over the ranks (their
    count divides the mesh size, the build's contract) and each rank
    appends its part at its lists' fill offsets, after growing every
    rank's capacity to one common power of two if a list overflows. Ids
    default to ``max id + 1`` onwards. ``donate=False`` writes into copies
    (copy-on-write), for a mutation racing readers of the old tensors.
    The coarse model is unchanged."""
    comms = _check_index(mesh, index)
    X = as_float(new_vectors, device="cpu")
    expects(X.ndim == 2 and X.shape[1] == index.dim, "dim mismatch")
    n_new = X.shape[0]
    expects(n_new % mesh.size == 0,
            "rows must divide the mesh axis (pad first)")
    m = n_new // mesh.size
    lo = mesh.rank * m
    X_local = X[lo:lo + m].to(mesh.device)
    expects_finite_all(comms, "sharded_ivf_flat_extend", X_local)
    id_dtype = index.indices.dtype
    default_base = None
    if new_indices is None:
        default_base = _flat._auto_id_base(index)
        ids = torch.arange(default_base, default_base + n_new,
                           dtype=id_dtype)
    else:
        ids = as_tensor(new_indices, device="cpu").reshape(-1)
        expects(ids.numel() == n_new, "one id per new row")
        expects_ids_fit("sharded_ivf_flat_extend", ids, id_dtype)
        ids = ids.to(id_dtype)
    if n_new == 0:
        index.epoch += 1
        return index
    labels = kmeans_balanced._predict(
        KMeansBalancedParams(metric=index.metric), index.centers, X_local)
    counts = torch.bincount(labels.long(), minlength=index.n_lists)
    need = int(comms.allreduce(
        torch.max(index.list_sizes + counts).reshape(1).cpu(), OpT.MAX)[0])
    cap = index.data.shape[1]
    new_cap = cap if need <= cap else next_pow2(need)
    store, ids_t = index.data, index.indices
    if new_cap > cap:
        store = torch.nn.functional.pad(store, (0, 0, 0, new_cap - cap))
        ids_t = torch.nn.functional.pad(ids_t, (0, new_cap - cap),
                                        value=PAD_ID)
    elif not donate:
        store, ids_t = store.clone(), ids_t.clone()
    store, ids_t, sizes, _ = _flat._append_in_place(
        store, ids_t, index.list_sizes, X_local, ids[lo:lo + m].to(
            mesh.device), labels, conservative=False)
    index.data, index.indices, index.list_sizes = store, ids_t, sizes
    index.deleted = _flat._pad_deleted(index.deleted, new_cap)
    _flat._track_next_id(index, ids, default_base, n_new)
    index.n_rows += n_new
    index.epoch += 1
    return index
