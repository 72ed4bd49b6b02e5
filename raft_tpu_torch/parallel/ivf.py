"""Multi-rank IVF-Flat and IVF-PQ: shard the lists, search locally, merge.

Port of ``raft_tpu/parallel/ivf.py``. One coarse model (the balanced
k-means centers; for IVF-PQ also the rotation and the codebooks) is
replicated, and each rank holds the capacity-padded list tensors of its
own part of the index. Two placements:

* ``placement="row"``: every rank holds the lists of ITS row shard, so
  the union of every rank's list l is the single-device list l. Search
  is collective: each rank probes the shared centers, scans its slice of
  the probed lists with the single-card engine the gate picks, and the
  merge engine combines the ranks' top-k.
* ``placement="list"``: whole lists per rank (:mod:`~raft_tpu_torch.
  parallel.routing`: affinity-aware, size-balanced bin packing), moved
  to their owners at build time. Search is routed: rank 0 probes and
  plans (``plan_route``) and broadcasts the plan, so every rank follows
  one plan; each rank scans only its locally probed slots for its routed
  query group, scatters the group's candidates back to the global query
  rows (merge padding elsewhere), and the merge combines the ranks. The
  merge accounting counts the participating ranks only. Hot lists can be
  replicated onto a second rank and lists migrated between ranks.

The per-rank engines are the single-card ones: IVF-Flat runs the
packed-cells engine (kernel B2 on the card) where it is eligible, else
the scan engine; IVF-PQ runs the compressed tier (kernel B4 on the
card) where it is eligible, else the LUT scan. Building assigns rows
with B1 k=1 on the card. Either placement gives the probed candidate set
of one index built from the same model, so the results are those of the
single-device index, up to the order of exact distance ties.

Every rank packs at one common capacity (a MAX allreduce). ``search``
takes a ``live_mask`` for degraded serving (rank 0's is used): the row
placement neutralizes dead ranks' candidates, the list placement routes
around them; either returns a per-query ``coverage``.

Snapshots: :func:`sharded_ivf_save` / :func:`sharded_ivf_load`, crash-safe
(``util/atomic_io``, a manifest written last), in the reference's file set.
"""

from __future__ import annotations

import dataclasses
import os
import types
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.comms.agree import agreed, root_value
from raft_tpu_torch.comms.comms import Comms, Mesh, OpT
from raft_tpu_torch.comms.topk_merge import (merge_dispatch_stats,
                                             pipeline_chunk_bounds,
                                             resolve_merge_engine,
                                             resolve_pipeline_chunks)
from raft_tpu_torch.core.error import expects, expects_finite
from raft_tpu_torch.core.mdarray import expects_ids_fit, validate_idx_dtype
from raft_tpu_torch.core.resources import as_float, as_tensor
from raft_tpu_torch.core.retry import with_retry
from raft_tpu_torch.core.sentinels import PAD_ID, worst_value
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import gram, row_norms_sq
from raft_tpu_torch.neighbors import ivf_flat as _flat
from raft_tpu_torch.neighbors import ivf_pq as _pq
from raft_tpu_torch.ops.pq_scan import _SC, book_tables, permute_subspaces
from raft_tpu_torch.parallel.degraded import (check_live_mask,
                                              expects_finite_all,
                                              probed_coverage,
                                              scan_merge_dispatch)
from raft_tpu_torch.parallel.kmeans import sharded_kmeans_balanced_fit
from raft_tpu_torch.parallel.knn import RowShard, _check_mesh, shard_database
from raft_tpu_torch.parallel.routing import (ListPlacement, RoutePlan,
                                             assign_lists, build_placement,
                                             empty_plan, plan_route,
                                             route_shapes, routing_stats)
from raft_tpu_torch.util.atomic_io import (DEFAULT_IO, FileIO, atomic_savez,
                                          crc32)
from raft_tpu_torch.util.pow2 import ceildiv, next_pow2


@dataclass
class ShardedIvfFlat:
    """IVF-Flat sharded over the ranks; the coarse centers are replicated.
    Each rank's object holds its own part: under the row placement the
    rows of its shard in every list, under the list placement the whole
    lists it owns (and replicates), in local slots."""

    metric: DistanceType
    centers: torch.Tensor       # (n_lists, dim), the same on every rank
    data: torch.Tensor          # (n_lists | n_slots, cap, dim): this rank's
    indices: torch.Tensor       # (n_lists | n_slots, cap): global ids
    list_sizes: torch.Tensor    # (n_lists | n_slots,) int32: this rank's
    n_dev: int
    n_rows: int = 0             # rows over every shard (primary copies)
    # Bumped by every mutation: the serving layer's cache key.
    epoch: int = 0
    deleted: Optional[torch.Tensor] = None   # like ``indices``, bool
    n_deleted: int = 0          # over every shard (primary copies)
    _next_id: Optional[int] = None
    # placement="list": which rank owns (and replicates) each list; the
    # same on every rank. None = the row placement.
    placement_map: Optional[ListPlacement] = None
    # Bytes the list-placed build moved between ranks, over every rank.
    pack_bytes: int = 0
    # (epoch, every rank's slot sizes (n_dev, n_slots)): the router's
    # coverage prices; refreshed per epoch by one allgather.
    _route_sizes: Optional[tuple] = None

    @property
    def placement(self) -> str:
        return "list" if self.placement_map is not None else "row"

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


@dataclass
class ShardedIvfPq:
    """IVF-PQ sharded over the ranks like :class:`ShardedIvfFlat`, with
    packed codes in place of the rows; the coarse centers, rotation and
    codebooks are replicated."""

    metric: DistanceType
    codebook_kind: "_pq.CodebookGen"
    centers: torch.Tensor
    rotation_matrix: torch.Tensor
    pq_centers: torch.Tensor
    pq_codes: torch.Tensor      # (n_lists | n_slots, cap, nbytes) uint8
    indices: torch.Tensor       # (n_lists | n_slots, cap)
    list_sizes: torch.Tensor    # (n_lists | n_slots,) int32
    n_dev: int
    pq_bits: int = 8
    pq_dim: int = 0
    n_rows: int = 0
    epoch: int = 0
    deleted: Optional[torch.Tensor] = None
    n_deleted: int = 0
    _next_id: Optional[int] = None
    placement_map: Optional[ListPlacement] = None
    pack_bytes: int = 0
    _route_sizes: Optional[tuple] = None
    # This rank's compressed-scan operands ((codesT, invalid, lo, hi,
    # crot_p)), rebuilt after extend / delete / migration.
    _scan_cache: Optional[tuple] = None
    # This rank's slot-gathered center tables of the routed search
    # ((crot_slot, crot_p_slot, books_slot)), rebuilt after a migration.
    _route_ops: Optional[tuple] = None

    @property
    def placement(self) -> str:
        return "list" if self.placement_map is not None else "row"

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation_matrix.shape[0]

    @property
    def size(self) -> int:
        return self.n_rows

    @property
    def live_size(self) -> int:
        return self.size - self.n_deleted


# ---------------------------------------------------------------------------
# Packing.


def _shard_pack(comms: Comms, rows, labels, ids, n_lists: int):
    """Pack this rank's rows into its lists at the capacity common to
    every rank (the next power of two of the fullest list anywhere)."""
    counts = torch.bincount(labels.long(), minlength=n_lists)
    most = comms.allreduce(torch.max(counts).reshape(1).cpu(), OpT.MAX)
    return _flat._pack_lists(rows, labels, ids, n_lists,
                             min_cap=next_pow2(int(most[0])))


def _deal(comms: Comms, dest: torch.Tensor, payloads):
    """Send row i of every payload to rank ``dest[i]`` (collective): the
    rows a rank keeps stay in place, the others go in one all-pairs
    exchange per payload, slabs padded to the largest count any rank
    sends to another. Returns what this rank received, in source rank
    order and each source's row order, and the bytes this rank sent to
    other ranks (padding not counted)."""
    n, r = comms.get_size(), comms.get_rank()
    dest = dest.long()
    per = torch.bincount(dest, minlength=n)
    counts = comms.allgather(per.reshape(1, n).cpu()).numpy()   # [src, dst]
    np.fill_diagonal(counts, 0)
    m = max(int(counts.max()), 1)
    keep = dest == r
    away = torch.nonzero(~keep).reshape(-1)
    order = away[torch.argsort(dest[away], stable=True)]
    sd = dest[order]
    moved = per.clone()
    moved[r] = 0
    start = torch.cumsum(moved, 0) - moved
    slot = sd * m + torch.arange(sd.shape[0], device=dest.device) \
        - start[sd]
    outs, sent = [], 0
    for x in payloads:
        buf = x.new_zeros((n * m,) + tuple(x.shape[1:]))
        buf[slot] = x[order]
        got = comms.device_multicast_sendrecv(buf, axis=0)
        got = got.reshape((n, m) + tuple(x.shape[1:]))
        outs.append(torch.cat([x[keep] if s == r else got[s, :counts[s, r]]
                               for s in range(n)]))
        sent += sd.shape[0] * x.element_size() * int(np.prod(x.shape[1:]))
    return outs, sent


def _list_pack(comms: Comms, rows, labels, ids, n_lists: int, centers):
    """placement="list" packer: the global list sizes (a SUM allreduce),
    rank 0's affinity-aware bin packing of whole lists (``assign_lists``
    over the sizes, the centers as affinity), broadcast; then every row
    goes to its list's owner (:func:`_deal`), which packs its lists into
    local slots at one common capacity. Slot ``n_slots - 1`` is empty on
    every rank (the router's padding target). Returns ``(data, idx,
    sizes, placement, bytes moved over every rank)``."""
    n_dev = comms.get_size()
    counts = comms.allreduce(
        torch.bincount(labels.long(), minlength=n_lists).cpu()).numpy()
    if comms.get_rank() == 0:
        owner = torch.as_tensor(assign_lists(
            counts, n_dev, centers=centers.float().cpu().numpy()))
    else:
        owner = torch.zeros(n_lists, dtype=torch.int32)
    pm = build_placement(comms.bcast(owner).numpy(), n_dev)
    dev = rows.device
    lab = labels.long()
    (rows_r, ids_r, slots_r), sent = _deal(
        comms, torch.as_tensor(pm.owner, device=dev)[lab],
        (rows, ids, torch.as_tensor(pm.slot, device=dev)[lab]))
    data, idx, sizes = _flat._pack_lists(
        rows_r, slots_r, ids_r, pm.n_slots,
        min_cap=next_pow2(max(int(counts.max()), 1)))
    moved = int(comms.allreduce(torch.tensor([sent]))[0])
    return data, idx, sizes, pm, moved


def _check_placement(placement: str) -> None:
    expects(placement in ("row", "list"),
            "placement must be 'row' or 'list', got %r", placement)


def _build_shard(mesh: Mesh, dataset, placement: str) -> RowShard:
    """This rank's rows of the build. The row placement deals equal
    contiguous shards (the row count divides the mesh size); the list
    placement moves every row to its list's owner anyway, so any count
    goes, in contiguous parts of ``ceil(n / size)`` rows."""
    if placement == "row" or isinstance(dataset, RowShard):
        return shard_database(mesh, dataset)
    X = as_float(dataset, device="cpu")
    expects(X.ndim == 2, "dataset must be (n, d), got %s", tuple(X.shape))
    chunk = ceildiv(X.shape[0], mesh.size)
    lo = min(mesh.rank * chunk, X.shape[0])
    return RowShard(X[lo:lo + chunk].to(mesh.device).contiguous(),
                    X.shape[0], lo)


def sharded_ivf_flat_build(mesh: Mesh, params: "_flat.IndexParams",
                           dataset, centers=None,
                           train_distributed: bool = False,
                           placement: str = "row") -> ShardedIvfFlat:
    """Build sharded over the mesh. Collective: every rank passes the same
    arguments (``dataset`` the whole matrix, or this rank's
    :class:`~raft_tpu_torch.parallel.knn.RowShard`; under the row
    placement or ``train_distributed`` its rows divide the mesh size).
    ``centers`` injects a trained coarse model; otherwise rank
    0 trains it as ``ivf_flat.build`` does and broadcasts it, or with
    ``train_distributed`` every rank trains it together with the sharded
    balancing EM (:func:`~raft_tpu_torch.parallel.kmeans.
    sharded_kmeans_balanced_fit`). Ids are the global row numbers.

    ``placement="list"`` assigns whole lists to ranks and moves each row
    to its list's owner; search is then routed (see
    :func:`sharded_ivf_flat_search`)."""
    _check_placement(placement)
    _check_mesh(mesh)
    comms = Comms(mesh)
    idx_dtype = validate_idx_dtype(params.idx_dtype)
    shard = _build_shard(mesh, dataset,
                         "row" if train_distributed else placement)
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
    common = dict(metric=params.metric, centers=centers, n_dev=mesh.size,
                  n_rows=shard.n_total, _next_id=shard.n_total)
    if placement == "list":
        data, idx, sizes, pm, moved = _list_pack(comms, rows, labels, ids,
                                                 params.n_lists, centers)
        return ShardedIvfFlat(data=data, indices=idx, list_sizes=sizes,
                              placement_map=pm, pack_bytes=moved, **common)
    data, idx, sizes = _shard_pack(comms, rows, labels, ids, params.n_lists)
    return ShardedIvfFlat(data=data, indices=idx, list_sizes=sizes,
                          **common)


def _pq_model(comms: Comms, params: "_pq.IndexParams", dataset, model,
              dim: int, dev: torch.device):
    """The replicated IVF-PQ model: ``model`` (a trained ``ivf_pq.Index``,
    the same on every rank) placed on ``dev``, or rank 0's
    ``ivf_pq.build(add_data_on_build=False)`` over the whole ``dataset``,
    its centers, rotation and codebooks broadcast."""
    if model is None:
        expects(not isinstance(dataset, RowShard), "training from one "
                "rank's shard needs a trained model=")
        pq_dim = params.pq_dim or _pq._calculate_pq_dim(dim)
        rot_dim = pq_dim * ceildiv(dim, pq_dim)
        book = 1 << params.pq_bits
        n_books = (pq_dim if params.codebook_kind
                   == _pq.CodebookGen.PER_SUBSPACE else params.n_lists)
        if comms.get_rank() == 0:
            trained = _pq.build(dataclasses.replace(
                params, add_data_on_build=False),
                as_float(dataset, device=dev).to(dev))
            parts = (trained.centers, trained.rotation_matrix,
                     trained.pq_centers)
        else:
            parts = (torch.empty((params.n_lists, dim), device=dev),
                     torch.empty((rot_dim, dim), device=dev),
                     torch.empty((n_books, book, rot_dim // pq_dim),
                                 device=dev))
        centers, rot, books = (comms.bcast(p) for p in parts)
        return dict(metric=params.metric,
                    codebook_kind=params.codebook_kind, centers=centers,
                    rotation_matrix=rot, pq_centers=books,
                    pq_bits=params.pq_bits, pq_dim=pq_dim)
    expects(isinstance(model, _pq.Index), "model must be an ivf_pq.Index")
    expects(model.dim == dim, "model dim %s != dataset dim %s", model.dim,
            dim)
    return dict(metric=model.metric, codebook_kind=model.codebook_kind,
                centers=model.centers.to(dev),
                rotation_matrix=model.rotation_matrix.to(dev),
                pq_centers=model.pq_centers.to(dev), pq_bits=model.pq_bits,
                pq_dim=model.pq_dim)


def sharded_ivf_pq_build(mesh: Mesh, params: "_pq.IndexParams", dataset,
                         model=None, placement: str = "row") -> ShardedIvfPq:
    """Build an IVF-PQ sharded over the mesh (collective; the same
    arguments on every rank, ``dataset`` the whole matrix or this rank's
    :class:`~raft_tpu_torch.parallel.knn.RowShard`). The coarse centers,
    rotation and codebooks come from ``model`` (an ``ivf_pq.Index`` from
    ``ivf_pq.build(add_data_on_build=False)``), or rank 0 trains them
    that way and broadcasts them. Every rank encodes its own rows against
    the shared model (``ivf_pq.encode_rows``: B1 k=1 on the card).
    ``placement="list"`` assigns whole lists to ranks, as in
    :func:`sharded_ivf_flat_build`."""
    _check_placement(placement)
    _check_mesh(mesh)
    comms = Comms(mesh)
    shard = _build_shard(mesh, dataset, placement)
    rows = shard.rows
    expects(shard.n_total >= params.n_lists, "need at least n_lists rows")
    expects(4 <= params.pq_bits <= 8, "pq_bits must be in [4, 8]")
    expects_finite_all(comms, "sharded_ivf_pq_build", rows)
    fields = _pq_model(comms, params, dataset, model, rows.shape[1],
                       mesh.device)
    labels, codes = _pq.encode_rows(types.SimpleNamespace(**fields), rows)
    idx_dtype = (model.indices.dtype if model is not None
                 else validate_idx_dtype(params.idx_dtype))
    ids = torch.arange(shard.offset, shard.offset + rows.shape[0],
                       dtype=idx_dtype, device=mesh.device)
    n_lists = fields["centers"].shape[0]
    common = dict(n_dev=mesh.size, n_rows=shard.n_total,
                  _next_id=shard.n_total, **fields)
    if placement == "list":
        packed, idx, sizes, pm, moved = _list_pack(
            comms, codes, labels, ids, n_lists, fields["centers"])
        return ShardedIvfPq(pq_codes=packed, indices=idx, list_sizes=sizes,
                            placement_map=pm, pack_bytes=moved, **common)
    packed, idx, sizes = _shard_pack(comms, codes, labels, ids, n_lists)
    return ShardedIvfPq(pq_codes=packed, indices=idx, list_sizes=sizes,
                        **common)


# ---------------------------------------------------------------------------
# Search: shared pieces.


def _check_index(mesh: Mesh, index, kind=None) -> Comms:
    _check_mesh(mesh)
    kinds = (ShardedIvfFlat, ShardedIvfPq) if kind is None else (kind,)
    expects(isinstance(index, kinds), "expected a %s, got %s",
            " or ".join(k.__name__ for k in kinds), type(index).__name__)
    expects(index.n_dev == mesh.size,
            "index sharded over %s ranks, mesh has %s", index.n_dev,
            mesh.size)
    return Comms(mesh)


def _queries(mesh: Mesh, index, queries, name: str) -> torch.Tensor:
    Q = as_float(queries, device=mesh.device)
    expects(Q.device == mesh.device, "queries on %s, mesh on %s", Q.device,
            mesh.device)
    expects(Q.ndim == 2 and Q.shape[1] == index.dim, "query dim mismatch")
    expects_finite(name, Q)
    return Q


def _merge_plan(merge_engine: str, n_q: int, k: int, n_dev: int,
                n_probes: int, pipeline_chunks: int):
    """The resolved merge engine and its probe-column chunks."""
    engine = resolve_merge_engine(merge_engine, n_q, k, n_dev,
                                  n_probes=n_probes)
    chunks = tuple(pipeline_chunk_bounds(
        n_probes, resolve_pipeline_chunks(engine, n_probes, n_dev,
                                          requested=pipeline_chunks)))
    return engine, chunks


def _empty_result(Q, k: int, id_dtype, live):
    d = Q.new_zeros((0, k))
    i = torch.zeros((0, k), dtype=id_dtype, device=Q.device)
    if live is None:
        return d, i
    return d, i, Q.new_zeros((0,))


def _flat_scanner(index: ShardedIvfFlat, use_cells: bool, qrows: int,
                  inner_is_l2: bool):
    """``scan(q, probe_ids, kk)``: this rank's single-card IVF-Flat scan
    of the given lists (slots) for queries ``q``: the packed-cells engine
    (B2 on the card) or the scan engine."""
    cap = index.indices.shape[1]
    if use_cells:
        return lambda q, pids, kk: _flat._cells_scan_probes(
            q, pids, index.data, index.indices, index.list_sizes, kk,
            inner_is_l2, qrows, False, index.deleted)
    # As the reference: norms summed in the store's dtype, then promoted;
    # the scores in f32.
    dataf = index.data.float()
    norms = row_norms_sq(index.data).float() if inner_is_l2 else None
    return lambda q, pids, kk: _flat._chunked_over_queries(
        lambda q_, p_: _flat._probe_scan(
            q_, dataf, norms, index.indices, index.list_sizes, kk,
            inner_is_l2, False, p_, index.deleted),
        q, pids, cap * index.dim * 4, kk, index.indices.dtype)


def _sharded_scan_operands(index: ShardedIvfPq) -> tuple:
    """This rank's operands of the compressed scan (B4), cached on the
    index: ``(codesT, invalid, lo, hi, crot_p)``: its codes transposed and
    padded to a multiple of 512 slots, its slot mask (fill line and
    tombstones), and the replicated model's codeword tables and permuted
    rotated centers."""
    if index._scan_cache is None:
        cap = index.pq_codes.shape[1]
        capp = ceildiv(cap, _SC) * _SC
        codesT = torch.nn.functional.pad(
            index.pq_codes.transpose(1, 2), (0, capp - cap)).contiguous()
        invalid = (torch.arange(capp, device=codesT.device)[None, :]
                   >= index.list_sizes[:, None])
        if index.deleted is not None:
            invalid = invalid | torch.nn.functional.pad(index.deleted,
                                                        (0, capp - cap))
        crot_p = permute_subspaces(gram(index.centers, index.rotation_matrix),
                                   index.pq_dim, index.pq_bits)
        lo, hi = book_tables(index.pq_centers, index.pq_bits)
        index._scan_cache = (codesT, invalid, lo, hi, crot_p)
    return index._scan_cache


def _pq_tier(params, index: ShardedIvfPq, k: int, n_q: int, n_probes: int,
             n_lists: int, device) -> tuple:
    """``(use_compressed, lut_dtype, internal_dtype)``: the single-card
    gate (``ivf_pq._compressed_tier_ok``) with this rank's capacity."""
    lut_dtype, internal_dtype = _pq.validate_search_dtypes(params)
    default_dtypes = (lut_dtype == torch.float32
                      and internal_dtype == torch.float32)
    use = _pq._compressed_tier_ok(
        params.engine, _pq._compressed_supported(index), default_dtypes, k,
        index.pq_codes.shape[1], index.pq_codes.shape[2], index.rot_dim,
        n_q, n_probes, n_lists, device)
    return use, lut_dtype, internal_dtype


def _pq_scanner(index: ShardedIvfPq, use_compressed: bool, qrows: int,
                lut_dtype, internal_dtype, crot, crot_p, books):
    """``scan(q, probe_ids, kk)``: this rank's single-card IVF-PQ scan of
    the given lists (slots): the compressed tier (B4 on the card) or the
    LUT scan. ``crot`` / ``crot_p`` / ``books`` are indexed by the probe
    ids (the rotated centers, their permuted form, per-cluster books)."""
    is_ip = index.metric == DistanceType.InnerProduct
    J, bits = index.pq_dim, index.pq_bits
    rot = index.rotation_matrix
    if use_compressed:
        codesT, invalid, lo, hi, _ = _sharded_scan_operands(index)
        return lambda q, pids, kk: _pq._compressed_scan_probes(
            permute_subspaces(gram(q, rot), J, bits), pids, codesT, lo, hi,
            invalid, index.indices, crot_p, kk, is_ip, J, bits, qrows)
    cap = index.pq_codes.shape[1]
    per_q = max(cap * J * 4, J * 256 * 4)
    per_cluster = index.codebook_kind == _pq.CodebookGen.PER_CLUSTER
    return lambda q, pids, kk: _flat._chunked_over_queries(
        lambda rq, p_: _pq._pq_probe_scan(
            rq, p_, index.pq_codes, index.indices, index.list_sizes, kk,
            is_ip, per_cluster, lut_dtype, J, bits, internal_dtype,
            pq_centers=books, centers_rot=crot, deleted=index.deleted),
        gram(q, rot), pids, per_q, kk, index.indices.dtype)


def _finish_pq(index, d):
    if index.metric == DistanceType.L2SqrtExpanded:
        return torch.sqrt(torch.clamp_min(d, 0.0))
    return d


# ---------------------------------------------------------------------------
# The row placement.


def sharded_ivf_flat_search(mesh: Mesh, params: "_flat.SearchParams",
                            index: ShardedIvfFlat, queries, k: int,
                            merge_engine: str = "auto", live_mask=None,
                            pipeline_chunks: int = 0, valid_rows=None,
                            suspect_mask=None, plan_cb=None):
    """Search the sharded index (collective); returns replicated
    ``(distances, global ids)``. The per-rank engine follows the
    single-card gate with the per-shard list capacity: the packed-cells
    engine (B2 on the card) where it is eligible, else the scan engine.
    ``merge_engine``: "allgather" | "ring" | "ring_bf16" | "pipelined" |
    "pipelined_bf16" | "auto"; the pipelined engines scan the probes in
    ``pipeline_chunks`` column ranges (0 = the default split), each
    range's exchange overlapped with the next range's scan.

    ``live_mask`` (bool (n_dev,), rank 0's is used) enables degraded
    serving: a third output ``coverage`` (float32 (q,)) is the per-query
    fraction of probed rows searched; with every shard live the first two
    outputs are those of ``live_mask=None``. The row placement
    neutralizes dead shards' candidates before the merge.

    A ``placement="list"`` index serves the routed path: rank 0 probes
    and plans (``plan_route``) and broadcasts the plan; each rank scans
    its locally probed slots for its routed queries. Liveness is then a
    routing input (dead ranks get no queries, replicas serve their lists,
    ``coverage`` prices the lists with no live copy), ``suspect_mask``
    (rank 0's) steers replicated lists off suspect ranks, ``valid_rows``
    marks the real rows of a zero-padded batch (the others route
    nowhere), and ``plan_cb`` is called with the agreed plan."""
    comms = _check_index(mesh, index, ShardedIvfFlat)
    live = (None if live_mask is None
            else check_live_mask(live_mask, comms))
    return _sharded_ivf_flat_search(mesh, params, index, queries, k,
                                    merge_engine, live, pipeline_chunks,
                                    valid_rows=valid_rows,
                                    suspect=suspect_mask, plan_cb=plan_cb)


def _sharded_ivf_flat_search(mesh: Mesh, params: "_flat.SearchParams",
                             index: ShardedIvfFlat, queries, k: int,
                             merge_engine: str, live, pipeline_chunks: int,
                             plan=None, valid_rows=None, suspect=None,
                             plan_cb=None):
    """:func:`sharded_ivf_flat_search` with ``live`` already agreed across
    the ranks (:func:`check_live_mask`'s output, or None): the sharded
    Searcher agrees it once to decide the degraded path and passes it
    here. ``plan`` injects a routed plan (the warmup vehicle)."""
    comms = _check_index(mesh, index, ShardedIvfFlat)
    Q = _queries(mesh, index, queries, "sharded_ivf_flat_search")
    expects(params.engine in ("auto", "scan", "bucketed"),
            f"unknown engine {params.engine!r} (auto|scan|bucketed)")
    inner_is_l2 = index.metric != DistanceType.InnerProduct
    sqrt = index.metric in (DistanceType.L2SqrtExpanded,
                            DistanceType.L2SqrtUnexpanded)
    n_probes = min(params.n_probes, index.n_lists)
    cap = index.indices.shape[1]
    if index.placement == "list":
        k = min(k, index.n_lists * cap)
        if Q.shape[0] == 0:
            return _empty_result(Q, k, index.indices.dtype, live)
        probe = lambda q: _flat._coarse_probe(q, index.centers, n_probes,
                                              inner_is_l2)
        return _routed_search(
            comms, index, Q, k, merge_engine, live, pipeline_chunks, probe,
            plan, valid_rows, suspect, plan_cb, select_min=inner_is_l2,
            scanner=lambda p: _flat_scanner(
                index, _flat._cells_eligible(
                    params.engine, k, params.bucket_cap, cap, index.dim,
                    p.qg, p.pb, index.indices.shape[0], Q.device),
                min(_flat._CELL_QROWS, max(8, p.qg)), inner_is_l2),
            finish=(lambda d: torch.sqrt(d)) if inner_is_l2 and sqrt
            else None)
    n_dev, n_lists = mesh.size, index.n_lists
    k = min(k, n_dev * n_lists * cap)
    if Q.shape[0] == 0:
        return _empty_result(Q, k, index.indices.dtype, live)
    use_cells = _flat._cells_eligible(params.engine, k, params.bucket_cap,
                                      cap, index.dim, Q.shape[0], n_probes,
                                      n_lists, Q.device)
    alive = None if live is None else bool(live[mesh.rank])
    engine, chunks = _merge_plan(merge_engine, Q.shape[0], k, n_dev,
                                 n_probes, pipeline_chunks)
    merge_dispatch_stats.record(
        engine, Q.shape[0], k, min(k, n_lists * cap), n_dev,
        idx_bytes=index.indices.element_size(),
        chunk_kks=([min(k, (hi - lo) * cap) for lo, hi in chunks]
                   if len(chunks) > 1 else None))
    probe_ids = _flat._coarse_probe(Q, index.centers, n_probes, inner_is_l2)
    scan = _flat_scanner(index, use_cells,
                         min(_flat._CELL_QROWS, max(8, Q.shape[0])),
                         inner_is_l2)
    out_d, out_i = scan_merge_dispatch(
        lambda lo, hi, kk_c: scan(Q, probe_ids[:, lo:hi], kk_c), chunks,
        chunk_width=lambda lo, hi: min(k, (hi - lo) * cap),
        full_kk=min(k, n_lists * cap), engine=engine, k=k, comms=comms,
        select_min=inner_is_l2, alive=alive)
    if inner_is_l2 and sqrt:
        out_d = torch.sqrt(out_d)
    if live is None:
        return out_d, out_i
    return out_d, out_i, probed_coverage(probe_ids, index.list_sizes, alive,
                                         comms)


def sharded_ivf_pq_search(mesh: Mesh, params: "_pq.SearchParams",
                          index: ShardedIvfPq, queries, k: int,
                          merge_engine: str = "auto", live_mask=None,
                          pipeline_chunks: int = 0, valid_rows=None,
                          suspect_mask=None, plan_cb=None):
    """Search the sharded IVF-PQ index (collective); returns replicated
    ``(distances, global ids)``. The per-rank tier follows the single-card
    gate with the per-shard capacity (for a routed dispatch the plan's
    group and probe widths): the compressed tier (B4 on the card) where
    it is eligible, else the LUT scan. ``merge_engine``,
    ``pipeline_chunks``, ``live_mask`` and the routed arguments are those
    of :func:`sharded_ivf_flat_search`."""
    comms = _check_index(mesh, index, ShardedIvfPq)
    live = (None if live_mask is None
            else check_live_mask(live_mask, comms))
    return _sharded_ivf_pq_search(mesh, params, index, queries, k,
                                  merge_engine, live, pipeline_chunks,
                                  valid_rows=valid_rows,
                                  suspect=suspect_mask, plan_cb=plan_cb)


def _sharded_ivf_pq_search(mesh: Mesh, params: "_pq.SearchParams",
                           index: ShardedIvfPq, queries, k: int,
                           merge_engine: str, live, pipeline_chunks: int,
                           plan=None, valid_rows=None, suspect=None,
                           plan_cb=None):
    """:func:`sharded_ivf_pq_search` with ``live`` already agreed (see
    :func:`_sharded_ivf_flat_search`)."""
    comms = _check_index(mesh, index, ShardedIvfPq)
    Q = _queries(mesh, index, queries, "sharded_ivf_pq_search")
    is_ip = index.metric == DistanceType.InnerProduct
    n_probes = min(params.n_probes, index.n_lists)
    cap = index.indices.shape[1]
    if index.placement == "list":
        k = min(k, index.n_lists * cap)
        if Q.shape[0] == 0:
            return _empty_result(Q, k, index.indices.dtype, live)
        crot, crot_p, books = _routed_pq_operands(mesh, index)

        def scanner(p):
            use, lut_dtype, internal = _pq_tier(
                params, index, k, p.qg, p.pb, index.indices.shape[0],
                Q.device)
            return _pq_scanner(index, use, min(_pq._CELL_QROWS,
                                               max(8, p.qg)),
                               lut_dtype, internal, crot, crot_p, books)

        return _routed_search(
            comms, index, Q, k, merge_engine, live, pipeline_chunks,
            lambda q: _pq._select_clusters(q, index.centers, n_probes,
                                           is_ip),
            plan, valid_rows, suspect, plan_cb, select_min=not is_ip,
            scanner=scanner, finish=lambda d: _finish_pq(index, d))
    n_dev, n_lists = mesh.size, index.n_lists
    k = min(k, n_dev * n_lists * cap)
    use, lut_dtype, internal = _pq_tier(params, index, k, Q.shape[0],
                                        n_probes, n_lists, Q.device)
    if Q.shape[0] == 0:
        return _empty_result(Q, k, index.indices.dtype, live)
    alive = None if live is None else bool(live[mesh.rank])
    engine, chunks = _merge_plan(merge_engine, Q.shape[0], k, n_dev,
                                 n_probes, pipeline_chunks)
    merge_dispatch_stats.record(
        engine, Q.shape[0], k, min(k, n_lists * cap), n_dev,
        idx_bytes=index.indices.element_size(),
        chunk_kks=([min(k, (hi - lo) * cap) for lo, hi in chunks]
                   if len(chunks) > 1 else None))
    probe_ids = _pq._select_clusters(Q, index.centers, n_probes, is_ip)
    crot = gram(index.centers, index.rotation_matrix)
    scan = _pq_scanner(index, use, min(_pq._CELL_QROWS, max(8, Q.shape[0])),
                       lut_dtype, internal, crot,
                       _sharded_scan_operands(index)[4] if use else None,
                       index.pq_centers)
    out_d, out_i = scan_merge_dispatch(
        lambda lo, hi, kk_c: scan(Q, probe_ids[:, lo:hi], kk_c), chunks,
        chunk_width=lambda lo, hi: min(k, (hi - lo) * cap),
        full_kk=min(k, n_lists * cap), engine=engine, k=k, comms=comms,
        select_min=not is_ip, alive=alive)
    out_d = _finish_pq(index, out_d)
    if live is None:
        return out_d, out_i
    # As the reference: the compressed tier counts the list rows from its
    # slot mask (tombstones excluded), the LUT tier from the fill line.
    sz = ((~_sharded_scan_operands(index)[1]).sum(1) if use
          else index.list_sizes)
    return out_d, out_i, probed_coverage(probe_ids, sz, alive, comms)


# ---------------------------------------------------------------------------
# The list placement: routed search.


def _routed_sizes_h(comms: Comms, index) -> np.ndarray:
    """Per-list row counts of the primary copies (host int64 (n_lists,)),
    from every rank's slot sizes: one allgather per mutation epoch,
    cached on the index. Collective."""
    pm = index.placement_map
    if index._route_sizes is None or index._route_sizes[0] != index.epoch:
        sizes = comms.allgather(index.list_sizes.reshape(1, -1).cpu())
        index._route_sizes = (index.epoch, sizes.numpy())
    return index._route_sizes[1][pm.owner, pm.slot].astype(np.int64)


def _bcast_plan(comms: Comms, plan: Optional[RoutePlan],
                probe_h: Optional[np.ndarray]):
    """Rank 0's plan and probe ids on every rank: a header, then one int32
    payload (q_rows, probe_slots, probe ids) and one float64 payload
    (fan-out, coverage)."""
    root = comms.get_rank() == 0
    head = torch.zeros(9, dtype=torch.int64)
    if root:
        head = torch.tensor([
            plan.qg, plan.pb, plan.n_queries, plan.participants,
            plan.replica_hits, plan.suspect_avoided,
            -1 if plan.n_valid is None else plan.n_valid,
            int(plan.coverage is not None), probe_h.shape[1]])
    qg, pb, n_q, parts, hits, avoided, n_valid, has_cov, n_pr = (
        int(v) for v in comms.bcast(head))
    n_dev = comms.get_size()
    sizes = (n_dev * qg, n_dev * qg * pb, n_q * n_pr)
    if root:
        ints = torch.as_tensor(np.concatenate([
            plan.q_rows.reshape(-1), plan.probe_slots.reshape(-1),
            probe_h.reshape(-1)]).astype(np.int32))
        flts = torch.as_tensor(np.concatenate([
            [plan.fanout_mean],
            plan.coverage if has_cov else []]).astype(np.float64))
    else:
        ints = torch.zeros(sum(sizes), dtype=torch.int32)
        flts = torch.zeros(1 + (n_q if has_cov else 0), dtype=torch.float64)
    ints = comms.bcast(ints).numpy()
    flts = comms.bcast(flts).numpy()
    if root:
        return plan, probe_h
    a, b = sizes[0], sizes[0] + sizes[1]
    plan = RoutePlan(
        q_rows=ints[:a].reshape(n_dev, qg),
        probe_slots=ints[a:b].reshape(n_dev, qg, pb), qg=qg, pb=pb,
        n_queries=n_q, participants=parts, fanout_mean=float(flts[0]),
        replica_hits=hits,
        coverage=flts[1:].astype(np.float32) if has_cov else None,
        n_valid=None if n_valid < 0 else n_valid, suspect_avoided=avoided)
    return plan, ints[b:].reshape(n_q, n_pr)


def _routed_plan(comms: Comms, index, Q, probe_fn, live, valid_rows,
                 suspect) -> RoutePlan:
    """Route one batch. Rank 0 probes, plans and broadcasts the plan, so
    every rank follows the same one (a rank with another plan would wait
    in another collective); every rank then records the same routing
    telemetry. ``live`` is already agreed; ``suspect`` is read on rank 0
    only. Collective."""
    pm = index.placement_map
    sizes = _routed_sizes_h(comms, index) if live is not None else None
    plan = probe_h = None
    if comms.get_rank() == 0:
        probe_h = probe_fn(Q).cpu().numpy().astype(np.int32)
        plan = plan_route(
            probe_h, pm, live_mask=live, list_sizes=sizes,
            n_valid=valid_rows,
            suspect_mask=(None if suspect is None
                          else np.asarray(suspect).astype(bool)))
    plan, probe_h = _bcast_plan(comms, plan, probe_h)
    routing_stats.record(
        plan, pm,
        probe_ids=probe_h if valid_rows is None else probe_h[:valid_rows])
    return plan


def routed_primary_mask(mesh: Mesh, index) -> Optional[torch.Tensor]:
    """This rank's per-slot "holds a primary copy" mask ((n_slots,) bool
    on the index's device), or None for the row placement and an
    unreplicated list placement: ``lifecycle.delete`` counts newly
    tombstoned slots against it, so a row deleted from a replicated list
    counts once (both copies are masked: they must stay identical)."""
    pm = index.placement_map
    if pm is None or not (pm.replica_owner >= 0).any():
        return None
    s2l = pm.slot_to_list[mesh.rank]
    primary = (s2l >= 0) & (pm.owner[np.maximum(s2l, 0)] == mesh.rank)
    return torch.as_tensor(primary, device=index.indices.device)


def _scatter_back(d_g, i_g, rows_l, n_q: int, select_min: bool):
    """One rank's routed-group candidates at their global query rows:
    queries not routed here keep the merge padding (worst, -1), and the
    group's padding rows (row == n_q) are masked out."""
    full_d = torch.full((n_q, d_g.shape[1]), worst_value(select_min),
                        dtype=d_g.dtype, device=d_g.device)
    full_i = torch.full((n_q, i_g.shape[1]), PAD_ID, dtype=i_g.dtype,
                        device=i_g.device)
    keep = rows_l < n_q
    full_d[rows_l[keep]] = d_g[keep]
    full_i[rows_l[keep]] = i_g[keep]
    return full_d, full_i


def _pad_candidates(out_d, out_i, k: int, select_min: bool):
    """A merged candidate set narrower than ``k`` (the routed width is
    min(k, pb cap n_dev)) padded back to k with the merge sentinels, as
    the row placement returns beyond the probed candidates."""
    if out_d.shape[1] >= k:
        return out_d, out_i
    pad = k - out_d.shape[1]
    return (torch.nn.functional.pad(out_d, (0, pad),
                                    value=worst_value(select_min)),
            torch.nn.functional.pad(out_i, (0, pad), value=PAD_ID))


def _routed_search(comms: Comms, index, Q, k: int, merge_engine: str, live,
                   pipeline_chunks: int, probe_fn, plan, valid_rows,
                   suspect, plan_cb, select_min: bool, scanner, finish):
    """Route -> dispatch -> sparse merge, shared by both index kinds.
    ``scanner(plan)`` gives this rank's ``scan(q, slots, kk)`` for the
    plan's shapes; ``finish`` maps the merged distances (sqrt). An
    injected ``plan`` (warmup) records no telemetry and skips
    ``plan_cb``."""
    n_dev, rank = comms.get_size(), comms.get_rank()
    cap = index.indices.shape[1]
    n_q = Q.shape[0]
    warm = plan is not None
    if not warm:
        plan = _routed_plan(comms, index, Q, probe_fn, live, valid_rows,
                            suspect)
        if plan_cb is not None:
            plan_cb(plan)
    engine, chunks = _merge_plan(merge_engine, n_q, k, n_dev, plan.pb,
                                 pipeline_chunks)
    if not warm:
        merge_dispatch_stats.record(
            engine, n_q, k, min(k, plan.pb * cap), n_dev,
            idx_bytes=index.indices.element_size(),
            chunk_kks=([min(k, (hi - lo) * cap) for lo, hi in chunks]
                       if len(chunks) > 1 else None),
            participants=plan.participants)
    rows_l = torch.as_tensor(plan.q_rows[rank], device=Q.device).long()
    slots_l = torch.as_tensor(plan.probe_slots[rank], device=Q.device)
    # The group's padding rows gather a real query, score only the empty
    # slot and are dropped by the scatter.
    q_l = Q[torch.clamp_max(rows_l, n_q - 1)]
    scan = scanner(plan)

    def scan_range(lo, hi, kk_c):
        d_g, i_g = scan(q_l, slots_l[:, lo:hi], kk_c)
        return _scatter_back(d_g, i_g, rows_l, n_q, select_min)

    out_d, out_i = scan_merge_dispatch(
        scan_range, chunks,
        chunk_width=lambda lo, hi: min(k, (hi - lo) * cap),
        full_kk=min(k, plan.pb * cap), engine=engine, k=k, comms=comms,
        select_min=select_min, alive=None)
    out_d, out_i = _pad_candidates(out_d, out_i, k, select_min)
    if finish is not None:
        out_d = finish(out_d)
    if live is None:
        return out_d, out_i
    cov = (plan.coverage if plan.coverage is not None
           else np.ones(n_q, np.float32))
    return out_d, out_i, torch.as_tensor(cov, device=Q.device)


def _routed_pq_operands(mesh: Mesh, index: ShardedIvfPq) -> tuple:
    """This rank's slot-gathered center tables of the routed IVF-PQ
    search, cached on the index: the probe operands are LOCAL slots, so
    the rotated centers (LUT residuals), their permuted form (the
    compressed scan's residual shift) and per-cluster books are gathered
    through ``slot_to_list``. Empty slots borrow list 0, so their rows
    are finite; their size is 0, so only sentinels survive."""
    if index._route_ops is None:
        s2l = torch.as_tensor(np.maximum(
            index.placement_map.slot_to_list[mesh.rank], 0),
            device=mesh.device).long()
        crot = gram(index.centers, index.rotation_matrix)
        crot_p = permute_subspaces(crot, index.pq_dim, index.pq_bits)
        books = (index.pq_centers[s2l] if index.codebook_kind
                 == _pq.CodebookGen.PER_CLUSTER else index.pq_centers)
        index._route_ops = (crot[s2l], crot_p[s2l], books)
    return index._route_ops


def sharded_routed_warmup(mesh: Mesh, params, index, n_queries: int, k: int,
                          merge_engine: str = "auto") -> int:
    """Run the routed search once at every (qg, pb) shape of the closed
    set ``route_shapes(n_queries, n_probes)`` (an all-padding plan each:
    the per-rank scans run at those shapes and score only sentinels), so
    the kernels are built and the shapes touched ahead of traffic.
    Records no telemetry. Collective. Returns the number of shapes, the
    reference's count."""
    expects(getattr(index, "placement_map", None) is not None,
            "routed warmup needs a placement='list' index")
    pm = index.placement_map
    n_probes = min(params.n_probes, index.n_lists)
    dummy = torch.zeros((n_queries, index.dim), device=mesh.device)
    search = (_sharded_ivf_flat_search if isinstance(index, ShardedIvfFlat)
              else _sharded_ivf_pq_search)
    shapes = route_shapes(n_queries, n_probes)
    for qg, pb in shapes:
        search(mesh, params, index, dummy, k, merge_engine, None, 0,
               plan=empty_plan(pm, n_queries, qg, pb))
    return len(shapes)


# ---------------------------------------------------------------------------
# Extend.


def _resolve_new_ids(index, n_new: int, new_indices, name: str):
    """``(ids on the host, default base or None)``: ``max id + 1``
    onwards by default, else the caller's ids (checked to fit)."""
    id_dtype = index.indices.dtype
    if new_indices is None:
        base = _flat._auto_id_base(index)
        return torch.arange(base, base + n_new, dtype=id_dtype), base
    ids = as_tensor(new_indices, device="cpu").reshape(-1)
    expects(ids.numel() == n_new, "one id per new row")
    expects_ids_fit(name, ids, id_dtype)
    return ids.to(id_dtype), None


def _routed_deal(pm: ListPlacement, rank: int, labels_h: np.ndarray):
    """The new rows this rank appends under the list placement, and their
    local slots: the rows of the lists it owns, then those of the lists
    it replicates (both copies take every row)."""
    pri = np.flatnonzero(pm.owner[labels_h] == rank)
    rep = np.flatnonzero(pm.replica_owner[labels_h] == rank)
    return (np.concatenate([pri, rep]),
            np.concatenate([pm.slot[labels_h[pri]],
                            pm.replica_slot[labels_h[rep]]]))


def _gather_rows(comms: Comms, part: torch.Tensor, n_total: int,
                 chunk: int) -> torch.Tensor:
    """Every rank's ``chunk``-row part (the last ones shorter), stacked
    into the ``n_total`` rows, on every rank."""
    pad = chunk - part.shape[0]
    if pad:
        part = torch.cat([part, part.new_zeros((pad,) + part.shape[1:])])
    return comms.allgather(part)[:n_total]


def _append_rows(comms: Comms, index, store_name: str, payload, ids,
                 slots, donate: bool) -> None:
    """Append this rank's rows at their lists' (slots') fill offsets,
    after growing every rank's capacity to one common power of two if a
    list overflows (a MAX allreduce). ``donate=False`` writes into
    copies."""
    store = getattr(index, store_name)
    counts = torch.bincount(slots.long(), minlength=store.shape[0])
    need = int(comms.allreduce(
        torch.max(index.list_sizes + counts).reshape(1).cpu(), OpT.MAX)[0])
    cap = store.shape[1]
    new_cap = cap if need <= cap else next_pow2(need)
    ids_t = index.indices
    if new_cap > cap:
        pad = (0, 0) * (store.ndim - 2) + (0, new_cap - cap)
        store = torch.nn.functional.pad(store, pad)
        ids_t = torch.nn.functional.pad(ids_t, (0, new_cap - cap),
                                        value=PAD_ID)
    elif not donate:
        store, ids_t = store.clone(), ids_t.clone()
    store, ids_t, sizes, _ = _flat._append_in_place(
        store, ids_t, index.list_sizes, payload, ids, slots,
        conservative=False)
    setattr(index, store_name, store)
    index.indices, index.list_sizes = ids_t, sizes
    index.deleted = _flat._pad_deleted(index.deleted, new_cap)


def _sharded_extend(mesh: Mesh, index, new_vectors, new_indices,
                    donate: bool, encode, name: str):
    """Shared grow + append of both kinds. ``encode(rows)`` gives
    ``(labels, payload)``. Row placement: the new rows are dealt
    contiguously over the ranks (their count divides the mesh size), each
    rank encodes and appends its part. List placement: each rank encodes
    a contiguous part, the labels (and codes) are gathered, and each rank
    appends the rows of the lists it owns or replicates."""
    comms = Comms(mesh)
    X = as_float(new_vectors, device="cpu")
    expects(X.ndim == 2 and X.shape[1] == index.dim, "dim mismatch")
    n_new = X.shape[0]
    routed = index.placement == "list"
    if routed:
        chunk = max(ceildiv(n_new, mesh.size), 1)
    else:
        expects(n_new % mesh.size == 0,
                "rows must divide the mesh axis (pad first)")
        chunk = n_new // mesh.size
    lo = min(mesh.rank * chunk, n_new)
    X_local = X[lo:lo + chunk].to(mesh.device)
    expects_finite_all(comms, name, X_local)
    ids, default_base = _resolve_new_ids(index, n_new, new_indices, name)
    if n_new == 0:
        index.epoch += 1
        return index
    store_name = "data" if isinstance(index, ShardedIvfFlat) else "pq_codes"
    if X_local.shape[0]:
        labels, payload = encode(X_local)
    else:                            # this rank's part of a short batch
        store = getattr(index, store_name)
        labels = torch.zeros(0, dtype=torch.int32, device=mesh.device)
        payload = (None if store_name == "data"
                   else store.new_zeros((0,) + tuple(store.shape[2:])))
    if routed:
        labels = _gather_rows(comms, labels.int(), n_new, chunk)
        rows, slots = _routed_deal(index.placement_map, mesh.rank,
                                   labels.cpu().numpy().astype(np.int64))
        rows_t = torch.as_tensor(rows)
        if payload is None:          # IVF-Flat: the rows themselves
            payload = X[rows_t].to(mesh.device)
        else:
            payload = _gather_rows(comms, payload, n_new,
                                   chunk)[rows_t.to(mesh.device)]
        ids_l = ids[rows_t].to(mesh.device)
        slots = torch.as_tensor(slots, device=mesh.device)
    else:
        if payload is None:
            payload = X_local
        ids_l = ids[lo:lo + chunk].to(mesh.device)
        slots = labels
    _append_rows(comms, index, store_name, payload, ids_l, slots, donate)
    _flat._track_next_id(index, ids, default_base, n_new)
    if isinstance(index, ShardedIvfPq):
        index._scan_cache = None
    index.n_rows += n_new
    index.epoch += 1
    return index


def sharded_ivf_flat_extend(mesh: Mesh, index: ShardedIvfFlat, new_vectors,
                            new_indices=None, *,
                            donate: bool = True) -> ShardedIvfFlat:
    """Append rows to the sharded index (collective; the same arguments on
    every rank). Row placement: the new rows are dealt contiguously over
    the ranks (their count divides the mesh size); list placement: each
    row goes to its list's owner and to its replica. Each rank appends at
    its lists' fill offsets, after growing every rank's capacity to one
    common power of two if a list overflows. Ids default to ``max id +
    1`` onwards. ``donate=False`` writes into copies (copy-on-write), for
    a mutation racing readers of the old tensors. The coarse model is
    unchanged."""
    _check_index(mesh, index, ShardedIvfFlat)
    kb = KMeansBalancedParams(metric=index.metric)
    return _sharded_extend(
        mesh, index, new_vectors, new_indices, donate,
        lambda X: (kmeans_balanced._predict(kb, index.centers, X), None),
        "sharded_ivf_flat_extend")


def sharded_ivf_pq_extend(mesh: Mesh, index: ShardedIvfPq, new_vectors,
                          new_indices=None, *,
                          donate: bool = True) -> ShardedIvfPq:
    """Encode (``ivf_pq.encode_rows`` against the replicated model) and
    append rows to the sharded IVF-PQ index, as
    :func:`sharded_ivf_flat_extend` appends."""
    _check_index(mesh, index, ShardedIvfPq)
    return _sharded_extend(mesh, index, new_vectors, new_indices, donate,
                           lambda X: _pq.encode_rows(index, X),
                           "sharded_ivf_pq_extend")


# ---------------------------------------------------------------------------
# List migration and replication (list placement only): copy-on-write
# successors at epoch + 1 that move or copy WHOLE lists between ranks.
# The lists' contents are unchanged, so results are too.


def _rebuild_list_tensors(comms: Comms, index, pm: ListPlacement):
    """The successor of ``index`` under the placement ``pm``: each list's
    live rows (up to its fill line, with their tombstones) travel from
    its old primary copy to its new owner and replica (one all-pairs
    exchange of the real rows, :func:`_deal`), into slots at the old
    capacity."""
    old = index.placement_map
    rank = comms.get_rank()
    is_pq = isinstance(index, ShardedIvfPq)
    store = index.pq_codes if is_pq else index.data
    dev = store.device
    sizes = _routed_sizes_h(comms, index)            # (n_lists,)
    cap = index.indices.shape[1]
    # Per destination copy of every list: (list, destination, its slot).
    dst = [(g, int(o), int(s)) for g in range(pm.n_lists)
           for o, s in ((pm.owner[g], pm.slot[g]),
                        (pm.replica_owner[g], pm.replica_slot[g]))
           if o >= 0]
    mine = [(g, o, s) for g, o, s in dst if old.owner[g] == rank]
    src_slot = torch.as_tensor([old.slot[g] for g, _, _ in mine],
                               dtype=torch.long, device=dev)
    lens = torch.as_tensor([int(sizes[g]) for g, _, _ in mine],
                           dtype=torch.long, device=dev)
    col = torch.arange(cap, device=dev)
    take = col[None, :] < lens[:, None]          # (copies, cap)
    blk = src_slot[:, None].expand(-1, cap)[take]
    pos = col[None, :].expand(len(mine), -1)[take]
    dest = torch.as_tensor([o for _, o, _ in mine], dtype=torch.long,
                           device=dev)[:, None].expand(-1, cap)[take]
    tomb = (index.deleted[blk, pos] if index.deleted is not None
            else torch.zeros(blk.shape[0], dtype=torch.bool, device=dev))
    (rows_r, ids_r, del_r), _ = _deal(
        comms, dest, (store[blk, pos], index.indices[blk, pos], tomb))
    # What arrives: from each source rank in order, its lists in id order
    # (each list's rows in slot order).
    arrive = sorted((int(old.owner[g]), g, s) for g, o, s in dst
                    if o == rank)
    sz = np.asarray([int(sizes[g]) for _, g, _ in arrive], np.int64)
    slot_r = torch.as_tensor(np.repeat(
        np.asarray([s for _, _, s in arrive], np.int64), sz), device=dev)
    at = torch.as_tensor(np.arange(int(sz.sum()))
                         - np.repeat(np.cumsum(sz) - sz, sz), device=dev)
    new_store = store.new_zeros((pm.n_slots, cap) + tuple(store.shape[2:]))
    new_idx = torch.full((pm.n_slots, cap), PAD_ID,
                         dtype=index.indices.dtype, device=dev)
    new_store[slot_r, at] = rows_r
    new_idx[slot_r, at] = ids_r
    new_sz = torch.bincount(slot_r, minlength=pm.n_slots).to(torch.int32)
    fields = dict(indices=new_idx, list_sizes=new_sz, placement_map=pm,
                  epoch=index.epoch + 1, _route_sizes=None)
    if index.deleted is not None:
        new_del = torch.zeros((pm.n_slots, cap), dtype=torch.bool,
                              device=dev)
        new_del[slot_r, at] = del_r
        fields.update(deleted=new_del)
    if is_pq:
        fields.update(pq_codes=new_store, _scan_cache=None, _route_ops=None)
    else:
        fields.update(data=new_store)
    return dataclasses.replace(index, **fields)


def _with_replicas(pm: ListPlacement, list_ids, sizes, live) -> ListPlacement:
    """A new placement with ``list_ids`` replicated onto a second rank
    each: per list the least row-loaded LIVE rank that is not its owner
    (ties to the lowest rank); a free local slot when there is one, else
    the slot count grows one power-of-two step. Lists already replicated
    keep their copy."""
    rep_o = pm.replica_owner.copy()
    rep_s = pm.replica_slot.copy()
    loads = np.zeros(pm.n_dev, np.int64)
    np.add.at(loads, pm.owner, sizes)
    used = {(s, j) for s in range(pm.n_dev)
            for j in np.flatnonzero(pm.slot_to_list[s] >= 0)}
    n_slots = pm.n_slots
    for g in np.asarray(list_ids, np.int64).reshape(-1):
        if rep_o[g] >= 0:
            continue
        candidates = [s for s in range(pm.n_dev)
                      if s != pm.owner[g] and live[s]]
        expects(bool(candidates),
                "no live non-owner shard to replicate list %s onto", g)
        tgt = min(candidates, key=lambda s: (loads[s], s))
        free = [j for j in range(n_slots - 1) if (tgt, j) not in used]
        if not free:
            n_slots = next_pow2(n_slots + 1)
            free = [j for j in range(n_slots - 1) if (tgt, j) not in used]
        rep_o[g], rep_s[g] = tgt, free[0]
        used.add((tgt, free[0]))
        loads[tgt] += sizes[g]
    return build_placement(pm.owner, pm.n_dev, min_slots=n_slots,
                           replica_owner=rep_o, replica_slot=rep_s)


def _agreed_ints(comms: Comms, values) -> np.ndarray:
    """Rank 0's integer array on every rank."""
    v = torch.as_tensor(np.asarray(values, np.int64).reshape(-1))
    n = int(comms.bcast(torch.tensor([v.numel()]))[0])
    buf = v if comms.get_rank() == 0 else torch.zeros(n, dtype=torch.int64)
    return comms.bcast(buf).numpy()


def _agreed_live(comms: Comms, live_mask, n_dev: int) -> np.ndarray:
    if live_mask is None:
        return np.ones(n_dev, bool)
    return check_live_mask(live_mask, comms)


def sharded_migrate_lists(mesh: Mesh, index, new_owner,
                          live_mask=None) -> tuple:
    """Move whole lists to a new owner assignment (e.g. ``assign_lists``
    over the observed probe loads, ``routing_stats.list_loads``).
    Collective; rank 0's ``new_owner`` and ``live_mask`` are used. Keeps
    the predecessor's slot count when the assignment fits. Replicated
    lists stay replicated: their second copy is placed again against the
    new owners, on a live non-owner rank. Returns ``(successor,
    n_migrated)``; the input index is not written."""
    comms = _check_index(mesh, index)
    pm = index.placement_map
    expects(pm is not None, "list migration needs placement='list'")
    new_owner = _agreed_ints(comms, new_owner).astype(np.int32)
    expects(new_owner.shape[0] == pm.n_lists,
            "owner assignment must cover all %s lists", pm.n_lists)
    live = _agreed_live(comms, live_mask, pm.n_dev)
    n_migrated = int((new_owner != pm.owner).sum())
    new_pm = build_placement(new_owner, pm.n_dev, min_slots=pm.n_slots)
    replicated = np.flatnonzero(pm.replica_owner >= 0)
    if replicated.size:
        new_pm = _with_replicas(new_pm, replicated,
                                _routed_sizes_h(comms, index), live)
    return _rebuild_list_tensors(comms, index, new_pm), n_migrated


def sharded_replicate_lists(mesh: Mesh, index, list_ids, live_mask=None):
    """Replicate hot lists onto a second rank (:func:`_with_replicas`):
    the router splits a replicated list's probe load over its live
    copies, and a dead owner keeps serving through the replica.
    Collective; rank 0's ``list_ids`` and ``live_mask`` are used. Returns
    the copy-on-write successor."""
    comms = _check_index(mesh, index)
    pm = index.placement_map
    expects(pm is not None, "list replication needs placement='list'")
    list_ids = _agreed_ints(comms, list_ids)
    live = _agreed_live(comms, live_mask, pm.n_dev)
    new_pm = _with_replicas(pm, list_ids, _routed_sizes_h(comms, index),
                            live)
    return _rebuild_list_tensors(comms, index, new_pm)


# ---------------------------------------------------------------------------
# Persistence: crash-safe snapshots of a sharded index. The file set is
# the reference's, key for key: ``<base>.model.npz`` (the replicated
# model), ``<base>.shard{r}.npz`` (rank r's list tensors) and
# ``<base>.manifest.npz`` (file names, sizes, CRC32s and the epoch),
# written last. Every file goes through ``util/atomic_io`` (tmp + fsync +
# rename). The ranks share one file system; every decision made from one
# rank's files or errors is agreed before the next collective.


SHARDED_SERIALIZATION_VERSION = 1


def _manifest_path(basename: str) -> str:
    return f"{basename}.manifest.npz"


def _io(fn, retry):
    """``fn()``, retried on transient errors under ``retry`` when set."""
    return with_retry(fn, retry) if retry is not None else fn()


def _model_arrays(mesh: Mesh, index) -> dict:
    """The model file's arrays, the reference's keys and dtypes."""
    is_pq = isinstance(index, ShardedIvfPq)
    model = dict(
        version=np.int64(SHARDED_SERIALIZATION_VERSION),
        kind=np.str_("pq" if is_pq else "flat"),
        metric=np.int64(index.metric.value),
        axis=np.str_(mesh.axis),
        n_shards=np.int64(index.n_dev),
        centers=index.centers.cpu().numpy())
    if is_pq:
        model.update(
            codebook_kind=np.int64(index.codebook_kind.value),
            rotation_matrix=index.rotation_matrix.cpu().numpy(),
            pq_centers=index.pq_centers.cpu().numpy(),
            pq_bits=np.int64(index.pq_bits),
            pq_dim=np.int64(index.pq_dim))
    pm = index.placement_map
    if pm is not None:
        # Optional keys: a row-placed file set stays byte-compatible with
        # version 1.
        model.update(
            placement_owner=pm.owner, placement_slot=pm.slot,
            placement_replica_owner=pm.replica_owner,
            placement_replica_slot=pm.replica_slot,
            placement_n_slots=np.int64(pm.n_slots))
    return model


def sharded_ivf_save(mesh: Mesh, basename: str, index, *, retry=None,
                     file_io: FileIO = DEFAULT_IO) -> None:
    """Save a :class:`ShardedIvfFlat` or :class:`ShardedIvfPq` (either
    placement) crash-safely, collective: rank r writes
    ``<base>.shard{r}.npz`` (its list tensors, with its tombstone mask
    when the index holds any), rank 0 writes ``<base>.model.npz``; one
    allgather of every file's CRC32 and size, and rank 0 writes
    ``<base>.manifest.npz`` last, the snapshot's commit point, with every
    file's CRC (the reference's single-process layout). A kill at any
    byte leaves the previous snapshot or a file set that fails
    :func:`verify_sharded_manifest`. A failed write on any rank (after
    ``retry``, a ``RetryPolicy`` for each file write) raises the same
    error on every rank, and no manifest is written. ``file_io`` is the
    fault seam. The reference takes no mesh: its controller sees every
    shard."""
    comms = _check_index(mesh, index)
    rank = mesh.rank

    def write(path, payload):
        return _io(lambda: atomic_savez(path, file_io, **payload), retry)

    is_pq = isinstance(index, ShardedIvfPq)
    store = index.pq_codes if is_pq else index.data
    shard = dict(store=store.cpu().numpy(),
                 indices=index.indices.cpu().numpy(),
                 list_sizes=index.list_sizes.cpu().numpy())
    if index.n_deleted:
        # Tombstones are index content; a mask-free file set stays
        # byte-compatible with version 1.
        shard["deleted"] = index.deleted.cpu().numpy()
    meta = np.full(4, -1, np.int64)        # model crc, size; shard crc, size
    with agreed(comms):
        if rank == 0:
            m = write(f"{basename}.model.npz", _model_arrays(mesh, index))
            meta[:2] = m["crc"], m["size"]
        s = write(f"{basename}.shard{rank}.npz", shard)
        meta[2:] = s["crc"], s["size"]
    table = comms.allgather(torch.as_tensor(meta).reshape(1, 4)).numpy()
    with agreed(comms):
        if rank == 0:
            names = [os.path.basename(f"{basename}.model.npz")] + [
                os.path.basename(f"{basename}.shard{s}.npz")
                for s in range(index.n_dev)]
            write(_manifest_path(basename), dict(
                version=np.int64(SHARDED_SERIALIZATION_VERSION),
                n_shards=np.int64(index.n_dev),
                epoch=np.int64(index.epoch),
                files=np.array(names),
                crc=np.concatenate([table[:1, 0], table[:, 2]]),
                size=np.concatenate([table[:1, 1], table[:, 3]])))


def verify_sharded_manifest(basename: str) -> Optional[int]:
    """Check a snapshot's manifest against the files on disk (not
    collective): returns the saved epoch, or None when there is no
    manifest (a save from before manifests: loadable, with a file
    existence check only). Raises ``LogicError`` on any mismatch (a
    missing file, size drift, CRC drift), before anything is loaded."""
    mpath = _manifest_path(basename)
    if not os.path.exists(mpath):
        return None
    with np.load(mpath) as m:
        version = int(m["version"])
        expects(version == SHARDED_SERIALIZATION_VERSION,
                f"sharded manifest version mismatch: {version}")
        names = [str(n) for n in m["files"]]
        crcs = m["crc"].astype(np.int64)
        lens = m["size"].astype(np.int64)
        epoch = int(m["epoch"])
    base_dir = os.path.dirname(basename)
    for name, crc, size in zip(names, crcs, lens):
        path = os.path.join(base_dir, name)
        expects(os.path.exists(path),
                "torn snapshot %r: manifest lists %r but the file is "
                "missing (kill mid-save?)", basename, name)
        if crc < 0:
            continue                   # written by another process
        with open(path, "rb") as f:
            data = f.read()
        expects(len(data) == int(size),
                "torn snapshot %r: %r is %s bytes, manifest says %s",
                basename, name, len(data), int(size))
        expects(crc32(data) == int(crc),
                "torn snapshot %r: %r fails its manifest CRC — file "
                "content does not match what the save committed",
                basename, name)
    return epoch


def _load_model(mesh: Mesh, basename: str, load_npz) -> dict:
    """Rank 0's part of a load: the whole file set verified, the model
    read and checked against the mesh, every shard file present."""
    verify_sharded_manifest(basename)
    with load_npz(f"{basename}.model.npz") as m:
        version = int(m["version"])
        expects(version == SHARDED_SERIALIZATION_VERSION,
                f"sharded serialization version mismatch: {version}")
        n_shards = int(m["n_shards"])
        expects(mesh.size == n_shards,
                f"index has {n_shards} shards but the mesh has "
                f"{mesh.size} ranks")
        model = {k: m[k] for k in m.files}
    for s in range(n_shards):
        expects(os.path.exists(f"{basename}.shard{s}.npz"),
                "sharded snapshot %r is missing shard file %d/%d "
                "(torn save?)", basename, s, n_shards)
    return model


def _check_shard(rank: int, arrays: dict, ref: dict) -> None:
    """This rank's shard arrays against shard 0's keys, dtypes and
    shapes: a cast would silently narrow (int64 ids from a mixed re-save
    onto int32)."""
    expects(set(arrays) == set(ref), "shard %s holds %s, shard0 %s", rank,
            sorted(arrays), sorted(ref))
    for key, (dtype, shape) in ref.items():
        a = arrays[key]
        expects(str(a.dtype) == dtype,
                f"shard {rank} {key} dtype {a.dtype} != shard0's {dtype}")
        expects(tuple(a.shape) == shape,
                f"shard {rank} {key} shape {a.shape} != shard0's {shape}")
    validate_idx_dtype(arrays["indices"].dtype)


def sharded_ivf_load(mesh: Mesh, basename: str, *, retry=None):
    """Load a snapshot written by :func:`sharded_ivf_save` onto ``mesh``
    (collective; the shard count must equal the mesh size). Rank 0
    verifies the manifest (every file's existence, size and CRC32), the
    version and the shard count, and reads the model; its verdict is
    agreed, so every rank raises the same ``LogicError`` or goes on to
    read only its own shard file. Every shard's dtypes and shapes must be
    shard 0's (agreed the same way). A list placement is re-dealt from
    the saved owners and checked against the saved slots; the tombstone
    count and the row count come from the primary copies. ``retry``
    retries each file read on transient errors."""
    _check_mesh(mesh)
    comms = Comms(mesh)
    rank, dev = mesh.rank, mesh.device

    def load_npz(path):
        return _io(lambda: np.load(path), retry)

    model = arrays = None
    with agreed(comms):
        if rank == 0:
            model = _load_model(mesh, basename, load_npz)
    model = root_value(comms, model)
    with agreed(comms):
        with load_npz(f"{basename}.shard{rank}.npz") as z:
            arrays = {k: z[k] for k in z.files}
    ref = root_value(comms, {k: (str(a.dtype), tuple(a.shape))
                             for k, a in arrays.items()}
                     if rank == 0 else None)
    with agreed(comms):
        _check_shard(rank, arrays, ref)
    n_shards = int(model["n_shards"])
    pm = None
    if "placement_owner" in model:
        pm = build_placement(
            model["placement_owner"], n_shards,
            min_slots=int(model["placement_n_slots"]),
            replica_owner=model["placement_replica_owner"],
            replica_slot=model["placement_replica_slot"])
        # Every placement producer deals slots in ascending list id per
        # owner; a drifted deal would route probes into the wrong slot.
        expects(bool(np.array_equal(pm.slot, model["placement_slot"])),
                "saved placement slots do not match the deterministic "
                "re-deal — file corrupt or writer/reader version skew")
    t = {k: torch.as_tensor(a).to(dev) for k, a in arrays.items()}
    primary = torch.ones(t["list_sizes"].shape[0], dtype=torch.bool,
                         device=dev)
    if pm is not None:
        s2l = pm.slot_to_list[rank]
        primary = torch.as_tensor(
            (s2l >= 0) & (pm.owner[np.maximum(s2l, 0)] == rank), device=dev)
    deleted = t.get("deleted")
    # Rows and tombstones over every rank, one logical copy each.
    counts = torch.stack([
        t["list_sizes"].long()[primary].sum(),
        (deleted[primary].sum() if deleted is not None
         else torch.zeros((), dtype=torch.long, device=dev)).long()])
    n_rows, n_del = (int(v) for v in comms.allreduce(counts.cpu()))
    top = comms.allreduce(torch.max(t["indices"]).reshape(1).long().cpu(),
                          OpT.MAX)
    common = dict(
        metric=DistanceType(int(model["metric"])),
        centers=torch.as_tensor(model["centers"]).to(dev),
        indices=t["indices"], list_sizes=t["list_sizes"], n_dev=n_shards,
        n_rows=n_rows, deleted=deleted, n_deleted=n_del,
        _next_id=int(top[0]) + 1, placement_map=pm)
    if str(model["kind"]) == "pq":
        return ShardedIvfPq(
            codebook_kind=_pq.CodebookGen(int(model["codebook_kind"])),
            rotation_matrix=torch.as_tensor(model["rotation_matrix"]).to(dev),
            pq_centers=torch.as_tensor(model["pq_centers"]).to(dev),
            pq_codes=t["store"], pq_bits=int(model["pq_bits"]),
            pq_dim=int(model["pq_dim"]), **common)
    return ShardedIvfFlat(data=t["store"], **common)
