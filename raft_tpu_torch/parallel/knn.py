"""Multi-rank brute-force kNN: shard the database, search locally, merge.

Port of ``raft_tpu/parallel/knn.py``. Every rank scans its own row shard
with the port's brute-force engine, which is kernel B1 on the card
(``brute_force._use_kernel``: n >= 8192, k <= 128), offsets its ids to
global rows and merges through the merge engine
(``comms/topk_merge.py``). The entry points are collective: each rank of
the mesh calls them with the same arguments and gets the same replicated
``(distances, ids)``.

Degraded serving: ``live_mask`` (typically ``ShardHealth.live_mask``;
rank 0's is used) neutralizes dead shards' candidates to the merge
padding, so a lost shard yields the exact top-k over the survivors plus a
per-query ``coverage`` fraction.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from raft_tpu_torch.comms.comms import Comms, Mesh
from raft_tpu_torch.comms.topk_merge import (merge_dispatch_stats,
                                             pipeline_chunk_bounds,
                                             resolve_merge_engine,
                                             resolve_pipeline_chunks)
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_float
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors.brute_force import _TILE_DB, _knn_one_part
from raft_tpu_torch.parallel.degraded import (check_live_mask,
                                              expects_finite_all,
                                              scan_merge_dispatch)


@dataclass(frozen=True)
class RowShard:
    """This rank's contiguous slice of a row-sharded matrix: ``rows``
    (n_total / size, d) on the mesh's device, global rows ``[offset,
    offset + len(rows))``."""

    rows: torch.Tensor
    n_total: int
    offset: int

    @property
    def shape(self):
        return (self.n_total, self.rows.shape[1])


def _check_mesh(mesh) -> None:
    expects(isinstance(mesh, Mesh),
            "mesh must be a comms.make_mesh Mesh (ROADMAP A.4a), got %s",
            type(mesh).__name__)


def shard_database(mesh: Mesh, db) -> RowShard:
    """This rank's row slice of ``db`` (the same matrix on every rank),
    placed once on the mesh's device: the layout :func:`sharded_knn`
    consumes. The row count must divide the mesh size (pad upstream). A
    :class:`RowShard` passes through."""
    _check_mesh(mesh)
    if isinstance(db, RowShard):
        expects(db.rows.device == mesh.device,
                "shard on %s, mesh on %s", db.rows.device, mesh.device)
        return db
    # A tensor stays where it is; numpy waits on the host for the slice.
    db = as_float(db, device="cpu")
    expects(db.ndim == 2, "db must be (n, d), got %s", tuple(db.shape))
    n = db.shape[0]
    expects(n % mesh.size == 0,
            "db rows must divide the mesh axis (pad first)")
    shard = n // mesh.size
    lo = mesh.rank * shard
    rows = db[lo:lo + shard].to(mesh.device).contiguous()
    return RowShard(rows, n, lo)


def sharded_knn(mesh: Mesh, db, queries, k: int, sqrt: bool = False,
                merge_engine: str = "auto",
                live_mask=None, pipeline_chunks: int = 0):
    """Exact L2 kNN with the database rows sharded over the mesh.

    ``db`` is the whole matrix (the same on every rank) or this rank's
    :class:`RowShard`; rows must divide the mesh size. Returns replicated
    ``(distances (q, k), int32 global ids (q, k))``. ``merge_engine``:
    "allgather", "ring", "ring_bf16", "pipelined", "pipelined_bf16" or
    "auto" ("auto" never picks the pipelined engines here: the row scan
    has no probe count to key them on). The pipelined engines scan the
    shard in ``pipeline_chunks`` row ranges (0 = the default split) and
    overlap each range's exchange with the next range's scan.

    ``live_mask`` (bool (n_dev,)) enables degraded serving: the result is
    the exact top-k over the live shards' rows (tail slots pad with
    (inf, -1) when k exceeds them), and a third output ``coverage``
    (float32 (q,)) gives the fraction of rows searched. With every shard
    live the first two outputs are those of ``live_mask=None``. Rejects
    non-finite inputs on every rank when any rank holds one."""
    _check_mesh(mesh)
    live = (None if live_mask is None
            else check_live_mask(live_mask, Comms(mesh)))
    return _sharded_knn(mesh, db, queries, k, sqrt, merge_engine, live,
                        pipeline_chunks)


def _sharded_knn(mesh: Mesh, db, queries, k: int, sqrt: bool,
                 merge_engine: str, live, pipeline_chunks: int):
    """:func:`sharded_knn` with ``live`` already agreed across the ranks
    (:func:`check_live_mask`'s output, or None): the sharded Searcher
    agrees it once to decide the degraded path and passes it here."""
    shard_db = shard_database(mesh, db)
    comms = Comms(mesh)
    Q = as_float(queries, device=mesh.device)
    expects(Q.device == mesh.device, "queries on %s, mesh on %s", Q.device,
            mesh.device)
    rows = shard_db.rows
    expects(Q.ndim == 2 and Q.shape[1] == rows.shape[1],
            "query dim mismatch")
    expects_finite_all(comms, "sharded_knn", Q, rows)
    n_dev = mesh.size
    shard = rows.shape[0]
    kk = min(k, shard)
    engine = resolve_merge_engine(merge_engine, Q.shape[0], k, n_dev)
    chunks = tuple(pipeline_chunk_bounds(
        shard, resolve_pipeline_chunks(engine, shard, n_dev,
                                       requested=pipeline_chunks)))
    merge_dispatch_stats.record(
        engine, Q.shape[0], k, kk, n_dev,
        chunk_kks=([min(k, hi - lo) for lo, hi in chunks]
                   if len(chunks) > 1 else None))
    alive = None if live is None else bool(live[mesh.rank])
    metric = (DistanceType.L2SqrtExpanded if sqrt
              else DistanceType.L2Expanded)

    def scan_range(lo, hi, kk_c):
        # One row range of the shard: B1 on the card, the tiled scan on
        # the CPU; ids offset to global rows.
        d_c, i_c = _knn_one_part(Q, rows[lo:hi], kk_c, metric, 2.0,
                                 _TILE_DB, "auto")
        return d_c, i_c + (shard_db.offset + lo)

    out_d, out_i = scan_merge_dispatch(
        scan_range, chunks, chunk_width=lambda lo, hi: min(kk, hi - lo),
        full_kk=kk, engine=engine, k=k, comms=comms, select_min=True,
        alive=alive)
    if live is None:
        return out_d, out_i
    # Equal rows per shard: the covered fraction is the live fraction.
    cov = float(live.astype("float32").mean())
    return out_d, out_i, torch.full((Q.shape[0],), cov,
                                    dtype=torch.float32, device=Q.device)
