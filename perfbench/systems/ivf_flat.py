"""The port's IVF-Flat index as a system under test.

Everything here calls ``raft_tpu_torch``'s public entry points; the
harness takes from the port only its answers, its index state (read by
the correctness check), its spans and its launch counters.
"""

from __future__ import annotations

import importlib

import torch

from raft_tpu_torch.neighbors import ivf_flat


def index_params(cfg: dict) -> ivf_flat.IndexParams:
    return ivf_flat.IndexParams(
        n_lists=cfg["n_lists"], kmeans_n_iters=cfg["kmeans_n_iters"],
        kmeans_trainset_fraction=cfg["kmeans_trainset_fraction"])


def search_params(cfg: dict) -> ivf_flat.SearchParams:
    return ivf_flat.SearchParams(n_probes=cfg["n_probes"])


def build(cfg: dict, X: torch.Tensor):
    return ivf_flat.build(index_params(cfg), X)


def search(index, cfg: dict, Q: torch.Tensor, k: int):
    return ivf_flat.search(search_params(cfg), index, Q, k)


def snapshot(index, keep_data: bool) -> dict:
    """Copies of the index state the check reads: centres, list ids and
    sizes (and the stored rows when ``keep_data``)."""
    snap = {"centers": index.centers.clone(),
            "indices": index.indices.clone(),
            "list_sizes": index.list_sizes.clone(),
            "deleted": (None if index.deleted is None
                        else index.deleted.clone())}
    if keep_data:
        snap["data"] = index.data.clone()
    return snap


def scan_row_bytes(index) -> float:
    return float(index.data.shape[2] * index.data.element_size())


def counters() -> dict:
    """The port's launch counters (cumulative)."""
    fk, pq, ss = (importlib.import_module("raft_tpu_torch.ops." + m)
                  for m in ("fused_knn", "pq_scan", "stream_select"))
    return {"b1": fk.fused_knn.launches,
            "b2": fk.fused_cells_knn.launches,
            "b2_tf32": fk.fused_cells_knn.tf32_launches,
            "b3": fk.fused_batch_knn.launches,
            "b4": pq.pq_fused_scan.launches,
            "b5": ss.stream_extract.launches}
