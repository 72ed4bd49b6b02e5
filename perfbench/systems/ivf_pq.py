"""The port's IVF-PQ index, searched on its compressed tier (B4)."""

from __future__ import annotations

import torch

from raft_tpu_torch.neighbors import ivf_pq

from perfbench.spec import module

#: The port's own path one precision below the configuration's: int8
#: look-up tables (the control of the correctness check).
CONTROL_PATH = {"int8_lut": True}

counters = module("systems", "ivf_flat").counters


def index_params(cfg: dict) -> ivf_pq.IndexParams:
    return ivf_pq.IndexParams(
        n_lists=cfg["n_lists"], kmeans_n_iters=cfg["kmeans_n_iters"],
        kmeans_trainset_fraction=cfg["kmeans_trainset_fraction"],
        pq_bits=cfg["pq_bits"], pq_dim=cfg["pq_dim"],
        retain_dataset=cfg["retain_dataset"])


def search_params(cfg: dict, int8_lut: bool = False) -> ivf_pq.SearchParams:
    return ivf_pq.SearchParams(n_probes=cfg["n_probes"],
                               compressed_lut_int8=int8_lut)


def build(cfg: dict, X: torch.Tensor):
    return ivf_pq.build(index_params(cfg), X)


def search(index, cfg: dict, Q: torch.Tensor, k: int,
           int8_lut: bool = False):
    return ivf_pq.search(search_params(cfg, int8_lut), index, Q, k)


def snapshot(index, keep_data: bool) -> dict:
    """Copies of the index state the check reads: centres, rotation,
    codebooks, packed codes, list ids and sizes."""
    return {"centers": index.centers.clone(),
            "rotation": index.rotation_matrix.clone(),
            "pq_centers": index.pq_centers.clone(),
            "pq_codes": index.pq_codes.clone(),
            "pq_bits": index.pq_bits, "pq_dim": index.pq_dim,
            "indices": index.indices.clone(),
            "list_sizes": index.list_sizes.clone(),
            "deleted": (None if index.deleted is None
                        else index.deleted.clone())}


def scan_row_bytes(index) -> float:
    return float(index.pq_codes.shape[2])
