"""Gaussian-cluster dataset generator.

Port of ``raft_tpu/random/make_blobs.py``: isotropic Gaussian blobs
around sampled or given centers. Row i belongs to cluster
``i % n_clusters`` before the shuffle, as in the reference. The draws come
from ``RngState(seed)`` on the output's device (``cuda`` unless ``device``
or a ``centers`` tensor says otherwise).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.resources import DeviceLike, as_tensor, resolve_device
from raft_tpu_torch.random.rng import _dtype
from raft_tpu_torch.random.rng_state import RngState


def make_blobs(n_rows: int, n_cols: int, n_clusters: int = 5,
               cluster_std: float = 1.0, centers=None,
               center_box_min: float = -10.0, center_box_max: float = 10.0,
               shuffle: bool = True, seed: int = 0, dtype=torch.float32,
               device: DeviceLike = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(data (n_rows, n_cols), labels (n_rows,) int32)``.
    ``cluster_std`` is a scalar or an array that broadcasts against the
    (n_rows, n_cols) noise, as in the reference."""
    dt = _dtype(dtype)
    if isinstance(centers, torch.Tensor):
        device = centers.device
    dev = resolve_device(device)
    state = RngState(seed)
    if centers is None:
        centers = torch.empty((n_clusters, n_cols), dtype=dt,
                              device=dev).uniform_(
            center_box_min, center_box_max,
            generator=state.next_generator(dev))
    else:
        centers = as_tensor(centers, device=dev).to(dt)
        n_clusters = centers.shape[0]
    labels = torch.arange(n_rows, dtype=torch.int32, device=dev) % n_clusters
    if shuffle:
        labels = labels[torch.randperm(n_rows,
                                       generator=state.next_generator(dev),
                                       device=dev)]
    noise = torch.randn((n_rows, n_cols), generator=state.next_generator(dev),
                        dtype=dt, device=dev)
    if not isinstance(cluster_std, (int, float)):
        cluster_std = as_tensor(cluster_std, device=dev).to(dt)
    data = centers[labels.long()] + cluster_std * noise
    return data, labels
