"""Regression dataset generator.

Port of ``raft_tpu/random/make_regression.py``: a Gaussian design matrix,
ground-truth coefficients of which ``n_informative`` rows are non-zero
(100 x U[0, 1)), an optional bias, noise and a shuffle of the
coefficients' rows. The draws come from ``RngState(seed)`` on ``device``
(``cuda`` when None).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import DeviceLike, resolve_device
from raft_tpu_torch.random.rng import _dtype
from raft_tpu_torch.random.rng_state import RngState


def make_regression(n_rows: int, n_cols: int,
                    n_informative: Optional[int] = None, n_targets: int = 1,
                    bias: float = 0.0, noise: float = 0.0,
                    shuffle: bool = True, seed: int = 0,
                    dtype=torch.float32, device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(X (n_rows, n_cols), y (n_rows, n_targets), coef
    (n_cols, n_targets))`` with y = X coef + bias (+ noise)."""
    if n_informative is None:
        n_informative = n_cols
    n_informative = min(n_informative, n_cols)
    dt = _dtype(dtype)
    dev = resolve_device(device)
    state = RngState(seed)
    x = torch.randn((n_rows, n_cols), generator=state.next_generator(dev),
                    dtype=dt, device=dev)
    coef = torch.zeros((n_cols, n_targets), dtype=dt, device=dev)
    coef[:n_informative] = 100.0 * torch.rand(
        (n_informative, n_targets), generator=state.next_generator(dev),
        dtype=dt, device=dev)
    if shuffle:
        # The columns of x are iid, so shuffling them changes nothing in
        # distribution: only the coefficients' rows move.
        coef = coef[torch.randperm(n_cols,
                                   generator=state.next_generator(dev),
                                   device=dev)]
    y = x @ coef + bias
    if noise > 0:
        y = y + noise * torch.randn(y.shape,
                                    generator=state.next_generator(dev),
                                    dtype=dt, device=dev)
    return x, y, coef
