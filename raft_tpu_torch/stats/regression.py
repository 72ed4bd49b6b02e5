"""Regression quality metrics.

Port of ``raft_tpu/stats/regression.py``: ``r2_score``,
``regression_metrics`` and ``information_criterion``.
"""

from __future__ import annotations

import enum
from typing import Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array


class InformationCriterionType(enum.Enum):
    """AIC, AICc and BIC."""

    AIC = 0
    AICc = 1
    BIC = 2


def r2_score(y, y_hat) -> torch.Tensor:
    """R^2 = 1 - SS_res / SS_tot, SS_tot about the mean of ``y``."""
    yt = as_array(y)
    yp = as_array(y_hat, device=yt.device).to(yt.device)
    mu = torch.mean(yt)
    return 1.0 - torch.sum((yt - yp) ** 2) / torch.sum((yt - mu) ** 2)


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median of all entries; of an even count, the mean of the two
    middle values (``jnp.median``'s linear interpolation)."""
    s, _ = torch.sort(x.reshape(-1))
    m = s.shape[0]
    if m % 2:
        return s[m // 2]
    return s[m // 2 - 1] * 0.5 + s[m // 2] * 0.5


def regression_metrics(predictions, ref_predictions
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean absolute, mean squared, median absolute)`` error."""
    p = as_array(predictions)
    r = as_array(ref_predictions, device=p.device).to(p.device)
    diff = p - r
    return (torch.mean(torch.abs(diff)), torch.mean(diff ** 2),
            _median(torch.abs(diff)))


def information_criterion(loglikelihood, ic_type: InformationCriterionType,
                          n_params: int, n_samples: int) -> torch.Tensor:
    """Per-series criterion from log-likelihoods: AIC = 2k - 2ll, AICc =
    AIC + 2k(k + 1) / (N - k - 1), BIC = k ln(N) - 2ll."""
    ll = as_array(loglikelihood)
    k, n = n_params, n_samples
    base = -2.0 * ll
    if ic_type == InformationCriterionType.AIC:
        penalty = 2.0 * k
    elif ic_type == InformationCriterionType.AICc:
        penalty = 2.0 * k + (2.0 * k * (k + 1)) / (n - k - 1)
    elif ic_type == InformationCriterionType.BIC:
        penalty = k * torch.log(torch.tensor(float(n), dtype=ll.dtype,
                                             device=ll.device))
    else:  # pragma: no cover
        raise ValueError(f"unknown IC type {ic_type}")
    return base + penalty
