"""Classification metrics.

Port of ``raft_tpu/stats/classification.py``: ``accuracy``,
``make_monotonic_bounds`` and ``contingency_matrix``. The table is a
``bincount`` of the (ground truth, predicted) pairs, where the reference
takes a one-hot product: the counts are the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array


def accuracy(predictions, ref_predictions) -> torch.Tensor:
    """The share of predictions equal to the reference's (float32)."""
    p = as_array(predictions)
    r = as_array(ref_predictions, device=p.device).to(p.device)
    return torch.mean((p == r).to(torch.float32))


def make_monotonic_bounds(y) -> Tuple[int, int]:
    """``(min_label, max_label)`` of ``y`` (host integers)."""
    y = as_array(y)
    return int(torch.amin(y)), int(torch.amax(y))


def contingency_matrix(ground_truth, predicted,
                       min_label: Optional[int] = None,
                       max_label: Optional[int] = None) -> torch.Tensor:
    """Contingency table of ground-truth (rows) against predicted
    (columns) labels in ``[min_label, max_label]`` (the ground truth's
    range when not given); a pair with either label outside is dropped.
    Returns ``(n_classes, n_classes)`` int32."""
    gt = as_array(ground_truth).long()
    pr = as_array(predicted, device=gt.device).to(gt.device).long()
    if min_label is None:
        min_label = int(torch.amin(gt))
    if max_label is None:
        max_label = int(torch.amax(gt))
    n_classes = max_label - min_label + 1
    g, p = gt - min_label, pr - min_label
    keep = (g >= 0) & (g < n_classes) & (p >= 0) & (p < n_classes)
    flat = (g * n_classes + p)[keep]
    counts = torch.bincount(flat, minlength=n_classes * n_classes)
    return counts.reshape(n_classes, n_classes).to(torch.int32)
