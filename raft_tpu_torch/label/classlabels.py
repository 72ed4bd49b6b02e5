"""Class-label utilities.

Port of ``raft_tpu/label/classlabels.py``: the sorted distinct labels, and
a remap of arbitrary label values onto 0..n_classes - 1. Where the
reference works on host numpy, the port works on the labels' device
(``cuda`` for non-tensors).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array


def get_unique_labels(labels) -> torch.Tensor:
    """Sorted distinct label values."""
    return torch.unique(as_array(labels), sorted=True)


def make_monotonic(labels, classes=None, zero_based: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remap labels onto a dense 0..k - 1 (or 1..k) range: each label's
    position in the sorted ``classes`` (the distinct labels when None).
    Returns ``(mapped int32, classes)``."""
    lab = as_array(labels)
    if classes is None:
        classes = torch.unique(lab, sorted=True)
    else:
        classes = as_array(classes, device=lab.device).to(lab.device)
    mapped = torch.searchsorted(classes.contiguous(),
                                lab.to(classes.dtype).contiguous())
    if not zero_based:
        mapped = mapped + 1
    return mapped.to(torch.int32), classes
