"""Merge two labelings through an equivalence mask.

Port of ``raft_tpu/label/merge_labels.py``: labels A and B over the same
points and a mask of core points; the classes joined by agreeing on
masked points take the least label of the class, by rounds of segment
minima over B's classes then A's (``scatter_reduce`` with ``amin``) until
no label changes. Points outside the mask keep their A label. Labels lie
in [0, n).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.mdarray import as_array

_INF = 2 ** 30


def merge_labels(labels_a, labels_b, mask) -> torch.Tensor:
    """The merged int32 labeling."""
    a = as_array(labels_a).to(torch.int32)
    b = as_array(labels_b, device=a.device).to(a.device).long()
    m = as_array(mask, device=a.device).to(device=a.device, dtype=torch.bool)
    ia = a.long()
    n = a.shape[0]

    def seg_min(values, seg):
        out = torch.full((n,), _INF, dtype=torch.int32, device=a.device)
        return out.scatter_reduce_(0, seg, values, "amin")

    lab = a
    while True:
        min_b = seg_min(torch.where(m, lab, _INF), b)
        pulled = torch.where(m, torch.minimum(lab, min_b[b]), lab)
        min_a = seg_min(torch.where(m, pulled, _INF), ia)
        new = torch.where(m, torch.minimum(pulled, min_a[ia]), pulled)
        if not bool(torch.any(new != lab)):
            return new
        lab = new
