"""Batched top-k selection with the reference's stable tie order.

Port of ``raft_tpu/matrix/select_k.py``. The reference selects with
``lax.top_k``, which returns ties lowest index first; ``torch.topk`` promises
no tie order (on ``[[1,0,0,0,1]]``, ``torch.topk(-x, 3)`` gives ``[1,3,2]``).
So every engine here selects with a stable sort, keyed on (value, index).

Engines:

* ``kTopK`` (and ``kAuto``, which resolves to it): one stable sort;
* ``kTwoPhase``: per-chunk stable selection, then a merge selection over
  the chunk candidates; same result as ``kTopK``;
* ``kStream`` is the reference's Pallas large-len select (kernel B5). It is
  not ported yet and raises.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects, fail
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.core.sentinels import PAD_ID, dummy_key_val
from raft_tpu_torch.util.pow2 import ceildiv


class SelectMethod(enum.Enum):
    """Algorithm choice (same members as raft_tpu's ``SelectMethod``)."""

    kAuto = 0
    kTopK = 1
    kTwoPhase = 2
    kStream = 3


_CHUNK = 16384


def stable_top_k(values: torch.Tensor, k: int,
                 select_min: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best entries of each row along the last axis, best first,
    ties to the lowest position: ``lax.top_k``'s order. Returns
    ``(values, int64 positions)``."""
    sel, idx = torch.sort(values, dim=-1, descending=not select_min,
                          stable=True)
    return sel[..., :k], idx[..., :k]


def _two_phase_top_k(values, k, select_min, chunk=_CHUNK):
    batch, n = values.shape
    n_chunks = ceildiv(n, chunk)
    pad = n_chunks * chunk - n
    if pad:
        dummy = dummy_key_val(values.dtype, select_min).to(values.device)
        values = torch.cat([values, dummy.expand(batch, pad)], dim=1)
    tiles = values.reshape(batch, n_chunks, chunk)
    _, idx_local = stable_top_k(tiles, min(k, chunk), select_min)
    base = (torch.arange(n_chunks, device=values.device) * chunk)[None, :, None]
    idx_global = (idx_local + base).reshape(batch, -1)
    cand = torch.gather(values, 1, idx_global)
    # Candidates are laid out in ascending position within equal values,
    # so the stable merge keeps the lowest-position tie order.
    sel, pos = stable_top_k(cand, k, select_min)
    return sel, torch.gather(idx_global, 1, pos)


def select_k(
    values,
    k: int,
    select_min: bool = True,
    indices=None,
    method: SelectMethod = SelectMethod.kAuto,
    handle=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the k smallest (or largest) entries per row with their
    indices, best first. ``indices``, when given, is a payload id matrix
    gathered through the selection; otherwise positions are returned.
    With k > n the tail is padded with the worst value and position n
    (payload id ``PAD_ID``).

    Returns ``(values (batch, k), indices (batch, k))``; positions are
    int32, a payload keeps its dtype."""
    v = as_tensor(values, handle)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[None, :]
    batch, n = v.shape
    if method == SelectMethod.kStream:
        fail("kStream (the streaming select kernel) is not ported yet; "
             "use kAuto or kTopK")
    if k >= n:
        sel, idx = stable_top_k(v, n, select_min)
        if k > n:
            dummy = dummy_key_val(v.dtype, select_min).to(v.device)
            sel = torch.cat([sel, dummy.expand(batch, k - n)], dim=1)
            idx = torch.cat([idx, torch.full((batch, k - n), n,
                                             dtype=idx.dtype,
                                             device=v.device)], dim=1)
    elif method == SelectMethod.kTwoPhase:
        sel, idx = _two_phase_top_k(v, k, select_min)
    else:
        sel, idx = stable_top_k(v, k, select_min)
    idx = idx.to(torch.int32)
    if indices is not None:
        payload = as_tensor(indices, device=v.device)
        if payload.ndim == 1:
            payload = payload[None, :]
        expects(payload.shape[0] in (1, batch),
                "indices must have one row or one per values row")
        payload = payload.expand(batch, -1)
        pad = idx >= payload.shape[1]
        safe = torch.clamp_max(idx, payload.shape[1] - 1).long()
        gathered = torch.gather(payload, 1, safe)
        idx = torch.where(pad, torch.full_like(gathered, PAD_ID), gathered)
    if squeeze:
        return sel[0], idx[0]
    return sel, idx
