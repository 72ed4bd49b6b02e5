"""Batched top-k selection with the reference's stable tie order.

Port of ``raft_tpu/matrix/select_k.py``. The reference selects with
``lax.top_k``, which returns ties lowest index first; ``torch.topk`` promises
no tie order (on ``[[1,0,0,0,1]]``, ``torch.topk(-x, 3)`` gives ``[1,3,2]``).
So every engine here selects with a stable sort, keyed on (value, index).

Engines:

* ``kTopK``: one stable sort;
* ``kTwoPhase``: per-chunk stable selection, then a merge selection over
  the chunk candidates; same result as ``kTopK``;
* ``kStream``: the large-len select. Kernel B5 (``ops/stream_select.py``)
  extracts every 512-position sub-chunk's 8 smallest, a stable sort ranks
  the n / 64 candidates, and a per-row audit sends the rows that
  compression could have cut short (sorted, constant, NaN) to the exact
  sort, so the result is ``kTopK``'s, ties included.

``kAuto`` takes ``kStream`` on ``cuda`` inside the reference's gate
(:func:`_stream_supported`: 64 <= k <= 256, len >= 65536 and >= 128 k,
batch >= 8, a float dtype) and ``kTopK`` everywhere else, as the reference
takes ``lax.top_k`` off the TPU. The gate is the reference's v5e rule; its
H100 crossover is measured by ``chip_smoke.py``, not re-tuned here.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.core.sentinels import PAD_ID, dummy_key_val
from raft_tpu_torch.ops.stream_select import M, n_candidates, stream_extract
from raft_tpu_torch.util.pow2 import ceildiv


class SelectMethod(enum.Enum):
    """Algorithm choice (same members as raft_tpu's ``SelectMethod``)."""

    kAuto = 0
    kTopK = 1
    kTwoPhase = 2
    kStream = 3


_CHUNK = 16384


_BITS = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
         torch.float32: torch.int32, torch.float64: torch.int64}


def order_key(values: torch.Tensor, standardize: bool = False
              ) -> torch.Tensor:
    """Integer keys that sort floats as the reference does: by the total
    order of their bits (-NaN < -inf < ... < -0 < +0 < ... < inf < +NaN),
    the order of ``lax.top_k``; with ``standardize`` every NaN sorts last
    and -0 equals +0, the order of ``lax.sort``. ``torch.sort`` on the
    floats themselves puts a negative NaN last on the CPU and first on
    CUDA. Non-float values are their own keys."""
    bits = _BITS.get(values.dtype)
    if bits is None:
        return values
    b = values.view(bits)
    key = b ^ ((b >> (torch.iinfo(bits).bits - 1)) & torch.iinfo(bits).max)
    if standardize:
        key = torch.where(values == 0, 0, key)
        key = torch.where(torch.isnan(values), torch.iinfo(bits).max, key)
    return key


def stable_top_k(values: torch.Tensor, k: int,
                 select_min: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best entries of each row along the last axis, best first,
    ties to the lowest position, in :func:`order_key`'s total order:
    ``lax.top_k``'s order on every device. Returns ``(values, int64
    positions)``."""
    _, idx = torch.sort(order_key(values), dim=-1, descending=not select_min,
                        stable=True)
    idx = idx[..., :k]
    return torch.gather(values, -1, idx), idx


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


# Audit-failure budget of the streaming engine's per-row repair.
_PATCH_ROWS = 8
_STREAM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _audit_failures(cand_v, best_v) -> torch.Tensor:
    """Per-row flag of the kStream audit: some sub-chunk's last extract is
    not above the row's k-th best (``best_v[:, -1]``), so that sub-chunk
    may hide a better entry."""
    chunk_worst = cand_v.view(cand_v.shape[0], -1, M)[:, :, M - 1]
    return ~torch.all(chunk_worst > best_v[:, -1:], dim=1)


def _stream_select_min(keys, values, k: int,
                       select_min: bool) -> torch.Tensor:
    """Streaming min-k over f32 keys (batch, n): the (batch, k) int32
    positions of the k smallest, ascending, exact.

    B5 extracts each sub-chunk's 8 smallest; a stable sort ranks those
    candidates (lane order already puts equal values in position order).
    The audit: a sub-chunk whose 8th extract is not above the row's k-th
    best may hide a better entry, so that row is recomputed by a stable
    sort of the row itself; up to ``_PATCH_ROWS`` rows are repaired alone,
    beyond that the whole batch is sorted. The exact sort runs on the f32
    ``values`` with the polarity ``select_min``, not on the keys (a
    max-selection's negated values), because CUDA's negation does not
    keep a NaN's sign."""
    batch = keys.shape[0]
    cand_v, cand_i = stream_extract(keys)
    best_v, pos = stable_top_k(cand_v, k)
    best_i = torch.gather(cand_i, 1, pos)
    bad = _audit_failures(cand_v, best_v)
    # The select's one host read: the count of rows that failed the audit
    # picks the branch.
    n_bad = int(bad.sum())
    if n_bad == 0:
        return best_i
    if n_bad > min(_PATCH_ROWS, batch):
        return stable_top_k(values, k, select_min)[1].to(torch.int32)
    # The bad rows first, in row order, without a second host read.
    rows = torch.argsort((~bad).to(torch.uint8), stable=True)[:n_bad]
    best_i[rows] = stable_top_k(values[rows], k, select_min)[1].to(
        torch.int32)
    return best_i


def _stream_top_k(values, k: int, select_min: bool):
    """kStream engine: f32 keys (negated for a max-selection), the
    streaming select, then the original values gathered at the selected
    positions. With k < n the positions are real: +inf padding loses every
    comparison, and degenerate rows trip the audit into the exact sort."""
    vals = values.to(torch.float32).contiguous()
    keys = vals if select_min else -vals
    idx = _stream_select_min(keys, vals, k, select_min)
    return torch.gather(values, 1, idx.long()), idx


def _stream_supported(batch: int, n: int, k: int, dtype,
                      device: torch.device) -> bool:
    """``kAuto``'s gate for kStream: the reference's rule (measured on a
    TPU v5e, where the extractor beat ``lax.top_k`` on long rows at large
    k), with a ``cuda`` device in place of the ``tpu`` backend. Needs n / 64
    candidates >= 2k of audit headroom."""
    return (device.type == "cuda" and 64 <= k <= 256 and n >= 65536
            and n >= 128 * k and batch >= 8 and dtype in _STREAM_DTYPES)


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
    if k >= n:
        sel, idx = stable_top_k(v, n, select_min)
        if k > n:
            dummy = dummy_key_val(v.dtype, select_min).to(v.device)
            sel = torch.cat([sel, dummy.expand(batch, k - n)], dim=1)
            idx = torch.cat([idx, torch.full((batch, k - n), n,
                                             dtype=idx.dtype,
                                             device=v.device)], dim=1)
    else:
        if method == SelectMethod.kStream:
            # An explicit request is validated, not silently degraded:
            # integer keys would round through f32, and too few candidates
            # could not hold k.
            expects(k <= 256, "kStream supports k <= 256 (the warpsort cap)")
            expects(v.dtype in _STREAM_DTYPES,
                    "kStream requires f32/bf16/f16 values (integer and f64 "
                    "keys are not exact in its f32 pipeline)")
            expects(n_candidates(n) >= k,
                    f"kStream needs len/64 candidates >= k (len={n}, k={k}); "
                    "use kTopK")
        if method == SelectMethod.kTwoPhase:
            sel, idx = _two_phase_top_k(v, k, select_min)
        elif method == SelectMethod.kStream or (
                method == SelectMethod.kAuto
                and _stream_supported(batch, n, k, v.dtype, v.device)):
            sel, idx = _stream_top_k(v, k, select_min)
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
