"""The top-k merge core behind ``knn_merge_parts``.

Port of ``raft_tpu/comms/topk_merge.py::merge_parts`` and its helpers
``_ascending_keys`` and ``_sorted_select``. The merge orders candidates by
(key, part-major concatenated position) ascending, where the key maps the
selection polarity onto ascending order. The reference reduces the parts
with a tree of pairwise merges over a two-key ``lax.sort``; on one host
that order is the order of one stable sort of the concatenated keys, which
is what this module does. Float keys sort as ``lax.sort`` sorts them
(every NaN last, -0 equal to +0), through ``select_k.order_key``, on every
device.

The multi-device merge engines (allgather, ring, ring_bf16, the pipelined
engines) and their dispatch statistics wait for the sharding slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.matrix.select_k import order_key


def _ascending_keys(v: torch.Tensor, select_min: bool) -> torch.Tensor:
    """Map values so that ascending order is best-first order, in the
    values' own dtype."""
    if select_min:
        return v
    if v.is_floating_point():
        return -v
    if v.dtype == torch.uint8:
        return 255 - v     # negation would wrap: key 0 must rank last
    return torch.bitwise_not(v)


def _sorted_select(d, i, k: int, select_min: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-first top-k of candidate columns by distance, ties to the
    lower column."""
    order = torch.argsort(order_key(_ascending_keys(d, select_min),
                                    standardize=True),
                          dim=1, stable=True)[:, :k]
    return torch.gather(d, 1, order), torch.gather(i, 1, order)


def merge_parts(keys, vals, k: Optional[int] = None, select_min: bool = True,
                translations: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-host merge of per-part results: ``keys``/``vals`` are
    ``(n_parts, n_queries, kk)``, reduced to the global top-``k`` (default
    ``kk``). Ties go to the lower part-major concatenated position, so the
    result is the concat + select_k output. ``translations`` offsets each
    part's ids, in the ids' own dtype: int64 ids take offsets past
    2^31."""
    expects(keys.ndim == 3 and vals.shape == keys.shape,
            "keys/vals must be (n_parts, n_queries, k)")
    n_parts, n_queries, kk = keys.shape
    if k is None:
        k = kk
    if translations is not None:
        translations = [int(x) for x in translations]
        info = torch.iinfo(vals.dtype)
        expects(all(info.min <= x <= info.max for x in translations),
                "translations %s do not fit the %s ids; widen them first "
                "(idx_dtype=torch.int64)", translations, vals.dtype)
        off = torch.as_tensor(translations, dtype=vals.dtype,
                              device=vals.device).reshape(n_parts, 1, 1)
        vals = vals + off
    return _sorted_select(
        keys.permute(1, 0, 2).reshape(n_queries, n_parts * kk),
        vals.permute(1, 0, 2).reshape(n_queries, n_parts * kk), k,
        select_min)
