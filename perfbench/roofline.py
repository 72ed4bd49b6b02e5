"""Peaks of one H100 and the least time a scan of IVF lists could take.

A frozen copy of the peaks (``PEAK_*``) and of the bound arithmetic of
the repository's ``chip_smoke.py`` (its B2 ``bounds()``), counted here
from the work itself rather than from the kernel's launch shape, so the
same work reads the same bound whatever implements it:

* operations: 2 x dim for every (query, row) pair scanned, the pairs
  worked out from the index's list sizes and each query's probed lists;
* bytes: the queries read once, the rows of every list that some query
  probes read once, and each (query, probe) pair's k candidates
  (distance and slot, 8 bytes) written once;
* the bound is the larger of operations over the tier's peak and bytes
  over the memory peak.

Exact-f32 products are held to a third of the TF32 peak (three TF32
products are the cheapest exact-f32 gram on the tensor cores); bf16
products to the bf16 peak.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

#: The product peak of each tier, in operations per second.
TIER_PEAK = {"f32": PEAK_TF32 / 3.0, "bf16": PEAK_BF16}


def bound_s(ops: float, nbytes: float, tier: str) -> float:
    """The least time of ``ops`` products on ``tier`` and ``nbytes`` of
    traffic, in seconds."""
    return max(ops / TIER_PEAK[tier], nbytes / PEAK_BYTES)


def ivf_scan_work(probe_ids, list_sizes, dim: int, k: int,
                  row_bytes: float, query_bytes: float) -> dict:
    """Operations and bytes of one scan of the probed lists.

    ``probe_ids`` (m, n_probes) list ids, ``list_sizes`` (n_lists,) rows
    per list; ``row_bytes`` bytes a stored row, ``query_bytes`` bytes a
    query row. Returns ``{"ops", "bytes", "pairs"}`` as Python numbers."""
    import torch

    sizes = list_sizes.to(torch.int64)
    pairs = int(sizes[probe_ids.long()].sum())
    used = torch.unique(probe_ids.long())
    rows_read = int(sizes[used].sum())
    m, p = probe_ids.shape
    nbytes = (m * query_bytes + rows_read * row_bytes + m * p * k * 8.0)
    return {"ops": 2.0 * dim * pairs, "bytes": float(nbytes),
            "pairs": pairs}


def add(a: dict, b: dict) -> dict:
    return {key: a.get(key, 0) + b.get(key, 0) for key in set(a) | set(b)}
