"""Degraded-mode serving helpers shared by every sharded search body.

Port of ``raft_tpu/parallel/degraded.py``: a dead shard's candidates
become merge padding, the merge returns the exact top-k over the
survivors, and a per-query ``coverage`` fraction rides along.

SPMD rules the reference's single controller did not need: every rank
holds its own ``ShardHealth``, so the mask a collective search uses is
rank 0's, broadcast with the call (:func:`check_live_mask`); and a check
that depends on a rank's own data (:func:`expects_finite_all`) agrees
across ranks before anyone raises, so no rank is left waiting in a
collective.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.comms.comms import Comms, OpT
from raft_tpu_torch.comms.topk_merge import (PIPELINED_ENGINES, topk_merge,
                                             topk_merge_pipelined)
from raft_tpu_torch.core.error import LogicError, expects
from raft_tpu_torch.core.sentinels import PAD_ID, worst_value


def check_live_mask(live_mask, comms: Comms) -> np.ndarray:
    """Validate a per-shard liveness mask: bool (n_dev,) with at least one
    live shard. The mask is rank 0's, broadcast to every rank (each rank's
    registry may have seen other events), and every rank checks the
    agreed mask, so all raise together."""
    n_dev = comms.get_size()
    live = np.asarray(live_mask)
    expects(live.shape == (n_dev,),
            "live_mask must be shape (%s,), got %s", n_dev, live.shape)
    live = comms.bcast(torch.as_tensor(live.astype(bool))).numpy()
    expects(bool(live.any()), "all shards dead: nothing to search")
    return live


def expects_finite_all(comms: Comms, name: str, *tensors) -> None:
    """``core/error.expects_finite`` over every rank's operands: one MAX
    allreduce of the local verdict, so every rank raises when any rank
    holds a NaN or an infinity."""
    flags = [torch.isfinite(t).all() for t in tensors
             if torch.is_floating_point(t) and t.numel()]
    bad = torch.tensor([0 if not flags or bool(torch.stack(flags).all())
                        else 1], dtype=torch.int32)
    if int(comms.allreduce(bad, OpT.MAX)[0]):
        raise LogicError(f"{name}: inputs must be finite (found NaN or inf)")


def neutralize_dead(dist, idx, alive: bool, select_min: bool):
    """A dead shard's candidates as the merge-padding sentinels (worst
    distance, id -1), which every merge engine ranks last."""
    if alive:
        return dist, idx
    return (torch.full_like(dist, worst_value(select_min)),
            torch.full_like(idx, PAD_ID))


def scan_merge_dispatch(scan_range, chunks, chunk_width, full_kk: int,
                        engine: str, k: int, comms: Comms, select_min: bool,
                        alive: Optional[bool] = None):
    """The shared scan -> merge of every sharded search body: this rank's
    scan merged through the engine, chunked with the exchanges overlapped
    when ``engine`` is pipelined (:func:`topk_merge_pipelined`).

    ``scan_range(lo, hi, kk)`` scans producer items [lo, hi) (probe
    columns, rows) at candidate width ``kk``; ``chunks`` is the (lo, hi)
    split (``pipeline_chunk_bounds``); ``chunk_width`` maps (lo, hi) to a
    chunk's width; ``full_kk`` is the unchunked width; ``alive`` is this
    shard's liveness (None = no mask)."""

    def one(lo, hi, kk):
        d, i = scan_range(lo, hi, kk)
        if alive is not None:
            d, i = neutralize_dead(d, i, alive, select_min)
        return d, i

    if engine in PIPELINED_ENGINES and len(chunks) > 1:
        return topk_merge_pipelined(
            lambda c: one(chunks[c][0], chunks[c][1],
                          chunk_width(chunks[c][0], chunks[c][1])),
            len(chunks), k, comms, select_min=select_min,
            quantized=engine == "pipelined_bf16")
    d, i = one(chunks[0][0], chunks[-1][1], full_kk)
    return topk_merge(d, i, k, comms, select_min=select_min, engine=engine)


def probed_coverage(probe_ids, sz_l, alive: bool, comms: Comms):
    """Per-query coverage: the fraction of the probed candidate rows that
    live on surviving shards. Every rank probes the same lists (the coarse
    model is replicated), so the probed-row totals sum exactly over the
    ranks; dead shards' rows count in the denominator only."""
    local = torch.sum(sz_l[probe_ids.long()].to(torch.float32), dim=1)
    total = comms.allreduce(local)
    live_total = comms.allreduce(local if alive else torch.zeros_like(local))
    return live_total / torch.clamp_min(total, 1.0)
