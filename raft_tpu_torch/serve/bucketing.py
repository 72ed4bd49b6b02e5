"""Shape bucketing: pad requests into a closed set of batch shapes.

Port of ``raft_tpu/serve/bucketing.py``. Requests arrive with arbitrary
row counts; the runtime quantizes the query-count axis to a pow2 ladder
and k to a small fixed grid, pads every request up to its bucket, and
warms the full ``len(q_buckets) x len(k_grid)`` closed set at startup
(:func:`warmup`). On the card the port compiles no per-shape program, so
the reference's reason for the grid (one XLA compile per novel shape)
becomes two others: the engines' plan caches (the IVF engines' measured
bucket capacities, ``ivf_flat._auto_cap_cache``) are keyed on the batch
shape and warm once per bucket, and the IVF engines' kernel gates read
the batch size, so the grid decides which batches reach kernels B2 and
B4 (a probe load ``n_queries * n_probes / n_lists >= 8``).

Padding is sound because every search path is row-independent: padded
query rows (zeros) compute neighbors for themselves that are sliced off
before results leave the scheduler; they cannot perturb real rows (each
output row of the distance/top-k pipeline depends only on its own query
row). The wasted pad compute is bounded by the pow2 ladder at <2x and
tracked per bucket as ``padded_slots`` in ``serve/stats.py``.
"""

from __future__ import annotations

import dataclasses

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.util.pow2 import next_pow2

#: Default k grid: the common serving points (top-1 lookup, top-10
#: retrieval, top-100 candidate generation for re-ranking).
DEFAULT_K_GRID = (1, 10, 100)


@dataclass(frozen=True)
class BucketGrid:
    """The closed set of batch shapes the runtime serves from.

    ``q_buckets`` — ascending query-count bucket sizes (use
    :meth:`pow2` for the standard pow2 ladder); a request with ``n``
    queries pads up to the smallest bucket >= n. ``k_grid`` — ascending
    k values; a request's k rounds up to the smallest grid k and the
    result is sliced back down (top-k at k' >= k prefixes to top-k
    under the same total order).
    """

    q_buckets: Tuple[int, ...]
    k_grid: Tuple[int, ...] = DEFAULT_K_GRID

    def __post_init__(self):
        for name, grid in (("q_buckets", self.q_buckets),
                           ("k_grid", self.k_grid)):
            expects(len(grid) >= 1, "%s must be non-empty", name)
            expects(all(int(g) == g and g >= 1 for g in grid),
                    "%s entries must be positive ints, got %s", name, grid)
            expects(tuple(sorted(set(grid))) == tuple(grid),
                    "%s must be strictly ascending, got %s", name, grid)

    @classmethod
    def pow2(cls, max_batch: int,
             k_grid: Tuple[int, ...] = DEFAULT_K_GRID) -> "BucketGrid":
        """The standard ladder: 1, 2, 4, ... up to ``max_batch`` rounded
        up to a power of two."""
        expects(max_batch >= 1, "max_batch must be >= 1, got %s", max_batch)
        top = next_pow2(max_batch)
        ladder = []
        b = 1
        while b <= top:
            ladder.append(b)
            b *= 2
        return cls(q_buckets=tuple(ladder), k_grid=tuple(k_grid))

    @property
    def max_batch(self) -> int:
        return self.q_buckets[-1]

    @property
    def max_k(self) -> int:
        return self.k_grid[-1]

    def bucket_queries(self, n: int) -> Optional[int]:
        """Smallest query bucket >= n, or None when n exceeds the grid
        (the caller chunks or serves out-of-grid)."""
        for b in self.q_buckets:
            if b >= n:
                return b
        return None

    def bucket_k(self, k: int) -> Optional[int]:
        """Smallest grid k >= requested k, or None when out of grid."""
        for g in self.k_grid:
            if g >= k:
                return g
        return None

    def bucket_for(self, n: int, k: int) -> Optional[Tuple[int, int]]:
        """The (q_bucket, k_bucket) this request pads into, or None if
        either axis falls outside the grid."""
        qb, kb = self.bucket_queries(n), self.bucket_k(k)
        if qb is None or kb is None:
            return None
        return (qb, kb)

    def shapes(self) -> Tuple[Tuple[int, int], ...]:
        """Every (q_bucket, k) shape — the closed set warmup runs."""
        return tuple((qb, kb) for qb in self.q_buckets
                     for kb in self.k_grid)


def pad_queries(queries: np.ndarray, q_bucket: int) -> np.ndarray:
    """Pad query rows with zeros up to the bucket size (host-side; the
    pad rows' results are sliced off by the scheduler)."""
    queries = np.asarray(queries)
    n = queries.shape[0]
    expects(n <= q_bucket, "batch of %s rows exceeds bucket %s", n,
            q_bucket)
    if n == q_bucket:
        return queries
    pad = np.zeros((q_bucket - n,) + queries.shape[1:], queries.dtype)
    return np.concatenate([queries, pad], axis=0)


def warmup(searcher, grid: BucketGrid, include_degraded: bool = False,
           cache_dir: Optional[str] = None,
           degrade_ladder: Optional[Tuple[float, ...]] = None,
           min_probes: int = 1) -> dict:
    """Run one dummy search per bucket shape ahead of traffic, so
    steady-state in-grid traffic builds and loads no kernel and meets
    warm plan caches.

    Runs one search per ``grid.shapes()`` entry on zero queries. Returns
    a report dict: shapes warmed, the kernel builds and first library
    loads observed (:class:`~raft_tpu_torch.serve.stats.CompileCounter`;
    a second boot on a machine reports 0, the persistent build cache
    served them), and that cache's directory
    (``ops/_build.enable_compilation_cache``). ``cache_dir`` is kept for
    the reference's signature: the port builds into one directory, so any
    other directory raises.

    ``degrade_ladder`` (pass ``DegradePolicy.ladder`` and its
    ``min_probes``) additionally warms every reduced-``n_probes`` rung the
    deadline degradation ladder can serve at: each rung is its own plan
    key, so a brownout meets warm caches too. Ignored for searchers
    without an ``n_probes`` parameter (brute force).

    ``include_degraded=True`` also runs each shape's degraded search (the
    ``live_mask`` path served while a shard is dead), which needs a
    sharded searcher with a health registry. Over a sharded searcher the
    call is collective, like its searches: every rank runs it.

    A routed (``placement="list"``) searcher also runs, per shape (and
    per ladder rung), the routed dispatch at every (query-group,
    local-probe-width) bucket of ``parallel.routing.route_shapes``
    (:func:`~raft_tpu_torch.parallel.ivf.sharded_routed_warmup`), so
    however queries cluster they meet shapes already run; the report's
    ``routed_shapes`` counts them. Warmup's dispatches record no merge or
    routing telemetry (their all-zeros queries would pour fake probe load
    onto a few lists)."""
    from raft_tpu_torch.core.logger import logger
    from raft_tpu_torch.ops._build import enable_compilation_cache
    from raft_tpu_torch.serve.stats import CompileCounter

    # Without a health registry there IS no degraded search to warm —
    # silently double-searching would report failure-readiness that
    # doesn't exist.
    expects(not include_degraded or getattr(searcher, "health", None)
            is not None,
            "include_degraded=True needs a searcher with ShardHealth")
    effective_dir = enable_compilation_cache()
    expects(cache_dir is None
            or Path(cache_dir).resolve() == Path(effective_dir).resolve(),
            "warmup: the port builds its kernels into %s, not %s",
            effective_dir, cache_dir)
    dim = searcher.dim
    shapes = grid.shapes()
    # The ladder's closed n_probes set (deduped: min_probes and int
    # truncation can collapse adjacent rungs onto one value).
    base_np = getattr(getattr(searcher, "_params", None), "n_probes", None)
    rung_probes: Tuple[int, ...] = ()
    if degrade_ladder is not None and base_np is not None:
        vals = {max(int(min_probes), int(int(base_np) * float(f)))
                for f in degrade_ladder}
        rung_probes = tuple(sorted(v for v in vals if v < int(base_np)))
    routed = (getattr(searcher, "mesh", None) is not None
              and getattr(getattr(searcher, "_index", None), "placement",
                          "row") == "list")
    routed_shapes = 0
    from raft_tpu_torch.comms.topk_merge import merge_dispatch_stats
    from raft_tpu_torch.parallel.routing import routing_stats

    with CompileCounter() as counter, merge_dispatch_stats.suppress(), \
            routing_stats.suppress():
        for qb, kb in shapes:
            dummy = np.zeros((qb, dim), np.float32)
            searcher.search(dummy, kb, degraded=False)
            if include_degraded:
                searcher.search(dummy, kb, degraded=True)
            for npr in rung_probes:
                # One extra search per ladder rung per shape: brownout
                # serving then meets warm plan caches.
                searcher.search(dummy, kb, degraded=False, n_probes=npr)
            if routed:
                from raft_tpu_torch.parallel.ivf import sharded_routed_warmup

                for npr in (None,) + rung_probes:
                    params = (searcher._params if npr is None else
                              dataclasses.replace(searcher._params,
                                                  n_probes=npr))
                    routed_shapes += sharded_routed_warmup(
                        searcher.mesh, params, searcher._index, qb, kb,
                        merge_engine=searcher.merge_engine)
    logger.debug("serve warmup: %s bucket shapes (+%s routed plan shapes), "
                 "%s kernel builds/loads, build cache at %s", len(shapes),
                 routed_shapes, counter.count, effective_dir)
    return {"shapes": len(shapes), "degraded": bool(include_degraded),
            "routed_shapes": routed_shapes,
            "degrade_rungs": len(rung_probes),
            "compile_events": counter.count, "cache_dir": effective_dir}
