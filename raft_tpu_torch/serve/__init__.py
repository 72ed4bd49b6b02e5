"""Online query-serving runtime above ``neighbors/`` and ``parallel/``.

Port of ``raft_tpu/serve``: shape bucketing with warm-up of the closed
set of batch shapes (``bucketing``), dynamic micro-batching with
bounded-queue admission control, deadlines and the degradation ladder
(``scheduler``), an exact-query LRU result cache keyed by index epoch
(``cache``), a uniform searcher facade threading RetryPolicy and the
index lifecycle (``searcher``), the hedge policy and its counters
(``hedge``), and per-bucket serving stats with kernel-build counting
(``stats``). A ``Searcher`` also serves a sharded brute-force, IVF-Flat
or IVF-PQ deployment on either placement (``mesh=``, ``health=``,
``dispatch_hook=``, ``hedge=``, an agreed ``retry=``), a
``BatchScheduler`` on rank 0 fronts it (the other ranks run
``BatchScheduler.follow``), and the circuit breaker
(``recovery.RecoveryProber``) re-admits a recovered shard after clean
shadow probes.
"""

from raft_tpu_torch.serve.bucketing import (
    DEFAULT_K_GRID,
    BucketGrid,
    pad_queries,
    warmup,
)
from raft_tpu_torch.serve.cache import ResultCache
from raft_tpu_torch.serve.hedge import HedgePolicy, HedgeStats
from raft_tpu_torch.serve.recovery import RecoveryProber
from raft_tpu_torch.serve.scheduler import (
    BatchPolicy,
    BatchScheduler,
    DegradePolicy,
    Overloaded,
    Ticket,
)
from raft_tpu_torch.serve.searcher import Searcher, SearchResult
from raft_tpu_torch.serve.stats import CompileCounter, ServeStats

__all__ = [
    "BucketGrid", "DEFAULT_K_GRID", "pad_queries", "warmup",
    "ResultCache",
    "HedgePolicy", "HedgeStats", "RecoveryProber",
    "BatchPolicy", "BatchScheduler", "DegradePolicy", "Overloaded",
    "Ticket",
    "Searcher", "SearchResult",
    "CompileCounter", "ServeStats",
]
