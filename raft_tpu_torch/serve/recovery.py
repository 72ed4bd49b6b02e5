"""Circuit-breaker recovery: shadow-probe degraded shards back to life.

Port of ``raft_tpu/serve/recovery.py`` in name only: its
:class:`RecoveryProber` re-admits a dead or suspect shard after
consecutive clean ``Searcher.shadow_probe`` passes, and a shadow probe of
one rank is a per-rank timing decision that the ranks must agree on
before any of them dispatches. Both wait for ROADMAP A.4c and raise.
"""

from __future__ import annotations

from raft_tpu_torch.core.error import fail

__all__ = ["RecoveryProber"]


class RecoveryProber:
    """Re-admits dead / suspect shards after consecutive clean shadow
    probes: waits for ROADMAP A.4c."""

    def __init__(self, *args, **kwargs):
        fail("the recovery prober (shadow probes of dead or suspect "
             "ranks) waits for ROADMAP A.4c")
