"""Hedged replica dispatch policy + counters (tail-latency robustness).

Port of ``raft_tpu/serve/hedge.py``: "The Tail at Scale" playbook, a
request that outlives a high quantile of its latency distribution is
re-issued to a replica and the first result wins. The policy and its
counters are host logic and carry over as they are; every ``Searcher``
holds a :class:`HedgeStats`. The hedged dispatch itself
(``Searcher._maybe_hedge``) re-routes a routed (list-placed) sharded
index around SUSPECT shards; under SPMD the decision to hedge is a timing
decision, so rank 0's clock, budget and suspect mask decide for every
rank (one broadcast before the re-dispatch), and rank 0's clock picks the
answer (one after it).

Determinism: the hedge is *reactive*, measured on the Searcher's
INJECTED clock, so replayed request streams hedge identically; no wall
time anywhere.

The budget derives from :meth:`ServeStats.latency_quantile`, the same
per-bucket latency model the deadline degradation ladder consults, so
the hedge only arms once the bucket has real evidence (``min_samples``);
before that ``min_budget`` is the floor.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from raft_tpu_torch.core.error import expects

__all__ = ["HedgePolicy", "HedgeStats"]


@dataclass(frozen=True)
class HedgePolicy:
    """Knobs for the Searcher's hedged replica dispatch.

    A dispatch hedges when its injected-clock elapsed time exceeds
    ``multiplier`` x the bucket's ``quantile`` latency (once
    ``min_samples`` observations back the estimate; ``min_budget``
    until then, and always a floor) AND some participating shard is
    suspect — re-dispatching with no straggler to route around would
    repeat the same plan.
    """

    quantile: float = 0.95     # per-bucket latency quantile the budget derives from
    multiplier: float = 2.0    # budget = multiplier * quantile latency
    min_samples: int = 8       # observations before the quantile is trusted
    min_budget: float = 0.0    # seconds; the budget floor / cold-start budget

    def __post_init__(self):
        expects(0.0 < self.quantile <= 1.0,
                "quantile must be in (0, 1], got %s", self.quantile)
        expects(self.multiplier >= 1.0,
                "multiplier must be >= 1, got %s", self.multiplier)
        expects(self.min_samples >= 1,
                "min_samples must be >= 1, got %s", self.min_samples)
        expects(self.min_budget >= 0.0,
                "min_budget must be >= 0, got %s", self.min_budget)

    def budget(self, quantile_latency: Optional[float]) -> Optional[float]:
        """The hedge budget in seconds given the bucket's observed
        quantile latency (None = not enough samples yet -> the floor,
        or None when no floor is set either: the hedge stays unarmed)."""
        if quantile_latency is None:
            return self.min_budget if self.min_budget > 0.0 else None
        return max(self.multiplier * quantile_latency, self.min_budget)


class HedgeStats:
    """Host-side hedge counters.

    ``fired`` — hedge dispatches issued; ``won`` — hedges whose answer
    was faster than the primary's (by the injected clock) and was
    served; ``suppressed`` — budget exceeded but no suspect participant
    to route around (the hedge would replay the same plan).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.fired = 0
        self.won = 0
        self.suppressed = 0

    def record(self, fired: bool = False, won: bool = False,
               suppressed: bool = False) -> None:
        with self._lock:
            self.fired += int(fired)
            self.won += int(won)
            self.suppressed += int(suppressed)

    def snapshot(self) -> dict:
        with self._lock:
            return {"fired": self.fired, "won": self.won,
                    "suppressed": self.suppressed}

    def reset(self) -> None:
        with self._lock:
            self.fired = 0
            self.won = 0
            self.suppressed = 0

    def __repr__(self) -> str:
        s = self.snapshot()
        return ("HedgeStats(fired=%d, won=%d, suppressed=%d)"
                % (s["fired"], s["won"], s["suppressed"]))
