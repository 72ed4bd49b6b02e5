"""Circuit-breaker recovery: shadow-probe degraded shards back to life.

Port of ``raft_tpu/serve/recovery.py``. A dead or suspect shard's breaker
is *open* (routing already steers serving traffic around it); the
:class:`RecoveryProber` sends it shadow probes off the hot path
(``Searcher.shadow_probe``: suppressed telemetry, no health feedback, no
caller traffic), and only after ``clean_threshold`` CONSECUTIVE clean
probes does it *close* the breaker with ``health.mark_live``, an
explicit edge on the health's listener feed.

Flap safety: any probe failure (an exception, or a probe slower than
``budget``) resets the streak to zero, and so does a fresh dead or
suspect transition between probing passes (the prober subscribes to the
state-listener feed). A flapping shard never serves before it has proven
``clean_threshold`` consecutive clean probes.

Over a sharded searcher (SPMD: every rank holds its own ``ShardHealth``
and prober) :meth:`RecoveryProber.step` is collective: rank 0's view of
which ranks are degraded and of every streak is broadcast first, each
probe is collective (``shadow_probe`` agrees a failure on any rank and
returns rank 0's elapsed time), so every rank reaches the same verdicts
and applies the same ``mark_live`` to its own ``ShardHealth``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import logger

__all__ = ["RecoveryProber"]


class RecoveryProber:
    """Re-admit dead / suspect shards after consecutive clean shadow
    probes.

    Step-driven like the BatchScheduler: ``step()`` runs one probing pass
    over every degraded rank (the caller's loop owns the cadence; the
    prober never sleeps and never reads wall time: elapsed comes from the
    Searcher's injected clock through :meth:`Searcher.shadow_probe`).

    Breaker states per rank (``state(rank)`` / ``snapshot()``):

    * ``"closed"``: live and not suspect; traffic flows.
    * ``"open"``: degraded, with no clean-probe credit.
    * ``"half_open"``: degraded, mid-streak: some clean probes passed,
      fewer than ``clean_threshold``.
    """

    def __init__(self, searcher, health, queries, k: int = 4, *,
                 clean_threshold: int = 3,
                 budget: Optional[float] = None):
        expects(clean_threshold >= 1,
                "clean_threshold must be >= 1, got %s", clean_threshold)
        expects(budget is None or budget > 0.0,
                "budget must be positive seconds, got %s", budget)
        q = np.ascontiguousarray(np.asarray(queries, dtype=np.float32))
        expects(q.ndim == 2 and q.shape[0] >= 1,
                "probe queries must be (n, dim), got %s", q.shape)
        self.searcher = searcher
        self.health = health
        self.queries = q
        self.k = int(k)
        self.clean_threshold = int(clean_threshold)
        self.budget = budget
        self._streak: Dict[int, int] = {}
        self.probes_sent = 0
        self.probes_clean = 0
        self.readmissions = 0
        # A fresh degradation between probing passes voids any streak.
        self._unsub = health.add_state_listener(self._on_transition)

    def _on_transition(self, rank: int, state: str) -> None:
        if state in ("dead", "suspect"):
            self._streak[rank] = 0

    def _degraded(self) -> List[int]:
        """The ranks to probe this pass. Over a sharded searcher, rank 0's
        degraded ranks and streaks, adopted by every rank (one
        broadcast)."""
        n = self.health.n_ranks
        mine = [r for r in range(n) if self.health.state(r) != "live"]
        mesh = getattr(self.searcher, "mesh", None)
        if mesh is None:
            return mine
        from raft_tpu_torch.comms.comms import Comms

        view = torch.zeros(2 * n, dtype=torch.int64)
        if mesh.rank == 0:
            view[mine] = 1
            view[n:] = torch.tensor([self._streak.get(r, 0)
                                     for r in range(n)])
        view = Comms(mesh).bcast(view).tolist()
        self._streak = {r: view[n + r] for r in range(n) if view[n + r]}
        return [r for r in range(n) if view[r]]

    # -- probing -----------------------------------------------------------
    def step(self) -> List[int]:
        """One probing pass: shadow-probe every degraded rank once and
        re-admit those whose clean streak reaches ``clean_threshold``.
        Returns the ranks re-admitted this pass. Collective over a
        sharded searcher."""
        readmitted: List[int] = []
        for rank in self._degraded():
            self.probes_sent += 1
            try:
                elapsed = self.searcher.shadow_probe(rank, self.queries,
                                                     self.k)
            except Exception as err:
                self._streak[rank] = 0
                logger.trace("recovery probe of rank %s failed: %r", rank,
                             err)
                continue
            if self.budget is not None and elapsed > self.budget:
                self._streak[rank] = 0   # a slow probe is not clean
                logger.trace("recovery probe of rank %s too slow: %.6fs > "
                             "budget %.6fs", rank, elapsed, self.budget)
                continue
            self.probes_clean += 1
            self._streak[rank] = self._streak.get(rank, 0) + 1
            if self._streak[rank] >= self.clean_threshold:
                # The only automatic mark_live, and an explicit edge:
                # listeners fire, and mark_live resets the rank's latency
                # history so a stale EWMA cannot re-suspect it.
                self.health.mark_live(rank)
                self._streak[rank] = 0
                self.readmissions += 1
                readmitted.append(rank)
                logger.info("recovery: rank %s re-admitted after %s "
                            "consecutive clean probes", rank,
                            self.clean_threshold)
        return readmitted

    # -- views -------------------------------------------------------------
    def state(self, rank: int) -> str:
        """The rank's breaker state: closed / open / half_open."""
        if self.health.state(rank) == "live":
            return "closed"
        return "half_open" if self._streak.get(rank, 0) > 0 else "open"

    def snapshot(self) -> dict:
        states = {r: self.state(r) for r in range(self.health.n_ranks)}
        return {
            "states": states,
            "streaks": {r: self._streak.get(r, 0)
                        for r in range(self.health.n_ranks)},
            "probes_sent": self.probes_sent,
            "probes_clean": self.probes_clean,
            "readmissions": self.readmissions,
        }

    def close(self) -> None:
        """Unsubscribe from the health feed. Idempotent."""
        if self._unsub is not None:
            self._unsub()
            self._unsub = None

    def __repr__(self) -> str:
        s = self.snapshot()
        n_open = sum(1 for v in s["states"].values() if v != "closed")
        return ("RecoveryProber(degraded=%d, probes=%d/%d clean, "
                "readmissions=%d)" % (n_open, s["probes_clean"],
                                      s["probes_sent"], s["readmissions"]))
