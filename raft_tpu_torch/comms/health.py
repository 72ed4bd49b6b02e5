"""Shard liveness registry for degraded-mode serving.

Port of ``raft_tpu/comms/health.py``, line for line: host numpy and
threading, with no device state. :class:`ShardHealth` is a per-rank
liveness mask fed by ``sync_stream`` outcomes (or explicit
``mark_dead``) that the sharded search entry points consume as a
``live_mask``: dead shards' candidates are neutralized to merge-padding
sentinels and every query reports the ``coverage`` fraction of live
database rows actually searched, so a serving layer chooses fail-hard or
serve-degraded.

Beyond live and dead, a third, latency-fed state sits between them:
SUSPECT. A suspect rank still serves (it holds valid data; demoting it
to dead would cost coverage). Suspicion is promoted from per-rank
dispatch-latency observations (:meth:`ShardHealth.observe_latency`: EWMA
and a windowed quantile on the injected clock, the threshold a multiple
of the fleet median) and, like dead, clears only through the explicit
:meth:`ShardHealth.mark_live` edge.

In the port each rank of a ``torch.distributed`` job holds its own
registry; a collective search uses rank 0's mask, broadcast with the call
(``parallel/degraded.check_live_mask``), so every rank neutralizes the
same shards.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from raft_tpu_torch.comms.comms import StatusT
from raft_tpu_torch.core.error import expects


@dataclass(frozen=True)
class LatencyPolicy:
    """Knobs for latency-based SUSPECT promotion.

    A rank is promoted to SUSPECT when BOTH its latency EWMA and its
    windowed ``quantile`` exceed ``multiplier`` x the fleet median of
    per-rank EWMAs (and ``floor``) — the two-signal AND keeps one
    outlier sample (quantile) or a slow ramp (EWMA) from tripping alone.
    ``min_samples`` gates promotion until the window is confident.
    """

    alpha: float = 0.25          # EWMA smoothing weight of the newest sample
    window: int = 64             # per-rank sample window for the quantile
    quantile: float = 0.9        # windowed quantile compared to threshold
    multiplier: float = 3.0      # threshold = multiplier * fleet median EWMA
    min_samples: int = 8         # observations before a rank can be suspect
    floor: float = 0.0           # absolute seconds the threshold never dips below

    def __post_init__(self):
        expects(0.0 < self.alpha <= 1.0,
                "alpha must be in (0, 1], got %s", self.alpha)
        expects(self.window >= 1, "window must be >= 1, got %s", self.window)
        expects(0.0 < self.quantile <= 1.0,
                "quantile must be in (0, 1], got %s", self.quantile)
        expects(self.multiplier > 1.0,
                "multiplier must be > 1, got %s", self.multiplier)
        expects(self.min_samples >= 1,
                "min_samples must be >= 1, got %s", self.min_samples)
        expects(self.floor >= 0.0, "floor must be >= 0, got %s", self.floor)


class ShardHealth:
    """Per-rank liveness over one mesh axis.

    A rank is LIVE until ``failure_threshold`` *consecutive* observed
    failures (ERROR or ABORT from :meth:`record`) or an explicit
    :meth:`mark_dead`. SUCCESS observations reset a live rank's failure
    streak but never auto-revive a dead rank — a rank that went dead
    stays dead until an operator (or a recovery path that re-validated
    the shard, e.g. serve/recovery.RecoveryProber after N clean shadow
    probes) calls :meth:`mark_live`; flapping ranks must not silently
    rejoin mid-serve with stale data.

    With ``latency=LatencyPolicy(...)`` a live rank additionally becomes
    SUSPECT when :meth:`observe_latency` sees it sustain latencies far
    above the fleet (class docstring of :class:`LatencyPolicy`).
    Suspect is a sub-state of live: ``live_mask`` still includes the
    rank (its data is valid — coverage must not drop), plain
    ``add_listener`` subscribers do NOT fire on live<->suspect edges
    (a promotion watcher must not fail over for a slow-but-correct
    shard), and only :meth:`mark_live` clears it — the same explicit,
    observed re-admission edge dead ranks take.

    Thread-safe: serving layers poke it from request threads while a
    prober thread feeds sync_stream outcomes.
    """

    def __init__(self, n_ranks: int, failure_threshold: int = 1,
                 latency: Optional[LatencyPolicy] = None):
        expects(n_ranks >= 1, "need at least one rank, got %s", n_ranks)
        expects(failure_threshold >= 1,
                "failure_threshold must be >= 1, got %s", failure_threshold)
        self.n_ranks = n_ranks
        self.failure_threshold = failure_threshold
        self.latency = latency
        self._lock = threading.Lock()
        self._live = np.ones(n_ranks, dtype=bool)
        self._suspect = np.zeros(n_ranks, dtype=bool)
        self._streak = np.zeros(n_ranks, dtype=np.int64)
        self._ewma = np.full(n_ranks, np.nan)
        win = latency.window if latency is not None else 1
        self._lat_windows = [deque(maxlen=win) for _ in range(n_ranks)]
        self._listeners: list = []
        self._state_listeners: list = []

    # -- events -----------------------------------------------------------
    def add_listener(self, cb) -> Callable[[], None]:
        """Subscribe ``cb(rank, live)`` to live/dead TRANSITIONS (not
        every observation) — how the metrics layer
        (``obs.registry.ShardHealthCollector``) counts flaps that a
        gauge scraped between die and revive would miss.  Suspect edges
        are invisible here (suspect ranks are still live — a promotion
        watcher must not trip); use :meth:`add_state_listener` for the
        full three-state feed.  Returns an idempotent unsubscribe
        callable (the ``Searcher.add_invalidation_hook`` contract)."""
        with self._lock:
            self._listeners.append(cb)

        def remove() -> None:
            with self._lock:
                try:
                    self._listeners.remove(cb)
                except ValueError:
                    pass

        return remove

    def add_state_listener(self, cb) -> Callable[[], None]:
        """Subscribe ``cb(rank, state)`` to EVERY state transition,
        ``state`` one of ``"live"`` / ``"suspect"`` / ``"dead"`` — the
        collector/breaker feed that sees suspect edges the binary
        listener channel hides.  Returns an idempotent unsubscribe."""
        with self._lock:
            self._state_listeners.append(cb)

        def remove() -> None:
            with self._lock:
                try:
                    self._state_listeners.remove(cb)
                except ValueError:
                    pass

        return remove

    def watch(self, rank: int, on_dead: Optional[Callable[[], None]] = None,
              on_live: Optional[Callable[[], None]] = None,
              on_suspect: Optional[Callable[[], None]] = None
              ) -> Callable[[], None]:
        """Subscribe per-edge callbacks for ONE rank: ``on_dead()`` on
        its live->dead transition (the promotion trigger —
        ``lifecycle.wal.PromotionManager`` arms a follower with it),
        ``on_live()`` on explicit re-admission via :meth:`mark_live`
        (how the breaker, collectors and a PromotionManager observe
        recovery), ``on_suspect()`` on latency-fed suspicion.  A dead
        rank never auto-revives, so ``on_dead`` still cannot un-happen
        spontaneously.  Returns the idempotent unsubscribe callable."""
        self._check_rank(rank)
        expects(on_dead is not None or on_live is not None
                or on_suspect is not None,
                "watch(%s) needs at least one callback", rank)

        def cb(r: int, state: str) -> None:
            if r != rank:
                return
            if state == "dead" and on_dead is not None:
                on_dead()
            elif state == "live" and on_live is not None:
                on_live()
            elif state == "suspect" and on_suspect is not None:
                on_suspect()

        return self.add_state_listener(cb)

    def _fire(self, rank: int, live: Optional[bool], state: str) -> None:
        """Invoke listeners OUTSIDE the lock (a listener may take its
        own lock; holding ours across foreign code invites inversions).
        ``live=None`` means the binary channel stays silent (suspect
        edges); callers pass the transition they observed inside the
        lock."""
        with self._lock:
            listeners = list(self._listeners) if live is not None else []
            state_listeners = list(self._state_listeners)
        for cb in listeners:
            cb(rank, live)
        for cb in state_listeners:
            cb(rank, state)

    # -- feeds ------------------------------------------------------------
    def record(self, rank: int, status: StatusT) -> bool:
        """Feed one sync_stream outcome for ``rank``; returns the rank's
        (possibly updated) liveness. ERROR and ABORT both count toward
        the failure streak: ABORT is cooperative cancellation — the
        shard's in-flight work is gone either way."""
        self._check_rank(rank)
        died = False
        with self._lock:
            if status == StatusT.SUCCESS:
                if self._live[rank]:
                    self._streak[rank] = 0
                alive = bool(self._live[rank])
            else:
                self._streak[rank] += 1
                if self._streak[rank] >= self.failure_threshold \
                        and self._live[rank]:
                    self._live[rank] = False
                    self._suspect[rank] = False
                    died = True
                alive = bool(self._live[rank])
        if died:
            self._fire(rank, False, "dead")
        return alive

    def observe_latency(self, rank: int, seconds: float) -> bool:
        """Feed one dispatch-latency observation (injected-clock
        seconds) for ``rank``; returns whether the rank is now suspect.
        Promotion needs ``latency=`` configured, ``min_samples``
        observations, and BOTH the rank's EWMA and its windowed
        quantile above ``multiplier`` x the fleet median of per-rank
        EWMAs (see :class:`LatencyPolicy`).  Dead ranks are ignored;
        a suspect rank stays suspect until :meth:`mark_live`."""
        self._check_rank(rank)
        expects(seconds >= 0.0, "latency must be >= 0, got %s", seconds)
        pol = self.latency
        promoted = False
        with self._lock:
            if not self._live[rank]:
                return False
            win = self._lat_windows[rank]
            win.append(float(seconds))
            prev = self._ewma[rank]
            if np.isnan(prev):
                self._ewma[rank] = float(seconds)
            elif pol is not None:
                self._ewma[rank] = (pol.alpha * float(seconds)
                                    + (1.0 - pol.alpha) * prev)
            else:
                self._ewma[rank] = 0.5 * float(seconds) + 0.5 * prev
            if pol is None or self._suspect[rank]:
                return bool(self._suspect[rank])
            if len(win) < pol.min_samples:
                return False
            observed = self._ewma[~np.isnan(self._ewma) & self._live]
            if observed.size < 2:
                return False    # no fleet to be slower than
            threshold = max(pol.multiplier * float(np.median(observed)),
                            pol.floor)
            samples = sorted(win)
            q_rank = min(len(samples) - 1,
                         max(0, int(round(pol.quantile
                                          * (len(samples) - 1)))))
            if self._ewma[rank] > threshold \
                    and samples[q_rank] > threshold:
                self._suspect[rank] = True
                promoted = True
        if promoted:
            self._fire(rank, None, "suspect")
        return promoted or self.is_suspect(rank)

    def mark_dead(self, rank: int) -> None:
        """Operator/chaos override: kill ``rank`` immediately (a dead
        rank's suspicion is moot — dead overrides suspect)."""
        self._check_rank(rank)
        with self._lock:
            was_live = bool(self._live[rank])
            self._live[rank] = False
            self._suspect[rank] = False
            self._streak[rank] = self.failure_threshold
        if was_live:
            self._fire(rank, False, "dead")

    def mark_suspect(self, rank: int) -> None:
        """Operator/test override: flag a LIVE ``rank`` suspect without
        waiting for latency evidence (dead ranks are already past
        suspicion — the call is a no-op for them)."""
        self._check_rank(rank)
        with self._lock:
            promote = bool(self._live[rank]) and not self._suspect[rank]
            if promote:
                self._suspect[rank] = True
        if promote:
            self._fire(rank, None, "suspect")

    def mark_live(self, rank: int) -> None:
        """Explicit revive / un-suspect (after the shard re-validated,
        e.g. reload or the RecoveryProber's N clean shadow probes).
        Also resets the rank's latency history: the samples that
        convicted it describe the fault, not the recovered shard — kept,
        they would re-promote it instantly."""
        self._check_rank(rank)
        with self._lock:
            was_degraded = (not bool(self._live[rank])
                            or bool(self._suspect[rank]))
            was_dead = not bool(self._live[rank])
            self._live[rank] = True
            self._suspect[rank] = False
            self._streak[rank] = 0
            self._ewma[rank] = np.nan
            self._lat_windows[rank].clear()
        if was_degraded:
            self._fire(rank, True if was_dead else None, "live")

    # -- views ------------------------------------------------------------
    @property
    def live_mask(self) -> np.ndarray:
        """Copy of the per-rank liveness mask (bool (n_ranks,)) — the
        ``live_mask`` operand of the sharded search entry points.
        SUSPECT ranks are still True here (their data is valid and
        coverage must not drop); route around them with
        :attr:`suspect_mask`.

        Row-sharded searches consume it as a collective-side operand
        (dead shards' candidates neutralize to merge sentinels); the
        routed ``placement="list"`` searches take it as a routing input
        (a dead rank receives no queries)."""
        with self._lock:
            return self._live.copy()

    @property
    def suspect_mask(self) -> np.ndarray:
        """Copy of the per-rank suspicion mask (bool (n_ranks,)): the
        routing input that steers a suspect primary onto its replica
        under the list placement (``parallel.routing.plan_route``)."""
        with self._lock:
            return self._suspect.copy()

    def is_live(self, rank: int) -> bool:
        self._check_rank(rank)
        with self._lock:
            return bool(self._live[rank])

    def is_suspect(self, rank: int) -> bool:
        self._check_rank(rank)
        with self._lock:
            return bool(self._suspect[rank])

    def state(self, rank: int) -> str:
        """``"live"`` / ``"suspect"`` / ``"dead"`` for one rank."""
        self._check_rank(rank)
        with self._lock:
            if not self._live[rank]:
                return "dead"
            return "suspect" if self._suspect[rank] else "live"

    def latency_ewma(self, rank: int) -> float:
        """The rank's smoothed dispatch latency (NaN before any
        observation) — scrape surface for the health collector."""
        self._check_rank(rank)
        with self._lock:
            return float(self._ewma[rank])

    def n_live(self) -> int:
        with self._lock:
            return int(self._live.sum())

    def n_suspect(self) -> int:
        with self._lock:
            return int(self._suspect.sum())

    def coverage(self) -> float:
        """Live fraction of ranks — the a-priori coverage bound when all
        shards hold equal row counts (the per-query value the searches
        report refines this by actually-probed rows)."""
        with self._lock:
            return float(self._live.sum()) / self.n_ranks

    def all_live(self) -> bool:
        with self._lock:
            return bool(self._live.all())

    def _check_rank(self, rank: int) -> None:
        expects(0 <= rank < self.n_ranks,
                "rank %s out of range [0, %s)", rank, self.n_ranks)

    def __repr__(self) -> str:
        return (f"ShardHealth(n_ranks={self.n_ranks}, "
                f"live={self.live_mask.tolist()}, "
                f"suspect={self.suspect_mask.tolist()})")


def checked_sync(comms, health: Optional[ShardHealth], rank: int,
                 *arrays) -> StatusT:
    """``sync_stream`` + health feed in one call: the idiom a host-side
    control loop uses after launching a sharded step —
    ``status = checked_sync(comms, health, r, out)``. ``health=None``
    degrades to a plain sync_stream."""
    status = comms.sync_stream(*arrays)
    if health is not None:
        health.record(rank, status)
    return status
