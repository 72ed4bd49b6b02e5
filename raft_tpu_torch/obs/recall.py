"""Online recall probe: shadow exact scans of sampled served queries.

Port of ``raft_tpu/obs/recall.py``. Offline recall sweeps pin
``n_probes`` against a frozen index, but a mutating index (extend /
delete / upsert / compaction) drifts: the centroids the coarse quantizer
routes by stop matching the data, and realized recall decays while every
latency metric stays green. :class:`RecallProbe` measures it without
touching the hot path:

* **Deterministic sampling**: a seeded ``random.Random`` stream decides
  per served request (arrival order is the only input), so a replayed
  request stream probes the same requests in both packages; the rate and
  a bounded pending queue (that drops, never blocks) limit it.
* **Off the hot path**: ``offer()`` (called by the scheduler at request
  completion) only enqueues; the exact scan runs in :meth:`run_pending`,
  on the cadence the operator owns. Samples whose index epoch moved
  before the scan are dropped as stale.
* **Shape-stable ground truth**: sampled queries are re-padded to their
  serving bucket before the exact scan, so the truth searches run at the
  bucket grid's shapes.
* **Drift flag**: windowed realized recall per bucket; when a bucket
  with enough samples falls below ``drift_below``, :attr:`drift` trips:
  the query-aware signal ``Compactor(drift_signal=...)`` consumes.

Ground truth: brute force is its own truth (scoring it checks the
serving pipeline end to end); IVF-Flat and IVF-PQ take a full-probe
search (``n_probes = n_lists``: exact over the survivors for IVF-Flat,
code-space truth for IVF-PQ); ``truth_fn`` overrides both.

Over a sharded searcher fronted by a ``BatchScheduler`` (rank 0; the
other ranks run ``BatchScheduler.follow``), the sampling stream and the
pending queue are rank 0's, and each truth search is collective: it goes
through the scheduler's command channel (rank 0 broadcasts the padded
queries and ``k``), so every rank runs the same search in order with the
batches. Call :meth:`run_pending` on rank 0 from the thread that pumps
the scheduler.
"""

from __future__ import annotations

import random
import threading
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from raft_tpu_torch.core.error import expects

__all__ = ["RecallProbe"]

BucketKey = Tuple[int, int]


class RecallProbe:
    """Samples served results and estimates realized recall per bucket.

    Wire it in with ``BatchScheduler(..., probe=probe)`` — the scheduler
    offers every non-degraded completion — and give ``run_pending`` a
    cadence (a background thread, the Compactor loop, or test code).
    With ``registry=`` the estimates publish as gauges on every scrape.
    """

    def __init__(self, searcher, *, rate: float = 0.01, seed: int = 0,
                 max_pending: int = 64, window: int = 512,
                 min_samples: int = 16,
                 drift_below: Optional[float] = None,
                 registry=None,
                 truth_fn: Optional[Callable] = None):
        expects(0.0 <= rate <= 1.0, "rate must be in [0, 1], got %s", rate)
        expects(max_pending >= 1, "max_pending must be >= 1")
        expects(window >= 1, "window must be >= 1")
        expects(min_samples >= 1, "min_samples must be >= 1")
        expects(drift_below is None or 0.0 < drift_below <= 1.0,
                "drift_below must be in (0, 1], got %s", drift_below)
        self.searcher = searcher
        self.rate = rate
        self.min_samples = min_samples
        self.drift_below = drift_below
        self._truth_fn = truth_fn
        self._window = window
        self._max_pending = max_pending
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._pending: deque = deque()
        self._recalls: Dict[BucketKey, deque] = {}
        self._drift = False
        # Lifetime accounting (all host ints; scrape surface).
        self.offered = 0
        self.sampled = 0
        self.scanned = 0
        self.dropped = 0
        self.stale = 0
        self._unsub = None
        if registry is not None:
            self._estimate = registry.gauge(
                "raft_recall_estimate",
                "windowed realized recall per serving bucket",
                labels=("bucket",))
            self._samples_g = registry.gauge(
                "raft_recall_samples",
                "recall sample-window size per bucket (confidence)",
                labels=("bucket",))
            self._drift_g = registry.gauge(
                "raft_recall_drift",
                "1 when any confident bucket sits below drift_below")
            self._counter_metrics = tuple(
                (c, registry.counter("raft_recall_%s_total" % c,
                                     "recall probe %s" % c))
                for c in ("offered", "sampled", "scanned", "dropped",
                          "stale"))
            self._unsub = registry.register_collector(self.publish)
        else:
            self._estimate = self._samples_g = self._drift_g = None
            self._counter_metrics = ()

    # -- hot path (scheduler thread) ---------------------------------------
    def offer(self, queries, k: int, indices, bucket: BucketKey,
              epoch: int) -> bool:
        """Maybe-sample one served request (cheap: one PRNG draw + one
        bounded append; the exact scan happens in :meth:`run_pending`).
        Returns whether the request was sampled."""
        with self._lock:
            self.offered += 1
            if self.rate <= 0.0 or self._rng.random() >= self.rate:
                return False
            if len(self._pending) >= self._max_pending:
                self.dropped += 1      # rate limit: drop, never block
                return False
            self.sampled += 1
            self._pending.append((queries, int(k), indices,
                                  (int(bucket[0]), int(bucket[1])),
                                  int(epoch)))
            return True

    # -- shadow lane -------------------------------------------------------
    def run_pending(self, max_items: Optional[int] = None) -> int:
        """Exact-scan up to ``max_items`` queued samples (all by
        default); updates the per-bucket recall windows and the drift
        flag.  Runs on the CALLER's thread — point a background cadence
        at it, never the serving threads.  Returns samples scored."""
        done = 0
        while max_items is None or done < max_items:
            with self._lock:
                if not self._pending:
                    break
                queries, k, indices, bucket, epoch = \
                    self._pending.popleft()
            if epoch != self.searcher.epoch:
                with self._lock:
                    self.stale += 1     # index moved: contents differ
                continue
            scores = self._score(queries, k, indices, bucket)
            with self._lock:
                win = self._recalls.get(bucket)
                if win is None:
                    win = self._recalls[bucket] = \
                        deque(maxlen=self._window)
                win.extend(scores)
                self.scanned += 1
            done += 1
        self._refresh_drift()
        return done

    def _score(self, queries, k, indices, bucket):
        """Per-query recall@k of the served ids against the exact top-k,
        computed at the request's serving bucket shape."""
        from raft_tpu_torch.comms.topk_merge import merge_dispatch_stats
        from raft_tpu_torch.parallel.routing import routing_stats
        from raft_tpu_torch.serve.bucketing import pad_queries

        qb, kb = bucket
        rows = queries.shape[0]
        padded = pad_queries(queries, qb) if rows < qb else queries
        # Shadow scans must not count as serving traffic on the merge and
        # routing scrapes (and the routed probe loads feed the balancer).
        with merge_dispatch_stats.suppress(), routing_stats.suppress():
            truth = np.asarray(self._truth(padded, kb))[:rows, :k]
        served = np.asarray(indices)[:, :k]
        # PAD_ID (-1) fills short answers (k > live candidates); a
        # pad-vs-pad match is not a recalled neighbor.
        return [float(np.intersect1d(served[r][served[r] >= 0],
                                     truth[r][truth[r] >= 0]).size) / k
                for r in range(rows)]

    def _truth(self, queries, k):
        if self._truth_fn is not None:
            return self._truth_fn(queries, k)
        front = getattr(self.searcher, "_front", None)
        if front is not None:
            front._command_truth(queries, k)    # the followers join
        return _truth_search(self.searcher, queries, k)

    # -- estimates ---------------------------------------------------------
    def recall(self, bucket: Optional[BucketKey] = None) -> float:
        """Windowed mean realized recall for one bucket (or pooled over
        all buckets); NaN before any sample landed."""
        with self._lock:
            if bucket is not None:
                win = self._recalls.get((int(bucket[0]), int(bucket[1])))
                vals = list(win) if win else []
            else:
                vals = [v for win in self._recalls.values() for v in win]
        return float(np.mean(vals)) if vals else float("nan")

    def sample_count(self, bucket: Optional[BucketKey] = None) -> int:
        with self._lock:
            if bucket is not None:
                win = self._recalls.get((int(bucket[0]), int(bucket[1])))
                return len(win) if win else 0
            return sum(len(w) for w in self._recalls.values())

    def _refresh_drift(self) -> None:
        if self.drift_below is None:
            return
        with self._lock:
            tripped = False
            for win in self._recalls.values():
                if len(win) >= self.min_samples and \
                        float(np.mean(win)) < self.drift_below:
                    tripped = True
                    break
            self._drift = tripped

    @property
    def drift(self) -> bool:
        """True while any confident bucket's realized recall sits below
        ``drift_below`` — the query-aware compaction trigger
        (``Compactor(drift_signal=lambda: probe.drift)``)."""
        with self._lock:
            return self._drift

    def snapshot(self) -> dict:
        """Plain-dict scrape of the probe state."""
        with self._lock:
            buckets = {
                "%dx%d" % key: {"recall": float(np.mean(win)),
                                "samples": len(win)}
                for key, win in sorted(self._recalls.items()) if win}
            return {"buckets": buckets, "drift": self._drift,
                    "offered": self.offered, "sampled": self.sampled,
                    "scanned": self.scanned, "dropped": self.dropped,
                    "stale": self.stale,
                    "pending": len(self._pending)}

    # -- registry feed -----------------------------------------------------
    def publish(self) -> None:
        """Collector hook: refresh the registry gauges (registered
        automatically when ``registry=`` was given)."""
        if self._estimate is None:
            return
        snap = self.snapshot()
        for bucket, row in snap["buckets"].items():
            self._estimate.set(row["recall"], bucket=bucket)
            self._samples_g.set(row["samples"], bucket=bucket)
        self._drift_g.set(1.0 if snap["drift"] else 0.0)
        for c, metric in self._counter_metrics:
            metric.set_total(snap[c])

    def close(self) -> None:
        """Unhook from the registry (idempotent)."""
        if self._unsub is not None:
            self._unsub()
            self._unsub = None

    def __repr__(self) -> str:
        return ("RecallProbe(rate=%s, scanned=%d, drift=%s)"
                % (self.rate, self.scanned, self.drift))


def _truth_search(searcher, queries, k: int) -> np.ndarray:
    """The ground-truth ids of ``queries`` on ``searcher``'s current
    index (module docstring); collective over a sharded searcher (the
    followers of a front rank call it from ``BatchScheduler.follow``)."""
    if searcher.kind == "brute_force":
        return searcher.search(queries, k, degraded=False).indices
    import dataclasses

    from raft_tpu_torch.serve.searcher import Searcher

    # A transient facade over the CURRENT index snapshot keeps the probe
    # apart from serving state: no shared caches, hooks or locks.
    sp = dataclasses.replace(
        searcher._params, n_probes=int(searcher._index.centers.shape[0]))
    exact = Searcher(searcher.kind, mesh=searcher.mesh,
                     index=searcher._index, search_params=sp,
                     merge_engine=searcher.merge_engine)
    return exact.search(queries, k, degraded=False).indices
