"""Serving-runtime observability: per-bucket counters + compile counting.

Port of ``raft_tpu/serve/stats.py``. :class:`ServeStats` is the
reference's scrape surface as is: per-shape-bucket counters (queued,
batched, padded-slot waste, cache hits, latency quantiles) exposed as a
plain dict.

Two deliberate disciplines, matching ``core/retry.py``:

* **Injectable clock**: latencies are differences of the scheduler's
  injected monotonic clock, never wall time, so tests assert exact
  quantiles.
* **Compile events are observed, not inferred**: the port compiles
  nothing per shape (no ``torch.compile``, no CUDA graphs); what it
  compiles is its kernels, one ``nvcc`` run per source, loaded once per
  process. :class:`CompileCounter` listens to ``ops/_build.py`` for those
  builds and first loads, so the steady-state contract, "no kernel build
  or library load while serving in-grid traffic", is measured.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Tuple

# One bucket key everywhere: (padded query rows, padded k).
BucketKey = Tuple[int, int]

#: Latency samples retained per bucket (ring buffer — a serving process
#: must not grow without bound; p50/p99 over the window is the standard
#: scrape contract).
LATENCY_WINDOW = 4096

_COUNTERS = ("requests", "queued", "batches", "batched_requests",
             "padded_slots", "batched_rows", "cache_hits", "cache_misses",
             "shed", "deadline_misses", "degraded_responses", "failed",
             "out_of_grid",
             # Degradation-ladder quality classes (docs/fault_tolerance.md
             # §ladder): every completed request lands in exactly one.
             "served_full", "served_reduced", "served_brownout",
             # Answers whose n_probes was shrunk by the ladder; queued
             # low-priority requests evicted for a higher-priority
             # arrival (evictions also count toward "shed").
             "probes_shrunk", "priority_evictions")


class ServeStats:
    """Per-bucket serving counters, exposed as a plain dict for scraping.

    Thread-safe (request threads submit while one thread pumps).
    Keying convention: per-REQUEST counters (requests, queued, shed,
    cache hits/misses, deadline_misses, degraded_responses, latency)
    key on the request's own bucket ``grid.bucket_for(rows, k)`` — the
    same key at submit and completion, so per-bucket rate/SLO math is
    consistent; batch-SHAPE counters (batches, batched_requests,
    batched_rows, padded_slots) key on the dispatched padded shape.
    Out-of-grid requests use their raw ``(rows, k)``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[BucketKey, Dict[str, float]] = {}
        self._latency: Dict[BucketKey, deque] = {}
        self.compile_events = 0

    def _b(self, bucket: BucketKey) -> Dict[str, float]:
        if bucket not in self._buckets:
            self._buckets[bucket] = {c: 0 for c in _COUNTERS}
            self._latency[bucket] = deque(maxlen=LATENCY_WINDOW)
        return self._buckets[bucket]

    def count(self, bucket: BucketKey, counter: str, n: int = 1) -> None:
        """Add ``n`` to one of the per-bucket counters."""
        with self._lock:
            b = self._b(bucket)
            if counter not in b:
                raise KeyError(f"unknown counter {counter!r} "
                               f"(one of {_COUNTERS})")
            b[counter] += n

    def observe_latency(self, bucket: BucketKey, seconds: float) -> None:
        """Record one request's submit→complete latency (injected-clock
        difference)."""
        with self._lock:
            self._b(bucket)
            self._latency[bucket].append(float(seconds))

    def record_compile(self, n: int = 1) -> None:
        with self._lock:
            self.compile_events += n

    def latency_quantile(self, bucket: BucketKey, q: float,
                         min_samples: int = 1) -> Optional[float]:
        """Windowed nearest-rank latency quantile for one bucket, or
        ``None`` before ``min_samples`` observations landed — the
        per-bucket latency model the hedge budget and the degradation
        ladder consume (both must refuse to act on thin evidence)."""
        with self._lock:
            lat = self._latency.get(bucket)
            if lat is None or len(lat) < max(1, min_samples):
                return None
            return float(self._quantile(list(lat), q))

    def latency_samples(self, bucket: BucketKey) -> int:
        """Live sample-window size for one bucket."""
        with self._lock:
            lat = self._latency.get(bucket)
            return 0 if lat is None else len(lat)

    @staticmethod
    def _quantile(samples, q: float) -> float:
        """Nearest-rank quantile — deterministic for the injected-clock
        tests (no interpolation scheme ambiguity)."""
        if not samples:
            return 0.0
        s = sorted(samples)
        rank = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[rank]

    def snapshot(self) -> dict:
        """Plain-dict scrape of everything: per-bucket counters with
        p50/p90/p99/max latency plus the live sample-window size (so a
        scrape consumer can judge quantile confidence — a p99 over 7
        samples is a guess, over 4096 a measurement), plus the global
        compile-event count."""
        with self._lock:
            buckets = {}
            for key, ctrs in self._buckets.items():
                lat = list(self._latency[key])
                row = dict(ctrs)
                row["latency_p50"] = self._quantile(lat, 0.50)
                row["latency_p90"] = self._quantile(lat, 0.90)
                row["latency_p99"] = self._quantile(lat, 0.99)
                row["latency_max"] = max(lat) if lat else 0.0
                row["latency_samples"] = len(lat)
                buckets["%dx%d" % key] = row
            return {"buckets": buckets,
                    "compile_events": self.compile_events}


class CompileCounter:
    """Context manager counting kernel builds and first library loads.

    Registers on ``ops/_build.py``'s listener hook, which fires once per
    ``nvcc`` run and once per first load of a kernel library, so a test
    (or the warmup report) can assert "this request stream built and
    loaded exactly N kernels". Optionally feeds
    :meth:`ServeStats.record_compile` so the scrape surface carries the
    same count.
    """

    def __init__(self, stats: Optional[ServeStats] = None):
        self.count = 0
        self._stats = stats
        self._active = False
        self._remove = None

    def _listener(self, event: str, name: str) -> None:
        if self._active:
            self.count += 1
            if self._stats is not None:
                self._stats.record_compile()

    def __enter__(self) -> "CompileCounter":
        from raft_tpu_torch.ops import _build

        self._active = True
        self._remove = _build.add_listener(self._listener)
        return self

    def __exit__(self, *exc) -> None:
        self._active = False
        self._stats = None
        if self._remove is not None:
            self._remove()
            self._remove = None
