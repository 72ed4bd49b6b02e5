"""Metrics registry: one scrape surface over every serving island.

Port of ``raft_tpu/obs/registry.py`` (host Python, no device code). A
serving process needs the Prometheus client-registry shape: named
counters / gauges / histograms with labels, a text exposition a scraper
polls, and a JSON snapshot for tests and dashboards. The stack's
telemetry lives in islands (``ServeStats``, ``ShardHealth``,
``Compactor``, ``ResultCache``, the index epoch and tombstones, the merge
and routing dispatch counters, the write-ahead log, elastic resizes,
hedging, the recovery breaker, the degradation ladder); each
``*Collector`` below owns its metric names and refreshes them at scrape
time from its island's thread-safe snapshot, and the islands stay
unchanged on their hot paths.

Metric names, help texts, label sets and the exposition are the
reference's byte for byte (a dashboard reads either package's scrape),
so a help text may name the reference's terms: ``compile_events`` counts
what the port's ``CompileCounter`` counts (kernel builds).

Determinism: exposition orders metrics by registration, series by label
values, and label keys by the metric's declared label order; two scrapes
of the same state are bit-identical.

Collectors read host-side state only (no tensor on a card is touched by
a scrape). Over a sharded deployment each rank's islands are its own;
scrape the front rank (rank 0), whose scheduler, cache and stats are the
service's.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "ServeStatsCollector", "ShardHealthCollector", "CacheCollector",
    "CompactorCollector", "SearcherCollector", "MergeDispatchCollector",
    "RoutingCollector", "WalCollector", "ElasticCollector",
    "HedgeCollector", "BreakerCollector", "DegradeCollector",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default histogram buckets: serving latencies (seconds), log-spaced.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5)


def _fmt(v: float) -> str:
    """Deterministic Prometheus value formatting: integers without a
    decimal point, floats via ``repr`` (shortest round-trip form)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


class _Metric:
    """Base of one named metric family; series are keyed by the tuple of
    label VALUES in declared label order.  All series state is guarded
    by the owning registry's single lock (one scrape = one lock hold)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], float] = {}

    def _key(self, kw: dict) -> Tuple[str, ...]:
        if set(kw) != set(self.labels):
            raise ValueError(
                "metric %r takes labels %s, got %s"
                % (self.name, tuple(self.labels), tuple(sorted(kw))))
        return tuple(str(kw[name]) for name in self.labels)

    def _sorted_series(self):
        return sorted(self._series.items())

    def clear(self) -> None:
        """Drop every series (adapters that re-publish a full state per
        scrape use this so stale label sets don't linger)."""
        with self._lock:
            self._series.clear()

    # -- exposition (caller holds the registry lock) -----------------------
    def _expose(self, lines: List[str]) -> None:
        for key, value in self._sorted_series():
            lines.append("%s%s %s" % (self.name, self._labelstr(key),
                                      _fmt(value)))

    def _labelstr(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = ['%s="%s"' % (n, _escape(v))
                 for n, v in zip(self.labels, key)]
        if extra:
            parts.append(extra)
        return "{%s}" % ",".join(parts) if parts else ""

    def _snap(self) -> dict:
        return {"type": self.kind, "help": self.help,
                "labels": list(self.labels),
                "series": [{"labels": dict(zip(self.labels, key)),
                            "value": value}
                           for key, value in self._sorted_series()]}


class Counter(_Metric):
    """Monotonic cumulative count.  ``inc`` adds; ``set_total`` is the
    adapter feed — islands already keep their own cumulative totals, so
    a scrape copies the absolute value instead of replaying deltas."""

    kind = "counter"

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError("counter %r cannot decrease" % self.name)
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def set_total(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(v)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._series.get(key, 0.0)


class Gauge(_Metric):
    """Point-in-time value (may go up or down)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._series.get(key, 0.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (the Prometheus classic shape)."""

    kind = "histogram"

    def __init__(self, name, help, labels, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels, lock)
        b = tuple(sorted(float(x) for x in buckets))
        if len(set(b)) != len(b) or not b:
            raise ValueError("histogram buckets must be non-empty and "
                             "strictly ascending, got %s" % (buckets,))
        self.buckets = b

    def observe(self, v: float, **labels) -> None:
        key = self._key(labels)
        v = float(v)
        with self._lock:
            row = self._series.get(key)
            if row is None:
                row = self._series[key] = \
                    [0] * (len(self.buckets) + 1) + [0.0]
            for i, edge in enumerate(self.buckets):
                if v <= edge:
                    row[i] += 1
            row[len(self.buckets)] += 1      # +Inf / count
            row[-1] += v                     # sum

    def _expose(self, lines: List[str]) -> None:
        for key, row in self._sorted_series():
            for i, edge in enumerate(self.buckets):
                lines.append("%s_bucket%s %s" % (
                    self.name,
                    self._labelstr(key, 'le="%s"' % _fmt(edge)),
                    _fmt(row[i])))
            lines.append("%s_bucket%s %s" % (
                self.name, self._labelstr(key, 'le="+Inf"'),
                _fmt(row[len(self.buckets)])))
            lines.append("%s_sum%s %s" % (self.name, self._labelstr(key),
                                          _fmt(row[-1])))
            lines.append("%s_count%s %s" % (
                self.name, self._labelstr(key),
                _fmt(row[len(self.buckets)])))

    def _snap(self) -> dict:
        return {"type": self.kind, "help": self.help,
                "labels": list(self.labels),
                "series": [{"labels": dict(zip(self.labels, key)),
                            "buckets": dict(zip(
                                [_fmt(e) for e in self.buckets] + ["+Inf"],
                                row[:len(self.buckets) + 1])),
                            "sum": row[-1],
                            "count": row[len(self.buckets)]}
                           for key, row in self._sorted_series()]}


class MetricsRegistry:
    """Named metrics + pull collectors behind one scrape call.

    ``counter``/``gauge``/``histogram`` create-or-return (idempotent for
    an identical declaration; a conflicting re-declaration raises — two
    subsystems silently sharing one name is how scrapes lie).
    ``register_collector`` adds a zero-arg callable run at the START of
    every scrape (adapters refresh their metrics there); it returns an
    unsubscribe callable, the same contract as
    ``Searcher.add_invalidation_hook``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], None]] = []

    # -- declaration -------------------------------------------------------
    def _declare(self, cls, name, help, labels, **kw) -> _Metric:
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % name)
        for lbl in labels:
            if not _LABEL_RE.match(lbl):
                raise ValueError("invalid label name %r on %r"
                                 % (lbl, name))
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labels != tuple(labels)
                        or (cls is Histogram and existing.buckets
                            != tuple(sorted(float(x)
                                            for x in kw["buckets"])))):
                    raise ValueError(
                        "metric %r already declared as %s%s"
                        % (name, existing.kind, existing.labels))
                return existing
            metric = cls(name, help, labels, self._lock, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, labels,
                             buckets=buckets)

    # -- collectors --------------------------------------------------------
    def register_collector(
            self, fn: Callable[[], None]) -> Callable[[], None]:
        with self._lock:
            self._collectors.append(fn)

        def remove() -> None:
            with self._lock:
                try:
                    self._collectors.remove(fn)
                except ValueError:
                    pass

        return remove

    def collect(self) -> None:
        """Run every collector (outside the lock — a collector reads its
        island's own thread-safe snapshot and writes metrics, which
        re-take the lock per write)."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()

    # -- scrape ------------------------------------------------------------
    def prometheus_text(self) -> str:
        """One scrape: run collectors, then the full text exposition
        (Prometheus text format 0.0.4) — deterministic ordering, so two
        scrapes of identical state are bit-identical."""
        self.collect()
        lines: List[str] = []
        with self._lock:
            for name, metric in self._metrics.items():
                if metric.help:
                    lines.append("# HELP %s %s" % (name,
                                                   _escape(metric.help)))
                lines.append("# TYPE %s %s" % (name, metric.kind))
                metric._expose(lines)
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-ready scrape (same collector pass as the text form)."""
        self.collect()
        with self._lock:
            return {name: metric._snap()
                    for name, metric in self._metrics.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)


# ---------------------------------------------------------------------------
# Adapters: one per telemetry island.  Each owns its metric names,
# refreshes them from the island's thread-safe snapshot at scrape time,
# and unhooks via close().


class ServeStatsCollector:
    """``ServeStats`` per-bucket counters + latency quantiles →
    ``raft_serve_*`` (serve/stats.py)."""

    def __init__(self, registry: MetricsRegistry, stats,
                 prefix: str = "raft_serve"):
        self.stats = stats
        self._counters = {}
        from raft_tpu_torch.serve.stats import _COUNTERS

        for c in _COUNTERS:
            self._counters[c] = registry.counter(
                "%s_%s_total" % (prefix, c),
                "per-bucket serving counter %r" % c, labels=("bucket",))
        self._latency = registry.gauge(
            prefix + "_latency_seconds",
            "windowed latency quantiles per bucket",
            labels=("bucket", "q"))
        self._samples = registry.gauge(
            prefix + "_latency_samples",
            "live latency sample-window size (quantile confidence)",
            labels=("bucket",))
        self._compiles = registry.counter(
            prefix + "_compile_events_total",
            "XLA backend compiles observed by CompileCounter")
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        snap = self.stats.snapshot()
        for bucket, row in snap["buckets"].items():
            for c, metric in self._counters.items():
                metric.set_total(row[c], bucket=bucket)
            for q in ("p50", "p90", "p99", "max"):
                self._latency.set(row["latency_" + q], bucket=bucket, q=q)
            self._samples.set(row["latency_samples"], bucket=bucket)
        self._compiles.set_total(snap["compile_events"])

    def close(self) -> None:
        self._unsub()


class ShardHealthCollector:
    """``ShardHealth`` → per-rank liveness/suspect gauges + transition
    events (comms/health.py).  Transitions are counted by registered
    listeners, so a die+revive BETWEEN scrapes still shows.  The
    three-state feed (``add_state_listener``) counts suspect edges the
    binary channel hides — a shard that went suspect, was hedged
    around, and recovered between scrapes leaves its trail here."""

    def __init__(self, registry: MetricsRegistry, health,
                 prefix: str = "raft_shard"):
        self.health = health
        self._live = registry.gauge(
            prefix + "_live", "per-rank liveness (1 live / 0 dead)",
            labels=("rank",))
        self._suspect = registry.gauge(
            prefix + "_suspect",
            "per-rank suspect flag (1 = latency outlier, hedged around)",
            labels=("rank",))
        self._n_live = registry.gauge(
            prefix + "_n_live", "count of live ranks")
        self._n_suspect = registry.gauge(
            prefix + "_n_suspect", "count of suspect ranks")
        self._transitions = registry.counter(
            prefix + "_transitions_total",
            "live/dead state transitions per rank",
            labels=("rank", "to"))
        self._state_transitions = registry.counter(
            prefix + "_state_transitions_total",
            "full three-state transitions per rank (incl. suspect)",
            labels=("rank", "to"))
        self._unsub_listener = health.add_listener(self._on_transition)
        self._unsub_state = (
            health.add_state_listener(self._on_state)
            if hasattr(health, "add_state_listener") else None)
        self._unsub = registry.register_collector(self.collect)

    def _on_transition(self, rank: int, live: bool) -> None:
        self._transitions.inc(rank=rank, to="live" if live else "dead")

    def _on_state(self, rank: int, state: str) -> None:
        self._state_transitions.inc(rank=rank, to=state)

    def collect(self) -> None:
        mask = self.health.live_mask
        suspect = getattr(self.health, "suspect_mask", None)
        for rank, live in enumerate(mask):
            self._live.set(1.0 if live else 0.0, rank=rank)
            if suspect is not None:
                self._suspect.set(1.0 if suspect[rank] else 0.0,
                                  rank=rank)
        self._n_live.set(float(mask.sum()))
        if suspect is not None:
            self._n_suspect.set(float(suspect.sum()))

    def close(self) -> None:
        self._unsub()
        self._unsub_listener()
        if self._unsub_state is not None:
            self._unsub_state()


class CacheCollector:
    """``ResultCache`` → size / hit-rate / eviction counters
    (serve/cache.py)."""

    def __init__(self, registry: MetricsRegistry, cache,
                 prefix: str = "raft_cache"):
        self.cache = cache
        self._size = registry.gauge(prefix + "_size", "entries held")
        self._capacity = registry.gauge(prefix + "_capacity", "LRU bound")
        self._hit_rate = registry.gauge(prefix + "_hit_rate",
                                        "lifetime hit fraction")
        self._counters = {
            c: registry.counter("%s_%s_total" % (prefix, c),
                                "result-cache %s" % c)
            for c in ("hits", "misses", "evictions", "invalidations")}
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        snap = self.cache.snapshot()
        self._size.set(snap["size"])
        self._capacity.set(snap["capacity"])
        self._hit_rate.set(snap["hit_rate"])
        for c, metric in self._counters.items():
            metric.set_total(snap[c])

    def close(self) -> None:
        self._unsub()


class CompactorCollector:
    """``Compactor`` pass/failure counters, trigger state, and the last
    published :class:`~raft_tpu_torch.lifecycle.compact.CompactionReport`
    (lifecycle/compact.py): a failed pass is a counter plus the failure
    repr as an info label, not only a warning line."""

    _REPORT_FIELDS = ("reclaimed_slots", "live_rows", "lists_split",
                      "lists_reclustered", "lists_migrated",
                      "n_lists_after", "cap_after", "epoch")

    def __init__(self, registry: MetricsRegistry, compactor,
                 prefix: str = "raft_compactor"):
        self.compactor = compactor
        self._counters = {
            c: registry.counter("%s_%s_total" % (prefix, c),
                                "compaction passes %s" % c)
            for c in ("passes", "failures", "skipped")}
        self._should_run = registry.gauge(
            prefix + "_should_run",
            "last trigger evaluation (1 = pass due)")
        self._trigger_frac = registry.gauge(
            prefix + "_trigger_frac",
            "tombstone fraction at the last trigger evaluation")
        self._last_report = registry.gauge(
            prefix + "_last_report",
            "fields of the last published CompactionReport",
            labels=("field",))
        self._last_failure = registry.gauge(
            prefix + "_last_failure_info",
            "1 when the most recent pass failed; the error rides the "
            "label", labels=("error",))
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        comp = self.compactor
        for c, metric in self._counters.items():
            metric.set_total(getattr(comp, c))
        self._should_run.set(1.0 if comp.last_should_run else 0.0)
        self._trigger_frac.set(comp.last_trigger_frac)
        report = comp.last_report
        if report is not None:
            for f in self._REPORT_FIELDS:
                self._last_report.set(getattr(report, f), field=f)
        self._last_failure.clear()
        if comp.last_error is not None:
            self._last_failure.set(1.0, error=comp.last_error)

    def close(self) -> None:
        self._unsub()


class SearcherCollector:
    """Index-content state through the serving facade: ``epoch``,
    ``tombstone_frac``, tombstone count (serve/searcher.py,
    lifecycle/delete.py; host counters, no device read)."""

    def __init__(self, registry: MetricsRegistry, searcher,
                 prefix: str = "raft_index"):
        self.searcher = searcher
        self._epoch = registry.gauge(
            prefix + "_epoch", "index content version (cache key)")
        self._tomb_frac = registry.gauge(
            prefix + "_tombstone_frac",
            "tombstoned fraction of stored slots (compaction trigger)")
        self._n_deleted = registry.gauge(
            prefix + "_n_deleted", "tombstoned slots awaiting compaction")
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        s = self.searcher
        self._epoch.set(s.epoch)
        self._tomb_frac.set(s.tombstone_frac)
        self._n_deleted.set(getattr(s._index, "n_deleted", 0)
                            if s.kind != "brute_force" else 0)

    def close(self) -> None:
        self._unsub()


class MergeDispatchCollector:
    """Per-engine ``topk_merge`` host dispatch counts + estimated
    exchange bytes (comms/topk_merge.py ``merge_dispatch_stats``) — the
    ``merge_comm_bytes`` estimator on the live scrape surface."""

    def __init__(self, registry: MetricsRegistry, stats=None,
                 prefix: str = "raft_merge"):
        if stats is None:
            from raft_tpu_torch.comms.topk_merge import merge_dispatch_stats
            stats = merge_dispatch_stats
        self.stats = stats
        self._dispatches = registry.counter(
            prefix + "_dispatch_total",
            "sharded-search merge dispatches per resolved engine",
            labels=("engine",))
        self._bytes = registry.counter(
            prefix + "_est_exchange_bytes_total",
            "estimated per-device collective bytes received "
            "(merge_comm_bytes)", labels=("engine",))
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        snap = self.stats.snapshot()
        for engine, row in snap.items():
            self._dispatches.set_total(row["dispatches"], engine=engine)
            self._bytes.set_total(row["est_bytes"], engine=engine)

    def close(self) -> None:
        self._unsub()


class RoutingCollector:
    """Routed-placement telemetry (parallel/routing.py
    ``routing_stats``): per-shard probe-load and routed-query counters,
    lists owned, replica hits, and the mean routing fan-out — the
    gauges that make the placement balancer's effect scrapeable
    (queries spread across shards, hot-list replica reads, fan-out
    dropping as locality rises)."""

    def __init__(self, registry: MetricsRegistry, stats=None,
                 prefix: str = "raft_route"):
        if stats is None:
            from raft_tpu_torch.parallel.routing import routing_stats
            stats = routing_stats
        self.stats = stats
        self._dispatches = registry.counter(
            prefix + "_dispatch_total", "routed search dispatches")
        self._queries = registry.counter(
            prefix + "_queries_total", "queries routed (all shards)")
        self._shard_queries = registry.counter(
            prefix + "_shard_queries_total",
            "queries routed per shard", labels=("shard",))
        self._shard_probes = registry.counter(
            prefix + "_shard_probe_load_total",
            "probed (query, list) occurrences per shard",
            labels=("shard",))
        self._lists_owned = registry.gauge(
            prefix + "_lists_owned", "primary lists owned per shard",
            labels=("shard",))
        self._replica_hits = registry.counter(
            prefix + "_replica_hits_total",
            "probe occurrences served by a hot-list replica")
        self._fanout = registry.gauge(
            prefix + "_fanout_mean",
            "mean shards participating per query (lifetime)")
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        snap = self.stats.snapshot()
        self._dispatches.set_total(snap["dispatches"])
        self._queries.set_total(snap["queries"])
        self._replica_hits.set_total(snap["replica_hits"])
        self._fanout.set(snap["fanout_mean"])
        for s, n in snap["shard_queries"].items():
            self._shard_queries.set_total(n, shard=s)
        for s, n in snap["shard_probes"].items():
            self._shard_probes.set_total(n, shard=s)
        for s, n in snap["lists_owned"].items():
            self._lists_owned.set(n, shard=s)

    def close(self) -> None:
        self._unsub()


class WalCollector:
    """Durability telemetry (lifecycle/wal.py): mutation-log append
    volume, fsync latency histogram, snapshot count, replay lag per
    follower and promotions fired.  Reads
    host-side :class:`~raft_tpu_torch.lifecycle.wal.WalStats` counters and
    cached follower watermarks only; a scrape never touches log files
    or device state (the fsync histogram drains latencies the log
    accumulated at append time)."""

    def __init__(self, registry: MetricsRegistry, stats,
                 followers: Sequence = (), promotion=None,
                 prefix: str = "raft_wal"):
        self.stats = stats
        self.followers = list(followers)
        self.promotion = promotion
        self._records = registry.counter(
            prefix + "_records_total", "mutation records appended")
        self._bytes = registry.counter(
            prefix + "_bytes_total", "mutation-log bytes appended")
        self._fsync = registry.histogram(
            prefix + "_fsync_seconds", "log append fsync latency")
        self._snapshots = registry.counter(
            prefix + "_snapshots_total", "full index snapshots written")
        self._head = registry.gauge(
            prefix + "_head_epoch", "newest committed epoch in the log")
        self._snap_epoch = registry.gauge(
            prefix + "_snapshot_epoch", "epoch of the newest snapshot")
        self._lag = registry.gauge(
            prefix + "_replay_lag_epochs",
            "epochs a follower trails the log head (as of its last "
            "catch-up/poll)", labels=("follower",))
        self._promotions = registry.counter(
            prefix + "_promotions_total",
            "followers promoted to primary")
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        st = self.stats
        self._records.set_total(st.records)
        self._bytes.set_total(st.bytes)
        self._snapshots.set_total(st.snapshots)
        self._head.set(st.head_epoch)
        self._snap_epoch.set(st.last_snapshot_epoch)
        for s in st.drain_fsyncs():
            self._fsync.observe(s)
        for i, f in enumerate(self.followers):
            self._lag.set(f.lag, follower=i)
        if self.promotion is not None:
            self._promotions.set_total(self.promotion.promotions)

    def close(self) -> None:
        self._unsub()


class ElasticCollector:
    """Elastic-membership telemetry (lifecycle/elastic.py
    ``elastic_stats``): join/leave migrations completed, lists moved
    across resizes, and the epoch of the last cutover."""

    def __init__(self, registry: MetricsRegistry, stats=None,
                 prefix: str = "raft_elastic"):
        if stats is None:
            from raft_tpu_torch.lifecycle.elastic import elastic_stats
            stats = elastic_stats
        self.stats = stats
        self._joins = registry.counter(
            prefix + "_joins_total", "shards joined the serving set")
        self._leaves = registry.counter(
            prefix + "_leaves_total", "shards drained from the serving "
            "set")
        self._moved = registry.counter(
            prefix + "_lists_moved_total",
            "whole lists migrated by elastic resizes")
        self._epoch = registry.gauge(
            prefix + "_last_epoch", "epoch of the last resize cutover")
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        snap = self.stats.snapshot()
        self._joins.set_total(snap["joins"])
        self._leaves.set_total(snap["leaves"])
        self._moved.set_total(snap["lists_moved"])
        self._epoch.set(snap["last_epoch"])

    def close(self) -> None:
        self._unsub()


class HedgeCollector:
    """Hedged-dispatch telemetry (serve/hedge.py ``HedgeStats`` on the
    Searcher): hedges fired / won / suppressed, plus the routing
    layer's suspect-avoided count — together the scrape answer to "is
    the tail defense actually engaging, and is it winning?"."""

    def __init__(self, registry: MetricsRegistry, searcher,
                 prefix: str = "raft_hedge"):
        self.searcher = searcher
        self._counters = {
            c: registry.counter(
                "%s_%s_total" % (prefix, c), "hedged dispatches %s" % c)
            for c in ("fired", "won", "suppressed")}
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        stats = getattr(self.searcher, "hedge_stats", None)
        if stats is None:
            return
        snap = stats.snapshot()
        for c, metric in self._counters.items():
            metric.set_total(snap[c])

    def close(self) -> None:
        self._unsub()


class BreakerCollector:
    """Circuit-breaker telemetry (serve/recovery.py
    :class:`RecoveryProber`): per-rank breaker state gauge (0 closed /
    1 half_open / 2 open), clean-probe streaks, probes sent/clean, and
    re-admissions — the scrape proof that a dead shard is being probed
    back instead of silently revived."""

    _STATE_CODE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

    def __init__(self, registry: MetricsRegistry, prober,
                 prefix: str = "raft_breaker"):
        self.prober = prober
        self._state = registry.gauge(
            prefix + "_state",
            "per-rank breaker state (0 closed / 1 half_open / 2 open)",
            labels=("rank",))
        self._streak = registry.gauge(
            prefix + "_clean_streak",
            "consecutive clean shadow probes per rank",
            labels=("rank",))
        self._probes = registry.counter(
            prefix + "_probes_total", "shadow probes sent")
        self._clean = registry.counter(
            prefix + "_probes_clean_total", "shadow probes judged clean")
        self._readmissions = registry.counter(
            prefix + "_readmissions_total",
            "ranks re-admitted via mark_live after a full clean streak")
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        snap = self.prober.snapshot()
        for rank, state in snap["states"].items():
            self._state.set(self._STATE_CODE[state], rank=rank)
        for rank, streak in snap["streaks"].items():
            self._streak.set(float(streak), rank=rank)
        self._probes.set_total(snap["probes_sent"])
        self._clean.set_total(snap["probes_clean"])
        self._readmissions.set_total(snap["readmissions"])

    def close(self) -> None:
        self._unsub()


class DegradeCollector:
    """Degradation-ladder telemetry (serve/scheduler.py
    :class:`DegradePolicy`): the scheduler's current brownout rung and
    queue fill fraction.  The per-bucket served-quality counters
    (``served_full`` / ``served_reduced`` / ``served_brownout``,
    ``probes_shrunk``, ``priority_evictions``) already flow through
    :class:`ServeStatsCollector` — this adapter adds the point-in-time
    gauges a dashboard alerts on."""

    def __init__(self, registry: MetricsRegistry, scheduler,
                 prefix: str = "raft_degrade"):
        self.scheduler = scheduler
        self._level = registry.gauge(
            prefix + "_brownout_level",
            "ladder rung of the most recent dispatch (0 = full quality)")
        self._fill = registry.gauge(
            prefix + "_queue_fill",
            "queued requests / max_queue at scrape time")
        self._unsub = registry.register_collector(self.collect)

    def collect(self) -> None:
        sched = self.scheduler
        self._level.set(float(getattr(sched, "brownout_level", 0)))
        self._fill.set(sched.pending() / sched.policy.max_queue)

    def close(self) -> None:
        self._unsub()
