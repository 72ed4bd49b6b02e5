"""Observability for the serving stack: tracing, metrics, online recall.

Port of ``raft_tpu/obs``:

* ``obs.trace``: the deterministic request-span tracer on the injectable
  monotonic clock, with JSON and Chrome trace-event exports;
* ``obs.registry``: ``MetricsRegistry`` (counters / gauges / histograms
  with labels, Prometheus text exposition and a JSON snapshot) and the
  ``*Collector`` adapters over every telemetry island (serving stats,
  shard health, cache, compactor, index epoch and tombstones, merge and
  routing dispatch, the write-ahead log, elastic resizes, hedging, the
  recovery breaker, the degradation ladder);
* ``obs.recall``: ``RecallProbe``, a deterministic shadow sampler that
  scores served answers against a full-probe search off the hot path and
  publishes realized-recall gauges and the drift flag the ``Compactor``
  trigger consumes.

Everything is off by default: no tracer, registry or probe exists unless
wired in.
"""

from raft_tpu_torch.obs.recall import RecallProbe
from raft_tpu_torch.obs.registry import (
    BreakerCollector,
    CacheCollector,
    CompactorCollector,
    Counter,
    DegradeCollector,
    ElasticCollector,
    Gauge,
    HedgeCollector,
    Histogram,
    MergeDispatchCollector,
    MetricsRegistry,
    RoutingCollector,
    SearcherCollector,
    ServeStatsCollector,
    ShardHealthCollector,
    WalCollector,
)
from raft_tpu_torch.obs.trace import NULL_SPAN, NULL_TRACER, Span, Tracer

__all__ = [
    "Span", "Tracer", "NULL_SPAN", "NULL_TRACER",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "ServeStatsCollector", "ShardHealthCollector", "CacheCollector",
    "CompactorCollector", "SearcherCollector", "MergeDispatchCollector",
    "RoutingCollector", "WalCollector", "ElasticCollector",
    "HedgeCollector", "BreakerCollector", "DegradeCollector",
    "RecallProbe",
]
