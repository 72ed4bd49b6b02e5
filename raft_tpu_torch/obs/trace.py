"""Deterministic request-span tracer for the serving runtime.

Port of ``raft_tpu/obs/trace.py``: every request yields a tree of timed
spans (queue-wait, batch-assembly, cache-lookup, device dispatch, result
merge, device_get), exportable as JSON or the Chrome trace-event format
(``chrome://tracing`` / Perfetto). For the same clock the span tree and
both exports are byte for byte the reference's.

Disciplines (shared with serve/ and core/retry.py):

* **Injectable monotonic clock**: span timestamps are differences of
  the SAME injected clock the scheduler runs on, never wall time, so
  exports are bit-stable under injection.
* **Zero-cost when disabled**: a disabled :class:`Tracer` hands out
  the shared :data:`NULL_SPAN` singleton whose every method is a no-op;
  instrumentation sites stay unconditional and pay one attribute check.
  Spans are host objects, and the device fence (a CUDA synchronise in
  ``Searcher.search``) only runs when a recording span asks for it.
* **Bounded retention**: finished request traces land in a ring buffer
  (``max_traces``); a serving process must not grow without bound.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "NULL_SPAN", "NULL_TRACER"]


class Span:
    """One timed operation: ``name``, start/end on the tracer's clock,
    string-keyed attributes, and child spans.  Create children with
    :meth:`child` (started now, finish later / use as a context
    manager) or :meth:`child_at` (pre-measured interval — the scheduler
    measures one batch once and attaches the interval to every member
    request's tree)."""

    __slots__ = ("name", "start", "end", "attrs", "children", "tid",
                 "_clock", "_sink")

    #: Real spans record; the :data:`NULL_SPAN` singleton reports False —
    #: the one flag instrumentation sites branch on (e.g. whether to pay
    #: the device fence).
    recording = True

    def __init__(self, name: str, clock: Callable[[], float], tid: int = 0,
                 attrs: Optional[dict] = None, sink=None):
        self.name = name
        self._clock = clock
        self.tid = tid
        self.start = clock()
        self.end: Optional[float] = None
        self.attrs: Dict[str, object] = dict(attrs) if attrs else {}
        self.children: List["Span"] = []
        self._sink = sink

    # -- building the tree -------------------------------------------------
    def child(self, name: str, **attrs) -> "Span":
        """Start a child span now (finish it explicitly or via ``with``)."""
        sp = Span(name, self._clock, tid=self.tid,
                  attrs=attrs if attrs else None)
        self.children.append(sp)
        return sp

    def child_at(self, name: str, start: float, end: float,
                 **attrs) -> "Span":
        """Attach an already-measured child interval (the scheduler
        measures a batch ONCE and attaches it to every member's tree)."""
        sp = Span(name, self._clock, tid=self.tid,
                  attrs=attrs if attrs else None)
        sp.start = start
        sp.end = end
        self.children.append(sp)
        return sp

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def now(self) -> float:
        """The span's clock (the tracer's injected monotonic) — the
        boundary instrumentation sites must read THIS clock when they
        attach pre-measured ``child_at`` intervals, or exports stop
        being deterministic under injection."""
        return self._clock()

    def finish(self, **attrs) -> None:
        """Stamp the end time (idempotent — the first finish wins) and,
        for request roots, publish into the tracer's ring buffer."""
        if attrs:
            self.attrs.update(attrs)
        if self.end is None:
            self.end = self._clock()
            if self._sink is not None:
                self._sink(self)

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    # -- export ------------------------------------------------------------
    def tree(self) -> dict:
        """Nested plain-dict form (the JSON export unit)."""
        return {
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "attrs": dict(self.attrs),
            "children": [c.tree() for c in self.children],
        }

    def __repr__(self) -> str:
        return ("Span(%r, start=%s, end=%s, children=%d)"
                % (self.name, self.start, self.end, len(self.children)))


class _NullSpan:
    """Shared do-nothing span: what a disabled tracer hands out so
    instrumentation sites never branch.  Every child is itself."""

    __slots__ = ()
    recording = False
    name = "null"
    children = ()
    attrs: Dict[str, object] = {}
    start = 0.0
    end = 0.0
    duration = 0.0
    tid = 0

    def child(self, name, **attrs):
        return self

    def child_at(self, name, start, end, **attrs):
        return self

    def annotate(self, **attrs):
        pass

    def now(self) -> float:
        return 0.0

    def finish(self, **attrs):
        pass

    def tree(self) -> dict:
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


#: The process-wide disabled span (see :class:`_NullSpan`).
NULL_SPAN = _NullSpan()


class Tracer:
    """Hands out request root spans and retains finished request traces.

    ``enabled=False`` (or :data:`NULL_TRACER`) turns every
    :meth:`request` into the shared :data:`NULL_SPAN` — the zero-cost
    contract instrumented code relies on.  Thread-safe: request threads
    open roots while a pump thread finishes them and a scraper drains.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 enabled: bool = True, max_traces: int = 1024):
        self._clock = clock
        self.enabled = enabled
        self._lock = threading.Lock()
        self._finished: deque = deque(maxlen=max_traces)
        self._dropped = 0
        self._tid = 0

    def now(self) -> float:
        """The tracer's clock (span boundary measurements must read THIS
        clock so exports are deterministic under injection)."""
        return self._clock()

    def request(self, name: str, **attrs):
        """Open one request root span (finished roots land in the ring
        buffer for :meth:`take`); :data:`NULL_SPAN` when disabled."""
        if not self.enabled:
            return NULL_SPAN
        with self._lock:
            self._tid += 1
            tid = self._tid
        return Span(name, self._clock, tid=tid,
                    attrs=attrs if attrs else None, sink=self._publish)

    def _publish(self, span: Span) -> None:
        with self._lock:
            if len(self._finished) == self._finished.maxlen:
                self._dropped += 1
            self._finished.append(span)

    def take(self) -> List[Span]:
        """Drain the finished request traces (oldest first)."""
        with self._lock:
            out = list(self._finished)
            self._finished.clear()
            return out

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._finished)

    @property
    def dropped(self) -> int:
        """Finished traces evicted by the ring bound (scrape health)."""
        with self._lock:
            return self._dropped

    # -- export ------------------------------------------------------------
    def to_json(self, spans: Optional[List[Span]] = None, *,
                drain: bool = False) -> str:
        """JSON array of nested span trees (``drain=True`` consumes the
        buffered traces; default peeks without consuming)."""
        if spans is None:
            spans = self.take() if drain else self._peek()
        return json.dumps([s.tree() for s in spans], sort_keys=True,
                          separators=(",", ":"))

    def chrome_trace(self, spans: Optional[List[Span]] = None, *,
                     drain: bool = False) -> dict:
        """Chrome trace-event form: one complete ("ph": "X") event per
        span, timestamps in integer microseconds of the injected clock,
        one ``tid`` row per request — load the JSON in Perfetto /
        ``chrome://tracing``.  Event order is deterministic: requests in
        finish order, spans depth-first in creation order."""
        if spans is None:
            spans = self.take() if drain else self._peek()
        events: List[dict] = []

        def emit(sp: Span) -> None:
            end = sp.end if sp.end is not None else sp.start
            events.append({
                "name": sp.name,
                "ph": "X",
                "ts": int(round(sp.start * 1e6)),
                "dur": int(round((end - sp.start) * 1e6)),
                "pid": 0,
                "tid": sp.tid,
                # The reference's category: exports stay byte-compatible.
                "cat": "raft_tpu.serve",
                "args": dict(sp.attrs),
            })
            for c in sp.children:
                emit(c)

        for root in spans:
            emit(root)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def chrome_trace_json(self, spans: Optional[List[Span]] = None, *,
                          drain: bool = False) -> str:
        """:meth:`chrome_trace` serialized deterministically (sorted
        keys, no whitespace) — the golden-file export format."""
        return json.dumps(self.chrome_trace(spans, drain=drain),
                          sort_keys=True, separators=(",", ":"))

    def _peek(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def __repr__(self) -> str:
        return ("Tracer(enabled=%s, pending=%d)"
                % (self.enabled, self.pending))


#: Shared disabled tracer: the default wired into the scheduler so
#: un-instrumented deployments pay one ``enabled`` check per request.
NULL_TRACER = Tracer(enabled=False)
