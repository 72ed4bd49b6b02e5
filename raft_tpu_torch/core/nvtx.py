"""Scoped profiler ranges in named domains, and the spans they log.

Port of ``raft_tpu/core/nvtx.py`` (RAFT's ``core/nvtx.hpp``). Labels read
``<domain>::<name>``; those of :func:`traced` entry points read
``<leaf module>.<function>``, e.g. ``raft_tpu_torch::masked_nn.masked_l2_nn``.

A range costs one flag check unless something records it:

* while a ``torch.profiler`` records, a range opens a record function of
  its label (the C++ ``RecordFunction`` behind
  ``torch.profiler.record_function``, entered without the Python
  operator's dispatch), so it shows in the profiler's trace, and logs a
  :class:`Span`: its name, its id, its parent's and its root's ids, its
  host interval on ``time.time_ns()`` (the clock kineto stamps its
  events with), the counts the caller passed as keyword attributes (host
  values only: reading a device value would add a sync) and, once CUDA is
  initialised in the process, its device interval as a pair of timed CUDA
  events on the current stream;
* when an NVTX tool is injected (``NVTX_INJECTION64_PATH``, which Nsight
  sets, read once at import), a range also pushes an NVTX range.

A span records one event, at its end. Its start event is the last
boundary its parent saw: the parent's start (a root records its own), or
the end of the sibling that closed before it. Device work queued between
two sibling spans so counts to the second one; the port's stage spans
follow one another with no device work between them, so the children of
a span tile its interval.

Ranges named ``sync.<site>`` wrap one host sync each (``bool()``,
``int()``, ``.cpu()`` of a device value, an index by a 0-dim or boolean
device tensor, a host-to-device copy), or ``syncs`` of them in one
operation (``torch.bincount`` makes two): their count is the host's
syncs, their host intervals its waits. A sync span inside another span
records no event: its device interval is the empty one at its parent's
last boundary, and what it queues counts to the span that holds it.

The log holds at most :data:`MAX_SPANS` spans; later ones are dropped and
counted. :func:`take_spans` drains it.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

#: Most spans the log holds between two :func:`take_spans`.
MAX_SPANS = 1 << 16

_NVTX_TOOL = (bool(os.environ.get("NVTX_INJECTION64_PATH"))
              and torch.cuda.is_available())
_profiling = torch._C._autograd._profiler_enabled
_record_function = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()

_tls = threading.local()
_lock = threading.Lock()
_ids = itertools.count(1)
_log: List["Span"] = []
_dropped = [0]
_cuda = [False]
_streams: Dict[tuple, torch.cuda.Stream] = {}


class Span:
    """One range's record. ``parent`` is 0 for a root; ``root`` is the id
    of the outermost span of the call (its own for a root). ``device_ms``
    is its event pair's interval, set by :func:`take_spans` (None off the
    card)."""

    __slots__ = ("name", "domain", "id", "parent", "root", "start_ns",
                 "end_ns", "attrs", "device_ms", "_start", "_end", "_mark")

    def __init__(self, name: str, domain: str, id: int, parent: int,
                 root: int, attrs: Dict[str, int]):
        self.name, self.domain, self.attrs = name, domain, attrs
        self.id, self.parent, self.root = id, parent, root
        self.start_ns = self.end_ns = None
        self.device_ms: Optional[float] = None
        self._start = self._end = self._mark = None

    @property
    def label(self) -> str:
        return f"{self.domain}::{self.name}"

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"root={self.root}, {self.attrs})")


class Taken(NamedTuple):
    """What :func:`take_spans` drained: the closed spans in the order they
    opened, and the number dropped since the last take."""

    spans: List[Span]
    dropped: int


def _open_spans() -> List[Optional[Span]]:
    try:
        return _tls.spans
    except AttributeError:
        _tls.spans = []
        return _tls.spans


def _record() -> torch.cuda.Event:
    """A timed event recorded on the current stream."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    ev = torch.cuda.Event(enable_timing=True)
    torch._C._CudaEventBase.record(ev, stream)
    return ev


def _begin(name: str, domain: str, attrs, t0: int) -> Optional[Span]:
    stack = _open_spans()
    up = stack[-1] if stack else None
    sid = next(_ids)
    if len(_log) >= MAX_SPANS:
        with _lock:
            _dropped[0] += 1
        stack.append(None)
        return None
    span = Span(name, domain, sid, up.id if up else 0,
                up.root if up else sid, attrs or {})
    _log.append(span)
    stack.append(span)
    span.start_ns = t0
    if _cuda[0] or torch.cuda.is_initialized():
        _cuda[0] = True
        if up is not None and up._mark is not None:
            span._start = up._mark
            if name.startswith("sync."):
                span._end = span._start
        else:
            span._start = _record()
        span._mark = span._start
    return span


def _finish(span: Optional[Span]) -> None:
    stack = _open_spans()
    stack.pop()
    if span is not None:
        if span._start is not None and span._end is None:
            span._end = _record()
            if stack and stack[-1] is not None:
                stack[-1]._mark = span._end
        span._mark = None
        span.end_ns = time.time_ns()


class _Range:
    """One range: NVTX when a tool is injected; a record function and a
    span while the profiler records."""

    __slots__ = ("name", "domain", "attrs", "rf", "span", "nvtx")

    def __init__(self, name: str, domain: str, attrs):
        self.name, self.domain, self.attrs = name, domain, attrs

    def __enter__(self) -> None:
        self.nvtx = _NVTX_TOOL
        if _NVTX_TOOL:
            torch.cuda.nvtx.range_push(f"{self.domain}::{self.name}")
        if not _profiling():
            self.rf = None
            return
        rf = self.rf = _record_function(f"{self.domain}::{self.name}")
        rf.__enter__()
        # Stamped next to the record function's own stamps, before
        # anything that allocates.
        t0 = time.time_ns()
        self.span = _begin(self.name, self.domain, self.attrs, t0)

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            _finish(self.span)
            self.rf.__exit__(None, None, None)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()


def range_scope(name: str, domain: str = "raft_tpu_torch", **attrs):
    """A range over the ``with`` body; ``attrs`` are counts (host values)
    kept on its span."""
    if not (_NVTX_TOOL or _profiling()):
        return _OFF
    return _Range(name, domain, attrs)


def traced(fn=None, *, name: Optional[str] = None,
           domain: str = "raft_tpu_torch"):
    """Decorator: a range over every call of ``fn``, labelled ``name`` or
    ``<leaf module>.<function>``."""

    def deco(f):
        label = name or f"{f.__module__.rsplit('.', 1)[-1]}.{f.__name__}"

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not (_NVTX_TOOL or _profiling()):
                return f(*args, **kwargs)
            with _Range(label, domain, None):
                return f(*args, **kwargs)

        return wrapper

    return deco(fn) if fn is not None else deco


def _stack() -> list:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def push_range(name: str, domain: str = "raft_tpu_torch") -> None:
    """Open a range on this thread's stack (prefer :func:`range_scope`)."""
    r = _Range(name, domain, None)
    r.__enter__()
    _stack().append(r)


def pop_range() -> None:
    """Close this thread's innermost range opened by :func:`push_range`."""
    stack = _stack()
    if stack:
        stack.pop().__exit__(None, None, None)


def take_spans() -> Taken:
    """Drain the log: every closed span, its device interval resolved
    (waiting for its end event), and the count dropped. Spans still open
    are left out."""
    global _log
    with _lock:
        spans, _log = _log, []
        dropped, _dropped[0] = _dropped[0], 0
    closed = [s for s in spans if s.end_ns is not None]
    for s in closed:
        if s._end is s._start and s._end is not None:
            s.device_ms = 0.0
        elif s._end is not None:
            s._end.synchronize()
            s.device_ms = s._start.elapsed_time(s._end)
        s._start = s._end = None
    return Taken(closed, dropped)
