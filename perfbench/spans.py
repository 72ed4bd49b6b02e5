"""The port's own stage spans in a traced run, reduced for the readers.

While the profiler records, ``raft_tpu_torch.core.nvtx`` logs a span for
each range the port opens: the roots ``ivf_flat.search`` /
``ivf_pq.search`` / ``ivf_flat.build`` / ``ivf_pq.build``, their stages
(``search.probe``, ``build.train``, ...) and ``sync.<site>`` around each
host sync. A span has a host interval on the clock of the profiler's
events and, on the card, a device interval from a pair of CUDA events.

:func:`of` drains that log once a run and keeps it on the reader
context. A port without the log (an older checkout) gives None, and so
does every reader. Counts are per ``window["batches"]`` or
``window["builds"]``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

SEARCH_ROOTS = ("ivf_flat.search", "ivf_pq.search")
BUILD_ROOTS = ("ivf_flat.build", "ivf_pq.build")
SCAN = "search.scan"


def of(ctx) -> Optional[list]:
    """The run's spans, drained from the port once and kept on ``ctx``
    (None when the port logs none)."""
    if not hasattr(ctx, "spans"):
        try:
            from raft_tpu_torch.core.nvtx import take_spans
        except ImportError:
            ctx.spans = None
        else:
            ctx.spans = take_spans().spans or None
    return ctx.spans


def _count(ctx, key: str) -> Optional[int]:
    n = ctx.window.get(key)
    return n if n else None


def _under(spans, roots: Tuple[str, ...]) -> List:
    """The spans of the calls whose root span is named in ``roots``,
    the roots included."""
    ids = {s.id for s in spans if s.parent == 0 and s.name in roots}
    return [s for s in spans if s.root in ids]


def host_ms_per(ctx, roots: Tuple[str, ...], count: str) -> Optional[float]:
    """Host ms inside the root spans named ``roots``, per ``count``."""
    sp, n = of(ctx), _count(ctx, count)
    if not sp or not n:
        return None
    top = [s for s in sp if s.parent == 0 and s.name in roots]
    if not top:
        return None
    return sum(s.end_ns - s.start_ns for s in top) * 1e-6 / n


def device_ms_per(ctx, roots: Tuple[str, ...], stages: Iterable[str],
                  count: str, exclude: bool = False) -> Optional[float]:
    """Device ms (event pairs) of the root's direct stages named in
    ``stages`` (all others with ``exclude``), per ``count``."""
    sp, n = of(ctx), _count(ctx, count)
    if not sp or not n:
        return None
    top = {s.id for s in sp if s.parent == 0 and s.name in roots}
    stages = set(stages)
    ms = [s.device_ms for s in sp if s.parent in top
          and (s.name in stages) != exclude]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / n


def syncs(spans) -> int:
    """Host syncs the ``sync.*`` spans among ``spans`` wrap."""
    return sum(s.attrs.get("syncs", 1) for s in spans
               if s.name.startswith("sync."))


def syncs_per(ctx, roots: Tuple[str, ...], count: str) -> Optional[float]:
    """Host syncs inside the root spans named ``roots``, per ``count``."""
    sp, n = of(ctx), _count(ctx, count)
    if not sp or not n:
        return None
    inside = _under(sp, roots)
    if not inside:
        return None
    return syncs(inside) / n


def idle_gaps(trace) -> List[Tuple[int, int]]:
    """The window's intervals in which no device operation ran."""
    busy: List[List[int]] = []
    for _, s, e in sorted(trace.ops, key=lambda o: o[1]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    edges = [trace.window[0]] + [x for b in busy for x in b] \
        + [trace.window[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _innermost(spans) -> Callable[[int], Optional[object]]:
    """``find(t)``: the innermost span whose host interval holds time
    ``t``, or None. Roots do not overlap (one thread), so the root is
    found by bisection and the innermost among its own spans."""
    tops = sorted((s for s in spans if s.parent == 0),
                  key=lambda s: s.start_ns)
    starts = [s.start_ns for s in tops]
    by_root: Dict[int, list] = defaultdict(list)
    for s in sorted(spans, key=lambda s: s.start_ns):
        by_root[s.root].append(s)

    def find(t: int):
        j = bisect.bisect_right(starts, t) - 1
        if j < 0 or tops[j].end_ns < t:
            return None
        inner = None
        for s in by_root[tops[j].id]:
            if s.start_ns > t:
                break
            if s.end_ns >= t:
                inner = s
        return inner

    return find


def idle_by_span(ctx) -> Optional[Dict[int, float]]:
    """Idle seconds of the traced window by the id of the innermost span
    over each gap's midpoint (0: no span of the port)."""
    sp, t = of(ctx), ctx.trace
    if not sp or t is None:
        return None
    find = _innermost(sp)
    out: Dict[int, float] = defaultdict(float)
    for g0, g1 in idle_gaps(t):
        s = find((g0 + g1) // 2)
        out[s.id if s is not None else 0] += (g1 - g0) * 1e-9
    return dict(out)


def idle_share_in(ctx, roots: Tuple[str, ...]) -> Optional[float]:
    """Percent of the traced window in which the device idles while the
    host is inside a root span named in ``roots``."""
    idle = idle_by_span(ctx)
    if idle is None or ctx.trace.window_s <= 0:
        return None
    inside = {s.id for s in _under(of(ctx), roots)}
    if not inside:
        return None
    sec = sum(v for k, v in idle.items() if k in inside)
    return 100.0 * sec / ctx.trace.window_s


def stage_table(ctx, roots: Tuple[str, ...], count: str) -> Optional[dict]:
    """Per span name under ``roots``, per ``count``: host ms, device ms
    (event pairs), idle ms (gaps whose midpoint it is the innermost span
    of) and host syncs; every figure summed over the spans of the name."""
    sp, n = of(ctx), _count(ctx, count)
    if not sp or not n:
        return None
    inside = _under(sp, roots)
    idle = idle_by_span(ctx) or {}
    rows: Dict[str, dict] = {}
    for s in inside:
        r = rows.setdefault(s.name, {"spans": 0, "host_ms": 0.0,
                                     "device_ms": 0.0, "idle_ms": 0.0,
                                     "syncs": 0})
        r["spans"] += 1
        r["host_ms"] += (s.end_ns - s.start_ns) * 1e-6
        r["device_ms"] += s.device_ms or 0.0
        r["idle_ms"] += idle.get(s.id, 0.0) * 1e3
        r["syncs"] += syncs([s])
    return {name: {k: v / n for k, v in r.items()}
            for name, r in rows.items()}
