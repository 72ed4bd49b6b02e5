"""The device trace of a traced run, reduced to what the readers need.

``torch.profiler`` records the CPU and CUDA activity of the measured
window, which the harness marks with the ``perfbench.window`` range.
From its events this module keeps the device operations (kernels, copies,
sets) inside that range, their union (the busy seconds), the time by
kernel name, and the idle gaps of the device, each named by what the host
was doing in its middle (the innermost CPU range that covers it).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "perfbench.window"

_BASE = re.compile(r"^[A-Za-z_][\w:]*")


def base_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments or parameters: ``void (anonymous
    namespace)::b2_tf32_kernel<64, 1>(float const*)`` ->
    ``b2_tf32_kernel``, ``void at::native::reduce_kernel<...>(...)`` ->
    ``at::native::reduce_kernel``."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name.split(" (")[0]
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    m = _BASE.match(name)
    return m.group(0) if m else name


def short_name(name: str) -> str:
    """The last component of a qualified name: ``cell_norms::b2_norms_kernel``
    -> ``b2_norms_kernel``."""
    return name.rsplit("::", 1)[-1]


class TraceSummary:
    """Device operations of the window: ``ops`` as ``(name, start_ns,
    end_ns)`` clipped to it, ``window_s``, ``busy_s``, and ``gaps`` as
    ``(label, seconds)``."""

    def __init__(self, window: Tuple[int, int], ops, gaps):
        self.window = window
        self.window_s = (window[1] - window[0]) * 1e-9
        self.ops = ops
        self.gaps = gaps
        merged = _merge([(s, e) for _, s, e in ops])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            out[name] += (e - s) * 1e-9
        return dict(out)

    def kernel_seconds(self, prefixes: Tuple[str, ...]) -> float:
        """Device seconds of the kernels whose name starts with one of
        ``prefixes``."""
        return sum(t for n, t in self.seconds_by_name().items()
                   if short_name(n).startswith(prefixes))

    def breakdown(self, top: int = 10) -> dict:
        by_name = sorted(self.seconds_by_name().items(),
                         key=lambda kv: -kv[1])[:top]
        gaps: Dict[str, float] = defaultdict(float)
        for label, sec in self.gaps:
            gaps[label] += sec
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t] for n, t in by_name],
                "idle_gaps": [[n, t] for n, t in idle]}


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def summarize(events) -> Optional[TraceSummary]:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``).
    Returns None when the window range or any device operation is
    missing."""
    window = None
    cpu: List[Tuple[int, int, str]] = []
    dev: List[Tuple[str, int, int]] = []
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if _is_device(ev):
            if name.startswith("perfbench.") or ev.is_user_annotation():
                continue
            dev.append((base_name(name), s, e))
        else:
            if name == WINDOW:
                window = (s, e)
            cpu.append((s, e, name))
    if window is None or not dev:
        return None
    w0, w1 = window
    ops = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
           if e > w0 and s < w1]
    if not ops:
        return None
    gaps = _label_gaps(_merge([(s, e) for _, s, e in ops]), window, cpu)
    return TraceSummary(window, ops, gaps)


def _label_gaps(busy, window, cpu) -> List[Tuple[str, float]]:
    """Each idle interval of the window, named by the innermost CPU range
    (annotation or operator) that covers its middle."""
    cpu = sorted(c for c in cpu if c[2] != WINDOW)
    starts = [c[0] for c in cpu]
    edges = [window[0]] + [x for s, e in busy for x in (s, e)] + [window[1]]
    out = []
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(starts, mid) - 1
        label = "host:python"
        # The innermost covering range starts last; look back a bounded
        # number of ranges for it.
        for c in range(j, max(-1, j - 256), -1):
            if cpu[c][1] >= mid:
                label = cpu[c][2]
                break
        out.append((label, (g1 - g0) * 1e-9))
    return out


class DeviceTrace:
    """Profile the block when ``enabled``; ``summary`` holds the
    :class:`TraceSummary` afterwards (None when disabled or empty)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Optional[TraceSummary] = None
        self._prof = None
        self._range = None

    def __enter__(self) -> "DeviceTrace":
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if not self.enabled:
            return
        import torch

        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        if exc[0] is None:
            self.summary = summarize(
                self._prof.profiler.kineto_results.events())
        self._prof = None
