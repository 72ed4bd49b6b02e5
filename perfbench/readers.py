"""Shared arithmetic of the per-layer metric readers (``metrics/``).

A reader gets a context with ``window`` (what the loop measured: counts,
spans, the scan work), ``trace`` (the device trace's summary, or None)
and ``cell``. It returns a number, or None when it finds nothing to
read; the harness then leaves the metric out.
"""

from __future__ import annotations

from typing import Optional, Tuple

from perfbench import roofline
from perfbench.devtrace import short_name

#: The port's hand-written kernels (B1-B4 by prefix, B5 by name).
KERNELS = ("b1_", "b2_", "b3_", "b4_", "stream_extract")


def idle_share(ctx) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def engine_share(ctx) -> Optional[float]:
    """Percent of the traced window taken by kernels other than the
    port's hand-written ones (the engines' plain-torch work)."""
    t = ctx.trace
    if t is None:
        return None
    sec = sum(s for n, s in t.seconds_by_name().items()
              if not short_name(n).startswith(
                  KERNELS + ("Memcpy", "Memset")))
    return 100.0 * sec / t.window_s


def scan_roofline(ctx, prefixes: Tuple[str, ...], tier: str
                  ) -> Optional[float]:
    """Percent: the least time of the window's scan work over the device
    time of the kernels named by ``prefixes``."""
    t, work = ctx.trace, ctx.window.get("work")
    if t is None or not work:
        return None
    sec = t.kernel_seconds(prefixes)
    if sec <= 0:
        return None
    return 100.0 * roofline.bound_s(work["ops"], work["bytes"], tier) / sec


def kernel_ms_per(ctx, prefixes: Tuple[str, ...], count: str
                  ) -> Optional[float]:
    """Device ms of the kernels named by ``prefixes`` per ``count`` (a
    count of the window, such as builds)."""
    t, n = ctx.trace, ctx.window.get(count)
    if t is None or not n:
        return None
    sec = t.kernel_seconds(prefixes)
    return 1e3 * sec / n if sec > 0 else None
