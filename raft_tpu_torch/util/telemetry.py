"""Shared plumbing for host-side telemetry recorders.

Port of ``raft_tpu/util/telemetry.py``: one definition of the thread-local
suppression contract, so that shadow traffic (a recall probe's exact
scans, warmup's synthetic dispatches) that runs through the same entry
points as serving traffic can drop its own records.
"""

from __future__ import annotations

import contextlib
import threading


class SuppressibleStats:
    """Mixin: thread-local record suppression for telemetry recorders.

    Subclasses call ``self._suppressed()`` at the top of ``record`` and
    return early when true; callers wrap shadow traffic in
    ``with stats.suppress(): ...``. Per thread (a probe thread suppressing
    itself never hides serving threads' records) and re-entrant (nesting
    restores the previous state).
    """

    def __init__(self):
        self._local = threading.local()

    def _suppressed(self) -> bool:
        return getattr(self._local, "off", False)

    def suppress(self):
        """Context manager: drop this THREAD's records while active."""

        @contextlib.contextmanager
        def _ctx():
            prev = getattr(self._local, "off", False)
            self._local.off = True
            try:
                yield
            finally:
                self._local.off = prev

        return _ctx()
