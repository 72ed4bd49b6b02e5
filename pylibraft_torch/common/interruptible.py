"""SIGINT-driven cooperative cancellation.

Ref: python/pylibraft/pylibraft/common/interruptible.pyx, a context
manager that installs a SIGINT handler calling
``raft::interruptible::cancel()`` on the captured token, so a blocked
``synchronize`` raises instead of hanging. Delegates to
:mod:`raft_tpu_torch.core.interruptible`.
"""

from __future__ import annotations

import contextlib
import signal
import threading

from raft_tpu_torch.core.interruptible import (  # noqa: F401 (re-exports)
    Interruptible,
    InterruptedException,
    synchronize,
)


@contextlib.contextmanager
def cuda_interruptible():
    """Ref: interruptible.pyx ``cuda_interruptible``: cancel the current
    thread's token on SIGINT for the duration of the scope."""
    token = Interruptible.get_token()
    if threading.current_thread() is not threading.main_thread():
        # Signal handlers are main-thread only; nested scopes still get
        # cancellation via their parent's token.
        yield
        return
    prev = signal.getsignal(signal.SIGINT)
    if prev is None:
        # A non-Python (C-level) handler is installed: we could neither
        # chain to it nor restore it afterwards, so leave it untouched;
        # cancellation simply isn't hooked to SIGINT in this scope.
        yield
        return

    def handler(signum, frame):
        # Cancel the token (wakes worker threads blocked in synchronize),
        # then defer to the prior disposition: chain a Python handler, or
        # raise KeyboardInterrupt for the default, but respect an explicit
        # SIG_IGN (e.g. multiprocessing pool workers) by cancelling only.
        token.cancel()
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            raise KeyboardInterrupt

    signal.signal(signal.SIGINT, handler)
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, prev)
        # A KeyboardInterrupt consumed by the caller must not leave the
        # cancel flag set: it would poison the next synchronize.
        token.reset()
