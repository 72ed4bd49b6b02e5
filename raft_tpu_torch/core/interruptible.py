"""Cooperative cancellation of host threads waiting on the card.

Port of ``raft_tpu/core/interruptible.py`` (``raft::interruptible``): a
per-thread token registry. :func:`synchronize` waits for the card while
polling the calling thread's token, and ``cancel()`` from another thread
makes it raise :class:`InterruptedException`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import torch

from raft_tpu_torch.core.error import RaftError


class InterruptedException(RaftError):
    """Raised by :func:`synchronize` (and
    :meth:`Interruptible.interruptible_check`) when the thread's token was
    cancelled."""


class Interruptible:
    """Per-thread cancellation token."""

    _registry: Dict[int, "Interruptible"] = {}
    _registry_lock = threading.Lock()

    def __init__(self) -> None:
        self._cancelled = threading.Event()

    @classmethod
    def get_token(cls, thread_id: Optional[int] = None) -> "Interruptible":
        """The token of ``thread_id`` (default: the calling thread)."""
        tid = threading.get_ident() if thread_id is None else thread_id
        with cls._registry_lock:
            # Tokens of finished threads go, so a stale cancel() cannot hit
            # a later thread that reuses the id, and the registry stays
            # bounded.
            alive = {t.ident for t in threading.enumerate()}
            alive.add(tid)
            for dead in [t for t in cls._registry if t not in alive]:
                del cls._registry[dead]
            tok = cls._registry.get(tid)
            if tok is None:
                tok = cls._registry[tid] = cls()
            return tok

    def cancel(self) -> None:
        """Request cancellation."""
        self._cancelled.set()

    def reset(self) -> None:
        """Clear a pending cancellation without raising."""
        self._cancelled.clear()

    @classmethod
    def cancel_thread(cls, thread_id: int) -> None:
        cls.get_token(thread_id).cancel()

    def interruptible_check(self) -> None:
        """Raise :class:`InterruptedException` if cancelled, clearing the
        flag."""
        if self._cancelled.is_set():
            self._cancelled.clear()
            raise InterruptedException("raft_tpu_torch: thread interrupted")


def synchronize(*tensors: torch.Tensor, poll_interval: float = 0.05) -> None:
    """Wait until the card has run the work queued so far on the current
    stream of each CUDA tensor's device (with no tensors, of the current
    device, when CUDA is initialised), checking the calling thread's token
    at least every ``poll_interval`` seconds. CPU tensors are ready when
    they exist: only the token is checked."""
    token = Interruptible.get_token()
    devs = {t.device for t in tensors if t.is_cuda}
    if not tensors and torch.cuda.is_initialized():
        devs = {torch.device("cuda", torch.cuda.current_device())}
    events = []
    for dev in devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    wait = min(1e-4, poll_interval)
    while not all(ev.query() for ev in events):
        token.interruptible_check()
        time.sleep(wait)
        wait = min(2 * wait, poll_interval)
    token.interruptible_check()
