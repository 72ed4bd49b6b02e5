"""Scoped profiler ranges in named domains.

Port of ``raft_tpu/core/nvtx.py`` (RAFT's ``core/nvtx.hpp``). A range opens
``torch.profiler.record_function("<domain>::<name>")``, so it shows in a
``torch.profiler`` trace, and, when the process has a card, an NVTX range
of the same label, for Nsight. Labels of :func:`traced` entry points read
``<leaf module>.<function>``, e.g. ``raft_tpu_torch::masked_nn.masked_l2_nn``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, List, Optional, Tuple

import torch

_tls = threading.local()


def _stack() -> List[Tuple[object, bool]]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def _open(label: str) -> Tuple[object, bool]:
    rf = torch.profiler.record_function(label)
    rf.__enter__()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(label)
    return rf, nvtx


def _close(entry: Tuple[object, bool]) -> None:
    rf, nvtx = entry
    if nvtx:
        torch.cuda.nvtx.range_pop()
    rf.__exit__(None, None, None)


@contextlib.contextmanager
def range_scope(name: str, domain: str = "raft_tpu_torch") -> Iterator[None]:
    """A trace range over the ``with`` body."""
    entry = _open(f"{domain}::{name}")
    try:
        yield
    finally:
        _close(entry)


def traced(fn=None, *, name: Optional[str] = None,
           domain: str = "raft_tpu_torch"):
    """Decorator: a range over every call of ``fn``, labelled ``name`` or
    ``<leaf module>.<function>``."""

    def deco(f):
        label = name or f"{f.__module__.rsplit('.', 1)[-1]}.{f.__name__}"

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with range_scope(label, domain):
                return f(*args, **kwargs)

        return wrapper

    return deco(fn) if fn is not None else deco


def push_range(name: str, domain: str = "raft_tpu_torch") -> None:
    """Open a range on this thread's stack (prefer :func:`range_scope`)."""
    _stack().append(_open(f"{domain}::{name}"))


def pop_range() -> None:
    """Close this thread's innermost range opened by :func:`push_range`."""
    stack = _stack()
    if stack:
        _close(stack.pop())
