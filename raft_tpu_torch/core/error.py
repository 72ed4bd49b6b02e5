"""Error handling: exception hierarchy and precondition helpers.

Port of ``raft_tpu/core/error.py`` (the ``RAFT_EXPECTS`` / ``RAFT_FAIL``
analogs), with ``CudaError`` raised for device and kernel failures.
"""

from __future__ import annotations

from typing import NoReturn


class RaftError(Exception):
    """Base exception for raft_tpu_torch."""


class LogicError(RaftError, ValueError):
    """Invalid arguments / broken preconditions."""


class CudaError(RaftError):
    """A CUDA device, build or kernel-launch failure."""


def expects(cond: bool, msg: str = "precondition violated", *args) -> None:
    """Raise :class:`LogicError` when ``cond`` is falsy; ``msg`` is a lazy
    %-format of ``args``."""
    if not cond:
        raise LogicError(msg % args if args else msg)


def fail(msg: str, *args) -> NoReturn:
    """Unconditional failure, lazily %-formatted like :func:`expects`."""
    raise LogicError(msg % args if args else msg)
