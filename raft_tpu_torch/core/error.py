"""Error handling: exception hierarchy and precondition helpers.

Port of ``raft_tpu/core/error.py`` (the ``RAFT_EXPECTS`` / ``RAFT_FAIL``
analogs), with ``CudaError`` raised for device and kernel failures.
"""

from __future__ import annotations

from typing import NoReturn

import torch

from raft_tpu_torch.core.nvtx import range_scope


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


def expects_finite(name: str, *tensors) -> None:
    """Raise :class:`LogicError` when a floating operand holds NaN or
    +-inf. One ``isfinite().all()`` pass per operand and one host sync per
    call; the public entry points call it on the vectors the caller hands
    them, and what they derive from those is not checked again.
    Non-floating operands (int8 / uint8 datasets) and empty ones are
    skipped. The sync is traced as ``sync.finite``."""
    flags = [torch.isfinite(t).all() for t in tensors
             if torch.is_floating_point(t) and t.numel()]
    if not flags:
        return
    with range_scope("sync.finite"):
        finite = bool(torch.stack(flags).all())
    if not finite:
        raise LogicError(f"{name}: inputs must be finite (found NaN or inf)")
