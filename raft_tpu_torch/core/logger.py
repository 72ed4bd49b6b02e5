"""Singleton logger with settable level and callback sinks.

Port of ``raft_tpu/core/logger.py``: the same API on
``logging.getLogger("raft_tpu_torch")`` (the logger every module of the
port writes to), with the custom TRACE level, a ``logger.trace`` method
and a user callback sink with a flush hook.
"""

from __future__ import annotations

import logging
import types
from typing import Callable, Optional

# Level names mirror the reference's RAFT_LEVEL_* (core/logger.hpp:40-57).
OFF = logging.CRITICAL + 10
CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARN = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
TRACE = logging.DEBUG - 5

logging.addLevelName(TRACE, "TRACE")

logger = logging.getLogger("raft_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] [%(asctime)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(WARN)


def _trace_method(self: logging.Logger, msg: str, *args, **kwargs) -> None:
    """``logger.trace(...)`` for the custom TRACE level, guarded by
    ``isEnabledFor`` so per-batch serving paths pay one int compare when
    TRACE is off."""
    if self.isEnabledFor(TRACE):
        self._log(TRACE, msg, args, **kwargs)


# Bound onto THIS logger instance only: patching logging.Logger would leak
# the convention into every library in the process.
logger.trace = types.MethodType(_trace_method, logger)


class CallbackSink(logging.Handler):
    """Route formatted log lines to a Python callable, with an optional
    flush hook."""

    def __init__(
        self,
        callback: Callable[[int, str], None],
        flush: Optional[Callable[[], None]] = None,
    ):
        super().__init__()
        self._callback = callback
        self._flush = flush

    def emit(self, record: logging.LogRecord) -> None:
        self._callback(record.levelno, self.format(record))

    def flush(self) -> None:
        if self._flush is not None:
            self._flush()


def set_level(level: int) -> None:
    """Set the global raft_tpu_torch log level."""
    logger.setLevel(level)


def set_callback(
    callback: Callable[[int, str], None],
    flush: Optional[Callable[[], None]] = None,
) -> CallbackSink:
    """Install a callback sink and return it (remove with
    ``logger.removeHandler``)."""
    sink = CallbackSink(callback, flush)
    logger.addHandler(sink)
    return sink


def trace(msg: str, *args) -> None:
    """Module-level alias of :meth:`logger.trace`."""
    logger.trace(msg, *args)
