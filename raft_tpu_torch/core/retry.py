"""Deterministic retry/backoff for eager host-side operations.

Port of ``raft_tpu/core/retry.py``, unchanged in behaviour: the policy
the serving ``Searcher`` threads through its dispatch
(``serve/searcher.py``) and the reference's host-side call sites use.

Design constraints:

* **Deterministic**: the backoff sequence is a pure function of the
  policy (no wall-clock jitter, no randomness), so tests assert the exact
  attempt/delay schedule and a failure replays bit for bit.
* **Cause chain**: every re-raise chains the previous attempt's error
  via ``__cause__``; exhaustion raises the ORIGINAL (last) error type,
  never a wrapper, so callers' ``except OSError`` handlers keep working
  and the full attempt history is in the traceback.
* **Injectable clock/sleep**: tests pass fake ``sleep``/``monotonic`` so
  schedules are asserted without waiting.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from raft_tpu_torch.core.error import RaftError, expects


class RetryExhausted(RaftError):
    """Internal marker re-raised only when an attempt raised nothing
    usable (never under normal operation — exhaustion re-raises the last
    attempt's original error, cause-chained)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Retry schedule for one eager host-side op.

    ``max_attempts`` total attempts (1 = no retry). The delay before
    re-attempt ``i`` (1-based) is ``base_delay * backoff**(i-1)`` capped
    at ``max_delay`` — deterministic exponential backoff with no
    wall-clock randomness. ``attempt_timeout`` bounds one attempt: an
    attempt whose wall time (injectable ``monotonic``) exceeds it is
    treated as failed even if it eventually returned, and its result is
    discarded (the cooperative analog of a transfer timeout — host calls
    cannot be preempted mid-flight). ``retry_on`` lists the exception
    types considered transient; anything else propagates immediately.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    backoff: float = 2.0
    max_delay: float = 2.0
    attempt_timeout: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (OSError, RuntimeError)

    def __post_init__(self):
        expects(self.max_attempts >= 1, "max_attempts must be >= 1, got %s",
                self.max_attempts)
        expects(self.base_delay >= 0.0, "base_delay must be >= 0")
        expects(self.backoff >= 1.0, "backoff must be >= 1")

    def delays(self) -> Tuple[float, ...]:
        """The full deterministic backoff sequence: the delay slept before
        each re-attempt (``max_attempts - 1`` entries)."""
        return tuple(min(self.base_delay * self.backoff ** i, self.max_delay)
                     for i in range(self.max_attempts - 1))


#: Policy for index save/load IO (NFS/GCS-style blips: short, few).
DEFAULT_IO_RETRY = RetryPolicy(max_attempts=3, base_delay=0.05,
                               retry_on=(OSError,))

#: Policy for host-side collective transfers and the multi-host
#: bootstrap (transport failures surface as RuntimeError).
DEFAULT_COMM_RETRY = RetryPolicy(max_attempts=3, base_delay=0.1,
                                 retry_on=(OSError, RuntimeError))


class AttemptTimeout(RaftError, TimeoutError):
    """An attempt exceeded ``RetryPolicy.attempt_timeout`` (cooperative:
    measured after the call returns; the slow result is discarded)."""


def with_retry(fn: Callable[[], object],
               policy: RetryPolicy = RetryPolicy(),
               *,
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               sleep: Callable[[float], None] = time.sleep,
               monotonic: Callable[[], float] = time.monotonic):
    """Run the zero-argument ``fn()`` under ``policy``.

    ``fn`` takes no arguments by design — bind the op's arguments with a
    lambda/partial (or use :func:`retrying`), so the retry-control
    keywords here can never collide with the wrapped op's own kwargs.

    Retries only exceptions matching ``policy.retry_on`` (plus
    :class:`AttemptTimeout` from the attempt-timeout check), sleeping the
    policy's deterministic backoff between attempts. ``on_retry(attempt,
    err)`` is called before each re-attempt (attempt is the 1-based index
    of the FAILED attempt) — the hook callers use to log or feed a health
    registry.

    On exhaustion the LAST attempt's original exception is re-raised,
    with each earlier attempt's error chained via ``__cause__`` — the
    original type survives (``except OSError`` still catches it) and the
    whole attempt history prints in the traceback.
    """
    delays = policy.delays()
    last_err: Optional[BaseException] = None
    retryable = tuple(policy.retry_on) + (AttemptTimeout,)
    for attempt in range(1, policy.max_attempts + 1):
        t0 = monotonic()
        try:
            result = fn()
            if (policy.attempt_timeout is not None
                    and monotonic() - t0 > policy.attempt_timeout):
                raise AttemptTimeout(
                    "attempt %s exceeded attempt_timeout=%ss"
                    % (attempt, policy.attempt_timeout))
            return result
        except retryable as err:
            if (last_err is not None and err is not last_err
                    and err.__cause__ is None):
                # Chain attempt history: each error points at the one
                # before it, so exhaustion shows the full sequence.
                err.__cause__ = last_err
            last_err = err
            if attempt == policy.max_attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, err)
            sleep(delays[attempt - 1])
    raise RetryExhausted("unreachable: loop exits by return or raise")


def retrying(policy: RetryPolicy = RetryPolicy(), **retry_kwargs):
    """Decorator form of :func:`with_retry` for call sites that wrap a
    whole function (``@retrying(DEFAULT_IO_RETRY)``). ``retry_kwargs``
    are with_retry's control keywords (on_retry/sleep/monotonic) only;
    the wrapped function's own arguments pass through untouched."""

    def wrap(fn: Callable) -> Callable:
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return with_retry(lambda: fn(*args, **kwargs), policy,
                              **retry_kwargs)

        return wrapped

    return wrap
