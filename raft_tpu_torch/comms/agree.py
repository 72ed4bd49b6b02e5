"""Agreement of rank-local outcomes before a collective depends on them.

The reference runs one controller over a ``jax`` mesh, so a failure, a
file check or a clock reading is seen once. The port runs one process
per rank (SPMD), and a decision that one rank makes from its own clock,
files or errors must reach every rank before any collective depends on
it: a rank that raised or retried alone would leave the others waiting in
a collective it never enters (on the card, a hang). Each helper here is
one agreement point that every rank reaches, contributes its outcome to,
and leaves with the same outcome:

* :func:`agree_error` / :func:`raise_agreed`: every rank's optional
  exception in, the lowest failing rank's exception out on every rank
  (one allgather of a flag; a broadcast of the pickled error only when a
  rank failed), so every rank raises the same type with the same text;
  :func:`agreed` is the ``with`` block form;
* :func:`root_value`: rank 0's picklable value on every rank;
* :func:`with_agreed_retry`: ``core/retry.with_retry`` whose attempts end
  at an agreement point, so every rank retries together under the same
  deterministic backoff, or every rank raises the original type.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import time
from typing import Callable, Optional

import torch

from raft_tpu_torch.comms.comms import Comms
from raft_tpu_torch.core.error import RaftError
from raft_tpu_torch.core.retry import (AttemptTimeout, RetryPolicy,
                                       with_retry)

__all__ = ["agree_error", "raise_agreed", "agreed", "root_value",
           "with_agreed_retry"]


def _bcast_bytes(comms: Comms, data: Optional[bytes], root: int) -> bytes:
    """``root``'s bytes on every rank (a length, then the payload)."""
    mine = comms.get_rank() == root
    n = int(comms.bcast(torch.tensor([len(data) if mine else 0]),
                        root=root)[0])
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8) if mine
           else torch.zeros(n, dtype=torch.uint8))
    return bytes(comms.bcast(buf, root=root).numpy())


def _portable(err: BaseException) -> bytes:
    """``err`` pickled, or a RaftError with its text when it does not
    pickle (a peer rebuilds it from these bytes)."""
    try:
        data = pickle.dumps(err)
        pickle.loads(data)
        return data
    except Exception:
        return pickle.dumps(RaftError(f"{type(err).__name__}: {err}"))


def agree_error(comms: Comms,
                err: Optional[BaseException]) -> Optional[BaseException]:
    """Collective: ``None`` on every rank when no rank passed an error,
    else the lowest failing rank's error on every rank (its own object
    there, an unpickled copy elsewhere, with ``agreed_from_rank`` set)."""
    flags = comms.allgather(torch.tensor([0 if err is None else 1]))
    failed = torch.nonzero(flags).reshape(-1)
    if failed.numel() == 0:
        return None
    src = int(failed[0])
    data = _bcast_bytes(comms, _portable(err) if comms.get_rank() == src
                        else None, src)
    if comms.get_rank() == src:
        return err
    copy = pickle.loads(data)
    copy.agreed_from_rank = src
    return copy


def raise_agreed(comms: Comms, err: Optional[BaseException]) -> None:
    """:func:`agree_error`, raising the agreed error on every rank."""
    err = agree_error(comms, err)
    if err is not None:
        raise err


@contextlib.contextmanager
def agreed(comms: Optional[Comms]):
    """``with agreed(comms): ...`` runs the block on every rank, and a
    failure in it on any rank raises the same error on every rank at the
    block's end (:func:`raise_agreed`). Collective. A collective inside
    the block must be one no rank can fail alone: a rank that raises
    before reaching it leaves the others waiting there. With ``comms``
    None the block runs as it is."""
    if comms is None:
        yield
        return
    err = None
    try:
        yield
    except Exception as e:       # agreed below, re-raised on every rank
        err = e
    raise_agreed(comms, err)


def root_value(comms: Comms, value=None):
    """Collective: rank 0's ``value`` (picklable) on every rank."""
    data = pickle.dumps(value) if comms.get_rank() == 0 else None
    return pickle.loads(_bcast_bytes(comms, data, 0))


def with_agreed_retry(fn: Callable[[], object], policy: RetryPolicy,
                      comms: Comms, *,
                      sleep: Callable[[float], None] = time.sleep,
                      monotonic: Callable[[], float] = time.monotonic):
    """``with_retry(fn, policy)`` over a collective ``fn``: after each
    attempt the ranks agree on its outcome (:func:`agree_error`; an
    attempt that outlived ``policy.attempt_timeout`` on any rank failed
    on every rank), then every rank retries under the same deterministic
    backoff, or every rank raises the original exception type. A failure
    is agreed at the end of an attempt, so ``fn`` must raise only outside
    its collectives (before the first, or after the last, on every rank's
    way to the agreement point)."""

    def attempt():
        t0 = monotonic()
        out = None
        with agreed(comms):
            out = fn()
            if (policy.attempt_timeout is not None
                    and monotonic() - t0 > policy.attempt_timeout):
                raise AttemptTimeout(
                    "attempt exceeded attempt_timeout=%ss"
                    % policy.attempt_timeout)
        return out

    return with_retry(attempt, dataclasses.replace(policy,
                                                   attempt_timeout=None),
                      sleep=sleep, monotonic=monotonic)
