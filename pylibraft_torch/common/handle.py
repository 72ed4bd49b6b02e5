"""DeviceResources handle + auto_sync_handle decorator.

Ref: python/pylibraft/pylibraft/common/handle.pyx:34 (``DeviceResources``
wrapping ``raft::device_resources``) and :209 (``auto_sync_handle``, which
creates a default handle when the caller passes none and syncs it after
the call). The port's handle is a
:class:`raft_tpu_torch.core.resources.DeviceResources` (an explicit
``torch.device``, ``cuda`` unless given, and a seeded generator), so every
facade hands it on to the ``raft_tpu_torch`` call as it is.

Unlike ``pylibraft/common/handle.py``, whose ``sync`` swallows every
exception, a failed synchronise propagates here.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from raft_tpu_torch.core.resources import DeviceLike
from raft_tpu_torch.core.resources import DeviceResources as _PortResources


class DeviceResources(_PortResources):
    """Ref common/handle.pyx:34, the handle passed to every pylibraft
    call: ``DeviceResources(n_streams=0, device=None, seed=None)`` takes
    the reference's ``n_streams`` first and keeps it (the port runs on
    the device's current stream, so it changes nothing), pins the device
    (``cuda`` by default; raises :class:`CudaError` without a card) and
    seeds the handle's generator."""

    def __init__(self, n_streams: int = 0, device: DeviceLike = None,
                 seed: Optional[int] = None):
        super().__init__(device, seed)
        self.n_streams = n_streams

    def getHandle(self):
        return self

    def sync(self) -> None:
        """Block until the work queued on the handle's device has run
        (ref handle.pyx ``sync``). Nothing waits on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# The reference's legacy name (ref common/handle.pyx:232).
Handle = DeviceResources


def auto_sync_handle(f):
    """Ref common/handle.pyx:209: inject a fresh handle (on ``cuda``) when
    absent, sync it after the wrapped call returns."""

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        sync_after = kwargs.get("handle") is None
        if sync_after:
            kwargs["handle"] = DeviceResources()
        handle = kwargs["handle"]
        ret = f(*args, **kwargs)
        if sync_after:
            handle.sync()
        return ret

    return wrapper
