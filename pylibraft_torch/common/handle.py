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

import torch

from raft_tpu_torch.core.resources import DeviceResources as _PortResources


class DeviceResources(_PortResources):
    """Ref common/handle.pyx:34, the handle passed to every pylibraft
    call: ``DeviceResources(device=None, seed=None)`` pins the device
    (``cuda`` by default; raises :class:`CudaError` without a card) and
    seeds the handle's generator."""

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
