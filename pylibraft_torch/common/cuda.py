"""Stream handle.

Ref: python/pylibraft/pylibraft/common/cuda.pyx, a thin ``Stream`` class
over ``cudaStream_t`` (create / sync / destroy) handed to
``DeviceResources``. The port's ``Stream`` is a handle on a device's
current stream at construction (``cuda`` unless a device is given).

Unlike ``pylibraft/common/cuda.py``, whose ``sync`` swallows every
exception, a failed synchronise propagates here.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import DeviceLike, resolve_device


class Stream:
    """Ref: common/cuda.pyx ``Stream``: the current stream of ``device``
    (``cuda`` by default; raises :class:`CudaError` without a card). The
    CPU has no stream: there ``sync`` returns at once."""

    def __init__(self, device: DeviceLike = None):
        self._device = resolve_device(device)
        self._stream = (torch.cuda.current_stream(self._device)
                        if self._device.type == "cuda" else None)

    @property
    def device(self) -> torch.device:
        return self._device

    def sync(self) -> None:
        """Block until the work queued on the stream has run (ref:
        cuda.pyx Stream.sync -> cudaStreamSynchronize)."""
        if self._stream is not None:
            self._stream.synchronize()

    def get_ptr(self) -> int:
        """The ``cudaStream_t`` handle as an int (ref: cuda.pyx
        getStream); 0 on the CPU."""
        return 0 if self._stream is None else int(self._stream.cuda_stream)
