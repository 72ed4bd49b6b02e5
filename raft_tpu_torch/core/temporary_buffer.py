"""Scoped host-to-device staging buffer.

Port of ``raft_tpu/core/temporary_buffer.py`` (RAFT's
``temporary_device_buffer``): a context manager that stages a numpy array
on a device (``cuda`` by default) and, for the writeback variant, copies
the device value back into the original array when the scope ends without
an exception. The staged tensor may be changed in place or replaced by
assigning ``buf.value``.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.resources import DeviceLike, resolve_device


class TemporaryDeviceBuffer:
    """Device staging of a host ndarray, optionally written back on exit."""

    def __init__(self, data: np.ndarray, writeback: bool = False,
                 device: DeviceLike = None):
        self._host = data
        self._writeback = writeback
        # A copy on every device, so that only writeback reaches ``data``.
        self.value = torch.tensor(np.asarray(data),
                                  device=resolve_device(device))

    def view(self) -> torch.Tensor:
        """The device-resident tensor."""
        return self.value

    def __enter__(self) -> "TemporaryDeviceBuffer":
        return self

    def __exit__(self, *exc) -> None:
        if self._writeback and exc[0] is None:
            np.copyto(self._host, self.value.cpu().numpy())


def make_temporary_device_buffer(data: np.ndarray, device: DeviceLike = None
                                 ) -> TemporaryDeviceBuffer:
    """Read-write staging without writeback."""
    return TemporaryDeviceBuffer(data, writeback=False, device=device)


def make_readonly_temporary_device_buffer(data: np.ndarray,
                                          device: DeviceLike = None
                                          ) -> TemporaryDeviceBuffer:
    """Read-only staging."""
    return TemporaryDeviceBuffer(data, writeback=False, device=device)


def make_writeback_temporary_device_buffer(data: np.ndarray,
                                           device: DeviceLike = None
                                           ) -> TemporaryDeviceBuffer:
    """Staging whose final ``value`` is copied back into ``data`` on a
    clean exit."""
    return TemporaryDeviceBuffer(data, writeback=True, device=device)
