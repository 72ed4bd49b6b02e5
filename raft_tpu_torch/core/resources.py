"""Device handle.

Port of ``raft_tpu/core/resources.py``: the handle is a thin holder of an
explicit ``torch.device``, which defaults to ``cuda``. Entry points move
numpy (and other non-tensor) inputs to the handle's device and leave tensor
inputs where they are, so CPU tensors select the CPU. Asking for ``cuda``
on a machine without a card raises: nothing carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from raft_tpu_torch.core.error import CudaError, expects

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device`` (``cuda`` when None); raises
    :class:`CudaError` when CUDA is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaError(f"device {dev} requested but CUDA is not available")
    return dev


class Resources:
    """Handle over one explicit device (default ``cuda``)."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._comms = None

    # The injected communicator (``comms.inject_comms_on_handle``).
    def set_comms(self, comms) -> None:
        self._comms = comms

    def get_comms(self):
        expects(self._comms is not None, "no communicator injected on handle")
        return self._comms

    def comms_initialized(self) -> bool:
        return self._comms is not None

    def __repr__(self) -> str:  # pragma: no cover
        return f"Resources(device={self.device})"


def as_tensor(x, handle: Optional[Resources] = None,
              device: DeviceLike = None) -> torch.Tensor:
    """A tensor stays where it is; anything else (numpy, lists) moves to
    ``handle.device``, else to ``device``, else to ``cuda``."""
    if isinstance(x, torch.Tensor):
        return x
    if handle is not None:
        dev = handle.device
    else:
        dev = resolve_device(device)
    return torch.as_tensor(np.asarray(x), device=dev)


def as_vectors(x, handle: Optional[Resources] = None,
               device: DeviceLike = None) -> torch.Tensor:
    """:func:`as_tensor` for vectors a caller hands an entry point:
    float64 maps to float32, as the reference's ``jnp.asarray`` maps it
    with x64 off; every other dtype (f32, f16, bf16, int8, uint8) stays."""
    t = as_tensor(x, handle, device)
    return t.float() if t.dtype == torch.float64 else t


def as_float(x, handle: Optional[Resources] = None,
             device: DeviceLike = None) -> torch.Tensor:
    """:func:`as_vectors`, with non-floating inputs mapped to float32."""
    t = as_vectors(x, handle, device)
    return t if t.is_floating_point() else t.float()
