"""RMM ``device_ndarray`` analog backed by a ``torch.Tensor``.

Ref: python/pylibraft/pylibraft/common/device_ndarray.py:24-147: the
constructor copies a host array to the device, ``empty`` / ``zeros`` /
``ones`` allocate there, ``copy_to_host`` and ``__array__`` bring it
back. The device is ``cuda`` unless the caller names another (``"cpu"``);
``.array`` is the tensor itself, with no copy.

numpy has no bfloat16, so a bf16 array reports ``dtype`` float32 and
``copy_to_host`` returns its values widened to float32, which holds every
bf16 value exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.resources import DeviceLike, resolve_device


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a tensor's host copy (float32 for bfloat16)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(str(dtype).removeprefix("torch."))


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (bfloat16 widened to float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _alloc(fill, shape, dtype, device) -> torch.Tensor:
    dt = np.dtype(dtype)
    return fill(shape, dtype=getattr(torch, dt.name),
                device=resolve_device(device))


class device_ndarray:
    """Device-resident ndarray; a thin wrapper over a ``torch.Tensor``."""

    def __init__(self, np_ndarray, device: DeviceLike = None):
        """Copy a host array to ``device`` (``cuda`` by default; ref
        device_ndarray.py:24-63)."""
        dev = resolve_device(device)
        if isinstance(np_ndarray, torch.Tensor):
            self._array = np_ndarray.detach().to(dev, copy=True)
        else:
            self._array = torch.as_tensor(np.array(np_ndarray), device=dev)

    @classmethod
    def from_torch(cls, t: torch.Tensor) -> "device_ndarray":
        """Wrap ``t`` where it lies, with no copy."""
        out = cls.__new__(cls)
        out._array = t
        return out

    @classmethod
    def empty(cls, shape, dtype=np.float32, order="C",
              device: DeviceLike = None):
        """Ref device_ndarray.py:65-85."""
        return cls.from_torch(_alloc(torch.empty, shape, dtype, device))

    @classmethod
    def zeros(cls, shape, dtype=np.float32, order="C",
              device: DeviceLike = None):
        return cls.from_torch(_alloc(torch.zeros, shape, dtype, device))

    @classmethod
    def ones(cls, shape, dtype=np.float32, order="C",
             device: DeviceLike = None):
        return cls.from_torch(_alloc(torch.ones, shape, dtype, device))

    @property
    def array(self) -> torch.Tensor:
        return self._array

    @property
    def shape(self):
        return tuple(self._array.shape)

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self._array.dtype)

    @property
    def ndim(self) -> int:
        return self._array.ndim

    @property
    def size(self) -> int:
        return self._array.numel()

    @property
    def c_contiguous(self) -> bool:
        """Ref device_ndarray.py:96-110."""
        return self._array.is_contiguous()

    @property
    def f_contiguous(self) -> bool:
        t = self._array
        return t.ndim <= 1 or t.permute(
            *reversed(range(t.ndim))).is_contiguous()

    def copy_to_host(self) -> np.ndarray:
        """Ref device_ndarray.py:139-147 (bfloat16 comes back as
        float32)."""
        return to_host(self._array)

    def __array__(self, dtype=None, copy=None):
        host = self.copy_to_host()
        return host if dtype is None else host.astype(dtype)

    def __len__(self) -> int:
        return int(self._array.shape[0])

    def __getitem__(self, item):
        return device_ndarray.from_torch(self._array[item])

    def __repr__(self) -> str:
        return f"device_ndarray({self._array!r})"
