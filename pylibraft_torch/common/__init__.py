"""pylibraft_torch.common: handles, arrays, wrappers.

Ref: python/pylibraft/pylibraft/common/__init__.py (exports Handle,
DeviceResources, Stream, device_ndarray, cai_wrapper, ai_wrapper).
"""

from pylibraft_torch.common.ai_wrapper import ai_wrapper, cai_wrapper
from pylibraft_torch.common.cuda import Stream
from pylibraft_torch.common.device_ndarray import device_ndarray
from pylibraft_torch.common.handle import (
    DeviceResources,
    Handle,
    auto_sync_handle,
)
from pylibraft_torch.common.interruptible import (
    cuda_interruptible,
    synchronize,
)
from pylibraft_torch.common.outputs import auto_convert_output, set_output_as


__all__ = [
    "DeviceResources",
    "Handle",
    "Stream",
    "ai_wrapper",
    "auto_convert_output",
    "auto_sync_handle",
    "cai_wrapper",
    "cuda_interruptible",
    "device_ndarray",
    "set_output_as",
    "synchronize",
]
