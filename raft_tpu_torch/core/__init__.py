"""Core runtime: the resource handle, typed array views, errors, retry,
logging, trace ranges, cancellation, serialization and operators."""

from raft_tpu_torch.core.resources import (
    DeviceResources,
    Resources,
    resource_factory,
)
from raft_tpu_torch.core.error import (
    LogicError,
    RaftError,
    expects,
    fail,
)
from raft_tpu_torch.core.retry import (
    DEFAULT_COMM_RETRY,
    DEFAULT_IO_RETRY,
    RetryPolicy,
    retrying,
    with_retry,
)
from raft_tpu_torch.core.mdarray import (
    ArraySpec,
    MemoryType,
    as_array,
    check_matrix,
    check_vector,
    col_major,
    row_major,
)
from raft_tpu_torch.core.kvp import KeyValuePair
from raft_tpu_torch.core import operators
from raft_tpu_torch.core.serialize import (
    deserialize_mdspan,
    deserialize_scalar,
    serialize_mdspan,
    serialize_scalar,
)
from raft_tpu_torch.core.interruptible import Interruptible, synchronize
from raft_tpu_torch.core.logger import logger, set_level
from raft_tpu_torch.core.nvtx import pop_range, push_range, range_scope
from raft_tpu_torch.core import math
from raft_tpu_torch.core.temporary_buffer import (
    TemporaryDeviceBuffer,
    make_readonly_temporary_device_buffer,
    make_temporary_device_buffer,
    make_writeback_temporary_device_buffer,
)

__all__ = [
    "Resources",
    "DeviceResources",
    "resource_factory",
    "RaftError",
    "LogicError",
    "expects",
    "fail",
    "RetryPolicy",
    "with_retry",
    "retrying",
    "DEFAULT_IO_RETRY",
    "DEFAULT_COMM_RETRY",
    "MemoryType",
    "ArraySpec",
    "check_matrix",
    "check_vector",
    "as_array",
    "row_major",
    "col_major",
    "KeyValuePair",
    "operators",
    "serialize_mdspan",
    "deserialize_mdspan",
    "serialize_scalar",
    "deserialize_scalar",
    "Interruptible",
    "synchronize",
    "logger",
    "set_level",
    "range_scope",
    "push_range",
    "pop_range",
    "math",
    "TemporaryDeviceBuffer",
    "make_temporary_device_buffer",
    "make_readonly_temporary_device_buffer",
    "make_writeback_temporary_device_buffer",
]
