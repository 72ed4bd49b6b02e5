"""B5's launch choice and its C binding, on the CPU.

``_b5_plan`` decides whether kernel B5 (``csrc/stream_select.cu``) reads
its keys with 16-byte loads: only when every row of the (batch, n) keys
starts on 16 bytes. The C entry refuses a 16-byte launch that breaks this,
so the plan is held here to that contract over row lengths and pointer
offsets, on real CPU tensors (the card tests run the same views through
the kernel). The ctypes argument list is held to the C prototype, which
the CPU cannot otherwise check.
"""

import ctypes
import re

import pytest
import torch

from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops import stream_select as ss

_LENGTHS = (1, 2, 3, 4, 5, 300, 511, 512, 513, 8190, 8192, 9000, 65535,
            65536, 100_001, 131072, 262144)


def _view(rows: int, length: int, offset: int) -> torch.Tensor:
    buf = torch.empty(rows * length + offset, dtype=torch.float32)
    return buf[offset:].view(rows, length)


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("length", _LENGTHS)
def test_plan_takes_16_byte_loads_only_on_aligned_rows(length, offset):
    keys = _view(3, length, offset)
    assert keys.is_contiguous()
    vec = ss._b5_plan(length, keys.data_ptr())
    starts = [keys[r].data_ptr() for r in range(3)]
    assert vec == all(p % 16 == 0 for p in starts)


def test_plan_of_a_fresh_tensor_is_16_byte():
    """A fresh allocation with n % 4 == 0 (every shape on the main path)
    takes the 16-byte loads."""
    for length in (65536, 131072, 262144):
        keys = torch.empty((8, length))
        assert ss._b5_plan(length, keys.data_ptr())


def test_argtypes_follow_the_c_prototype():
    text = (_build.CSRC_DIR / "stream_select.cu").read_text()
    proto = re.search(r"int stream_extract_launch\(([^)]*)\)", text)
    params = [p.strip() for p in proto.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert ss._ARGTYPES == want
