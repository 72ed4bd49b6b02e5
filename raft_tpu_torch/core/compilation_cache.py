"""The port's persistent kernel build cache.

Port of ``raft_tpu/core/compilation_cache.py``. The reference turns on
XLA's persistent compilation cache; the port's counterpart is the
directory its CUDA kernel libraries are built into and loaded from
(``ops/_build.py``), so a process reuses every library an earlier one
built from the same sources.
"""

from raft_tpu_torch.ops._build import enable_compilation_cache

__all__ = ["enable_compilation_cache"]
