"""Hand-written CUDA kernels and their plain PyTorch versions.

The package exports the fused kNN function; import the module of the same
name with ``importlib.import_module("raft_tpu_torch.ops.fused_knn")``.
"""

from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_supported

__all__ = [
    "fused_knn",
    "fused_knn_supported",
]
