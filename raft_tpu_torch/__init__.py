"""raft_tpu_torch: the PyTorch and CUDA port of raft_tpu for NVIDIA Hopper.

The module tree mirrors ``raft_tpu/`` file for file. Plain tensor code is
PyTorch; every Pallas kernel of ``raft_tpu`` on a ported path is a
hand-written CUDA kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``).

Two rules hold everywhere:

* entry points run on the card unless the caller asks for the CPU: numpy
  inputs move to the handle's device (``cuda`` by default, and a missing
  card raises); tensor inputs stay where they are;
* a kernel wrapper takes its plain PyTorch version only for CPU tensors.
  For CUDA tensors it builds and launches the kernel, or raises.

This package imports neither ``jax`` nor ``raft_tpu``.
"""

__version__ = "0.1.0"

from raft_tpu_torch.core.resources import DeviceResources, Resources

__all__ = [
    "Resources",
    "DeviceResources",
    "__version__",
]
