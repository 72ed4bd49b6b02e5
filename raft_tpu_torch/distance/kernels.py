"""Gram (kernel) matrices for SVM-style workloads.

Port of ``raft_tpu/distance/kernels.py`` (RAFT's ``distance/kernels.cuh``):
each kernel is ``f(x . y^T)`` or ``f(|x - y|^2)``, a full-f32 product and
an elementwise epilogue. RBF takes the expanded L2 of
``distance/pairwise.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.distance.distance_types import KernelType
from raft_tpu_torch.distance.pairwise import gram, l2_expanded


@dataclasses.dataclass
class KernelParams:
    """``kernels::KernelParams``: the kernel and its degree, gamma and
    coef0."""

    kernel: KernelType = KernelType.LINEAR
    degree: int = 3
    gamma: float = 1.0
    coef0: float = 0.0


class GramMatrixBase:
    """The linear gram matrix ``x . y^T``."""

    def __call__(self, x, y) -> torch.Tensor:
        x = as_array(x)
        return self.evaluate(x, as_array(y, device=x.device))

    def evaluate(self, x, y) -> torch.Tensor:
        return gram(x, y)


class PolynomialKernel(GramMatrixBase):
    """``(gain x . y^T + offset) ^ exponent``."""

    def __init__(self, exponent: int = 3, gain: float = 1.0,
                 offset: float = 0.0):
        self.exponent = exponent
        self.gain = gain
        self.offset = offset

    def evaluate(self, x, y) -> torch.Tensor:
        return (self.gain * gram(x, y) + self.offset) ** self.exponent


class TanhKernel(GramMatrixBase):
    """``tanh(gain x . y^T + offset)``."""

    def __init__(self, gain: float = 1.0, offset: float = 0.0):
        self.gain = gain
        self.offset = offset

    def evaluate(self, x, y) -> torch.Tensor:
        return torch.tanh(self.gain * gram(x, y) + self.offset)


class RBFKernel(GramMatrixBase):
    """``exp(-gain |x - y|^2)``, on the expanded L2."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def evaluate(self, x, y) -> torch.Tensor:
        return torch.exp(-self.gain * l2_expanded(x, y, sqrt=False))


def kernel_factory(params: KernelParams) -> GramMatrixBase:
    """The kernel of ``params``."""
    if params.kernel == KernelType.LINEAR:
        return GramMatrixBase()
    if params.kernel == KernelType.POLYNOMIAL:
        return PolynomialKernel(params.degree, params.gamma, params.coef0)
    if params.kernel == KernelType.TANH:
        return TanhKernel(params.gamma, params.coef0)
    if params.kernel == KernelType.RBF:
        return RBFKernel(params.gamma)
    raise ValueError(f"unknown kernel type {params.kernel!r}")
