"""BLAS-level wrappers: gemm / gemv / dot / axpy / transpose.

Port of ``raft_tpu/linalg/blas.py``. Products run through
``torch.matmul`` (cuBLAS on the card) in full f32. This module owns that
choice for the port: importing it switches TF32 off for the process, and
:func:`full_f32_matmul`, which these wrappers and
``distance.pairwise.gram`` compute every product with, holds full f32
for the product if a caller switched TF32 back on.

``precision`` takes the reference's names: None, ``"default"``,
``"high"`` or ``"highest"`` (:data:`DEFAULT_PRECISION`). The reference
trades accuracy for speed below ``"highest"`` on the TPU's bf16 units;
the port computes at full f32 for each of them and only checks the name.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array, torch_dtype

# The reference's default, full f32 (its Precision.HIGHEST).
DEFAULT_PRECISION = "highest"
PRECISIONS = (None, "default", "high", "highest")

# Full-f32 products by default, for the port's products outside
# full_f32_matmul too.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# Serialises full_f32_matmul's switch and restore of the process-wide
# setting between threads.
_PRECISION_LOCK = threading.Lock()


def resolve_precision(precision) -> str:
    """Check a ``precision`` argument (one of :data:`PRECISIONS`) and
    return its name, None being the default; every one of them computes
    at full f32 in the port."""
    expects(precision in PRECISIONS,
            "precision must be None, 'default', 'high' or 'highest' "
            "(got %r)", precision)
    return DEFAULT_PRECISION if precision is None else precision


def full_f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` in full f32 whatever the process has set.
    The precision is a process-wide setting of PyTorch's: when a caller
    has switched TF32 on, it is set to "highest" for this one product
    (cuBLAS reads it when the product is issued) and restored, under a
    lock, so two threads of the port do not undo each other's restore.
    While it is switched, another thread's products run at full f32
    too. With TF32 off, as this module's import leaves it, nothing is
    switched."""
    if not a.is_cuda or torch.get_float32_matmul_precision() == "highest":
        return torch.matmul(a, b)
    with _PRECISION_LOCK:
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return torch.matmul(a, b)
        finally:
            torch.set_float32_matmul_precision(prev)


def _matmul(a, b, precision, preferred_element_type=None):
    resolve_precision(precision)
    if preferred_element_type is not None:
        dt = torch_dtype(preferred_element_type)
        a, b = a.to(dt), b.to(dt)
    return full_f32_matmul(a, b)


def gemm(a, b, alpha: float = 1.0, beta: float = 0.0,
         c: Optional[torch.Tensor] = None, trans_a: bool = False,
         trans_b: bool = False, precision=DEFAULT_PRECISION,
         preferred_element_type=None) -> torch.Tensor:
    """``alpha * op(a) @ op(b) + beta * c``. ``preferred_element_type``
    is the dtype the product is computed and returned in (e.g. f32 for
    bf16 operands)."""
    a = as_array(a)
    b = as_array(b, device=a.device)
    if trans_a:
        a = a.T
    if trans_b:
        b = b.T
    out = _matmul(a, b, precision, preferred_element_type)
    if alpha != 1.0:
        out = alpha * out
    if beta != 0.0 and c is not None:
        out = out + beta * as_array(c, device=out.device)
    return out


def gemv(a, x, alpha: float = 1.0, beta: float = 0.0,
         y: Optional[torch.Tensor] = None, trans: bool = False,
         precision=DEFAULT_PRECISION) -> torch.Tensor:
    """``alpha * op(a) @ x + beta * y``."""
    a = as_array(a)
    x = as_array(x, device=a.device)
    if trans:
        a = a.T
    out = _matmul(a, x, precision)
    if alpha != 1.0:
        out = alpha * out
    if beta != 0.0 and y is not None:
        out = out + beta * as_array(y, device=out.device)
    return out


def dot(x, y) -> torch.Tensor:
    """Vector dot product."""
    x = as_array(x)
    return _matmul(x, as_array(y, device=x.device), DEFAULT_PRECISION)


def axpy(alpha: float, x, y) -> torch.Tensor:
    """``y + alpha * x``."""
    y = as_array(y)
    return y + alpha * as_array(x, device=y.device)


def transpose(x) -> torch.Tensor:
    """Matrix transpose (a view)."""
    return as_array(x).T
