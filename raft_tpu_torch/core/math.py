"""Elementwise math under the reference's names.

Port of ``raft_tpu/core/math.py`` (``core/math.hpp`` of RAFT): ``abs``,
``acos``, ``asin``, ``atanh``, ``cos``, ``exp``, ``log``, ``pow``, ``sin``,
``sqrt``, ``tanh``, the variadic ``max`` / ``min`` and the sign ``sgn``, on
tensors.
"""

from __future__ import annotations

import torch

abs = torch.abs  # noqa: A001 - mirrors raft::abs
acos = torch.arccos
asin = torch.arcsin
atanh = torch.arctanh
cos = torch.cos
exp = torch.exp
log = torch.log
pow = torch.pow  # noqa: A001 - mirrors raft::pow
sin = torch.sin
sqrt = torch.sqrt
tanh = torch.tanh


def max(*args):  # noqa: A001 - mirrors raft::max
    """Variadic elementwise maximum."""
    out = torch.as_tensor(args[0])
    for a in args[1:]:
        out = torch.maximum(out, torch.as_tensor(a))
    return out


def min(*args):  # noqa: A001 - mirrors raft::min
    """Variadic elementwise minimum."""
    out = torch.as_tensor(args[0])
    for a in args[1:]:
        out = torch.minimum(out, torch.as_tensor(a))
    return out


def sgn(x):
    """-1, 0 or +1 in the input's dtype."""
    return torch.sign(x)
