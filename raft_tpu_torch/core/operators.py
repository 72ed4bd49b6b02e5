"""Composable functors used as map / reduce / epilogue operators.

Port of ``raft_tpu/core/operators.py`` (``core/operators.hpp`` of RAFT):
plain callables on tensors, passed into the ``linalg`` map and reduce
primitives. Unary ops take and ignore extra arguments, as there.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.kvp import KeyValuePair


# -- unary ------------------------------------------------------------------
def identity_op(x, *_):
    return x


def void_op(*_):
    return None


def sq_op(x, *_):
    return x * x


def abs_op(x, *_):
    return torch.abs(x)


def sqrt_op(x, *_):
    return torch.sqrt(x)


def nz_op(x, *_):
    return (x != 0).to(x.dtype)


def cast_op(dtype):
    def op(x, *_):
        return x.to(dtype)

    return op


# -- binary -----------------------------------------------------------------
def add_op(a, b):
    return a + b


def sub_op(a, b):
    return a - b


def mul_op(a, b):
    return a * b


def div_op(a, b):
    return a / b


def div_checkzero_op(a, b):
    """``a / b``, and 0 where ``b`` is 0."""
    q = a / b
    return torch.where(b == 0, torch.zeros_like(q), q)


def pow_op(a, b):
    return torch.pow(a, b)


def min_op(a, b):
    return torch.minimum(a, b)


def max_op(a, b):
    return torch.maximum(a, b)


def sqdiff_op(a, b):
    d = a - b
    return d * d


def absdiff_op(a, b):
    return torch.abs(a - b)


def equal_op(a, b):
    return a == b


def notequal_op(a, b):
    return a != b


# -- key-value reducers: on equal values the lower key wins ------------------
def argmin_op(a: KeyValuePair, b: KeyValuePair) -> KeyValuePair:
    take_b = (b.value < a.value) | ((b.value == a.value) & (b.key < a.key))
    return KeyValuePair(key=torch.where(take_b, b.key, a.key),
                        value=torch.where(take_b, b.value, a.value))


def argmax_op(a: KeyValuePair, b: KeyValuePair) -> KeyValuePair:
    take_b = (b.value > a.value) | ((b.value == a.value) & (b.key < a.key))
    return KeyValuePair(key=torch.where(take_b, b.key, a.key),
                        value=torch.where(take_b, b.value, a.value))


def key_op(kvp: KeyValuePair, *_):
    return kvp.key


def value_op(kvp: KeyValuePair, *_):
    return kvp.value


# -- compose ----------------------------------------------------------------
def compose_op(*ops):
    """Apply ops right to left: ``compose_op(f, g)(x) == f(g(x))``."""

    def op(x, *args):
        for f in reversed(ops):
            x = f(x, *args)
        return x

    return op


def plug_const_op(const, binary):
    """Bind the second argument of a binary op."""

    def op(x, *_):
        return binary(x, const)

    return op


def add_const_op(const):
    return plug_const_op(const, add_op)


def sub_const_op(const):
    return plug_const_op(const, sub_op)


def mul_const_op(const):
    return plug_const_op(const, mul_op)


def div_const_op(const):
    return plug_const_op(const, div_op)


def pow_const_op(const):
    return plug_const_op(const, pow_op)
