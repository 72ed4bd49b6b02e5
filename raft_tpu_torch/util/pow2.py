"""Power-of-two alignment / rounding helpers.

Port of ``raft_tpu/util/pow2.py`` (``raft::ceildiv``, ``round_up_safe``,
``is_pow2`` and the ``next_pow2`` list-capacity growth policy).
"""

from __future__ import annotations


def ceildiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up_safe(v: int, multiple: int) -> int:
    """Round up to a multiple."""
    return ceildiv(v, multiple) * multiple


def next_pow2(v: int) -> int:
    """Smallest power of two >= v (v <= 0 gives 1): the amortized
    list-capacity growth policy of the IVF packers."""
    return 1 << max(int(v) - 1, 0).bit_length()


def is_pow2(v: int) -> bool:
    """True for a positive power of two."""
    return v > 0 and (v & (v - 1)) == 0
