"""Power-of-two alignment / rounding helpers.

Port of ``raft_tpu/util/pow2.py``: ``raft::ceildiv``, ``round_up_safe``,
``round_down_safe``, ``is_pow2``, the ``Pow2`` alignment helper and the
``next_pow2`` list-capacity growth policy.
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


def round_down_safe(v: int, multiple: int) -> int:
    """Round down to a multiple."""
    return (v // multiple) * multiple


class Pow2:
    """Mask-based alignment for a power-of-two ``value``:
    ``Pow2(128).round_up(130) == 256``."""

    def __init__(self, value: int):
        if not is_pow2(value):
            raise ValueError(f"Pow2 requires a power of two, got {value}")
        self.value = value
        self.mask = value - 1

    def round_up(self, x: int) -> int:
        return (x + self.mask) & ~self.mask

    def round_down(self, x: int) -> int:
        return x & ~self.mask

    def div(self, x: int) -> int:
        return x >> self.value.bit_length() - 1

    def mod(self, x: int) -> int:
        return x & self.mask

    def is_aligned(self, x: int) -> bool:
        return (x & self.mask) == 0
