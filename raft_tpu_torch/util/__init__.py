"""Small host-side helpers: power-of-two arithmetic, parameter sweeps and
layout predicates."""

from raft_tpu_torch.util.pow2 import (Pow2, ceildiv, is_pow2, round_down_safe,
                                      round_up_safe)
from raft_tpu_torch.util.itertools import product_of_lists
from raft_tpu_torch.util.input_validation import is_col_major, is_row_major

__all__ = [
    "Pow2",
    "ceildiv",
    "round_up_safe",
    "round_down_safe",
    "is_pow2",
    "product_of_lists",
    "is_row_major",
    "is_col_major",
]
