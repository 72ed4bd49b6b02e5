"""Matrix operations and batched top-k selection."""

from raft_tpu_torch.matrix.ops import (
    argmax,
    argmin,
    col_wise_sort,
    copy,
    gather,
    gather_if,
    init,
    l2_norm,
    linewise_op,
    reverse,
    scatter,
    shift_fill,
    sign_flip,
    slice as slice_,
    triangular_upper,
)
from raft_tpu_torch.matrix.select_k import SelectMethod, select_k

__all__ = [
    "argmax", "argmin", "gather", "gather_if", "scatter", "slice_", "copy",
    "init", "reverse", "sign_flip", "linewise_op", "col_wise_sort",
    "triangular_upper", "shift_fill", "l2_norm", "select_k", "SelectMethod",
]
