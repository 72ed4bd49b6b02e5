"""Dense linear algebra: element-wise ops, reductions, norms, BLAS-level
products and decompositions."""

from raft_tpu_torch.linalg.elementwise import (
    add,
    add_scalar,
    binary_op,
    divide,
    divide_scalar,
    eltwise,
    map,
    map_offset,
    multiply,
    multiply_scalar,
    power,
    power_scalar,
    sqrt,
    subtract,
    subtract_scalar,
    ternary_op,
    unary_op,
)
from raft_tpu_torch.linalg.reduce import (
    coalesced_reduction,
    map_reduce,
    mean_squared_error,
    reduce,
    reduce_cols_by_key,
    reduce_rows_by_key,
    strided_reduction,
)
from raft_tpu_torch.linalg.norm import (
    L1Norm,
    L2Norm,
    LinfNorm,
    NormType,
    col_norm,
    norm,
    normalize,
    row_norm,
)
from raft_tpu_torch.linalg.blas import axpy, dot, gemm, gemv, transpose
from raft_tpu_torch.linalg.matrix_vector import matrix_vector_op
from raft_tpu_torch.linalg.decomp import (
    cholesky_rank_one_update,
    eig_dc,
    eig_jacobi,
    lstsq_eig,
    lstsq_svd,
    qr_get_q,
    qr_get_qr,
    rsvd,
    svd_eig,
    svd_qr,
)

__all__ = [
    "add", "add_scalar", "subtract", "subtract_scalar", "multiply",
    "multiply_scalar", "divide", "divide_scalar", "power", "power_scalar",
    "sqrt", "eltwise", "unary_op", "binary_op", "ternary_op", "map",
    "map_offset",
    "reduce", "coalesced_reduction", "strided_reduction", "map_reduce",
    "reduce_rows_by_key", "reduce_cols_by_key", "mean_squared_error",
    "NormType", "L1Norm", "L2Norm", "LinfNorm", "norm", "row_norm",
    "col_norm", "normalize",
    "gemm", "gemv", "dot", "axpy", "transpose",
    "matrix_vector_op",
    "qr_get_q", "qr_get_qr", "eig_dc", "eig_jacobi", "svd_qr", "svd_eig",
    "rsvd", "lstsq_svd", "lstsq_eig", "cholesky_rank_one_update",
]
