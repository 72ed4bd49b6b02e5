"""Fused L2 nearest-neighbor: pairwise L2 + row-wise arg-min in one pass.

Port of ``raft_tpu/distance/fused_l2_nn.py``: ``fused_l2_nn_min_reduce``,
the k-means inner loop, and ``fused_l2_nn_argmin``, its arg-min alone. It is
the fused kNN of ``ops/fused_knn.py`` with k=1 on every device: kernel B1
on ``cuda`` (as the reference routes to its Pallas kernel on ``tpu``), its
plain version on the CPU. The kernel's output is (m, 1), so no query
chunking is needed.

``bf16`` picks the precision tier: None keeps f32, "split" rounds the y
(centroid) operand to bf16 and recovers x with a hi/lo double product,
"full" rounds both; accumulation and norms stay f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects, expects_finite
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.core.resources import as_float
from raft_tpu_torch.linalg.blas import DEFAULT_PRECISION, resolve_precision


@traced
def fused_l2_nn_min_reduce(
    x,
    y,
    sqrt: bool = False,
    tile_n: int = 2048,
    precision=DEFAULT_PRECISION,
    bf16: Optional[str] = None,
    handle=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``x``, the L2-nearest row of ``y``: returns
    ``(min_dist (m,), argmin (m,) int32)``, squared unless ``sqrt``. Ties
    go to the lowest index. ``tile_n`` is the reference's column-tile
    width; it is accepted for signature parity and ignored, since the
    fused kNN tiles ``y`` itself and the result does not depend on it.
    ``precision`` takes the reference's names and is checked; the f32
    tier computes at full f32 for each (``bf16`` picks the tier)."""
    resolve_precision(precision)
    expects(bf16 in (None, "split", "full"),
            f"bf16 must be None, 'split' or 'full' (got {bf16!r})")
    x = as_float(x, handle)
    y = as_float(y, handle, x.device)
    expects(x.ndim == 2 and y.ndim == 2, "x and y must be matrices")
    expects(x.shape[1] == y.shape[1], "x and y must have the same n_cols")
    expects(y.shape[0] >= 1, "y must have at least one row")
    expects_finite("fused_l2_nn_min_reduce", x, y)
    return _min_reduce(x, y, sqrt, bf16)


def _min_reduce(x, y, sqrt: bool = False, bf16: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arg-min of :func:`fused_l2_nn_min_reduce` on float tensors,
    without the entry point's checks (the k-means loop calls it on
    operands derived from checked inputs)."""
    # Imported here: ops.fused_knn imports distance.pairwise, and with the
    # distance package's exports a module-level import closes a cycle.
    from raft_tpu_torch.ops.fused_knn import fused_knn

    d1, i1 = fused_knn(x, y, 1, metric="l2", sqrt=sqrt,
                       bf16=bf16 is not None, qsplit=bf16 == "split")
    return d1[:, 0], i1[:, 0]


def fused_l2_nn_argmin(x, y, sqrt: bool = False, handle=None
                       ) -> torch.Tensor:
    """The arg-min of :func:`fused_l2_nn_min_reduce` alone: for each row of
    ``x``, the int32 index of its L2-nearest row of ``y`` (ties to the
    lowest index)."""
    _, idx = fused_l2_nn_min_reduce(x, y, sqrt=sqrt, handle=handle)
    return idx
