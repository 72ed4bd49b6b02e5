"""Shared neighbors helpers, ref python/pylibraft/pylibraft/neighbors/
common.pyx (``_check_input_array``, ``_get_metric``).

The port's own copy of ``pylibraft/neighbors/common.py`` over
``raft_tpu_torch``'s ``DistanceType``.
"""

from __future__ import annotations

import numpy as np

from raft_tpu_torch.distance.distance_types import DistanceType

# ANN metric-name map, ref neighbors/common.pyx _get_metric: the ANN indexes
# accept only the three metrics below.
_METRIC_MAP = {
    "sqeuclidean": DistanceType.L2Expanded,
    "euclidean": DistanceType.L2SqrtExpanded,
    "inner_product": DistanceType.InnerProduct,
}

_METRIC_NAMES = {v: k for k, v in _METRIC_MAP.items()}


def _get_metric(metric) -> DistanceType:
    if isinstance(metric, DistanceType):
        return metric
    try:
        return _METRIC_MAP[metric]
    except KeyError:
        raise ValueError(
            f"metric {metric!r} is not supported; use one of "
            f"{sorted(_METRIC_MAP)}"
        ) from None


def _get_metric_string(metric: DistanceType) -> str:
    return _METRIC_NAMES.get(DistanceType(metric), str(metric))


def _check_input_array(cai, exp_dt, exp_rows=None, exp_cols=None):
    """Ref neighbors/common.pyx ``_check_input_array``: dtype whitelist +
    contiguity + optional shape pinning."""
    if np.dtype(cai.dtype) not in [np.dtype(dt) for dt in exp_dt]:
        raise TypeError("dtype %s not supported" % cai.dtype)
    if not cai.c_contiguous:
        raise ValueError("Row major input is expected")
    if exp_cols is not None and cai.shape[1] != exp_cols:
        raise ValueError(
            "Incorrect number of columns, expected {} got {}".format(
                exp_cols, cai.shape[1]
            )
        )
    if exp_rows is not None and cai.shape[0] != exp_rows:
        raise ValueError(
            "Incorrect number of rows, expected {} , got {}".format(
                exp_rows, cai.shape[0]
            )
        )
