"""Distance metric vocabulary.

Port of ``raft_tpu/distance/distance_types.py``: the ``DistanceType`` enum
(same numeric values as the reference), the pylibraft metric-name map with
its aliases, ``SUPPORTED_DISTANCES``, the selection-polarity helpers and
the gram kernels' ``KernelType``.
"""

from __future__ import annotations

import enum


class DistanceType(enum.IntEnum):
    """Same names and numeric values as raft_tpu's ``DistanceType``."""

    L2Expanded = 0
    L2SqrtExpanded = 1
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7
    Canberra = 8
    LpUnexpanded = 9
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19
    Precomputed = 100


def is_min_close(metric: DistanceType) -> bool:
    """Whether smaller values mean closer neighbors (similarity metrics
    select max). Pairwise-form values use :func:`value_form_select_min`."""
    return metric not in (
        DistanceType.InnerProduct,
        DistanceType.CosineExpanded,
        DistanceType.CorrelationExpanded,
    )


def value_form_select_min(metric: DistanceType) -> bool:
    """Selection polarity for pairwise-form values: every metric emits
    distances except InnerProduct, which scores raw similarity."""
    return metric != DistanceType.InnerProduct


DISTANCE_TYPES = {
    "l2": DistanceType.L2SqrtUnexpanded,
    "sqeuclidean": DistanceType.L2Unexpanded,
    "euclidean": DistanceType.L2SqrtUnexpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "inner_product": DistanceType.InnerProduct,
    "chebyshev": DistanceType.Linf,
    "linf": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "cosine": DistanceType.CosineExpanded,
    "lp": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "haversine": DistanceType.Haversine,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "minkowski": DistanceType.LpUnexpanded,
    "russellrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
    "sqeuclidean_expanded": DistanceType.L2Expanded,
    "euclidean_expanded": DistanceType.L2SqrtExpanded,
}

# The metric names pylibraft's pairwise_distance documents as supported.
SUPPORTED_DISTANCES = [
    "euclidean", "l1", "cityblock", "l2", "inner_product", "chebyshev",
    "minkowski", "canberra", "kl_divergence", "correlation", "russellrao",
    "hellinger", "lp", "hamming", "jensenshannon", "cosine", "sqeuclidean",
]


def resolve_metric(metric) -> DistanceType:
    """Accept either a DistanceType or a pylibraft-style metric name."""
    if isinstance(metric, DistanceType):
        return metric
    if isinstance(metric, str):
        try:
            return DISTANCE_TYPES[metric.lower()]
        except KeyError:
            raise ValueError(
                f"metric '{metric}' is not supported; one of "
                f"{sorted(DISTANCE_TYPES)}"
            ) from None
    return DistanceType(metric)


class KernelType(enum.IntEnum):
    """Gram-matrix kernel functions (``kernels::KernelType``), with the
    reference's values."""

    LINEAR = 0
    POLYNOMIAL = 1
    RBF = 2
    TANH = 3
