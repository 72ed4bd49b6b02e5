"""Statistics: descriptive statistics and regression, classification and
clustering quality metrics, the port of ``raft_tpu/stats``."""

from raft_tpu_torch.stats.descriptive import (
    mean,
    mean_center,
    mean_add,
    meanvar,
    stddev,
    vars_,
    sum_ as sum,
    cov,
    minmax,
    weighted_mean,
    row_weighted_mean,
    col_weighted_mean,
    histogram,
    dispersion,
)
from raft_tpu_torch.stats.regression import (
    r2_score,
    regression_metrics,
    information_criterion,
    InformationCriterionType,
)
from raft_tpu_torch.stats.classification import accuracy, contingency_matrix
from raft_tpu_torch.stats.cluster_metrics import (
    adjusted_rand_index,
    rand_index,
    mutual_info_score,
    entropy,
    homogeneity_score,
    completeness_score,
    v_measure,
    kl_divergence,
    silhouette_score,
    trustworthiness_score,
)

__all__ = [
    "mean", "mean_center", "mean_add", "meanvar", "stddev", "vars_", "sum",
    "cov", "minmax", "weighted_mean", "row_weighted_mean",
    "col_weighted_mean", "histogram", "dispersion",
    "r2_score", "regression_metrics", "information_criterion",
    "InformationCriterionType",
    "accuracy", "contingency_matrix",
    "adjusted_rand_index", "rand_index", "mutual_info_score", "entropy",
    "homogeneity_score", "completeness_score", "v_measure", "kl_divergence",
    "silhouette_score", "trustworthiness_score",
]
