"""Clustering quality metrics.

Port of ``raft_tpu/stats/cluster_metrics.py``. The pair-counting and
information metrics reduce the contingency table
(:func:`~raft_tpu_torch.stats.classification.contingency_matrix`), held in
float32 as in the reference. ``silhouette_score`` takes ``chunk`` rows of
the distance matrix at a time and sums each cluster's distances with one
product against the labels' one-hot; ``trustworthiness_score`` ranks every
row of the original distances, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.matrix.select_k import stable_top_k
from raft_tpu_torch.stats.classification import contingency_matrix


def _contingency(a, b, n_classes: Optional[int] = None) -> torch.Tensor:
    """Square float32 contingency table over labels 0..n_classes - 1."""
    a = as_array(a).long()
    b = as_array(b, device=a.device).to(a.device).long()
    if n_classes is None:
        n_classes = int(torch.maximum(torch.amax(a), torch.amax(b))) + 1
    return contingency_matrix(a, b, min_label=0,
                              max_label=n_classes - 1).to(torch.float32)


def rand_index(first, second) -> torch.Tensor:
    """Rand index: the share of sample pairs on which the two clusterings
    agree (same cluster in both, or different in both), from the
    contingency table."""
    n = as_array(first).shape[0]
    cm = _contingency(first, second)
    total_pairs = n * (n - 1) / 2.0
    sum_sq = torch.sum(cm ** 2)
    sum_rows_sq = torch.sum(torch.sum(cm, dim=1) ** 2)
    sum_cols_sq = torch.sum(torch.sum(cm, dim=0) ** 2)
    a_pairs = (sum_sq - n) / 2.0
    b_pairs = total_pairs + (sum_sq - sum_rows_sq - sum_cols_sq + n) / 2.0
    return (a_pairs + b_pairs) / total_pairs


def adjusted_rand_index(first, second) -> torch.Tensor:
    """Adjusted-for-chance Rand index; 1 when the expected and the best
    index coincide (identical trivial clusterings)."""
    n = as_array(first).shape[0]
    cm = _contingency(first, second)

    def comb2(x):
        return torch.sum(x * (x - 1) / 2.0)

    sum_comb = comb2(cm)
    sum_comb_rows = comb2(torch.sum(cm, dim=1))
    sum_comb_cols = comb2(torch.sum(cm, dim=0))
    expected = sum_comb_rows * sum_comb_cols / (n * (n - 1) / 2.0)
    denom = (sum_comb_rows + sum_comb_cols) / 2.0 - expected
    safe = torch.where(denom == 0, 1.0, denom)
    return torch.where(denom == 0, 1.0, (sum_comb - expected) / safe)


def mutual_info_score(first, second) -> torch.Tensor:
    """Mutual information (nats): sum p_ij log(p_ij / (p_i p_j))."""
    n = as_array(first).shape[0]
    p_ij = _contingency(first, second) / n
    p_i = torch.sum(p_ij, dim=1, keepdim=True)
    p_j = torch.sum(p_ij, dim=0, keepdim=True)
    ratio = p_ij / (p_i * p_j)
    term = torch.where(
        p_ij > 0, p_ij * torch.log(torch.where(ratio > 0, ratio, 1.0)), 0.0)
    return torch.sum(term)


def entropy(labels, n_classes: Optional[int] = None) -> torch.Tensor:
    """Shannon entropy (nats) of a labeling."""
    y = as_array(labels).long()
    n = y.shape[0]
    if n_classes is None:
        n_classes = int(torch.amax(y)) + 1
    p = torch.bincount(y, minlength=n_classes)[:n_classes].to(
        torch.float32) / n
    return -torch.sum(torch.where(
        p > 0, p * torch.log(torch.where(p > 0, p, 1.0)), 0.0))


def homogeneity_score(truth, predicted) -> torch.Tensor:
    """MI / H(truth) (1 when the truth's entropy is 0)."""
    mi = mutual_info_score(truth, predicted)
    h = entropy(truth)
    return torch.where(h == 0, 1.0, mi / torch.where(h == 0, 1.0, h))


def completeness_score(truth, predicted) -> torch.Tensor:
    """MI / H(predicted) (1 when the prediction's entropy is 0)."""
    mi = mutual_info_score(truth, predicted)
    h = entropy(predicted)
    return torch.where(h == 0, 1.0, mi / torch.where(h == 0, 1.0, h))


def v_measure(truth, predicted, beta: float = 1.0) -> torch.Tensor:
    """Weighted harmonic mean of homogeneity and completeness."""
    h = homogeneity_score(truth, predicted)
    c = completeness_score(truth, predicted)
    denom = beta * h + c
    return torch.where(denom == 0, 0.0,
                       (1 + beta) * h * c / torch.where(denom == 0, 1.0,
                                                        denom))


def kl_divergence(modeled_pdf, candidate_pdf) -> torch.Tensor:
    """KL divergence sum p log(p / q) over the entries with p > 0 (a q of
    0 there contributes 0)."""
    p = as_array(modeled_pdf)
    q = as_array(candidate_pdf, device=p.device).to(p.device)
    ratio = torch.where((p > 0) & (q > 0),
                        p / torch.where(q > 0, q, 1.0), 1.0)
    return torch.sum(torch.where(p > 0, p * torch.log(ratio), 0.0))


@traced
def silhouette_score(X, labels, n_clusters: Optional[int] = None,
                     metric: str = "sqeuclidean", chunk: int = 1024
                     ) -> torch.Tensor:
    """Mean silhouette coefficient over all samples. ``chunk`` rows of the
    distance matrix are made at a time, each multiplied by the labels'
    (n, k) one-hot for every cluster's distance sum. A sample alone in its
    cluster scores 0; empty cluster ids are left out of b(i). Raises
    below 2 populated clusters."""
    from raft_tpu_torch.distance import pairwise_distance

    x = as_array(X)
    y = as_array(labels, device=x.device).to(x.device).long()
    n = x.shape[0]
    if n_clusters is None:
        n_clusters = int(torch.amax(y)) + 1
    expects(torch.unique(y).numel() >= 2,
            "silhouette_score requires at least 2 populated clusters")
    onehot = torch.nn.functional.one_hot(y, n_clusters).to(x.dtype)
    counts = torch.sum(onehot, dim=0)
    sums = torch.cat([pairwise_distance(x[s:s + chunk], x, metric=metric)
                      @ onehot for s in range(0, n, chunk)])

    own = onehot.bool()
    own_count = counts[y]
    a_sum = torch.sum(torch.where(own, sums, 0.0), dim=1)
    a = torch.where(own_count > 1,
                    a_sum / torch.clamp_min(own_count - 1, 1), 0.0)
    excluded = own | (counts[None, :] == 0)
    mean_other = torch.where(excluded, float("inf"),
                             sums / torch.clamp_min(counts[None, :], 1))
    b = torch.amin(mean_other, dim=1)
    sil = torch.where(own_count > 1,
                      (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-30),
                      0.0)
    return torch.mean(sil)


@traced
def trustworthiness_score(X, X_embedded, n_neighbors: int,
                          metric: str = "sqeuclidean", batch_size: int = 512
                          ) -> torch.Tensor:
    """How much local structure of ``X`` survives in ``X_embedded``: each
    sample's ``n_neighbors`` + 1 nearest in the embedding (itself
    included; ties to the lowest index) are looked up in its stable
    ordering of the original distances, each costs max(0, rank - k), and
    the score is 1 - 2 sum / (n k (2n - 3k - 1)). ``batch_size`` is
    accepted for parity; the reference does not read it either."""
    from raft_tpu_torch.distance import pairwise_distance

    x = as_array(X)
    e = as_array(X_embedded, device=x.device).to(x.device)
    n, k = x.shape[0], n_neighbors
    d_emb = pairwise_distance(e, e, metric=metric)
    _, emb_ind = stable_top_k(-d_emb, k + 1, select_min=False)
    del d_emb
    order = torch.argsort(pairwise_distance(x, x, metric=metric), dim=1,
                          stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(n, device=x.device)[None, :]
                   .expand(n, n))
    penalty = torch.clamp_min(torch.gather(ranks, 1, emb_ind) - k, 0)
    t = torch.sum(penalty).to(torch.float32)
    return 1.0 - (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))) * t
