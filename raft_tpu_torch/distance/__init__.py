"""Distance metrics: the expanded pairwise family and the fused L2 arg-min."""
