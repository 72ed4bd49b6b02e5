"""pylibraft_torch.neighbors: brute-force + ANN indexes.

Ref: python/pylibraft/pylibraft/neighbors/__init__.py (exports brute_force,
ivf_flat, ivf_pq, refine).
"""

from pylibraft_torch.neighbors import brute_force, ivf_flat, ivf_pq
from pylibraft_torch.neighbors.refine import refine

__all__ = ["brute_force", "ivf_flat", "ivf_pq", "refine"]
