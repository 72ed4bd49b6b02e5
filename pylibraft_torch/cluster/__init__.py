"""pylibraft_torch.cluster: k-means (ref python/pylibraft/pylibraft/cluster)."""

from pylibraft_torch.cluster import kmeans

__all__ = ["kmeans"]
