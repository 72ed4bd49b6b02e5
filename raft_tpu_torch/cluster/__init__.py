"""Clustering: balanced k-means."""
