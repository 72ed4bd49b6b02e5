"""Nearest-neighbor search: brute force and IVF-Flat."""
