"""pylibraft_torch.random: RMAT graph generator.

Ref: python/pylibraft/pylibraft/random/__init__.py (exports ``rmat``) over
rmat_rectangular_generator.pyx:80.
"""

from pylibraft_torch.random.rmat_rectangular_generator import rmat

__all__ = ["rmat"]
