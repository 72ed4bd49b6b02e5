"""Parameter-sweep helpers (port of ``raft_tpu/util/itertools.py``)."""

from __future__ import annotations

import itertools
from typing import Any, Iterable, List, Tuple


def product_of_lists(*lists: Iterable[Any]) -> List[Tuple[Any, ...]]:
    """Cartesian product of parameter lists, for test and bench sweeps."""
    return list(itertools.product(*lists))
