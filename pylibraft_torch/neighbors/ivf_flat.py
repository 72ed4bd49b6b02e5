"""IVF-Flat ANN index, pylibraft surface.

Ref: python/pylibraft/pylibraft/neighbors/ivf_flat/ivf_flat.pyx:
``IndexParams``, ``Index``, ``build``, ``extend``, ``SearchParams``,
``search``, ``save``, ``load``. Backed by
``raft_tpu_torch.neighbors.ivf_flat``: on the card, the build's k-means
assignments are k=1 launches of the fused kNN kernel and a search whose
probe load fills the cells (n_queries x n_probes / n_lists >= 8) runs the
packed-cells kernel.
"""

from __future__ import annotations

import numpy as np

from raft_tpu_torch.core.mdarray import validate_idx_dtype
from raft_tpu_torch.neighbors import ivf_flat as _impl

from pylibraft_torch.common import auto_convert_output, auto_sync_handle, cai_wrapper
from pylibraft_torch.common.outputs import copy_into
from pylibraft_torch.neighbors.common import (
    _check_input_array,
    _get_metric,
    _get_metric_string,
)

_DATA_DTYPES = [np.dtype("float32"), np.dtype("byte"), np.dtype("ubyte")]


class IndexParams:
    """Ref ivf_flat.pyx IndexParams; metric accepts the ANN metric strings
    {"sqeuclidean", "euclidean", "inner_product"}. ``idx_dtype`` selects
    the neighbor-id dtype: "int32" (the default) or "int64", the
    reference's int64_t."""

    def __init__(self, *, n_lists=1024, metric="sqeuclidean",
                 kmeans_n_iters=20, kmeans_trainset_fraction=0.5,
                 add_data_on_build=True, adaptive_centers=False,
                 idx_dtype="int32"):
        self.params = _impl.IndexParams(
            n_lists=n_lists,
            metric=_get_metric(metric),
            kmeans_n_iters=kmeans_n_iters,
            kmeans_trainset_fraction=kmeans_trainset_fraction,
            add_data_on_build=add_data_on_build,
            adaptive_centers=adaptive_centers,
            idx_dtype=validate_idx_dtype(idx_dtype),
        )

    @property
    def n_lists(self):
        return self.params.n_lists

    @property
    def metric(self):
        return _get_metric_string(self.params.metric)

    @property
    def kmeans_n_iters(self):
        return self.params.kmeans_n_iters

    @property
    def kmeans_trainset_fraction(self):
        return self.params.kmeans_trainset_fraction

    @property
    def add_data_on_build(self):
        return self.params.add_data_on_build

    @property
    def adaptive_centers(self):
        return self.params.adaptive_centers


class SearchParams:
    """Ref ivf_flat.pyx SearchParams(n_probes=20)."""

    def __init__(self, *, n_probes=20):
        self.params = _impl.SearchParams(n_probes=n_probes)

    @property
    def n_probes(self):
        return self.params.n_probes

    def __repr__(self):
        return f"SearchParams(n_probes={self.n_probes})"


class Index:
    """Handle over the device-resident index (ref ivf_flat.pyx Index):
    ``Index(index)`` wraps a ``raft_tpu_torch`` IVF-Flat index as it is."""

    def __init__(self, index=None):
        self._index = index
        self.trained = index is not None

    @property
    def size(self):
        return 0 if self._index is None else self._index.size

    @property
    def dim(self):
        return 0 if self._index is None else self._index.dim

    @property
    def n_lists(self):
        return 0 if self._index is None else self._index.n_lists

    @property
    def metric(self):
        return None if self._index is None else _get_metric_string(self._index.metric)

    @property
    def adaptive_centers(self):
        return False if self._index is None else self._index.adaptive_centers

    def __repr__(self):
        attrs = ", ".join(
            f"{k}={getattr(self, k)}"
            for k in ["size", "dim", "n_lists", "metric"])
        return f"Index(type=IVF-Flat, {attrs})"


@auto_sync_handle
@auto_convert_output
def build(index_params: IndexParams, dataset, handle=None) -> Index:
    """Ref ivf_flat.pyx ``build``: trains balanced k-means centers and
    fills the inverted lists."""
    ds = cai_wrapper(dataset, handle)
    _check_input_array(ds, _DATA_DTYPES)
    return Index(_impl.build(index_params.params, ds.array, handle=handle))


@auto_sync_handle
@auto_convert_output
def extend(index: Index, new_vectors, new_indices, handle=None) -> Index:
    """Ref ivf_flat.pyx ``extend``."""
    v = cai_wrapper(new_vectors, handle)
    i = cai_wrapper(new_indices, handle)
    _check_input_array(v, _DATA_DTYPES, exp_cols=index.dim)
    index._index = _impl.extend(index._index, v.array, i.array,
                                handle=handle)
    return index


@auto_sync_handle
@auto_convert_output
def search(search_params: SearchParams, index: Index, queries, k: int,
           neighbors=None, distances=None, memory_resource=None, handle=None):
    """Ref ivf_flat.pyx ``search``: returns ``(distances, neighbors)``.
    ``memory_resource`` is accepted for parity with the reference binding
    (an RMM memory resource); PyTorch's caching allocator serves every
    allocation here."""
    if not index.trained:
        raise ValueError("Index needs to be built before calling search.")
    q = cai_wrapper(queries, handle)
    _check_input_array(q, [np.dtype("float32")], exp_cols=index.dim)
    d, n = _impl.search(search_params.params, index._index, q.array, k,
                        handle=handle)
    if distances is not None:
        copy_into(distances, d)
    if neighbors is not None:
        copy_into(neighbors, n)
    return d, n


def save(filename: str, index: Index, handle=None) -> None:
    """Ref ivf_flat.pyx ``save``: the versioned npz layout, which
    ``pylibraft.neighbors.ivf_flat`` reads too."""
    _impl.save(filename, index._index)


def load(filename: str, handle=None) -> Index:
    """Ref ivf_flat.pyx ``load``, onto the handle's device (``cuda`` when
    no handle is given)."""
    return Index(_impl.load(filename, device=None if handle is None
                            else handle.device))
