"""IVF-PQ ANN index, pylibraft surface.

Ref: python/pylibraft/pylibraft/neighbors/ivf_pq/ivf_pq.pyx: IndexParams
(:91), Index (:227), build (:309), extend (:406), SearchParams (:511),
search (:568), save (:719), load (:765). Backed by
``raft_tpu_torch.neighbors.ivf_pq``: on the card, the build's k-means
assignments are k=1 launches of the fused kNN kernel and a full batch of
the compressed search runs the PQ scan kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.mdarray import validate_idx_dtype
from raft_tpu_torch.neighbors import ivf_pq as _impl
from raft_tpu_torch.neighbors.ivf_pq import _torch_dtype

from pylibraft_torch.common import auto_convert_output, auto_sync_handle, cai_wrapper
from pylibraft_torch.common.outputs import copy_into
from pylibraft_torch.neighbors.common import (
    _check_input_array,
    _get_metric,
    _get_metric_string,
)

_CODEBOOK_KINDS = {
    "subspace": _impl.CodebookGen.PER_SUBSPACE,
    "cluster": _impl.CodebookGen.PER_CLUSTER,
}
_DATA_DTYPES = [np.dtype("float32"), np.dtype("byte"), np.dtype("ubyte")]


def _search_dtype(dtype) -> torch.dtype:
    """A LUT / score dtype as the port's torch dtype. The reference's fp8
    LUT maps to the affine uint8-quantized LUT (ivf_pq_search.cuh:70
    fp_8bit analog), as in ``pylibraft/neighbors/ivf_pq.py``; the other
    names, numpy and torch dtypes map as themselves."""
    return torch.uint8 if str(dtype) == "fp8" else _torch_dtype(dtype)


class IndexParams:
    """Ref ivf_pq.pyx:91-226; same names/defaults."""

    def __init__(self, *, n_lists=1024, metric="sqeuclidean",
                 kmeans_n_iters=20, kmeans_trainset_fraction=0.5,
                 pq_bits=8, pq_dim=0, codebook_kind="subspace",
                 force_random_rotation=False, add_data_on_build=True,
                 conservative_memory_allocation=False, idx_dtype="int32",
                 retain_dataset=True):
        if codebook_kind not in _CODEBOOK_KINDS:
            raise ValueError(f"codebook_kind must be in {sorted(_CODEBOOK_KINDS)}")
        self.params = _impl.IndexParams(
            n_lists=n_lists,
            metric=_get_metric(metric),
            kmeans_n_iters=kmeans_n_iters,
            kmeans_trainset_fraction=kmeans_trainset_fraction,
            pq_bits=pq_bits,
            pq_dim=pq_dim,
            codebook_kind=_CODEBOOK_KINDS[codebook_kind],
            force_random_rotation=force_random_rotation,
            add_data_on_build=add_data_on_build,
            idx_dtype=validate_idx_dtype(idx_dtype),
            conservative_memory_allocation=conservative_memory_allocation,
            retain_dataset=retain_dataset,
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
    def pq_bits(self):
        return self.params.pq_bits

    @property
    def pq_dim(self):
        return self.params.pq_dim

    @property
    def codebook_kind(self):
        kind = self.params.codebook_kind
        return "subspace" if kind == _impl.CodebookGen.PER_SUBSPACE else "cluster"

    @property
    def force_random_rotation(self):
        return self.params.force_random_rotation

    @property
    def add_data_on_build(self):
        return self.params.add_data_on_build

    @property
    def conservative_memory_allocation(self):
        return self.params.conservative_memory_allocation


class SearchParams:
    """Ref ivf_pq.pyx:511-565 (n_probes, lut_dtype,
    internal_distance_dtype), and ``min_recall``, the recall class a
    search must reach (an exact refine of the retained rows when the
    compressed search would fall short)."""

    def __init__(self, *, n_probes=20, lut_dtype=np.float32,
                 internal_distance_dtype=np.float32, min_recall=None):
        self.params = _impl.SearchParams(
            n_probes=n_probes, lut_dtype=_search_dtype(lut_dtype),
            internal_distance_dtype=_search_dtype(internal_distance_dtype),
            min_recall=min_recall)

    @property
    def n_probes(self):
        return self.params.n_probes

    @property
    def min_recall(self):
        return self.params.min_recall

    @property
    def lut_dtype(self):
        return self.params.lut_dtype

    @property
    def internal_distance_dtype(self):
        return self.params.internal_distance_dtype

    def __repr__(self):
        return f"SearchParams(n_probes={self.n_probes})"


class Index:
    """Ref ivf_pq.pyx:227-305: ``Index(index)`` wraps a ``raft_tpu_torch``
    IVF-PQ index as it is."""

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
    def pq_dim(self):
        return 0 if self._index is None else self._index.pq_dim

    @property
    def pq_len(self):
        return 0 if self._index is None else self._index.pq_len

    @property
    def pq_bits(self):
        return 0 if self._index is None else self._index.pq_bits

    @property
    def rot_dim(self):
        return 0 if self._index is None else self._index.rot_dim

    @property
    def n_lists(self):
        return 0 if self._index is None else self._index.n_lists

    @property
    def metric(self):
        return None if self._index is None else _get_metric_string(self._index.metric)

    @property
    def codebook_kind(self):
        if self._index is None:
            return None
        kind = self._index.codebook_kind
        return "subspace" if kind == _impl.CodebookGen.PER_SUBSPACE else "cluster"

    def __repr__(self):
        attrs = ", ".join(
            f"{k}={getattr(self, k)}"
            for k in ["size", "dim", "pq_dim", "pq_bits", "n_lists", "metric"])
        return f"Index(type=IVF-PQ, {attrs})"


@auto_sync_handle
@auto_convert_output
def build(index_params: IndexParams, dataset, handle=None) -> Index:
    """Ref ivf_pq.pyx:309: trainset subsample -> balanced k-means ->
    per-subspace/per-cluster codebooks -> encode + fill lists."""
    ds = cai_wrapper(dataset, handle)
    _check_input_array(ds, _DATA_DTYPES)
    return Index(_impl.build(index_params.params, ds.array, handle=handle))


@auto_sync_handle
@auto_convert_output
def extend(index: Index, new_vectors, new_indices, handle=None) -> Index:
    """Ref ivf_pq.pyx:406."""
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
    """Ref ivf_pq.pyx:568: returns ``(distances, neighbors)``.
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
    """Ref ivf_pq.pyx:719: the versioned npz layout (bit-packed codes),
    which ``pylibraft.neighbors.ivf_pq`` reads too."""
    _impl.save(filename, index._index)


def load(filename: str, handle=None) -> Index:
    """Ref ivf_pq.pyx:765, onto the handle's device (``cuda`` when no
    handle is given)."""
    return Index(_impl.load(filename, device=None if handle is None
                            else handle.device))
