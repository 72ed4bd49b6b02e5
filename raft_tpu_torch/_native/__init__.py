"""The port's loader of the native host runtime (``native/host_runtime.cpp``).

The runtime is plain C++ with a C interface, loaded with ``ctypes``: the
``.fvecs`` / ``.bvecs`` / ``.ivecs`` readers and writers, the threaded
host re-rank (``refine_host``), the host k-way merge of per-part top-k
lists, a host top-k and the union-find agglomeration behind single
linkage. At first use ``g++ -O3 -std=c++17 -fPIC -shared -pthread``
compiles the source into the port's build directory
(``ops/_build.BUILD_DIR``, under ``build/``) through ``ops/_build``'s
own build machinery: named by a hash of the source and the flags, and a
temporary file renamed into place, so two processes never load a
half-written library.

Unlike the reference's loader, nothing falls back: a failed build raises
:class:`NativeBuildError` with the compiler's output, and every wrapper
calls the library. The NumPy versions below (``_read_vecs_numpy``,
``_write_vecs_numpy``, ``_refine_numpy``, ``_merge_numpy``,
``_select_k_numpy``) are the plain versions the tests hold the library
to; no wrapper calls them.

This module reads the runtime's source only; it imports nothing of the
reference package.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from raft_tpu_torch.core.error import RaftError
from raft_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "host_runtime.cpp"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
#: The library's name in ``ops/_build`` (its file is
#: ``libraft_host-<hash>.so``, its build time ``BUILD_SECONDS["raft_host"]``).
LIBRARY = "raft_host"


class NativeBuildError(RaftError):
    """The host runtime failed to compile or load."""


def _job() -> _build.Job:
    """The runtime's build: ``g++`` with :data:`CXX_FLAGS` on
    :data:`SOURCE`."""
    return [CXX, *CXX_FLAGS], [SOURCE], []


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)

    lib.raft_native_version.restype = ctypes.c_int
    lib.raft_read_fvecs.argtypes = [ctypes.c_char_p, p_i64, p_i64, p_f32]
    lib.raft_read_bvecs.argtypes = [ctypes.c_char_p, p_i64, p_i64, p_u8]
    lib.raft_read_ivecs.argtypes = [ctypes.c_char_p, p_i64, p_i64, p_i32]
    lib.raft_write_fvecs.argtypes = [ctypes.c_char_p, i64, i64, p_f32]
    lib.raft_write_bvecs.argtypes = [ctypes.c_char_p, i64, i64, p_u8]
    lib.raft_refine_host.argtypes = [
        p_f32, i64, i64, p_f32, i64, p_i64, i64, i64, ctypes.c_int,
        p_f32, p_i64]
    lib.raft_knn_merge_parts.argtypes = [
        p_f32, p_i64, i64, i64, i64, ctypes.c_int, p_i64, p_f32, p_i64]
    lib.raft_select_k_host.argtypes = [
        p_f32, i64, i64, i64, ctypes.c_int, p_f32, p_i64]
    lib.raft_dendrogram_host.argtypes = [
        p_i32, p_i32, p_f32, i64, i64, i64, p_i64, p_f64, p_i64, p_i32,
        p_i64]
    for fn in (lib.raft_read_fvecs, lib.raft_read_bvecs, lib.raft_read_ivecs,
               lib.raft_write_fvecs, lib.raft_write_bvecs,
               lib.raft_refine_host, lib.raft_knn_merge_parts,
               lib.raft_select_k_host, lib.raft_dendrogram_host):
        fn.restype = ctypes.c_int
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, compiled first if this source has no build
    yet. Raises :class:`NativeBuildError` when it cannot be built or
    loaded."""
    return _build.load_library(LIBRARY, _job(), NativeBuildError, _configure)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _read_vecs(fn, path: str, dtype, ctype) -> np.ndarray:
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = fn(path.encode(), ctypes.byref(rows), ctypes.byref(cols), None)
    if rc != 0:
        raise IOError(f"failed to read {path} (rc={rc})")
    out = np.empty((rows.value, cols.value), dtype)
    rc = fn(path.encode(), ctypes.byref(rows), ctypes.byref(cols),
            _ptr(out, ctype))
    if rc != 0:
        raise IOError(f"failed to read {path} (rc={rc})")
    return out


def read_fvecs(path: str) -> np.ndarray:
    """Read a ``.fvecs`` file (float32 rows, each after its int32 width)."""
    return _read_vecs(get_lib().raft_read_fvecs, path, np.float32,
                      ctypes.c_float)


def read_bvecs(path: str) -> np.ndarray:
    """Read a ``.bvecs`` file (uint8 rows)."""
    return _read_vecs(get_lib().raft_read_bvecs, path, np.uint8,
                      ctypes.c_uint8)


def read_ivecs(path: str) -> np.ndarray:
    """Read an ``.ivecs`` file (int32 rows)."""
    return _read_vecs(get_lib().raft_read_ivecs, path, np.int32,
                      ctypes.c_int32)


def write_fvecs(path: str, data: np.ndarray) -> None:
    """Write float32 rows as ``.fvecs``."""
    data = np.ascontiguousarray(data, np.float32)
    rc = get_lib().raft_write_fvecs(path.encode(), data.shape[0],
                                    data.shape[1], _ptr(data, ctypes.c_float))
    if rc != 0:
        raise IOError(f"failed to write {path} (rc={rc})")


def write_bvecs(path: str, data: np.ndarray) -> None:
    """Write uint8 rows as ``.bvecs``."""
    data = np.ascontiguousarray(data, np.uint8)
    rc = get_lib().raft_write_bvecs(path.encode(), data.shape[0],
                                    data.shape[1], _ptr(data, ctypes.c_uint8))
    if rc != 0:
        raise IOError(f"failed to write {path} (rc={rc})")


def refine_host(dataset: np.ndarray, queries: np.ndarray,
                candidates: np.ndarray, k: int,
                metric: str = "sqeuclidean"):
    """Exact re-rank of each query's candidate rows on the host's threads:
    the k best by squared L2 (``"sqeuclidean"``) or inner product
    (``"inner_product"``); a candidate id outside the dataset (-1
    padding) is skipped. Returns ``(distances (q, k) float32, ids (q, k)
    int64)``."""
    dataset = np.ascontiguousarray(dataset, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    candidates = np.ascontiguousarray(candidates, np.int64)
    mcode = {"sqeuclidean": 0, "inner_product": 1}[metric]
    nq, nc = candidates.shape
    out_d = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    rc = get_lib().raft_refine_host(
        _ptr(dataset, ctypes.c_float), dataset.shape[0], dataset.shape[1],
        _ptr(queries, ctypes.c_float), nq,
        _ptr(candidates, ctypes.c_int64), nc, k, mcode,
        _ptr(out_d, ctypes.c_float), _ptr(out_i, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"refine_host failed (rc={rc})")
    return out_d, out_i


def knn_merge_parts(dists: np.ndarray, ids: np.ndarray,
                    select_min: bool = True, translations=None):
    """Host k-way merge of per-part sorted top-k lists (p, q, k), each
    part's ids shifted by its ``translations`` entry. Returns ``(dists
    (q, k), ids (q, k))``."""
    dists = np.ascontiguousarray(dists, np.float32)
    ids = np.ascontiguousarray(ids, np.int64)
    p, nq, k = dists.shape
    if p == 0 or k == 0:
        raise ValueError("knn_merge_parts requires >=1 part and k>=1")
    trans = (np.ascontiguousarray(translations, np.int64)
             if translations is not None else None)
    out_d = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    rc = get_lib().raft_knn_merge_parts(
        _ptr(dists, ctypes.c_float), _ptr(ids, ctypes.c_int64), p, nq, k,
        1 if select_min else 0,
        _ptr(trans, ctypes.c_int64) if trans is not None else None,
        _ptr(out_d, ctypes.c_float), _ptr(out_i, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"knn_merge_parts failed (rc={rc})")
    return out_d, out_i


def select_k_host(x: np.ndarray, k: int, select_min: bool = True):
    """Host top-k of each row: ``(values (b, k), positions (b, k)
    int64)``."""
    x = np.ascontiguousarray(x, np.float32)
    b, n = x.shape
    out_v = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.int64)
    rc = get_lib().raft_select_k_host(
        _ptr(x, ctypes.c_float), b, n, k, 1 if select_min else 0,
        _ptr(out_v, ctypes.c_float), _ptr(out_i, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"select_k_host failed (rc={rc})")
    return out_v, out_i


def dendrogram_host(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                    n: int, n_clusters: int):
    """Union-find agglomeration over weight-sorted MST edges. Returns
    ``(labels, children, distances, sizes)`` truncated to the merges
    made."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    w = np.ascontiguousarray(w, np.float32)
    m = max(n - 1, 0)
    children = np.zeros((m, 2), np.int64)
    distances = np.zeros(m, np.float64)
    sizes = np.zeros(m, np.int64)
    labels = np.zeros(n, np.int32)
    merges = ctypes.c_int64()
    rc = get_lib().raft_dendrogram_host(
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        _ptr(w, ctypes.c_float), src.shape[0], n, n_clusters,
        _ptr(children, ctypes.c_int64),
        _ptr(distances, ctypes.c_double), _ptr(sizes, ctypes.c_int64),
        _ptr(labels, ctypes.c_int32), ctypes.byref(merges))
    if rc != 0:
        raise ValueError(f"dendrogram_host failed (rc={rc})")
    k = merges.value
    return labels, children[:k], distances[:k], sizes[:k]


# --- plain NumPy versions (what the tests hold the library to) -------------

def _read_vecs_numpy(path: str, dtype) -> np.ndarray:
    raw = np.fromfile(path, np.uint8)
    dim = int(raw[:4].view(np.int32)[0])
    elt = np.dtype(dtype).itemsize
    row_bytes = 4 + dim * elt
    n = raw.size // row_bytes
    rows = raw.reshape(n, row_bytes)[:, 4:]
    return rows.reshape(n, dim * elt).view(dtype).reshape(n, dim).copy()


def _write_vecs_numpy(path: str, data: np.ndarray) -> None:
    n, d = data.shape
    with open(path, "wb") as f:
        for r in range(n):
            np.int32(d).tofile(f)
            data[r].tofile(f)


def _refine_numpy(dataset, queries, candidates, k, mcode):
    invalid = (candidates < 0) | (candidates >= dataset.shape[0])
    safe = np.where(invalid, 0, candidates)
    gathered = dataset[safe]
    if mcode == 0:
        d = ((gathered - queries[:, None, :]) ** 2).sum(-1)
    else:
        d = -(gathered * queries[:, None, :]).sum(-1)
    d = np.where(invalid, np.inf, d)
    order = np.argsort(d, axis=1)[:, :k]
    out_d = np.take_along_axis(d, order, axis=1)
    out_i = np.take_along_axis(candidates, order, axis=1)
    if mcode == 1:
        out_d = -out_d
    return out_d.astype(np.float32), out_i


def _merge_numpy(dists, ids, select_min, trans):
    p, nq, k = dists.shape
    if trans is not None:
        ids = np.where(ids >= 0, ids + trans[:, None, None], ids)
    flat_d = dists.transpose(1, 0, 2).reshape(nq, p * k)
    flat_i = ids.transpose(1, 0, 2).reshape(nq, p * k)
    order = np.argsort(flat_d if select_min else -flat_d, axis=1)[:, :k]
    return (np.take_along_axis(flat_d, order, axis=1),
            np.take_along_axis(flat_i, order, axis=1))


def _select_k_numpy(x, k, select_min):
    order = np.argsort(x if select_min else -x, axis=1)[:, :k]
    return np.take_along_axis(x, order, axis=1), order.astype(np.int64)
