"""Binary serialization of arrays and scalars to streams and files.

Port of ``raft_tpu/core/serialize.py``, in numpy alone: arrays as ``.npy``
payloads, scalars as packed little-endian values (the reference's
``serialize_mdspan`` / ``serialize_scalar`` wire convention), so a stream
written by either package reads in the other. Tensors are written through
:func:`to_numpy`, which copies them to the host first. The IVF indexes'
``save`` / ``load`` keep their arrays in one ``.npz`` file, read and
written here under ``core/retry.with_retry`` (:func:`read_npz`,
:func:`write_npz`), as the reference's are.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO

import numpy as np
import torch

from raft_tpu_torch.core.retry import DEFAULT_IO_RETRY, with_retry

_SCALAR_FMT = {
    np.dtype(np.int8): "<b",
    np.dtype(np.uint8): "<B",
    np.dtype(np.int32): "<i",
    np.dtype(np.uint32): "<I",
    np.dtype(np.int64): "<q",
    np.dtype(np.uint64): "<Q",
    np.dtype(np.float32): "<f",
    np.dtype(np.float64): "<d",
    np.dtype(np.bool_): "<?",
}

# numpy has no bfloat16. The reference's ml_dtypes bfloat16 arrays land in
# an ``.npy`` header as the 2-byte void type ``|V2``; a bf16 tensor is
# written with those bits, and a 2-byte void array (``|V2`` as read back,
# or an ml_dtypes bfloat16 array in memory) reads as bf16.
_BF16_NP = np.dtype("V2")


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.kind == "V" and dtype.itemsize == 2


def to_numpy(x) -> np.ndarray:
    """A host numpy array of a tensor (bf16 as its 2-byte ``|V2`` bits)
    or of anything ``np.asarray`` takes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_NP)
        return x.numpy()
    return np.asarray(x)


def from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """The tensor of a numpy array read from a stream (a 2-byte void array
    is bf16), on ``device``."""
    a = np.asarray(a)
    if _is_bf16(a.dtype):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def serialize_mdspan(stream: BinaryIO, arr) -> None:
    """Write an array to ``stream`` as an ``.npy`` payload. A bf16 array
    gets the header ml_dtypes writes for it (``'<V2'``), so the bytes are
    the reference's."""
    a = to_numpy(arr)
    if not _is_bf16(a.dtype):
        np.save(stream, a, allow_pickle=False)
        return
    a = np.ascontiguousarray(a)
    np.lib.format.write_array_header_1_0(
        stream, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
    stream.write(a.tobytes())


def deserialize_mdspan(stream: BinaryIO) -> np.ndarray:
    """Read an ``.npy`` payload."""
    return np.load(stream, allow_pickle=False)


def serialize_scalar(stream: BinaryIO, value, dtype) -> None:
    """Write a raw little-endian scalar."""
    dt = np.dtype(dtype)
    stream.write(struct.pack(_SCALAR_FMT[dt], dt.type(value).item()))


def deserialize_scalar(stream: BinaryIO, dtype):
    """Read a raw little-endian scalar."""
    dt = np.dtype(dtype)
    fmt = _SCALAR_FMT[dt]
    return dt.type(struct.unpack(fmt, stream.read(struct.calcsize(fmt)))[0])


def read_npz(filename, retry=None) -> dict:
    """Every array of an ``.npz`` file, the suffix added when missing
    (``np.savez`` adds it), read under ``with_retry`` (``retry`` or
    ``DEFAULT_IO_RETRY``)."""
    name = os.fspath(filename)
    if not name.endswith(".npz"):
        name += ".npz"

    def read():
        with np.load(name, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    return with_retry(read, retry or DEFAULT_IO_RETRY)


def write_npz(filename, payload: dict, retry=None) -> None:
    """``np.savez`` of ``payload`` under ``with_retry``."""
    with_retry(lambda: np.savez(os.fspath(filename), **payload),
               retry or DEFAULT_IO_RETRY)
