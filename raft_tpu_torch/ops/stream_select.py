"""Streaming min-k extract (B5), the work-compression pass of kStream.

Port of the Pallas sweep of ``raft_tpu/matrix/select_k.py::
_stream_select_min`` (kernel ``_mextract_kernel``, core
:func:`extract_m_rows`). The f32 keys (batch, n) are read as if padded with
+inf to a multiple of 8192 positions; every 512-position sub-chunk yields
its 8 smallest (value, position) pairs, ascending by (value compared as a
float, position), at columns [8s, 8s + 8) of a (batch, n_pad / 64)
candidate block. -0 and +0 compare equal there, and the value written is
the key's own bits at the written position (the reference writes
``jnp.min``'s result, whose zero sign is unspecified). A sub-chunk with
fewer than 8 entries below +inf repeats (inf, its first position) on its
tail passes; one holding a NaN gives (NaN, INT32_MAX) on every pass, as
``jnp.min`` propagates NaN and ``==`` matches nothing.

The kernel is hand-written CUDA in ``csrc/stream_select.cu``; its one
launch choice, the load width, is :func:`_b5_plan`'s. The plain version
runs :func:`extract_m_rows` over a (batch, n_pad / 512, 512) view. The
wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises. ``stream_extract.launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from raft_tpu_torch.core.error import CudaError, expects
from raft_tpu_torch.core.sentinels import PAD_ID
from raft_tpu_torch.ops import _build
from raft_tpu_torch.util.pow2 import round_up_safe

#: Positions per sub-chunk, extracts per sub-chunk, and the row granule
#: (the reference's 16-sub-chunk tile).
SUB = 512
M = 8
BT = 8192
I32MAX = 2 ** 31 - 1


def n_candidates(n: int) -> int:
    """Candidate columns per row for a row of ``n`` keys."""
    return round_up_safe(n, BT) // SUB * M


def extract_m_rows(work, ids, m: int, out_v, out_i, lane_base: int = 0):
    """``m`` passes of the streaming extract over the last axis of ``work``
    (f32, min order): each pass takes the minimum, the lowest id among the
    entries equal to it, knocks that entry out with +inf and writes the
    entry's own value (a NaN minimum matches no id: NaN, ``I32MAX``) and
    id at column ``lane_base + t`` of ``(out_v, out_i)``. Leading axes
    broadcast. Returns ``(residual work, out_v, out_i)``."""
    col = torch.arange(out_v.shape[-1], device=out_v.device)
    for t in range(m):
        cur = torch.amin(work, dim=-1, keepdim=True)
        hit = work == cur
        sel = torch.amin(torch.where(hit, ids, I32MAX), dim=-1, keepdim=True)
        at = ids == sel
        # The key at sel, not cur: amin's choice between -0 and +0 is
        # unspecified.
        own = torch.gather(work, -1, torch.argmax(at.to(torch.uint8), -1,
                                                  keepdim=True))
        cur = torch.where(sel == I32MAX, cur, own)
        work = torch.where(at, float("inf"), work)
        put = col == lane_base + t
        out_v = torch.where(put, cur, out_v)
        out_i = torch.where(put, sel, out_i)
    return work, out_v, out_i


def _stream_extract_plain(keys) -> Tuple[torch.Tensor, torch.Tensor]:
    batch, n = keys.shape
    n_pad = round_up_safe(n, BT)
    nc = n_pad // SUB
    w = F.pad(keys, (0, n_pad - n), value=float("inf")).view(batch, nc, SUB)
    ids = (torch.arange(nc, dtype=torch.int32, device=keys.device)[:, None]
           * SUB + torch.arange(SUB, dtype=torch.int32, device=keys.device))
    out_v = torch.full((batch, nc, M), float("inf"), dtype=torch.float32,
                       device=keys.device)
    out_i = torch.full((batch, nc, M), PAD_ID, dtype=torch.int32,
                       device=keys.device)
    _, out_v, out_i = extract_m_rows(w, ids, M, out_v, out_i)
    return out_v.reshape(batch, nc * M), out_i.reshape(batch, nc * M)


def _b5_plan(n: int, data_ptr: int) -> bool:
    """Whether B5 takes 16-byte loads: every row must start on 16 bytes,
    so ``n % 4 == 0`` and the keys' pointer aligned (a contiguous view one
    float into its storage is not). The C entry refuses a 16-byte launch
    that breaks either."""
    return n % 4 == 0 and data_ptr % 16 == 0


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _lib():
    lib = _build.load_library("stream_select")
    if lib.stream_extract_launch.argtypes is None:
        lib.stream_extract_launch.argtypes = _ARGTYPES
        lib.stream_extract_launch.restype = ctypes.c_int
    return lib


def _stream_extract_cuda(keys) -> Tuple[torch.Tensor, torch.Tensor]:
    _build.check_operands("stream_extract", keys)
    batch, n = keys.shape
    width = n_candidates(n)
    out_v = torch.empty((batch, width), dtype=torch.float32,
                        device=keys.device)
    out_i = torch.empty((batch, width), dtype=torch.int32, device=keys.device)
    if batch == 0:
        return out_v, out_i
    lib = _lib()
    with torch.cuda.device(keys.device):
        err = lib.stream_extract_launch(_build.ptr(keys), _build.ptr(out_v),
                                        _build.ptr(out_i),
                                        batch, n, width // M,
                                        int(_b5_plan(n, keys.data_ptr())),
                                        _build.stream(keys.device))
    _build.check(err, "stream_extract launch")
    stream_extract.launches += 1
    return out_v, out_i


def stream_extract(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sub-chunk 8 smallest of f32 keys (batch, n): returns candidate
    values (batch, n_pad / 64) f32 and int32 positions."""
    expects(keys.ndim == 2 and keys.dtype == torch.float32
            and keys.shape[1] >= 1,
            "stream_extract: float32 keys (batch, n >= 1) expected")
    if keys.device.type == "cpu":
        return _stream_extract_plain(keys)
    if keys.device.type == "cuda":
        return _stream_extract_cuda(keys.contiguous())
    raise CudaError(f"stream_extract: no kernel for {keys.device}")


stream_extract.launches = 0
