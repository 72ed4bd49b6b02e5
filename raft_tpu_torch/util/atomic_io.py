"""Atomic host-file I/O seam: tmp + fsync + rename writes, CRC32 framing.

Port of ``raft_tpu/util/atomic_io.py`` (no device code, so the port keeps
its own copy). A durable file of the port (the sharded snapshot's model,
shard and manifest files, ``parallel/ivf.py``) is written whole to
``<path>.tmp``, fsynced, then renamed onto its final name with
``os.replace``: POSIX rename atomicity makes "the file exists" mean "the
file is complete", so a kill mid-write never leaves a torn final file.

The primitive operations (``write_bytes`` / ``replace`` / ``fsync``) are
injectable (:class:`FileIO`), so a test can tear a payload at a scripted
byte offset or drop a rename without patching ``os``.
"""

from __future__ import annotations

import io as _io
import os
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import numpy as np

__all__ = ["FileIO", "DEFAULT_IO", "crc32", "savez_bytes",
           "atomic_write_bytes", "atomic_savez"]


def _default_write(f, data: bytes) -> None:
    f.write(data)


def _default_fsync(f) -> None:
    f.flush()
    os.fsync(f.fileno())


@dataclass(frozen=True)
class FileIO:
    """The injectable file primitives. The defaults are the real
    operations; a fault test substitutes wrapped ones (a torn write
    writes a prefix of the payload and raises, a dropped rename raises
    without renaming: the states a power loss leaves behind)."""

    write_bytes: Callable[[Any, bytes], None] = field(
        default=_default_write)
    replace: Callable[[str, str], None] = field(default=os.replace)
    fsync: Callable[[Any], None] = field(default=_default_fsync)


#: The shared default instance (no injected faults).
DEFAULT_IO = FileIO()


def crc32(data: bytes) -> int:
    """Unsigned CRC32 (zlib): the integrity check of a manifest entry."""
    return zlib.crc32(data) & 0xFFFFFFFF


def savez_bytes(**arrays) -> bytes:
    """``np.savez`` into memory, so a file's CRC is known before it is
    written through :func:`atomic_write_bytes` as one unit."""
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def atomic_write_bytes(path: str, data: bytes,
                       file_io: FileIO = DEFAULT_IO,
                       fsync: bool = True) -> int:
    """Write ``data`` to ``path`` atomically (tmp + fsync + rename) and
    return its CRC32. A crash at any point leaves the complete new file,
    the complete old file, or a stale ``.tmp`` that the next write
    overwrites: never a torn ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        file_io.write_bytes(f, data)
        if fsync:
            file_io.fsync(f)
    file_io.replace(tmp, path)
    return crc32(data)


def atomic_savez(path: str, file_io: FileIO = DEFAULT_IO,
                 fsync: bool = True, **arrays) -> Dict[str, int]:
    """Atomic ``np.savez``: serialize to memory, write with
    :func:`atomic_write_bytes`. Returns ``{"crc": ..., "size": ...}``, the
    caller's manifest entry."""
    data = savez_bytes(**arrays)
    return {"crc": atomic_write_bytes(path, data, file_io, fsync=fsync),
            "size": len(data)}
