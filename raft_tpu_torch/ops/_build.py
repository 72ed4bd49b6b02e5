"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries go into ``build/raft_tpu_torch/`` at the repository
root, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as is. Nothing here runs at import
time; a failed build raises :class:`~raft_tpu_torch.core.error.CudaError`.

Listeners (:func:`add_listener`) hear of every ``nvcc`` run and every first
load of a library: the serving layer's ``CompileCounter`` counts them, so
"no kernel build or library load in steady state" is observed, not
assumed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List

from raft_tpu_torch.core.error import CudaError

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "raft_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register / shared-memory report) per source.
BUILD_LOG: Dict[str, str] = {}
#: Seconds each library took to build in this process (absent if cached).
BUILD_SECONDS: Dict[str, float] = {}
_LISTENERS: List[Callable[[str, str], None]] = []


def add_listener(fn: Callable[[str, str], None]) -> Callable[[], None]:
    """Call ``fn(event, name)`` for each ``nvcc`` run (event "build") and
    each first load of a library (event "load"). Returns an idempotent
    unsubscribe callable."""
    _LISTENERS.append(fn)

    def remove() -> None:
        try:
            _LISTENERS.remove(fn)
        except ValueError:
            pass

    return remove


def _notify(event: str, name: str) -> None:
    for fn in list(_LISTENERS):
        fn(event, name)


def enable_compilation_cache(path=None) -> str:
    """The port's persistent build cache: the directory the kernel
    libraries are built into and loaded from, so a process reuses every
    library an earlier one built from the same sources. A ``path`` points
    :data:`BUILD_DIR` there (made if missing) for every later build and
    load. Returns the effective directory."""
    global BUILD_DIR
    if path is not None:
        BUILD_DIR = Path(path)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return str(BUILD_DIR)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/*.cu`` stems)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, Path]:
    """Build every missing library, one ``nvcc`` per source, all started
    together. Returns ``{name: library path}``."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{n}.cu")]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            os.unlink(tmp)
            raise CudaError(f"cannot run nvcc for {n}: {e}") from e
        procs[n] = (proc, tmp, time.perf_counter())
        _notify("build", n)
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = out
        BUILD_SECONDS[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise CudaError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
        _notify("load", name)
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise CudaError(f"{what} failed: cudaError_t {err}")


def check_operands(name: str, *tensors) -> None:
    """Raise unless every operand of a launch is contiguous and on the
    first one's device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise CudaError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise CudaError(f"{name}: operands must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer for a C entry point."""
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a C entry point."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
