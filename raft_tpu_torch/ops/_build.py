"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries go into ``build/raft_tpu_torch/`` at the repository
root, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as is. Nothing here runs at import
time; a failed build raises :class:`~raft_tpu_torch.core.error.CudaError`.
The same machinery (:func:`compile_libraries`, :func:`load_library` with
a job) builds the host runtime of ``raft_tpu_torch._native`` with ``g++``.

Listeners (:func:`add_listener`) hear of every compiler run and every first
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
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from raft_tpu_torch.core.error import CudaError

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "raft_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: A library's build: the compiler command with its flags, the sources
#: it compiles and the headers they include (hashed into the name).
Job = Tuple[List[str], List[Path], List[Path]]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()
#: The compiler's output per library (nvcc's: the ptxas register and
#: shared-memory report).
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


def library_path(name: str, command: List[str], inputs: List[Path]) -> Path:
    """Where ``lib<name>`` lives: named by a hash of the files it is made
    from and of the compiler's flags."""
    h = hashlib.sha256()
    for p in inputs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(command[1:]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _cuda_job(name: str) -> Job:
    return ([nvcc_path(), *NVCC_FLAGS], [CSRC_DIR / f"{name}.cu"],
            sorted(CSRC_DIR.glob("*.cuh")))


def _library_path(name: str) -> Path:
    command, srcs, headers = _cuda_job(name)
    return library_path(name, command, headers + srcs)


def compile_libraries(jobs: Dict[str, Job], error=CudaError
                      ) -> Dict[str, Path]:
    """Build every missing library of ``jobs`` (``{name: (command,
    sources, headers)}``: ``command -o <library> sources``), all compilers
    started together. A failed build raises ``error`` with the compiler's
    output. Returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n, cmd, headers + srcs)
             for n, (cmd, srcs, headers) in jobs.items()}
    procs = {}
    for n, (cmd, srcs, _) in jobs.items():
        if paths[n].exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.Popen([*cmd, "-o", tmp, *map(str, srcs)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            os.unlink(tmp)
            raise error(f"cannot run {cmd[0]} for {n}: {e}") from e
        procs[n] = (proc, tmp, time.perf_counter())
        _notify("build", n)
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = out
        BUILD_SECONDS[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n}: {jobs[n][0][0]} exited {proc.returncode}"
                          f"\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise error("build failed:\n" + "\n".join(failed))
    return paths


def build_all(names=None) -> Dict[str, Path]:
    """Build every missing kernel library, one ``nvcc`` per source, all
    started together. Returns ``{name: library path}``."""
    names = sources() if names is None else list(names)
    return compile_libraries({n: _cuda_job(n) for n in names})


def load_library(name: str, job: Optional[Job] = None, error=CudaError,
                 configure: Optional[Callable] = None) -> ctypes.CDLL:
    """The loaded library ``name``, built if needed: ``csrc/<name>.cu``
    by default, else the one ``job`` makes (as in
    :func:`compile_libraries`). ``configure`` runs once on the library
    when it is first loaded; a failed build or load raises ``error``."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = (build_all([name]) if job is None
                    else compile_libraries({name: job}, error))[name]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise error(f"cannot load {path}: {e}") from e
            if configure is not None:
                lib = configure(lib)
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
