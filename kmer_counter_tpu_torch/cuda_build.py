"""Build and load the package's CUDA sources (``csrc/*.cu``).

Each source is compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes — no PyTorch headers, so a build takes
seconds.  Libraries go to ``_build/`` beside this file (listed in
.gitignore), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one loads at once.  The build runs at first use, never
at import.  Each source has its own lock, so different sources may build
at once, from different threads: a caller that needs every kernel (as
chip_smoke.py does) then waits for the slowest nvcc, not for the sum.

``current_stream`` is every wrapper's stream handle: a launch path short
enough for kernels whose time the host's work per call would otherwise set.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}  # one per source
_loaded: dict[str, ctypes.CDLL] = {}
# Per source: seconds spent in nvcc (0.0 when a cached build was loaded)
# and the compiler's register/shared-memory report (-Xptxas -v).
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}


def ptr_array(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (``void* const*``), for
    the kernels' entry points; the caller keeps the tensors alive."""
    return (ctypes.c_void_p * len(tensors))(*[v.data_ptr() for v in tensors])


def current_stream(device_index: int) -> int:
    """The raw handle (``cudaStream_t``) of the caller's current stream on
    the CUDA device of that index: the stream a ``torch.cuda.stream(...)``
    block set, else the default one.  The same handle as
    ``torch.cuda.current_stream(device).cuda_stream`` without building a
    ``Stream`` object a call (PyTorch's private binding that its generated
    wrappers call; it exists only in a CUDA build of PyTorch)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        tag = digest.hexdigest()[:16]
        lib_path = BUILD_DIR / f"lib{name}-{tag}.so"
        build_seconds[name] = 0.0
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True,
                text=True,
            )
            build_seconds[name] = time.perf_counter() - t0
            build_log[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {src}:\n{build_log[name]}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        _loaded[name] = lib
        return lib
