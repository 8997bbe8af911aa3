"""ctypes bindings to the native host runtime (native/libkmer_io.so).

The port's own copy of kmer_counter_tpu/io/native.py.  It loads the same
library, built from the repository's native/ sources.

The C++ library implements the hot host-side paths — FASTQ chunk parsing
and the k-way merge of sorted spill runs (native/kmer_io.cpp).  Everything
degrades gracefully to the pure-Python implementations in io.fastq /
io.spill when the library has not been built (``make -C native``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libkmer_io.so"),
    os.path.join(os.path.dirname(__file__), "libkmer_io.so"),
]

_lib = None
_load_attempted = False


def _try_build():
    """Best-effort `make -C native` when the checkout has sources but no
    built library (the .so is not committed)."""
    import subprocess

    native_dir = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "native")
    )
    if not os.path.exists(os.path.join(native_dir, "Makefile")):
        return
    try:
        subprocess.run(
            ["make", "-C", native_dir],
            capture_output=True,
            timeout=120,
            check=False,
        )
    except Exception:
        pass


def load_library():
    """The loaded CDLL, or None when unavailable."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if not any(os.path.exists(os.path.abspath(p)) for p in _LIB_PATHS):
        _try_build()
    for path in _LIB_PATHS:
        path = os.path.abspath(path)
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            lib.kc_open.restype = ctypes.c_void_p
            lib.kc_open.argtypes = [ctypes.c_char_p]
            try:
                lib.kc_open_range.restype = ctypes.c_void_p
                lib.kc_open_range.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_longlong,
                    ctypes.c_longlong,
                ]
            except AttributeError:
                pass  # older .so without range support; Python fallback
            lib.kc_line_length.restype = ctypes.c_long
            lib.kc_line_length.argtypes = [ctypes.c_void_p]
            lib.kc_read_chunk.restype = ctypes.c_long
            lib.kc_read_chunk.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_long,
            ]
            lib.kc_close.restype = None
            lib.kc_close.argtypes = [ctypes.c_void_p]
            lib.kc_merge_runs.restype = ctypes.c_long
            lib.kc_merge_runs.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.c_char_p,
                ctypes.c_int,
            ]
            _lib = lib
            break
    return _lib


def available() -> bool:
    return load_library() is not None


class NativeFASTQReader:
    """Drop-in replacement for io.fastq.FASTQReader backed by C++ (the
    ``byte_range`` record-resync semantics included — kc_open_range)."""

    def __init__(self, path: str, byte_range: tuple[int, int] | None = None):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library not built (make -C native)")
        self._lib = lib
        self.path = path
        if byte_range is not None:
            if not hasattr(lib, "kc_open_range"):
                raise RuntimeError("native library lacks kc_open_range")
            start, end = byte_range
            self._h = lib.kc_open_range(path.encode(), max(start, 0), end)
        else:
            self._h = lib.kc_open(path.encode())
        if not self._h:
            raise ValueError(f"{path}: not a FASTQ file (native parser)")
        self.line_length = int(lib.kc_line_length(self._h))

    def read_chunk(self, max_reads: int):
        from kmer_counter_tpu_torch.io.fastq import FASTQChunk

        if self._h is None:
            return None
        out = np.zeros((max_reads, self.line_length), dtype=np.uint8)
        n = self._lib.kc_read_chunk(
            self._h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            max_reads,
        )
        if n < 0:
            raise ValueError(
                f"{self.path}: malformed FASTQ (truncated record, "
                "misplaced header/separator line, or a sequence line "
                f"exceeding line length {self.line_length})"
            )
        if n == 0:
            self.close()
            return None
        return FASTQChunk(out[:n], int(n), self.line_length)

    def close(self):
        if self._h is not None:
            self._lib.kc_close(self._h)
            self._h = None


def native_merge_runs(paths: list[str], out_path: str, k: int) -> int:
    """C++ k-way merge; same contract as io.spill.merge_runs."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    parent = os.path.dirname(out_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    n = lib.kc_merge_runs(arr, len(paths), out_path.encode(), k)
    if n < 0:
        raise OSError(f"native merge failed over {len(paths)} runs")
    return int(n)
