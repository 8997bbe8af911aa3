"""Stable stream compaction (K2) — counterpart of
kmer_counter_tpu.ops.pallas_sort.compact_live.

``compact_live`` launches the hand-written CUDA kernel in
``csrc/compact_live.cu`` (which replaces the Pallas kernel
``pallas_sort.compact_live``) for CUDA tensors, and runs
``compact_live_reference``, its plain torch version, only for tensors on
the CPU.  There is no fallback: on any other device, or when the kernel
cannot be built or launched, it raises.

Contract (both versions, as the JAX function's): ``operands`` are 1 to 9
lanes of n rows and ``live`` one more, all 1-D contiguous int32 tensors
holding uint32 bits (``live`` may be one of the operands).  The result is
``[len(operands), out_rows] int32`` (``out_rows`` <= n, n by default): the
rows with ``live != 0`` at the front in their original order, as many as
fit, then rows holding the sentinel (0xFFFFFFFF) in the first ``num_keys``
lanes and 0 in the others — the JAX function's output cut to its first
``out_rows`` columns, as ``table2._c3_compact`` cuts it to the prefix.  The
caller computes the live count.  Any n works (the JAX function needs a
multiple of its tile).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from kmer_counter_tpu_torch import cuda_build
from kmer_counter_tpu_torch.cuda_build import ptr_array
from kmer_counter_tpu_torch.ops.u32 import SENTINEL

MAX_OPS = 9
# Calls of ``compact_live`` that launched the kernels (compact and fill,
# counted once per call on a CUDA tensor with an output row; the plain
# version does not count).
launches = 0
_LIB = None  # the typed library, once built and loaded (_lib)


def _check(operands: Sequence[torch.Tensor], live: torch.Tensor, num_keys: int, out_rows: int):
    if not 1 <= len(operands) <= MAX_OPS:
        raise ValueError(f"compact_live takes 1 to {MAX_OPS} operands, got {len(operands)}")
    if not 0 <= num_keys <= len(operands):
        raise ValueError(f"num_keys must be in [0, {len(operands)}], got {num_keys}")
    n = live.shape[0] if live.dim() == 1 else -1
    for v in (*operands, live):
        if v.dtype != torch.int32:
            raise TypeError(f"operands and live must be int32 (uint32 bits), got {v.dtype}")
        if v.dim() != 1 or v.shape[0] != n:
            raise ValueError("operands and live must be 1-D and of equal length")
        if v.device != live.device:
            raise ValueError("operands and live must be on one device")
        if not v.is_contiguous():
            raise ValueError("operands and live must be contiguous")
    if not 0 <= out_rows <= n:
        raise ValueError(f"out_rows must be in [0, {n}], got {out_rows}")


def compact_live(
    operands: Sequence[torch.Tensor], live: torch.Tensor, num_keys: int, out_rows: int | None = None
) -> torch.Tensor:
    """K2: the kernel for CUDA tensors, the plain version for CPU tensors."""
    out_rows = live.shape[0] if out_rows is None else out_rows
    _check(operands, live, num_keys, out_rows)
    if live.device.type == "cpu":
        return compact_live_reference(operands, live, num_keys, out_rows)
    if live.device.type != "cuda":
        raise RuntimeError(f"compact_live has no kernel for device {live.device}")
    return _launch(operands, live, num_keys, out_rows)


def _empty_out(n_ops: int, n: int, num_keys: int, device) -> torch.Tensor:
    out = torch.zeros((n_ops, n), dtype=torch.int32, device=device)
    out[:num_keys] = SENTINEL
    return out


def compact_live_reference(
    operands: Sequence[torch.Tensor], live: torch.Tensor, num_keys: int, out_rows: int | None = None
) -> torch.Tensor:
    """Plain torch K2: a boolean-mask gather into a filled output."""
    out_rows = live.shape[0] if out_rows is None else out_rows
    keep = live != 0
    out = _empty_out(len(operands), out_rows, num_keys, live.device)
    rows = torch.stack(list(operands))[:, keep][:, :out_rows]
    out[:, : rows.shape[1]] = rows
    return out


# ---- the CUDA kernel -------------------------------------------------------


def _lib() -> ctypes.CDLL:
    """The library with its entry points typed: built and loaded at the
    first call, then kept in _LIB (no lock on the launch path)."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("compact_live")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.cl_tile_rows.argtypes, lib.cl_tile_rows.restype = [], i
        lib.cl_num_tiles.argtypes, lib.cl_num_tiles.restype = [vp, ll], ll
        lib.cl_compact.argtypes = [ptrs, ptrs, i, i, vp, ll, ll, vp, vp]
        lib.cl_compact.restype = i
        _LIB = lib
    return _LIB


def tile_rows() -> int:
    """Rows per CUDA block (builds the kernel if needed)."""
    return _lib().cl_tile_rows()


def _launch(operands, live, num_keys, out_rows):
    global launches
    lib = _lib()
    n = live.shape[0]
    if out_rows == 0:
        return _empty_out(len(operands), 0, num_keys, live.device)
    out = torch.empty((len(operands), out_rows), dtype=torch.int32, device=live.device)
    # The look-back's status words, one per tile, then the tile ticket: zero.
    scratch = torch.zeros(lib.cl_num_tiles(live.data_ptr(), n) + 1, dtype=torch.int64, device=live.device)
    stream = cuda_build.current_stream(live.get_device())
    err = lib.cl_compact(ptr_array(operands), ptr_array(list(out.unbind(0))), len(operands),
                         num_keys, live.data_ptr(), n, out_rows, scratch.data_ptr(), stream)
    if err:
        raise RuntimeError(f"compact_live launch failed: cudaError {err}")
    launches += 1
    return out
