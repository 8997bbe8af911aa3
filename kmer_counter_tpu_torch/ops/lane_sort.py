"""Multi-lane sort (K6 + K7) — counterpart of
kmer_counter_tpu.ops.pallas_sort.sort_ops.

``sort_ops`` launches the hand-written CUDA merge sort in
``csrc/lane_sort.cu`` (which replaces the Pallas kernels
``pallas_sort.leaf_sort`` and ``pallas_sort._merge_pass``) for CUDA
tensors, and runs ``sort_ops_reference``, its plain torch version
(``sortcount.lex_argsort`` and a gather), only for tensors on the CPU.
There is no fallback: on any other device, or when the kernel cannot be
built or launched, it raises.

Contract (both versions): ``keys`` is ``[NL, N] int32`` (uint32 bits,
1 <= NL <= 8, each lane contiguous), sorted as unsigned lexicographic keys
with lane 0 most significant; ``payload`` is ``[N] int32`` and rides
along.  Returns new ``(keys, payload)`` tensors.  Order among equal keys
is unspecified, as with ``lax.sort(..., is_stable=False)``; an all-ones
key is an ordinary key whose payload is kept (unlike the Pallas sort,
whose merge pass can drop it).
"""

from __future__ import annotations

import ctypes

import torch

from kmer_counter_tpu_torch import cuda_build
from kmer_counter_tpu_torch.cuda_build import ptr_array
from kmer_counter_tpu_torch.ops.sortcount import lex_argsort

MAX_KEYS = 8
# Sorts launched through ``sort_ops`` (one per call on a non-empty CUDA
# tensor; the plain version does not count).
launches = 0
_LIB = None  # the typed library, once built and loaded (_lib)


def _check(keys: torch.Tensor, payload: torch.Tensor):
    if keys.dtype != torch.int32 or payload.dtype != torch.int32:
        raise TypeError(f"keys and payload must be int32 (uint32 bits), got {keys.dtype}, {payload.dtype}")
    if keys.dim() != 2 or not 1 <= keys.shape[0] <= MAX_KEYS:
        raise ValueError(f"keys must be [NL, N] with 1 <= NL <= {MAX_KEYS}, got {tuple(keys.shape)}")
    if payload.shape != keys.shape[1:]:
        raise ValueError(f"payload must be [N] for keys [NL, N], got {tuple(payload.shape)}")
    if payload.device != keys.device:
        raise ValueError("keys and payload must be on one device")
    if (keys.shape[1] > 1 and keys.stride(1) != 1) or not payload.is_contiguous():
        raise ValueError("every key lane and the payload must be contiguous")


def sort_ops(keys: torch.Tensor, payload: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 + K7: the kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(keys, payload)
    if keys.device.type == "cpu":
        return sort_ops_reference(keys, payload)
    if keys.device.type != "cuda":
        raise RuntimeError(f"sort_ops has no kernel for device {keys.device}")
    return _launch(keys, payload)


def sort_ops_reference(keys: torch.Tensor, payload: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch sort: a stable lexicographic argsort, then a gather."""
    perm = lex_argsort(keys)
    return keys[:, perm], payload[perm]


# ---- the CUDA kernel -------------------------------------------------------


def _lib() -> ctypes.CDLL:
    """The library with its entry points typed: built and loaded at the
    first call, then kept in _LIB (no lock on the launch path)."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("lane_sort")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.ls_tile_rows.argtypes, lib.ls_tile_rows.restype = [i], i
        lib.ls_merge_passes.argtypes, lib.ls_merge_passes.restype = [i, ll], i
        lib.ls_sort.argtypes, lib.ls_sort.restype = [ptrs, ptrs, ptrs, i, ll, vp], i
        _LIB = lib
    return _LIB


def tile_rows(num_keys: int) -> int:
    """Rows per leaf tile at ``num_keys`` key lanes (builds the kernel if
    needed)."""
    return _lib().ls_tile_rows(num_keys)


def merge_passes(num_keys: int, n: int) -> int:
    """Merge passes (one launch each, after the leaf's) that the kernel
    makes for n rows at ``num_keys`` key lanes: runs of one leaf tile, two,
    ... until one run holds all n (builds the kernel if needed)."""
    return _lib().ls_merge_passes(num_keys, n)


def _launch(keys: torch.Tensor, payload: torch.Tensor):
    """One call of ls_sort: the leaf and every merge pass, enqueued on the
    current stream, between two ping-pong buffers (one when n fits a leaf
    tile)."""
    global launches
    lib = _lib()
    NL, n = keys.shape
    bufs = [torch.empty((NL + 1, n), dtype=torch.int32, device=keys.device)]
    if n == 0:
        return bufs[0][:NL], bufs[0][NL]
    if lib.ls_merge_passes(NL, n):
        bufs.append(torch.empty_like(bufs[0]))
    buf_ptrs = [ptr_array(list(b.unbind(0))) for b in bufs]
    stream = cuda_build.current_stream(keys.get_device())
    cur = lib.ls_sort(ptr_array([*keys.unbind(0), payload]), buf_ptrs[0], buf_ptrs[-1], NL, n, stream)
    if cur < 0:
        raise RuntimeError(f"lane_sort launch failed: cudaError {-cur}")
    launches += 1
    out = bufs[cur]
    return out[:NL], out[NL]
